"""plan_preprocess_s: host seconds of the plan build's stage of
preprocessing into the kernels' tables (``plan.preprocess``, the
reordered plans' position remap included), summed over the legs. The
program's stage counters: ``GraphOps.build_s`` (train) or the serving
registry's ``plan_build_s()`` (serve), kept for every build; None where
the stage did no work or the program keeps no counters."""

STAGE = "preprocess"


def read(rec):
    gops = getattr(rec.world, "gops", None)
    if gops is not None:
        stages = getattr(gops, "build_s", None)
    else:
        reg = rec.world.service.engine.registry
        stages = reg.plan_build_s() if hasattr(reg, "plan_build_s") else None
    return (stages or {}).get(STAGE) or None
