"""plan_tune_s: host seconds of the plan build's stage of the tuner
(``plan.tune``: the analytical model, or a tune-cache hit), summed over
the legs. The program's stage counters: ``GraphOps.build_s`` (train) or
the serving registry's ``plan_build_s()`` (serve), kept for every build;
None where the stage did no work or the program keeps no counters."""

STAGE = "tune"


def read(rec):
    gops = getattr(rec.world, "gops", None)
    if gops is not None:
        stages = getattr(gops, "build_s", None)
    else:
        reg = rec.world.service.engine.registry
        stages = reg.plan_build_s() if hasattr(reg, "plan_build_s") else None
    return (stages or {}).get(STAGE) or None
