"""plan_build_s: host seconds of the plan build, ending in a
synchronisation: ``GraphOps(...)`` for a training cell,
``GNNService.register_*`` for a serving cell (the harness's
``plan_build`` span)."""


def read(rec):
    spans = rec.spans.spans.get("plan_build")
    return sum(spans) if spans else None
