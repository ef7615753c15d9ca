"""Occupancy-aware autotuning: 2D-aware cost model + search + plan cache.

Entry points used by :meth:`repro_torch.core.preprocess.Plan.build` (the
``ExecSpec.tune`` knob of every operator):

* ``tune="model"`` → :func:`tune_spmm`/:func:`tune_sddmm` run the
  analytical model (:mod:`repro_torch.tune.model`) — cheap, no timing;
* ``tune="search"`` → empirical argmin over a small candidate grid
  (:mod:`repro_torch.tune.search`), timed on ``ExecSpec.tune_backend``
  and memoized in the persistent :class:`~repro_torch.tune.cache.PlanCache`
  so a second construction of the same operator never re-times;
* ``tune="off"`` → the hardcoded defaults (:data:`DEFAULT_TUNE`);
* ``tune=TuneConfig(...)`` → use exactly that config (how the search
  itself evaluates candidates, and an escape hatch for experts).
"""
from __future__ import annotations

from repro_torch.tune.cache import PlanCache, matrix_signature, tune_key
from repro_torch.tune.model import (
    DEFAULT_TUNE,
    SMEM_BUDGET_BYTES,
    TuneConfig,
    matrix_features,
    model_tune_sddmm,
    model_tune_spmm,
    occupancy_report,
    sddmm_footprint,
    spmm_footprint,
)
from repro_torch.tune.search import (
    median_timer,
    search_sddmm,
    search_spmm,
    sddmm_candidates,
    spmm_candidates,
)

__all__ = [
    "DEFAULT_TUNE",
    "PlanCache",
    "SMEM_BUDGET_BYTES",
    "TuneConfig",
    "matrix_features",
    "matrix_signature",
    "median_timer",
    "model_tune_sddmm",
    "model_tune_spmm",
    "occupancy_report",
    "sddmm_candidates",
    "sddmm_footprint",
    "search_sddmm",
    "search_spmm",
    "spmm_candidates",
    "spmm_footprint",
    "tune_key",
    "tune_sddmm",
    "tune_spmm",
]


def _resolve(tune, *, a, op: str, width: int, dtype: str, backend: str,
             mode: str, threshold, cache, timer,
             model_fn, search_fn, bk=None, ts_tile=None) -> TuneConfig:
    if isinstance(tune, TuneConfig):
        return tune
    if tune == "off":
        return DEFAULT_TUNE.replace(threshold=threshold, bk=bk,
                                    ts_tile=ts_tile)
    # Forced single-resource modes pin the threshold (threshold_for_mode
    # resolves it at the call site); the tuner then only sizes the rest.
    if tune == "model":
        return model_fn(mode=mode, threshold=threshold)
    if tune == "search":
        pc = cache if isinstance(cache, PlanCache) else PlanCache(cache)
        key = tune_key(a, op=op, width=width, dtype=dtype, backend=backend,
                       mode=mode, tune="search", threshold=threshold,
                       bk=bk, ts_tile=ts_tile)
        hit = pc.get(key)
        if hit is not None:
            return hit
        cfg, timings = search_fn(mode=mode, threshold=threshold, timer=timer)
        pc.put(key, cfg, meta={"timings_s": {str(i): t
                                             for i, t in timings.items()}})
        return cfg
    raise ValueError(
        f"tune must be 'model', 'search', 'off' or a TuneConfig, got {tune!r}")


def tune_spmm(a, *, mode: str = "hybrid", threshold: int | None = None,
              tune="model", n: int = 128, dtype: str = "float32",
              backend: str = "cuda", cache=None, timer=None,
              bk: int | None = None, ts_tile: int | None = None,
              feat=None, device="cuda") -> TuneConfig:
    """Resolve the ``tune=`` knob for one SpMM operator construction.

    Explicit plan parameters (``bk``/``ts_tile``) are forwarded so the
    tuner prices — and the emitted config records — the plan that will
    actually be built. ``feat`` (a precomputed :func:`matrix_features`
    result) lets callers tuning several operators over the same matrix
    pay the feature pass once. ``device`` is where a search runs its
    candidates.
    """
    return _resolve(
        tune, a=a, op="spmm", width=n, dtype=dtype, backend=backend,
        mode=mode, threshold=threshold, cache=cache, timer=timer,
        bk=bk, ts_tile=ts_tile,
        model_fn=lambda **kw: model_tune_spmm(
            a, n=n, bk=bk, ts_tile=ts_tile, feat=feat, **kw),
        search_fn=lambda **kw: search_spmm(
            a, n=n, backend=backend, bk=bk, ts_tile=ts_tile, device=device,
            **kw),
    )


def tune_sddmm(a, *, mode: str = "hybrid", threshold: int | None = None,
               tune="model", kf: int = 128, dtype: str = "float32",
               backend: str = "cuda", cache=None, timer=None,
               bk: int | None = None, ts_tile: int | None = None,
               feat=None, device="cuda") -> TuneConfig:
    """Resolve the ``tune=`` knob for one SDDMM operator construction.

    ``bk``/``ts_tile``/``feat``/``device`` behave as in :func:`tune_spmm`.
    """
    return _resolve(
        tune, a=a, op="sddmm", width=kf, dtype=dtype, backend=backend,
        mode=mode, threshold=threshold, cache=cache, timer=timer,
        bk=bk, ts_tile=ts_tile,
        model_fn=lambda **kw: model_tune_sddmm(
            a, kf=kf, bk=bk, ts_tile=ts_tile, feat=feat, **kw),
        search_fn=lambda **kw: search_sddmm(
            a, kf=kf, backend=backend, bk=bk, ts_tile=ts_tile, device=device,
            **kw),
    )
