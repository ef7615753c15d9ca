"""Empirical tuner: time a small candidate grid through the real apply
path and keep the argmin (the paper's Fig.-11 protocol, generalized from
the threshold alone to the whole :class:`TuneConfig`).

The grid is deliberately tiny — the *hardcoded default* config, the
analytical model's pick, and a handful of perturbations around it —
because every candidate pays a full preprocess and upload. The default
config is always candidate #0 and ties resolve to the earliest
candidate, so search can never lose to the defaults it replaces. Results
are meant to be memoized through :class:`repro_torch.tune.cache.PlanCache`
(see :func:`repro_torch.tune.tune_spmm`).

Candidates are timed through the port's ``LibraSpMM``/``LibraSDDMM`` on
the operator's device: ``backend="cuda"`` times the kernels on the card
(and raises without one, never timing the plain path instead),
``backend="torch"`` the plain path. A candidate whose build or launch
raises fails the search.

Timing is injectable (``timer(fn) -> seconds``) so tests drive the
search with a deterministic stub; the default timer is the median wall
time after a warm-up call, with the card synchronized around each rep.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.threshold import synchronize
from repro_torch.obs.ledger import get_ledger, record_apply
from repro_torch.obs.trace import get_tracer
from repro_torch.sparse.matrix import SparseCSR
from repro_torch.tune.model import (
    DEFAULT_TUNE,
    TuneConfig,
    model_tune_sddmm,
    model_tune_spmm,
)

Timer = Callable[[Callable[[], object]], float]


def median_timer(reps: int = 3, warmup: int = 1) -> Timer:
    def timer(fn: Callable[[], object]) -> float:
        for _ in range(warmup):
            fn()
        ts = []
        for _ in range(reps):
            synchronize()
            t0 = time.perf_counter()
            fn()
            synchronize()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))
    return timer


def _dedup(cands: list[TuneConfig]) -> list[TuneConfig]:
    seen, out = set(), []
    for c in cands:
        key = c.replace(source="x")
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


def spmm_candidates(a: SparseCSR, *, n: int, mode: str,
                    threshold: int | None, backend: str = "cuda",
                    bk: int | None = None,
                    ts_tile: int | None = None) -> list[TuneConfig]:
    """Candidate grid, shaped by what the timed backend can distinguish.

    Candidate #0 is the floor search can't lose to: the hardcoded
    default *plan* (default threshold/bk/ts_tile — plan parameters are
    read on every backend). On ``"torch"`` it carries the model's segment
    caps, which the plain path never reads (it runs the compact tables),
    so only thresholds are told apart there — the reference's ``"xla"``
    grid. On ``"cuda"`` it is the verbatim default config, and the §4.3
    ts/cs perturbations join the grid: the kernels walk the segment
    tables, so the caps change what runs. No tile or grid-order
    perturbations: no CUDA kernel reads them, so they would time the
    same launches and the argmin over them would be timer noise.
    """
    from repro_torch.core import preprocess as P

    model = model_tune_spmm(a, n=n, mode=mode, threshold=threshold,
                            bk=bk, ts_tile=ts_tile)
    default_thr = (threshold if threshold is not None
                   else P.DEFAULT_SPMM_THRESHOLD)
    default_plan = {"threshold": default_thr, "bk": bk, "ts_tile": ts_tile}
    if backend == "torch":
        cands = [model.replace(**default_plan), model]
    else:
        cands = [DEFAULT_TUNE.replace(**default_plan), model]
        cands.extend(_seg_cap_perturbations(model))
    if threshold is None and mode == "hybrid" and model.threshold is not None:
        for t in (model.threshold - 1, model.threshold + 1):
            if 1 <= t <= 9:
                cands.append(model.replace(threshold=t))
    return _dedup(cands)


def _seg_cap_perturbations(model: TuneConfig) -> list[TuneConfig]:
    """§4.3 Ts/Cs cap perturbations around the model's pick. Segment
    caps re-layout the plan (the launch tables change), so they only
    matter where the executable iterates them — the kernel backend."""
    out = []
    if model.ts is not None and model.ts > 0:
        for ts in (max(model.ts // 2, 1), min(model.ts * 2, 64)):
            if ts != model.ts:
                out.append(model.replace(ts=ts))
    if model.cs is not None and model.cs > 0:
        tile = model.ts_tile or 32
        for cs in (max(model.cs // 2, tile), min(model.cs * 2, 16 * tile)):
            if cs != model.cs:
                out.append(model.replace(cs=cs))
    return out


def sddmm_candidates(a: SparseCSR, *, kf: int, mode: str,
                     threshold: int | None, backend: str = "cuda",
                     bk: int | None = None,
                     ts_tile: int | None = None) -> list[TuneConfig]:
    """See :func:`spmm_candidates` for the backend-shaped grid rationale."""
    from repro_torch.core import preprocess as P

    model = model_tune_sddmm(a, kf=kf, mode=mode, threshold=threshold,
                             bk=bk, ts_tile=ts_tile)
    default_thr = (threshold if threshold is not None
                   else P.DEFAULT_SDDMM_THRESHOLD)
    default_plan = {"threshold": default_thr, "bk": bk, "ts_tile": ts_tile}
    if backend == "torch":
        cands = [model.replace(**default_plan), model]
    else:
        cands = [DEFAULT_TUNE.replace(**default_plan), model]
        cands.extend(_seg_cap_perturbations(model))
    if threshold is None and mode == "hybrid" and model.threshold is not None:
        for t in (max(model.threshold // 2, 1), model.threshold * 2):
            cands.append(model.replace(threshold=t))
    return _dedup(cands)


def _timing_device(backend: str, device) -> torch.device:
    """The device candidates run on; the kernel backend times the card."""
    from repro_torch.api import BACKENDS, checked_device

    if backend not in BACKENDS:
        raise ValueError(
            f"tune_backend must be one of {BACKENDS}, got {backend!r}")
    dev = checked_device(device, "tune='search'")
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError(
            "tune='search' with tune_backend='cuda' times the kernels on "
            f"the card, but the operator's device is {device!r}; pass "
            "tune_backend='torch' to time the plain path")
    return dev


def search_spmm(a: SparseCSR, *, n: int = 128, backend: str = "cuda",
                mode: str = "hybrid", threshold: int | None = None,
                candidates: list[TuneConfig] | None = None,
                timer: Timer | None = None, bk: int | None = None,
                ts_tile: int | None = None, seed: int = 0,
                device="cuda") -> tuple[TuneConfig, dict[int, float]]:
    """Time each candidate through ``LibraSpMM.__call__`` on ``device``;
    return the argmin config (``source="search"``) and per-candidate
    seconds."""
    from repro_torch.api import ExecSpec
    from repro_torch.core.spmm import LibraSpMM

    dev = _timing_device(backend, device)
    candidates = candidates if candidates is not None else spmm_candidates(
        a, n=n, mode=mode, threshold=threshold, backend=backend, bk=bk,
        ts_tile=ts_tile)
    timer = timer or median_timer()
    rng = np.random.default_rng(seed)
    b = torch.from_numpy(rng.standard_normal((a.k, n)).astype(
        np.float32)).to(dev)
    best_i, timings = 0, {}
    with get_tracer().span("tune.search", op="spmm", backend=backend,
                           candidates=len(candidates)) as sp:
        for i, cand in enumerate(candidates):
            op = LibraSpMM(a, spec=ExecSpec(
                mode=mode, threshold=cand.threshold, tune=cand,
                backend=backend, device=str(dev)))
            timings[i] = timer(lambda: op(b))
            sp.event("candidate", index=i, threshold=cand.threshold,
                     seconds=timings[i])
            if get_ledger() is not None:
                record_apply(op, "spmm", width=n, dtype="float32",
                             backend=backend, wall_s=timings[i],
                             source="search")
            if timings[i] < timings[best_i]:
                best_i = i
        sp.set(best=best_i, best_seconds=timings[best_i])
    return candidates[best_i].replace(source="search"), timings


def search_sddmm(a: SparseCSR, *, kf: int = 128, backend: str = "cuda",
                 mode: str = "hybrid", threshold: int | None = None,
                 candidates: list[TuneConfig] | None = None,
                 timer: Timer | None = None, bk: int | None = None,
                 ts_tile: int | None = None, seed: int = 0,
                 device="cuda") -> tuple[TuneConfig, dict[int, float]]:
    """Time each candidate through ``LibraSDDMM.__call__`` on ``device``
    (see :func:`search_spmm`)."""
    from repro_torch.api import ExecSpec
    from repro_torch.core.sddmm import LibraSDDMM

    dev = _timing_device(backend, device)
    candidates = candidates if candidates is not None else sddmm_candidates(
        a, kf=kf, mode=mode, threshold=threshold, backend=backend, bk=bk,
        ts_tile=ts_tile)
    timer = timer or median_timer()
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((a.m, kf)).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(rng.standard_normal((a.k, kf)).astype(
        np.float32)).to(dev)
    best_i, timings = 0, {}
    with get_tracer().span("tune.search", op="sddmm", backend=backend,
                           candidates=len(candidates)) as sp:
        for i, cand in enumerate(candidates):
            op = LibraSDDMM(a, spec=ExecSpec(
                mode=mode, sddmm_threshold=cand.threshold, tune=cand,
                backend=backend, device=str(dev)))
            timings[i] = timer(lambda: op(x, y))
            sp.event("candidate", index=i, threshold=cand.threshold,
                     seconds=timings[i])
            if get_ledger() is not None:
                record_apply(op, "sddmm", width=kf, dtype="float32",
                             backend=backend, wall_s=timings[i],
                             source="search")
            if timings[i] < timings[best_i]:
                best_i = i
        sp.set(best=best_i, best_seconds=timings[best_i])
    return candidates[best_i].replace(source="search"), timings
