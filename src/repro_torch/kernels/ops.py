"""The hybrid SpMM/SDDMM apply: both streams' kernels, plus the combine
for SpMM.

``backend="cuda"`` runs the four Hopper kernels over the §4.3 segment
launch tables when the plan has them (the default) and over the compact
per-block/per-tile tables otherwise (``TuneConfig(ts=0, cs=0)``).
``backend="torch"`` runs the plain reference path over the compact
tables. On CPU tensors the kernel wrappers run their plain twins, so
``backend="cuda"`` is testable on the CPU too. A kernel that fails to
build or launch raises :class:`ApplyError` (stage ``"compile"`` or
``"execute"``).

The SpMM combine stays outside the kernels, as in the reference
package: one ``index_add_`` of both streams' partials into a zeroed
``(nwin*8, n)`` output. Non-atomic segments own their rows, so their add
is a store in effect; atomic ones (decomposed windows/rows, windows
shared by both streams) accumulate. The SDDMM needs none: the plan gives
each canonical position exactly one owner among both streams' live
slots, so K3 and K4 store every score at its position in the ``(nnz,)``
output themselves, and padding stores nothing (the plain path's
``ref.scatter_scores`` adds into a swallow slot instead).

On the kernel path the applies also take a batch: dense operands with a
leading batch axis, and tables that are shared by the batch or carry
one of their own. Each kernel then launches once for the whole batch
(the reference's ``vmap`` of the apply, a batch grid axis on the TPU)
and one combine covers every element, each element's result bit for
bit its single apply's; an SDDMM element's scores sit ``nnz`` apart.
The ``*_apply_stack`` forms apply one plan to a stack of panels this
way, the serving shape;
:mod:`repro_torch.dist.sparse` applies the shards of one card this way.
:func:`apply_at` runs an operator's apply and counts its keys.

On the kernel path each apply opens spans
(:mod:`repro_torch.obs.trace`): ``apply.tc`` (K1/K3), ``apply.cc``
(K2/K4) and, for SpMM, ``apply.combine`` (attribute ``op="spmm"``; the
combine's zeros, concatenations and ``index_add_``), the combine on the
device clock; a stack's revaluation is ``apply.revalue``.
"""
from __future__ import annotations

import math
import time

import torch

from repro_torch.core.formats import WINDOW
from repro_torch.core.threshold import synchronize
from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import ApplyError
from repro_torch.kernels.sddmm_mxu import sddmm_mxu
from repro_torch.kernels.sddmm_vpu import sddmm_vpu
from repro_torch.kernels.spmm_mxu import spmm_mxu
from repro_torch.kernels.spmm_vpu import spmm_vpu
from repro_torch.obs.trace import NULL_SPAN, get_tracer, span

__all__ = ["ApplyError", "apply_at", "classify_apply_error",
           "sddmm_apply", "sddmm_apply_stack", "spmm_apply",
           "spmm_apply_stack"]


def classify_apply_error(exc: BaseException) -> str:
    """Map an apply-path exception to a short failure class:
    ``compile`` | ``resource`` | ``injected`` | ``nonfinite`` |
    ``runtime``. Duck-typed (name/message heuristics for the
    out-of-memory family) so callers never import backend guts."""
    if isinstance(exc, ApplyError):
        return exc.stage if exc.stage != "execute" else \
            classify_apply_error(exc.cause)
    kind = getattr(exc, "kind", None)       # serve.faults.InjectedFault
    if kind in ("raise", "resource"):
        return "resource" if kind == "resource" else "injected"
    name = type(exc).__name__.lower()
    msg = str(exc).lower()
    if "resource" in name or "resource_exhausted" in msg \
            or "out of memory" in msg:
        return "resource"
    if "nonfinite" in name or "non-finite" in msg:
        return "nonfinite"
    return "runtime"


def kernels_ready(backend: str, device: torch.device) -> None:
    """Build (or load) the kernel library when ``backend`` launches the
    kernels on a card, so that a build failure surfaces where an apply
    key is first used."""
    if backend == "cuda" and device.type == "cuda":
        _build.library()


def apply_at(seen: set, key, device: torch.device, fn, *args,
             backend: str, sample=None, **kw):
    """One operator apply, ``fn(*args, backend=backend, **kw)``, at
    ``key``.

    The counterpart of the reference's AOT executable cache. The kernels
    take any shape, so nothing is compiled per key: ``seen`` only holds
    the keys applied so far (the serving tier counts hits and misses by
    its size). The first apply at a key loads the kernel library on the
    card under a ``kernels.compile`` span; a failure there raises
    :class:`ApplyError` (stage ``"compile"``) and leaves the key unseen,
    so the next call tries again.

    ``sample`` (a ``(wall_s) -> None`` callable, usually from
    :func:`repro_torch.obs.ledger.apply_sampler`) opts this apply into
    perf-ledger recording: it is timed from a synchronised card to
    ``torch.cuda.synchronize()`` after it (asynchronous launches would
    time the enqueue, not the kernels), and the wall seconds handed to
    ``sample``. While the process tracer records, the apply is a
    ``kernels.execute`` span: a profiler range around the apply's
    kernels while the profiler records.
    """
    tr = get_tracer()
    active = tr.active
    if key not in seen:
        try:
            with (tr.span("kernels.compile", key=str(key)) if active
                  else NULL_SPAN):
                kernels_ready(backend, device)
        except Exception as exc:
            raise ApplyError("compile", key, exc) from exc
        seen.add(key)
    if not active and sample is None:
        return fn(*args, backend=backend, **kw)
    sp = tr.span("kernels.execute", key=str(key)).open() \
        if active else None
    try:
        if sample is None:
            return fn(*args, backend=backend, **kw)
        synchronize()
        t0 = time.perf_counter()
        out = fn(*args, backend=backend, **kw)
        synchronize()
        sample(time.perf_counter() - t0)
        return out
    finally:
        if sp is not None:
            sp.close()


def _add_rows(rows: torch.Tensor, data: torch.Tensor,
              height: int) -> torch.Tensor:
    """The SpMM combine: ``data``'s rows ``(..., R, n)`` added into a
    zeroed ``(..., height, n)`` output at ``rows`` (``(R,)``, or one set
    an element of a batch) by one ``index_add_``, each batch element's
    rows offset by its height."""
    *lead, r, n = data.shape
    batch = math.prod(lead)
    idx = rows.long().reshape(-1, r)
    idx = idx + torch.arange(batch, device=idx.device)[:, None] * height
    out = torch.zeros((batch * height, n), dtype=torch.float32,
                      device=data.device)
    out.index_add_(0, idx.reshape(-1), data.reshape(batch * r, n))
    return out.view(*lead, height, n)


def spmm_apply(arrs, b: torch.Tensor, *, m: int, nwin: int,
               backend: str = "cuda") -> torch.Tensor:
    """Hybrid SpMM: ``C[m, n] = A_sp @ B`` from a preprocessed plan.

    On the kernel path ``b`` may be a ``(batch, k, n)`` stack (see the
    module docstring): ``(batch, m, n)``, K1 and K2 once each."""
    if backend == "torch":
        return ref.spmm_hybrid_ref(arrs, b, m, nwin)
    if backend != "cuda":
        raise ValueError(f"unknown backend {backend!r}")
    with span("apply.tc"):
        if "tc_seg_vals" in arrs:
            # Segment-granular launch (§4.3 Ts): one segment of ≤ ts
            # blocks of one window per thread block, each with its own
            # output slab; the kernel reads each segment's real vectors
            # (``tc_len``).
            nseg = arrs["tc_seg_rank"].shape[-1]
            tc = spmm_mxu(arrs["tc_seg_vals"], arrs["tc_seg_cols"],
                          arrs["tc_seg_rank"], b, n_active=nseg,
                          unique_ranks=True, seg_len=arrs.get("tc_len"))
            tc_rows = arrs["tc_seg_row"]
        else:
            n_active = arrs["tc_active_row"].shape[-1] // WINDOW
            tc = spmm_mxu(arrs["tc_vals"], arrs["tc_cols"], arrs["tc_rank"],
                          b, n_active=n_active, seg_len=arrs.get("tc_len"))
            tc_rows = arrs["tc_active_row"]
    # CUDA cores: §4.3 Cs row-segments of ≤ cs residual elements when the
    # plan has them, else tiles; the kernel reads each row's real prefix
    # (``vpu_len``).
    with span("apply.cc"):
        seg = "_seg" if "vpu_seg_vals" in arrs else ""
        partials = spmm_vpu(arrs[f"vpu{seg}_vals"], arrs[f"vpu{seg}_cols"],
                            b, seg_len=arrs.get("vpu_len"))
        vpu_rows = arrs[f"vpu{seg}_row"]
    # Combine: one scatter-add of both streams' partials into a zeroed C
    # (rows ≥ m from the padded last window are sliced off).
    with span("apply.combine", b, op="spmm"):
        rows = torch.cat([tc_rows.expand(*tc.shape[:-2], -1),
                          vpu_rows.expand(*partials.shape[:-2], -1)], -1)
        out = _add_rows(rows, torch.cat([tc, partials], -2), nwin * WINDOW)
    return out[..., :m, :]


def sddmm_apply(arrs, x: torch.Tensor, y: torch.Tensor, *, nnz: int,
                backend: str = "cuda") -> torch.Tensor:
    """Hybrid SDDMM: ``values[nnz] = sample(X @ Yᵀ)`` in canonical CSR
    order.

    On the kernel path ``x``/``y`` may be ``(batch, rows, kf)`` stacks
    (see the module docstring): ``(batch, nnz)``, K3 and K4 once each.
    Both kernels store into one output at the plan's positions; a
    position no live slot owns (a partition shard's tail past its own
    non-zeros) is left unwritten."""
    if backend == "torch":
        return ref.sddmm_hybrid_ref(arrs, x, y, nnz)
    if backend != "cuda":
        raise ValueError(f"unknown backend {backend!r}")
    batch = _build.batch_of(x, y)
    out = torch.empty((*(() if batch is None else (batch,)), nnz),
                      dtype=torch.float32, device=x.device)
    with span("apply.tc"):
        # §4.3 Ts: one thread block scores a segment of ≤ ts blocks
        # sharing a window (zero-bitmap padding, out_pos −1, stores
        # nothing); else the compact per-block tables.
        seg = "_seg" if "tc_seg_cols" in arrs else ""
        sddmm_mxu(arrs[f"tc{seg}_cols"], arrs[f"tc{seg}_bitmap"],
                  arrs[f"tc{seg}_window"], x, y,
                  out_pos=arrs[f"tc{seg}_out_pos"], out=out)
    with span("apply.cc"):
        # The Cs cap batches whole element tiles per segment.
        seg = "_seg" if "vpu_seg_rows" in arrs else ""
        sddmm_vpu(arrs[f"vpu{seg}_rows"], arrs[f"vpu{seg}_cols"], x, y,
                  out_pos=arrs[f"vpu{seg}_out_pos"],
                  mask=arrs[f"vpu{seg}_mask"], out=out)
    return out


def spmm_apply_stack(arrs, b_stack: torch.Tensor, *, m: int, nwin: int,
                     backend: str = "cuda",
                     edge_vals: torch.Tensor | None = None) -> torch.Tensor:
    """Panel-stack hybrid SpMM: one plan over a ``(batch, k, n)`` stack.

    The serving-shape primitive: a graph's plan is the amortized asset,
    requests arrive as feature panels. On the kernel path the stack is
    one launch of K1 and one of K2 over the plan's tables, and one
    combine; every panel's result is bit for bit its single apply's.
    ``edge_vals`` — optional ``(batch, nnz)`` canonical per-panel values
    — revalues the plan per panel (``arrs`` then holds the position maps,
    ``for_backend(..., revalue=True)``) by one gather over the position
    maps: the attention-serving path, pattern shared and values per
    request. ``backend="torch"`` runs the plain path panel by panel.
    """
    if b_stack.shape[0] == 0:
        return b_stack.new_zeros((0, m, b_stack.shape[2]))
    if backend == "torch":
        return torch.stack([
            spmm_apply(arrs if edge_vals is None
                       else ref.revalue_spmm_arrays(arrs, edge_vals[i]),
                       b, m=m, nwin=nwin, backend=backend)
            for i, b in enumerate(b_stack)])
    if edge_vals is not None:
        with span("apply.revalue"):
            arrs = ref.revalue_spmm_arrays(arrs, edge_vals)
    return spmm_apply(arrs, b_stack, m=m, nwin=nwin, backend=backend)


def sddmm_apply_stack(arrs, x_stack: torch.Tensor, y_stack: torch.Tensor,
                      *, nnz: int, backend: str = "cuda") -> torch.Tensor:
    """Panel-stack hybrid SDDMM: ``(batch, m, kf) × (batch, k, kf) →
    (batch, nnz)``; on the kernel path one launch of K3 and one of K4
    (see :func:`spmm_apply_stack`)."""
    if x_stack.shape[0] == 0:
        return x_stack.new_zeros((0, nnz))
    if backend == "torch":
        return torch.stack([sddmm_apply(arrs, x, y, nnz=nnz, backend=backend)
                            for x, y in zip(x_stack, y_stack)])
    return sddmm_apply(arrs, x_stack, y_stack, nnz=nnz, backend=backend)
