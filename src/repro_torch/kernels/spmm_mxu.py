"""K1 — SpMM Tensor Core stream (the reference's MXU stream).

Stream mapping: the reference package runs this stream on the TPU's MXU
(``src/repro/kernels/spmm_mxu.py``); here it runs on the H100's Tensor
Cores, as in the paper. The CUDA kernel (``csrc/spmm_mxu.cu``) computes
``outᵀ = B[cols]ᵀ · valsᵀ`` with ``mma.sync`` m16n8k8 TF32, the 8-row
window on the n=8 side (swap-and-transpose). It reads only each
segment's real vectors (:func:`real_lengths`), gathering their B rows
through a ``cp.async`` ring. A batch of dense operands (a panel stack, a
partition's shards) is one launch with a batch grid axis.

:func:`spmm_mxu` launches the kernel for CUDA tensors and runs
:func:`repro_torch.kernels.ref.spmm_tc_compact_ref`, its plain
fp32 twin, for CPU tensors; it never falls back from the
card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import WINDOW
from repro_torch.kernels import _build, ref
from repro_torch.kernels.spmm_vpu import real_lengths as row_lengths


def real_lengths(vals: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(nb,) i32 (with a leading batch axis if either table has one): one
    past the last condensed vector of each block whose column or any of
    whose 8 values is non-zero (K2's rule,
    :func:`repro_torch.kernels.spmm_vpu.real_lengths`, on each vector's
    largest |value|).
    Vectors past it are padding (values 0, column 0); a real all-zero
    vector at column 0 past the last such vector adds exactly what the
    padding adds, so the kernel gives the same result."""
    return row_lengths(vals.abs().amax(dim=-2), cols)


def spmm_mxu(tc_vals, tc_cols, tc_rank, b, *, n_active: int,
             unique_ranks: bool = False, seg_len=None):
    """Compacted Tensor Core partial output, shape ``(n_active * 8, n)``,
    or ``(batch, n_active * 8, n)`` for a batch.

    Args:
      tc_vals: (nb, 8, bk) f32 condensed blocks (zero padded). Under the
        segmented launch a "block" is one §4.3 segment — ``bk`` is then
        ``ts · bk`` flattened condensed vectors of a single window.
      tc_cols: (nb, bk) i32 source row of B for each condensed vector.
      tc_rank: (nb,) i32 compacted output slab of each block.
      b: (k, n) f32 dense matrix, or a ``(batch, k, n)`` stack: one
        launch for the whole batch (the TPU kernel's vmapped form). Each
        table may then carry a leading batch axis of its own (per-panel
        values, a partition's shards) or be shared by every element.
      n_active: number of output slabs (output height / 8).
      unique_ranks: every block owns its own slab (the segment table
        guarantees it), so the kernel stores; otherwise the output is
        zeroed and blocks sharing a slab add atomically.
      seg_len: optional (nb,) i32 length of each block's real prefix:
        vectors ``[0, len)`` are real, the rest is padding (the plan's
        own, :meth:`PlanArrays.tc_len`). Derived from the values and
        columns by :func:`real_lengths` when absent. The plain twin
        multiplies every vector, which gives the same result.
    """
    batch = _build.batch_of(b)
    if _build.on_cpu(tc_vals, tc_cols, tc_rank, b):
        # The plain twin's scatter-add covers both rank layouts.
        if batch is None:
            return ref.spmm_tc_compact_ref(tc_vals, tc_cols, tc_rank, b,
                                           n_active)
        return ref.over_batch(
            lambda v, c, r, bb: ref.spmm_tc_compact_ref(v, c, r, bb,
                                                        n_active),
            (tc_vals, 3), (tc_cols, 2), (tc_rank, 1), (b, 2))
    dev = _build.check_operands(
        "spmm_mxu", ("tc_vals", tc_vals, torch.float32, 3),
        ("tc_cols", tc_cols, torch.int32, 2),
        ("tc_rank", tc_rank, torch.int32, 1), ("b", b, torch.float32, 2),
        batch=batch)
    nb, win, bk = tc_vals.shape[-3:]
    n = b.shape[-1]
    if win != WINDOW or tuple(tc_cols.shape[-2:]) != (nb, bk) \
            or tuple(tc_rank.shape[-1:]) != (nb,):
        raise ValueError(
            f"spmm_mxu: shapes vals {tuple(tc_vals.shape)}, cols "
            f"{tuple(tc_cols.shape)}, rank {tuple(tc_rank.shape)} disagree")
    if unique_ranks and nb != n_active:
        raise ValueError(f"spmm_mxu: unique_ranks needs nb == n_active, "
                         f"got {nb} and {n_active}")
    lead = () if batch is None else (batch,)
    alloc = torch.empty if unique_ranks else torch.zeros
    out = alloc((*lead, n_active * WINDOW, n), dtype=torch.float32,
                device=dev)
    if out.numel() == 0 or nb == 0 or bk == 0:
        return out.zero_()
    if seg_len is None:
        seg_len = real_lengths(tc_vals, tc_cols)
    _build.check_operands("spmm_mxu", ("tc_vals", tc_vals, torch.float32, 3),
                          ("seg_len", seg_len, torch.int32, 1), batch=batch)
    if seg_len.shape[-1] != nb:
        raise ValueError(f"spmm_mxu: seg_len {tuple(seg_len.shape)} for "
                         f"{nb} blocks")
    vec4 = n % 4 == 0 and _build.aligned16(b, out)
    bs = _build.batch_stride
    with torch.cuda.device(dev):
        err = _build.library().spmm_mxu_launch(
            tc_vals.data_ptr(), tc_cols.data_ptr(), seg_len.data_ptr(),
            tc_rank.data_ptr(), b.data_ptr(), out.data_ptr(), batch or 1,
            nb, bk, n, bs(tc_vals, 3), bs(tc_cols, 2), bs(seg_len, 1),
            bs(tc_rank, 1), bs(b, 2), bs(out, 2), int(not unique_ranks),
            int(vec4), _build.stream_handle(dev))
    _build.check(err, "spmm_mxu")
    spmm_mxu.launches += 1
    return out


spmm_mxu.launches = 0
