"""K3 — SDDMM Tensor Core stream (the reference's MXU stream).

Stream mapping: the reference package runs this stream on the TPU's MXU
(``src/repro/kernels/sddmm_mxu.py``); here it runs on the H100's Tensor
Cores. The CUDA kernel (``csrc/sddmm_mxu.cu``) computes
``Sᵀ = Y[cols] · X_winᵀ`` with ``mma.sync`` m16n8k8 TF32 and applies the
paper's Bit-Decoding (``(bitmap[j] >> r) & 1``) in registers. It gathers
only the Y rows of columns whose bitmap is non-zero, staged by
``cp.async``, over feature slices of Y small enough to stay in L2
(:func:`slice_feats`), one launch a slice. A batch of dense operands (a
panel stack, a partition's shards) runs with a batch grid axis. Given the
plan's position table, the last slice stores each kept score at its
canonical CSR position, the SDDMM's output; without one the scores come
back laid out as the table.

:func:`sddmm_mxu` launches the kernel for CUDA tensors and runs
:func:`repro_torch.kernels.ref.sddmm_tc_ref`, its plain fp32
twin (then :func:`~repro_torch.kernels.ref.place_scores` for the
canonical store), for CPU tensors; it never falls back from the
card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import WINDOW
from repro_torch.kernels import _build, ref

#: The narrowest and widest feature slices the kernel is built for.
MIN_SLICE, MAX_SLICE = 16, 128


def slice_feats(k: int, kf: int) -> int:
    """Features of Y that one launch gathers: the widest power of two in
    [MIN_SLICE, MAX_SLICE] whose ``k`` rows fit
    :data:`_build.L2_SLICE_BYTES`, narrowed to the fewest that cover
    ``kf`` in as many slices."""
    return _build.pow2_slice(k, kf, MIN_SLICE, MAX_SLICE)


def sddmm_mxu(tc_cols, tc_bitmap, tc_window, x, y, out_pos=None, out=None):
    """Bitmap-sampled block scores, shape ``(nb, 8, bk)``, or ``(batch,
    nb, 8, bk)`` for a batch; with ``out_pos``, ``out`` holding them at
    their canonical positions.

    Args:
      tc_cols: (nb, bk) i32 column (row of Y) of each condensed vector.
      tc_bitmap: (nb, bk) i32 8-bit occupancy words.
      tc_window: (nb,) i32 window (row-block) ids.
      x: (mrows, kf) f32 dense rows; window rows past ``mrows`` read as 0.
      y: (kcols, kf) f32 dense rows.
      out_pos: optional (nb, 8, bk) i32 canonical position of each score,
        −1 for padding.
      out: with ``out_pos``, the (nnz,) f32 output, ``(batch, nnz)`` for a
        batch. A score is stored where its bit is set and its position is
        not −1; nothing else of ``out`` is written.

    ``x`` and ``y`` may carry a leading batch axis ``(batch, rows, kf)``:
    one launch (a feature slice) for the whole batch, the TPU kernel's
    vmapped form; each table may then carry one too or be shared.
    """
    batch = _build.batch_of(x, y)
    canonical = out_pos is not None
    operands = (tc_cols, tc_bitmap, tc_window, x, y) + (
        (out_pos, out) if canonical else ())
    if _build.on_cpu(*operands):
        if batch is None:
            s = ref.sddmm_tc_ref(tc_cols, tc_bitmap, tc_window, x, y)
        else:
            s = ref.over_batch(ref.sddmm_tc_ref, (tc_cols, 2),
                               (tc_bitmap, 2), (tc_window, 1), (x, 2),
                               (y, 2))
        if not canonical:
            return s
        kept = ref.bitmap_mask(tc_bitmap) & (out_pos >= 0)
        return ref.place_scores(s, out_pos, kept, out)
    lead = () if batch is None else (batch,)
    tables = (("out_pos", out_pos, torch.int32, 3),
              ("out", out, torch.float32, 1)) if canonical else ()
    dev = _build.check_operands(
        "sddmm_mxu", ("tc_cols", tc_cols, torch.int32, 2),
        ("tc_bitmap", tc_bitmap, torch.int32, 2),
        ("tc_window", tc_window, torch.int32, 1),
        ("x", x, torch.float32, 2), ("y", y, torch.float32, 2), *tables,
        batch=batch)
    nb, bk = tc_cols.shape[-2:]
    mrows, kf = x.shape[-2:]
    if tc_bitmap.shape[-2:] != tc_cols.shape[-2:] \
            or tuple(tc_window.shape[-1:]) != (nb,) or y.shape[-1] != kf \
            or (canonical and (tuple(out_pos.shape[-3:]) != (nb, WINDOW, bk)
                               or out.dim() != len(lead) + 1)):
        raise ValueError(
            f"sddmm_mxu: shapes cols {tuple(tc_cols.shape)}, bitmap "
            f"{tuple(tc_bitmap.shape)}, window {tuple(tc_window.shape)}, "
            f"x {tuple(x.shape)}, y {tuple(y.shape)}"
            + (f", out_pos {tuple(out_pos.shape)}, out {tuple(out.shape)}"
               if canonical else "") + " disagree")
    if not canonical:
        out = torch.empty((*lead, nb, WINDOW, bk), dtype=torch.float32,
                          device=dev)
        if out.numel() == 0:
            return out
        if kf == 0:
            return out.zero_()
    elif nb * bk == 0 or out.shape[-1] == 0:
        return out
    elif kf == 0:
        kept = ref.bitmap_mask(tc_bitmap) & (out_pos >= 0)
        return ref.place_scores(torch.zeros(
            (*lead, nb, WINDOW, bk), device=dev), out_pos, kept, out)
    vec4 = kf % 4 == 0 and _build.aligned16(x, y)
    # A launch touches at most nb * bk rows of Y: a small table keeps
    # its gathers in L2 at any width, and needs fewer launches. A batch
    # element slices as its single launch does, so its sums are the same.
    width = slice_feats(min(y.shape[-2], nb * bk), kf)
    staged = None
    if canonical and kf > width:  # the earlier slices' scratch
        staged = torch.empty((*lead, nb, WINDOW, bk), dtype=torch.float32,
                             device=dev)
    bs = _build.batch_stride
    ptr = _build.data_ptr
    with torch.cuda.device(dev):
        err = _build.library().sddmm_mxu_launch(
            tc_cols.data_ptr(), tc_bitmap.data_ptr(), tc_window.data_ptr(),
            ptr(out_pos), x.data_ptr(), y.data_ptr(), out.data_ptr(),
            ptr(staged), batch or 1, nb, bk, kf, mrows, bs(tc_cols, 2),
            bs(tc_bitmap, 2), bs(tc_window, 1), bs(out_pos, 3), bs(x, 2),
            bs(y, 2), bs(out, 1 if canonical else 3), bs(staged, 3), width,
            int(vec4), _build.stream_handle(dev))
    _build.check(err, "sddmm_mxu")
    sddmm_mxu.launches += 1
    return out


sddmm_mxu.launches = 0
