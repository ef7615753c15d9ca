"""K3 — SDDMM Tensor Core stream (the reference's MXU stream).

Stream mapping: the reference package runs this stream on the TPU's MXU
(``src/repro/kernels/sddmm_mxu.py``); here it runs on the H100's Tensor
Cores. The CUDA kernel (``csrc/sddmm_mxu.cu``) computes
``Sᵀ = Y[cols] · X_winᵀ`` with ``mma.sync`` m16n8k8 TF32 and applies the
paper's Bit-Decoding (``(bitmap[j] >> r) & 1``) in registers. It gathers
only the Y rows of columns whose bitmap is non-zero, staged by
``cp.async``, over feature slices of Y small enough to stay in L2
(:func:`slice_feats`), one launch a slice.

:func:`sddmm_mxu` launches the kernel for CUDA tensors and runs
:func:`repro_torch.kernels.ref.sddmm_tc_ref`, its plain fp32
twin, for CPU tensors; it never falls back from the
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


def sddmm_mxu(tc_cols, tc_bitmap, tc_window, x, y):
    """Bitmap-sampled block scores, shape ``(nb, 8, bk)``.

    Args:
      tc_cols: (nb, bk) i32 column (row of Y) of each condensed vector.
      tc_bitmap: (nb, bk) i32 8-bit occupancy words.
      tc_window: (nb,) i32 window (row-block) ids.
      x: (mrows, kf) f32 dense rows; window rows past ``mrows`` read as 0.
      y: (kcols, kf) f32 dense rows.
    """
    if _build.on_cpu(tc_cols, tc_bitmap, tc_window, x, y):
        return ref.sddmm_tc_ref(tc_cols, tc_bitmap, tc_window, x, y)
    dev = _build.check_operands(
        "sddmm_mxu", ("tc_cols", tc_cols, torch.int32, 2),
        ("tc_bitmap", tc_bitmap, torch.int32, 2),
        ("tc_window", tc_window, torch.int32, 1),
        ("x", x, torch.float32, 2), ("y", y, torch.float32, 2))
    nb, bk = tc_cols.shape
    kf = x.shape[1]
    if tc_bitmap.shape != tc_cols.shape or tuple(tc_window.shape) != (nb,) \
            or y.shape[1] != kf:
        raise ValueError(
            f"sddmm_mxu: shapes cols {tuple(tc_cols.shape)}, bitmap "
            f"{tuple(tc_bitmap.shape)}, window {tuple(tc_window.shape)}, "
            f"x {tuple(x.shape)}, y {tuple(y.shape)} disagree")
    out = torch.empty((nb, WINDOW, bk), dtype=torch.float32, device=dev)
    if nb == 0 or bk == 0:
        return out
    if kf == 0:
        return out.zero_()
    vec4 = kf % 4 == 0 and _build.aligned16(x, y)
    # A launch touches at most nb * bk rows of Y: a small table keeps
    # its gathers in L2 at any width, and needs fewer launches.
    width = slice_feats(min(y.shape[0], nb * bk), kf)
    with torch.cuda.device(dev):
        err = _build.library().sddmm_mxu_launch(
            tc_cols.data_ptr(), tc_bitmap.data_ptr(), tc_window.data_ptr(),
            x.data_ptr(), y.data_ptr(), out.data_ptr(), nb, bk, kf,
            x.shape[0], width, int(vec4),
            _build.stream_handle(dev))
    _build.check(err, "sddmm_mxu")
    sddmm_mxu.launches += 1
    return out


sddmm_mxu.launches = 0
