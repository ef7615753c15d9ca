"""K4 — SDDMM CUDA-core stream (the reference's VPU stream).

Stream mapping: the reference package runs this stream on the TPU's VPU
(``src/repro/kernels/sddmm_vpu.py``); here it runs on the H100's CUDA
cores. The CUDA kernel (``csrc/sddmm_vpu.cu``) scores runs of 32
consecutive elements a warp, a group of lanes an element, over feature
slices of Y small enough to stay in L2 (:func:`slice_feats`), one launch
a slice, adding the slices' partial dot products in order. A batch of
dense operands (a panel stack, a partition's shards) runs with a batch
grid axis.

:func:`sddmm_vpu` launches the kernel for CUDA tensors and runs
:func:`repro_torch.kernels.ref.sddmm_pair_scores`, its plain
fp32 twin, for CPU tensors; it never falls back from the
card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def slice_feats(k: int, kf: int, vec4: bool) -> int:
    """Features of Y that one launch gathers: the widest power-of-two
    number of lanes (float4 or scalar features each, at most 32) whose
    ``k`` rows fit :data:`_build.L2_SLICE_BYTES`, narrowed to the fewest
    lanes that cover ``kf`` in as many slices."""
    unit = 4 if vec4 else 1
    return _build.pow2_slice(k, kf, unit, 32 * unit)


def sddmm_vpu(rows, cols, x, y):
    """Element scores, shape ``(ntiles, ts)``, or ``(batch, ntiles, ts)``
    for a batch (the caller applies the mask).

    Args:
      rows, cols: (ntiles, ts) i32 row of X / row of Y of each element.
      x: (mrows, kf) f32; y: (kcols, kf) f32.

    ``x`` and ``y`` may carry a leading batch axis ``(batch, rows, kf)``:
    one launch (a feature slice) for the whole batch, the TPU kernel's
    vmapped form; ``rows``/``cols`` may then carry one too or be shared.
    """
    batch = _build.batch_of(x, y)
    if _build.on_cpu(rows, cols, x, y):
        if batch is None:
            return ref.sddmm_pair_scores(rows, cols, x, y)
        return ref.over_batch(ref.sddmm_pair_scores, (rows, 2), (cols, 2),
                              (x, 2), (y, 2))
    dev = _build.check_operands(
        "sddmm_vpu", ("rows", rows, torch.int32, 2),
        ("cols", cols, torch.int32, 2), ("x", x, torch.float32, 2),
        ("y", y, torch.float32, 2), batch=batch)
    kf = x.shape[-1]
    if rows.shape[-2:] != cols.shape[-2:] or y.shape[-1] != kf:
        raise ValueError(
            f"sddmm_vpu: shapes rows {tuple(rows.shape)}, cols "
            f"{tuple(cols.shape)}, x {tuple(x.shape)}, y {tuple(y.shape)} "
            "disagree")
    lead = () if batch is None else (batch,)
    out = torch.empty((*lead, *rows.shape[-2:]), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    if kf == 0:
        return out.zero_()
    vec4 = kf % 4 == 0 and _build.aligned16(x, y)
    bs = _build.batch_stride
    with torch.cuda.device(dev):
        err = _build.library().sddmm_vpu_launch(
            rows.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
            out.data_ptr(), batch or 1, rows.shape[-2] * rows.shape[-1], kf,
            bs(rows, 2), bs(cols, 2), bs(x, 2), bs(y, 2), bs(out, 2),
            slice_feats(y.shape[-2], kf, vec4), int(vec4),
            _build.stream_handle(dev))
    _build.check(err, "sddmm_vpu")
    sddmm_vpu.launches += 1
    return out


sddmm_vpu.launches = 0
