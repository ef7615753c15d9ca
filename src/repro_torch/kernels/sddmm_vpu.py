"""K4 — SDDMM CUDA-core stream (the reference's VPU stream).

Stream mapping: the reference package runs this stream on the TPU's VPU
(``src/repro/kernels/sddmm_vpu.py``); here it runs on the H100's CUDA
cores. The CUDA kernel (``csrc/sddmm_vpu.cu``) scores runs of 32
consecutive elements a warp, a group of lanes an element, over feature
slices of Y small enough to stay in L2 (:func:`slice_feats`), one launch
a slice, adding the slices' partial dot products in order. A batch of
dense operands (a panel stack, a partition's shards) runs with a batch
grid axis. Given the plan's position table and mask, the last slice
stores each masked-in score at its canonical CSR position, the SDDMM's
output; without them the scores come back laid out as the table.

:func:`sddmm_vpu` launches the kernel for CUDA tensors and runs
:func:`repro_torch.kernels.ref.sddmm_pair_scores`, its plain
fp32 twin (then :func:`~repro_torch.kernels.ref.place_scores` for the
canonical store), for CPU tensors; it never falls back from the
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


def sddmm_vpu(rows, cols, x, y, out_pos=None, mask=None, out=None):
    """Element scores, shape ``(ntiles, ts)``, or ``(batch, ntiles, ts)``
    for a batch (the caller applies the mask); with ``out_pos``, ``out``
    holding the masked-in ones at their canonical positions.

    Args:
      rows, cols: (ntiles, ts) i32 row of X / row of Y of each element.
      x: (mrows, kf) f32; y: (kcols, kf) f32.
      out_pos: optional (ntiles, ts) i32 canonical position of each
        element; ``mask`` (ntiles, ts) bool marks the real ones.
      out: with ``out_pos``, the (nnz,) f32 output, ``(batch, nnz)`` for a
        batch. A score is stored where ``mask`` holds; nothing else of
        ``out`` is written.

    ``x`` and ``y`` may carry a leading batch axis ``(batch, rows, kf)``:
    one launch (a feature slice) for the whole batch, the TPU kernel's
    vmapped form; the tables may then carry one too or be shared.
    """
    batch = _build.batch_of(x, y)
    canonical = out_pos is not None
    operands = (rows, cols, x, y) + ((out_pos, mask, out) if canonical
                                      else ())
    if _build.on_cpu(*operands):
        if batch is None:
            s = ref.sddmm_pair_scores(rows, cols, x, y)
        else:
            s = ref.over_batch(ref.sddmm_pair_scores, (rows, 2), (cols, 2),
                               (x, 2), (y, 2))
        return ref.place_scores(s, out_pos, mask, out) if canonical else s
    lead = () if batch is None else (batch,)
    tables = (("out_pos", out_pos, torch.int32, 2),
              ("mask", mask, torch.bool, 2),
              ("out", out, torch.float32, 1)) if canonical else ()
    dev = _build.check_operands(
        "sddmm_vpu", ("rows", rows, torch.int32, 2),
        ("cols", cols, torch.int32, 2), ("x", x, torch.float32, 2),
        ("y", y, torch.float32, 2), *tables, batch=batch)
    kf = x.shape[-1]
    table = rows.shape[-2:]
    if cols.shape[-2:] != table or y.shape[-1] != kf \
            or (canonical and (out_pos.shape[-2:] != table
                               or mask.shape[-2:] != table
                               or out.dim() != len(lead) + 1)):
        raise ValueError(
            f"sddmm_vpu: shapes rows {tuple(rows.shape)}, cols "
            f"{tuple(cols.shape)}, x {tuple(x.shape)}, y {tuple(y.shape)}"
            + (f", out_pos {tuple(out_pos.shape)}, mask "
               f"{tuple(mask.shape)}, out {tuple(out.shape)}"
               if canonical else "") + " disagree")
    if not canonical:
        out = torch.empty((*lead, *table), dtype=torch.float32, device=dev)
        if out.numel() == 0:
            return out
        if kf == 0:
            return out.zero_()
    elif table.numel() == 0 or out.shape[-1] == 0:
        return out
    elif kf == 0:
        return ref.place_scores(torch.zeros((*lead, *table), device=dev),
                                out_pos, mask, out)
    vec4 = kf % 4 == 0 and _build.aligned16(x, y)
    width = slice_feats(y.shape[-2], kf, vec4)
    staged = None
    if canonical and kf > width:  # the earlier slices' scratch
        staged = torch.empty((*lead, *table), dtype=torch.float32,
                             device=dev)
    bs = _build.batch_stride
    ptr = _build.data_ptr
    with torch.cuda.device(dev):
        err = _build.library().sddmm_vpu_launch(
            rows.data_ptr(), cols.data_ptr(), ptr(out_pos), ptr(mask),
            x.data_ptr(), y.data_ptr(), out.data_ptr(), ptr(staged),
            batch or 1, table.numel(), kf, bs(rows, 2), bs(cols, 2),
            bs(out_pos, 2), bs(mask, 2), bs(x, 2), bs(y, 2),
            bs(out, 1 if canonical else 2), bs(staged, 2), width,
            int(vec4), _build.stream_handle(dev))
    _build.check(err, "sddmm_vpu")
    sddmm_vpu.launches += 1
    return out


sddmm_vpu.launches = 0
