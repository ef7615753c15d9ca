"""K2 — SpMM CUDA-core stream (the reference's VPU stream).

Stream mapping: the reference package runs this stream on the TPU's VPU
(``src/repro/kernels/spmm_vpu.py``); here it runs on the H100's CUDA
cores with FP32 FMA, as in the paper. The CUDA kernel
(``csrc/spmm_vpu.cu``) reads only each row's real slots, runs slice-major
over column slices of B small enough to stay in L2 (:func:`slice_cols`),
and keeps several B-row gathers in flight on every lane. A batch of
dense operands (a panel stack, a partition's shards) is one launch with
a batch grid axis.

:func:`spmm_vpu` launches the kernel for CUDA tensors and runs
:func:`repro_torch.kernels.ref.spmm_tile_partials`, its plain
fp32 twin, for CPU tensors; it never falls back from the
card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def real_lengths(vals: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(ntiles,) i32 (with a leading batch axis if either table has one):
    one past the last slot of each row whose value or column is
    non-zero. Slots past it are padding (value 0, column 0); a real zero
    weight at column 0 past the last such slot adds exactly what the
    padding adds, so the kernel gives the same result."""
    slot = torch.arange(1, vals.shape[-1] + 1, dtype=torch.int32,
                        device=vals.device)
    real = (vals != 0) | (cols != 0)
    return torch.where(real, slot, 0).amax(dim=-1).to(torch.int32)


def slice_cols(k: int, n: int, vec4: bool) -> int:
    """Columns of B that one slice of the launch gathers: all of ``n``
    when its ``k`` rows fit :data:`_build.L2_SLICE_BYTES` and 32 lanes
    cover it (a row of lanes a group, no lane idle), else the widest
    power-of-two number of lanes (float4 or scalar columns each) that
    fits: a slice then starts on a 128-byte line of every B row that is
    a multiple of it."""
    unit = 4 if vec4 else 1
    whole = -(-n // unit) * unit
    if k * whole * 4 <= _build.L2_SLICE_BYTES and whole <= 32 * unit:
        return whole
    width = 32 * unit
    while width > unit and k * width * 4 > _build.L2_SLICE_BYTES:
        width //= 2
    return width


def spmm_vpu(vpu_vals, vpu_cols, b, *, seg_len=None):
    """Per-tile partial rows, shape ``(ntiles, n)``, or ``(batch, ntiles,
    n)`` for a batch.

    Args:
      vpu_vals: (ntiles, ts) f32 residual non-zero values (zero padded);
        under the segmented launch a tile is one §4.3 Cs segment.
      vpu_cols: (ntiles, ts) i32 row of B for each value (0 where padded).
      b: (k, n) f32 dense matrix, or a ``(batch, k, n)`` stack: one
        launch for the whole batch (the TPU kernel's vmapped form). Each
        table may then carry a leading batch axis of its own or be
        shared by every element.
      seg_len: optional (ntiles,) i32 length of each row's real prefix:
        slots ``[0, len)`` hold its non-zeros, the rest is padding (the
        plan's own, :meth:`PlanArrays.vpu_len`). Derived from the values
        and columns by :func:`real_lengths` when absent. The plain twin
        multiplies every slot, which gives the same result.
    """
    batch = _build.batch_of(b)
    if _build.on_cpu(vpu_vals, vpu_cols, b):
        if batch is None:
            return ref.spmm_tile_partials(vpu_vals, vpu_cols, b)
        return ref.over_batch(ref.spmm_tile_partials, (vpu_vals, 2),
                              (vpu_cols, 2), (b, 2))
    dev = _build.check_operands(
        "spmm_vpu", ("vpu_vals", vpu_vals, torch.float32, 2),
        ("vpu_cols", vpu_cols, torch.int32, 2), ("b", b, torch.float32, 2),
        batch=batch)
    ntiles, ts = vpu_vals.shape[-2:]
    k, n = b.shape[-2:]
    if vpu_cols.shape[-2:] != vpu_vals.shape[-2:]:
        raise ValueError(f"spmm_vpu: vals {tuple(vpu_vals.shape)} and cols "
                         f"{tuple(vpu_cols.shape)} disagree")
    lead = () if batch is None else (batch,)
    out = torch.empty((*lead, ntiles, n), dtype=torch.float32, device=dev)
    if out.numel() == 0 or ts == 0:
        return out.zero_()
    if seg_len is None:
        seg_len = real_lengths(vpu_vals, vpu_cols)
    _build.check_operands("spmm_vpu", ("vpu_vals", vpu_vals, torch.float32, 2),
                          ("seg_len", seg_len, torch.int32, 1), batch=batch)
    if seg_len.shape[-1] != ntiles:
        raise ValueError(f"spmm_vpu: seg_len {tuple(seg_len.shape)} for "
                         f"{ntiles} rows")
    vec4 = n % 4 == 0 and _build.aligned16(b, out)
    bs = _build.batch_stride
    with torch.cuda.device(dev):
        err = _build.library().spmm_vpu_launch(
            vpu_vals.data_ptr(), vpu_cols.data_ptr(), seg_len.data_ptr(),
            b.data_ptr(), out.data_ptr(), batch or 1, ntiles, ts, n,
            bs(vpu_vals, 2), bs(vpu_cols, 2), bs(seg_len, 1), bs(b, 2),
            bs(out, 2), slice_cols(k, n, vec4), int(vec4),
            _build.stream_handle(dev))
    _build.check(err, "spmm_vpu")
    spmm_vpu.launches += 1
    return out


spmm_vpu.launches = 0
