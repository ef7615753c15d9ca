"""K2 — SpMM CUDA-core stream (the reference's VPU stream).

Stream mapping: the reference package runs this stream on the TPU's VPU
(``src/repro/kernels/spmm_vpu.py``); here it runs on the H100's CUDA
cores with FP32 FMA, as in the paper. The CUDA kernel
(``csrc/spmm_vpu.cu``) gives one warp to each (tile, column chunk).

:func:`spmm_vpu` launches the kernel for CUDA tensors and runs
:func:`repro_torch.kernels.ref.spmm_tile_partials`, its plain
fp32 twin, for CPU tensors; it never falls back from the
card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def spmm_vpu(vpu_vals, vpu_cols, b):
    """Per-tile partial rows, shape ``(ntiles, n)``.

    Args:
      vpu_vals: (ntiles, ts) f32 residual non-zero values (zero padded);
        under the segmented launch a tile is one §4.3 Cs segment.
      vpu_cols: (ntiles, ts) i32 row of B for each value (0 where padded).
      b: (k, n) f32 dense matrix.
    """
    if _build.on_cpu(vpu_vals, vpu_cols, b):
        return ref.spmm_tile_partials(vpu_vals, vpu_cols, b)
    dev = _build.check_operands(
        "spmm_vpu", ("vpu_vals", vpu_vals, torch.float32, 2),
        ("vpu_cols", vpu_cols, torch.int32, 2), ("b", b, torch.float32, 2))
    if vpu_cols.shape != vpu_vals.shape:
        raise ValueError(f"spmm_vpu: vals {tuple(vpu_vals.shape)} and cols "
                         f"{tuple(vpu_cols.shape)} disagree")
    ntiles, ts = vpu_vals.shape
    n = b.shape[1]
    out = torch.empty((ntiles, n), dtype=torch.float32, device=dev)
    if ntiles == 0 or n == 0 or ts == 0:
        return out.zero_()
    vec4 = n % 4 == 0 and _build.aligned16(b, out)
    with torch.cuda.device(dev):
        err = _build.library().spmm_vpu_launch(
            vpu_vals.data_ptr(), vpu_cols.data_ptr(), b.data_ptr(),
            out.data_ptr(), ntiles, ts, n, int(vec4),
            _build.stream_handle(dev))
    _build.check(err, "spmm_vpu")
    spmm_vpu.launches += 1
    return out


spmm_vpu.launches = 0
