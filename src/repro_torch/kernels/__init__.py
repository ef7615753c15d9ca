"""The five hand-written Hopper kernels of the port.

K1–K4 carry the hybrid SpMM/SDDMM path (``spmm_mxu``, ``spmm_vpu``,
``sddmm_mxu``, ``sddmm_vpu``); K5 (``flash_attention``) carries the
dense transformer's attention. Each wrapper counts its kernel launches
in a plain integer attribute ``launches``; :func:`launch_counts` reads
them and :func:`reset_launch_counts` zeroes them, so a run can show
which kernels its path went through.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention_fused
from repro_torch.kernels.sddmm_mxu import sddmm_mxu
from repro_torch.kernels.sddmm_vpu import sddmm_vpu
from repro_torch.kernels.spmm_mxu import spmm_mxu
from repro_torch.kernels.spmm_vpu import spmm_vpu

KERNELS = {"spmm_mxu": spmm_mxu, "spmm_vpu": spmm_vpu,
           "sddmm_mxu": sddmm_mxu, "sddmm_vpu": sddmm_vpu,
           "flash_attention": flash_attention_fused}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
