"""The four hand-written Hopper kernels of the hybrid SpMM/SDDMM path.

Each wrapper (``spmm_mxu``, ``spmm_vpu``, ``sddmm_mxu``, ``sddmm_vpu``)
counts its kernel launches in a plain integer attribute ``launches``;
:func:`launch_counts` reads them and :func:`reset_launch_counts` zeroes
them, so a run can show which kernels its path went through.
"""
from __future__ import annotations

from repro_torch.kernels.sddmm_mxu import sddmm_mxu
from repro_torch.kernels.sddmm_vpu import sddmm_vpu
from repro_torch.kernels.spmm_mxu import spmm_mxu
from repro_torch.kernels.spmm_vpu import spmm_vpu

KERNELS = {"spmm_mxu": spmm_mxu, "spmm_vpu": spmm_vpu,
           "sddmm_mxu": sddmm_mxu, "sddmm_vpu": sddmm_vpu}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
