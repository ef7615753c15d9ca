"""repro_torch: Libra (hybrid Tensor Core + CUDA-core sparse matrix
multiplication) in PyTorch with hand-written Hopper kernels.

The package mirrors the JAX package ``repro`` module for module and
builds the same plans from the same matrices; it also carries the dense
transformer stack (``repro_torch.models``, ``repro_torch.configs``,
``repro_torch.launch.serve``), whose attention is the flash-attention
kernel. The kernels under ``repro_torch/kernels/csrc`` are compiled with
``nvcc`` at first use. Importing the package builds nothing.
"""
from repro_torch.api import ExecSpec
from repro_torch.core.sddmm import LibraSDDMM
from repro_torch.core.spmm import LibraSpMM
from repro_torch.sparse.matrix import SparseCSR
from repro_torch.tune.model import TuneConfig

__all__ = ["ExecSpec", "LibraSDDMM", "LibraSpMM", "SparseCSR", "TuneConfig"]
