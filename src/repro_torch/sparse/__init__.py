from repro_torch.sparse.matrix import SparseCSR, coo_to_csr
from repro_torch.sparse.generate import (
    random_uniform_csr,
    power_law_csr,
    banded_csr,
    block_structured_csr,
    mixed_csr,
    suitesparse_like_corpus,
)

__all__ = [
    "SparseCSR",
    "coo_to_csr",
    "random_uniform_csr",
    "power_law_csr",
    "banded_csr",
    "block_structured_csr",
    "mixed_csr",
    "suitesparse_like_corpus",
]
