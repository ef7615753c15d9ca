"""Sparsity-aware reordering: densify 8-row Tensor Core windows before
planning.

See :mod:`repro_torch.reorder.core` for the algorithm and
:meth:`repro_torch.core.preprocess.Plan.build` for how the permutation
composes with the canonical nnz order (``ExecSpec.reorder``).
"""
from repro_torch.reorder.core import (
    MIN_TC_GAIN,
    Reordering,
    apply_reorder,
    decide_reorder,
    reorder_csr,
    reorder_gain,
    reorder_rows,
    row_sketches,
)

__all__ = [
    "MIN_TC_GAIN",
    "Reordering",
    "apply_reorder",
    "decide_reorder",
    "reorder_csr",
    "reorder_gain",
    "reorder_rows",
    "row_sketches",
]
