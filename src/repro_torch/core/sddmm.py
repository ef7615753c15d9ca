"""Public hybrid SDDMM: values = sample(X·Yᵀ, sparsity(A)).

Output follows the canonical CSR (row-major, column-sorted) non-zero
order of the mask matrix, so GNN attention pipelines can chain
``SDDMM → softmax-by-row → SpMM`` without reindexing. Knobs live on one
frozen :class:`repro_torch.api.ExecSpec`; the SDDMM block threshold is
``ExecSpec.sddmm_threshold``, and ``ExecSpec.tune`` chooses it (with the
§4.3 caps) as for :mod:`repro_torch.core.spmm`, priced at the feature
width ``tune_kf`` against K3's shared-memory footprint. When the plan is
reordered (``reorder="on"``, or ``"auto"`` when it pays) X is gathered
into the reordered row space; the outputs still land in the original
matrix's canonical order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import ExecSpec
from repro_torch.core import preprocess
from repro_torch.core.balance import BalanceParams
from repro_torch.core.formats import PlanArrays, SDDMMPlan
from repro_torch.kernels.ops import apply_at, sddmm_apply
from repro_torch.obs.ledger import apply_sampler, dtype_name
from repro_torch.sparse.matrix import SparseCSR
from repro_torch.tune.model import TuneConfig


def threshold_for_mode(mode: str, bk: int, threshold: int | None = None) -> int:
    """The SDDMM block threshold that ``mode`` pins (the reference's name
    for :func:`repro_torch.core.preprocess.threshold_for_mode_sddmm`)."""
    return preprocess.threshold_for_mode_sddmm(mode, bk, threshold)


class LibraSDDMM:
    """Preprocess-once, apply-many hybrid SDDMM operator."""

    def __init__(self, a: SparseCSR, *, spec: ExecSpec | None = None,
                 balance: BalanceParams | None = None):
        spec = ExecSpec() if spec is None else spec
        self.spec = spec
        self.device = spec.torch_device()
        self.m, self.k = a.shape
        self.nnz = a.nnz
        self.mode = spec.mode
        built = preprocess.Plan.build(a, "sddmm", spec, balance=balance)
        self.tune_config: TuneConfig = built.cfg
        self.plan: SDDMMPlan = built.plan
        self.reorder = built.reorder
        # The output scatter maps point back to original canonical nnz
        # order, so only the row operand is permuted: x_r = x[row_perm].
        self._row_perm = (None if built.reorder is None else
                          torch.from_numpy(built.reorder.row_perm).to(
                              self.device))
        self.arrays = PlanArrays(self.plan, self.device)
        # CSR structure for chaining into softmax/SpMM: the original
        # matrix's (outputs land in its canonical order).
        self.indptr = np.asarray(a.indptr)
        self.indices = np.asarray(a.indices)
        # The apply keys (kf, dtype, backend, rows of x and y) used so
        # far: see kernels.ops.apply_at.
        self._apply_cache: set = set()
        # The matrix the plan was built on, read only while a perf
        # ledger is recording (see LibraSpMM).
        self._a = built.a

    def __call__(self, x: torch.Tensor, y: torch.Tensor,
                 backend: str | None = None) -> torch.Tensor:
        if x.shape[0] < self.m or y.shape[0] < self.k:
            raise ValueError(f"x needs ≥ {self.m} rows and y ≥ {self.k}, "
                             f"got {x.shape[0]} and {y.shape[0]}")
        backend = self.spec.backend if backend is None else backend
        if self._row_perm is not None:
            # Rows of x past m stay in place.
            perm = self._row_perm
            if x.shape[0] > self.m:
                perm = torch.cat([perm, torch.arange(
                    self.m, x.shape[0], device=perm.device)])
            x = x.index_select(0, perm)

        return apply_at(
            self._apply_cache,
            (x.shape[1], str(x.dtype), backend, x.shape[0], y.shape[0]),
            self.device, sddmm_apply, self.arrays.for_backend(backend), x,
            y, nnz=self.nnz, backend=backend,
            sample=apply_sampler(self, "sddmm", width=x.shape[1],
                                 dtype=dtype_name(x.dtype), backend=backend))

    @property
    def tc_ratio(self) -> float:
        return self.plan.meta["tc_ratio"]
