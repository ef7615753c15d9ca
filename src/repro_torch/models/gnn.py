"""GNN models (GCN, AGNN) on Libra hybrid sparse operators, forward only.

This is the paper's end-to-end application (§5.5): SpMM performs feature
aggregation, SDDMM computes per-edge attention. :class:`GraphOps` builds
the plans for A, Aᵀ and SDDMM(A) once; :class:`GCN` and :class:`AGNN`
are ``nn.Module``s whose forwards match the reference package's
``gcn_forward`` / ``agnn_forward``.

Training is the next slice (ROADMAP queue 1 item 7): the SpMM/SDDMM
duality makes every backward matmul a Libra op on the Aᵀ and SDDMM(A)
plans built here, but until it is ported the ``backward`` of
:meth:`GraphOps.spmm` and :meth:`GraphOps.sddmm` raises, so no silently
wrong gradient can exist.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.api import ExecSpec
from repro_torch.core import preprocess
from repro_torch.core.formats import PlanArrays
from repro_torch.core.windows import num_windows
from repro_torch.kernels import ref
from repro_torch.kernels.ops import sddmm_apply, spmm_apply
from repro_torch.sparse.matrix import SparseCSR, coo_to_csr

_NO_BACKWARD = ("the GNN backward pass is not ported yet (ROADMAP queue 1 "
                "item 7, training slice)")


def transpose_csr(a: SparseCSR) -> tuple[SparseCSR, np.ndarray]:
    """Aᵀ plus the permutation mapping A's nnz order → Aᵀ's nnz order."""
    rows, cols, vals = a.to_coo()
    at = coo_to_csr(a.k, a.m, cols, rows, vals)
    order = np.lexsort((rows, cols))  # Aᵀ canonical order over A's edges
    perm = np.asarray(order, np.int32)  # edge p_T of Aᵀ = A-edge perm[p_T]
    return at, perm


class GraphOps:
    """Preprocessed Libra plans for one graph: A, Aᵀ, and SDDMM(A).

    All three legs are built through :meth:`Plan.build` under one
    :class:`~repro_torch.api.ExecSpec`; the default spec is
    ``tune="off"`` on ``device="cuda"``. ``spec.backend`` selects the
    apply path of every op. The Aᵀ plan serves the backward pass of the
    training slice and is built now so one ``GraphOps`` covers both.
    """

    def __init__(self, a: SparseCSR, *, spec: ExecSpec | None = None):
        spec = ExecSpec() if spec is None else spec
        self.spec = spec
        self.device = spec.torch_device()
        self.a = a
        self.m, self.k = a.shape
        self.nnz = a.nnz
        self.backend = spec.backend
        self.nwin = num_windows(a.m)
        at, self.perm = transpose_csr(a)
        self.nwin_t = num_windows(at.m)
        built = preprocess.Plan.build(a, "spmm", spec)
        built_t = preprocess.Plan.build(at, "spmm", spec)
        built_sd = preprocess.Plan.build(a, "sddmm", spec)
        self.cfg, self.cfg_t = built.cfg, built_t.cfg
        self.cfg_sd = built_sd.cfg
        self.arrs = PlanArrays(built.plan, self.device)
        self.arrs_t = PlanArrays(built_t.plan, self.device)
        self.arrs_sd = PlanArrays(built_sd.plan, self.device)
        rows, _, _ = a.to_coo()
        # Destination row of every edge (softmax over incident edges).
        self.edge_row = torch.from_numpy(rows.astype(np.int64)).to(
            self.device)

    def spmm(self, edge_vals: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """C = A(edge_vals) @ B (edge values in canonical CSR order)."""
        return _SpMMEdgeValues.apply(self, edge_vals, b)

    def sddmm(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """vals[p] = ⟨X[row_p], Y[col_p]⟩ in canonical CSR order."""
        return _SDDMM.apply(self, x, y)

    def fixed_spmm(self, b: torch.Tensor,
                   backend: str | None = None) -> torch.Tensor:
        """C = A @ B with the plan's baked-in values."""
        backend = backend or self.backend
        return spmm_apply(self.arrs.for_backend(backend), b, m=self.m,
                          nwin=self.nwin, backend=backend)


class _SpMMEdgeValues(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g: GraphOps, edge_vals, b):
        arrs = ref.revalue_spmm_arrays(
            g.arrs.for_backend(g.backend, revalue=True), edge_vals)
        return spmm_apply(arrs, b, m=g.m, nwin=g.nwin, backend=g.backend)

    @staticmethod
    def backward(ctx, d_c):
        raise NotImplementedError(_NO_BACKWARD)


class _SDDMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g: GraphOps, x, y):
        return sddmm_apply(g.arrs_sd.for_backend(g.backend), x, y,
                           nnz=g.nnz, backend=g.backend)

    @staticmethod
    def backward(ctx, d_vals):
        raise NotImplementedError(_NO_BACKWARD)


def edge_softmax(g: GraphOps, scores: torch.Tensor) -> torch.Tensor:
    """Numerically stable per-destination-row softmax over edge scores."""
    mx = torch.full((g.m,), float("-inf"), dtype=scores.dtype,
                    device=scores.device)
    mx = mx.scatter_reduce(0, g.edge_row, scores, "amax")
    e = torch.exp(scores - mx[g.edge_row])
    z = torch.zeros((g.m,), dtype=scores.dtype, device=scores.device)
    z.index_add_(0, g.edge_row, e)
    return e / torch.clamp(z[g.edge_row], min=1e-9)


def gcn_norm_edges(a: SparseCSR) -> np.ndarray:
    """Symmetric normalization D^-1/2 A D^-1/2 as per-edge values."""
    rows, cols, _ = a.to_coo()
    deg = np.maximum(np.bincount(rows, minlength=a.m), 1).astype(np.float64)
    deg_c = np.maximum(np.bincount(cols, minlength=a.k), 1).astype(np.float64)
    return (1.0 / np.sqrt(deg[rows] * deg_c[cols])).astype(np.float32)


def _init_weights(dims: list[int], generator: torch.Generator | None):
    return nn.ParameterList(
        nn.Parameter(torch.randn(dims[i], dims[i + 1], generator=generator)
                     / np.sqrt(dims[i]))
        for i in range(len(dims) - 1))


class GCN(nn.Module):
    """GCN: H' = σ(Â H W), Â's normalized values as the edge values.

    Weights are ``(d_in, d_out)``, the reference package's layout.
    """

    def __init__(self, dims: list[int], *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dims = list(dims)
        self.weights = _init_weights(self.dims, generator)

    def forward(self, g: GraphOps, x: torch.Tensor,
                norm_edge_vals: torch.Tensor) -> torch.Tensor:
        h = x
        for i, w in enumerate(self.weights):
            h = g.spmm(norm_edge_vals, h @ w)
            if i < len(self.weights) - 1:
                h = torch.relu(h)
        return h


class AGNN(nn.Module):
    """AGNN: attention = softmax_row(β·cos(h_i, h_j)) via SDDMM, then SpMM."""

    def __init__(self, dims: list[int], *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dims = list(dims)
        self.weights = _init_weights(self.dims, generator)
        self.betas = nn.ParameterList(
            nn.Parameter(torch.ones(())) for _ in range(len(dims) - 1))

    def forward(self, g: GraphOps, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, (w, beta) in enumerate(zip(self.weights, self.betas)):
            hn = h / torch.clamp(torch.linalg.vector_norm(
                h, dim=-1, keepdim=True), min=1e-9)
            scores = g.sddmm(hn, hn) * beta             # SDDMM (paper Fig. 3)
            att = edge_softmax(g, scores)
            h = g.spmm(att, h)                          # SpMM aggregation
            h = h @ w
            if i < len(self.weights) - 1:
                h = torch.relu(h)
        return h
