"""GNN models (GCN, AGNN) on Libra hybrid sparse operators, and their
training step.

This is the paper's end-to-end application (§5.5): SpMM performs feature
aggregation, SDDMM computes per-edge attention. :class:`GraphOps` builds
the plans for A, Aᵀ and SDDMM(A) once; :class:`GCN` and :class:`AGNN`
are ``nn.Module``s whose forwards match the reference package's
``gcn_forward`` / ``agnn_forward``. Gradients follow the SpMM/SDDMM
duality, as in the reference: the VJP of a value-parameterized SpMM is
an SpMM on the Aᵀ plan (for the features) plus an SDDMM on A's pattern
(for the edge values), and the VJP of an SDDMM is two SpMMs, so every
sparse product of a training step is a Libra apply on one of the three
plans. :func:`train_step` is the reference's full-batch step: a
cross-entropy and a plain SGD update.

Spans (:mod:`repro_torch.obs.trace`; ``gnn.step`` on the card's clock
too): the plan build's stages (``plan.*``), ``gnn.step`` > ``gnn.forward``,
``gnn.backward``, ``gnn.update``; ``gnn.spmm`` (``leg`` A/At, ``phase``
fwd/bwd), ``gnn.sddmm`` (``phase``) and ``gnn.edge_softmax`` around the
operators' ``apply.*`` spans. The softmax's backward runs in autograd's
own nodes, inside ``gnn.backward`` and outside any ``gnn.*`` child.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from repro_torch.api import ExecSpec
from repro_torch.core import preprocess
from repro_torch.core.formats import PlanArrays
from repro_torch.core.windows import num_windows
from repro_torch.kernels import ref
from repro_torch.kernels.ops import sddmm_apply, spmm_apply
from repro_torch.obs.trace import StageClock, span
from repro_torch.sparse.matrix import SparseCSR, coo_to_csr
from repro_torch.tune.model import matrix_features


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
    :class:`~repro_torch.api.ExecSpec`. As in the reference, the
    spec-less default stays ``ExecSpec(tune="off")`` (cheap
    construction), on ``device="cuda"``; ``tune="model"`` picks per-leg
    thresholds and segment caps analytically (A and Aᵀ each get their
    own config — their sparsity patterns differ), with one
    ``matrix_features`` pass of A shared by the A-SpMM and SDDMM legs.
    ``spec.backend`` selects the apply path of every op, forward and
    backward.

    ``spec.reorder`` ("on", or "auto" where it pays) densifies each leg
    independently (A, Aᵀ and the SDDMM mask each get their own row
    permutation, priced on their own pattern). Every leg stays
    original order in, original order out: its plan's nnz maps point at
    its matrix's original canonical order, and the row permutes ride
    inside the differentiable applies, so edge values, the Aᵀ edge
    permutation and the softmax segment ids never change.

    ``build_legs`` holds each leg's ``plan.meta["build_s"]`` (``"A"``,
    ``"At"``, ``"SDDMM"``); ``build_s`` the construction's host seconds
    by stage, the legs' stages summed with the shared feature pass,
    ``transpose`` (Aᵀ and its edge permutation) and ``upload`` (the
    plans' device views and index tensors); ``rest`` is the remainder,
    so the values sum to the construction's wall time.
    ``sddmm_slots`` and ``sddmm_live`` are the SDDMM leg's
    ``plan.meta["sddmm_slots"]``/``["sddmm_live"]``: the score slots its
    kernels compute and those that store a score (one a non-zero).
    """

    def __init__(self, a: SparseCSR, *, spec: ExecSpec | None = None):
        t_start = time.perf_counter()
        spec = ExecSpec(tune="off") if spec is None else spec
        self.spec = spec
        self.device = spec.torch_device()
        self.a = a
        self.m, self.k = a.shape
        self.nnz = a.nnz
        self.backend = spec.backend
        self.nwin = num_windows(a.m)
        stages = StageClock()
        with stages.stage("transpose"):
            at, self.perm = transpose_csr(a)
        self.nwin_t = num_windows(at.m)
        # One feature pass of A, shared by the SpMM and SDDMM tuners.
        feat_a = None
        if spec.tune == "model":
            with stages.stage("features"):
                feat_a = matrix_features(a)
        built = preprocess.Plan.build(a, "spmm", spec, feat=feat_a, leg="A")
        built_t = preprocess.Plan.build(at, "spmm", spec, leg="At")
        built_sd = preprocess.Plan.build(a, "sddmm", spec, feat=feat_a,
                                         leg="SDDMM")
        self.cfg, self.cfg_t = built.cfg, built_t.cfg
        self.cfg_sd = built_sd.cfg
        with stages.stage("upload"):
            self.arrs = PlanArrays(built.plan, self.device)
            self.arrs_t = PlanArrays(built_t.plan, self.device)
            self.arrs_sd = PlanArrays(built_sd.plan, self.device)
            # Per-leg reorder epilogues/prologues (None when not
            # reordered).
            self._unperm = self._index(built.reorder, "row_inv")
            self._unperm_t = self._index(built_t.reorder, "row_inv")
            self._x_perm = self._index(built_sd.reorder, "row_perm")
            self.perm_dev = torch.from_numpy(
                self.perm.astype(np.int64)).to(self.device)
            rows, _, _ = a.to_coo()
            # Destination row of every edge (softmax over incident edges).
            self.edge_row = torch.from_numpy(rows.astype(np.int64)).to(
                self.device)
        sd_meta = built_sd.plan.meta
        self.sddmm_slots = sd_meta["sddmm_slots"]
        self.sddmm_live = sd_meta["sddmm_live"]
        self.build_legs = {leg: b.plan.meta["build_s"] for leg, b in
                           (("A", built), ("At", built_t),
                            ("SDDMM", built_sd))}
        build_s = {k: stages.seconds.get(k, 0.0)
                   + sum(leg.get(k, 0.0) for leg in self.build_legs.values())
                   for k in (*preprocess.BUILD_STAGES, "transpose", "upload")}
        build_s["rest"] = (time.perf_counter() - t_start
                           - sum(build_s.values()))
        self.build_s = build_s

    def _index(self, reord, name):
        return (None if reord is None
                else torch.from_numpy(getattr(reord, name)).to(self.device))

    def spmm(self, edge_vals: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """C = A(edge_vals) @ B (edge values in canonical CSR order),
        differentiable in (edge_vals, b)."""
        return _SpMMEdgeValues.apply(self, edge_vals, b)

    def sddmm(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """vals[p] = ⟨X[row_p], Y[col_p]⟩ in canonical CSR order,
        differentiable in (x, y)."""
        return _SDDMM.apply(self, x, y)

    def fixed_spmm(self, b: torch.Tensor,
                   backend: str | None = None) -> torch.Tensor:
        """C = A @ B with the plan's baked-in values."""
        backend = backend or self.backend
        out = spmm_apply(self.arrs.for_backend(backend), b, m=self.m,
                         nwin=self.nwin, backend=backend)
        return _unreorder(out, self._unperm)

    def _a_apply(self, vals, b, phase="fwd"):
        """A(vals) @ b on the A plan, in original row order."""
        with span("gnn.spmm", leg="A", phase=phase):
            with span("apply.revalue"):
                arrs = ref.revalue_spmm_arrays(
                    self.arrs.for_backend(self.backend, revalue=True), vals)
            return _unreorder(spmm_apply(arrs, b, m=self.m, nwin=self.nwin,
                                         backend=self.backend), self._unperm)

    def _at_apply(self, vals, b, phase="fwd"):
        """A(vals)ᵀ @ b on the Aᵀ plan (``vals`` in A's edge order)."""
        with span("gnn.spmm", leg="At", phase=phase):
            with span("apply.revalue"):
                arrs = ref.revalue_spmm_arrays(
                    self.arrs_t.for_backend(self.backend, revalue=True),
                    vals[self.perm_dev])
            return _unreorder(spmm_apply(arrs, b, m=self.k,
                                         nwin=self.nwin_t,
                                         backend=self.backend),
                              self._unperm_t)

    def _sddmm_apply(self, x, y, phase="fwd"):
        """⟨X[row_p], Y[col_p]⟩ on the SDDMM(A) plan."""
        with span("gnn.sddmm", phase=phase):
            return sddmm_apply(self.arrs_sd.for_backend(self.backend),
                               _reorder_x(x, self._x_perm), y, nnz=self.nnz,
                               backend=self.backend)


def _unreorder(out, unperm):
    """Restore original row order after a reordered-plan SpMM apply."""
    if unperm is None:
        return out
    with span("apply.permute"):
        return out.index_select(0, unperm)


def _reorder_x(x, perm):
    """Gather X into the reordered row space of a reordered SDDMM plan."""
    if perm is None:
        return x
    with span("apply.permute"):
        return x.index_select(0, perm)


class _SpMMEdgeValues(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g: GraphOps, edge_vals, b):
        ctx.g = g
        ctx.save_for_backward(edge_vals, b)
        return g._a_apply(edge_vals, b)

    @staticmethod
    def backward(ctx, d_c):
        g = ctx.g
        edge_vals, b = ctx.saved_tensors
        # A loss like out.sum() hands in an expanded, stride-0 cotangent;
        # the kernels take contiguous operands only.
        d_c = d_c.contiguous()
        d_vals = d_b = None
        if ctx.needs_input_grad[2]:
            d_b = g._at_apply(edge_vals, d_c, "bwd")    # dB = A(v)ᵀ · dC
        if ctx.needs_input_grad[1]:
            # dv[p] = dC[row_p]·B[col_p]
            d_vals = g._sddmm_apply(d_c, b, "bwd")
        return None, d_vals, d_b


class _SDDMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g: GraphOps, x, y):
        ctx.g = g
        ctx.save_for_backward(x, y)
        return g._sddmm_apply(x, y)

    @staticmethod
    def backward(ctx, d_vals):
        g = ctx.g
        x, y = ctx.saved_tensors
        d_x = d_y = None
        if ctx.needs_input_grad[1]:
            d_x = g._a_apply(d_vals, y, "bwd")    # dX = A(dv) · Y
        if ctx.needs_input_grad[2]:
            d_y = g._at_apply(d_vals, x, "bwd")   # dY = A(dv)ᵀ · X
        return None, d_x, d_y


def edge_softmax(g: GraphOps, scores: torch.Tensor) -> torch.Tensor:
    """Numerically stable per-destination-row softmax over edge scores.

    The per-row maxima and sums are gathered back to the edges with
    ``index_select``, whose backward is one ``index_add_``: the backward
    of ``t[edge_row]`` sorts the indices to accumulate, and on a
    power-law graph's 2.29M edges took about 7 ms a gather on an H100.
    """
    with span("gnn.edge_softmax"):
        mx = torch.full((g.m,), float("-inf"), dtype=scores.dtype,
                        device=scores.device)
        mx = mx.scatter_reduce(0, g.edge_row, scores, "amax")
        e = torch.exp(scores - mx.index_select(0, g.edge_row))
        z = torch.zeros((g.m,), dtype=scores.dtype, device=scores.device)
        z = z.index_add(0, g.edge_row, e)
        return e / torch.clamp(z.index_select(0, g.edge_row), min=1e-9)


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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-softmax at each row's label."""
    lp = torch.log_softmax(logits, dim=-1)
    return -lp.gather(1, labels[:, None]).mean()


def sgd_step(model: nn.Module, lr: float) -> None:
    """Plain SGD: ``p -= lr * p.grad`` for every parameter with a
    gradient."""
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p -= lr * p.grad


def train_step(model: nn.Module, g: GraphOps, x: torch.Tensor,
               labels: torch.Tensor, *args, lr: float) -> torch.Tensor:
    """One full-batch training step: forward, :func:`cross_entropy`,
    backward, :func:`sgd_step`. ``args`` follow ``x`` into the model's
    forward (GCN's normalized edge values). Returns the loss before the
    update; the step's gradients stay in each ``p.grad`` until the next
    step."""
    with span("gnn.step", x):
        for p in model.parameters():
            p.grad = None
        with span("gnn.forward"):
            loss = cross_entropy(model(g, x, *args), labels)
        with span("gnn.backward"):
            loss.backward()
        with span("gnn.update"):
            sgd_step(model, lr)
        return loss.detach()
