"""GNN training on window-sharded Libra operators.

:class:`DistGraphOps` mirrors :class:`repro_torch.models.gnn.GraphOps` —
same differentiable ``spmm``/``sddmm`` surface, same gradient duality —
but every apply (forward *and* both backward legs) runs through the
sharded applies of :mod:`repro_torch.dist.sparse` over a
:class:`~repro_torch.dist.sparse.ShardMesh`. The model code is
unchanged: :class:`~repro_torch.models.gnn.GCN`,
:class:`~repro_torch.models.gnn.AGNN` and
:func:`~repro_torch.models.gnn.edge_softmax` duck-type over either ops
object, so going multi-shard is a one-line swap.

Partitions are built once per graph (paper §4.5 — preprocess-once,
apply-many, shard-once too): A for the forward SpMM, Aᵀ for the
feature-gradient SpMM, and SDDMM(A) for the value gradient. The edge
permutation between A's and Aᵀ's canonical nnz orders is the same
host-side map the single-device path uses.

Unlike :class:`GraphOps` (``tune="off"`` default), ``DistGraphOps``
defaults to ``tune="model"``, as in the reference package: per-*shard*
tuning is the point of partitioned execution, and its cost is one
feature pass per shard.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import ExecSpec
from repro_torch.dist.partition import partition_sddmm, partition_spmm
from repro_torch.dist.sparse import (
    SHARD_AXIS,
    ShardMesh,
    sddmm_sharded,
    spmm_sharded,
)
from repro_torch.models.gnn import (
    cross_entropy,
    edge_softmax,
    train_step,
    transpose_csr,
)
from repro_torch.sparse.matrix import SparseCSR


class DistGraphOps:
    """Sharded Libra plans for one graph: A, Aᵀ, and SDDMM(A) on a mesh.

    Drop-in for :class:`repro_torch.models.gnn.GraphOps` in model code.
    ``spec.tune="model"`` (the default) tunes every shard of every
    partition; ``spec.backend``/``spec.b_layout`` select the per-shard
    apply path and the dense-operand layout for all ops. Index tensors
    and outputs live on the mesh's first device.
    """

    def __init__(self, a: SparseCSR, mesh: ShardMesh,
                 axis: str = SHARD_AXIS, *, spec: ExecSpec | None = None):
        # Reordering (spec.reorder) rides inside the partitions: their
        # gathers are pre-composed with the permutations, so the
        # backward legs below stay original-order black boxes.
        spec = ExecSpec() if spec is None else spec
        self.spec = spec
        self.mesh, self.axis = mesh, axis
        self.device = mesh.device(0)
        self.backend, self.b_layout = spec.backend, spec.b_layout
        self.a = a
        self.m, self.k = a.shape
        self.nnz = a.nnz
        n_shards = int(mesh.shape[axis])
        self.part = partition_spmm(a, n_shards, spec=spec)
        at, self.perm = transpose_csr(a)
        self.part_t = partition_spmm(at, n_shards, spec=spec)
        self.part_sd = partition_sddmm(a, n_shards, spec=spec)
        self.perm_dev = torch.from_numpy(self.perm.astype(np.int64)).to(
            self.device)
        rows, _, _ = a.to_coo()
        # Destination row of every edge (softmax over incident edges).
        self.edge_row = torch.from_numpy(rows.astype(np.int64)).to(
            self.device)

    # -- differentiable ops (same surface as GraphOps) --------------------
    def spmm(self, edge_vals: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """C = A(edge_vals) @ B, differentiable in (edge_vals, b)."""
        return _DistSpMMEdgeValues.apply(self, edge_vals, b)

    def sddmm(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """vals[p] = ⟨X[row_p], Y[col_p]⟩, differentiable in (x, y)."""
        return _DistSDDMM.apply(self, x, y)

    def fixed_spmm(self, b: torch.Tensor,
                   backend: str | None = None) -> torch.Tensor:
        """C = A @ B with the partitions' baked-in values."""
        return self._spmm(self.part, b, backend=backend)

    # -- sharded applies with this object's mesh/backend knobs ------------
    def _spmm(self, part, b, edge_vals=None, backend=None):
        return spmm_sharded(part, b, mesh=self.mesh, axis=self.axis,
                            backend=backend or self.backend,
                            edge_vals=edge_vals, b_layout=self.b_layout)

    def _sddmm(self, x, y):
        return sddmm_sharded(self.part_sd, x, y, mesh=self.mesh,
                             axis=self.axis, backend=self.backend,
                             y_layout=self.b_layout)


class _DistSpMMEdgeValues(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g: DistGraphOps, edge_vals, b):
        ctx.g = g
        ctx.save_for_backward(edge_vals, b)
        return g._spmm(g.part, b, edge_vals=edge_vals)

    @staticmethod
    def backward(ctx, d_c):
        g = ctx.g
        edge_vals, b = ctx.saved_tensors
        # The kernels take contiguous operands only (a sum() loss hands
        # in a stride-0 cotangent).
        d_c = d_c.contiguous()
        d_vals = d_b = None
        if ctx.needs_input_grad[2]:
            # dB = A(v)ᵀ @ dC — sharded SpMM on the transposed partition.
            d_b = g._spmm(g.part_t, d_c,
                          edge_vals=edge_vals.index_select(0, g.perm_dev))
        if ctx.needs_input_grad[1]:
            # dv[p] = dC[row_p] · B[col_p] — sharded SDDMM, A's pattern.
            d_vals = g._sddmm(d_c, b)
        return None, d_vals, d_b


class _DistSDDMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g: DistGraphOps, x, y):
        ctx.g = g
        ctx.save_for_backward(x, y)
        return g._sddmm(x, y)

    @staticmethod
    def backward(ctx, d_vals):
        g = ctx.g
        x, y = ctx.saved_tensors
        d_x = d_y = None
        if ctx.needs_input_grad[1]:
            d_x = g._spmm(g.part, y, edge_vals=d_vals)      # dX = A(dv)·Y
        if ctx.needs_input_grad[2]:
            d_y = g._spmm(g.part_t, x,                      # dY = A(dv)ᵀ·X
                          edge_vals=d_vals.index_select(0, g.perm_dev))
        return None, d_x, d_y


# ------------------------------------------------------- training steps ---
def gcn_loss(model, g, feats, labels, norm_edge_vals) -> torch.Tensor:
    """Cross-entropy of a GCN forward over either ops object."""
    return cross_entropy(model(g, feats, norm_edge_vals), labels)


def agnn_loss(model, g, feats, labels) -> torch.Tensor:
    """Cross-entropy of an AGNN forward over either ops object."""
    return cross_entropy(model(g, feats), labels)


def make_gcn_train_step(g, lr: float = 0.2):
    """SGD step for a :class:`~repro_torch.models.gnn.GCN`: works with
    ``GraphOps`` and ``DistGraphOps`` alike — the mesh rides inside the
    sharded ops. ``step(model, feats, labels, norm_edge_vals)`` updates
    the model in place and returns the loss before the update."""
    def step(model, feats, labels, norm_edge_vals):
        return train_step(model, g, feats, labels, norm_edge_vals, lr=lr)
    return step


def make_agnn_train_step(g, lr: float = 0.2):
    """SGD step for an :class:`~repro_torch.models.gnn.AGNN` (SDDMM →
    edge softmax → SpMM per layer); ``step(model, feats, labels)``."""
    def step(model, feats, labels):
        return train_step(model, g, feats, labels, lr=lr)
    return step


__all__ = [
    "DistGraphOps",
    "agnn_loss",
    "edge_softmax",
    "gcn_loss",
    "make_agnn_train_step",
    "make_gcn_train_step",
]
