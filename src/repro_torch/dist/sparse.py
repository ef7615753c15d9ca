"""Sharded + batched hybrid sparse execution.

The two scale axes the single-device operators lack:

* :func:`spmm_sharded` / :func:`sddmm_sharded` — run one Libra plan
  split into contiguous-window shards (:mod:`repro_torch.dist.partition`)
  over a :class:`ShardMesh`, the counterpart of the reference package's
  one-axis ``Mesh``. When every shard sits on one device, the shards
  apply as one batch over the partition's stacked tables
  (:func:`~repro_torch.kernels.ops.spmm_apply` with a leading shard
  axis: K1–K4 launch once each on ``backend="cuda"``), the port of the
  reference's no-mesh ``vmap`` over ``part.stacked``. A mesh spread
  over several devices runs the single-device apply on each shard's
  device, one shard after another. The output is row-partitioned by
  construction (a window never straddles shards), so there is **no
  cross-shard combine** — one gather reassembles the result.
* :class:`BatchedSpMM` / :class:`BatchedSDDMM` — apply one plan to a
  ``(batch, k, n)`` stack of dense panels (the serving shape: one graph,
  many feature panels in flight) through
  :func:`~repro_torch.kernels.ops.spmm_apply_stack` /
  :func:`~repro_torch.kernels.ops.sddmm_apply_stack`. On the card a
  stack is one launch of each of K1–K4, and each panel's result is bit
  for bit the single apply's. Reordered plans keep the single
  operators' contract: SpMM outputs come back in original row order,
  SDDMM gathers X's rows into the reordered row space.

Every operator counts the apply keys (operand shape, dtype, backend) it
has used (:func:`~repro_torch.kernels.ops.apply_at`).

Halo model
----------
Each shard's plan columns are remapped onto its *halo* — the
sorted-unique set of dense-operand rows the shard touches (precomputed
host-side by the partitioner). At execution time each shard
materializes only ``B[halo]`` (one ``index_select``), never all of B.
The dense operand arrives two ways (``b_layout=`` / ``y_layout=``):

* ``"replicated"`` (default) — every shard's device holds B and gathers
  its halo rows locally;
* ``"rowshard"`` — B's rows are split over the shards' devices and each
  shard gathers them back whole before its halo gather (the reference's
  all-gather; on one card, a concatenation).

``edge_vals=`` (SpMM) revalues every shard's tables from one canonical
nnz value vector (the training path — pattern fixed, values per step):
the stacked position maps are global, so each shard reads the global
vector, after one ``edge_perm`` gather on a reordered partition.
"""
from __future__ import annotations

import torch

from repro_torch.api import B_LAYOUTS, ExecSpec, checked_device
from repro_torch.core.balance import BalanceParams
from repro_torch.core.sddmm import LibraSDDMM
from repro_torch.core.spmm import LibraSpMM
from repro_torch.dist.partition import (
    SDDMMPartition,
    SpMMPartition,
    partition_sddmm,
    partition_spmm,
)
from repro_torch.kernels import ref
from repro_torch.kernels.ops import (
    apply_at,
    sddmm_apply,
    sddmm_apply_stack,
    spmm_apply,
    spmm_apply_stack,
)
from repro_torch.obs.trace import span

SHARD_AXIS = "shards"


class ShardMesh:
    """A one-axis mesh of shards: shard ``p`` runs on ``devices[p]``.

    The counterpart of the reference package's ``jax.sharding.Mesh``
    over one named axis: ``mesh.shape[axis]`` is the shard count. Every
    device is checked (a CUDA device needs a card). Several shards may
    share one device; when all of them do, they apply as one batch.
    """

    def __init__(self, devices, axis: str = SHARD_AXIS):
        self.devices = tuple(checked_device(d, "ShardMesh") for d in devices)
        if not self.devices:
            raise ValueError("ShardMesh needs at least one device")
        self.axis = axis
        self.shape = {axis: len(self.devices)}

    @classmethod
    def round_robin(cls, n_shards: int, axis: str = SHARD_AXIS
                    ) -> "ShardMesh":
        """``n_shards`` shards over the cards: shard ``p`` on card ``p %
        torch.cuda.device_count()`` (all on ``cuda:0`` with one card)."""
        n_cards = max(torch.cuda.device_count(), 1)
        return cls([f"cuda:{p % n_cards}" for p in range(n_shards)], axis)

    def device(self, p: int) -> torch.device:
        return self.devices[p]

    @property
    def one_device(self) -> bool:
        """True when every shard runs on one device: the sharded applies
        then run the shards as one batch."""
        return len(set(self.devices)) == 1

    def __repr__(self) -> str:
        return f"ShardMesh({[str(d) for d in self.devices]}, {self.axis!r})"


def _check_mesh(part, mesh: ShardMesh, axis: str, layout: str) -> None:
    if layout not in B_LAYOUTS:
        raise ValueError(f"layout must be one of {B_LAYOUTS}, got {layout!r}")
    if int(mesh.shape[axis]) != part.n_shards:
        raise ValueError(f"mesh {mesh.shape} for a partition of "
                         f"{part.n_shards} shards")


def _row_blocks(t: torch.Tensor, mesh: ShardMesh) -> list[torch.Tensor]:
    """``t``'s rows padded to a multiple of the shard count and split into
    one block a shard, each on its shard's device (``"rowshard"``)."""
    n = len(mesh.devices)
    per = -(-t.shape[0] // n)
    t = torch.nn.functional.pad(t, (0, 0, 0, per * n - t.shape[0]))
    return [blk.to(mesh.device(p)) for p, blk in enumerate(t.split(per))]


def _operand(t: torch.Tensor, blocks, dev: torch.device) -> torch.Tensor:
    """The whole dense operand on ``dev``: ``t`` itself (replicated), or
    the row blocks gathered back (rowshard)."""
    if blocks is None:
        return t.to(dev)
    return torch.cat([blk.to(dev) for blk in blocks])


def _device_arrays(part, mesh: ShardMesh) -> list:
    """The tables a sharded apply on ``mesh`` reads: the stacked tables
    once when every shard shares one device, else each shard's on its
    device."""
    if mesh.one_device:
        return [part.stacked_arrays(mesh.device(0))]
    return [part.arrays(p, mesh.device(p)) for p in range(part.n_shards)]


def _apply_batch(apply, local, operands, *, backend: str, **kw):
    """One device's shards as one batch: ``local``'s tables and each
    operand carry a leading shard axis. The kernel path is one batched
    apply (K1–K4 once each); the plain path applies the shards one after
    another over their slices of the stacked tables."""
    if backend == "cuda":
        return apply(local, *operands, backend=backend, **kw)
    return torch.stack([
        apply({k: v[p] for k, v in local.items()}, *(o[p] for o in operands),
              backend=backend, **kw)
        for p in range(operands[0].shape[0])])


def _halo_stack(t: torch.Tensor, halo: torch.Tensor) -> torch.Tensor:
    """``t``'s rows at each shard's halo, ``(P, halo_pad, n)``, by one
    gather over the stacked halo maps."""
    return t.index_select(0, halo.reshape(-1)).view(*halo.shape, t.shape[1])


def spmm_sharded(part: SpMMPartition, b: torch.Tensor, *, mesh: ShardMesh,
                 axis: str = SHARD_AXIS, backend: str = "cuda",
                 edge_vals: torch.Tensor | None = None,
                 b_layout: str = "replicated") -> torch.Tensor:
    """C = A @ B over a mesh; the shards of one device apply as one batch,
    those of a spread mesh each on its device.

    ``edge_vals`` (canonical global nnz order) revalues every shard's
    tables — the differentiable-values path; the stacked position maps
    are global, so one gather revalues all of them. Output rows are
    partitioned by shard, so the result needs no reduction: one gather
    (``part.out_gather``) reassembles C on ``b``'s device.
    """
    _check_mesh(part, mesh, axis, b_layout)
    if edge_vals is not None and part.edge_perm is not None:
        # Reordered partition: shard positions index the reordered
        # canonical nnz order — gather the caller's original-order
        # values into it once, before the shards apply.
        edge_vals = edge_vals.index_select(
            0, part.index("edge_perm", edge_vals.device))
    blocks = _row_blocks(b, mesh) if b_layout == "rowshard" else None
    revalue = edge_vals is not None
    kw = dict(m=part.rows_pad, nwin=part.wmax, backend=backend)
    if mesh.one_device:
        dev = mesh.device(0)
        arrays = part.stacked_arrays(dev)
        local = arrays.for_backend(backend, revalue=revalue)
        if revalue:
            local = ref.revalue_spmm_arrays(local, edge_vals.to(dev))
        b_halo = _halo_stack(_operand(b, blocks, dev), arrays["halo"])
        out = _apply_batch(spmm_apply, local, (b_halo,), **kw)
        flat = out.reshape(-1, b.shape[1]).to(b.device)
    else:
        outs = []
        for p in range(part.n_shards):
            dev = mesh.device(p)
            arrays = part.arrays(p, dev)
            local = arrays.for_backend(backend, revalue=revalue)
            if revalue:
                local = ref.revalue_spmm_arrays(local, edge_vals.to(dev))
            b_halo = _operand(b, blocks, dev).index_select(0,
                                                           arrays["halo"])
            outs.append(spmm_apply(local, b_halo, **kw).to(b.device))
        flat = torch.cat(outs)
    return flat.index_select(0, part.index("out_gather", b.device))


def sddmm_sharded(part: SDDMMPartition, x: torch.Tensor, y: torch.Tensor, *,
                  mesh: ShardMesh, axis: str = SHARD_AXIS,
                  backend: str = "cuda",
                  y_layout: str = "replicated") -> torch.Tensor:
    """values = sample(X·Yᵀ, sparsity(A)) over a mesh, canonical global
    nnz order.

    X is laid out in padded per-shard panels (``part.x_take``, one
    gather before the shards apply); Y follows ``y_layout`` like B in
    :func:`spmm_sharded`. Each shard scores into its local nnz slice;
    ``part.nnz_gather`` reassembles the canonical vector on ``x``'s
    device — again no cross-shard combine.
    """
    _check_mesh(part, mesh, axis, y_layout)
    panels = x.index_select(0, part.index("x_take", x.device)).view(
        part.n_shards, part.rows_pad, x.shape[1])
    blocks = _row_blocks(y, mesh) if y_layout == "rowshard" else None
    kw = dict(nnz=part.nnz_pad, backend=backend)
    if mesh.one_device:
        dev = mesh.device(0)
        arrays = part.stacked_arrays(dev)
        y_halo = _halo_stack(_operand(y, blocks, dev), arrays["halo"])
        out = _apply_batch(sddmm_apply, arrays.for_backend(backend),
                           (panels.to(dev), y_halo), **kw)
        flat = out.reshape(-1).to(x.device)
    else:
        outs = []
        for p in range(part.n_shards):
            dev = mesh.device(p)
            arrays = part.arrays(p, dev)
            y_halo = _operand(y, blocks, dev).index_select(0, arrays["halo"])
            outs.append(sddmm_apply(arrays.for_backend(backend),
                                    panels[p].to(dev), y_halo,
                                    **kw).to(x.device))
        flat = torch.cat(outs)
    return flat.index_select(0, part.index("nnz_gather", x.device))


class BatchedSpMM:
    """Apply one Libra plan to a stack of B panels: ``(batch, k, n) →
    (batch, m, n)``; ``_cache`` holds the apply keys (batch shape, dtype,
    backend, revalued) used so far."""

    def __init__(self, a, spec: ExecSpec | None = None, *,
                 balance: BalanceParams | None = None):
        self.op = LibraSpMM(a, spec=spec, balance=balance)
        self._cache: set = set()

    def __call__(self, b_stack: torch.Tensor, backend: str | None = None,
                 edge_vals: torch.Tensor | None = None) -> torch.Tensor:
        """Apply the plan to every panel; ``edge_vals`` — optional
        ``(batch, nnz)`` canonical per-panel values — revalues the plan
        per panel (the attention-serving path)."""
        op = self.op
        if b_stack.ndim != 3 or b_stack.shape[1] != op.k:
            raise ValueError(f"b_stack must be (batch, {op.k}, n), got "
                             f"{tuple(b_stack.shape)}")
        backend = op.spec.backend if backend is None else backend
        has_ev = edge_vals is not None
        arrs = op.arrays.for_backend(backend, revalue=has_ev)
        out = apply_at(
            self._cache,
            (tuple(b_stack.shape), str(b_stack.dtype), backend, has_ev),
            op.device, spmm_apply_stack, arrs, b_stack, m=op.m,
            nwin=op.nwin, backend=backend, edge_vals=edge_vals)
        if op._row_unperm is not None:   # reordered plan: restore rows
            with span("apply.permute"):
                out = out.index_select(1, op._row_unperm)
        return out


class BatchedSDDMM:
    """``(batch, m, kf) × (batch, k, kf) → (batch, nnz)`` over one plan
    (``_cache`` holds the apply keys used so far)."""

    def __init__(self, a, spec: ExecSpec | None = None, *,
                 balance: BalanceParams | None = None):
        self.op = LibraSDDMM(a, spec=spec, balance=balance)
        self._cache: set = set()

    def __call__(self, x_stack: torch.Tensor, y_stack: torch.Tensor,
                 backend: str | None = None) -> torch.Tensor:
        op = self.op
        if x_stack.ndim != 3 or y_stack.ndim != 3:
            raise ValueError("x_stack and y_stack must be 3-d stacks")
        backend = op.spec.backend if backend is None else backend
        perm = op._row_perm
        if perm is not None and x_stack.shape[1] > op.m:
            perm = torch.cat([perm, torch.arange(
                op.m, x_stack.shape[1], device=perm.device)])
        if perm is not None:   # reordered plan: permute X's rows
            with span("apply.permute"):
                x_stack = x_stack.index_select(1, perm)
        return apply_at(
            self._cache,
            (tuple(x_stack.shape), tuple(y_stack.shape),
             str(x_stack.dtype), backend),
            op.device, sddmm_apply_stack, op.arrays.for_backend(backend),
            x_stack, y_stack, nnz=op.nnz, backend=backend)


class ShardedSpMM:
    """Engine-callable sharded apply: partition and mesh bound once.

    The serving-shape counterpart of :class:`BatchedSpMM` for graphs too
    large (or too imbalanced) for one device: the partition is the
    amortized asset; requests arrive as ``(k, n)`` panels. Accepts a
    :class:`~repro_torch.dist.partition.SpMMPartition` or a raw
    :class:`~repro_torch.sparse.matrix.SparseCSR` (partitioned here
    under ``spec``); ``edge_vals`` revalues the tables per call
    (canonical nnz order). ``_cache`` holds the apply keys (operand
    shape, dtype, revalued) used so far; ``arrays`` the lazy device
    tables the applies read: the stacked tables when every shard shares
    one device, else each shard's.
    """

    def __init__(self, a, mesh: ShardMesh, *, axis: str = SHARD_AXIS,
                 spec: ExecSpec | None = None, timer=None):
        spec = ExecSpec() if spec is None else spec
        self.spec = spec
        self.part = (a if isinstance(a, SpMMPartition)
                     else partition_spmm(a, int(mesh.shape[axis]),
                                         spec=spec, mesh=mesh, timer=timer))
        _check_mesh(self.part, mesh, axis, spec.b_layout)
        self.mesh, self.axis = mesh, axis
        self.backend, self.b_layout = spec.backend, spec.b_layout
        self.m, self.k, self.nnz = self.part.m, self.part.k, self.part.nnz
        self.arrays = _device_arrays(self.part, mesh)
        self._cache: set = set()

    @property
    def tune_config(self):
        return self.part.run_cfg

    def __call__(self, b: torch.Tensor,
                 edge_vals: torch.Tensor | None = None) -> torch.Tensor:
        if b.shape[0] != self.k:
            raise ValueError(f"b has {b.shape[0]} rows, A has {self.k} "
                             "columns")
        return apply_at(
            self._cache,
            (tuple(b.shape), str(b.dtype), edge_vals is not None),
            self.mesh.device(0), spmm_sharded, self.part, b,
            mesh=self.mesh, axis=self.axis, backend=self.backend,
            edge_vals=edge_vals, b_layout=self.b_layout)


class ShardedSDDMM:
    """Engine-callable sharded SDDMM — see :class:`ShardedSpMM`."""

    def __init__(self, a, mesh: ShardMesh, *, axis: str = SHARD_AXIS,
                 spec: ExecSpec | None = None, timer=None):
        spec = ExecSpec() if spec is None else spec
        self.spec = spec
        self.part = (a if isinstance(a, SDDMMPartition)
                     else partition_sddmm(a, int(mesh.shape[axis]),
                                          spec=spec, mesh=mesh, timer=timer))
        _check_mesh(self.part, mesh, axis, spec.b_layout)
        self.mesh, self.axis = mesh, axis
        self.backend, self.y_layout = spec.backend, spec.b_layout
        self.m, self.k, self.nnz = self.part.m, self.part.k, self.part.nnz
        self.arrays = _device_arrays(self.part, mesh)
        self._cache: set = set()

    @property
    def tune_config(self):
        return self.part.run_cfg

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.shape[0] < self.m or y.shape[0] < self.k:
            raise ValueError(f"x needs ≥ {self.m} rows and y ≥ {self.k}, "
                             f"got {x.shape[0]} and {y.shape[0]}")
        return apply_at(
            self._cache, (tuple(x.shape), tuple(y.shape), str(x.dtype)),
            self.mesh.device(0), sddmm_sharded, self.part, x, y,
            mesh=self.mesh, axis=self.axis, backend=self.backend,
            y_layout=self.y_layout)
