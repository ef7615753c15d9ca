"""Batched hybrid sparse execution: one plan over a stack of panels.

:class:`BatchedSpMM` / :class:`BatchedSDDMM` apply one Libra plan to a
``(batch, k, n)`` stack of dense panels (the serving shape: one graph,
many feature panels in flight) through
:func:`~repro_torch.kernels.ops.spmm_apply_stack` /
:func:`~repro_torch.kernels.ops.sddmm_apply_stack`, counting the apply
keys (batch shape, dtype, backend) they have used. On the card a stack
runs K1–K4 panel by panel, so each panel's result is bit for bit the
single apply's. Reordered plans keep the single operators' contract: SpMM
outputs come back in original row order (one ``index_select`` of the
reordered rows), SDDMM gathers X's rows into the reordered row space.

The window-sharded operators (the reference's ``ShardedSpMM`` /
``ShardedSDDMM`` over ``shard_map``) are ROADMAP item 12; their classes
here raise ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import torch

from repro_torch.api import ExecSpec
from repro_torch.core.balance import BalanceParams
from repro_torch.core.sddmm import LibraSDDMM
from repro_torch.core.spmm import LibraSpMM
from repro_torch.kernels.ops import (
    apply_at,
    sddmm_apply_stack,
    spmm_apply_stack,
)

_SHARDED = ("window-sharded execution is not ported yet (ROADMAP item 12: "
            "dist/partition.py, then dist/sparse.py on torch.distributed)")


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
            x_stack = x_stack.index_select(1, perm)
        return apply_at(
            self._cache,
            (tuple(x_stack.shape), tuple(y_stack.shape),
             str(x_stack.dtype), backend),
            op.device, sddmm_apply_stack, op.arrays.for_backend(backend),
            x_stack, y_stack, nnz=op.nnz, backend=backend)


class ShardedSpMM:
    """Window-sharded SpMM over a device mesh: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"ShardedSpMM: {_SHARDED}")


class ShardedSDDMM:
    """Window-sharded SDDMM over a device mesh: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"ShardedSDDMM: {_SHARDED}")
