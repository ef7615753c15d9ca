"""Batched (and, later, window-sharded) hybrid sparse execution.

The port has the batched operators the serving tier runs
(:class:`~repro_torch.dist.sparse.BatchedSpMM`,
:class:`~repro_torch.dist.sparse.BatchedSDDMM`). The sharded ones, the
window partitioner and distributed GNN training are ROADMAP item 12:
:class:`~repro_torch.dist.sparse.ShardedSpMM` and
:class:`~repro_torch.dist.sparse.ShardedSDDMM` raise
``NotImplementedError`` naming it.

Lazy exports (PEP 562) so ``import repro_torch.dist`` stays cheap.
"""
from __future__ import annotations

_LAZY = {
    "BatchedSDDMM": "repro_torch.dist.sparse",
    "BatchedSpMM": "repro_torch.dist.sparse",
    "ShardedSDDMM": "repro_torch.dist.sparse",
    "ShardedSpMM": "repro_torch.dist.sparse",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'repro_torch.dist' has no attribute {name!r}")
