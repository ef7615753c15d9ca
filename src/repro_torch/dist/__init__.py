"""Window-sharded + batched hybrid sparse execution
(:mod:`repro_torch.dist.partition` / :mod:`repro_torch.dist.sparse` /
:mod:`repro_torch.dist.gnn`).

The reference package's GSPMD rules for the dense models
(``dist/sharding.py``) belong with the dense stack, ROADMAP item 13.

Lazy exports (PEP 562) so ``import repro_torch.dist`` stays cheap.
"""
from __future__ import annotations

_LAZY = {
    "BatchedSDDMM": "repro_torch.dist.sparse",
    "BatchedSpMM": "repro_torch.dist.sparse",
    "DistGraphOps": "repro_torch.dist.gnn",
    "SDDMMPartition": "repro_torch.dist.partition",
    "SHARD_AXIS": "repro_torch.dist.sparse",
    "Shard": "repro_torch.dist.partition",
    "ShardMesh": "repro_torch.dist.sparse",
    "ShardedSDDMM": "repro_torch.dist.sparse",
    "ShardedSpMM": "repro_torch.dist.sparse",
    "SpMMPartition": "repro_torch.dist.partition",
    "column_halo": "repro_torch.dist.partition",
    "make_agnn_train_step": "repro_torch.dist.gnn",
    "make_gcn_train_step": "repro_torch.dist.gnn",
    "partition_sddmm": "repro_torch.dist.partition",
    "partition_spmm": "repro_torch.dist.partition",
    "sddmm_sharded": "repro_torch.dist.sparse",
    "shard_windows": "repro_torch.dist.partition",
    "spmm_sharded": "repro_torch.dist.sparse",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'repro_torch.dist' has no attribute {name!r}")
