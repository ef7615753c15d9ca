"""Window-sharded + batched hybrid sparse execution
(:mod:`repro_torch.dist.partition` / :mod:`repro_torch.dist.sparse` /
:mod:`repro_torch.dist.gnn`), and the dense models' placement rules over
an in-process named mesh (:mod:`repro_torch.dist.sharding`).

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
    "LayerSharding": "repro_torch.dist.sharding",
    "Mesh": "repro_torch.dist.sharding",
    "NamedSharding": "repro_torch.dist.sharding",
    "PartitionSpec": "repro_torch.dist.sharding",
    "Placed": "repro_torch.dist.sharding",
    "activation_context": "repro_torch.dist.sharding",
    "batch_shardings": "repro_torch.dist.sharding",
    "cache_shardings": "repro_torch.dist.sharding",
    "device_put": "repro_torch.dist.sharding",
    "gather": "repro_torch.dist.sharding",
    "make_agnn_train_step": "repro_torch.dist.gnn",
    "make_gcn_train_step": "repro_torch.dist.gnn",
    "make_mesh": "repro_torch.dist.sharding",
    "param_shardings": "repro_torch.dist.sharding",
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
