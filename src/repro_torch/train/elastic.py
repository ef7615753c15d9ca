"""Elastic scaling: move a training state between meshes.

Mirrors ``repro.train.elastic``. Checkpoints store whole (unsharded)
tensors, so elasticity is a re-placement problem: build shardings for
the new mesh from the same rules and place the state by them.
:func:`remesh_live` moves an in-memory state; a restart after losing
devices restores the newest checkpoint and places it the same way.
"""
from __future__ import annotations

from repro_torch.dist import sharding as sh


def remesh_live(tree, new_mesh, spec_fn=None):
    """Re-place a tree (of :class:`~repro_torch.dist.sharding.Placed` or
    of tensors) onto ``new_mesh``: gather, then place by
    ``param_shardings`` (or by ``spec_fn(new_mesh, tree)``)."""
    whole = sh.gather(tree)
    if spec_fn is None:
        shardings = sh.param_shardings(new_mesh, whole)
    else:
        shardings = spec_fn(new_mesh, whole)
    return sh.device_put(whole, shardings)


def degrade_plan(n_failed: int,
                 mesh_shape: tuple[int, ...]) -> tuple[int, ...]:
    """The largest rectangular sub-mesh after losing ``n_failed`` devices
    (drop whole data-axis rows, the standard slice-repair move)."""
    data, model = mesh_shape[-2], mesh_shape[-1]
    rows_lost = (n_failed + model - 1) // model
    new_data = max(1, data - rows_lost)
    return (*mesh_shape[:-2], new_data, model)
