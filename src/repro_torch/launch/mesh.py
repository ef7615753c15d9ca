"""Production meshes over :class:`repro_torch.dist.sharding.Mesh`.

Mirrors ``repro.launch.mesh``: functions, not module constants, so that
importing this module touches no device. Positions go round robin over
the cards (all on ``cuda:0`` with one card) unless the caller names a
device for every position, such as ``"cpu"`` or ``"meta"``.
"""
from __future__ import annotations

from repro_torch.dist.sharding import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> Mesh:
    """``(16, 16)`` over ``("data", "model")``, or ``(2, 16, 16)`` over
    ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_local_mesh(*, device="cuda") -> Mesh:
    """A one-position mesh with the production axis names."""
    return make_mesh((1, 1), ("data", "model"), device=device)
