"""GCN: ``H' = Â (H W)`` a layer, Â's normalised values as the edge
values; the program's ``GCN``."""
from __future__ import annotations

import torch

from gpubench import cells, work

WIDTHS = "dims"
REFERENCE = "gcn"


def draw_params(cfg: dict, seed: int, dev: torch.device) -> list[dict]:
    """``w`` a layer (:func:`gpubench.cells.draw_weights`)."""
    return [{"w": w} for w in cells.draw_weights(cfg["dims"], seed, dev)]


def build_train(world, spec) -> None:
    """The plans, and Â's values on the device."""
    from repro_torch.models.gnn import GraphOps, gcn_norm_edges

    world.gops = GraphOps(world.csr, spec=spec)
    world.norm = torch.from_numpy(gcn_norm_edges(world.csr)).to(world.dev)


def train_args(world) -> tuple:
    return (world.norm,)


def module(cfg: dict, layers: list[dict], dev: torch.device):
    from repro_torch.models.gnn import GCN

    model = GCN(cfg["dims"]).to(dev)
    with torch.no_grad():
        for w, layer in zip(model.weights, layers):
            w.copy_(layer["w"])
    return model


def leaves(model) -> list[torch.Tensor]:
    return list(model.weights)


def register(service, name: str, csr, model) -> None:
    service.register_gcn(name, csr, model)


def step_flops(n: int, nnz: int, cfg: dict) -> float:
    """One full-batch GCN step.

    Forward: ``H W`` and the SpMM at ``d_out``. Backward: the SpMM on
    Aᵀ at ``d_out``, ``dW = Hᵀ dY`` and, except for the first layer,
    whose input (the features) needs no gradient, ``dH = dY Wᵀ``. The
    edge values are constants: no SDDMM."""
    dims = cfg["dims"]
    total = 0.0
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        dense = work.dense_flops(n, d_in, d_out)
        total += dense * (2 if i == 0 else 3)
        total += 2 * (2.0 * nnz * d_out)
    return total
