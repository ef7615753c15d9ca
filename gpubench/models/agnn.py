"""AGNN: ``H' = (softmax_row(β ⟨Hn_i, Hn_j⟩) · H) W`` a layer, the
scores by SDDMM over the normalised features; the program's ``AGNN``."""
from __future__ import annotations

import torch

from gpubench import cells, work

WIDTHS = "dims"
REFERENCE = "agnn"


def draw_params(cfg: dict, seed: int, dev: torch.device) -> list[dict]:
    """``w`` a layer (:func:`gpubench.cells.draw_weights`) and ``beta``
    1."""
    return [{"w": w, "beta": torch.ones((), device=dev)}
            for w in cells.draw_weights(cfg["dims"], seed, dev)]


def build_train(world, spec) -> None:
    from repro_torch.models.gnn import GraphOps

    world.gops = GraphOps(world.csr, spec=spec)


def train_args(world) -> tuple:
    return ()


def module(cfg: dict, layers: list[dict], dev: torch.device):
    from repro_torch.models.gnn import AGNN

    model = AGNN(cfg["dims"]).to(dev)
    with torch.no_grad():
        for w, beta, layer in zip(model.weights, model.betas, layers):
            w.copy_(layer["w"])
            beta.copy_(layer["beta"])
    return model


def leaves(model) -> list[torch.Tensor]:
    """Each layer's ``w`` then its ``beta``."""
    return [p for w, beta in zip(model.weights, model.betas)
            for p in (w, beta)]


def register(service, name: str, csr, model) -> None:
    service.register_agnn(name, csr, model)


def step_flops(n: int, nnz: int, cfg: dict) -> float:
    """One full-batch AGNN step. A layer at input width ``d``:
    scores by SDDMM over the normalised ``H`` (``d``), the SpMM of the
    attention over ``H`` (``d``), then ``H W``.

    Backward: ``dW`` and ``d(agg) = dZ Wᵀ``; the SpMM's value gradient
    (an SDDMM at ``d``), needed for β in every layer. From the second
    layer on, ``H`` needs a gradient too: the SpMM on Aᵀ at ``d``
    and both SpMMs of the SDDMM's backward at ``d``. The first layer's
    input is the features, which need none."""
    dims = cfg["dims"]
    total = 0.0
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        sparse = 2.0 * nnz * d_in
        dense = work.dense_flops(n, d_in, d_out)
        total += 2 * sparse + dense          # forward
        total += 2 * dense + sparse          # dW, d(agg), d(attention)
        if i > 0:
            total += 3 * sparse              # dH through Aᵀ, dX, dY
    return total
