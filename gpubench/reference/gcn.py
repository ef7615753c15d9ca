"""Plain PyTorch GCN: ``H' = Â (H W)`` with Â = D^-1/2 A D^-1/2, ReLU
but after the last layer; a layer is ``{"w": (d_in, d_out)}``."""
from __future__ import annotations

import torch

from .gnn import Edges, aggregate

KEYS = ("w",)


def gcn_norm(e: Edges) -> torch.Tensor:
    """Â's values, float32: 1/sqrt(deg(row)·deg(col)), degrees at least 1."""
    deg_r = torch.bincount(e.rows, minlength=e.m).clamp_min(1).double()
    deg_c = torch.bincount(e.cols, minlength=e.m).clamp_min(1).double()
    return (1.0 / torch.sqrt(deg_r[e.rows] * deg_c[e.cols])).float()


def graph_terms(e: Edges) -> torch.Tensor:
    return gcn_norm(e)


def forward(layers: list[dict], e: Edges, x: torch.Tensor,
            dtype=torch.float32, terms: torch.Tensor | None = None):
    """Logits of every node, in ``dtype``; ``terms`` are Â's values."""
    h = x.to(dtype)
    last = len(layers) - 1
    v = (gcn_norm(e) if terms is None else terms).to(dtype)
    for i, layer in enumerate(layers):
        h = aggregate(e, v, h @ layer["w"].to(dtype))
        if i < last:
            h = torch.relu(h)
    return h
