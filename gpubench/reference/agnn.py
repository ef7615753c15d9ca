"""Plain PyTorch AGNN: ``Hn = H / ‖H‖``, ``s_p = β ⟨Hn[row_p],
Hn[col_p]⟩``, ``a = softmax over each destination row``,
``H' = (a·H) W``, ReLU but after the last layer; a layer is
``{"w": (d_in, d_out), "beta": ()}``."""
from __future__ import annotations

import torch

from .gnn import Edges, aggregate, edge_dots, row_softmax

KEYS = ("w", "beta")


def graph_terms(e: Edges) -> None:
    return None


def forward(layers: list[dict], e: Edges, x: torch.Tensor,
            dtype=torch.float32, terms=None):
    """Logits of every node, in ``dtype``."""
    h = x.to(dtype)
    last = len(layers) - 1
    for i, layer in enumerate(layers):
        hn = h / torch.linalg.vector_norm(h, dim=-1,
                                          keepdim=True).clamp_min(1e-9)
        att = row_softmax(e, edge_dots(e, hn, hn) * layer["beta"].to(dtype))
        h = aggregate(e, att, h) @ layer["w"].to(dtype)
        if i < last:
            h = torch.relu(h)
    return h
