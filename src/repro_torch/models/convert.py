"""Carry GNN parameters from the reference package's layout to modules.

The reference keeps a model's parameters as a list of per-layer dicts:
``[{"w": (d_in, d_out)}, ...]`` for GCN, plus ``"beta": ()`` per layer
for AGNN. These functions take such a list as NumPy arrays (convert
``jax.Array`` leaves with ``np.asarray`` first) and return the port's
modules holding the same values, so both packages compute the same
function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.gnn import AGNN, GCN


def _dims(params) -> list[int]:
    ws = [np.asarray(p["w"]) for p in params]
    return [ws[0].shape[0]] + [w.shape[1] for w in ws]


def _load_weights(module, params, device):
    with torch.no_grad():
        for w, p in zip(module.weights, params):
            w.copy_(torch.tensor(np.asarray(p["w"], np.float32)))
    return module.to(device)


def gcn_params_from_jax(params, device="cpu") -> GCN:
    """A :class:`GCN` holding the reference's ``[{"w": ...}]`` values."""
    return _load_weights(GCN(_dims(params)), params, device)


def agnn_params_from_jax(params, device="cpu") -> AGNN:
    """An :class:`AGNN` holding the reference's ``[{"w", "beta"}]`` values."""
    model = AGNN(_dims(params))
    with torch.no_grad():
        for beta, p in zip(model.betas, params):
            beta.fill_(float(np.asarray(p["beta"])))
    return _load_weights(model, params, device)
