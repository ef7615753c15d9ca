"""Carry parameters from the reference package's layout to modules.

The reference keeps a GNN's parameters as a list of per-layer dicts:
``[{"w": (d_in, d_out)}, ...]`` for GCN, plus ``"beta": ()`` per layer
for AGNN; a dense or MoE transformer's as one tree whose ``layers``
leaves are stacked over a leading ``n_layers`` axis. These functions take such
trees as NumPy arrays (convert ``jax.Array`` leaves with ``np.asarray``
first) and return the port's modules holding the same values, so both
packages compute the same function. Like every entry point of the port
they place the module on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import checked_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.gnn import AGNN, GCN
from repro_torch.models.moe import MoETransformer
from repro_torch.models.transformer import Transformer


def _dims(params) -> list[int]:
    ws = [np.asarray(p["w"]) for p in params]
    return [ws[0].shape[0]] + [w.shape[1] for w in ws]


def _load_weights(module, params, device):
    with torch.no_grad():
        for w, p in zip(module.weights, params):
            w.copy_(torch.tensor(np.asarray(p["w"], np.float32)))
    return module.to(checked_device(device, "convert"))


def gcn_params_from_jax(params, device="cuda") -> GCN:
    """A :class:`GCN` holding the reference's ``[{"w": ...}]`` values."""
    return _load_weights(GCN(_dims(params)), params, device)


def agnn_params_from_jax(params, device="cuda") -> AGNN:
    """An :class:`AGNN` holding the reference's ``[{"w", "beta"}]`` values."""
    model = AGNN(_dims(params))
    with torch.no_grad():
        for beta, p in zip(model.betas, params):
            beta.fill_(float(np.asarray(p["beta"])))
    return _load_weights(model, params, device)


def _put(dst, src):
    dst.copy_(torch.from_numpy(np.array(src)))


def _load_stacked(model, params, groups):
    """Copy a stacked reference tree into ``model`` (a module with
    ``embedding``, ``layers`` and ``final_norm``); ``groups`` names each
    layer's ``ParameterDict``s, whose nested dicts nest in the tree too."""
    stacked = params["layers"]

    def put_dict(pd, tree, i):
        for name, t in pd.items():
            if isinstance(t, torch.nn.ParameterDict):
                put_dict(t, tree[name], i)
            else:
                _put(t, tree[name][i])

    with torch.no_grad():
        _put(model.embedding, params["embed"]["embedding"])
        _put(model.final_norm, params["final_norm"]["scale"])
        for i, lp in enumerate(model.layers):
            _put(lp.attn_norm, stacked["attn_norm"]["scale"][i])
            _put(lp.mlp_norm, stacked["mlp_norm"]["scale"][i])
            for group in groups:
                put_dict(getattr(lp, group), stacked[group], i)
    return model


def transformer_params_from_jax(params, cfg: ArchConfig,
                                device="cuda") -> Transformer:
    """A :class:`Transformer` holding the reference's dense parameters.

    ``params`` is ``{"embed": {"embedding"}, "layers": {"attn_norm":
    {"scale"}, "attn": {"wq", "wk", "wv", "wo"}, "mlp_norm": {"scale"},
    "mlp": {"wi_gate", "wi_up", "wo"}}, "final_norm": {"scale"}}`` with
    every ``layers`` leaf stacked over ``n_layers``.
    """
    model = Transformer(cfg, device=checked_device(device, "convert"))
    return _load_stacked(model, params, ("attn", "mlp"))


def moe_params_from_jax(params, cfg: ArchConfig,
                        device="cuda") -> MoETransformer:
    """A :class:`MoETransformer` holding the reference's MoE parameters.

    ``params`` is the dense tree with ``"moe": {"router", "wi_gate",
    "wi_up", "wo"}`` (and ``"shared": {"wi_gate", "wi_up", "wo"}`` with
    shared experts) in place of ``"mlp"``, every ``layers`` leaf stacked
    over ``n_layers``.
    """
    model = MoETransformer(cfg, device=checked_device(device, "convert"))
    return _load_stacked(model, params, ("attn", "moe"))
