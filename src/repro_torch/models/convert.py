"""Carry parameters from the reference package's layout to modules.

The reference keeps a GNN's parameters as a list of per-layer dicts:
``[{"w": (d_in, d_out)}, ...]`` for GCN, plus ``"beta": ()`` per layer
for AGNN; a language model's as one tree whose layer leaves are stacked
over leading layer axes (``layers`` over ``n_layers``; the hybrid's
``groups`` over groups and layers), which :func:`param_layout` describes
for every family. These functions take such
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
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.mamba2 import Mamba2LM
from repro_torch.models.moe import MoETransformer
from repro_torch.models.transformer import Transformer
from repro_torch.models.whisper import Whisper


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


def param_layout(model) -> dict[tuple[str, ...], np.ndarray]:
    """The reference's parameter tree of ``model``, any language-model
    family: each leaf's path → the port's parameter names it holds, an
    object array whose shape is the leaf's leading stacked axes (``()``
    for a leaf that is not stacked).

    One rule covers every family, read off the module tree: a parameter
    named ``<container>.<i>[.<j>].<rest>`` lies at index ``(i[, j])`` of
    the leaf ``(<container>, *<rest>)``; ``embedding`` is the reference's
    ``("embed", "embedding")``; a norm (a name ending in ``norm``) is a
    ``{"scale"}`` dict in the reference and a bare parameter here. So
    ``layers`` (dense, VLM, MoE, SSM), ``enc_layers``/``dec_layers``
    (audio) are stacked over the layers, the hybrid's ``groups`` over
    ``(ngroups, every)`` and its ``tail`` over the tail's layers, and
    ``shared_attn``, ``enc_norm``, ``final_norm`` stand alone. The
    converters below, :mod:`repro_torch.train.checkpoint` and
    :mod:`repro_torch.dist.sharding` read it.
    """
    return layout_of(name for name, _ in model.named_parameters())


def layout_of(names) -> dict[tuple[str, ...], np.ndarray]:
    """:func:`param_layout` from parameter names alone (any iterable of
    dotted names, such as the keys of ``dict(model.named_parameters())``
    or of the AdamW moments). The first run of integer parts indexes the
    leaf wherever it starts, so names under a prefix (``mu.layers.0.wq``)
    stack as the names without it do."""
    index: dict[tuple[str, ...], dict[tuple[int, ...], str]] = {}
    for name in names:
        parts = name.split(".")
        i = next((j for j, x in enumerate(parts) if x.isdigit()),
                 len(parts))
        idx = []
        while i < len(parts) and parts[i].isdigit():
            idx.append(int(parts.pop(i)))
        path = tuple(parts)
        if path == ("embedding",):
            path = ("embed", "embedding")
        elif path[-1].endswith("norm"):
            path += ("scale",)
        index.setdefault(path, {})[tuple(idx)] = name
    layout = {}
    for path, names in index.items():
        grid = np.empty(tuple(max(ix) + 1 for ix in zip(*names)),
                        dtype=object)
        for ix, name in names.items():
            grid[ix] = name
        layout[path] = grid
    return layout


def ref_leaf(tree, path):
    """The leaf of a nested-dict ``tree`` at ``path``."""
    for key in path:
        tree = tree[key]
    return tree


def _load_params(model, params):
    """Copy the reference's tree ``params`` (array leaves) into ``model``
    through :func:`param_layout`; returns ``model``."""
    tensors = dict(model.named_parameters())
    with torch.no_grad():
        for path, names in param_layout(model).items():
            leaf = np.asarray(ref_leaf(params, path))
            for ix in np.ndindex(names.shape):
                _put(tensors[names[ix]], leaf[ix])
    return model


def transformer_params_from_jax(params, cfg: ArchConfig,
                                device="cuda") -> Transformer:
    """A :class:`Transformer` holding the reference's dense or VLM
    parameters.

    ``params`` is ``{"embed": {"embedding"}, "layers": {"attn_norm":
    {"scale"}, "attn": {"wq", "wk", "wv", "wo"}, "mlp_norm": {"scale"},
    "mlp": {"wi_gate", "wi_up", "wo"}}, "final_norm": {"scale"}}`` with
    every ``layers`` leaf stacked over ``n_layers``.
    """
    model = Transformer(cfg, device=checked_device(device, "convert"))
    return _load_params(model, params)


def moe_params_from_jax(params, cfg: ArchConfig,
                        device="cuda") -> MoETransformer:
    """A :class:`MoETransformer` holding the reference's MoE parameters.

    ``params`` is the dense tree with ``"moe": {"router", "wi_gate",
    "wi_up", "wo"}`` (and ``"shared": {"wi_gate", "wi_up", "wo"}`` with
    shared experts) in place of ``"mlp"``, every ``layers`` leaf stacked
    over ``n_layers``.
    """
    model = MoETransformer(cfg, device=checked_device(device, "convert"))
    return _load_params(model, params)


def mamba2_params_from_jax(params, cfg: ArchConfig,
                           device="cuda") -> Mamba2LM:
    """A :class:`Mamba2LM` holding the reference's SSM parameters:
    ``embed``, ``final_norm`` and ``layers`` (``norm``, ``wz``, ``wx``,
    ``wb``, ``wc``, ``wdt``, ``conv_x``, ``conv_b``, ``conv_c``,
    ``a_log``, ``d_skip``, ``dt_bias``, ``gate_norm``, ``out_proj``, each
    stacked over ``n_layers``)."""
    model = Mamba2LM(cfg, device=checked_device(device, "convert"))
    return _load_params(model, params)


def hybrid_params_from_jax(params, cfg: ArchConfig,
                           device="cuda") -> HybridLM:
    """A :class:`HybridLM` holding the reference's hybrid parameters:
    ``groups`` (Mamba2 leaves stacked ``(ngroups, every, ...)``),
    ``shared_attn`` (one attention + MLP block), ``tail`` (stacked over
    the tail's layers, when there is one), ``embed`` and ``final_norm``."""
    model = HybridLM(cfg, device=checked_device(device, "convert"))
    return _load_params(model, params)


def whisper_params_from_jax(params, cfg: ArchConfig,
                            device="cuda") -> Whisper:
    """A :class:`Whisper` holding the reference's audio parameters:
    ``enc_layers`` and ``dec_layers`` stacked over their layers,
    ``enc_norm``, ``embed`` and ``final_norm``."""
    model = Whisper(cfg, device=checked_device(device, "convert"))
    return _load_params(model, params)
