"""Zamba2-style hybrid LM as an ``nn.Module``: a Mamba2 backbone and one
*shared* attention block.

Mirrors ``repro.models.hybrid``. The layers run in ``n_layers //
hybrid_attn_every`` groups of ``hybrid_attn_every`` Mamba2 layers, each
group followed by the same attention + MLP parameter set
(``shared_attn``, one :class:`~repro_torch.models.transformer.Layer`
applied after every group), then a tail of the remaining Mamba2 layers:
zamba2-7b runs 13 groups of 6 and a tail of 3. The shared attention uses
a sliding window, ``min(sliding_window, S + 1)``, and runs K5
(``layers.attention_block``); decoding runs the plain
``layers.decode_attention`` over a ring buffer of ``min(sliding_window,
max_len)`` slots per application, which holds exactly the window's
tokens, as the reference does. The residual stream stays in fp32, as in
:mod:`repro_torch.models.mamba2`. With ``cfg.remat`` and grad enabled
each group (its Mamba2 layers, then the shared block) runs under
``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` over a
group; the tail runs without. The shared block's gradient sums over its
applications.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.api import checked_device
from repro_torch.dist import sharding as sh
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import Layer, attn_decode


def _group_counts(cfg: ArchConfig) -> tuple[int, int]:
    """(groups, tail layers)."""
    every = cfg.hybrid_attn_every
    ngroups = cfg.n_layers // every
    return ngroups, cfg.n_layers - ngroups * every


class HybridLM(nn.Module):
    """Mamba2 groups with a shared attention block, and a Mamba2 tail.

    Args:
      cfg: a ``hybrid`` :class:`ArchConfig`.
      generator: draws every weight (on the generator's device, then
        moved to ``device``); ``None`` leaves the drawn weights
        uninitialised for :func:`repro_torch.models.convert.hybrid_params_from_jax`.
      device: where the parameters live; ``"cuda"`` (the default) needs a
        card and raises without one.
    """

    def __init__(self, cfg: ArchConfig, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        if cfg.family != "hybrid":
            raise NotImplementedError(
                f"HybridLM is the hybrid family; got {cfg.family!r}")
        dev = checked_device(device, "HybridLM")
        self.cfg = cfg
        ngroups, tail = _group_counts(cfg)
        self.embedding = nn.Parameter(L.init_embedding(generator, cfg, dev))
        self.groups = nn.ModuleList(
            nn.ModuleList(mamba2.Mamba2Layer(cfg, generator, dev)
                          for _ in range(cfg.hybrid_attn_every))
            for _ in range(ngroups))
        self.shared_attn = Layer(cfg, generator, dev)
        self.tail = nn.ModuleList(mamba2.Mamba2Layer(cfg, generator, dev)
                                  for _ in range(tail))
        self.final_norm = nn.Parameter(L.init_norm(cfg, dev))

    def _shared_attn_block(self, x):
        cfg, sp = self.cfg, self.shared_attn
        cd = L.dtype_of(cfg, "compute_dtype")
        window = min(cfg.sliding_window, x.shape[1] + 1)
        h = L.rms_norm(x, sp.attn_norm, cfg.norm_eps).to(cd)
        x = x + L.attention_block(sp.attn, h, cfg, layer_window=window)
        h = L.rms_norm(x, sp.mlp_norm, cfg.norm_eps).to(cd)
        return x + L.mlp_block(sp.mlp, h, cfg)

    def _group(self, group, x):
        """A group's Mamba2 layers, then the shared block."""
        for lp in group:
            x = mamba2.apply_layer(lp, x, self.cfg)
        return self._shared_attn_block(x)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Prefill forward: logits (B, S, vocab) in fp32."""
        cfg = self.cfg
        x = L.embed(self.embedding, tokens, cfg).float()
        remat = cfg.remat and torch.is_grad_enabled()
        for group in self.groups:
            if remat:
                # The group draws no random numbers: no RNG state to keep.
                x = checkpoint(self._group, group, x, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=sh.remat_context)
            else:
                x = self._group(group, x)
        for lp in self.tail:
            x = mamba2.apply_layer(lp, x, cfg)
        return mamba2.final_logits(self, x)

    def decode_step(self, cache: dict, token: torch.Tensor, cache_len: int):
        """One-token decode; each application of the shared attention
        writes its ring buffer at ``(cache_len - 1) % wlen`` and attends
        over the filled slots. Returns (logits, cache), updated in place."""
        cfg = self.cfg
        cache_len = int(cache_len)
        x = L.embed(self.embedding, token, cfg).float()
        wlen = cache["attn_k"].shape[2]
        pos = torch.full((x.shape[0], 1), cache_len - 1, dtype=torch.int32,
                         device=x.device)
        slot = (cache_len - 1) % wlen
        filled = min(cache_len, wlen)
        for g, group in enumerate(self.groups):
            x = mamba2.decode_layers(group, x, cache["g_state"][g],
                                     cache["g_conv_x"][g],
                                     cache["g_conv_bc"][g], cfg)
            # Ring buffer: every filled slot is inside the window.
            x = attn_decode(self.shared_attn, x, cache["attn_k"][g],
                            cache["attn_v"][g], pos, cfg, write_at=slot,
                            read_len=filled)
        if len(self.tail):
            x = mamba2.decode_layers(self.tail, x, cache["t_state"],
                                     cache["t_conv_x"], cache["t_conv_bc"],
                                     cfg)
        return mamba2.final_logits(self, x), cache


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Mamba2 states and conv tails for every layer, and a ring buffer of
    ``min(sliding_window, max_len)`` K/V slots per shared-attention
    application."""
    dev = checked_device(device, "init_cache")
    ngroups, tail = _group_counts(cfg)
    every = cfg.hybrid_attn_every
    d_in, h, p, n = mamba2._dims(cfg)
    kv, hd = cfg.n_kv, cfg.head_dim
    k = cfg.ssm_conv - 1
    wlen = min(cfg.sliding_window, max_len)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    cache = {
        "g_state": zeros((ngroups, every, batch, h, p, n), torch.float32),
        "g_conv_x": zeros((ngroups, every, batch, k, d_in)),
        "g_conv_bc": zeros((ngroups, every, batch, k, 2 * n)),
        "attn_k": zeros((ngroups, batch, wlen, kv, hd)),
        "attn_v": zeros((ngroups, batch, wlen, kv, hd)),
    }
    if tail:
        cache["t_state"] = zeros((tail, batch, h, p, n), torch.float32)
        cache["t_conv_x"] = zeros((tail, batch, k, d_in))
        cache["t_conv_bc"] = zeros((tail, batch, k, 2 * n))
    return cache
