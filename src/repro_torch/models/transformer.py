"""Decoder-only transformer LM as an ``nn.Module``, dense and VLM.

Mirrors ``repro.models.transformer`` for the dense family (minitron-8b,
gemma2-9b with its local/global alternation and softcaps, glm4-9b,
granite-34b with MQA) and the VLM family (qwen2-vl-7b: M-RoPE, and a
stubbed frontend whose precomputed patch embeddings replace the first
``n_patches`` token embeddings). The reference scans one stacked
parameter tree over the layers; here each layer is a sub-module of a
``ModuleList`` holding the same leaves (``attn_norm``,
``attn.{wq,wk,wv,wo}``, ``mlp_norm``, ``mlp.{wi_gate,wi_up,wo}``), and
the embedding and final norm sit beside them. Every layer's attention in :meth:`forward` runs
K5 (``layers.flash_attention``); decoding runs the plain
``layers.decode_attention``, as the reference computes it outside any
kernel. With ``cfg.mrope`` every layer rotates q and k by M-RoPE over
three position streams, t = h = w for a text-only stream (close to
RoPE, not bit-equal: M-RoPE keeps its frequencies in fp32).

Training: with ``cfg.remat`` and grad enabled, each layer's block runs
under ``torch.utils.checkpoint`` (non-reentrant), the reference's
per-layer ``jax.checkpoint(..., policy=nothing_saveable)``: only the
layer inputs are kept, and the backward recomputes each layer, K5
included, so K5 launches twice a layer in a training step.

Decoding updates the cache tensors in place and returns the same dict
(the reference returns a new tree).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.api import checked_device
from repro_torch.dist import sharding as sh
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig


class Layer(nn.Module):
    """One pre-norm attention + MLP block's parameters."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator | None,
                 device):
        super().__init__()
        self.attn_norm = nn.Parameter(L.init_norm(cfg, device))
        self.attn = nn.ParameterDict(L.init_attention(gen, cfg, device))
        self.mlp_norm = nn.Parameter(L.init_norm(cfg, device))
        self.mlp = nn.ParameterDict(L.init_mlp(gen, cfg, device))


def layer_window(cfg: ArchConfig, layer_idx: int, seq_len: int) -> int:
    """Sliding window of one layer.

    gemma2 alternates local (even) and global (odd) layers; global layers
    get an "infinite" window (> seq_len) so one attention serves both.
    """
    if cfg.local_global and layer_idx % 2 == 0:
        return cfg.sliding_window
    return seq_len + 1


class Transformer(nn.Module):
    """Dense or VLM decoder-only LM.

    Args:
      cfg: a ``dense`` or ``vlm`` :class:`ArchConfig`.
      generator: draws every weight (on the generator's device, then
        moved to ``device``); ``None`` allocates them uninitialised for
        :func:`repro_torch.models.convert.transformer_params_from_jax`.
      device: where the parameters live; ``"cuda"`` (the default) needs a
        card and raises without one.
    """

    def __init__(self, cfg: ArchConfig, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        if cfg.family not in ("dense", "vlm"):
            raise NotImplementedError(
                f"Transformer is the dense and vlm families; got "
                f"{cfg.family!r}")
        dev = checked_device(device, "Transformer")
        self.cfg = cfg
        self.embedding = nn.Parameter(L.init_embedding(generator, cfg, dev))
        self.layers = nn.ModuleList(Layer(cfg, generator, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(L.init_norm(cfg, dev))

    # ------------------------------------------------------- prefill ---
    def _layer(self, lp: Layer, x, window: int, positions, positions3):
        cfg = self.cfg
        h = L.rms_norm(x, lp.attn_norm, cfg.norm_eps)
        h = L.attention_block(lp.attn, h, cfg, layer_window=window,
                              positions=positions, positions3=positions3)
        x = x + h
        h = L.rms_norm(x, lp.mlp_norm, cfg.norm_eps)
        return x + L.mlp_block(lp.mlp, h, cfg)

    def forward(self, tokens: torch.Tensor, *, patch_embeds=None,
                positions3=None) -> torch.Tensor:
        """Train/prefill forward: logits (B, S, vocab) in fp32.

        VLM family: ``patch_embeds`` (B, P, D), the stubbed frontend's
        output, replace the first P token embeddings; with ``cfg.mrope``
        and no ``positions3`` (3, B, S), the three streams are the token
        positions (a text-only stream)."""
        cfg = self.cfg
        x = L.embed(self.embedding, tokens, cfg)
        if cfg.family == "vlm" and patch_embeds is not None:
            n_p = patch_embeds.shape[1]
            x = torch.cat([patch_embeds.to(x.dtype), x[:, n_p:]], dim=1)
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)[None, :]
        if cfg.mrope and positions3 is None:
            positions3 = torch.stack([positions] * 3)
        remat = cfg.remat and torch.is_grad_enabled()
        for i, lp in enumerate(self.layers):
            window = layer_window(cfg, i, s)
            if remat:
                # The layer draws no random numbers: no RNG state to keep.
                x = checkpoint(self._layer, lp, x, window, positions,
                               positions3, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=sh.remat_context)
            else:
                x = self._layer(lp, x, window, positions, positions3)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        return L.unembed(self.embedding, x, cfg)

    # ------------------------------------------------------ decoding ---
    def decode_step(self, cache: dict, token: torch.Tensor, cache_len: int):
        """One-token decode. token: (B, 1) ints; cache_len: filled length
        *including* the new token's slot. Returns (logits, cache)."""
        cfg = self.cfg
        cache_len = int(cache_len)
        x = L.embed(self.embedding, token, cfg)
        pos = torch.full((x.shape[0], 1), cache_len - 1, dtype=torch.int32,
                         device=x.device)
        if cfg.local_global and "k_local" in cache:
            # Split cache (gemma2): even layers attend through a
            # sliding-window ring buffer that holds exactly the last
            # `wlen` tokens, odd layers through the full cache.
            wlen = cache["k_local"].shape[2]
            slot = (cache_len - 1) % wlen
            filled = min(cache_len, wlen)
            for i, lp in enumerate(self.layers):
                j = i // 2
                if i % 2 == 0:
                    x = attn_decode(
                        lp, x, cache["k_local"][j], cache["v_local"][j], pos,
                        cfg, write_at=slot, read_len=filled)
                else:
                    x = attn_decode(
                        lp, x, cache["k"][j], cache["v"][j], pos, cfg,
                        write_at=cache_len - 1, read_len=cache_len)
        else:
            for i, lp in enumerate(self.layers):
                kc, vc = cache["k"][i], cache["v"][i]
                x = attn_decode(
                    lp, x, kc, vc, pos, cfg, write_at=cache_len - 1,
                    read_len=cache_len,
                    window=layer_window(cfg, i, kc.shape[1]))
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        return L.unembed(self.embedding, x, cfg), cache


def attn_decode(lp: Layer, x, kc, vc, pos, cfg: ArchConfig, *,
                write_at: int, read_len: int, window=None):
    """One attention + MLP block of decode: write this token's K/V at
    ``write_at`` of the caches ``kc``, ``vc`` (B, S, KV, hd), attend over
    the first ``read_len`` slots (within ``window``, if given). ``x`` is
    the residual stream, in the compute type or (the hybrid's) fp32."""
    cd = L.dtype_of(cfg, "compute_dtype")
    h = L.rms_norm(x, lp.attn_norm, cfg.norm_eps).to(cd)
    q, k, v = L.qkv_project(lp.attn, h, cfg)
    if cfg.mrope:
        p3 = torch.stack([pos] * 3)
        q = L.apply_mrope(q, p3, cfg.rope_theta, cfg.mrope_sections)
        k = L.apply_mrope(k, p3, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
    kc[:, write_at] = k[:, 0].to(kc.dtype)
    vc[:, write_at] = v[:, 0].to(vc.dtype)
    o = L.decode_attention(q, kc, vc, read_len, window=window,
                           softcap_val=cfg.attn_softcap)
    x = x + o.reshape(o.shape[0], 1, -1) @ lp.attn["wo"].to(cd)
    h = L.rms_norm(x, lp.mlp_norm, cfg.norm_eps).to(cd)
    return x + L.mlp_block(lp.mlp, h, cfg)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Zeroed KV cache; gemma2's split layout when the config asks for it.

    The split cache keeps only a sliding-window ring buffer for the local
    (even) layers: ``min(sliding_window, max_len)`` slots instead of
    ``max_len``.
    """
    dev = checked_device(device, "init_cache")
    kv, hd = cfg.n_kv, cfg.head_dim
    if cfg.local_global and cfg.local_global_split_cache \
            and cfg.n_layers % 2 == 0:
        half = cfg.n_layers // 2
        wlen = min(cfg.sliding_window, max_len)
        local = (half, batch, wlen, kv, hd)
        full = (half, batch, max_len, kv, hd)
        return {"k_local": torch.zeros(local, dtype=dtype, device=dev),
                "v_local": torch.zeros(local, dtype=dtype, device=dev),
                "k": torch.zeros(full, dtype=dtype, device=dev),
                "v": torch.zeros(full, dtype=dtype, device=dev)}
    shape = (cfg.n_layers, batch, max_len, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}
