"""Whisper-tiny backbone as an ``nn.Module``: encoder-decoder transformer.

Mirrors ``repro.models.whisper``. The conv/mel frontend is a stub, as in
the reference: callers pass frame embeddings (B, n_audio_ctx, d_model).
The encoder adds a sinusoidal position table and runs non-causal
self-attention; the decoder runs causal self-attention with RoPE, then
cross attention over the encoder's output, whose K/V are computed once
(:meth:`Whisper.enc_kv`). Every attention of :meth:`Whisper.forward`
runs K5 (``layers.flash_attention``): the encoder's and the cross
attention non-causal (Sq ≠ Sk for the cross attention), the decoder's
self-attention causal. Decoding runs the plain
``layers.decode_attention`` for both, with the cross K/V held in the
cache (``xk``/``xv``), as the reference does.

Encoder layers are :class:`~repro_torch.models.transformer.Layer`
(``attn_norm``, ``attn``, ``mlp_norm``, ``mlp``); decoder layers
(:class:`DecoderLayer`) add ``xattn_norm`` and ``xattn``. With
``cfg.remat`` and grad enabled each decoder layer runs under
``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` over a
decoder layer: the cross attention is recomputed inside it, the cross
K/V (``enc_kv``) stay outside as its inputs, and the encoder runs
without.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.api import checked_device
from repro_torch.dist import sharding as sh
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import Layer


def _sinusoid(n: int, d: int) -> np.ndarray:
    """(n, d) fp32 position table: sin on even columns, cos on odd."""
    pos = np.arange(n)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / np.power(10000.0, dim / d)
    out = np.zeros((n, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


class DecoderLayer(Layer):
    """Self-attention, cross attention and MLP parameters."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator | None,
                 device):
        super().__init__(cfg, gen, device)
        self.xattn_norm = nn.Parameter(L.init_norm(cfg, device))
        self.xattn = nn.ParameterDict(L.init_attention(gen, cfg, device))


class Whisper(nn.Module):
    """Encoder-decoder LM over stubbed frame embeddings.

    Args:
      cfg: an ``audio`` :class:`ArchConfig`.
      generator: draws every weight (on the generator's device, then
        moved to ``device``); ``None`` allocates them uninitialised for
        :func:`repro_torch.models.convert.whisper_params_from_jax`.
      device: where the parameters live; ``"cuda"`` (the default) needs a
        card and raises without one.
    """

    def __init__(self, cfg: ArchConfig, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        if cfg.family != "audio":
            raise NotImplementedError(
                f"Whisper is the audio family; got {cfg.family!r}")
        dev = checked_device(device, "Whisper")
        self.cfg = cfg
        self.embedding = nn.Parameter(L.init_embedding(generator, cfg, dev))
        self.enc_layers = nn.ModuleList(
            Layer(cfg, generator, dev)
            for _ in range(cfg.n_enc_layers or cfg.n_layers))
        self.enc_norm = nn.Parameter(L.init_norm(cfg, dev))
        self.dec_layers = nn.ModuleList(DecoderLayer(cfg, generator, dev)
                                        for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(L.init_norm(cfg, dev))

    def encode(self, frame_embeds: torch.Tensor) -> torch.Tensor:
        """frame_embeds: (B, Sa, D), the stubbed frontend's output →
        encoder states (B, Sa, D) in ``compute_dtype``."""
        cfg = self.cfg
        cd = L.dtype_of(cfg, "compute_dtype")
        table = torch.from_numpy(_sinusoid(frame_embeds.shape[1],
                                           cfg.d_model))
        x = frame_embeds.to(cd) + table.to(frame_embeds.device, cd)[None]
        for lp in self.enc_layers:
            h = L.rms_norm(x, lp.attn_norm, cfg.norm_eps)
            q, k, v = L.qkv_project(lp.attn, h, cfg)
            o = L.flash_attention(q, k, v, causal=False,
                                  chunk=cfg.attn_chunk)
            x = x + o.reshape(*x.shape[:2], -1) @ lp.attn["wo"].to(cd)
            h = L.rms_norm(x, lp.mlp_norm, cfg.norm_eps)
            x = x + L.mlp_block(lp.mlp, h, cfg)
        return L.rms_norm(x, self.enc_norm, cfg.norm_eps)

    def enc_kv(self, enc_out: torch.Tensor):
        """Each decoder layer's cross K and V, computed once: two tensors
        (n_layers, B, Sa, KV, hd)."""
        cfg = self.cfg
        b, sa, _ = enc_out.shape
        cd = L.dtype_of(cfg, "compute_dtype")
        shape = (b, sa, cfg.n_kv, cfg.head_dim)
        xk = torch.stack([(enc_out @ lp.xattn["wk"].to(cd)).reshape(shape)
                          for lp in self.dec_layers])
        xv = torch.stack([(enc_out @ lp.xattn["wv"].to(cd)).reshape(shape)
                          for lp in self.dec_layers])
        return xk, xv

    def _cross_attention(self, p, x, k, v):
        """x: (B, Sd, D) queries against the encoder's k, v (B, Sa, KV,
        hd) through K5, non-causal."""
        cfg = self.cfg
        b, s, _ = x.shape
        cd = L.dtype_of(cfg, "compute_dtype")
        q = (x @ p["wq"].to(cd)).reshape(b, s, cfg.n_heads, cfg.head_dim)
        out = L.flash_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
        return out.reshape(b, s, -1) @ p["wo"].to(cd)

    def _dec_layer(self, lp, ek, ev, x):
        """One decoder layer: causal self-attention, cross attention over
        the encoder's ``ek``, ``ev``, MLP."""
        cfg, s = self.cfg, x.shape[1]
        h = L.rms_norm(x, lp.attn_norm, cfg.norm_eps)
        x = x + L.attention_block(lp.attn, h, cfg, layer_window=s + 1)
        h = L.rms_norm(x, lp.xattn_norm, cfg.norm_eps)
        x = x + self._cross_attention(lp.xattn, h, ek, ev)
        h = L.rms_norm(x, lp.mlp_norm, cfg.norm_eps)
        return x + L.mlp_block(lp.mlp, h, cfg)

    def forward(self, tokens: torch.Tensor, *,
                frame_embeds: torch.Tensor) -> torch.Tensor:
        """Teacher-forced forward: logits (B, Sd, vocab) in fp32 over the
        decoder positions."""
        cfg = self.cfg
        xk, xv = self.enc_kv(self.encode(frame_embeds))
        x = L.embed(self.embedding, tokens, cfg)
        remat = cfg.remat and torch.is_grad_enabled()
        for lp, ek, ev in zip(self.dec_layers, xk, xv):
            if remat:
                # The layer draws no random numbers: no RNG state to keep.
                x = checkpoint(self._dec_layer, lp, ek, ev, x,
                               use_reentrant=False, preserve_rng_state=False,
                               context_fn=sh.remat_context)
            else:
                x = self._dec_layer(lp, ek, ev, x)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        return L.unembed(self.embedding, x, cfg)

    def decode_step(self, cache: dict, token: torch.Tensor, cache_len: int):
        """One decoder token; the cross K/V come from ``cache["xk"]`` and
        ``cache["xv"]``. Returns (logits, cache), updated in place."""
        cfg = self.cfg
        cd = L.dtype_of(cfg, "compute_dtype")
        cache_len = int(cache_len)
        x = L.embed(self.embedding, token, cfg)
        b = x.shape[0]
        pos = torch.full((b, 1), cache_len - 1, dtype=torch.int32,
                         device=x.device)
        for i, lp in enumerate(self.dec_layers):
            kc, vc = cache["k"][i], cache["v"][i]
            h = L.rms_norm(x, lp.attn_norm, cfg.norm_eps)
            q, k, v = L.qkv_project(lp.attn, h, cfg)
            q = L.apply_rope(q, pos, cfg.rope_theta)
            k = L.apply_rope(k, pos, cfg.rope_theta)
            kc[:, cache_len - 1] = k[:, 0].to(kc.dtype)
            vc[:, cache_len - 1] = v[:, 0].to(vc.dtype)
            o = L.decode_attention(q, kc, vc, cache_len)
            x = x + o.reshape(b, 1, -1) @ lp.attn["wo"].to(cd)
            # Cross attention: non-causal, the whole audio context.
            h = L.rms_norm(x, lp.xattn_norm, cfg.norm_eps)
            qx = (h @ lp.xattn["wq"].to(cd)).reshape(b, 1, cfg.n_heads,
                                                     cfg.head_dim)
            xk, xv = cache["xk"][i], cache["xv"][i]
            ox = L.decode_attention(qx, xk, xv, xk.shape[1])
            x = x + ox.reshape(b, 1, -1) @ lp.xattn["wo"].to(cd)
            h = L.rms_norm(x, lp.mlp_norm, cfg.norm_eps)
            x = x + L.mlp_block(lp.mlp, h, cfg)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        return L.unembed(self.embedding, x, cfg), cache


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda",
               n_audio: int | None = None) -> dict:
    """Zeroed self-attention K/V (``max_len`` slots) and cross K/V
    (``n_audio`` or ``n_audio_ctx`` frames) for every decoder layer."""
    dev = checked_device(device, "init_cache")
    kv, hd, ld = cfg.n_kv, cfg.head_dim, cfg.n_layers
    sa = n_audio or cfg.n_audio_ctx

    def zeros(s):
        return torch.zeros((ld, batch, s, kv, hd), dtype=dtype, device=dev)

    return {"k": zeros(max_len), "v": zeros(max_len), "xk": zeros(sa),
            "xv": zeros(sa)}
