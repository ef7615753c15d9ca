"""Shared transformer layers in PyTorch: norms, RoPE/M-RoPE, attention,
MLPs.

Mirrors ``repro.models.layers`` function for function, with the same
rounding points: activations in ``compute_dtype``, weights cast per use
from ``param_dtype``, norms and softmax statistics in fp32. Parameters
are mappings of tensors (the ``nn.ParameterDict``s of
:mod:`repro_torch.models.transformer`); every ``init_*`` draws from an
explicit :class:`torch.Generator` on that generator's device and places
the result on ``device``.

Inside :func:`repro_torch.dist.sharding.activation_context`,
:func:`flash_attention` repeats K and V as the reference does
(``sh.kv_repeat_for_tp``) when the model axis does not divide the KV
heads, so K5 runs at the repeated head count (gemma2-9b's 16/8 at 16/16
on a model axis of 16); outside a context nothing changes. The
reference's ``sh.constrain`` calls place tensors and change no value;
one process computes on whole tensors, so they are left out.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as sh
from repro_torch.kernels.flash_attention import (
    flash_attention_fused,
    flash_attention_grad,
)
from repro_torch.models.config import ArchConfig


def dtype_of(cfg: ArchConfig, which: str) -> torch.dtype:
    return getattr(torch, getattr(cfg, which))


def rms_norm(x, scale, eps):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def softcap(x, cap: float):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ----------------------------------------------------------------- RoPE ---
def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    # The reference rounds the frequencies to x's type first.
    freqs = torch.tensor(rope_freqs(d, theta), dtype=x.dtype,
                         device=x.device).float()
    ang = positions[..., None].float() * freqs            # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)        # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_mrope(x, positions3, theta: float, sections):
    """Qwen2-VL M-RoPE: the rotary frequencies split into (t, h, w)
    sections, each rotated by its own position stream.

    x: (..., S, H, D); positions3: (3, ..., S). Unlike :func:`apply_rope`
    the reference keeps the frequencies in fp32 (no rounding to x's
    type); cos and sin are cast to x's type.
    """
    d = x.shape[-1]
    half = d // 2
    freqs = torch.tensor(rope_freqs(d, theta), dtype=torch.float32,
                         device=x.device)
    # Section id of each rotary frequency index.
    sec = np.zeros(half, np.int64)
    start = 0
    for si, width in enumerate(np.asarray(sections) * half
                               // int(np.sum(sections))):
        sec[start:start + width] = si
        start += width
    sec[start:] = len(sections) - 1
    pos = positions3[torch.tensor(sec, device=positions3.device)]
    ang = pos.movedim(0, -1).float() * freqs              # (..., S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ------------------------------------------------------ flash attention ---
def flash_attention(q, k, v, *, causal: bool, window=None,
                    softcap_val: float = 0.0, chunk: int = 1024,
                    q_offset: int = 0, remat_chunks: bool = True):
    """Attention with an online softmax: K5 on the card, its plain twin
    on CPU tensors.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D) with H % KV == 0. ``window``
    restricts keys to within ``window`` of the query; ``None`` disables it
    (the reference's ``Sk + Sq + 1``). ``q_offset`` is the absolute
    position of q[0]. When grad is enabled and an input requires it, the
    call goes through the autograd Function (K5's forward with its
    logsumexp, and a backward that walks ``chunk`` keys a step, as the
    reference's scan does); otherwise K5 runs alone. ``remat_chunks``
    decides whether the reference's backward stores or recomputes each
    chunk's scores; the Function always recomputes them from the saved
    logsumexp, so it has no effect here. Inside a sharding context whose
    model axis does not divide the KV heads, K and V are repeated first
    (``sh.kv_repeat_for_tp``), as the reference repeats them.
    """
    del remat_chunks
    rep = sh.kv_repeat_for_tp(k.shape[2], q.shape[2])
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    sq, sk = q.shape[1], k.shape[1]
    window = sk + sq + 1 if window is None else int(window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_attention_grad(q, k, v, causal=causal, window=window,
                                    softcap=softcap_val, q_offset=q_offset,
                                    chunk=chunk)
    return flash_attention_fused(q, k, v, causal=causal, window=window,
                                 softcap=softcap_val, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, cache_len: int, *, window=None,
                     softcap_val: float = 0.0):
    """Single-token attention against a KV cache (plain PyTorch, as the
    reference computes it outside any kernel).

    q: (B, 1, H, D); caches: (B, S, KV, D); cache_len: valid length (the
    new token is at index cache_len - 1).
    """
    b, _, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    qh = q.reshape(b, kv, g, d).float()
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bkgd,bskd->bkgs", qh, k_cache.float()) * scale
    scores = softcap(scores, softcap_val)
    pos = torch.arange(s, device=q.device)
    if window is None:
        window = s + 1
    last = cache_len - 1
    valid = (pos <= last) & (pos > last - window)
    scores = torch.where(valid, scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


# ------------------------------------------------------------- attention --
def _normal(gen, shape, std, dtype, device):
    """N(0, std²) drawn in fp32 by ``gen`` on its device, cast to ``dtype``
    on ``device``; ``gen=None`` leaves the tensor uninitialised (for
    values loaded afterwards)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return t.normal_(generator=gen).mul_(std).to(device=device, dtype=dtype)


def init_attention(gen: torch.Generator | None, cfg: ArchConfig,
                   device) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    pd = dtype_of(cfg, "param_dtype")
    sc = 1.0 / math.sqrt(d)
    return {
        "wq": _normal(gen, (d, h * hd), sc, pd, device),
        "wk": _normal(gen, (d, kv * hd), sc, pd, device),
        "wv": _normal(gen, (d, kv * hd), sc, pd, device),
        "wo": _normal(gen, (h * hd, d), 1.0 / math.sqrt(h * hd), pd, device),
    }


def qkv_project(p, x, cfg: ArchConfig):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    cd = dtype_of(cfg, "compute_dtype")
    q = (x @ p["wq"].to(cd)).reshape(b, s, h, hd)
    k = (x @ p["wk"].to(cd)).reshape(b, s, kv, hd)
    v = (x @ p["wv"].to(cd)).reshape(b, s, kv, hd)
    return q, k, v


def attention_block(p, x, cfg: ArchConfig, *, layer_window: int = 0,
                    positions=None, positions3=None):
    """Full self-attention block (projections + rope + K5 + output); with
    ``cfg.mrope`` and ``positions3`` (3, B, S), M-RoPE instead of RoPE."""
    b, s, _ = x.shape
    q, k, v = qkv_project(p, x, cfg)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    if cfg.mrope and positions3 is not None:
        q = apply_mrope(q, positions3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions3, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_attention(q, k, v, causal=True, window=layer_window,
                          softcap_val=cfg.attn_softcap, chunk=cfg.attn_chunk,
                          remat_chunks=cfg.flash_remat)
    cd = dtype_of(cfg, "compute_dtype")
    return out.reshape(b, s, -1) @ p["wo"].to(cd)


# ------------------------------------------------------------------ MLP ---
def init_mlp(gen: torch.Generator | None, cfg: ArchConfig, device,
             d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    pd = dtype_of(cfg, "param_dtype")
    return {
        "wi_gate": _normal(gen, (d, f), 1.0 / math.sqrt(d), pd, device),
        "wi_up": _normal(gen, (d, f), 1.0 / math.sqrt(d), pd, device),
        "wo": _normal(gen, (f, d), 1.0 / math.sqrt(f), pd, device),
    }


def mlp_block(p, x, cfg: ArchConfig):
    cd = dtype_of(cfg, "compute_dtype")
    g = F.silu(x @ p["wi_gate"].to(cd))
    u = x @ p["wi_up"].to(cd)
    return (g * u) @ p["wo"].to(cd)


def init_norm(cfg: ArchConfig, device) -> torch.Tensor:
    return torch.zeros((cfg.d_model,), dtype=dtype_of(cfg, "param_dtype"),
                       device=device)


def init_embedding(gen: torch.Generator | None, cfg: ArchConfig,
                   device) -> torch.Tensor:
    return _normal(gen, (cfg.vocab_padded, cfg.d_model),
                   1.0 / math.sqrt(cfg.d_model), dtype_of(cfg, "param_dtype"),
                   device)


def embed(embedding, tokens, cfg: ArchConfig):
    return F.embedding(tokens.long(), embedding).to(
        dtype_of(cfg, "compute_dtype"))


def unembed(embedding, x, cfg: ArchConfig):
    """Logits in fp32 over the true vocabulary, softcapped.

    The softcap is the reference's ``cap * tanh(x / cap)``, the same
    operations in the same order either way. Under ``no_grad`` it runs in
    place on the fp32 logits: at 8192 tokens × 256k vocabulary each
    temporary would be 8.4 GB. Under grad it runs out of place, because
    ``tanh`` saves its output for the backward (in place, the ``mul_``
    would overwrite it); that saved output is the one fp32 copy of the
    logits the loss head keeps.
    """
    cd = dtype_of(cfg, "compute_dtype")
    logits = (x @ embedding.to(cd).T)[..., : cfg.vocab].float()
    cap = cfg.logit_softcap
    if not cap:
        return logits
    if torch.is_grad_enabled() and logits.requires_grad:
        return cap * torch.tanh(logits / cap)
    return logits.div_(cap).tanh_().mul_(cap)
