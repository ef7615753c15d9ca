"""Analytic parameter / MODEL_FLOPS accounting per architecture.

MODEL_FLOPS follows the assignment's definition: 6·N·D for training
(N = params, D = tokens) and 6·N_active·D for MoE; serve steps use
2·N_active per generated token (forward only). Embedding parameters are
included in N (they participate in the matmuls at both ends).

The port's own copy of ``repro.launch.flops``: pure arithmetic over
:class:`~repro_torch.models.config.ArchConfig`, for every family.
"""
from __future__ import annotations

from repro_torch.models.config import ArchConfig, InputShape


def _attn_params(cfg: ArchConfig) -> int:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    return d * h * hd + 2 * d * kv * hd + h * hd * d


def _mlp_params(d: int, f: int) -> int:
    return 3 * d * f


def _mamba_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    d_in = cfg.ssm_d_inner
    n = cfg.ssm_state
    h = cfg.ssm_n_heads
    conv_dim = d_in + 2 * n
    return (d * (2 * d_in + 2 * n + h)      # in_proj
            + conv_dim * cfg.ssm_conv       # conv
            + d_in * d                      # out_proj
            + 3 * h + d_in)                 # A, D, dt_bias, gate norm


def count_params(cfg: ArchConfig) -> tuple[int, int]:
    """Returns (total, active-per-token)."""
    emb = cfg.vocab * cfg.d_model
    d = cfg.d_model
    if cfg.family in ("dense", "vlm"):
        layer = _attn_params(cfg) + _mlp_params(d, cfg.d_ff)
        total = emb + cfg.n_layers * layer
        return total, total
    if cfg.family == "moe":
        f = cfg.moe_d_ff or cfg.d_ff
        attn = _attn_params(cfg)
        router = d * cfg.n_experts
        shared = _mlp_params(d, cfg.n_shared_experts * f) \
            if cfg.n_shared_experts else 0
        total = emb + cfg.n_layers * (
            attn + router + cfg.n_experts * _mlp_params(d, f) + shared)
        active = emb + cfg.n_layers * (
            attn + router + cfg.top_k * _mlp_params(d, f) + shared)
        return total, active
    if cfg.family == "ssm":
        total = emb + cfg.n_layers * _mamba_params(cfg)
        return total, total
    if cfg.family == "hybrid":
        shared_blk = _attn_params(cfg) + _mlp_params(d, cfg.d_ff)
        total = emb + cfg.n_layers * _mamba_params(cfg) + shared_blk
        # shared block params are *executed* once per application:
        n_app = cfg.n_layers // cfg.hybrid_attn_every
        active = emb + cfg.n_layers * _mamba_params(cfg) + n_app * shared_blk
        return total, active
    if cfg.family == "audio":
        enc_layer = _attn_params(cfg) + _mlp_params(d, cfg.d_ff)
        dec_layer = 2 * _attn_params(cfg) + _mlp_params(d, cfg.d_ff)
        n_enc = cfg.n_enc_layers or cfg.n_layers
        total = emb + n_enc * enc_layer + cfg.n_layers * dec_layer
        return total, total
    raise ValueError(cfg.family)


def model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """Global MODEL_FLOPS of one step of the given kind."""
    total, active = count_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    # decode: one token per sequence
    return 2.0 * active * shape.global_batch
