"""Unified architecture config covering all assigned model families."""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "audio", "vlm", "ssm", "hybrid"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    vocab: int
    # --- attention ---
    n_heads: int = 0
    n_kv: int = 0
    d_head: int = 0                  # 0 ⇒ d_model // n_heads
    d_ff: int = 0
    rope_theta: float = 10_000.0
    local_global: bool = False       # gemma2: alternate sliding/global layers
    sliding_window: int = 4096
    attn_softcap: float = 0.0        # gemma2: 50.0
    logit_softcap: float = 0.0       # gemma2: 30.0
    mrope: bool = False              # qwen2-vl M-RoPE (3 rotary sections)
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_dispatch: str = "local"  # "local" (grouped, EP all-to-all) or
    #                              "global_sort" (§Perf baseline)
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid (zamba2): one shared attention block every k mamba layers ---
    hybrid_attn_every: int = 6
    # --- enc-dec (whisper) ---
    enc_dec: bool = False
    n_audio_ctx: int = 1500
    n_enc_layers: int = 0
    # --- vlm ---
    n_patches: int = 0               # stub frontend: precomputed patch embeds
    # --- numerics / runtime ---
    dp_only: bool = False        # batch over all mesh axes (no TP) — small models
    replicate_params: bool = False   # keep params whole per device (tiny models)
    local_global_split_cache: bool = True  # ring cache for local layers
    vocab_pad_to: int = 128      # Megatron-style padded vocab (shardable)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    remat: bool = True
    serve_sample: bool = False       # serve_step returns sampled tokens
    #   instead of logits (skips the vocab all-gather — §Perf Cell 3)
    attn_chunk: int = 1024           # flash-attention KV chunk
    flash_remat: bool = True         # recompute chunk scores in backward
    #   (False stores every chunk's score tensor — §Perf baseline)
    # roofline bookkeeping
    notes: str = ""

    @property
    def vocab_padded(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab + p - 1) // p * p

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def scaled(self, **kw) -> "ArchConfig":
        """Reduced config of the same family (smoke tests)."""
        return dataclasses.replace(self, **kw)

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k shape (sub-quadratic sequence cost)."""
        return self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned (shape) cell: training or serving geometry."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
