"""Zamba2-7B: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,            # mamba2 layers; shared attn applied every 6
    d_model=3584,
    n_heads=32,
    n_kv=32,
    d_ff=14336,             # shared block MLP
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    hybrid_attn_every=6,
    sliding_window=4096,    # shared attn window ⇒ sub-quadratic
    notes="sliding-window shared attention ⇒ long_500k RUNS",
)

SMOKE = CONFIG.scaled(
    n_layers=5, d_model=64, n_heads=4, n_kv=4, d_head=16, d_ff=128,
    vocab=512, ssm_state=16, ssm_head_dim=16, ssm_chunk=32,
    hybrid_attn_every=2, sliding_window=64, attn_chunk=64,
)
