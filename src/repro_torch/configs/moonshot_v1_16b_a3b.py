"""Moonshot/Moonlight-16B-A3B: 64 experts, top-6, 2 shared
[hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv=16,                # MHA (kv == heads)
    d_ff=1408,
    moe_d_ff=1408,
    vocab=163840,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    notes="long_500k skipped (quadratic)",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_head=16, d_ff=64,
    moe_d_ff=64, vocab=512, n_experts=8, top_k=2, n_shared_experts=1,
    attn_chunk=64,
)
