"""Qwen3-MoE 235B-A22B: 128 experts, top-8 [hf:Qwen/Qwen3 family]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv=4,
    d_head=128,
    d_ff=1536,              # per-expert FFN width
    moe_d_ff=1536,
    vocab=151936,
    n_experts=128,
    top_k=8,
    notes=("dispatch matrix is the paper's extreme-sparse NNZ-1 regime → "
           "Libra routes it to the flexible path (sort-based dispatch); "
           "long_500k skipped (quadratic)"),
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=64,
    moe_d_ff=64, vocab=512, n_experts=8, top_k=2, attn_chunk=64,
)
