"""Qwen2-VL-7B backbone: M-RoPE, dynamic-resolution frontend stubbed
[arXiv:2409.12191; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv=4,
    d_ff=18944,
    vocab=152064,
    mrope=True,
    mrope_sections=(16, 24, 24),
    n_patches=1024,          # stub frontend: precomputed patch embeddings
    notes="patch frontend is a stub per spec; long_500k skipped (quadratic)",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=128,
    vocab=512, n_patches=16, attn_chunk=64,
)
