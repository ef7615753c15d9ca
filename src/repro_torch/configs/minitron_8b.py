"""Minitron-8B (pruned Nemotron) [arXiv:2407.14679; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,                 # GQA
    d_ff=16384,
    vocab=256000,
    notes="full attention; long_500k skipped (quadratic)",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=128,
    vocab=512, attn_chunk=64,
)
