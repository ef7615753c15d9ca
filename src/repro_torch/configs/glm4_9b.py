"""GLM4-9B: RoPE, GQA kv=2 [hf:THUDM/glm-4-9b]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv=2,
    d_ff=13696,
    vocab=151552,
    notes="full attention; long_500k skipped (quadratic)",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=96,
    vocab=512, attn_chunk=64,
)
