"""Granite-34B-Code: llama-arch MQA (kv=1) [arXiv:2405.04324; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv=1,                 # MQA
    d_ff=24576,
    vocab=49152,
    notes="MQA decode is KV-bandwidth-light; long_500k skipped (quadratic)",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv=1, d_head=16, d_ff=128,
    vocab=512, attn_chunk=64,
)
