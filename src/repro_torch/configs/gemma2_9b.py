"""Gemma2-9B: local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv=8,
    d_head=256,
    d_ff=14336,
    vocab=256000,
    local_global=True,
    sliding_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    notes=("alternating local/global; global layers quadratic ⇒ long_500k "
           "skipped; local layers expressible as Libra block-sparse masks"),
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=128,
    vocab=512, sliding_window=32, attn_chunk=64,
)
