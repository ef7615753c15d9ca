"""Mamba2-130M: SSD, attention-free [arXiv:2405.21060]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,              # attention-free
    n_kv=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    dp_only=True,  # 24 SSD heads don't divide a 16-wide TP axis; 130M params
    replicate_params=True,  # 515 MB f32: kill per-layer FSDP gathers (§Perf)
    serve_sample=True,      # distributed greedy sampling (§Perf Cell 3)
    notes=("Libra technique inapplicable to the SSD scan (no unstructured "
           "sparse operand) — arch runs WITHOUT it, see DESIGN.md "
           "§Arch-applicability; linear-time ⇒ long_500k RUNS"),
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, vocab=512, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=32,
)
