"""Whisper-tiny backbone: enc-dec, conv frontend stubbed
[arXiv:2212.04356]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv=6,
    d_ff=1536,
    vocab=51865,
    enc_dec=True,
    n_audio_ctx=1500,
    dp_only=True,  # 384-d/6-head backbone: nothing divides a 16-wide TP axis
    replicate_params=True,  # 37M params: replicate, no FSDP gathers

    notes=("frontend (mel+conv) is a stub: input_specs provides frame "
           "embeddings; decode shapes lower the decoder with cross-attn; "
           "long_500k skipped (quadratic decoder)"),
)

SMOKE = CONFIG.scaled(
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv=4, d_head=16,
    d_ff=128, vocab=512, n_audio_ctx=32, attn_chunk=64,
)
