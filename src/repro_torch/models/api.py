"""Family-dispatching model API: init / forward / loss / cache / decode.

Mirrors ``repro.models.api`` for every family: ``dense`` and ``vlm``
(:class:`~repro_torch.models.transformer.Transformer`), ``moe``
(:class:`~repro_torch.models.moe.MoETransformer`), ``ssm``
(:class:`~repro_torch.models.mamba2.Mamba2LM`), ``hybrid``
(:class:`~repro_torch.models.hybrid.HybridLM`) and ``audio``
(:class:`~repro_torch.models.whisper.Whisper`). ``params`` is the model
module itself. The input specs are tensors on the ``meta`` device, the
counterpart of the reference's ``jax.ShapeDtypeStruct``: shapes and
dtypes, no storage.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import hybrid, mamba2, moe, transformer, whisper
from repro_torch.models.config import ArchConfig, InputShape

_MODELS = {"dense": transformer.Transformer, "vlm": transformer.Transformer,
           "moe": moe.MoETransformer, "ssm": mamba2.Mamba2LM,
           "hybrid": hybrid.HybridLM, "audio": whisper.Whisper}


def init_params(generator: torch.Generator, cfg: ArchConfig, *,
                device="cuda") -> nn.Module:
    """A model whose weights ``generator`` draws (on its own device)."""
    return _MODELS[cfg.family](cfg, generator=generator, device=device)


def forward_logits(params: nn.Module, batch: dict, cfg: ArchConfig):
    """Returns (logits, aux_loss); every family but MoE has aux 0.0.
    ``batch`` carries ``frame_embeds`` for the audio family and may carry
    ``patch_embeds`` for the VLM family."""
    tokens = batch["tokens"]
    if cfg.family == "moe":
        return params(tokens)
    if cfg.family == "audio":
        return params(tokens, frame_embeds=batch["frame_embeds"]), 0.0
    if cfg.family == "vlm":
        return params(tokens, patch_embeds=batch.get("patch_embeds")), 0.0
    return params(tokens), 0.0


def loss_fn(params: nn.Module, batch: dict, cfg: ArchConfig):
    """Next-token cross-entropy over labels >= 0, plus
    ``router_aux_coef`` times the MoE aux loss."""
    logits, aux = forward_logits(params, batch, cfg)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + cfg.router_aux_coef * aux


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Zeroed decode cache of ``cfg``'s family. The MoE family keeps the
    dense layout, as the reference's ``moe.init_cache`` does; the SSM
    family's conv tails stay fp32 whatever ``dtype`` says, because the
    reference's ``api.init_cache`` calls ``mamba2.init_cache`` without
    it."""
    if cfg.family == "ssm":
        return mamba2.init_cache(cfg, batch, max_len, device=device)
    if cfg.family == "hybrid":
        return hybrid.init_cache(cfg, batch, max_len, dtype, device)
    if cfg.family == "audio":
        return whisper.init_cache(cfg, batch, max_len, dtype, device)
    return transformer.init_cache(cfg, batch, max_len, dtype, device)


def decode_step(params: nn.Module, cache: dict, token, cache_len: int,
                cfg: ArchConfig):
    """One-token decode: (logits, cache); the cache updates in place."""
    return params.decode_step(cache, token, cache_len)


# ------------------------------------------------------------ input specs --
def _spec(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Meta-tensor stand-ins for one global train/prefill batch."""
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _spec((b, s)), "labels": _spec((b, s))}
    if cfg.family == "audio":
        specs["frame_embeds"] = _spec((b, cfg.n_audio_ctx, cfg.d_model),
                                      torch.float32)
    if cfg.family == "vlm":
        specs["patch_embeds"] = _spec((b, cfg.n_patches or 256, cfg.d_model),
                                      torch.float32)
    return specs


def decode_input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Stand-ins for one decode step with a cache of seq_len history."""
    b, s = shape.global_batch, shape.seq_len
    return {"token": _spec((b, 1)), "cache_len": _spec(()),
            "cache": init_cache(cfg, b, s, dtype=torch.bfloat16,
                                device="meta")}
