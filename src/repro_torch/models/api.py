"""Family-dispatching model API: init / forward / loss / cache / decode.

Mirrors ``repro.models.api`` for the ``dense`` and ``moe`` families. The
other families raise :class:`NotImplementedError` naming their ROADMAP
item. ``params`` is the model module itself
(:class:`~repro_torch.models.transformer.Transformer` or
:class:`~repro_torch.models.moe.MoETransformer`). The input specs are
tensors on the ``meta`` device, the counterpart of the reference's
``jax.ShapeDtypeStruct``: shapes and dtypes, no storage.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import moe, transformer
from repro_torch.models.config import ArchConfig, InputShape

_UNPORTED = {
    "ssm": "ROADMAP queue 1 item 13c (mamba2.py)",
    "hybrid": "ROADMAP queue 1 item 13c (hybrid.py)",
    "audio": "ROADMAP queue 1 item 13c (whisper.py)",
    "vlm": "ROADMAP queue 1 item 13c (VLM frontend, M-RoPE)",
}
_MODELS = {"dense": transformer.Transformer, "moe": moe.MoETransformer}


def _model(cfg: ArchConfig):
    """The model class of ``cfg``'s family."""
    if cfg.family not in _MODELS:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"{_UNPORTED.get(cfg.family, 'ROADMAP queue 1 item 13')}")
    return _MODELS[cfg.family]


def init_params(generator: torch.Generator, cfg: ArchConfig, *,
                device="cuda") -> nn.Module:
    """A model whose weights ``generator`` draws (on its own device)."""
    return _model(cfg)(cfg, generator=generator, device=device)


def forward_logits(params: nn.Module, batch: dict, cfg: ArchConfig):
    """Returns (logits, aux_loss); the dense family's aux is 0.0."""
    _model(cfg)
    out = params(batch["tokens"])
    return out if cfg.family == "moe" else (out, 0.0)


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
    """Zeroed KV cache; the MoE family keeps the dense layout, as the
    reference's ``moe.init_cache`` does."""
    _model(cfg)
    return transformer.init_cache(cfg, batch, max_len, dtype, device)


def decode_step(params: nn.Module, cache: dict, token, cache_len: int,
                cfg: ArchConfig):
    """One-token decode: (logits, cache); the cache updates in place."""
    _model(cfg)
    return params.decode_step(cache, token, cache_len)


# ------------------------------------------------------------ input specs --
def _spec(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Meta-tensor stand-ins for one global train/prefill batch."""
    _model(cfg)
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": _spec((b, s)), "labels": _spec((b, s))}


def decode_input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Stand-ins for one decode step with a cache of seq_len history."""
    b, s = shape.global_batch, shape.seq_len
    return {"token": _spec((b, 1)), "cache_len": _spec(()),
            "cache": init_cache(cfg, b, s, dtype=torch.bfloat16,
                                device="meta")}
