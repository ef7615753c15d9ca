"""Family-dispatching model API: init / forward / loss / cache / decode.

Mirrors ``repro.models.api`` for the ``dense`` family. The other
families raise :class:`NotImplementedError` naming their ROADMAP item.
``params`` is the :class:`~repro_torch.models.transformer.Transformer`
module itself. The input specs are tensors on the ``meta`` device, the
counterpart of the reference's ``jax.ShapeDtypeStruct``: shapes and
dtypes, no storage.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig, InputShape

_UNPORTED = {
    "moe": "ROADMAP queue 1 item 13 (moe.py)",
    "ssm": "ROADMAP queue 1 item 13 (mamba2.py)",
    "hybrid": "ROADMAP queue 1 item 13 (hybrid.py)",
    "audio": "ROADMAP queue 1 item 13 (whisper.py)",
    "vlm": "ROADMAP queue 1 item 13 (VLM frontend, M-RoPE)",
}


def _dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"{_UNPORTED.get(cfg.family, 'ROADMAP queue 1 item 13')}")


def init_params(generator: torch.Generator, cfg: ArchConfig, *,
                device="cuda") -> transformer.Transformer:
    """A model whose weights ``generator`` draws (on its own device)."""
    _dense(cfg)
    return transformer.Transformer(cfg, generator=generator, device=device)


def forward_logits(params: transformer.Transformer, batch: dict,
                   cfg: ArchConfig):
    """Returns (logits, aux_loss)."""
    _dense(cfg)
    return params(batch["tokens"]), 0.0


def loss_fn(params: transformer.Transformer, batch: dict, cfg: ArchConfig):
    """Next-token cross-entropy over labels >= 0."""
    logits, aux = forward_logits(params, batch, cfg)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + cfg.router_aux_coef * aux


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    _dense(cfg)
    return transformer.init_cache(cfg, batch, max_len, dtype, device)


def decode_step(params: transformer.Transformer, cache: dict, token,
                cache_len: int, cfg: ArchConfig):
    """One-token decode: (logits, cache); the cache updates in place."""
    _dense(cfg)
    return params.decode_step(cache, token, cache_len)


# ------------------------------------------------------------ input specs --
def _spec(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Meta-tensor stand-ins for one global train/prefill batch."""
    _dense(cfg)
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": _spec((b, s)), "labels": _spec((b, s))}


def decode_input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Stand-ins for one decode step with a cache of seq_len history."""
    _dense(cfg)
    b, s = shape.global_batch, shape.seq_len
    return {"token": _spec((b, 1)), "cache_len": _spec(()),
            "cache": init_cache(cfg, b, s, dtype=torch.bfloat16,
                                device="meta")}
