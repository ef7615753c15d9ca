"""AdamW + schedule + global-norm clipping over named tensors.

Mirrors ``repro.train.optimizer``: the parameters are a mapping of name
to tensor (``dict(model.named_parameters())``), and the state is
``{"mu", "nu", "step"}`` with ``mu`` and ``nu`` keyed like the
parameters and ``step`` an int32 scalar tensor. The update keeps the
reference's order: the global-norm clip, the bias-corrected step, the
decoupled weight decay added to the update on the reference's matrices
only (layer-stacked vectors included), and the
learning rate ``lr_at(step)`` taken before the step's increment.
``moment_dtype="bfloat16"`` halves the moments' memory.

Unlike the reference's pure functions, :func:`apply_updates` writes the
parameters and the moments in place (no second copy of either on the
card). It walks each tensor in flat slices of :data:`SLICE` elements, so
its temporaries stay a few slices large even for the embedding; the
update is elementwise, so the slices change no result.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

#: Elements of one slice of a tensor that :func:`apply_updates` updates
#: at a time (256 MB of fp32).
SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # "bfloat16" halves optimizer memory


def lr_at(step, cfg: OptConfig):
    """The learning rate at ``step`` (an integer tensor), as a float32
    tensor on its device: linear warm-up, then a cosine down to
    ``min_lr_ratio``."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params: Mapping[str, torch.Tensor],
                   cfg: OptConfig) -> dict:
    md = getattr(torch, cfg.moment_dtype)
    dev = next(iter(params.values())).device
    return {
        "mu": {n: torch.zeros(p.shape, dtype=md, device=p.device)
               for n, p in params.items()},
        "nu": {n: torch.zeros(p.shape, dtype=md, device=p.device)
               for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _slices(t: torch.Tensor):
    flat = t.view(-1)
    for i in range(0, flat.numel(), SLICE):
        yield flat[i:i + SLICE]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over ``tensors`` of their fp32 sums of squares."""
    return torch.sqrt(sum(sum(s.float().square().sum() for s in _slices(t))
                          for t in tensors))


@torch.no_grad()
def apply_updates(params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], state: dict,
                  cfg: OptConfig) -> dict:
    """One AdamW step, in place on ``params`` and ``state``; returns the
    metrics ``{"grad_norm", "lr"}`` (float32 scalar tensors).

    The decay goes on every tensor whose leaf in the reference's tree has
    two dims or more: a layer's 1-D norm scale is a row of the
    reference's ``(n_layers, d)`` leaf, so it decays as that leaf does
    (:func:`repro_torch.models.convert.layout_of` stacks the names)."""
    from repro_torch.models.convert import layout_of

    leaf_ndim = {name: grid.ndim for grid in layout_of(params).values()
                 for name in grid.flat}
    step = state["step"] + 1
    gnorm = global_norm(grads[n] for n in params)
    scale = torch.minimum(torch.ones_like(gnorm),
                          cfg.clip_norm / torch.clamp(gnorm, min=1e-9))
    lr = lr_at(state["step"], cfg)
    stepf = step.float()
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)
    for name, p in params.items():
        # Decoupled weight decay on the reference's matrices only.
        decay = p.ndim + leaf_ndim[name] >= 2
        for ps, gs, ms, vs in zip(_slices(p), _slices(grads[name].detach()),
                                  _slices(state["mu"][name]),
                                  _slices(state["nu"][name])):
            g = gs.float() * scale
            mu = ms.float() * cfg.b1
            mu += (1 - cfg.b1) * g
            nu = vs.float() * cfg.b2
            nu += g.square_().mul_(1 - cfg.b2)
            ms.copy_(mu)
            vs.copy_(nu)
            delta = mu.div_(bc1).div_(nu.div_(bc2).sqrt_().add_(cfg.eps))
            if decay:
                delta += cfg.weight_decay * ps.float()
            ps.copy_(ps.float() - delta.mul_(lr))
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
