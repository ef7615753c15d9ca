"""The training step: loss → grad → AdamW, with microbatches.

Mirrors ``repro.train.train_step.make_train_step`` on one card: no mesh
and no shardings (``shardings_for_train``, ``make_serve_step`` and
``shardings_for_serve`` are GSPMD placement, ROADMAP item 13d; the
serving step is :mod:`repro_torch.launch.serve`'s). With microbatches
the batch is split on its first axis and the gradients of the
microbatches are accumulated in fp32; the step's loss is the mean of the
microbatch losses (each a masked mean, as the reference's scan takes it,
which is not the masked mean over the whole batch) and the gradients are
divided by ``microbatches``.

The model's parameters and the optimizer state update in place. The
gradients accumulate in the parameters' ``.grad`` (fp32 parameters: the
accumulator is ``.grad`` itself, so no second copy of the gradients is
held) and are released after the update.
"""
from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.models.config import ArchConfig
from repro_torch.train import optimizer as opt


def make_train_step(cfg: ArchConfig, opt_cfg: opt.OptConfig,
                    microbatches: int = 1):
    """Returns ``train_step(model, opt_state, batch) -> metrics``: one
    update of ``model`` and ``opt_state`` in place; ``metrics`` holds
    ``loss``, ``grad_norm`` and ``lr`` as float32 scalar tensors."""

    def train_step(model, opt_state: dict, batch: dict) -> dict:
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        n = next(iter(batch.values())).shape[0]
        if n % microbatches:
            raise ValueError(f"batch of {n} does not split into "
                             f"{microbatches} microbatches")
        per = n // microbatches
        acc = None
        if microbatches > 1 and any(p.dtype != torch.float32
                                    for p in params.values()):
            acc = {k: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for k, p in params.items()}
        loss_sum = None
        with torch.enable_grad():
            for i in range(microbatches):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                loss = api.loss_fn(model, mb, cfg)
                loss.backward()
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
                if acc is not None:
                    for k, p in params.items():
                        acc[k] += p.grad.float()
                        p.grad = None
        if microbatches == 1:
            grads = {k: p.grad for k, p in params.items()}
        else:
            loss = loss_sum / microbatches
            grads = acc or {k: p.grad for k, p in params.items()}
            for g in grads.values():
                g.div_(microbatches)
        metrics = opt.apply_updates(params, grads, opt_state, opt_cfg)
        for p in params.values():
            p.grad = None
        metrics["loss"] = loss
        return metrics

    return train_step
