"""Train and serve step builders on a mesh.

Mirrors ``repro.train.train_step``. ``make_train_step``: loss → grad →
AdamW, with microbatches: the batch is split on its first axis, the
gradients of the microbatches are accumulated in fp32, the step's loss
is the mean of the microbatch losses (each a masked mean, as the
reference's scan takes it, which is not the masked mean over the whole
batch) and the gradients are divided by ``microbatches``.
``make_serve_step``: one-token decode against the cache, returning the
argmax tokens for a ``serve_sample`` config.

With a mesh, each step runs inside
:func:`repro_torch.dist.sharding.activation_context` and leaves it on
every exit, an exception included (the reference's train step leaves it
entered when tracing raises). One process computes on whole tensors, so
the mesh changes the arithmetic only where the reference's does: the
KV repeat before attention and the MoE block's token groups and
expert-parallel exchange. ``shardings_for_train`` and
``shardings_for_serve`` give the reference's shardings for every input
and output; a train step gathers :class:`~repro_torch.dist.sharding.Placed`
inputs (no copy where every block is a view, as on the launchers'
meshes, ``launch.train.mesh_on``) and writes the updated optimizer
state back (:func:`~repro_torch.dist.sharding.refresh_`).

The model's parameters and the optimizer state update in place. The
gradients accumulate in the parameters' ``.grad`` (fp32 parameters: the
accumulator is ``.grad`` itself, so no second copy of the gradients is
held) and are released after the update.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.dist import sharding as sh
from repro_torch.models import api
from repro_torch.models.config import ArchConfig
from repro_torch.train import optimizer as opt


def _context(cfg: ArchConfig, mesh):
    if mesh is None:
        return contextlib.nullcontext()
    return sh.activation_context(mesh, sh.dp_only_of(cfg))


def make_train_step(cfg: ArchConfig, opt_cfg: opt.OptConfig, mesh=None,
                    microbatches: int = 1):
    """Returns ``train_step(model, opt_state, batch) -> metrics``: one
    update of ``model`` and ``opt_state`` in place; ``metrics`` holds
    ``loss``, ``grad_norm`` and ``lr`` as float32 scalar tensors.
    ``opt_state`` and ``batch`` may be placed trees
    (:func:`repro_torch.dist.sharding.device_put`)."""

    def train_step(model, opt_state: dict, batch: dict) -> dict:
        params = dict(model.named_parameters())
        dev = next(iter(params.values())).device
        state = sh.gather(opt_state, dev)
        batch = sh.gather(batch, dev)
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
        with _context(cfg, mesh), torch.enable_grad():
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
        metrics = opt.apply_updates(params, grads, state, opt_cfg)
        for p in params.values():
            p.grad = None
        sh.refresh_(opt_state, state)
        metrics["loss"] = loss
        return metrics

    return train_step


def shardings_for_train(mesh, params, opt_state, batch_like,
                        replicate_params=False):
    """``((params, opt_state, batch), (params, opt_state, metrics))``
    shardings, as the reference's. ``params`` is a module or a mapping of
    its parameters; the moments follow the parameters' rules."""
    p_sh = sh.param_shardings(mesh, params, replicate=replicate_params)
    repl = sh.NamedSharding(mesh, sh.P())
    o_sh = {
        "mu": sh.param_shardings(mesh, opt_state["mu"],
                                 replicate=replicate_params),
        "nu": sh.param_shardings(mesh, opt_state["nu"],
                                 replicate=replicate_params),
        "step": repl,
    }
    b_sh = sh.batch_shardings(mesh, batch_like)
    metric_sh = {"grad_norm": repl, "lr": repl, "loss": repl}
    return (p_sh, o_sh, b_sh), (p_sh, o_sh, metric_sh)


def make_serve_step(cfg: ArchConfig, mesh=None):
    """Returns ``serve_step(model, cache, token, cache_len) -> (out,
    cache)``: the logits (B, 1, vocab), or for a ``serve_sample`` config
    their argmax (B, 1) as int32; the cache updates in place."""

    def serve_step(model, cache, token, cache_len):
        with _context(cfg, mesh):
            logits, cache2 = api.decode_step(model, cache, token,
                                             int(cache_len), cfg)
            if cfg.serve_sample:
                return torch.argmax(logits, dim=-1).to(torch.int32), cache2
        return logits, cache2

    return serve_step


def shardings_for_serve(mesh, params, cache, token_like, sample=False,
                        replicate_params=False):
    """``((params, cache, token, cache_len), (out, cache))`` shardings,
    as the reference's."""
    p_sh = sh.param_shardings(mesh, params, replicate=replicate_params)
    c_sh = sh.cache_shardings(mesh, cache)
    t_sh = sh.NamedSharding(mesh, sh.sanitize_spec(
        sh.batch_spec(mesh, 2), tuple(token_like.shape), mesh))
    len_sh = sh.NamedSharding(mesh, sh.P())
    out_sh = t_sh if sample else sh.NamedSharding(mesh, sh.sanitize_spec(
        sh.batch_spec(mesh, 3), (token_like.shape[0], 1, 1 << 30), mesh))
    return (p_sh, c_sh, t_sh, len_sh), (out_sh, c_sh)
