"""Training launcher: the train loop with checkpoint/resume on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \\
        --smoke --steps 20 --batch 8 --seq 128 --ckpt-dir /tmp/ck --resume

The loop of ``repro.launch.train.train_loop``: weights drawn from a
generator seeded with 0 on the device, ``OptConfig`` built as the
reference builds it, batches from :mod:`repro_torch.train.data` (with
zero ``frame_embeds`` for the audio family and zero ``patch_embeds`` for
the VLM, fp32, as the reference adds them), a resume from the newest
valid checkpoint, and a save every ``save_every`` steps and at the end,
keeping the last 3. The mesh is :func:`make_mesh_for` the card count
(``(1, 1)`` with one card or on the CPU), every position on the model's
device (:func:`mesh_on`); the AdamW state is placed by
``shardings_for_train`` and the step runs inside the mesh's sharding
context, as the reference's loop does. The parameters stay in the
module and each batch whole, as the one-process step reads them.
It runs on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.api import checked_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.dist import sharding as sh
from repro_torch.models import api
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts


def make_mesh_for(n_devices: int, *, device="cuda") -> sh.Mesh:
    """A ``(d, n // d)`` ``("data", "model")`` mesh, d the largest divisor
    of ``n_devices`` not above its square root, as the reference factors
    it; positions round robin over the cards unless ``device`` names one
    device for all."""
    d = int(math.sqrt(n_devices))
    while n_devices % d:
        d -= 1
    return sh.make_mesh((d, n_devices // d), ("data", "model"),
                        device=device)


def mesh_on(dev: torch.device) -> sh.Mesh:
    """The launchers' mesh: :func:`make_mesh_for` the card count (one
    position on the CPU), every position on ``dev``. One process computes
    on whole tensors, so every placed block is then a view: spreading the
    positions over cards would only copy blocks back and forth."""
    if dev.type != "cuda":
        return make_mesh_for(1, device=dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return make_mesh_for(torch.cuda.device_count(),
                         device=torch.device("cuda", index))


def train_loop(cfg, steps: int, global_batch: int, seq_len: int,
               ckpt_dir: str | None = None, resume: bool = False,
               microbatches: int = 1, log_every: int = 1,
               save_every: int = 50, host: int = 0, n_hosts: int = 1, *,
               device="cuda"):
    """Train ``steps`` steps (from the checkpoint's step on a resume);
    returns ``(model, losses)``, one loss for each step this call ran."""
    del host  # every host computes the whole global batch on one card
    dev = checked_device(device, "train_loop")
    ocfg = opt_lib.OptConfig(warmup_steps=min(10, steps // 5 + 1),
                             total_steps=steps)
    dcfg = data_lib.DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                               global_batch=global_batch, n_hosts=n_hosts)
    model = api.init_params(torch.Generator(dev).manual_seed(0), cfg,
                            device=dev)
    state = opt_lib.init_opt_state(dict(model.named_parameters()), ocfg)
    start_step = 0
    if resume and ckpt_dir:
        ckpt_lib.clean_tmp(ckpt_dir)
        like = ckpt_lib.train_tree(model, state, leaf=lambda ts_: None)
        restored, at = ckpt_lib.restore_latest(ckpt_dir, like)
        if at >= 0:
            ckpt_lib.load_train_tree(model, state, restored)
            start_step = at
            print(f"[train] resumed from step {at}")

    # The stubbed frontends' outputs, zero as the reference's loop makes
    # them: whisper's frame embeddings, the VLM's patch embeddings.
    extra = {}
    if cfg.family == "audio":
        extra["frame_embeds"] = torch.zeros(
            (global_batch, cfg.n_audio_ctx, cfg.d_model),
            dtype=torch.float32, device=dev)
    if cfg.family == "vlm":
        extra["patch_embeds"] = torch.zeros(
            (global_batch, cfg.n_patches, cfg.d_model),
            dtype=torch.float32, device=dev)

    mesh = mesh_on(dev)
    step_fn = ts.make_train_step(cfg, ocfg, mesh, microbatches=microbatches)

    def batch_at(step):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data_lib.global_batch(dcfg, step).items()}
        batch.update(extra)
        return batch

    (_, o_sh, _), _ = ts.shardings_for_train(mesh, model, state,
                                             batch_at(start_step))
    placed_state = sh.device_put(state, o_sh)
    losses = []
    for s in range(start_step, steps):
        # The step gathers the placed state (the tensors themselves:
        # every block is a view) and writes its update back.
        t0 = time.perf_counter()
        metrics = step_fn(model, placed_state, batch_at(s))
        loss = float(metrics["loss"])
        losses.append(loss)
        if s % log_every == 0:
            print(f"[train] step {s} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"dt={time.perf_counter() - t0:.2f}s", flush=True)
        if ckpt_dir and (s + 1) % save_every == 0:
            ckpt_lib.save(ckpt_dir, s + 1, ckpt_lib.train_tree(
                model, sh.gather(placed_state, dev)))
            ckpt_lib.keep_last(ckpt_dir, 3)
    if ckpt_dir:
        ckpt_lib.save(ckpt_dir, steps, ckpt_lib.train_tree(
            model, sh.gather(placed_state, dev)))
    return model, losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    _, losses = train_loop(cfg, args.steps, args.batch, args.seq,
                           ckpt_dir=args.ckpt_dir, resume=args.resume,
                           microbatches=args.microbatches)
    print(f"[train] done: first loss {losses[0]:.4f} → last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
