"""Dry run of every (arch × shape × mesh) cell: the whole step traced under
the op counter.

The reference (``repro.launch.dryrun``) lowers and compiles each cell for
256 or 512 fake devices and reads XLA's memory and cost analyses. The
port compiles nothing: it runs each cell's whole step once at the
shape's global batch, on ``launch.mesh.make_production_mesh(device=...)``
inside the mesh's activation context, under
:class:`~repro_torch.launch.hlo_analysis.OpCounter`. On ``device="meta"``
(the default) the step runs on shapes alone: no card and no memory are
needed, and the trace proves that the step runs through (every shape,
dtype and kernel check on the way) and counts its flops, bytes and live
storage. A train cell is the step of ``make_train_step`` (gradients and
AdamW), prefill is ``forward_logits`` under ``no_grad``, decode is one
``make_serve_step`` over a ``decode_input_specs`` cache.
``--device cuda`` runs the same step on the card with weights drawn
from a seed, for the cells that fit, and adds the milliseconds of one
more run (``ms``: the whole global program on one card, against
roofline terms that are per position).

The JSON keeps the reference's keys, with these differences:
``trace_s`` replaces ``compile_s``; ``bytes_per_device.arguments`` is the
largest position's parameter, optimizer-state and batch (or cache)
blocks under the reference's shardings; ``output``, ``temp``, ``alias``
and the roofline's flops and bytes are the global one-process program
over ``n_chips`` (``per_device`` says so); the collectives are empty
(one process partitions nothing); there is no ``xla_cost_analysis``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2_9b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2_130m \\
        --shape decode_32k --device cuda

Results land in experiments/dryrun_torch/<arch>_<shape>_<mesh>.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.dist import sharding as sh
from repro_torch.launch import flops as F
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.models.config import ALL_SHAPES, ArchConfig, InputShape
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# Gradient-accumulation microbatches for train_4k, the reference's: it
# sized them so that the per-device working set fits a 16 GB v5e HBM (one
# microbatch of activations lives at a time; grads accumulate in f32).
# The same programs run here.
DEFAULT_MICROBATCHES = {
    "minitron_8b": 4, "gemma2_9b": 4, "glm4_9b": 4, "granite_34b": 16,
    "qwen3_moe_235b_a22b": 8, "moonshot_v1_16b_a3b": 8, "whisper_tiny": 1,
    "qwen2_vl_7b": 8, "mamba2_130m": 1, "zamba2_7b": 4,
}

PER_DEVICE = ("arguments: the largest position's parameter, optimizer-state "
              "and batch (or cache) blocks under the reference's shardings; "
              "output, temp, alias and the roofline's flops and bytes: the "
              "global one-process program over n_chips")


def skip_reason(cfg: ArchConfig, shape: InputShape) -> str | None:
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return "skip(quadratic): full-attention arch at 500k context"
    return None


def input_specs(cfg: ArchConfig, shape: InputShape):
    """Meta-tensor stand-ins for every model input of the cell."""
    if shape.kind == "train" or shape.kind == "prefill":
        return api.train_input_specs(cfg, shape)
    return api.decode_input_specs(cfg, shape)


def _materialize(specs, dev, gen, vocab):
    """The specs on ``meta`` as they are; elsewhere seeded tokens below
    ``vocab``, normal floats and zeroed caches on ``dev``."""
    if dev.type == "meta":
        return specs

    def one(t):
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=gen, device=dev,
                               dtype=torch.float32).to(t.dtype)
        return torch.randint(0, vocab, t.shape, generator=gen, device=dev,
                             dtype=t.dtype)

    return sh.tree_map(one, specs)


def _largest_position_bytes(mesh, pairs) -> int:
    """Bytes of the largest position's blocks: ``pairs`` are (tree,
    shardings) of the same structure, as phase 13 (a) of ``chip_smoke.py``
    sums them."""
    index = {pos: i for i, pos in enumerate(mesh.positions())}
    per_pos = np.zeros(mesh.size)

    def add(t, s):
        block = math.prod(s.shard_shape(t.shape)) * t.element_size()
        held = [index[pos] for pos, idx in s.indices_map(t.shape).items()
                if idx is not None]
        per_pos[held] += block

    for tree, shardings in pairs:
        sh.tree_map(add, tree, shardings)
    return int(per_pos.max())


def cell_program(cfg: ArchConfig, shape: InputShape, mesh, *,
                 microbatches: int = 1, device="meta", seed: int = 0):
    """The cell's step, built on ``device`` with weights and inputs drawn
    from ``seed``. Returns ``(kind, fn, args, arguments)``: ``fn(*args)``
    runs the step once, and ``arguments`` are the largest position's
    argument bytes."""
    dev = torch.device(device)
    gen = None if dev.type == "meta" else torch.Generator(dev).manual_seed(
        seed)
    model = api.init_params(gen, cfg, device=dev)
    params = dict(model.named_parameters())
    specs = input_specs(cfg, shape)
    if shape.kind in ("train", "prefill"):
        batch = _materialize(specs, dev, gen, cfg.vocab)
        if shape.kind == "prefill":
            def fwd(model, batch):
                with torch.no_grad(), sh.activation_context(
                        mesh, sh.dp_only_of(cfg)):
                    logits, _ = api.forward_logits(model, batch, cfg)
                return logits

            p_sh = sh.param_shardings(mesh, params,
                                      replicate=cfg.replicate_params)
            args = _largest_position_bytes(mesh, [
                (params, p_sh), (batch, sh.batch_shardings(mesh, batch))])
            return "prefill", fwd, (model, batch), args
        opt_cfg = opt_lib.OptConfig()
        state = opt_lib.init_opt_state(params, opt_cfg)
        step = ts.make_train_step(cfg, opt_cfg, mesh,
                                  microbatches=microbatches)
        (p_sh, o_sh, b_sh), _ = ts.shardings_for_train(
            mesh, params, state, batch, replicate_params=cfg.replicate_params)
        args = _largest_position_bytes(
            mesh, [(params, p_sh), (state, o_sh), (batch, b_sh)])
        return "train", step, (model, state, batch), args
    cache = specs["cache"] if dev.type == "meta" else api.init_cache(
        cfg, shape.global_batch, shape.seq_len, dtype=torch.bfloat16,
        device=dev)
    token = _materialize(specs["token"], dev, gen, cfg.vocab)
    cache_len = shape.seq_len - 1
    serve = ts.make_serve_step(cfg, mesh)
    (p_sh, c_sh, t_sh, _), _ = ts.shardings_for_serve(
        mesh, params, cache, token, sample=cfg.serve_sample,
        replicate_params=cfg.replicate_params)
    args = _largest_position_bytes(
        mesh, [(params, p_sh), (cache, c_sh), (token, t_sh)])

    def decode(model, cache, token):
        with torch.no_grad():
            return serve(model, cache, token, cache_len)

    return "decode", decode, (model, cache, token), args


def trace_cell(cfg: ArchConfig, shape: InputShape, mesh, *,
               microbatches: int = 1, device="meta", seed: int = 0):
    """Run the cell's step (:func:`cell_program`) once under the counter.
    Returns ``(kind, stats, arguments, run)``: the counts, the largest
    position's argument bytes and a function that runs the step again
    (for timing)."""
    kind, fn, args, arguments = cell_program(
        cfg, shape, mesh, microbatches=microbatches, device=device,
        seed=seed)
    return (kind, H.analyze_step(fn, *args), arguments,
            lambda: fn(*args))


def _apply_overrides(cfg, overrides: dict | None):
    if not overrides:
        return cfg
    typed = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            typed[k] = v.lower() in ("1", "true", "yes") if isinstance(v, str) else bool(v)
        elif isinstance(cur, int):
            typed[k] = int(v)
        elif isinstance(cur, float):
            typed[k] = float(v)
        else:
            typed[k] = v
    return dataclasses.replace(cfg, **typed)


def _counts(st: H.HloStats, model_flops: float) -> dict:
    """What the roofline reads, for ``--reanalyze``: the per-device counts
    and the global MODEL_FLOPS of the cell's config."""
    return {"flops": st.flops, "hbm_bytes": st.hbm_bytes,
            "flops_by_dtype": st.flops_by_dtype,
            "model_flops_global": model_flops}


def run_cell(arch: str, shape: InputShape, multi_pod: bool,
             microbatches: int = 1, save: bool = True,
             overrides: dict | None = None, tag: str = "", *,
             device="meta", config: ArchConfig | None = None,
             out_dir: str | None = None, seed: int = 0) -> dict:
    """One cell. ``config`` replaces ``get_config(arch)`` (the tests pass
    smoke configs); ``out_dir`` replaces :data:`OUT_DIR`."""
    cfg = _apply_overrides(config or get_config(arch), overrides)
    mesh_name = ("multi" if multi_pod else "single") + (f"_{tag}" if tag else "")
    cell = {"arch": arch, "shape": shape.name, "mesh": mesh_name}
    out_dir = out_dir or OUT_DIR
    reason = skip_reason(cfg, shape)
    if reason:
        cell["status"] = reason
        if save:
            _save(cell, out_dir)
        return cell
    t0 = time.time()
    if microbatches == 1 and shape.kind == "train":
        microbatches = DEFAULT_MICROBATCHES.get(arch, 1)
    cell["microbatches"] = microbatches
    try:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # Every position on the step's own device: one process computes on
        # whole tensors, so spreading positions would only copy blocks.
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
        n_chips = mesh.size
        kind, stats, arguments, run = trace_cell(
            cfg, shape, mesh, microbatches=microbatches, device=dev)
        trace_s = time.time() - t0
        mf = F.model_flops(cfg, shape)
        per_dev = stats.per_device(n_chips)
        rl = H.roofline_from_stats(per_dev, model_flops_global=mf,
                                   n_chips=n_chips)
        cell.update(
            status="ok",
            kind=kind,
            device=dev.type,
            trace_s=round(trace_s, 1),
            n_chips=n_chips,
            per_device=PER_DEVICE,
            bytes_per_device={
                "arguments": arguments,
                "output": per_dev.output_bytes,
                "temp": per_dev.temp_bytes,
                "alias": per_dev.alias_bytes,
                "peak_live": arguments + per_dev.temp_bytes,
            },
            roofline=rl.as_dict(),
            counts=_counts(per_dev, mf),
            by_op=stats.by_op,
            kernel_calls=stats.kernel_calls,
            collectives={},
            collective_count=0,
            params=F.count_params(cfg),
        )
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            run()
            end.record()
            torch.cuda.synchronize(dev)
            cell["ms"] = start.elapsed_time(end)
    except Exception as exc:  # a trace failure = a bug in the system
        cell["status"] = f"FAIL: {type(exc).__name__}: {exc}"
        cell["traceback"] = traceback.format_exc()[-2000:]
    if save:
        _save(cell, out_dir)
    return cell


def _save(cell: dict, out_dir: str = OUT_DIR) -> None:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{cell['arch']}_{cell['shape']}_{cell['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(cell, f, indent=1)


def reanalyze_saved(out_dir: str = OUT_DIR) -> None:
    """Recompute the roofline of saved cells from their counts (no
    retrace) with the current
    :class:`~repro_torch.launch.hlo_analysis.Hardware`."""
    for jp in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(jp) as f:
            cell = json.load(f)
        if not str(cell.get("status", "")).startswith("ok"):
            continue
        counts = dict(cell["counts"])
        mf = counts.pop("model_flops_global")
        stats = H.HloStats(coll_op_bytes={}, link_traffic=0.0, coll_count=0,
                           **counts)
        rl = H.roofline_from_stats(stats, model_flops_global=mf,
                                   n_chips=cell["n_chips"])
        cell["roofline"] = rl.as_dict()
        with open(jp, "w") as f:
            json.dump(cell, f, indent=1)
        r = cell["roofline"]
        print(f"[reanalyze] {cell['arch']} {cell['shape']} {cell['mesh']}: "
              f"bott={r['bottleneck']} c={r['compute_s']:.3e} "
              f"m={r['memory_s']:.3e} l={r['collective_s']:.3e}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--reanalyze", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override key=value (repeatable)")
    ap.add_argument("--tag", default="",
                    help="suffix for the result file (perf iterations)")
    ap.add_argument("--device", default="meta",
                    help="meta (shapes only, the default) or cuda (runs the "
                    "step on the card and times it)")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    if args.reanalyze:
        reanalyze_saved(args.out_dir)
        return
    overrides = dict(kv.split("=", 1) for kv in args.override)

    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = [s for s in ALL_SHAPES if args.shape in (None, s.name)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "multi" if mp else "single"
                out = os.path.join(
                    args.out_dir, f"{arch}_{shape.name}_{mesh_name}.json")
                if args.skip_existing and os.path.exists(out):
                    with open(out) as f:
                        prev = json.load(f)
                    if str(prev.get("status", "")).startswith(("ok", "skip")):
                        print(f"[dryrun] cached {arch} {shape.name} {mesh_name}")
                        continue
                cell = run_cell(arch, shape, mp,
                                microbatches=args.microbatches,
                                overrides=overrides, tag=args.tag,
                                device=args.device, out_dir=args.out_dir)
                status = cell["status"].splitlines()[0]
                rl = cell.get("roofline", {})
                extra = ""
                if rl:
                    extra = (f" bott={rl['bottleneck']}"
                             f" c={rl['compute_s']:.3e}s"
                             f" m={rl['memory_s']:.3e}s"
                             f" l={rl['collective_s']:.3e}s"
                             f" useful={rl['useful_ratio']:.2f}"
                             f" trace={cell['trace_s']}s")
                print(f"[dryrun] {arch} {shape.name} {mesh_name}: "
                      f"{status}{extra}", flush=True)


if __name__ == "__main__":
    main()
