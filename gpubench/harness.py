"""One run of one cell: set-up, the measured window, the per-layer
readers and the comparison, assembled into the result's line.

:func:`run_cell` takes the device it is given; the command line
(:mod:`gpubench.run`) hands it the card and refuses to run without one.
The CPU tests hand it the CPU at a small size, which is how the harness
is exercised without a card.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import sys
import time

import torch

from gpubench import cells, check, trace, traffic
from gpubench.cells import Spans, sync


@dataclasses.dataclass
class Record:
    """What a per-layer reader may read: the configuration and mix, the
    spans and counters the harness recorded, the traced slice's summary,
    and the world (graph, plans) still alive after the window."""

    cfg: dict
    mix: dict
    dev: torch.device
    spans: Spans
    window: dict
    trace: dict | None
    world: cells.World


def reader(name: str):
    """The ``read(record)`` of ``gpubench/metrics/<name>.py``."""
    return cells.load_module("metrics", name).read


def metrics_of(bench: dict, cell: str, trace_on: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace_on`` its per-layer
    ones: those that list the cell, or list no cells and move an
    end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace_on:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace_on: bool,
             dev: torch.device, *, t_start: float | None = None,
             overrides: dict | None = None, program=None) -> dict:
    """Run the cell ``name`` once and return the result's line.

    ``overrides`` replaces keys of the configuration (``"config"``) and
    of the traffic mix (``"traffic"``); ``program`` replaces the
    program's class (the control and the CPU tests use both)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = cells.bench()
    entry, cfg, mix = cells.cell(name, bench)
    overrides = overrides or {}
    cfg = {**cfg, **overrides.get("config", {})}
    mix = {**mix, **overrides.get("traffic", {})}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    spans = Spans()
    kind = mix["kind"]
    world = cells.World(cfg, kind, dev, spans)
    slicer = trace.Slice(torch) if trace_on else None
    if slicer is not None and dev.type == "cuda":
        slicer.prime()
    e2e: dict[str, float] = {}
    if kind == "train":
        prog = (program or cells.TrainProgram)(world, seed)
        kept = cells.train_check_steps(prog, mix["check_steps"])
        sync(dev)
        setup_s = time.perf_counter() - t_start
        win = cells.train_window(prog, dev, seconds, slicer)
        e2e["train_step_ms"] = win["seconds"] * 1e3 / max(win["steps"], 1)
        attempted = win["steps"]
        failed = 0 if win["finite"] else attempted
        log(f"window: {win['steps']} steps in {win['seconds']:.3f} s")
    else:
        prog = (program or cells.ServeProgram)(world, seed,
                                               mix["pool_panels"])
        plan = traffic.schedule(mix, cfg, seed, seconds, world.graph.m, dev)
        cells.warm_serve(prog, dev, plan, mix["max_batch"])
        sync(dev)
        setup_s = time.perf_counter() - t_start
        spans.spans.pop("flush", None)
        spans.spans.pop("batch", None)
        win = cells.serve_window(prog, dev, plan, spans, slicer,
                                 max_batch=mix["max_batch"])
        lat_ms = [v * 1e3 for v in win["latency_s"]]
        p95 = cells.percentile(lat_ms, 95)
        e2e["serve_p95_ms"] = p95 if math.isfinite(p95) else 1e9
        attempted, failed = len(plan.due), win["errors"]
        late = win["late_s"]
        log(f"window: {attempted} requests at "
            f"{attempted / plan.seconds:.3f}/s offered, served in "
            f"{win['seconds']:.3f} s; {len(spans.spans.get('flush', []))} "
            f"flushes; latency p50 {cells.percentile(lat_ms, 50):.3f} ms, "
            f"p95 {p95:.3f} ms, max {max(lat_ms):.3f} ms; generator late "
            f"by median {statistics.median(late) * 1e3:.3f} ms, max "
            f"{max(late) * 1e3:.3f} ms; failed {failed}")
    e2e["setup_s"] = setup_s
    log(f"setup: {setup_s:.3f} s (graph "
        f"{sum(spans.spans.get('graph', [])):.3f} s, plans "
        f"{sum(spans.spans.get('plan_build', [])):.3f} s)")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    summary = slicer.summary() if slicer is not None else None
    if summary:
        log(f"trace: the profiler started in {slicer.start_s:.3f} s; busy "
            f"{summary['busy_s']:.6f} s of {summary['window_s']:.6f} s")
    metrics = {}
    record = Record(cfg, mix, dev, spans, win, summary, world)
    for m in metrics_of(bench, name, trace_on):
        value = (e2e.get(m["name"]) if not trace_on
                 else reader(m["name"])(record))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": peak}
    if trace_on:
        device["busy_s"] = summary["busy_s"] if summary else 0.0
        device["window_s"] = summary["window_s"] if summary else 0.0
    # The comparison runs once the program's state is freed.
    layers0, pool = prog.layers0, getattr(prog, "pool", None)
    x, labels = getattr(prog, "x", None), getattr(prog, "labels", None)
    del record, prog
    world.__dict__.pop("gops", None)
    world.__dict__.pop("service", None)
    cells.release(dev)
    e = check.edges(world.graph, dev)
    t = time.perf_counter()
    model = cells.reference(cfg)
    if kind == "train":
        numbers = check.train_numbers(model, layers0, e, x, labels,
                                      kept, lr=cfg["optimizer"]["lr"])
    else:
        numbers = check.serve_numbers(model, layers0, e, pool, plan,
                                      win["kept"])
    log(f"comparison: {time.perf_counter() - t:.3f} s")
    correct, checks = check.judge(numbers, cells.limits(name))
    correct = correct and (kind != "train" or failed == 0)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if summary:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = checks
    return out
