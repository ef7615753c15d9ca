#!/usr/bin/env python3
"""Where a benchmark cell's step or flush spends its device time, by the
program's spans, and where its plan build spends its host time, by stage
and leg, on one NVIDIA GPU.

Run from the repository root::

    python3 tools/span_breakdown.py --workload agnn_arxiv.train \\
        [--seed N] [--seconds S] [--out FILE]

It makes one traced run of the cell through the benchmark's harness (the
run ``gpubench/run.py --trace 1`` makes) and reads, from the profiled
slice at the window's end:

- ``spans``: device seconds of the spans on ``repro_torch.obs.trace``'s
  device clock (``gnn.step``, ``gnn_service.flush``, ``apply.combine``),
  total and self (less the clocked children's), with the count;
- ``index_add``: the ``index_add_`` kernels' (``indexFunc*``) device
  seconds by the chain of program ranges around their launch; a launch
  on a thread with no range of its own (autograd's) takes the ranges
  open on any thread at that time, marked ``~``;
- ``kernels``: every kernel group's device seconds by the innermost
  program range around its launch;
- ``plan``: the plan build's host seconds by stage, per leg (train) or
  per operator (serve), with ``plan_build_s`` and the rest;
- ``tracing``: the step time before the slice and inside it (tracing
  on), and the host cost of a span site with tracing off, and on with
  and without the device clock.

It prints the result line and this document as JSON, and writes the
document to ``--out`` (default ``build/spans_<cell>.json``).
"""
import argparse
import bisect
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

PREFIXES = ("gnn.", "apply.", "gnn_service.", "serve.", "kernels.",
            "plan.")


def span_table(roots) -> dict:
    """Device seconds by span key (name, with op, leg and phase)."""
    out = {}
    todo = list(roots)
    while todo:
        sp = todo.pop()
        todo.extend(sp.children)
        dev = sp.device_s
        if dev is None:
            continue
        key = sp.name + "".join(f"[{k}={sp.attrs[k]}]"
                                for k in ("op", "leg", "phase")
                                if k in sp.attrs)
        kids = sum(c.device_s or 0.0 for c in sp.children)
        row = out.setdefault(key, {"n": 0, "device_s": 0.0, "self_s": 0.0})
        row["n"] += 1
        row["device_s"] += dev
        row["self_s"] += dev - kids
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["device_s"]))


def kernel_tables(prof) -> tuple[dict, dict, dict]:
    """``index_add_`` kernels by range chain, every kernel group by
    innermost range, and the match counts."""
    from torch.autograd import DeviceType

    from gpubench.trace import classify

    ranges, launches, kernels = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        if kind == DeviceType.CPU:
            name = e.name()
            if name.startswith(PREFIXES):
                ranges.setdefault(e.start_thread_id(), []).append(
                    (e.start_ns(), e.end_ns(), name))
            elif name.startswith("cu"):
                launches[e.correlation_id()] = (e.start_ns(),
                                                e.start_thread_id())
        elif kind == DeviceType.CUDA and not e.is_user_annotation():
            kernels.append((e.name(), e.end_ns() - e.start_ns(),
                            e.correlation_id()))
    for v in ranges.values():
        v.sort()
    every = sorted(r for v in ranges.values() for r in v)

    def chain(t, thread):
        own = [r for r in ranges.get(thread, []) if r[0] <= t <= r[1]]
        if own:
            return ">".join(r[2] for r in own)
        i = bisect.bisect_right(every, (t, 1 << 62, ""))
        other = [r for r in every[:i] if r[1] >= t]
        return "~" + ">".join(r[2] for r in other) if other else "(none)"

    index_add, groups = {}, {}
    matched = 0
    for name, ns, corr in kernels:
        at = launches.get(corr)
        where = chain(*at) if at else "(no launch)"
        matched += at is not None
        inner = where.split(">")[-1]
        g = groups.setdefault(inner, {})
        grp = classify(name)
        g[grp] = g.get(grp, 0.0) + ns / 1e9
        if "indexfunc" in name.lower():
            index_add[where] = index_add.get(where, 0.0) + ns / 1e9
    order = sorted(index_add.items(), key=lambda kv: -kv[1])
    groups = dict(sorted(groups.items(),
                         key=lambda kv: -sum(kv[1].values())))
    return dict(order), groups, {"kernels": len(kernels),
                                 "matched": matched}


def site_cost(dev, n: int = 200000) -> dict:
    """Host ns of one span site: off (profiler off, process tracer
    disabled) and on (an enabled tracer, with and without the device
    clock on ``dev``)."""
    import torch

    from repro_torch.obs import trace

    x = torch.zeros(1, device=dev)
    t = time.perf_counter()
    for _ in range(n):
        with trace.span("apply.combine", x, op="spmm"):
            pass
    off = (time.perf_counter() - t) / n * 1e9
    on_n = n // 20
    with trace.use_tracer(trace.Tracer()):
        t = time.perf_counter()
        for _ in range(on_n):
            with trace.span("apply.combine", x, op="spmm"):
                pass
        on = (time.perf_counter() - t) / on_n * 1e9
        t = time.perf_counter()
        for _ in range(on_n):
            with trace.span("apply.tc"):
                pass
        plain = (time.perf_counter() - t) / on_n * 1e9
    return {"off_ns": off, "on_ns": on, "on_plain_ns": plain}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=2147483659)
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from gpubench import cells, harness
    from gpubench import trace as gtrace
    from repro_torch.obs import trace

    if not torch.cuda.is_available():
        print("span_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    seen = {}
    summary = gtrace.Slice.summary

    def keep_profile(self, top=10):
        seen["prof"] = self.prof
        return summary(self, top)

    train_window = cells.train_window

    def keep_window(*a, **kw):
        seen["window"] = out = train_window(*a, **kw)
        return out

    reader = harness.reader

    def plan_reader(name):
        fn = reader(name)

        def read(rec):
            seen.setdefault("plan", plan_of(rec))
            return fn(rec)
        return read

    gtrace.Slice.summary = keep_profile
    cells.train_window = keep_window
    harness.reader = plan_reader
    t0 = time.perf_counter()
    result = harness.run_cell(args.workload, args.seed % (1 << 63),
                              args.seconds, True, dev, t_start=t0)
    roots = list(trace.get_tracer().roots)
    doc = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(dev),
           "spans": span_table(roots)}
    index_add, groups, counts = kernel_tables(seen["prof"])
    doc.update(index_add=index_add, kernels=groups, matched=counts,
               plan=seen.get("plan"))
    top = [sp for sp in roots
           if sp.name in ("gnn.step", "gnn_service.flush")]
    sites = 0
    todo = list(top)
    while todo:
        sp = todo.pop()
        sites += 1
        todo.extend(sp.children)
    tracing = {"roots": len(top),
               "sites_each": sites / len(top) if top else None}
    win = seen.get("window")
    if win and win.get("pre"):
        pre_s, pre_n = win["pre"]
        tracing.update(
            pre_step_ms=1e3 * pre_s / pre_n,
            slice_step_ms=1e3 * (win["seconds"] - pre_s)
            / max(win["steps"] - pre_n, 1))
    trace.get_tracer().clear()
    tracing.update(site_cost(dev))
    doc["tracing"] = tracing
    print(json.dumps(result))
    print(json.dumps(doc, indent=1))
    out = pathlib.Path(args.out or ROOT / "build"
                       / f"spans_{args.workload}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"result": result, **doc}, indent=1))
    return 0


def plan_of(rec) -> dict:
    """The plan build's host seconds: by stage and leg for a training
    cell's ``GraphOps``, by stage and operator for a serving cell's
    registry, beside the harness's ``plan_build_s``."""
    out = {"plan_build_s": sum(rec.spans.spans.get("plan_build", []))}
    gops = getattr(rec.world, "gops", None)
    if gops is not None:
        out["stages"] = dict(gops.build_s)
        out["legs"] = {k: dict(v) for k, v in gops.build_legs.items()}
    else:
        reg = rec.world.service.engine.registry
        out["stages"] = reg.plan_build_s()
        out["ops"] = {kind: dict(op.op.plan.meta["build_s"])
                      for name in reg.stats()["names"]
                      for kind, op in reg.resolve(name).ops.items()}
    out["outside_stages_s"] = out["plan_build_s"] - sum(
        out["stages"].values())
    return out


if __name__ == "__main__":
    sys.exit(main())
