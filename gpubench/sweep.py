"""The sweep that finds a serving cell's knee, on the card.

    python3 gpubench/sweep.py --workload <serve cell> --seed <n> \
        --seconds 10 --rates 100,150,200,250,300

Registers the cell's model once, warms it up, then offers each rate in
turn for ``--seconds`` with the cell's mix (open loop, the same
generator as the benchmark's runs) and prints one JSON line a rate:
requests, latency p50/p95/max, the seconds the queue took to drain
after the last arrival, and the completed requests a second. The knee
is the highest offered rate at which every request is served, the queue
left at the last arrival drains within three mean flushes, the p95
stays within five times the p95 at the sweep's first (lowest) rate, and
the rate lies under the capacity that the sweep's saturated top rates
show (requests a flush over the mean flush time): past it the queue,
and with it the tail, grows through the window. A flush's time grows
with its batch, so where flushes are long the drain alone cannot tell.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == ROOT / "gpubench":
    del sys.path[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(path))
    import torch

    from gpubench import cells, traffic

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _, cfg, mix = cells.cell(args.workload)
    world = cells.World(cfg, "serve", dev, cells.Spans())
    prog = cells.ServeProgram(world, args.seed, mix["pool_panels"])
    rates = [float(r) for r in args.rates.split(",")]
    for k, r in enumerate(rates):
        plan = traffic.schedule(mix, cfg, args.seed + k, args.seconds,
                                world.graph.m, dev, offered=r)
        if k == 0:
            cells.warm_serve(prog, dev, plan, mix["max_batch"])
        spans = cells.Spans()
        win = cells.serve_window(prog, dev, plan, spans,
                                 max_batch=mix["max_batch"])
        lat = [v * 1e3 for v in win["latency_s"]]
        print(json.dumps({
            "workload": args.workload, "offered_rps": r,
            "requests": len(lat), "errors": win["errors"],
            "p50_ms": cells.percentile(lat, 50),
            "p95_ms": cells.percentile(lat, 95), "max_ms": max(lat),
            "drain_s": win["seconds"] - args.seconds,
            "completed_rps": len(lat) / win["seconds"],
            "flushes": len(spans.spans.get("flush", [])),
            "flush_ms": 1e3 * statistics.mean(spans.spans.get("flush", [0])),
            "batch": statistics.mean(spans.spans.get("batch", [0])),
            "late_max_ms": 1e3 * max(win["late_s"]),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
