"""The readings the comparison's limits are set from, on the card.

    python3 gpubench/control.py --workload <cell> --seeds 12 --seed0 <n> \
        [--faults 3] [--seconds 3] [--out chiprun_out/control.jsonl]

Builds the cell's plans or serving tier once, then for each seed reads
the cell's numbers (see :mod:`gpubench.check`) three ways:

* ``program``: the program, as a run of the cell drives it (training:
  its first steps; serving: a short window at the cell's own load);
* ``control``: the reference in the program's place, computed in
  bfloat16, the precision below the configuration's float32;
* ``half_batch`` (training, the first ``--faults`` seeds): the
  reference in the program's place with the loss taken over half of
  the nodes.

One JSON line a reading. A fault that returns the state unchanged reads
1 on ``update_gap`` by construction and needs no run.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == ROOT / "gpubench":
    del sys.path[0]


def readings(workload: str, seeds: list[int], dev, *, faults: int = 3,
             seconds: float = 3.0, overrides: dict | None = None):
    """Yield one dict a reading: ``seed``, ``who`` and the numbers."""
    import torch

    from gpubench import cells, check, traffic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, cfg, mix = cells.cell(workload)
    overrides = overrides or {}
    cfg = {**cfg, **overrides.get("config", {})}
    mix = {**mix, **overrides.get("traffic", {})}
    world = cells.World(cfg, mix["kind"], dev, cells.Spans())
    model = cells.reference(cfg)
    e = check.edges(world.graph, dev)
    lr = cfg["optimizer"]["lr"]
    half = torch.arange(world.graph.m // 2, device=dev)
    for i, seed in enumerate(seeds):
        if mix["kind"] == "train":
            makers = [("program", lambda: cells.TrainProgram(world, seed)),
                      ("control", lambda: cells.ReferenceTrainProgram(
                          world, seed, dtype=torch.bfloat16))]
            if i < faults:
                makers.append(("half_batch",
                               lambda: cells.ReferenceTrainProgram(
                                   world, seed, loss_rows=half)))
            for who, make in makers:
                prog = make()
                run = cells.train_check_steps(prog, mix["check_steps"])
                layers0, x, labels = prog.layers0, prog.x, prog.labels
                prog.free()
                del prog
                cells.release(dev)
                detail: dict = {}
                numbers = check.train_numbers(model, layers0, e, x,
                                              labels, run, lr=lr,
                                              detail=detail)
                yield {"seed": seed, "who": who, "losses": run["losses"],
                       **numbers, **detail}
            continue
        prog = cells.ServeProgram(world, seed, mix["pool_panels"])
        plan = traffic.schedule(mix, cfg, seed, seconds, world.graph.m, dev)
        cells.warm_serve(prog, dev, plan, mix["max_batch"])
        win = cells.serve_window(prog, dev, plan, cells.Spans(),
                                 max_batch=mix["max_batch"])
        yield {"seed": seed, "who": "program", "requests": len(plan.due),
               "errors": win["errors"],
               **check.serve_numbers(model, prog.layers0, e,
                                     prog.pool, plan, win["kept"])}
        ctrl = cells.ReferenceServeProgram(world, seed, mix["pool_panels"])
        kept = {}
        for j in sorted(plan.check):
            rid = ctrl.submit(plan.panels[j], plan.subset_ids(j)
                              if plan.subset[j] else None)
            kept[j] = ctrl.flush()[rid]
        yield {"seed": seed, "who": "control",
               **check.serve_numbers(model, ctrl.layers0, e,
                                     ctrl.pool, plan, kept)}
        prog.free()
        ctrl.free()
        del prog, ctrl, win, kept
        cells.release(dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--seed0", type=int, required=True)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(path))
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [args.seed0 + i for i in range(args.seeds)]
    t = time.perf_counter()
    with open(args.out or "/dev/null", "a") as out:
        for row in readings(args.workload, seeds, torch.device("cuda", 0),
                            faults=args.faults, seconds=args.seconds):
            line = json.dumps({"workload": args.workload, **row,
                               "at_s": round(time.perf_counter() - t, 1)})
            print(line, flush=True)
            out.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
