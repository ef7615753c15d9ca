"""Run one cell of the benchmark once, on the card.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It loads, warms up, measures for
``--seconds``, compares what the window produced with the plain
reference and prints one JSON line last on standard output. Without a
card, with fewer cards than the cell asks for, or without the program
beside it, it exits non-zero and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Run as a script, Python puts this folder first on the path, where
# ``trace.py`` would stand in for the standard library's module.
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == ROOT / "gpubench":
    del sys.path[0]

#: Top-level module names that must not be loaded when the result is
#: printed: JAX and the package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted({k.split(".")[0] for k in sys.modules
                   if k.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    try:
        import torch

        import repro_torch  # noqa: F401
        from gpubench import cells, harness
    except ImportError as exc:
        print(f"gpubench: cannot load the program or the harness: {exc}",
              file=sys.stderr)
        return 3
    entry, _, _ = cells.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"gpubench: {args.workload} needs {entry['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    seed = args.seed % (1 << 63)
    result = harness.run_cell(args.workload, seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        lim = "none (not compared)" if c["limit"] is None else f"{c['limit']!r}"
        print(f"check {name}: {c['value']!r} limit {lim}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
