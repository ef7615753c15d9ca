"""Render the dry-run cells (``launch/dryrun.py``) into tables.

The reference's ``repro.launch.report`` over the port's JSON: the
roofline and dry-run tables, the hill-climb picks, and the fused
attention projection. That last one is reported from the other end
here: the port's attention is already fused (K5), so the table shows
the memory term as counted, with K5's counted bytes, next to the term
if the unfused chunked chain (``hbm_traffic_model``'s ``unfused``) took
the place of every K5 call.

    PYTHONPATH=src python -m repro_torch.launch.report roofline
    PYTHONPATH=src python -m repro_torch.launch.report dryrun multi
    PYTHONPATH=src python -m repro_torch.launch.report build EXPERIMENTS.md
"""
from __future__ import annotations

import glob
import json
import os

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")
ARCH_ORDER = ["minitron_8b", "gemma2_9b", "glm4_9b", "granite_34b",
              "qwen3_moe_235b_a22b", "moonshot_v1_16b_a3b", "whisper_tiny",
              "qwen2_vl_7b", "mamba2_130m", "zamba2_7b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_cells(mesh: str = "single", dryrun_dir: str | None = None) -> dict:
    cells = {}
    for path in glob.glob(os.path.join(dryrun_dir or DRYRUN_DIR,
                                       f"*_{mesh}.json")):
        with open(path) as f:
            c = json.load(f)
        cells[(c["arch"], c["shape"])] = c
    return cells


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    for unit, scale in (("s", 1.0), ("ms", 1e-3), ("us", 1e-6), ("ns", 1e-9)):
        if x >= scale:
            return f"{x / scale:.2f}{unit}"
    return f"{x:.1e}s"


def _frac(c: dict) -> float:
    r = c["roofline"]
    dom = max(r["compute_s"], r["memory_s"], r["collective_s"])
    return r["compute_s"] / dom if dom else 0.0


def roofline_table(mesh: str = "single", dryrun_dir: str | None = None) -> str:
    cells = load_cells(mesh, dryrun_dir)
    lines = [
        "| arch | shape | kind | compute | memory | collective | bottleneck"
        " | roofline-frac | MODEL_FLOPS/dev | useful | peak GB/dev |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            c = cells.get((arch, shape))
            if c is None:
                continue
            if not str(c["status"]).startswith("ok"):
                lines.append(f"| {arch} | {shape} | — | — | — | — | "
                             f"{c['status'].splitlines()[0][:46]} | — | — |"
                             " — | — |")
                continue
            r = c["roofline"]
            peak = c["bytes_per_device"]["peak_live"] / 1e9
            lines.append(
                f"| {arch} | {shape} | {c['kind']} | {fmt_s(r['compute_s'])} |"
                f" {fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} |"
                f" {r['bottleneck']} | {_frac(c):.3f} |"
                f" {r['model_flops']:.2e} | {r['useful_ratio']:.2f} |"
                f" {peak:.1f} |")
    return "\n".join(lines)


def dryrun_table(mesh: str, dryrun_dir: str | None = None) -> str:
    cells = load_cells(mesh, dryrun_dir)
    lines = [
        "| arch | shape | status | chips | args GB/dev | temp GB/dev |"
        " collectives (count) | trace s |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            c = cells.get((arch, shape))
            if c is None:
                continue
            if not str(c["status"]).startswith("ok"):
                lines.append(f"| {arch} | {shape} |"
                             f" {c['status'].splitlines()[0][:46]} | — | — |"
                             f" — | — | — |")
                continue
            b = c["bytes_per_device"]
            coll = ", ".join(f"{k}:{v / 1e9:.1f}GB"
                             for k, v in c["collectives"].items())
            lines.append(
                f"| {arch} | {shape} | ok | {c['n_chips']} |"
                f" {b['arguments'] / 1e9:.2f} | {b['temp'] / 1e9:.2f} |"
                f" {coll} ({c['collective_count']}) | {c['trace_s']} |")
    return "\n".join(lines)


def pick_hillclimb_cells(dryrun_dir: str | None = None) -> list[tuple]:
    """worst roofline fraction / most collective-bound / most
    paper-representative (MoE sparse dispatch)."""
    cells = load_cells("single", dryrun_dir)
    ok = {k: v for k, v in cells.items()
          if str(v["status"]).startswith("ok")}
    worst = min(ok.items(), key=lambda kv: _frac(kv[1]))
    coll = max(ok.items(),
               key=lambda kv: kv[1]["roofline"]["collective_s"]
               / max(kv[1]["roofline"]["compute_s"], 1e-12))
    return [("worst-roofline-fraction", worst[0], _frac(worst[1])),
            ("most-collective-bound", coll[0],
             coll[1]["roofline"]["collective_s"]
             / max(coll[1]["roofline"]["compute_s"], 1e-12)),
            ("paper-representative", ("qwen3_moe_235b_a22b", "train_4k"),
             _frac(ok[("qwen3_moe_235b_a22b", "train_4k")]))]


def _unfused_bytes(kernel_calls: dict, chunk: int) -> float:
    """HBM bytes of the unfused chunked chain over every counted K5 call
    (``"b,sq,sk,h,kv,d"`` → calls)."""
    from repro_torch.kernels.flash_attention import hbm_traffic_model

    total = 0.0
    for key, calls in kernel_calls.items():
        b, sq, sk, h, kv, d = map(int, key.split(","))
        tm = hbm_traffic_model(b=b, sq=sq, sk=sk, h=h, kv=kv, d=d,
                               chunk=min(chunk, sk))
        total += calls * tm["unfused"]
    return total


def fused_attention_projection(dryrun_dir: str | None = None) -> str:
    """The memory term as counted (K5 fused) against the term with the
    unfused chunked chain in place of every K5 call."""
    from repro_torch.configs import get_config
    from repro_torch.launch.hlo_analysis import Hardware

    hbm_bw = Hardware().hbm_bw
    lines = [
        "| arch | shape | memory (counted, K5 fused) | K5 share |"
        " memory (unfused chain in place of K5) | ratio |",
        "|---|---|---|---|---|---|",
    ]
    cells = load_cells("single", dryrun_dir)
    for arch in ARCH_ORDER:
        for shape_name in ("train_4k", "prefill_32k"):
            c = cells.get((arch, shape_name))
            if c is None or not str(c["status"]).startswith("ok"):
                continue
            calls = c.get("kernel_calls", {}).get("flash_attention")
            mem_s = c["roofline"]["memory_s"]
            if not calls or mem_s <= 0:
                continue
            n = c["n_chips"]
            k5_s = c["by_op"]["flash_attention"]["bytes"] / n / hbm_bw
            unfused_s = _unfused_bytes(
                calls, get_config(arch).attn_chunk) / n / hbm_bw
            mem_unfused = mem_s - k5_s + unfused_s
            lines.append(
                f"| {arch} | {shape_name} | {fmt_s(mem_s)} |"
                f" {k5_s / mem_s * 100:.1f}% | {fmt_s(mem_unfused)} |"
                f" {mem_unfused / mem_s:.2f}× |")
    return "\n".join(lines)


def build_experiments_md(path: str, dryrun_dir: str | None = None) -> None:
    """Fill the four table placeholders of the file at ``path``."""
    with open(path) as f:
        text = f.read()
    subs = {
        "<!-- ROOFLINE_TABLE -->": roofline_table("single", dryrun_dir),
        "<!-- DRYRUN_TABLE_SINGLE -->":
            "### Single-pod (16×16 = 256 positions)\n\n"
            + dryrun_table("single", dryrun_dir),
        "<!-- DRYRUN_TABLE_MULTI -->":
            "### Multi-pod (2×16×16 = 512 positions)\n\n"
            + dryrun_table("multi", dryrun_dir),
        "<!-- PERF_FUSED_TABLE -->": fused_attention_projection(dryrun_dir),
    }
    for k, v in subs.items():
        if k in text:
            text = text.replace(k, v)
    with open(path, "w") as f:
        f.write(text)
    print(f"{path}: tables injected")


if __name__ == "__main__":
    import sys

    what = sys.argv[1] if len(sys.argv) > 1 else "roofline"
    if what == "roofline":
        print(roofline_table("single"))
    elif what == "dryrun":
        print(dryrun_table(sys.argv[2] if len(sys.argv) > 2 else "single"))
    elif what == "pick":
        for tag, cell, val in pick_hillclimb_cells():
            print(tag, cell, f"{val:.4f}")
    elif what == "fused":
        print(fused_attention_projection())
    elif what == "build":
        build_experiments_md(sys.argv[2])
