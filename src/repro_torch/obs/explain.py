"""Plan/execution explainer: the paper's arguments as inspectable numbers.

Libra's performance case rests on structural quantities — the 2D-aware
Tensor Core / CUDA-core split (Tensor Core fraction, window density),
the §4.3 Ts/Cs segment decomposition and its balance residue, padding
waste of the condensed formats, and the kernels' footprint on the card.
:func:`explain_spmm` / :func:`explain_sddmm` report all of them for a
prepared operator, plan, or registry entry, with a measured side on
request, as a dict and a rendered text table (:func:`render_table`).
:func:`explain_partition` reports a window-sharded partition's balance
and halo.

The structural fields are the reference package's, field for field.
Two sections are the card's own:

* ``occupancy`` — the Hopper footprint of the apply at the report's
  width: K1's (SpMM) or K3's (SDDMM) shared memory and threads a block
  and the CUDA-core kernels' L2 slice
  (:func:`~repro_torch.tune.model.spmm_footprint` /
  :func:`~repro_torch.tune.model.sddmm_footprint`), and how many such
  blocks one SM holds (:func:`~repro_torch.tune.model.occupancy_report`).
  ``bytes_per_step`` and ``pipeline_depth`` carry the reference's names
  for shared memory a block and blocks an SM, as the perf ledger does.
* ``measured`` — the median wall time of the apply with the card
  synchronized around each run, and the analytic operation and byte
  counts of :mod:`repro_torch.obs.ledger` under the reference's
  ``hlo_*`` keys (``"counts": "analytic"``: the port compiles no HLO).
"""
from __future__ import annotations

import numpy as np


def _window_hist(plan, a=None) -> dict:
    """Per-window density histogram. With the source matrix, the full
    Fig.-1 statistic (8×1 vector occupancy, 1..8 nnz); from the plan
    alone, occupancy of the condensed Tensor Core bitmaps (the residue
    stream has no vector structure left)."""
    from repro_torch.core.formats import WINDOW

    if a is not None:
        from repro_torch.tune.model import matrix_features

        feat = matrix_features(a)
        hist = feat.win_vec_hist.sum(axis=0)[1:]  # vectors with 1..8 nnz
        return {
            "vector_occupancy": [int(c) for c in hist],
            "window_density": float(feat.window_density),
            "source": "matrix",
        }
    bits = np.asarray(plan.tc.bitmap, np.uint32).reshape(-1)
    pop = np.zeros_like(bits, np.int64)
    for s in range(WINDOW):
        pop += (bits >> np.uint32(s)) & np.uint32(1)
    pop = pop[pop > 0]
    hist = np.bincount(pop, minlength=WINDOW + 1)[1:WINDOW + 1]
    return {
        "vector_occupancy": [int(c) for c in hist],
        "window_density": float(pop.mean() / WINDOW) if pop.size else 0.0,
        "source": "tc_bitmap",
    }


def _segment_report(plan) -> dict:
    """§4.3 segment counts, atomic fractions, and the LPT balance
    residue (:func:`repro_torch.core.balance.balance_report`) of each
    stream's segment sizes — the quantity shard balancing minimizes."""
    from repro_torch.core.balance import balance_report

    out: dict = {}
    for stream in ("tc", "vpu"):
        seg = plan.meta.get(f"{stream}_segments")
        if seg is None or not seg.nseg:
            out[stream] = None
            continue
        out[stream] = {
            "nseg": int(seg.nseg),
            "limit": int(seg.limit),
            "atomic_frac": float(np.mean(seg.atomic)),
            "mean_size": float(np.mean(seg.sizes)),
            "balance": balance_report(np.asarray(seg.sizes, np.int64), 8),
        }
    out["seg_spt"] = int(plan.meta.get("seg_spt", 1))
    return out


def _padding_report(plan, kind: str) -> dict:
    """Zero padding materialized by the condensed formats (bytes the
    kernels stream but the matrix never had)."""
    tc = plan.tc
    tc_cells = int(tc.vals.size)
    out = {
        "tc_padded_zeros": int(tc.padded_zeros),
        "tc_pad_frac": tc.padded_zeros / max(tc_cells, 1),
    }
    vpu = plan.vpu
    if kind == "spmm":
        vpu_cells = int(vpu.vals.size)
        vpu_pad = vpu_cells - int(vpu.nnz)
    else:  # COOTiles: mask marks real elements
        vpu_cells = int(vpu.mask.size)
        vpu_pad = vpu_cells - int(vpu.mask.sum())
    out["vpu_padded_zeros"] = int(vpu_pad)
    out["vpu_pad_frac"] = vpu_pad / max(vpu_cells, 1)
    total_cells = tc_cells + vpu_cells
    out["total_pad_frac"] = (tc.padded_zeros + vpu_pad) / max(total_cells, 1)
    return out


def _occupancy_report(cfg, plan, kind: str, width: int) -> dict | None:
    """Hopper footprint and blocks an SM of the plan's apply at
    ``width`` (``None`` when no config is known)."""
    if cfg is None:
        return None
    from repro_torch.tune.model import (occupancy_report, sddmm_footprint,
                                        spmm_footprint)

    foot = (spmm_footprint if kind == "spmm" else sddmm_footprint)(
        width, int(plan.k))
    occ = occupancy_report(foot["smem_bytes"], foot["threads"])
    return {**occ, "width": int(width), "footprint": foot,
            "bytes_per_step": occ["smem_bytes_per_block"],
            "pipeline_depth": occ["blocks_per_sm"]}


def _measure(op, kind: str, *, width: int, backend: str, reps: int,
             timer=None) -> dict:
    """Measured side: median apply wall time (the card synchronized
    around each run) plus the analytic operation and byte counts of one
    apply at ``width``."""
    import time

    import torch

    from repro_torch.core.threshold import synchronize
    from repro_torch.obs.ledger import _op_context

    rng = np.random.default_rng(0)

    def operand(rows):
        return torch.from_numpy(rng.standard_normal(
            (rows, width)).astype(np.float32)).to(op.device)

    args = ((operand(op.k),) if kind == "spmm"
            else (operand(op.m), operand(op.k)))

    def call():
        return op(*args, backend=backend)

    if timer is None:
        def timer(fn):
            fn()                            # build / upload / warm
            ts = []
            for _ in range(reps):
                synchronize()
                t0 = time.perf_counter()
                fn()
                synchronize()
                ts.append(time.perf_counter() - t0)
            return float(np.median(ts))

    wall_s = timer(call)
    counts = _op_context(op, kind)._hlo(width)
    out = {"wall_s": wall_s, "width": width, "backend": backend,
           "counts": "analytic",
           "hlo_flops": counts["hlo_flops"],
           "hlo_hbm_bytes": counts["hlo_bytes"]}
    if wall_s > 0:
        out["hlo_gflops_per_s"] = counts["hlo_flops"] / wall_s / 1e9
    return out


def explain_plan(plan, *, cfg=None, a=None, kind: str | None = None,
                 width: int = 32) -> dict:
    """Structural report for one prepared plan (no execution).

    ``cfg`` (the :class:`~repro_torch.tune.model.TuneConfig` the plan
    was built with) adds the occupancy section, priced at ``width``;
    ``a`` (the source matrix) upgrades the density histogram to full
    vector resolution.
    """
    from repro_torch.core.formats import SpMMPlan

    if kind is None:
        kind = "spmm" if isinstance(plan, SpMMPlan) else "sddmm"
    meta = plan.meta
    return {
        "kind": kind,
        "shape": {"m": plan.m, "k": plan.k, "nnz": plan.nnz},
        "threshold": plan.threshold,
        "tc_fraction": float(meta.get("tc_ratio", 0.0)),
        "tc_nnz": int(meta.get("tc_nnz", 0)),
        "vpu_nnz": int(meta.get("vpu_nnz", 0)),
        "density_hist": _window_hist(plan, a),
        "reorder": meta.get("reorder"),
        "segments": _segment_report(plan),
        "padding": _padding_report(plan, kind),
        "occupancy": _occupancy_report(cfg, plan, kind, width),
        "tune_source": getattr(cfg, "source", None),
        "measured": None,
    }


def _explain_op(op, kind: str, *, a=None, measure: bool, width: int,
                backend: str | None, reps: int, timer=None) -> dict:
    report = explain_plan(op.plan, cfg=op.tune_config, a=a, kind=kind,
                          width=width)
    arrays = getattr(op, "arrays", None)
    if hasattr(arrays, "view_nbytes"):
        # Per-view resident/lazy device-byte status (PlanArrays).
        report["memory"] = arrays.memory()
    if measure:
        report["measured"] = _measure(
            op, kind, width=width,
            backend=op.spec.backend if backend is None else backend,
            reps=reps, timer=timer)
    return report


def explain_spmm(target, *, a=None, measure: bool = False, width: int = 32,
                 backend: str | None = None, reps: int = 3, timer=None,
                 spec=None) -> dict:
    """Explain an SpMM plan/operator/matrix.

    ``target`` may be a :class:`~repro_torch.core.spmm.LibraSpMM`, a
    prepared :class:`~repro_torch.core.formats.SpMMPlan`, or a raw
    :class:`~repro_torch.sparse.matrix.SparseCSR` (an operator is built
    under ``spec``, on the card by default). ``measure=True`` times the
    apply on ``backend`` (the operator's own by default) and attaches
    the analytic counts.
    """
    from repro_torch.core.formats import SpMMPlan
    from repro_torch.core.spmm import LibraSpMM
    from repro_torch.sparse.matrix import SparseCSR

    if isinstance(target, SpMMPlan):
        return explain_plan(target, a=a, kind="spmm", width=width)
    if isinstance(target, SparseCSR):
        target, a = LibraSpMM(target, spec=spec), target
    return _explain_op(target, "spmm", a=a, measure=measure, width=width,
                       backend=backend, reps=reps, timer=timer)


def explain_sddmm(target, *, a=None, measure: bool = False, width: int = 32,
                  backend: str | None = None, reps: int = 3, timer=None,
                  spec=None) -> dict:
    """SDDMM counterpart of :func:`explain_spmm`."""
    from repro_torch.core.formats import SDDMMPlan
    from repro_torch.core.sddmm import LibraSDDMM
    from repro_torch.sparse.matrix import SparseCSR

    if isinstance(target, SDDMMPlan):
        return explain_plan(target, a=a, kind="sddmm", width=width)
    if isinstance(target, SparseCSR):
        target, a = LibraSDDMM(target, spec=spec), target
    return _explain_op(target, "sddmm", a=a, measure=measure, width=width,
                       backend=backend, reps=reps, timer=timer)


def explain_entry(registry, name: str, op: str = "spmm", **kw) -> dict:
    """Explain a :class:`~repro_torch.serve.registry.GraphRegistry`
    entry's operator (batched entries only — sharded entries carry
    per-shard plans; explain those via :func:`explain_partition`)."""
    entry = registry.resolve(name)
    fn = entry.op(op)
    if entry.sharded:
        raise ValueError(f"{name!r} is sharded; use explain_partition on "
                         f"its SpMMPartition")
    report = (explain_spmm if op == "spmm" else explain_sddmm)(fn.op, **kw)
    report["registry"] = {"name": name, "key": entry.key[:10],
                          "mode": entry.mode, "warmed": entry.warmed}
    return report


def explain_partition(part) -> dict:
    """Shard-level report for a :mod:`repro_torch.dist.partition`
    partition: per-shard nnz/segment balance and halo waste."""
    meta = part.meta
    halo = meta.get("halo_rows", [])
    nnz = meta.get("shard_nnz", [])
    return {
        "kind": "partition",
        "n_shards": len(nnz),
        "shard_nnz": [int(x) for x in nnz],
        "reorder": meta.get("reorder"),
        "nnz_balance": meta.get("balance"),
        "segment_balance": meta.get("segment_balance"),
        "shard_segments": meta.get("shard_segments"),
        "halo_rows": [int(x) for x in halo],
        "halo_waste_frac": float(sum(halo)) / max(float(sum(nnz)), 1.0),
    }


# ------------------------------------------------------------ render ---
def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def render_table(report: dict, *, title: str | None = None) -> str:
    """Render an explain report as an aligned two-column text table."""
    rows: list[tuple[str, str]] = []
    kind = report.get("kind", "?")
    shape = report.get("shape", {})
    rows.append(("operator", kind))
    if shape:
        rows.append(("shape", f"{shape['m']}x{shape['k']} "
                              f"nnz={shape['nnz']}"))
    if "threshold" in report:
        rows.append(("threshold", _fmt(report["threshold"])))
    if "tc_fraction" in report:
        rows.append(("tc_fraction", _fmt(report["tc_fraction"])))
        rows.append(("tc/vpu nnz", f"{report['tc_nnz']}/"
                                   f"{report['vpu_nnz']}"))
    dh = report.get("density_hist")
    if dh:
        rows.append(("window_density", _fmt(dh["window_density"])))
        rows.append(("vec_occupancy[1..8]",
                     " ".join(str(c) for c in dh["vector_occupancy"])))
    ro = report.get("reorder")
    if ro:
        if ro.get("enabled"):
            rows.append(("reorder", f"chosen ({ro.get('mode', '?')}): "
                                    f"tc_frac {ro['tc_frac_before']:.3f}"
                                    f" -> {ro['tc_frac_after']:.3f}"))
            rows.append(("reorder_density",
                         f"{ro['window_density_before']:.3f} -> "
                         f"{ro['window_density_after']:.3f}"))
            if "occupancy_before" in ro:
                rows.append(("occupancy_before[1..8]",
                             " ".join(str(c)
                                      for c in ro["occupancy_before"])))
                rows.append(("occupancy_after[1..8]",
                             " ".join(str(c)
                                      for c in ro["occupancy_after"])))
        else:
            why = (f"gain {ro['gain']:.3f}" if "gain" in ro
                   else ro.get("mode", "off"))
            rows.append(("reorder", f"skipped ({why})"))
    segs = report.get("segments")
    if segs:
        for stream in ("tc", "vpu"):
            s = segs.get(stream)
            if s is None:
                rows.append((f"{stream}_segments", "off"))
            else:
                rows.append((f"{stream}_segments",
                             f"{s['nseg']} (limit {s['limit']}, atomic "
                             f"{s['atomic_frac']:.2f}, max/mean "
                             f"{s['balance']['max_over_mean']:.3f})"))
    pad = report.get("padding")
    if pad:
        rows.append(("padding", f"tc {pad['tc_pad_frac']:.3f}, vpu "
                                f"{pad['vpu_pad_frac']:.3f}, total "
                                f"{pad['total_pad_frac']:.3f}"))
    occ = report.get("occupancy")
    if occ:
        rows.append(("smem_per_block", f"{occ['bytes_per_step']} B "
                                       f"(budget {occ['budget_bytes']}, "
                                       f"n={occ['width']})"))
        rows.append(("blocks_per_sm",
                     f"{occ['pipeline_depth']} "
                     f"({'fits' if occ['fits'] else 'OVER BUDGET'})"))
    mem = report.get("memory")
    if mem:
        for view, st in sorted(mem["views"].items()):
            if st["resident_keys"] == 0:
                status = "lazy"
            elif st["resident_keys"] == st["keys"]:
                status = "resident"
            else:
                status = "partial"
            rows.append((f"mem_{view}",
                         f"{status} {st['resident_bytes']}/{st['bytes']} B "
                         f"({st['resident_keys']}/{st['keys']} arrays)"))
        rows.append(("mem_resident", f"{mem['resident_bytes']}/"
                                     f"{mem['total_bytes']} B"))
    meas = report.get("measured")
    if meas:
        rows.append(("measured_wall", f"{meas['wall_s'] * 1e6:.1f} us "
                                      f"(n={meas['width']}, "
                                      f"{meas['backend']})"))
        if "hlo_flops" in meas:
            rows.append(("flops (analytic)", _fmt(meas["hlo_flops"])))
            rows.append(("bytes (analytic)", _fmt(meas["hlo_hbm_bytes"])))
        if "hlo_gflops_per_s" in meas:
            rows.append(("gflops_per_s", _fmt(meas["hlo_gflops_per_s"])))
    if report.get("kind") == "partition":
        rows = [("operator", "partition"),
                ("n_shards", _fmt(report["n_shards"])),
                ("shard_nnz", " ".join(map(str, report["shard_nnz"]))),
                ("nnz max/mean",
                 _fmt(report["nnz_balance"]["max_over_mean"])),
                ("halo_rows", " ".join(map(str, report["halo_rows"]))),
                ("halo_waste_frac", _fmt(report["halo_waste_frac"]))]
        sb = report.get("segment_balance")
        if sb:
            rows.append(("segment max/mean", _fmt(sb["max_over_mean"])))
        ro = report.get("reorder")
        if ro:
            rows.append(("reorder",
                         (f"chosen: tc_frac {ro['tc_frac_before']:.3f} -> "
                          f"{ro['tc_frac_after']:.3f}")
                         if ro.get("enabled") else "skipped"))
    w = max(len(k) for k, _ in rows)
    lines = [f"{k:>{w}} | {v}" for k, v in rows]
    bar = "-" * max(len(line) for line in lines)
    head = [title, bar] if title else [bar]
    return "\n".join(head + lines + [bar])
