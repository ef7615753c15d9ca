#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases:

0. Device and build: print the card's name and power limit, build the
   four Hopper kernels from ``src/repro_torch/kernels/csrc`` and print the
   build time. Exits non-zero when there is no CUDA device.
1. Each kernel against its plain PyTorch twin on the card, on the plan
   tables of the matrices below: exactly on integer-valued data in
   [-4, 4], within the stated tolerance on random fp32 data.
2. Operators at full size on ``mixed_csr(16384, 16384, seed=3)``:
   ``LibraSpMM`` at n=256 and ``LibraSDDMM`` at kf=128, with the configs
   that put about 90% (SpMM) and all (SDDMM) non-zeros on Tensor Cores.
3. GNN inference on a graph of ogbn-arxiv's size (169,343 nodes,
   2.29M edges, ``power_law_csr(169343, 169343, 13.7, seed=1)``): GCN and
   AGNN ``[128, 256, 256, 40]`` (OGB's GCN baseline width) answer three
   requests each, plus ``LibraSDDMM`` with a config that puts 97.8% of the
   edges on Tensor Cores.

Phases 2 and 3 are the main path: every kernel's launch counter is set
to 0 just before them and read just after, and each kernel must have
launched. Outputs are checked against the port's plain ``backend="torch"``
path on the card. Then each kernel is timed (CUDA events, median of 20
launches) beside its plain twin, one PyTorch library call computing the
same stream's function, and its bound (compulsory bytes over 3.35 TB/s
or operations over the data-sheet peak, whichever is larger). Last, one
steady GCN and one AGNN request run under ``torch.profiler``: device busy
time, idle share and the kernels that take the most device time.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises.

fp32 matrix products in the plain versions run in full fp32: this script
sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``. Only the two Tensor Core
kernels use TF32, by design.
"""
from __future__ import annotations

import copy
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM bandwidth, TF32 Tensor Core,
# FP32 CUDA core.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"tf32": 495e12, "fp32": 67e12}

# Tolerances, each with its reason:
# - integer-valued data in [-4, 4]: every kernel equals its twin exactly
#   (TF32 holds such values exactly and fp32 sums of small integers are
#   exact in any order);
# - CUDA-core kernels (fp32 FMA) on random data: rtol 1e-5 and
#   atol 1e-5·max|ref|, for fp32 sums taken in another order;
# - Tensor Core kernels (TF32, 10 mantissa bits) on random data and any
#   output a TF32 stream feeds: max|Δ| ≤ 2e-2·max|ref|;
# - outputs fed by fp32 streams only: max|Δ| ≤ 1e-4·max|ref|.
FP32_RTOL = 1e-5
TF32_REL = 2e-2
FP32_PATH_REL = 1e-4

KERNEL_INFO = {
    "spmm_mxu": ("src/repro/kernels/spmm_mxu.py:121", "tf32"),
    "spmm_vpu": ("src/repro/kernels/spmm_vpu.py:73", "fp32"),
    "sddmm_mxu": ("src/repro/kernels/sddmm_mxu.py:88", "tf32"),
    "sddmm_vpu": ("src/repro/kernels/sddmm_vpu.py:60", "fp32"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")

    from repro_torch import kernels
    from repro_torch.api import ExecSpec
    from repro_torch.core.sddmm import LibraSDDMM
    from repro_torch.core.spmm import LibraSpMM
    from repro_torch.kernels import _build, ref
    from repro_torch.models.gnn import AGNN, GCN, GraphOps, gcn_norm_edges
    from repro_torch.sparse import mixed_csr, power_law_csr
    from repro_torch.tune.model import TuneConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ------------------------------------------------ phase 0: device, build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        "allow_tf32 set False for matmul and cudnn (plain versions run "
        "full fp32)")
    t0 = time.perf_counter()
    _build.library()
    log(f"phase 0: kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.last_build_seconds:.1f} s)")
    for line in _build.last_build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    # ------------------------------------------------ host: matrices, plans
    def timed(label, fn):
        t = time.perf_counter()
        out = fn()
        log(f"host: {label} {time.perf_counter() - t:.1f} s")
        return out

    a_mix = timed("mixed_csr(16384, 16384, seed=3)",
                  lambda: mixed_csr(16384, 16384, seed=3))
    graph = timed("power_law_csr(169343, 169343, 13.7, seed=1)",
                  lambda: power_law_csr(169343, 169343, 13.7, seed=1))
    log(f"host: mixed nnz={a_mix.nnz}, graph nnz={graph.nnz}")
    spmm_mix = timed("LibraSpMM plan (mixed)", lambda: LibraSpMM(
        a_mix, spec=ExecSpec(tune=TuneConfig(
            threshold=6, bk=32, ts_tile=32, ts=4, cs=128))))
    sddmm_mix = timed("LibraSDDMM plan (mixed)", lambda: LibraSDDMM(
        a_mix, spec=ExecSpec(tune=TuneConfig(
            threshold=1, bk=16, ts_tile=32, ts=8, cs=128))))
    gops = timed("GraphOps plans A, A^T, SDDMM(A) (graph, tune=off)",
                 lambda: GraphOps(graph))
    sddmm_graph = timed("LibraSDDMM plan (graph)", lambda: LibraSDDMM(
        graph, spec=ExecSpec(tune=TuneConfig(
            threshold=8, bk=16, ts_tile=32, ts=2, cs=32))))
    for label, plan in (("LibraSpMM mixed", spmm_mix.plan),
                        ("LibraSDDMM mixed", sddmm_mix.plan),
                        ("GraphOps SpMM", gops.arrs.plan),
                        ("GraphOps SDDMM", gops.arrs_sd.plan),
                        ("LibraSDDMM graph", sddmm_graph.plan)):
        log(f"plan: {label}: tc_nnz={plan.meta['tc_nnz']} "
            f"vpu_nnz={plan.meta['vpu_nnz']} "
            f"tc_ratio={plan.meta['tc_ratio']:.4f}")

    norm = torch.from_numpy(gcn_norm_edges(graph)).to(dev)

    def seeded(seed, *shape, integers=False):
        g = torch.Generator().manual_seed(seed)
        if integers:
            t = torch.randint(-4, 5, shape, generator=g).float()
        else:
            t = torch.randn(*shape, generator=g)
        return t.to(dev)

    # ------------------------------------------------ phase 1: kernel twins
    def compare(label, out, want, kind):
        torch.cuda.synchronize()
        if out.shape != want.shape:
            fail(f"{label}: shape {tuple(out.shape)} != {tuple(want.shape)}")
        if not bool(torch.isfinite(out).all()):
            fail(f"{label}: non-finite output")
        err = (out - want).abs().max().item() if out.numel() else 0.0
        scale = want.abs().max().item() if want.numel() else 0.0
        if kind == "exact":
            ok, tol = err == 0.0, "exact"
        elif kind == "fp32":
            ok = bool(torch.allclose(out, want, rtol=FP32_RTOL,
                                     atol=FP32_RTOL * scale))
            tol = f"rtol={FP32_RTOL:g} atol={FP32_RTOL:g}*max|ref|"
        else:
            rel = {"tf32": TF32_REL, "fp32_path": FP32_PATH_REL}[kind]
            ok, tol = err <= rel * scale, f"{rel:g}*max|ref|"
        log(f"  {label}: max|err|={err:.3e} max|ref|={scale:.3e} "
            f"tol={tol} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{label}: max|err| {err} outside {tol}")
        return err

    def int_edges(a, seed):
        return seeded(seed, a.nnz, integers=True)

    def element_tables(t):
        """The CUDA-core SDDMM operands the apply launches: the Cs segment
        tables when the plan groups tiles, else the per-tile tables."""
        if "vpu_seg_rows" in t:
            return t["vpu_seg_rows"], t["vpu_seg_cols"]
        return t["vpu_rows"], t["vpu_cols"]

    # Every width the main path gives a kernel (GCN layers aggregate at
    # n=256 and 40, AGNN at 128 and 256; AGNN scores at kf=128 and 256),
    # plus one width off the float4 path (n=37, kf=30) for the scalar code.
    spmm_cases = {   # label → (operator tables, matrix, n)
        "mixed LibraSpMM n=256": (spmm_mix.arrays, a_mix, 256),
        "mixed LibraSpMM n=37": (spmm_mix.arrays, a_mix, 37),
        "graph GraphOps A n=256": (gops.arrs, graph, 256),
        "graph GraphOps A n=128": (gops.arrs, graph, 128),
        "graph GraphOps A n=40": (gops.arrs, graph, 40),
    }
    sddmm_cases = {  # label → (operator tables, matrix, kf)
        "mixed LibraSDDMM kf=128": (sddmm_mix.arrays, a_mix, 128),
        "mixed LibraSDDMM kf=30": (sddmm_mix.arrays, a_mix, 30),
        "graph GraphOps SDDMM kf=128": (gops.arrs_sd, graph, 128),
        "graph GraphOps SDDMM kf=256": (gops.arrs_sd, graph, 256),
        "graph LibraSDDMM kf=128": (sddmm_graph.arrays, graph, 128),
    }
    twin_err: dict[tuple[str, str], float] = {}
    log("phase 1: each kernel against its plain twin on the card")
    for label, (pa, a, n) in spmm_cases.items():
        seg = pa.for_backend("cuda", revalue=True)
        for data in ("integer", "random"):
            if data == "integer":
                ev = int_edges(a, 11)
                b = seeded(12, a.k, n, integers=True)
            else:
                ev = norm if a is graph else torch.from_numpy(a.data).to(dev)
                b = seeded(13, a.k, n)
            t = ref.revalue_spmm_arrays(seg, ev)
            nseg = t["tc_seg_rank"].shape[0]
            kind = "exact" if data == "integer" else None
            twin_err[("spmm_mxu", label)] = compare(
                f"spmm_mxu {label} {data}",
                kernels.spmm_mxu(t["tc_seg_vals"], t["tc_seg_cols"],
                                 t["tc_seg_rank"], b, n_active=nseg,
                                 unique_ranks=True),
                ref.spmm_tc_compact_ref(t["tc_seg_vals"], t["tc_seg_cols"],
                                        t["tc_seg_rank"], b, nseg),
                kind or "tf32")
            twin_err[("spmm_vpu", label)] = compare(
                f"spmm_vpu {label} {data}",
                kernels.spmm_vpu(t["vpu_seg_vals"], t["vpu_seg_cols"], b),
                ref.spmm_tile_partials(t["vpu_seg_vals"],
                                       t["vpu_seg_cols"], b),
                kind or "fp32")
    # K2 multiplies every slot, padding (value 0, column 0) included, as
    # its twin does: with non-finite B rows and an exact-zero weight both
    # give the same inf/NaN pattern, bit for bit.
    t = ref.revalue_spmm_arrays(gops.arrs.for_backend("cuda", revalue=True),
                                int_edges(graph, 14))
    vv, vc = t["vpu_seg_vals"].clone(), t["vpu_seg_cols"]
    real = torch.nonzero(vv.flatten()).flatten()
    vv.view(-1)[real[0]] = 0.0
    b = seeded(15, graph.k, 40, integers=True)
    b[0] = float("inf")
    b[vc.flatten()[real[1]], :8] = float("nan")
    out, want = kernels.spmm_vpu(vv, vc, b), ref.spmm_tile_partials(vv, vc, b)
    same = (out == want) | (out.isnan() & want.isnan())
    torch.cuda.synchronize()
    if not bool(same.all()) or not bool(want.isnan().any()):
        fail("spmm_vpu with non-finite B rows: kernel and twin differ")
    log(f"  spmm_vpu non-finite B, exact-zero weight: "
        f"{int(want.isnan().sum())} NaN and {int(want.isinf().sum())} inf "
        "entries, identical to the twin")
    for label, (pa, a, kf) in sddmm_cases.items():
        t = pa.for_backend("cuda")
        for data in ("integer", "random"):
            integers = data == "integer"
            x = seeded(21, a.m, kf, integers=integers)
            y = seeded(22, a.k, kf, integers=integers)
            kind = "exact" if integers else None
            twin_err[("sddmm_mxu", label)] = compare(
                f"sddmm_mxu {label} {data}",
                kernels.sddmm_mxu(t["tc_seg_cols"], t["tc_seg_bitmap"],
                                  t["tc_seg_window"], x, y),
                ref.sddmm_tc_ref(t["tc_seg_cols"], t["tc_seg_bitmap"],
                                 t["tc_seg_window"], x, y),
                kind or "tf32")
            rows, cols = element_tables(t)
            twin_err[("sddmm_vpu", label)] = compare(
                f"sddmm_vpu {label} {data}", kernels.sddmm_vpu(rows, cols, x, y),
                ref.sddmm_pair_scores(rows, cols, x, y), kind or "fp32")

    # ------------------------------------------------ phases 2-3: main path
    def tol_kind(*plans):
        return "tf32" if any(p.meta["tc_nnz"] for p in plans) else "fp32_path"

    gcn = GCN([128, 256, 256, 40],
              generator=torch.Generator().manual_seed(0)).to(dev)
    agnn = AGNN([128, 256, 256, 40],
                generator=torch.Generator().manual_seed(1)).to(dev)
    requests = [seeded(100 + i, graph.m, 128) for i in range(3)]
    b_mix = seeded(31, a_mix.k, 256)
    x_mix, y_mix = seeded(32, a_mix.m, 128), seeded(33, a_mix.k, 128)
    x_graph = seeded(34, graph.m, 128)

    results = {}
    counts_by_step = {}
    latency = {"GCN": [], "AGNN": []}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.no_grad():
        def step(label, fn):
            before = kernels.launch_counts()
            results[label] = fn()
            after = kernels.launch_counts()
            counts_by_step[label] = {k: after[k] - before[k] for k in after}

        step("LibraSpMM mixed n=256", lambda: spmm_mix(b_mix))
        step("LibraSDDMM mixed kf=128", lambda: sddmm_mix(x_mix, y_mix))
        for name, model, args in (("GCN", gcn, (norm,)), ("AGNN", agnn, ())):
            for i, x in enumerate(requests):
                def serve(model=model, x=x, args=args, name=name):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = model(gops, x, *args)
                    torch.cuda.synchronize()
                    latency[name].append((time.perf_counter() - t) * 1e3)
                    return out
                step(f"{name} request {i}", serve)
        step("LibraSDDMM graph kf=128", lambda: sddmm_graph(x_graph, x_graph))
    torch.cuda.synchronize()
    main_counts = kernels.launch_counts()
    log(f"phases 2-3 (main path) launches: {main_counts}")
    for label, c in counts_by_step.items():
        log(f"  {label}: {c}")
    missing = [k for k, v in main_counts.items() if v <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    for name, ms in latency.items():
        log(f"phase 3: {name} [128, 256, 256, 40] per-request latency ms: "
            + ", ".join(f"{v:.2f}" for v in ms))
    log(f"phases 2-3: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    log("phases 2-3: outputs against the plain backend='torch' path on "
        "the card")
    gops_plain = copy.copy(gops)
    gops_plain.backend = "torch"
    with torch.no_grad():
        compare("LibraSpMM mixed n=256", results["LibraSpMM mixed n=256"],
                spmm_mix(b_mix, backend="torch"), tol_kind(spmm_mix.plan))
        compare("LibraSDDMM mixed kf=128",
                results["LibraSDDMM mixed kf=128"],
                sddmm_mix(x_mix, y_mix, backend="torch"),
                tol_kind(sddmm_mix.plan))
        for i, x in enumerate(requests):
            out = results[f"GCN request {i}"]
            if tuple(out.shape) != (graph.m, 40):
                fail(f"GCN logits shape {tuple(out.shape)}")
            compare(f"GCN request {i} logits", out,
                    gcn(gops_plain, x, norm), tol_kind(gops.arrs.plan))
            out = results[f"AGNN request {i}"]
            if tuple(out.shape) != (graph.m, 40):
                fail(f"AGNN logits shape {tuple(out.shape)}")
            compare(f"AGNN request {i} logits", out, agnn(gops_plain, x),
                    tol_kind(gops.arrs.plan, gops.arrs_sd.plan))
        compare("LibraSDDMM graph kf=128",
                results["LibraSDDMM graph kf=128"],
                sddmm_graph(x_graph, x_graph, backend="torch"),
                tol_kind(sddmm_graph.plan))

    # ------------------------------------------------ timing and bounds
    def median_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for s, e in ev:
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)

    coo_rows = {id(a): a.to_coo()[0] for a in (a_mix, graph)}

    def stream_csr(a, pos, vals):
        """CSR tensor of the non-zeros at canonical positions ``pos``."""
        p = np.sort(pos[pos >= 0].astype(np.int64))
        rows = coo_rows[id(a)][p]
        crow = np.zeros(a.m + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=a.m), out=crow[1:])
        v = vals[torch.from_numpy(p).to(dev)]
        return torch.sparse_csr_tensor(
            torch.from_numpy(crow).to(dev),
            torch.from_numpy(a.indices[p].astype(np.int64)).to(dev), v,
            size=(a.m, a.k))

    def bound(nbytes, ops, kind):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[kind] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    entries = []

    def record(name, label, ms, plain_ms, library_ms, nb, ops):
        replaces, kind = KERNEL_INFO[name]
        bound_ms, bound_by = bound(nb, ops, kind)
        lib = "null" if library_ms is None else f"{library_ms:.4f}"
        log(f"  {name} [{label}]: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({nb / 1e6:.1f} MB, {ops / 1e9:.2f} G {kind} ops)")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": main_counts[name],
            "max_abs_err": twin_err[(name, label)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})

    log("timing: kernel and plain twin, CUDA events, median of 20 / 3 runs")
    # K1 at LibraSpMM mixed n=256 (the operator's own values).
    t = spmm_mix.arrays.for_backend("cuda")
    nseg = t["tc_seg_rank"].shape[0]
    k1 = (t["tc_seg_vals"], t["tc_seg_cols"], t["tc_seg_rank"], b_mix)
    k1_out = kernels.spmm_mxu(*k1, n_active=nseg, unique_ranks=True)
    vals = torch.from_numpy(a_mix.data).to(dev)
    lib_a = stream_csr(a_mix, spmm_mix.arrays.host["tc_pos"].ravel(), vals)
    record("spmm_mxu", "mixed LibraSpMM n=256",
           median_ms(lambda: kernels.spmm_mxu(*k1, n_active=nseg,
                                              unique_ranks=True)),
           median_ms(lambda: ref.spmm_tc_compact_ref(*k1, nseg), reps=3),
           median_ms(lambda: torch.sparse.mm(lib_a, b_mix)),
           nbytes(*k1, k1_out),
           2 * int(torch.count_nonzero(t["tc_seg_vals"])) * b_mix.shape[1])
    # K2 at a GCN layer: GraphOps A with normalized edges, n=256.
    t = ref.revalue_spmm_arrays(gops.arrs.for_backend("cuda", revalue=True),
                                norm)
    b_gcn = seeded(41, graph.k, 256)
    k2 = (t["vpu_seg_vals"], t["vpu_seg_cols"], b_gcn)
    k2_out = kernels.spmm_vpu(*k2)
    lib_a = stream_csr(graph, gops.arrs.host["vpu_pos"].ravel(), norm)
    record("spmm_vpu", "graph GraphOps A n=256",
           median_ms(lambda: kernels.spmm_vpu(*k2)),
           median_ms(lambda: ref.spmm_tile_partials(*k2), reps=3),
           median_ms(lambda: torch.sparse.mm(lib_a, b_gcn)),
           nbytes(*k2, k2_out),
           2 * int(torch.count_nonzero(t["vpu_seg_vals"])) * 256)
    # K3 at LibraSDDMM graph kf=128; K4 at the AGNN first layer (kf=128).
    ones = torch.ones(graph.nnz, device=dev)
    for name, pa, label in (
            ("sddmm_mxu", sddmm_graph.arrays, "graph LibraSDDMM kf=128"),
            ("sddmm_vpu", gops.arrs_sd, "graph GraphOps SDDMM kf=128")):
        t = pa.for_backend("cuda")
        host = pa.host
        if name == "sddmm_mxu":
            args = (t["tc_seg_cols"], t["tc_seg_bitmap"], t["tc_seg_window"],
                    x_graph, x_graph)
            kern, twin = kernels.sddmm_mxu, ref.sddmm_tc_ref
            pos = host["tc_out_pos"].ravel()
            useful = int(np.count_nonzero(pos >= 0))
        else:
            args = (*element_tables(t), x_graph, x_graph)
            kern, twin = kernels.sddmm_vpu, ref.sddmm_pair_scores
            pos = np.where(host["vpu_mask"], host["vpu_out_pos"], -1).ravel()
            useful = int(host["vpu_mask"].sum())
        out = kern(*args)
        lib_a = stream_csr(graph, pos, ones)
        try:  # the yardstick only: the port never calls it
            library_ms = median_ms(lambda: torch.sparse.sampled_addmm(
                lib_a, x_graph, x_graph.t(), beta=0.0))
        except RuntimeError as exc:
            log(f"  {name}: torch.sparse.sampled_addmm unavailable ({exc}); "
                "library_ms null")
            library_ms = None
        record(name, label, median_ms(lambda: kern(*args)),
               median_ms(lambda: twin(*args), reps=3), library_ms,
               nbytes(*args[:-1], out), 2 * useful * x_graph.shape[1])

    # ------------------------------------------------ profile: one request
    # Device time by kernel for one steady request of each model. This is
    # a measurement, not a check: a profiler that records no device time
    # is reported as such.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    log("profile: one steady request per model (torch.profiler, device "
        "time by kernel)")
    for name, run in (("GCN", lambda: gcn(gops, requests[0], norm)),
                      ("AGNN", lambda: agnn(gops, requests[0]))):
        with torch.no_grad(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        # Device-side events only (kernels, memcpy, memset): a CPU op's
        # device time repeats that of the kernels it launched.
        rows = sorted(((getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0)) / 1e3,
                        e.count, e.key) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA), reverse=True)
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if not rows or not spans:
            log(f"  {name}: wall {wall_ms:.3f} ms (profiled); the profiler "
                "recorded no device time")
            continue
        # Busy time is the union of the device intervals of this one run;
        # the span runs from its first device event's start to its last
        # one's end, so busy / span is the device's share of the request
        # once work has reached it, and busy / wall the share of the whole
        # profiled request, host launch overhead included.
        busy_us, cur_s, cur_e = 0.0, *spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy_us += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy_us += cur_e - cur_s
        busy_ms = busy_us / 1e3
        span_ms = (max(e for _, e in spans) - spans[0][0]) / 1e3
        log(f"  {name} (one profiled request): wall {wall_ms:.3f} ms, "
            f"device span {span_ms:.3f} ms, device busy {busy_ms:.3f} ms; "
            f"idle share of span {1 - busy_ms / span_ms:.3f}, of wall "
            f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
        for ms, count, key in rows[:10]:
            log(f"    {ms:9.4f} ms  x{count:<4d} {key[:90]}")

    log(f"wall time {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
