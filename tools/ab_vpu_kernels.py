#!/usr/bin/env python3
"""A/B timings of K2 (``spmm_vpu``) and K4 (``sddmm_vpu``) variants on one
NVIDIA GPU, at the GNN main path's shapes.

Run from the repository root::

    python3 tools/ab_vpu_kernels.py [--baseline DIR]

The graph is ``power_law_csr(169343, 169343, 13.7, seed=1)`` with the
default ``tune="off"`` plans, as in ``chip_smoke.py`` phase 3. Each
variant is built by ``nvcc`` into its own library under
``build/ab_vpu/`` and its launch entry point is called on the plan's
tables:

- the kernels in ``kernels/csrc``, and copies of them with one change
  each (``EDITS``: gathers in flight a lane, warps a block, stores,
  cache policies), each at the
  slice width its wrapper chooses and at the others in ``K2_WIDTHS`` and
  ``K4_WIDTHS``;
- with ``--baseline DIR``, the sources of an earlier commit in DIR, e.g.
  ``git show <commit>:src/repro_torch/kernels/csrc/spmm_vpu.cu``, the same
  for ``sddmm_vpu.cu`` and ``common.cuh``, written into one directory.
  Their entry points take no length and no slice width (the first
  kernels' interface). GCN and AGNN requests are then also timed with
  both generations of the kernels, in the order old, new, new, old.

The committed kernels also run on the same tables with every column
folded into the first 4096 rows of B or Y, where every gather hits L2:
the time the kernels would take with no L2 miss.

Every variant's output is checked against the plain twin (rtol 1e-5) and
each is timed with CUDA events, median of 20 launches, in two passes:
the list forward, then backward. The card's name and power limit are
printed first.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.api import ExecSpec  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.sddmm_vpu import slice_feats  # noqa: E402
from repro_torch.kernels.spmm_vpu import slice_cols  # noqa: E402
from repro_torch.models.gnn import (  # noqa: E402
    AGNN, GCN, GraphOps, gcn_norm_edges)
from repro_torch.sparse import power_law_csr  # noqa: E402

OUT = ROOT / "build" / "ab_vpu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OLD_SIG = {"spmm_vpu_launch": (_P, _P, _P, _P, _L, _I, _I, _I, _P),
           "sddmm_vpu_launch": (_P, _P, _P, _P, _P, _L, _I, _I, _P)}

# Variant -> textual edits, made in each source that holds the text; ""
# is the source as committed.
EDITS = {
    "": (),
    "K2 2 in flight": (("kUnroll = 4;  // B", "kUnroll = 2;  // B"),),
    "K2 8 in flight": (("kUnroll = 4;  // B", "kUnroll = 8;  // B"),),
    "K4 4 in flight": (("kUnroll = 2;  // el", "kUnroll = 4;  // el"),),
    "K4 8 in flight": (("kUnroll = 2;  // el", "kUnroll = 8;  // el"),),
    "8-warp blocks": (("kWarps = 4;", "kWarps = 8;"),),
    "plain stores": (("__stcs(o, ", "*o = ("),
                     ("__stcs(reinterpret_cast<float4*>(o),",
                      "*reinterpret_cast<float4*>(o) = ("),
                     ("__ldcs(out + e)", "out[e]"),
                     ("__stcs(out + e, mine);", "out[e] = mine;")),
    "gathers with an L2 evict_last policy": (
        ("const float4 t = __ldcg(reinterpret_cast<const float4*>(p));",
         "float4 t;\n    asm(\"{ .reg .b64 pol; createpolicy.fractional."
         "L2::evict_last.b64 pol, 1.0; ld.global.cg.L2::cache_hint.v4.f32 "
         "{%0, %1, %2, %3}, [%4], pol; }\" : \"=f\"(t.x), \"=f\"(t.y), "
         "\"=f\"(t.z), \"=f\"(t.w) : \"l\"(p));"),
        ("const float4 bb =\n              __ldcg(reinterpret_cast<const "
         "float4*>(y + cc * kf + f));",
         "float4 bb;\n          asm(\"{ .reg .b64 pol; createpolicy."
         "fractional.L2::evict_last.b64 pol, 1.0; ld.global.cg.L2::"
         "cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], pol; }\" : \"=f\""
         "(bb.x), \"=f\"(bb.y), \"=f\"(bb.z), \"=f\"(bb.w) : \"l\""
         "(y + cc * kf + f));")),
    "K4 X via L2 only": (
        ("__ldg(reinterpret_cast<const float4*>(x + r * kf + f))",
         "__ldcg(reinterpret_cast<const float4*>(x + r * kf + f))"),),
}
# Slice widths timed at each shape (K2: columns, any multiple of 4 up to
# 128; K4: features, 4 x a power of two).
K2_WIDTHS = {256: (32, 64, 128), 128: (32, 64, 128), 40: (24, 40)}
K4_WIDTHS = {128: (32, 64, 128), 256: (32, 64, 128)}
HOT = 4096


def _dir(tag: str) -> pathlib.Path:
    return OUT / ("".join(c if c.isalnum() else "_" for c in tag) or "new")


def build(tag: str, src_dir: pathlib.Path, edits) -> subprocess.Popen:
    d = _dir(tag)
    d.mkdir(parents=True, exist_ok=True)
    (d / "common.cuh").write_text((src_dir / "common.cuh").read_text())
    unused = dict(edits)
    for name in ("spmm_vpu.cu", "sddmm_vpu.cu"):
        text = (src_dir / name).read_text()
        for old, new in edits:
            if old in text:
                text = text.replace(old, new)
                unused.pop(old, None)
        (d / name).write_text(text)
    if unused:
        raise SystemExit(f"{tag}: no source holds {list(unused)}")
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
         str(d / "lib.so"), str(d / "spmm_vpu.cu"), str(d / "sddmm_vpu.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(tag: str, sig) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_dir(tag) / "lib.so"))
    for name, argtypes in sig.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


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


def stream():
    return _build.stream_handle(torch.device("cuda"))


def k2_call(lib, old, vals, cols, lens, b, out, w=None):
    ntiles, ts = vals.shape
    n = b.shape[1]
    if old:
        return lambda: lib.spmm_vpu_launch(
            vals.data_ptr(), cols.data_ptr(), b.data_ptr(), out.data_ptr(),
            ntiles, ts, n, int(n % 4 == 0), stream())
    # A batch of one: every batch stride 0.
    return lambda: lib.spmm_vpu_launch(
        vals.data_ptr(), cols.data_ptr(), lens.data_ptr(), b.data_ptr(),
        out.data_ptr(), 1, ntiles, ts, n, 0, 0, 0, 0, 0, w,
        int(n % 4 == 0), stream())


def k4_call(lib, old, rows, cols, x, out, w=None):
    nel, kf = rows.numel(), x.shape[1]
    if old:
        return lambda: lib.sddmm_vpu_launch(
            rows.data_ptr(), cols.data_ptr(), x.data_ptr(), x.data_ptr(),
            out.data_ptr(), nel, kf, int(kf % 4 == 0), stream())
    # The staged form: no position table, mask or staging buffer.
    return lambda: lib.sddmm_vpu_launch(
        rows.data_ptr(), cols.data_ptr(), None, None, x.data_ptr(),
        x.data_ptr(), out.data_ptr(), None, 1, nel, kf, 0, 0, 0, 0, 0, 0, 0,
        0, w, int(kf % 4 == 0), stream())


def passes(cases):
    """Time each (label, fn) forward then backward; print both medians."""
    fwd = {label: median_ms(fn) for label, fn in cases}
    bwd = {label: median_ms(fn) for label, fn in reversed(cases)}
    for label, _ in cases:
        print(f"  {label}: {fwd[label]:.4f} / {bwd[label]:.4f} ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=pathlib.Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_vpu_kernels: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    procs = {tag: build(tag, _build.CSRC, edits)
             for tag, edits in EDITS.items()}
    if args.baseline:
        procs["baseline"] = build("baseline", args.baseline, ())
    for tag, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {tag!r}:\n{out}")
        regs = [line.strip() for line in out.splitlines()
                if "registers" in line]
        print(f"built {tag or 'new'}: {regs}", flush=True)
    libs = {tag: load(tag, OLD_SIG if tag == "baseline"
                      else {k: _build.SIGNATURES[k] for k in OLD_SIG})
            for tag in procs}
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)

    graph = power_law_csr(169343, 169343, 13.7, seed=1)
    t0 = time.perf_counter()
    gops = GraphOps(graph, spec=ExecSpec(tune="off", device="cuda"))
    print(f"GraphOps {time.perf_counter() - t0:.1f} s", flush=True)
    norm = torch.from_numpy(gcn_norm_edges(graph)).to(dev)
    t = ref.revalue_spmm_arrays(gops.arrs.for_backend("cuda", revalue=True),
                                norm)
    vals, cols, lens = t["vpu_seg_vals"], t["vpu_seg_cols"], t["vpu_len"]
    sd = gops.arrs_sd.for_backend("cuda")
    seg = "_seg" if "vpu_seg_rows" in sd else ""
    rows, ecols = sd[f"vpu{seg}_rows"], sd[f"vpu{seg}_cols"]
    # The same tables with every column folded into the first HOT rows of
    # the gathered operand: every gather then hits L2, which gives the
    # kernel's rate with no L2 miss at all.
    cols_hot, ecols_hot = cols % HOT, ecols % HOT
    gen = torch.Generator(dev).manual_seed(0)

    def check(fn, out, want, label):
        out.fill_(float("nan"))
        assert fn() == 0, label
        torch.cuda.synchronize()
        if not torch.allclose(out, want, rtol=1e-5,
                              atol=1e-5 * want.abs().max().item()):
            raise SystemExit(f"{label}: differs from the twin")

    for n in (256, 128, 40):
        b = torch.randn(graph.k, n, generator=gen, device=dev)
        out = torch.empty(vals.shape[0], n, device=dev)
        want = ref.spmm_tile_partials(vals, cols, b)
        chosen = slice_cols(graph.k, n, True)
        cases = []
        for tag, lib in libs.items():
            old = tag == "baseline"
            for w in [None] if old else sorted({chosen, *K2_WIDTHS[n]}):
                label = (f"K2 n={n} {tag or 'new'}"
                         + ("" if old else f" w={w}"))
                fn = k2_call(lib, old, vals, cols, lens, b, out, w)
                check(fn, out, want, label)
                cases.append((label, fn))
        label = f"K2 n={n} new w={chosen}, columns folded to {HOT} rows"
        fn = k2_call(libs[""], False, vals, cols_hot, lens, b, out, chosen)
        check(fn, out, ref.spmm_tile_partials(vals, cols_hot, b), label)
        cases.append((label, fn))
        print(f"K2 at n={n} (wrapper's slice width {chosen}):", flush=True)
        passes(cases)
    for kf in (128, 256):
        x = torch.randn(graph.m, kf, generator=gen, device=dev)
        out = torch.empty(rows.shape, device=dev)
        want = ref.sddmm_pair_scores(rows, ecols, x, x)
        chosen = slice_feats(graph.k, kf, True)
        cases = []
        for tag, lib in libs.items():
            old = tag == "baseline"
            for w in [None] if old else sorted({chosen, *K4_WIDTHS[kf]}):
                label = (f"K4 kf={kf} {tag or 'new'}"
                         + ("" if old else f" w={w}"))
                fn = k4_call(lib, old, rows, ecols, x, out, w)
                check(fn, out, want, label)
                cases.append((label, fn))
        label = f"K4 kf={kf} new w={chosen}, columns folded to {HOT} rows"
        fn = k4_call(libs[""], False, rows, ecols_hot, x, out, chosen)
        check(fn, out, ref.sddmm_pair_scores(rows, ecols_hot, x, x), label)
        cases.append((label, fn))
        print(f"K4 at kf={kf} (wrapper's slice width {chosen}):", flush=True)
        passes(cases)

    if "baseline" in libs:
        request_ab(libs["baseline"], gops, norm, dev)
    return 0


def request_ab(old_lib, gops, norm, dev):
    """GCN and AGNN requests with the baseline K2/K4 patched into the apply,
    against the kernels as committed: old, new, new, old."""
    from unittest import mock

    def old_spmm_vpu(vals, cols, b, *, seg_len=None):
        out = torch.empty(vals.shape[0], b.shape[1], device=dev)
        assert k2_call(old_lib, True, vals, cols, None, b, out)() == 0
        return out

    def old_sddmm_vpu(rows, cols, x, y, out_pos=None, mask=None, out=None):
        s = torch.empty(rows.shape, device=dev)
        assert old_lib.sddmm_vpu_launch(
            rows.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
            s.data_ptr(), rows.numel(), x.shape[1],
            int(x.shape[1] % 4 == 0), stream()) == 0
        # The baseline stores scores laid out as the table: the apply's
        # canonical output places them.
        return s if out_pos is None else ref.place_scores(s, out_pos, mask,
                                                          out)

    gcn = GCN([128, 256, 256, 40],
              generator=torch.Generator().manual_seed(0)).to(dev)
    agnn = AGNN([128, 256, 256, 40],
                generator=torch.Generator().manual_seed(1)).to(dev)
    x = torch.randn(gops.m, 128, generator=torch.Generator(dev).manual_seed(2),
                    device=dev)

    def request_ms(run, reps=10):
        run()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    print("requests (host clock, median of 10; old, new, new, old):",
          flush=True)
    with torch.no_grad():
        for name, run in (("GCN", lambda: gcn(gops, x, norm)),
                          ("AGNN", lambda: agnn(gops, x))):
            got = []
            for gen in ("old", "new", "new", "old"):
                if gen == "old":
                    with mock.patch.object(ops, "spmm_vpu", old_spmm_vpu), \
                            mock.patch.object(ops, "sddmm_vpu", old_sddmm_vpu):
                        got.append(request_ms(run))
                else:
                    got.append(request_ms(run))
            print(f"  {name}: " + ", ".join(f"{v:.3f}" for v in got)
                  + " ms", flush=True)


if __name__ == "__main__":
    sys.exit(main())
