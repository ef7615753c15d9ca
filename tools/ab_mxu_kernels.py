#!/usr/bin/env python3
"""A/B timings of K1 (``spmm_mxu``) and K3 (``sddmm_mxu``) variants on one
NVIDIA GPU, at the shapes where the main path gives them real work.

Run from the repository root::

    python3 tools/ab_mxu_kernels.py [--baseline DIR]

The shapes are ``chip_smoke.py``'s: K1 at ``LibraSpMM`` on
``mixed_csr(16384, 16384, seed=3)`` with n = 256, K3 at ``LibraSDDMM``
on the same matrix and on ``power_law_csr(169343, 169343, 13.7, seed=1)``
with kf = 128, each with the ``TuneConfig`` of ``chip_smoke.py``. Each
variant is built by ``nvcc`` into its own library under
``build/ab_mxu/`` and its launch entry point is called on the plan's
segment tables:

- the kernels in ``kernels/csrc``, and copies of them with one change
  each (``EDITS``: stages of the ``cp.async`` ring, block shape, stores);
  K3 also at every feature-slice width in ``K3_WIDTHS`` (128 is one pass
  over all of kf);
- with ``--baseline DIR``, the sources of an earlier commit in DIR, e.g.
  ``git show 9d8a824:src/repro_torch/kernels/csrc/spmm_mxu.cu``, the same
  for ``sddmm_mxu.cu`` and ``common.cuh``, written into one directory.
  Their entry points take no length and no slice width (the first
  kernels' interface). The three operators are then also timed with both
  generations of the kernels, in the order old, new, new, old.

The committed kernels also run on the same tables with every column
folded into the first 4096 rows of B or Y, where every gather hits L2:
the time the kernels would take with no L2 miss.

Every variant's output is checked against the plain twin (max|Δ| ≤
2e-2·max|ref|, the TF32 tolerance) and each is timed with CUDA events,
median of 20 launches, in two passes: the list forward, then backward. A
variant whose shared memory does not fit the card at a width reports the
launch error instead of a time. The card's name and power limit are
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
from repro_torch.core.sddmm import LibraSDDMM  # noqa: E402
from repro_torch.core.spmm import LibraSpMM  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.sddmm_mxu import slice_feats  # noqa: E402
from repro_torch.sparse import mixed_csr, power_law_csr  # noqa: E402
from repro_torch.tune.model import TuneConfig  # noqa: E402

OUT = ROOT / "build" / "ab_mxu"
SOURCES = ("spmm_mxu.cu", "sddmm_mxu.cu")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OLD_SIG = {"spmm_mxu_launch": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P),
           "sddmm_mxu_launch": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _L, _P)}
TF32_REL = 2e-2

# Variant -> textual edits, made in each source that holds the text; ""
# is the source as committed.
EDITS = {
    "": (),
    "K1 3 stages": (("kStages = 2;      // chunks staged",
                     "kStages = 3;      // chunks staged"),),
    "K1 4 stages": (("kStages = 2;      // chunks staged",
                     "kStages = 4;      // chunks staged"),),
    "K1 256-column tiles (values read once)": (
        ("kTileCols = 128;", "kTileCols = 256;"),),
    "K1 64-column tiles": (("kTileCols = 128;", "kTileCols = 64;"),),
    "K1 64-column tiles, 4 stages": (
        ("kTileCols = 128;", "kTileCols = 64;"),
        ("kStages = 2;      // chunks staged",
         "kStages = 4;      // chunks staged")),
    "K3 3 stages": (("kStages = 2;  // chunks a warp",
                     "kStages = 3;  // chunks a warp"),),
    "K3 2-warp blocks": (("kWarps = 4;   // warps a block",
                          "kWarps = 2;   // warps a block"),),
    "K3 8-warp blocks": (("kWarps = 4;   // warps a block",
                          "kWarps = 8;   // warps a block"),),
    "K3 16-column chunks": (("return kF >= 128 ? 16 : 32;", "return 16;"),),
    "K3 32-column chunks": (("return kF >= 128 ? 16 : 32;", "return 32;"),),
    "stores: K1 plain, K3 streaming": (
        ("*dst = kept ? acc[q] : 0.f;", "__stcs(dst, kept ? acc[q] : 0.f);"),
        ("*dst = st[kOld + r * kCols + jc] + acc[q];",
         "__stcs(dst, st[kOld + r * kCols + jc] + acc[q]);"),
        ("__stcs(reinterpret_cast<float4*>(dst),",
         "*reinterpret_cast<float4*>(dst) = ("),
        ("__stcs(dst + e, o[h][e]);", "dst[e] = o[h][e];")),
}
K3_WIDTHS = (32, 64, 128)
HOT = 4096


def _dir(tag: str) -> pathlib.Path:
    return OUT / ("".join(c if c.isalnum() else "_" for c in tag) or "new")


def build(tag: str, src_dir: pathlib.Path, edits) -> subprocess.Popen:
    d = _dir(tag)
    d.mkdir(parents=True, exist_ok=True)
    (d / "common.cuh").write_text((src_dir / "common.cuh").read_text())
    unused = dict(edits)
    for name in SOURCES:
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
         str(d / "lib.so"), *(str(d / name) for name in SOURCES)],
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


def k1_call(lib, old, vals, cols, lens, rank, b, out):
    nb, _, bk = vals.shape
    n = b.shape[1]
    if old:
        return lambda: lib.spmm_mxu_launch(
            vals.data_ptr(), cols.data_ptr(), rank.data_ptr(), b.data_ptr(),
            out.data_ptr(), nb, bk, n, 0, int(n % 4 == 0), stream())
    # A batch of one: every batch stride 0.
    return lambda: lib.spmm_mxu_launch(
        vals.data_ptr(), cols.data_ptr(), lens.data_ptr(), rank.data_ptr(),
        b.data_ptr(), out.data_ptr(), 1, nb, bk, n, 0, 0, 0, 0, 0, 0, 0,
        int(n % 4 == 0), stream())


def k3_call(lib, old, cols, bits, window, x, y, out, w=None):
    nb, bk = cols.shape
    kf = x.shape[1]
    if old:
        return lambda: lib.sddmm_mxu_launch(
            cols.data_ptr(), bits.data_ptr(), window.data_ptr(),
            x.data_ptr(), y.data_ptr(), out.data_ptr(), nb, bk, kf,
            x.shape[0], stream())
    # The staged form: no position table, no staging buffer.
    return lambda: lib.sddmm_mxu_launch(
        cols.data_ptr(), bits.data_ptr(), window.data_ptr(), None,
        x.data_ptr(), y.data_ptr(), out.data_ptr(), None, 1, nb, bk, kf,
        x.shape[0], 0, 0, 0, 0, 0, 0, 0, 0, w, int(kf % 4 == 0), stream())


def check(fn, out, want, label) -> int:
    """Run once against the twin; the launch's error code (0 = ran)."""
    out.fill_(float("nan"))
    err = fn()
    if err:
        return err
    torch.cuda.synchronize()
    bad = (out - want).abs().max().item()
    if not bad <= TF32_REL * want.abs().max().item():
        raise SystemExit(f"{label}: differs from the twin (max|err| {bad})")
    return 0


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
        raise SystemExit("ab_mxu_kernels: needs a CUDA device")
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
        regs = [line.split("Used ")[1].split(",")[0] for line in
                out.splitlines() if "Used" in line and "registers" in line]
        print(f"built {tag or 'new'}: registers {regs}", flush=True)
    libs = {tag: load(tag, OLD_SIG if tag == "baseline"
                      else {k: _build.SIGNATURES[k] for k in OLD_SIG})
            for tag in procs}
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    a_mix = mixed_csr(16384, 16384, seed=3)
    graph = power_law_csr(169343, 169343, 13.7, seed=1)
    spec = ExecSpec(tune="off", device="cuda")
    spmm_mix = LibraSpMM(a_mix, spec=spec.replace(tune=TuneConfig(
        threshold=6, bk=32, ts_tile=32, ts=4, cs=128)))
    sddmm_mix = LibraSDDMM(a_mix, spec=spec.replace(tune=TuneConfig(
        threshold=1, bk=16, ts_tile=32, ts=8, cs=128)))
    sddmm_graph = LibraSDDMM(graph, spec=spec.replace(tune=TuneConfig(
        threshold=8, bk=16, ts_tile=32, ts=2, cs=32)))
    print(f"plans {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(dev).manual_seed(0)

    # K1 at LibraSpMM mixed n=256, the operator's own values.
    t = spmm_mix.arrays.for_backend("cuda")
    vals, cols, rank, lens = (t["tc_seg_vals"], t["tc_seg_cols"],
                              t["tc_seg_rank"], t["tc_len"])
    nseg = rank.shape[0]
    b = torch.randn(a_mix.k, 256, generator=gen, device=dev)
    out = torch.empty(nseg * 8, 256, device=dev)
    want = ref.spmm_tc_compact_ref(vals, cols, rank, b, nseg)
    cases = []
    for tag, lib in libs.items():
        label = f"K1 n=256 {tag or 'new'}"
        fn = k1_call(lib, tag == "baseline", vals, cols, lens, rank, b, out)
        err = check(fn, out, want, label)
        if err:
            print(f"  {label}: does not launch (error {err})", flush=True)
        else:
            cases.append((label, fn))
    # Every gather an L2 hit: columns folded into B's first HOT rows.
    hot = cols % HOT
    label = f"K1 n=256 new, columns folded to {HOT} rows"
    fn = k1_call(libs[""], False, vals, hot, lens, rank, b, out)
    check(fn, out, ref.spmm_tc_compact_ref(vals, hot, rank, b, nseg), label)
    cases.append((label, fn))
    print(f"K1 at mixed LibraSpMM n=256 ({nseg} segments, "
          f"{int(lens.sum())} real vectors of {cols.numel()}):", flush=True)
    passes(cases)
    del want, out

    # K3 at LibraSDDMM on the graph and on the mixed matrix, kf=128.
    for name, op, a in (("graph", sddmm_graph, graph),
                        ("mixed", sddmm_mix, a_mix)):
        t = op.arrays.for_backend("cuda")
        cols, bits, window = (t["tc_seg_cols"], t["tc_seg_bitmap"],
                              t["tc_seg_window"])
        x = torch.randn(a.m, 128, generator=gen, device=dev)
        y = x if a is graph else torch.randn(a.k, 128, generator=gen,
                                            device=dev)
        out = torch.empty(cols.shape[0], 8, cols.shape[1], device=dev)
        want = ref.sddmm_tc_ref(cols, bits, window, x, y)
        chosen = slice_feats(y.shape[0], 128)
        cases = []
        for tag, lib in libs.items():
            old = tag == "baseline"
            for w in [None] if old else sorted({chosen, *K3_WIDTHS}):
                label = (f"K3 {name} kf=128 {tag or 'new'}"
                         + ("" if old else f" w={w}"))
                fn = k3_call(lib, old, cols, bits, window, x, y, out, w)
                err = check(fn, out, want, label)
                if err:
                    print(f"  {label}: does not launch (error {err})",
                          flush=True)
                else:
                    cases.append((label, fn))
        hot = cols % HOT
        label = f"K3 {name} kf=128 new w={chosen}, columns folded to {HOT} rows"
        fn = k3_call(libs[""], False, hot, bits, window, x, y, out, chosen)
        check(fn, out, ref.sddmm_tc_ref(hot, bits, window, x, y), label)
        cases.append((label, fn))
        print(f"K3 at {name} LibraSDDMM kf=128 (wrapper's slice width "
              f"{chosen}; {cols.shape[0]} segments x {cols.shape[1]}, "
              f"{int((bits != 0).sum())} real columns):", flush=True)
        passes(cases)
        del want, out

    if "baseline" in libs:
        operator_ab(libs["baseline"], dev, gen, a_mix, graph, spmm_mix,
                    sddmm_mix, sddmm_graph)
    return 0


def operator_ab(old_lib, dev, gen, a_mix, graph, spmm_mix, sddmm_mix,
                sddmm_graph):
    """The three operators with the baseline K1/K3 patched into the apply,
    against the kernels as committed: old, new, new, old."""
    from unittest import mock

    def old_spmm_mxu(vals, cols, rank, b, *, n_active, unique_ranks=False,
                     seg_len=None):
        alloc = torch.empty if unique_ranks else torch.zeros
        out = alloc(n_active * 8, b.shape[1], device=dev)
        assert old_lib.spmm_mxu_launch(
            vals.data_ptr(), cols.data_ptr(), rank.data_ptr(), b.data_ptr(),
            out.data_ptr(), vals.shape[0], vals.shape[2], b.shape[1],
            int(not unique_ranks), int(b.shape[1] % 4 == 0), stream()) == 0
        return out

    def old_sddmm_mxu(cols, bits, window, x, y, out_pos=None, out=None):
        s = torch.empty(cols.shape[0], 8, cols.shape[1], device=dev)
        assert k3_call(old_lib, True, cols, bits, window, x, y, s)() == 0
        if out_pos is None:
            return s
        # The baseline stores staged scores: the apply's canonical output
        # places them (a scatter the committed kernel does in its stores).
        kept = ref.bitmap_mask(bits) & (out_pos >= 0)
        return ref.place_scores(s, out_pos, kept, out)

    b = torch.randn(a_mix.k, 256, generator=gen, device=dev)
    xm, ym = (torch.randn(a_mix.m, 128, generator=gen, device=dev)
              for _ in range(2))
    xg = torch.randn(graph.m, 128, generator=gen, device=dev)
    print("operators (CUDA events, median of 20; old, new, new, old):",
          flush=True)
    for name, run in (("LibraSpMM mixed n=256", lambda: spmm_mix(b)),
                      ("LibraSDDMM mixed kf=128", lambda: sddmm_mix(xm, ym)),
                      ("LibraSDDMM graph kf=128",
                       lambda: sddmm_graph(xg, xg))):
        got = []
        for gen_ in ("old", "new", "new", "old"):
            if gen_ == "old":
                with mock.patch.object(ops, "spmm_mxu", old_spmm_mxu), \
                        mock.patch.object(ops, "sddmm_mxu", old_sddmm_mxu):
                    got.append(median_ms(run))
            else:
                got.append(median_ms(run))
        print(f"  {name}: " + ", ".join(f"{v:.4f}" for v in got) + " ms",
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
