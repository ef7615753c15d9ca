#!/usr/bin/env python3
"""A/B of K1–K4's single launches before and after their batch axis, on
one NVIDIA GPU, at the main path's shapes.

Run from the repository root::

    python3 tools/ab_batched_kernels.py --baseline DIR

DIR holds an earlier commit's ``spmm_mxu.cu``, ``spmm_vpu.cu``,
``sddmm_mxu.cu``, ``sddmm_vpu.cu`` and ``common.cuh`` from before the
batch axis (``git show <commit>:src/repro_torch/kernels/csrc/<file>``
into a directory that ``.gitignore`` lists, e.g. ``build/ab_base``).
Each variant is built by ``nvcc`` into its own library under
``build/ab_batched/`` (``ptxas``'s registers printed):

- ``baseline``: DIR's sources, whose entry points take no batch;
- the committed sources, and copies of them with one change each
  (``EDITS``), called as a batch of one (every batch stride 0);
- with ``--variant VDIR`` (repeatable), VDIR's sources, which take the
  committed entry points; a source VDIR lacks is the committed one.

Each kernel runs on the plan tables the main path gives it: K1 at
``LibraSpMM`` on ``mixed_csr(16384, 16384, seed=3)`` (n = 256), K2 at
the graph's ``GraphOps`` A (n = 256, 128, 40), K3 at ``LibraSDDMM`` on
the mixed matrix (kf = 128), K4 at the graph's SDDMM(A) (kf = 128,
256); the graph is ``power_law_csr(169343, 169343, 13.7, seed=1)``,
plans at ``tune="off"`` or ``chip_smoke.py``'s literal configs. Every
variant's output must equal the baseline's bit for bit (K1 with unique
ranks stores). Each variant is timed with CUDA events, median of 20
launches queued behind a device sleep, in the order baseline, variants,
variants reversed, baseline. Then the same with a batch of ``BATCH``
dense operands over the shared tables: each variant's one batched launch
against the baseline's ``BATCH`` single launches, element by element
bit for bit. The card's name and power limit are printed first.
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
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.sddmm_mxu import slice_feats as k3_slice  # noqa: E402
from repro_torch.kernels.sddmm_vpu import slice_feats as k4_slice  # noqa: E402
from repro_torch.kernels.spmm_vpu import slice_cols  # noqa: E402
from repro_torch.models.gnn import GraphOps, gcn_norm_edges  # noqa: E402
from repro_torch.sparse import mixed_csr, power_law_csr  # noqa: E402
from repro_torch.tune.model import TuneConfig  # noqa: E402

OUT = ROOT / "build" / "ab_batched"
SOURCES = ("spmm_mxu.cu", "spmm_vpu.cu", "sddmm_mxu.cu", "sddmm_vpu.cu")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: The entry points before the batch axis.
BASE_SIG = {
    "spmm_mxu_launch": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P),
    "spmm_vpu_launch": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P),
    "sddmm_mxu_launch": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _L, _I, _I, _P),
    "sddmm_vpu_launch": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _P),
}
MIX_SPMM_CFG = dict(threshold=6, bk=32, ts_tile=32, ts=4, cs=128)
MIX_SDDMM_CFG = dict(threshold=1, bk=16, ts_tile=32, ts=8, cs=128)
SLEEP_CYCLES = 100_000_000
BATCH = 8

# Variant -> textual edits of the committed sources; "" is the source as
# committed. The committed kernels read each batch element's operand
# bases from a parameter table; the variant offsets element 0's bases by
# z strides inside the kernel instead (a stride is the difference of the
# table's first two entries; a batch of one multiplies it by 0), as a
# kernel given batch strides would.
EDITS = {
    "": (),
    "K2 and K4 offsetting in the kernel": (
        ("""  const float* __restrict__ vals = ops.vals[z];
  const int* __restrict__ cols = ops.cols[z];
  const int* __restrict__ row_len = ops.row_len[z];
  const float* __restrict__ b = ops.b[z];
  float* __restrict__ out = ops.out[z];""",
         """  const float* __restrict__ vals = ops.vals[0] + z * (ops.vals[1] - ops.vals[0]);
  const int* __restrict__ cols = ops.cols[0] + z * (ops.cols[1] - ops.cols[0]);
  const int* __restrict__ row_len = ops.row_len[0] + z * (ops.row_len[1] - ops.row_len[0]);
  const float* __restrict__ b = ops.b[0] + z * (ops.b[1] - ops.b[0]);
  float* __restrict__ out = ops.out[0] + z * (ops.out[1] - ops.out[0]);"""),
        ("""  const int* __restrict__ rows = ops.rows[z];
  const int* __restrict__ cols = ops.cols[z];
  const float* __restrict__ x = ops.x[z];
  const float* __restrict__ y = ops.y[z];
  float* __restrict__ out = ops.out[z];""",
         """  const int* __restrict__ rows = ops.rows[0] + z * (ops.rows[1] - ops.rows[0]);
  const int* __restrict__ cols = ops.cols[0] + z * (ops.cols[1] - ops.cols[0]);
  const float* __restrict__ x = ops.x[0] + z * (ops.x[1] - ops.x[0]);
  const float* __restrict__ y = ops.y[0] + z * (ops.y[1] - ops.y[0]);
  float* __restrict__ out = ops.out[0] + z * (ops.out[1] - ops.out[0]);""")),
}


def _dir(tag: str) -> pathlib.Path:
    return OUT / ("".join(c if c.isalnum() else "_" for c in tag) or "new")


def build(tag: str, src_dir: pathlib.Path, edits) -> subprocess.Popen:
    d = _dir(tag)
    d.mkdir(parents=True, exist_ok=True)

    def source(name):
        path = src_dir / name
        return (path if path.exists() else _build.CSRC / name).read_text()

    (d / "common.cuh").write_text(source("common.cuh"))
    unused = dict(edits)
    for name in SOURCES:
        text = source(name)
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
    """Median of ``reps`` runs between CUDA events, queued behind a device
    sleep so that the card, not the host's launches, sets the pace."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def calls(lib, base: bool, name: str, t: dict, out):
    """A launch of kernel ``name`` on ``t``'s operands into ``out``: the
    baseline's entry point, or the committed one. Dense operands (``b``,
    ``x``, ``y``) and ``out`` may carry a leading batch axis (committed
    entry points only): one launch over the batch, the tables shared."""
    s = _build.stream_handle(torch.device("cuda"))
    dense = t["b"] if "b" in t else t["x"]
    batch = dense.shape[0] if dense.dim() == 3 else 1

    def bs(x, ndim):
        return x[0].numel() if x.dim() == ndim + 1 else 0

    def entry(*strides):
        return {} if base else dict(one=(batch,), z=strides)

    if name == "spmm_mxu":
        v, c, r, b, lens = (t[k] for k in ("vals", "cols", "rank", "b",
                                           "lens"))
        nb, _, bk = v.shape
        n = b.shape[-1]
        e = entry(0, 0, 0, 0, bs(b, 2), bs(out, 2))
        return lambda: lib.spmm_mxu_launch(
            v.data_ptr(), c.data_ptr(), lens.data_ptr(), r.data_ptr(),
            b.data_ptr(), out.data_ptr(), *e.get("one", ()), nb, bk, n,
            *e.get("z", ()), 0, int(n % 4 == 0), s)
    if name == "spmm_vpu":
        v, c, b, lens = (t[k] for k in ("vals", "cols", "b", "lens"))
        k, n = b.shape[-2:]
        e = entry(0, 0, 0, bs(b, 2), bs(out, 2))
        return lambda: lib.spmm_vpu_launch(
            v.data_ptr(), c.data_ptr(), lens.data_ptr(), b.data_ptr(),
            out.data_ptr(), *e.get("one", ()), v.shape[0], v.shape[1], n,
            *e.get("z", ()), slice_cols(k, n, n % 4 == 0), int(n % 4 == 0),
            s)
    if name == "sddmm_mxu":
        c, bits, w, x, y = (t[k] for k in ("cols", "bits", "window", "x",
                                           "y"))
        nb, bk = c.shape
        kf = x.shape[-1]
        width = k3_slice(min(y.shape[-2], nb * bk), kf)
        # The committed entry point's staged form: no position table
        # (pos, staging buffer and their strides null).
        e = entry(0, 0, 0, 0, bs(x, 2), bs(y, 2), bs(out, 3), 0)
        ptrs = (c, bits, w, x, y, out) if base else (c, bits, w, None, x,
                                                      y, out, None)
        return lambda: lib.sddmm_mxu_launch(
            *map(_build.data_ptr, ptrs), *e.get("one", ()), nb, bk, kf,
            x.shape[-2], *e.get("z", ()), width, int(kf % 4 == 0), s)
    rows, c, x = (t[k] for k in ("rows", "cols", "x"))
    kf = x.shape[-1]
    e = entry(0, 0, 0, 0, bs(x, 2), bs(x, 2), bs(out, 2), 0)
    ptrs = (rows, c, x, x, out) if base else (rows, c, None, None, x, x,
                                              out, None)
    return lambda: lib.sddmm_vpu_launch(
        *map(_build.data_ptr, ptrs), *e.get("one", ()), rows.numel(), kf,
        *e.get("z", ()), k4_slice(x.shape[-2], kf, kf % 4 == 0),
        int(kf % 4 == 0), s)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=pathlib.Path, required=True)
    ap.add_argument("--variant", type=pathlib.Path, action="append",
                    default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_batched_kernels: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    procs = {tag: build(tag, _build.CSRC, edits)
             for tag, edits in EDITS.items()}
    procs["baseline"] = build("baseline", args.baseline, ())
    for vdir in args.variant:
        procs[str(vdir)] = build(str(vdir), vdir, ())
    for tag, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {tag!r}:\n{out}")
        kernels = [line.split("'")[1] for line in out.splitlines()
                   if "Compiling entry function" in line]
        regs = [line.split("Used ")[1].split(",")[0]
                for line in out.splitlines() if "registers" in line]
        spills = [line.split("bytes stack frame, ")[1].strip()
                  for line in out.splitlines() if "spill stores" in line]
        regs = [f"{r} ({sp})" for r, sp in zip(regs, spills)]
        print(f"built {tag or 'committed'}: "
              + "; ".join(f"{k[k.find('_kernel') - 8:k.find('_kernel') + 16]}"
                          f" {r}" for k, r in zip(kernels, regs)),
              flush=True)
    libs = {tag: load(tag, BASE_SIG if tag == "baseline"
                      else {k: _build.SIGNATURES[k] for k in BASE_SIG})
            for tag in procs}
    order = ["baseline", *EDITS, *map(str, args.variant)]
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    a_mix = mixed_csr(16384, 16384, seed=3)
    graph = power_law_csr(169343, 169343, 13.7, seed=1)
    sp_mix = LibraSpMM(a_mix, spec=ExecSpec(tune=TuneConfig(**MIX_SPMM_CFG)))
    sd_mix = LibraSDDMM(a_mix, spec=ExecSpec(
        tune=TuneConfig(**MIX_SDDMM_CFG)))
    gops = GraphOps(graph, spec=ExecSpec(tune="off", device="cuda"))
    print(f"plans {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(dev).manual_seed(0)
    t1 = sp_mix.arrays.for_backend("cuda")
    norm = torch.from_numpy(gcn_norm_edges(graph)).to(dev)
    t2 = ref.revalue_spmm_arrays(gops.arrs.for_backend("cuda", revalue=True),
                                 norm)
    t3 = sd_mix.arrays.for_backend("cuda")
    t4 = gops.arrs_sd.for_backend("cuda")
    seg4 = "_seg" if "vpu_seg_rows" in t4 else ""
    cases = []   # (label, name, operands, output shape)
    b = torch.randn(a_mix.k, 256, generator=gen, device=dev)
    nseg = t1["tc_seg_rank"].shape[0]
    cases.append(("K1 mixed n=256", "spmm_mxu", dict(
        vals=t1["tc_seg_vals"], cols=t1["tc_seg_cols"],
        rank=t1["tc_seg_rank"], b=b, lens=t1["tc_len"]), (nseg * 8, 256)))
    for n in (256, 128, 40):
        b = torch.randn(graph.k, n, generator=gen, device=dev)
        cases.append((f"K2 graph A n={n}", "spmm_vpu", dict(
            vals=t2["vpu_seg_vals"], cols=t2["vpu_seg_cols"], b=b,
            lens=t2["vpu_len"]), (t2["vpu_seg_vals"].shape[0], n)))
    x = torch.randn(a_mix.m, 128, generator=gen, device=dev)
    y = torch.randn(a_mix.k, 128, generator=gen, device=dev)
    c3 = t3["tc_seg_cols"]
    cases.append(("K3 mixed kf=128", "sddmm_mxu", dict(
        cols=c3, bits=t3["tc_seg_bitmap"], window=t3["tc_seg_window"],
        x=x, y=y), (c3.shape[0], 8, c3.shape[1])))
    for kf in (128, 256):
        x = torch.randn(graph.m, kf, generator=gen, device=dev)
        rows = t4[f"vpu{seg4}_rows"]
        cases.append((f"K4 graph SDDMM(A) kf={kf}", "sddmm_vpu", dict(
            rows=rows, cols=t4[f"vpu{seg4}_cols"], x=x), tuple(rows.shape)))
    for label, name, t, shape in cases:
        outs = {tag: torch.empty(shape, device=dev) for tag in order}
        fns = {tag: calls(libs[tag], tag == "baseline", name, t, outs[tag])
               for tag in order}
        for tag in order:
            assert fns[tag]() == 0, (label, tag)
        torch.cuda.synchronize()
        for tag in order[1:]:
            if not torch.equal(outs[tag], outs["baseline"]):
                raise SystemExit(f"{label}: {tag or 'committed'} differs "
                                 "from the baseline")
        seq = order + order[::-1]
        times = {tag: [] for tag in order}
        for tag in seq:
            times[tag].append(median_ms(fns[tag]))
        base = statistics.mean(times["baseline"])
        print(f"{label}: " + "; ".join(
            f"{tag or 'committed'} "
            + "/".join(f"{v:.4f}" for v in times[tag])
            + f" ms ({statistics.mean(times[tag]) / base:.3f})"
            for tag in order), flush=True)
        # A batch of BATCH dense operands over the shared tables: each
        # committed-interface variant's one launch against BATCH single
        # launches of the baseline, element by element bit for bit.
        tb = dict(t)
        for key in ("b", "x", "y"):
            if key in t:
                tb[key] = torch.randn(BATCH, *t[key].shape, generator=gen,
                                      device=dev)
        loop_outs = torch.empty((BATCH, *shape), device=dev)
        singles = [calls(libs["baseline"], True, name,
                         {**tb, **{k: tb[k][i] for k in ("b", "x", "y")
                                   if k in tb}}, loop_outs[i])
                   for i in range(BATCH)]
        batched = {tag: torch.empty((BATCH, *shape), device=dev)
                   for tag in order[1:]}
        fns = {"baseline": lambda: [f() for f in singles]}
        fns.update({tag: calls(libs[tag], False, name, tb, batched[tag])
                    for tag in order[1:]})
        for tag in order:
            fns[tag]()
        torch.cuda.synchronize()
        for tag in order[1:]:
            if not torch.equal(batched[tag], loop_outs):
                raise SystemExit(f"{label}: {tag or 'committed'}'s batch "
                                 "differs from the baseline's singles")
        times = {tag: [] for tag in order}
        for tag in seq:
            times[tag].append(median_ms(fns[tag]))
        base = statistics.mean(times["baseline"])
        print(f"{label}, batch {BATCH}: " + "; ".join(
            ("baseline singles" if tag == "baseline" else
             f"{tag or 'committed'} batched")
            + " " + "/".join(f"{v:.4f}" for v in times[tag])
            + f" ms ({statistics.mean(times[tag]) / base:.3f})"
            for tag in order), flush=True)
        del tb, loop_outs, batched, singles, fns
    return 0


if __name__ == "__main__":
    sys.exit(main())
