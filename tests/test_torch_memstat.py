"""Device-memory accounting against the reference: the port's lazy
``PlanArrays`` views, ``MemLedger``, the registry's byte budget and the
``/memory`` endpoint hold ``tests/test_memstat.py``'s contracts.

The port's ledger is exact by construction on its own device: it sums
the uploaded tensors' ``nbytes``, the kernel path's derived lengths
included. Against the reference's byte totals:

* the compact view (reference ``"xla"``, port ``"torch"``) holds the
  same keys in as many bytes;
* the kernel path (reference ``"pallas"``, port ``"cuda"``) holds the
  same keys plus, for SpMM plans, ``tc_len`` and ``vpu_len``: one int32
  per row of the Tensor Core and CUDA-core tables it reads (segments,
  or blocks/tiles), accounted under that table's view (``"segment"`` as
  ``tc_seg_len``/``vpu_seg_len``, ``"compact"`` as ``tc_len``/``vpu_len``);
  SDDMM plans carry none.
"""
import json
import types
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core import formats as jformats
from repro.core import preprocess as jpre
from repro.obs import memstat as jmem
from repro.obs.metrics import MetricsRegistry as JMetrics
from repro.sparse import generate as jgen
from repro_torch import serve as tserve
from repro_torch.core import formats as tformats
from repro_torch.core import preprocess as tpre
from repro_torch.core.windows import num_windows
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.obs import memstat as tmem
from repro_torch.obs.metrics import MetricsRegistry as TMetrics
from repro_torch.sparse import generate as tgen

KERNEL = {"xla": "torch", "pallas": "cuda"}


def _corpus(gen):
    return gen.suitesparse_like_corpus(n_small=4, seed=7)


def _plans(kind):
    jp = jpre.preprocess_spmm if kind == "spmm" else jpre.preprocess_sddmm
    tp = tpre.preprocess_spmm if kind == "spmm" else tpre.preprocess_sddmm
    return [(jp(ja), tp(ta)) for ja, ta in zip(_corpus(jgen).values(),
                                                _corpus(tgen).values())]


def _resident_sum(pa) -> int:
    return sum(v.numel() * v.element_size() for _, v in pa.resident_items())


def _length_bytes(pa, backend, segmented=True) -> dict:
    """The derived lengths' bytes per view, from the host tables."""
    out = {v: 0 for v in tformats.PLAN_VIEWS}
    if pa.kind != "spmm" or backend != "cuda":
        return out
    for stream in ("tc", "vpu"):
        seg = segmented and f"{stream}_seg_vals" in pa.host
        table = pa.host[f"{stream}_seg_pos" if seg else f"{stream}_pos"]
        out["segment" if seg else "compact"] += 4 * table.shape[0]
    return out


# SDDMM plans have no revaluation view.
VIEW_CASES = [(kind, rb, rv, seg) for kind in ("spmm", "sddmm")
              for rb in ("xla", "pallas") for rv in (False, True)
              for seg in (True, False) if not (kind == "sddmm" and rv)]


@pytest.mark.parametrize("kind,ref_backend,revalue,segmented", VIEW_CASES)
def test_view_bytes_equal_reference_plus_lengths(kind, ref_backend, revalue,
                                                 segmented):
    backend = KERNEL[ref_backend]
    for jplan, tplan in _plans(kind):
        jpa, tpa = jformats.PlanArrays(jplan), tformats.PlanArrays(
            tplan, "cpu")
        kw = dict(revalue=revalue, segmented=segmented)
        assert tpa.backend_keys(backend, **kw) == \
            jpa.backend_keys(ref_backend, **kw)
        extra = _length_bytes(tpa, backend, segmented)
        assert tpa.projected_nbytes(backend, **kw) == \
            jpa.projected_nbytes(ref_backend, **kw) + sum(extra.values())
        jpa.for_backend(ref_backend, **kw)
        tpa.for_backend(backend, **kw)
        want = jpa.view_nbytes()
        assert tpa.view_nbytes() == {v: want[v] + extra[v] for v in want}
        assert tpa.resident_nbytes() == _resident_sum(tpa)
        assert tpa.projected_nbytes() == jpa.projected_nbytes()
        mem, jmemory = tpa.memory(), jpa.memory()
        assert mem["views"] == jmemory["views"]
        assert mem["total_bytes"] == jmemory["total_bytes"]


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("kind", ["spmm", "sddmm"])
def test_lazy_views_equal_eager_dict(kind, backend):
    rng = np.random.default_rng(0)
    for a in _corpus(tgen).values():
        plan = (tpre.preprocess_spmm if kind == "spmm"
                else tpre.preprocess_sddmm)(a)
        pa = tformats.PlanArrays(plan, "cpu")
        eager = tformats.PlanArrays(plan, "cpu").materialize_all()
        if kind == "spmm":
            b = torch.from_numpy(rng.standard_normal((a.k, 16)).astype(
                np.float32))
            kw = dict(m=a.m, nwin=num_windows(a.m), backend=backend)
            got = tops.spmm_apply(pa.for_backend(backend), b, **kw)
            want = tops.spmm_apply(eager, b, **kw)
            assert _resident_sum(pa) < pa.projected_nbytes() + 4 * (
                pa.host["tc_seg_pos"].shape[0]
                + pa.host["vpu_seg_pos"].shape[0])
        else:
            x = torch.from_numpy(rng.standard_normal((a.m, 16)).astype(
                np.float32))
            y = torch.from_numpy(rng.standard_normal((a.k, 16)).astype(
                np.float32))
            got = tops.sddmm_apply(pa.for_backend(backend), x, y,
                                   nnz=plan.nnz, backend=backend)
            want = tops.sddmm_apply(eager, x, y, nnz=plan.nnz,
                                    backend=backend)
        assert torch.equal(got, want)


def test_revalue_view_uploads_no_values():
    a = next(iter(_corpus(tgen).values()))
    plan = tpre.preprocess_spmm(a)
    rng = np.random.default_rng(2)
    b = torch.from_numpy(rng.standard_normal((a.k, 8)).astype(np.float32))
    ev = torch.from_numpy(rng.standard_normal(a.nnz).astype(np.float32))
    eager = tformats.PlanArrays(plan, "cpu").materialize_all()
    kw = dict(m=a.m, nwin=num_windows(a.m), backend="torch")
    want = tops.spmm_apply(tref.revalue_spmm_arrays(eager, ev), b, **kw)
    pa = tformats.PlanArrays(plan, "cpu")
    lazy = pa.for_backend("torch", revalue=True)
    assert not any(k.endswith("_vals") for k in lazy)
    got = tops.spmm_apply(tref.revalue_spmm_arrays(lazy, ev), b, **kw)
    assert torch.equal(got, want)
    assert pa.view_nbytes()["revalue"] > 0


@pytest.mark.parametrize("key", [
    "tc_pos", "tc_seg_pos", "tc_seg_vals", "tc_vals", "tc_out_pos",
    "vpu_seg_out_pos", "vpu_pos", "vpu_seg_mask", "tc_bitmap"])
def test_view_classification_matches_reference(key):
    assert tformats.view_of_key(key) == jformats.view_of_key(key)
    assert tformats.PLAN_VIEWS == jformats.PLAN_VIEWS


def test_derived_lengths_take_their_tables_view():
    assert tformats.view_of_key("tc_seg_len") == "segment"
    assert tformats.view_of_key("vpu_len") == "compact"
    a = next(iter(_corpus(tgen).values()))
    pa = tformats.PlanArrays(tpre.preprocess_spmm(a), "cpu")
    for backend in ("cuda", "torch"):
        assert "tc_bitmap" not in pa.backend_keys(backend)
    pa.for_backend("cuda")
    assert {"tc_seg_len", "vpu_seg_len"} <= set(pa._uploads)
    pa.for_backend("cuda", segmented=False)
    assert {"tc_len", "vpu_len"} <= set(pa._uploads)
    assert pa.resident_nbytes() == _resident_sum(pa)


# ------------------------------------------------------------- ledger ---
def _ledger_trace(mod, metrics_cls):
    """One scripted sequence of uploads and releases; everything the
    ledger reports along the way."""
    m = metrics_cls()
    led = mod.MemLedger(metrics=m)
    docs = []
    led.account("g1", "spmm", "compact", "tc_vals", 4096, "float32")
    led.account("g1", "spmm", "segment", "tc_seg_vals", 8192, "float32")
    led.account("g2", "sddmm", "compact", "vpu_rows", 512, "int32")
    docs.append(led.memory_report())
    led.account("g1", "spmm", "compact", "tc_vals", 2048, "float32")
    bind = led.binder("g3", "spmm")
    bind("revalue", "tc_pos", 1024, "int32")
    docs.append(led.memory_report(top_k=2))
    docs.append(led.release("g1"))
    docs.append(led.release("missing"))
    docs.append(led.memory_report())
    docs.append({"resident": led.resident_bytes(),
                 "compact": led.resident_bytes("compact"),
                 "g3": led.graph_bytes("g3"), "peak": led.peak_bytes()})
    docs.append(mod.render_memory(led.memory_report()))
    docs.append(m.exposition())
    return docs


def test_mem_ledger_matches_reference_step_for_step():
    assert _ledger_trace(tmem, TMetrics) == _ledger_trace(jmem, JMetrics)


def test_metrics_series_materialized_at_zero():
    body = TMetrics()
    tmem.MemLedger(metrics=body)
    ref = JMetrics()
    jmem.MemLedger(metrics=ref)
    assert body.exposition() == ref.exposition()
    for view in tformats.PLAN_VIEWS:
        assert f'registry_resident_bytes{{view="{view}"}} 0' in \
            body.exposition()


def _plan_arrays(a):
    return tformats.PlanArrays(tpre.preprocess_spmm(a), "cpu")


def test_ledger_exact_over_a_corpus_and_growth():
    m = TMetrics()
    led = tmem.MemLedger(metrics=m)
    pas = {}
    for name, a in _corpus(tgen).items():
        pa = _plan_arrays(a)
        pa.set_accountant(led.binder(name, "spmm"))
        pa.for_backend("torch")
        pas[name] = pa
    expect = sum(_resident_sum(pa) for pa in pas.values())
    rep = led.memory_report()
    assert led.resident_bytes() == rep["resident_bytes"] == expect
    assert sum(rep["by_view"].values()) == sum(rep["by_op"].values()) \
        == sum(g["bytes"] for g in rep["graphs"]) == expect
    next(iter(pas.values())).for_backend("cuda")
    expect = sum(_resident_sum(pa) for pa in pas.values())
    assert led.resident_bytes() == led.peak_bytes() == expect


def test_replay_on_late_attach_and_double_materialization():
    a = next(iter(_corpus(tgen).values()))
    pa = _plan_arrays(a)
    pa.for_backend("torch")        # uploads before any accountant
    led = tmem.MemLedger()
    pa.set_accountant(led.binder("g", "spmm"))
    assert led.resident_bytes() == _resident_sum(pa)
    pa.for_backend("cuda")
    pa.for_backend("cuda", segmented=False)
    pa.for_backend("torch")
    assert led.resident_bytes() == led.graph_bytes("g") == _resident_sum(pa)
    vb = pa.view_nbytes()
    for view in tformats.PLAN_VIEWS:
        assert led.resident_bytes(view) == vb[view]
    freed = led.release("g")
    assert freed == vb["compact"] + vb["segment"] + vb["revalue"]
    rep = led.memory_report()
    assert rep["evicted_bytes"] == freed and led.resident_bytes() == 0
    assert "memory report" in tmem.render_memory(rep)


# --------------------------------------------------- registry + engine ---
def _pkg(side, backend):
    if side == "ref":
        return types.SimpleNamespace(
            gen=jgen, serve=jserve, mem=jmem, arr=jnp.asarray,
            reg=lambda **kw: jserve.GraphRegistry(backend=backend,
                                                  tune="off", **kw),
            env="REPRO_REGISTRY_MAX_BYTES")
    return types.SimpleNamespace(
        gen=tgen, serve=tserve, mem=tmem,
        arr=lambda x: torch.from_numpy(np.asarray(x, np.float32)),
        reg=lambda **kw: tserve.GraphRegistry(backend=backend, device="cpu",
                                              tune="off", **kw),
        env="REPRO_TORCH_REGISTRY_MAX_BYTES")


def sc_lru_budget(P):
    reg = P.reg(max_graphs=8, width_buckets=(8,), panel_buckets=(1,))
    graphs = [(f"g{i}", P.gen.power_law_csr(64, 64, 4.0, seed=i))
              for i in range(3)]
    for n, a in graphs:
        reg.register(a, name=n, ops=("spmm",))
    rng = np.random.default_rng(0)
    for n, a in graphs:
        b = rng.standard_normal((a.shape[1], 8)).astype(np.float32)
        reg.get(n).op("spmm")(P.arr(b)[None], backend=reg.backend)
    sizes = [reg.mem.graph_bytes(reg.resolve(n).key) for n, _ in graphs]
    reg.max_bytes = sizes[1] + sizes[2]
    dropped = reg.enforce_budget()
    doc = {"dropped": dropped, "in": [n in reg for n, _ in graphs],
           "resident": reg.mem.resident_bytes() == sizes[1] + sizes[2],
           "stats": dict(reg.stats(), resident_bytes=None, peak_bytes=None,
                         max_bytes=None)}
    reg.max_bytes = 1
    doc["lone"] = (reg.enforce_budget(), len(reg.stats()["names"]))
    return doc


def sc_pressure(P):
    reg = P.reg(max_graphs=4, max_bytes=64)
    eng = P.serve.SparseEngine(reg)
    a = P.gen.power_law_csr(64, 64, 4.0, seed=0)
    try:
        eng.register(a, name="big", ops=("spmm",))
    except P.mem.MemoryPressure as exc:
        err = (exc.reason, exc.required > exc.budget == 64)
    return {"err": err, "rejected": eng.stats()["rejected"],
            "rejects": reg.stats()["pressure_rejects"],
            "in": "big" in reg}


def sc_flush_budget(P):
    reg = P.reg(max_graphs=8, width_buckets=(8,), panel_buckets=(1,))
    eng = P.serve.SparseEngine(reg)
    graphs = [(f"g{i}", P.gen.power_law_csr(64, 64, 4.0, seed=10 + i))
              for i in range(3)]
    rng = np.random.default_rng(0)
    for n, a in graphs:
        eng.register(a, name=n, ops=("spmm",))
    for n, a in graphs:
        eng.submit(n, "spmm", b=P.arr(rng.standard_normal((64, 8))))
    eng.flush()
    before = reg.stats()["graphs_resident"]
    reg.max_bytes = reg.mem.resident_bytes() - 1
    rid = eng.submit("g2", "spmm", b=P.arr(rng.standard_normal((64, 8))))
    out = eng.flush()
    return {"before": before, "ok": not isinstance(out[rid], Exception),
            "fits": reg.mem.resident_bytes() <= reg.max_bytes,
            "after": reg.stats()["graphs_resident"]}


def sc_evict_rebuild(P):
    reg = P.reg(max_graphs=1, width_buckets=(8,), panel_buckets=(1,))
    a0 = P.gen.power_law_csr(64, 64, 4.0, seed=0)
    a1 = P.gen.power_law_csr(64, 64, 4.0, seed=1)
    reg.register(a0, name="g0", ops=("spmm",))
    b = P.arr(np.random.default_rng(0).standard_normal((64, 8)))
    reg.get("g0").op("spmm")(b[None], backend=reg.backend)
    reg.register(a1, name="g1", ops=("spmm",))
    rep = reg.memory_report()
    reg.get("g1").op("spmm")(b[None], backend=reg.backend)
    return {"in": "g0" in reg, "evicted": rep["evicted_bytes"] > 0,
            "exact": reg.mem.resident_bytes() == reg.mem.graph_bytes(
                reg.resolve("g1").key)}


def sc_mem_false(P):
    reg = P.reg(max_graphs=2, mem=False)
    reg.register(P.gen.power_law_csr(64, 64, 4.0, seed=0), name="g",
                 ops=("spmm",))
    try:
        reg.memory_report()
    except ValueError:
        return {"mem": reg.mem, "raised": True}
    return {"raised": False}


BUDGET = {"lru": sc_lru_budget, "pressure": sc_pressure,
          "flush": sc_flush_budget, "evict_rebuild": sc_evict_rebuild,
          "mem_false": sc_mem_false}


@pytest.mark.parametrize("pair", ["xla/torch", "xla/cuda"])
@pytest.mark.parametrize("name", sorted(BUDGET))
def test_byte_budget_matches_reference(name, pair):
    jb, tb = pair.split("/")
    assert BUDGET[name](_pkg("port", tb)) == BUDGET[name](_pkg("ref", jb))


def test_env_var_budget(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_REGISTRY_MAX_BYTES", "12345")
    assert tserve.GraphRegistry(max_graphs=2, device="cpu").max_bytes == 12345
    monkeypatch.delenv("REPRO_TORCH_REGISTRY_MAX_BYTES")
    assert tserve.GraphRegistry(max_graphs=2, device="cpu").max_bytes is None


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_registry_bytes_equal_reference_plus_lengths(backend):
    """A served graph's accounted bytes: the reference's for the same
    view, plus the kernel path's lengths."""
    ref_backend = {"cuda": "pallas", "torch": "xla"}[backend]
    docs = {}
    for side, P in (("ref", _pkg("ref", ref_backend)),
                    ("port", _pkg("port", backend))):
        reg = P.reg(max_graphs=2, width_buckets=(16,), panel_buckets=(1,))
        a = P.gen.power_law_csr(128, 96, 6.0, seed=3)
        reg.register(a, name="g")
        for op in ("spmm", "sddmm"):
            reg.warm("g", op)
        entry = reg.resolve("g")
        docs[side] = (reg.stats()["resident_bytes"], entry,
                      reg.memory_report())
    want, _, jrep = docs["ref"]
    got, entry, rep = docs["port"]
    arrays = entry.op("spmm").op.arrays
    extra = sum(_length_bytes(arrays, backend).values())
    assert got == want + extra == rep["resident_bytes"]
    assert rep["by_op"]["spmm"] == jrep["by_op"]["spmm"] + extra
    assert rep["by_op"]["sddmm"] == jrep["by_op"]["sddmm"]
    assert got == sum(_resident_sum(op.op.arrays)
                      for op in entry.ops.values())


# ------------------------------------------------------------- http ---
def test_http_memory_equals_uploaded_bytes_and_metrics():
    a = tgen.power_law_csr(128, 96, 6.0, seed=3)
    reg = tserve.GraphRegistry(max_graphs=4, width_buckets=(16,),
                               panel_buckets=(1, 2), device="cpu")
    eng = tserve.SparseEngine(reg)
    eng.register(a, name="g", ops=("spmm",))
    b = np.random.default_rng(0).standard_normal((96, 16)).astype(
        np.float32)
    eng.submit("g", "spmm", b=torch.from_numpy(b))
    eng.flush()
    uploaded = sum(_resident_sum(op.op.arrays)
                   for op in reg.resolve("g").ops.values())
    with eng.serve_http() as srv:
        doc = json.loads(urllib.request.urlopen(
            f"{srv.url}/memory", timeout=10).read().decode())
        assert doc["kind"] == "memory_report" and doc["n_graphs"] == 1
        assert doc["resident_bytes"] == reg.mem.resident_bytes() \
            == uploaded > 0
        body = urllib.request.urlopen(
            f"{srv.url}/metrics", timeout=10).read().decode()
        assert 'registry_resident_bytes{view="segment"}' in body
        assert "registry_bytes_evicted_total" in body
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{srv.url}/bogus", timeout=10)
        assert "/memory" in ei.value.read().decode()


def test_http_memory_404_when_disabled():
    eng = tserve.SparseEngine(tserve.GraphRegistry(max_graphs=2, mem=False,
                                                   device="cpu"))
    with eng.serve_http() as srv:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{srv.url}/memory", timeout=10)
        assert ei.value.code == 404
