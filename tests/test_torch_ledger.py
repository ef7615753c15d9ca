"""The perf ledger, calibration, drift feedback and scrape endpoint
against the reference (``tests/test_ledger.py``'s contracts) on the CPU.

* ``PerfLedger`` stores, caps, compacts and reads samples as the
  reference does: the same scripted operations leave the same samples
  and stats (the port's root is ``$REPRO_TORCH_PERF_LEDGER_DIR``).
* ``ledger_key``/``config_digest`` give the reference's digests.
* An operator apply, a search candidate and an engine sample carry the
  reference's fields. Their model fields are the port's own: the H100
  prediction, the Hopper footprint in ``vmem_step_bytes`` /
  ``pipeline_depth``, and analytic flops/bytes in ``hlo_flops`` /
  ``hlo_bytes`` (2 × nnz × width; each real entry's pair, each gathered
  row once, the output once).
* ``calibration_report``, ``render_calibration``, ``detect_drift`` and
  ``apply_drift`` agree with the reference on the same samples.
* The endpoint serves ``/metrics``, ``/health``, ``/memory``,
  ``/stats`` and ``/explain/<graph>`` (the explainer's report; a
  sharded graph is 400, an unknown one 404).
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.obs import calibrate as jcal
from repro.obs import ledger as jled
from repro.sparse import generate as jgen
from repro.tune.model import TuneConfig as JTuneConfig
from repro_torch import serve as tserve
from repro_torch.api import ExecSpec
from repro_torch.core.sddmm import LibraSDDMM
from repro_torch.core.spmm import LibraSpMM
from repro_torch.obs import calibrate as tcal
from repro_torch.obs import ledger as tled
from repro_torch.obs.serve_http import ObsHTTPServer
from repro_torch.obs.trace import Tracer, use_tracer
from repro_torch.sparse import generate as tgen
from repro_torch.tune.cache import PlanCache
from repro_torch.tune.model import TuneConfig
from repro_torch.tune.search import search_spmm, spmm_candidates

CPU = ExecSpec(device="cpu")


def counter_clock(start=0.0):
    t = [start - 1.0]

    def clock():
        t[0] += 1.0
        return t[0]

    return clock


def synth(key, wall, pred, t, **extra):
    s = {"key": key, "wall_s": wall, "predicted_s": pred, "t": t,
         "op": "spmm", "backend": "xla", "tc_frac": 0.5, "sig": "s0"}
    s.update(extra)
    return s


# ------------------------------------------------------------ storage ---
def _store_script(mod, root, name):
    led = mod.PerfLedger(str(root), max_per_key=3, clock=counter_clock())
    docs = {}
    if name == "roundtrip":
        led.record({"key": "a", "wall_s": 1.0})
        led.record({"key": "b", "wall_s": 2.0, "t": 9.0})
        docs["samples"] = led.samples()
        docs["a"] = led.samples("a")
        docs["keys"] = sorted(led.keys())
    elif name == "requires_key":
        with pytest.raises(ValueError):
            led.record({"wall_s": 1.0})
        docs["samples"] = led.samples()
    elif name == "corrupt":
        led.record({"key": "a"})
        with open(led.path, "a") as f:
            f.write('{"key": "torn\n[1, 2]\n\n')
        led.record({"key": "b"})
        docs["samples"] = led.samples()
        docs["corrupt"] = led.stats()["corrupt_lines"]
        docs["dropped"] = led.compact()
        docs["after"] = led.stats()["corrupt_lines"]
    elif name == "cap":
        for i in range(5):
            led.record({"key": "a", "i": i})
        led.record({"key": "b", "i": 9})
        docs["dropped"] = led.compact()
        docs["samples"] = led.samples()
        docs["again"] = led.compact()
    elif name == "clear":
        led.record({"key": "a"})
        led.clear()
        led.clear()
        docs["samples"] = led.samples()
    st = led.stats()
    docs["stats"] = {k: v for k, v in st.items() if k != "path"}
    return docs


@pytest.mark.parametrize("name", ["roundtrip", "requires_key", "corrupt",
                                  "cap", "clear"])
def test_store_matches_reference(name, tmp_path):
    assert _store_script(tled, tmp_path / "p", name) == \
        _store_script(jled, tmp_path / "r", name)


def test_concurrent_writers_interleave_whole_lines(tmp_path):
    led = tled.PerfLedger(str(tmp_path))

    def write(w):
        for i in range(50):
            led.record({"key": f"k{w}", "i": i, "pad": "x" * 200})

    threads = [threading.Thread(target=write, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(led.samples()) == 200
    assert led.stats()["corrupt_lines"] == 0


def test_env_root_and_max(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PERF_LEDGER_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_PERF_LEDGER_MAX", "7")
    led = tled.PerfLedger()
    assert led.root == str(tmp_path) and led.max_per_key == 7
    monkeypatch.delenv("REPRO_TORCH_PERF_LEDGER_DIR")
    assert tled.default_ledger_dir().endswith("repro_torch_perf_ledger")


@pytest.mark.parametrize("args", [
    ("sig", "spmm", 32, "float32", "xla", "d1"),
    ("sig", "spmm", 64, "float32", "xla", "d1"),
    ("s2", "sddmm", 128, "float32", "cuda", "d9")])
def test_ledger_key_matches_reference(args):
    assert tled.ledger_key(*args) == jled.ledger_key(*args)


@pytest.mark.parametrize("fields", [
    {}, {"threshold": 3}, {"ts": 0, "cs": 0}, {"bk": 16, "ts_tile": 64}])
def test_config_digest_matches_reference(fields):
    cfg, jcfg = TuneConfig(**fields), JTuneConfig(**fields)
    assert tled.config_digest(cfg) == jled.config_digest(jcfg)
    assert (tled.config_digest(cfg.replace(source="search"))
            == tled.config_digest(cfg.replace(source="cache")))


# ---------------------------------------------------------- recording ---
def _record_spmm(mod_led, op, b, root):
    led = mod_led.PerfLedger(str(root), clock=counter_clock())
    op(b)
    assert led.samples() == []
    with mod_led.use_ledger(led):
        op(b)
        op(b)
    op(b)
    return led.samples()


def test_operator_apply_records_the_reference_fields(tmp_path):
    from repro.core.spmm import LibraSpMM as JSpMM

    rng = np.random.default_rng(0)
    b = rng.standard_normal((96, 16)).astype(np.float32)
    want = _record_spmm(jled, JSpMM(jgen.power_law_csr(
        128, 96, 6.0, seed=3), tune="off"), b, tmp_path / "r")
    op = LibraSpMM(tgen.power_law_csr(128, 96, 6.0, seed=3),
                   spec=ExecSpec(tune="off", device="cpu"))
    got = _record_spmm(tled, op, torch.from_numpy(b), tmp_path / "p")
    assert len(got) == len(want) == 2
    assert got[0]["key"] == got[1]["key"]
    assert set(got[0]) - {"hlo_flops", "hlo_bytes"} == \
        set(want[0]) - {"hlo_flops", "hlo_bytes"}
    assert {"hlo_flops", "hlo_bytes"} <= set(got[0])
    same = ("sig", "op", "m", "k", "nnz", "tc_frac", "tc_steps",
            "vpu_steps", "width", "dtype", "source", "tune_source")
    for k in same:
        assert got[0][k] == want[0][k], k
    s = got[0]
    vb = op.arrays.view_nbytes()     # the kernel path's segment view
    assert s["mem_bytes"] == {**vb, "total": op.arrays.resident_nbytes()}
    assert s["backend"] == "cuda" and s["wall_s"] > 0
    assert s["predicted_s"] > 0 and s["vmem_step_bytes"] > 0
    assert s["pipeline_depth"] >= 1
    a = op._a
    assert s["hlo_flops"] == 2.0 * a.nnz * 16
    cols = np.unique(a.indices).size
    assert s["hlo_bytes"] == 8 * a.nnz + 4 * cols * 16 + 4 * a.m * 16


def test_sddmm_apply_records(tmp_path):
    rng = np.random.default_rng(1)
    a = tgen.mixed_csr(96, 80, seed=4)
    x = torch.from_numpy(rng.standard_normal((96, 8)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((80, 8)).astype(np.float32))
    led = tled.PerfLedger(str(tmp_path), clock=counter_clock())
    with tled.use_ledger(led):
        LibraSDDMM(a, spec=CPU)(x, y)
    (s,) = led.samples()
    assert s["op"] == "sddmm" and s["width"] == 8 and s["predicted_s"] > 0
    rows = np.count_nonzero(np.diff(a.indptr))
    cols = np.unique(a.indices).size
    assert s["hlo_bytes"] == 8 * a.nnz + 4 * (rows + cols) * 8 + 4 * a.nnz


def test_search_candidates_recorded(tmp_path):
    a = tgen.power_law_csr(128, 96, 6.0, seed=3)
    ncand = len(spmm_candidates(a, n=16, mode="hybrid", threshold=None,
                                backend="torch"))
    ticks = iter(range(1, 1000))
    led = tled.PerfLedger(str(tmp_path), clock=counter_clock())
    with tled.use_ledger(led):
        search_spmm(a, n=16, backend="torch", device="cpu",
                    timer=lambda fn: float(next(ticks)))
    docs = led.samples()
    assert len(docs) == ncand
    assert {d["source"] for d in docs} == {"search"}
    assert [d["wall_s"] for d in docs] == [float(i + 1)
                                           for i in range(ncand)]


def test_apply_sampler_none_without_ledger():
    op = LibraSpMM(tgen.mixed_csr(64, 64, seed=5), spec=CPU)
    assert tled.apply_sampler(op, "spmm", width=16, dtype="float32",
                              backend="cuda") is None


# -------------------------------------------------------- calibration ---
def _calibration_inputs():
    return {
        "golden": [synth("k1", wall=2.0, pred=1.0, t=0.0),
                   synth("k2", wall=8.0, pred=1.0, t=1.0),
                   synth("k3", wall=0.5, pred=1.0, t=2.0, op="sddmm",
                         tc_frac=0.9)],
        "unusable": [synth("k", wall=0.0, pred=1.0, t=0.0),
                     {"key": "k2", "t": 1.0}],
        "footprints": [synth(f"k{i}", wall=1.0 + i, pred=1.0, t=float(i),
                             mem_bytes={"total": 1 << (18 + 3 * i)})
                       for i in range(4)],
        "drift": ([synth("k", wall=1.0, pred=1.0, t=float(i))
                   for i in range(4)]
                  + [synth("k", wall=2.0, pred=1.0, t=float(4 + i))
                     for i in range(4)]),
        "stable": [synth("k", wall=123.0, pred=1e-2, t=float(i))
                   for i in range(12)],
        "guard": ([synth("k", wall=1.0, pred=1.0, t=0.0)]
                  + [synth("k", wall=9.0, pred=1.0, t=1.0)] * 4),
        "unordered": ([synth("k", wall=2.0, pred=1.0, t=float(10 + i))
                       for i in range(4)]
                      + [synth("k", wall=1.0, pred=1.0, t=float(i))
                         for i in range(4)]),
    }


@pytest.mark.parametrize("name", sorted(_calibration_inputs()))
def test_calibration_and_drift_match_reference(name):
    samples = _calibration_inputs()[name]
    for mod_min in (5, 6):
        assert tcal.detect_drift(samples, min_samples=mod_min) == \
            jcal.detect_drift(samples, min_samples=mod_min)
    want = jcal.calibration_report(samples)
    got = tcal.calibration_report(samples)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert tcal.render_calibration(got, title="t") == \
        jcal.render_calibration(want, title="t")


def test_report_over_ledger_object(tmp_path):
    led = tled.PerfLedger(str(tmp_path), clock=counter_clock())
    led.record(synth("k", wall=3.0, pred=1.0, t=0.0))
    assert tcal.calibration_report(led)["n_samples"] == 1


def test_flagged_key_stales_cache_and_retunes(tmp_path):
    """Drift on a registry-built operator stales its PlanCache entry and
    drops the resident entry; re-registration searches again."""
    a = tgen.power_law_csr(128, 96, 6.0, seed=3)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (96, 16)).astype(np.float32))
    pc = PlanCache(str(tmp_path / "tune"))
    spec = ExecSpec(tune="search", tune_cache=pc, tune_backend="torch",
                    device="cpu")
    reg = tserve.GraphRegistry(max_graphs=4, device="cpu")
    reg.register(a, name="t/g", ops=("spmm",), spec=spec)
    op = reg.resolve("t/g").op("spmm").op
    led = tled.PerfLedger(str(tmp_path / "led"), clock=counter_clock())
    with tled.use_ledger(led):
        for _ in range(8):
            op(b)
    docs = led.samples()
    assert len(docs) == 8 and docs[0].get("tune_key")
    drifted = [dict(d, wall_s=d["wall_s"] * (40.0 if i >= 4 else 1.0))
               for i, d in enumerate(docs)]
    flags = tcal.detect_drift(drifted, threshold=1.5)
    assert len(flags) == 1 and flags[0]["tune_key"] == docs[0]["tune_key"]
    assert tcal.apply_drift(flags, pc, registry=reg) == {
        "flagged": 1, "staled": 1, "invalidated": 1}
    assert pc.stats()["stale_marked"] == 1
    assert "t/g" not in reg.stats()["names"]

    def searched(registry, name):
        tr = Tracer()
        with use_tracer(tr):
            registry.register(a, name=name, ops=("spmm",), spec=spec)
        names = []

        def walk(spans):
            for s in spans:
                names.append(s.name)
                walk(s.children)

        walk(tr.roots)
        return "tune.search" in names

    assert searched(reg, "t/g")
    assert pc.stats()["stale_misses"] == 1
    assert not searched(tserve.GraphRegistry(max_graphs=4, device="cpu"),
                        "t/g2")


def test_apply_drift_without_registry(tmp_path):
    out = tcal.apply_drift([{"key": "k", "sig": "s", "tune_key": "zz"}],
                           PlanCache(str(tmp_path)))
    assert out == {"flagged": 1, "staled": 0, "invalidated": 0}


# ---------------------------------------------------- engine sampling ---
def _mix(engine, mats, width=16, rounds=1):
    rng = np.random.default_rng(0)
    for _ in range(rounds):
        for name, a in mats.items():
            engine.submit(name, "spmm", b=torch.from_numpy(
                rng.standard_normal((a.k, width)).astype(np.float32)))
        engine.flush()


@pytest.mark.parametrize("every,rounds,want", [(2, 4, 2), (1, 3, 3),
                                               (None, 2, 0)])
def test_every_nth_apply_sampled(tmp_path, every, rounds, want):
    a = tgen.power_law_csr(128, 96, 6.0, seed=3)
    reg = tserve.GraphRegistry(max_graphs=4, width_buckets=(16,),
                               panel_buckets=(1, 2), device="cpu")
    reg.register(a, name="g", ops=("spmm",))
    led = tled.PerfLedger(str(tmp_path), clock=counter_clock())
    eng = tserve.SparseEngine(reg, ledger=led if every else None,
                              sample_every=every)
    _mix(eng, {"g": a}, rounds=rounds)
    docs = led.samples()
    assert len(docs) == want
    assert all(d["source"] == "engine" and d["op"] == "spmm"
               and d["wall_s"] > 0 and d["width"] == 16 for d in docs)


def test_sampled_results_bit_identical(tmp_path):
    a = tgen.power_law_csr(128, 96, 6.0, seed=3)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (96, 16)).astype(np.float32))
    reg = tserve.GraphRegistry(max_graphs=4, width_buckets=(16,),
                               panel_buckets=(1, 2), device="cpu")
    reg.register(a, name="g", ops=("spmm",))
    led = tled.PerfLedger(str(tmp_path))
    eng = tserve.SparseEngine(reg, ledger=led, sample_every=1)
    rid = eng.submit("g", "spmm", b=b)
    out = eng.flush()[rid]
    assert torch.equal(out, reg.resolve("g").op("spmm").op(b))
    assert len(led.samples()) == 1


# ------------------------------------------------------ HTTP endpoint ---
def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


def test_scrape_metrics_health_stats_and_explain_501():
    """Named for the 501 ``/explain`` answered before the explainer was
    ported; it now answers the report (200), a sharded graph 400 and an
    unknown graph 404."""
    from repro_torch.dist import ShardMesh
    from repro_torch.obs.explain import explain_entry

    a = tgen.power_law_csr(128, 96, 6.0, seed=3)
    reg = tserve.GraphRegistry(max_graphs=4, width_buckets=(16,),
                               panel_buckets=(1, 2), device="cpu")
    reg.register(a, name="t/g", ops=("spmm",))
    eng = tserve.SparseEngine(reg)
    eng.submit("t/g", "spmm", b=torch.ones(96, 16))
    eng.flush()
    with eng.serve_http() as srv:
        series = {}
        for line in _get(f"{srv.url}/metrics").splitlines():
            if line and not line.startswith("#"):
                name, _, val = line.rpartition(" ")
                series[name] = float(val)
        assert series["serve_submitted_total"] == 1.0
        assert series["serve_served_total"] == 1.0
        assert "registry_registered_total" in series
        h = json.loads(_get(f"{srv.url}/health"))
        assert "breakers" in h and "failures" in h
        st = json.loads(_get(f"{srv.url}/stats"))
        assert st["served"] == 1 and st["registry"]["graphs_resident"] == 1
        reg.register(a, name="t/s", ops=("spmm",),
                     mesh=ShardMesh(["cpu", "cpu"]))
        doc = json.loads(_get(f"{srv.url}/explain/t/g"))
        assert doc == json.loads(json.dumps(explain_entry(reg, "t/g")))
        assert doc["kind"] == "spmm" and doc["registry"]["name"] == "t/g"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{srv.url}/explain/t/s")
        assert ei.value.code == 400
        assert "sharded" in json.loads(ei.value.read().decode())["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{srv.url}/explain/t/nope")
        assert ei.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{srv.url}/bogus")
        assert ei.value.code == 404


def test_port_zero_binds_ephemeral():
    eng = tserve.SparseEngine(tserve.GraphRegistry(max_graphs=2,
                                                   device="cpu"))
    srv = ObsHTTPServer(eng).start()
    try:
        assert srv.port > 0 and str(srv.port) in srv.url
    finally:
        srv.stop()
