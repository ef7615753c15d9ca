"""Observability (``repro_torch.obs``): the span tracer and the metrics
registry against the reference's ``repro.obs.trace`` and
``repro.obs.metrics``. The same calls under the same injected clock give
the same dict trees, Chrome traces, Prometheus text and snapshots; the
``PlanCache`` reports the reference's counters; a traced tuner gives the
same plan and output as an untraced one.
"""
import json

import numpy as np
import pytest
import torch

from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.tune.cache import PlanCache as JPlanCache
from repro.tune.model import TuneConfig as JTune
from repro_torch.api import ExecSpec
from repro_torch.core.spmm import LibraSpMM
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.sparse import mixed_csr
from repro_torch.tune import PlanCache, TuneConfig


def fake_clock(start=100.0, step=0.5):
    t = [start - step]

    def clock():
        t[0] += step
        return t[0]

    return clock


def _trace_scenario(mod, step):
    """Nested spans, late attributes, events (one outside any span, which
    is dropped), flows across spans and events, an out-of-order close."""
    tr = mod.Tracer(clock=fake_clock(step=step))
    with tr.span("request", op="spmm", n=32, flow_id="r1") as root:
        root.event("admit", flow_id="r2", depth=3)
        with tr.span("tune.model", m=96, k=96) as sp:
            sp.set(threshold=3, obj=object.__name__)
        with tr.span("execute", flow_ids=["r1", "r2"]):
            tr.event("kernel", kernel="spmm_mxu")
        dangling = tr.span("dangling").open()
        tr.span("inner").open()
        dangling.close()
    tr.event("orphan")
    with tr.span("complete", flow_id="r1", ok=True, ratio=0.25):
        pass
    return tr


@pytest.mark.parametrize("step", [0.5, 1e-3, 1.25e-6])
def test_trace_exports_equal_the_reference(step):
    got, want = (_trace_scenario(m, step) for m in (ttrace, jtrace))
    assert got.to_dict() == want.to_dict()
    assert json.dumps(got.to_chrome_trace(), sort_keys=True) == json.dumps(
        want.to_chrome_trace(), sort_keys=True)
    assert got.current is None and want.current is None


def test_disabled_tracer_is_noop_and_the_default():
    assert ttrace.get_tracer().enabled is False
    tr = ttrace.Tracer(enabled=False)
    sp = tr.span("a", x=1)
    assert sp is ttrace.NULL_SPAN and tr.span("b") is ttrace.NULL_SPAN
    with sp as s:
        s.set(y=2).event("e")
    tr.event("orphan")
    assert tr.roots == [] and tr.to_dict() == []
    assert tr.to_chrome_trace()["traceEvents"] == []


def test_use_tracer_scopes_and_restores():
    prev = ttrace.get_tracer()
    t = ttrace.Tracer()
    with ttrace.use_tracer(t):
        assert ttrace.get_tracer() is t
        with ttrace.get_tracer().span("x"):
            pass
    assert ttrace.get_tracer() is prev
    assert [s.name for s in t.roots] == ["x"]


def _metrics_scenario(mod, null=False):
    m = (mod.NullMetricsRegistry if null else mod.MetricsRegistry)()
    m.counter("requests_total", "Total requests").inc(3)
    errs = m.counter("errors_total", "Errors", labels=("kind",))
    errs.inc(kind="nan")
    errs.inc(2.5, kind='quote"and\\slash')
    m.gauge("depth", "Queue depth").set(7)
    m.gauge("inflight", labels=("op",)).inc(4, op="spmm")
    h = m.histogram("lat_s", "Latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    hl = m.histogram("tune_s", labels=("op",), buckets=(0.01,))
    hl.observe(0.001, op="sddmm")
    with hl.time(op="spmm") as timer:
        pass
    assert timer.elapsed >= 0
    return m


@pytest.mark.parametrize("null", [False, True], ids=["registry", "null"])
def test_metrics_exports_equal_the_reference(null):
    got = _metrics_scenario(tmetrics, null)
    want = _metrics_scenario(jmetrics, null)
    # The timed observation's value is a wall time: compare all but it.
    for reg in (got, want):
        reg["tune_s"]._series.pop(("spmm",), None)
    assert got.exposition() == want.exposition()
    assert got.snapshot() == want.snapshot()
    if not null:
        assert 'errors_total{kind="nan"} 1' in got.exposition()
        assert 'lat_s_bucket{le="+Inf"} 3' in got.exposition()


def test_metric_kind_and_label_clashes_raise():
    m = tmetrics.MetricsRegistry()
    c = m.counter("c", labels=("a",))
    assert m.counter("c", labels=("a",)) is c
    with pytest.raises(ValueError):
        m.gauge("c")
    with pytest.raises(ValueError):
        m.counter("c", labels=("b",))
    with pytest.raises(ValueError):
        c.inc(-1, a="x")
    with pytest.raises(ValueError):
        c.inc(b="x")
    assert tmetrics.default_registry() is tmetrics.default_registry()


def test_plan_cache_reports_the_reference_counters(tmp_path):
    """The same lookups on both caches give the same exposition: hits,
    misses, quarantines by reason and bytes, stale marks."""
    regs = []
    for cls, cfg, root in ((PlanCache, TuneConfig, tmp_path / "port"),
                           (JPlanCache, JTune, tmp_path / "ref")):
        reg = tmetrics.MetricsRegistry() if cls is PlanCache \
            else jmetrics.MetricsRegistry()
        pc = cls(str(root), metrics=reg)
        assert pc.get("cold") is None
        pc.put("k", cfg(threshold=4))
        assert pc.get("k") is not None
        with open(pc._path("bad"), "w") as f:
            f.write("{not json")
        assert pc.get("bad") is None
        assert pc.mark_stale("k") and pc.get("k") is None
        regs.append(reg)
    assert regs[0].exposition() == regs[1].exposition()
    assert "tune_cache_hits_total 1" in regs[0].exposition()


def test_traced_tuning_gives_the_same_plan_and_output():
    a = mixed_csr(96, 96, seed=3)
    b = torch.from_numpy(np.random.default_rng(0).integers(
        -3, 4, (a.k, 16)).astype(np.float32))
    spec = ExecSpec(device="cpu")
    plain = LibraSpMM(a, spec=spec)
    tr = ttrace.Tracer()
    with ttrace.use_tracer(tr):
        traced = LibraSpMM(a, spec=spec)
    assert traced.tune_config == plain.tune_config
    assert torch.equal(traced(b), plain(b))
    (build,) = tr.to_dict()
    assert build["name"] == "plan.build"
    assert build["attrs"] == {"op": "spmm", "leg": "A"}
    (tune,) = [c for c in build["children"] if c["name"] == "plan.tune"]
    (span,) = tune["children"]
    assert span["name"] == "tune.model"
    assert span["attrs"]["threshold"] == plain.tune_config.threshold
