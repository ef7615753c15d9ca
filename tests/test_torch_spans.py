"""Spans inside the port (``repro_torch.obs.trace``): the profiler
bridge, follow mode, the device clock, a span stack per thread, the
plan build's stage counters, the off path, and the benchmark's readers
of them (``gpubench/metrics/plan_*_s.py`` and ``*_combine_share.*``).

Everything here runs on the CPU at a small size; the device clock is
held against the profiler's kernel time by the ``cuda``-marked test at
the end (``python -m pytest -m cuda tests/test_torch_spans.py`` on the
card).
"""
import pathlib
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.api import ExecSpec
from repro_torch.core import preprocess
from repro_torch.kernels import ops
from repro_torch.models import gnn
from repro_torch.obs import trace
from repro_torch.serve import GNNService, GraphRegistry, SparseEngine
from repro_torch.sparse import power_law_csr

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CPU = torch.device("cpu")
DIMS = [16, 12, 4]
SPEC = ExecSpec(tune="model", reorder="on", device="cpu")
STEP_SPANS = {"gnn.step", "gnn.forward", "gnn.backward", "gnn.update",
              "gnn.spmm", "apply.revalue", "apply.tc", "apply.cc",
              "apply.combine", "apply.permute"}
AGNN_SPANS = STEP_SPANS | {"gnn.sddmm", "gnn.edge_softmax"}
FLUSH_SPANS = {"gnn_service.flush", "gnn_service.aggregate",
               "gnn_service.dense", "serve.flush", "serve.execute",
               "serve.apply", "kernels.execute", "apply.tc", "apply.cc",
               "apply.combine"}


@pytest.fixture
def follow():
    """The process tracer, emptied before and after the test."""
    tr = trace.get_tracer()
    tr.clear()
    yield tr
    tr.clear()


@pytest.fixture(scope="module")
def graph():
    return power_law_csr(300, 300, 6.0, seed=3)


@pytest.fixture(scope="module")
def gops(graph):
    return gnn.GraphOps(graph, spec=SPEC)


def _model(kind):
    gen = torch.Generator().manual_seed(5)
    cls = {"gcn": gnn.GCN, "agnn": gnn.AGNN}[kind]
    return cls(DIMS, generator=gen)


def _step(kind, g):
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(g.m, DIMS[0], generator=gen)
    labels = torch.randint(0, DIMS[-1], (g.m,), generator=gen)
    args = ((torch.from_numpy(gnn.gcn_norm_edges(g.a)),)
            if kind == "gcn" else ())
    return gnn.train_step(_model(kind), g, x, labels, *args, lr=0.2)


def _service(graph, kind):
    svc = GNNService(SparseEngine(GraphRegistry(device="cpu",
                                                backend="cuda")))
    reg = {"gcn": svc.register_gcn, "agnn": svc.register_agnn}[kind]
    reg("m", graph, _model(kind))
    return svc


def _names(spans):
    out = set()
    todo = list(spans)
    while todo:
        sp = todo.pop()
        out.add(sp.name)
        todo.extend(sp.children)
    return out


def _find(spans, name):
    out, todo = [], list(spans)
    while todo:
        sp = todo.pop()
        if sp.name == name:
            out.append(sp)
        todo.extend(sp.children)
    return out


# ----------------------------------------------------- profiler bridge ---
@pytest.mark.parametrize("kind", ["gcn", "agnn"])
def test_profiled_step_shows_the_program_ranges(kind, gops, follow):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(kind, gops)
    ranges = {e.name for e in prof.events()}
    want = AGNN_SPANS if kind == "agnn" else STEP_SPANS
    assert want <= ranges, want - ranges
    assert want <= _names(follow.roots)
    assert [sp.name for sp in follow.roots] == ["gnn.step"]


@pytest.mark.parametrize("kind", ["gcn", "agnn"])
def test_profiled_flush_shows_the_service_ranges(kind, graph, follow):
    svc = _service(graph, kind)
    feats = torch.randn(graph.m, DIMS[0],
                        generator=torch.Generator().manual_seed(7))
    svc.submit("m", feats)
    svc.submit("m", feats, node_ids=[1, 2, 3])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = svc.flush()
    assert len(out) == 2
    ranges = {e.name for e in prof.events()}
    # GCN's panels are column-packed; AGNN's valued SpMM and SDDMM
    # stacks are not.
    want = FLUSH_SPANS | ({"gnn_service.attention", "gnn.edge_softmax",
                           "apply.revalue"}
                          if kind == "agnn" else {"serve.pack"})
    assert want <= ranges, want - ranges
    (flush,) = [sp for sp in follow.roots if sp.name == "gnn_service.flush"]
    assert want <= _names([flush])
    assert "serve.bucket" not in ranges


# ------------------------------------------------------- follow mode ---
def test_default_tracer_records_only_while_the_profiler_does(gops, follow):
    assert follow.enabled is False and follow.active is False
    _step("agnn", gops)
    assert follow.roots == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert follow.active
        _step("agnn", gops)
    assert not follow.active
    assert [sp.name for sp in follow.roots] == ["gnn.step"]
    _step("agnn", gops)
    assert [sp.name for sp in follow.roots] == ["gnn.step"]


def test_follow_mode_keeps_the_newest_roots(follow, monkeypatch):
    """The cap counts spans, not roots: roots of two spans each."""
    monkeypatch.setattr(trace, "FOLLOW_SPANS", 8)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(20):
            with trace.span("s", i=i):
                with trace.span("child"):
                    pass
    kept = [sp.attrs["i"] for sp in follow.roots]
    assert kept == list(range(20 - len(kept), 20))
    assert 2 <= len(kept) <= 8 // 2 + 1


def test_a_new_profiler_session_drops_the_last_ones_spans(follow):
    """Follow mode holds the last session alone: a span asked for with
    the profiler off ends the session, and the next one starts empty."""
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("first"):
            pass
    assert trace.span("off") is trace.NULL_SPAN and follow.lapsed
    assert [sp.name for sp in follow.roots] == ["first"]
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("second"):
            pass
        with trace.span("third"):
            pass
    assert [sp.name for sp in follow.roots] == ["second", "third"]
    assert not follow.lapsed


def test_an_enabled_tracer_records_without_the_profiler(gops):
    tr = trace.Tracer()
    with trace.use_tracer(tr):
        _step("gcn", gops)
    assert STEP_SPANS <= _names(tr.roots)
    step = tr.to_dict()[0]
    assert step["name"] == "gnn.step"
    assert "device_dur_s" not in step       # no device clock on the CPU


# -------------------------------------------------------- device clock ---
def test_cpu_spans_have_no_device_clock(gops):
    tr = trace.Tracer()
    with trace.use_tracer(tr):
        _step("agnn", gops)
    spans = _find(tr.roots, "apply.combine")
    assert spans and all(sp.device_s is None for sp in spans)
    chrome = tr.to_chrome_trace()["traceEvents"]
    assert not any("device_dur_us" in e.get("args", {}) for e in chrome)


def test_device_seconds_export_only_where_a_span_has_them():
    tr = trace.Tracer(clock=iter([0.0, 1.0, 2.0, 3.0]).__next__)
    with tr.span("outer"):
        with tr.span("inner"):
            pass
    tr.roots[0].children[0]._dev = 0.25
    (outer,) = tr.to_dict()
    assert "device_dur_s" not in outer
    assert outer["children"][0]["device_dur_s"] == 0.25
    args = {e["name"]: e["args"] for e in tr.to_chrome_trace()["traceEvents"]}
    assert args["inner"] == {"device_dur_us": 250000.0}
    assert args["outer"] == {}


# ------------------------------------------------------------- threads ---
def test_backward_spans_nest_under_the_step(gops):
    tr = trace.Tracer()
    with trace.use_tracer(tr):
        _step("agnn", gops)
    (step,) = tr.roots
    by_name = {c.name: c for c in step.children}
    assert list(by_name) == ["gnn.forward", "gnn.backward", "gnn.update"]
    bwd = by_name["gnn.backward"].children
    assert {(c.name, c.attrs.get("phase")) for c in bwd} == {
        ("gnn.spmm", "bwd"), ("gnn.sddmm", "bwd")}
    legs = sorted(c.attrs["leg"] for c in bwd if c.name == "gnn.spmm")
    # AGNN's dX (A) and dY (Aᵀ) of each SDDMM and each SpMM's dB (Aᵀ);
    # the first SDDMM's inputs hold no gradient but the weights'.
    assert set(legs) == {"A", "At"}
    # An SpMM combines its streams' partials; the SDDMM's kernels store
    # at the canonical positions and need no combine.
    for c in bwd:
        kids = {k.name for k in c.children}
        assert kids >= {"apply.tc", "apply.cc"}
        assert ("apply.combine" in kids) == (c.name == "gnn.spmm"), kids


def test_a_backward_thread_nests_under_the_waiting_span(gops):
    """Autograd runs a card's backward on its own thread while the caller
    waits inside ``backward()``: spans that thread opens inside the
    backward nest under the caller's open span, and nest among
    themselves on their own stack. The backward here runs on a thread
    of the test's own, as it would on autograd's."""
    tr = trace.Tracer()
    vals = torch.rand(gops.nnz, generator=torch.Generator().manual_seed(8))
    b = torch.randn(gops.m, 4, generator=torch.Generator().manual_seed(9),
                    requires_grad=True)
    out = gops.spmm(vals, b)
    with trace.use_tracer(tr):
        with tr.span("gnn.backward") as waiting:
            worker = threading.Thread(target=out.sum().backward)
            worker.start()
            worker.join()
            assert tr.current is waiting
    assert b.grad is not None and tr._stacks == {}
    (root,) = tr.roots
    (leg,) = root.children
    assert (leg.name, leg.attrs) == ("gnn.spmm", {"leg": "At",
                                                  "phase": "bwd"})
    assert [c.name for c in leg.children] == [
        "apply.revalue", "apply.tc", "apply.cc", "apply.combine",
        "apply.permute"]


def test_threads_keep_their_own_stacks():
    tr = trace.Tracer()
    opened = threading.Event()
    release = threading.Event()

    def other():
        with tr.span("other"):
            opened.set()
            release.wait(5)

    with tr.span("main") as main:
        th = threading.Thread(target=other)
        th.start()
        opened.wait(5)
        with tr.span("inner") as inner:
            assert tr.current is inner
        release.set()
        th.join()
    # Outside an autograd backward a thread's first span is a root, not
    # a child of whatever another thread has open.
    assert [c.name for c in main.children] == ["inner"]
    assert sorted(sp.name for sp in tr.roots) == ["main", "other"]
    assert tr.current is None and tr._stacks == {}


# ---------------------------------------------------- plan-build stages ---
def test_stage_clock_counts_self_time():
    clock = trace.StageClock()
    with clock.stage("outer"):
        time.sleep(0.02)
        with clock.stage("inner"):
            time.sleep(0.03)
    s = clock.seconds
    assert 0.02 <= s["outer"] < 0.03 + 0.02 and s["inner"] >= 0.03


def test_graph_ops_stages_sum_to_its_build_time(graph):
    t0 = time.perf_counter()
    g = gnn.GraphOps(graph, spec=SPEC)
    wall = time.perf_counter() - t0
    stages = g.build_s
    assert set(stages) == {*preprocess.BUILD_STAGES, "transpose",
                           "upload", "rest"}
    assert all(v >= 0 for v in stages.values()), stages
    total = sum(stages.values())
    assert total <= wall and wall - total < 0.05 * wall + 1e-3
    assert set(g.build_legs) == {"A", "At", "SDDMM"}
    for leg in g.build_legs.values():
        assert set(leg) == {*preprocess.BUILD_STAGES, "rest"}
    for k in preprocess.BUILD_STAGES:
        legs = sum(leg[k] for leg in g.build_legs.values())
        assert stages[k] >= legs > 0 or k == "features"
    assert stages["features"] > 0 and stages["reorder"] > 0


def test_plan_build_spans_nest_by_stage(graph):
    tr = trace.Tracer()
    with trace.use_tracer(tr):
        gnn.GraphOps(graph, spec=SPEC)
    builds = [sp for sp in tr.roots if sp.name == "plan.build"]
    assert [sp.attrs for sp in builds] == [
        {"op": "spmm", "leg": "A"}, {"op": "spmm", "leg": "At"},
        {"op": "sddmm", "leg": "SDDMM"}]
    for b in builds:
        assert [c.name for c in b.children] == [
            "plan.reorder", "plan.tune", "plan.preprocess"]
        assert "plan.features" in [c.name for c in b.children[0].children]
    assert [sp.name for sp in tr.roots if sp.name != "plan.build"] == [
        "plan.transpose", "plan.features", "plan.upload"]


def test_registry_entry_keeps_the_stage_seconds(graph):
    reg = GraphRegistry(device="cpu", backend="cuda")
    t0 = time.perf_counter()
    reg.register(graph, name="g", ops=("spmm", "sddmm"))
    wall = time.perf_counter() - t0
    stages = reg.plan_build_s()
    assert stages["tune"] > 0 and stages["preprocess"] > 0
    assert stages["rest"] >= 0 and sum(stages.values()) <= wall
    entry = reg.resolve("g")
    want = {k: sum(op.op.plan.meta["build_s"][k]
                   for op in entry.ops.values())
            for k in preprocess.BUILD_STAGES}
    assert {k: stages[k] for k in want} == pytest.approx(want)


# ----------------------------------------------------------- off path ---
class _CountingKey:
    """An apply key whose string form counts how often it is built."""

    def __init__(self):
        self.built = 0

    def __str__(self):
        self.built += 1
        return "key"


def test_off_path_builds_no_attributes(follow):
    key = _CountingKey()
    seen = set()

    def apply(x, backend):
        return x + 1

    x = torch.zeros(2)
    for _ in range(3):
        ops.apply_at(seen, key, CPU, apply, x, backend="torch")
    assert key.built == 0 and follow.roots == []
    with profile(activities=[ProfilerActivity.CPU]):
        ops.apply_at(seen, key, CPU, apply, x, backend="torch")
    assert key.built == 1
    assert [sp.attrs["key"] for sp in follow.roots] == ["key"]


def test_off_span_is_the_shared_null_span(follow):
    assert trace.span("x", torch.zeros(1), op="spmm") is trace.NULL_SPAN
    assert trace.get_tracer().span("x") is trace.NULL_SPAN


# ------------------------------------------------ the benchmark readers ---
READERS = ["plan_features_s", "plan_reorder_s", "plan_tune_s",
           "plan_preprocess_s", "sddmm_combine_share.train",
           "spmm_combine_share.train", "sddmm_combine_share.serve"]


def _record(cell, tmp_path, seed=2147483659):
    from gpubench import cells, harness

    _, cfg, mix = cells.cell(cell)
    cfg = {**cfg, "graph": {"generator": "power_law", "m": 400, "k": 400,
                            "avg_row": 6.0, "alpha": 1.8, "seed": 1},
           "dims": [16, 12, 4]}
    spans = cells.Spans()
    world = cells.World(cfg, mix["kind"], CPU, spans,
                        tune_cache=str(tmp_path / "tune"))
    with profile(activities=[ProfilerActivity.CPU]):
        if mix["kind"] == "train":
            prog = cells.TrainProgram(world, seed)
            for _ in range(2):
                prog.step()
        else:
            prog = cells.ServeProgram(world, seed, 2)
            prog.submit(0, None)
            prog.submit(1, [3, 4])
            prog.flush()
    summary = {"busy_s": 1.0, "window_s": 1.0, "device_ops": [],
               "idle_gaps": []}
    return harness.Record(cfg, mix, CPU, spans, {}, summary, world)


def _read(name, rec):
    from gpubench import harness

    return harness.reader(name)(rec)


@pytest.mark.parametrize("cell", ["agnn_arxiv.train", "gcn_arxiv.train",
                                  "gcn_arxiv.serve", "agnn_arxiv.serve"])
def test_readers_return_a_number_or_none(cell, tmp_path, follow):
    import json

    rec = _record(cell, tmp_path)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in bench["per_layer"]
              if cell in m.get("workloads", [])}
    got = {name: _read(name, rec) for name in READERS}
    for name, value in got.items():
        assert value is None or isinstance(value, float), (name, value)
        if name.startswith("plan_") and name in listed:
            assert value is not None and value > 0, (name, value)
        if name.startswith("plan_") and name not in listed:
            assert value is None, (name, value)
    # No device clock on the CPU: the shares find nothing to read.
    assert all(got[n] is None for n in READERS if "share" in n)


def _device_times(spans, seconds):
    for sp in _find(spans, "apply.combine") + _find(
            spans, "gnn.step") + _find(spans, "gnn_service.flush"):
        sp._dev = seconds[sp.name, sp.attrs.get("op")]


@pytest.mark.parametrize("cell", ["agnn_arxiv.train", "gcn_arxiv.train",
                                  "agnn_arxiv.serve", "gcn_arxiv.serve"])
def test_share_readers_read_the_device_seconds(cell, tmp_path, follow):
    rec = _record(cell, tmp_path)
    _device_times(follow.roots, {("apply.combine", "sddmm"): 0.002,
                                 ("apply.combine", "spmm"): 0.001,
                                 ("gnn.step", None): 0.05,
                                 ("gnn_service.flush", None): 0.04})
    combines = {op: len([sp for sp in _find(follow.roots, "apply.combine")
                         if sp.attrs["op"] == op])
                for op in ("spmm", "sddmm")}
    kind = rec.mix["kind"]
    den = 0.05 * 2 if kind == "train" else 0.04
    for name, op in (("sddmm_combine_share.train", "sddmm"),
                     ("spmm_combine_share.train", "spmm"),
                     ("sddmm_combine_share.serve", "sddmm")):
        got = _read(name, rec)
        each = 0.002 if op == "sddmm" else 0.001
        if not name.endswith(kind) or combines[op] == 0:
            assert got is None, (name, got)
        else:
            assert got == pytest.approx(100 * each * combines[op] / den)
    rec.trace = None
    assert _read("spmm_combine_share.train", rec) is None


def test_readers_leave_a_program_without_counters_out(tmp_path, follow):
    rec = _record("gcn_arxiv.train", tmp_path)
    del rec.world.gops.build_s
    assert _read("plan_tune_s", rec) is None
    follow.clear()
    assert _read("spmm_combine_share.train", rec) is None


# ------------------------------------------------------------ the card ---
@pytest.mark.cuda
def test_device_clock_reads_the_combine_kernels():
    """On one AGNN step under the profiler, the ``apply.combine`` spans'
    device seconds lie within 10% of the kernels the profiler puts
    inside those ranges: the SpMM combine's zeros, ``cat`` and
    ``index_add_``.

    The SDDMM has no combine (K3 and K4 store at the canonical
    positions), so every such span is an SpMM's, forward and backward;
    the step is queued behind a device sleep, so the host runs ahead and
    each span's interval is its kernels'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType

    dev = torch.device("cuda", 0)
    a = power_law_csr(60000, 60000, 13.7, seed=1)
    g = gnn.GraphOps(a, spec=ExecSpec(tune="model", reorder="auto",
                                      device="cuda"))
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(a.m, 256, generator=gen, device=dev)
    labels = torch.randint(0, 8, (a.m,), generator=gen, device=dev)
    # Wide layers: each combine's kernels then far outlast the device's
    # gaps between them, which its span's interval also holds.
    model = gnn.AGNN([256, 256, 256]).to(dev)
    gnn.train_step(model, g, x, labels, lr=0.1)       # warm-up
    tr = trace.get_tracer()
    tr.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(400_000_000)
        gnn.train_step(model, g, x, labels, lr=0.1)
        torch.cuda.synchronize()
    combines = _find(tr.roots, "apply.combine")
    tr.clear()
    clocked = sum(sp.device_s for sp in combines)
    events = list(prof.profiler.kineto_results.events())
    ranges = [(e.start_ns(), e.end_ns(), e.start_thread_id())
              for e in events if e.device_type() == DeviceType.CPU
              and e.name() == "apply.combine"]
    launched = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and "LaunchKernel" in e.name():
            launched[e.correlation_id()] = (e.start_ns(),
                                            e.start_thread_id())

    def inside(corr):
        at = launched.get(corr)
        return at is not None and any(s <= at[0] <= t and at[1] == th
                                      for s, t, th in ranges)

    kernels = [e for e in events if e.device_type() == DeviceType.CUDA
               and inside(e.correlation_id())]
    launched_s = sum(e.end_ns() - e.start_ns() for e in kernels) / 1e9
    assert combines and {sp.attrs["op"] for sp in combines} == {"spmm"}
    assert any("indexfunc" in e.name().lower() for e in kernels)
    assert abs(clocked - launched_s) <= 0.1 * launched_s, (clocked,
                                                           launched_s)
