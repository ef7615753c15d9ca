"""The resilience layer against the reference: ``repro_torch.serve``'s
faults, degradation ladder, breakers, deadlines and plan-cache
quarantine hold ``repro.serve``'s contracts (``tests/test_resilience.py``)
on the CPU.

Each scenario is written once and driven through both packages with the
same seeded matrices (integer values), panels, fault schedule and
submission sequence: the reference on ``backend="xla"``, the port on
``device="cpu"`` with ``backend="cuda"`` (kernel wrappers on their CPU
twins) or ``"torch"``. The port's last rung is ``torch`` where the
reference's is ``xla``; the comparison reads the one as the other. The
port offers that rung on CPU registries only: on the card its ladder
ends at ``unsegmented`` (``test_torch_card.py``).
Every scenario's results (arrays bit for bit, typed errors by class,
reason, rid, graph and op), ``health()`` histograms, recorded backoff
sleeps and fired-fault logs must agree, and each package's served
results must equal its own direct operator calls.
"""
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core.sddmm import LibraSDDMM as JSDDMM
from repro.core.spmm import LibraSpMM as JSpMM
from repro.kernels import ops as jops
from repro.sparse import generate as jgen
from repro.tune import cache as jcache
from repro.tune.model import TuneConfig as JTuneConfig
from repro_torch import serve as tserve
from repro_torch.api import ExecSpec
from repro_torch.core.sddmm import LibraSDDMM
from repro_torch.core.spmm import LibraSpMM
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.sparse import generate as tgen
from repro_torch.tune import cache as tcache
from repro_torch.tune.model import TuneConfig

BASE_SEED = 20260808
_NOSLEEP = lambda s: None                                    # noqa: E731


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _pkg(side: str, backend: str):
    if side == "ref":
        def direct(kind, a):
            op = (JSpMM if kind == "spmm" else JSDDMM)(a, tune="off")
            if kind == "spmm":
                return lambda b: op(b, backend=backend)
            return lambda x, y: op(x, y, backend=backend)

        return types.SimpleNamespace(
            side=side, gen=jgen, serve=jserve, direct=direct,
            reg=lambda **kw: jserve.GraphRegistry(backend=backend,
                                                  tune="off", **kw),
            arr=jnp.asarray, np=np.asarray, nan=lambda *s: jnp.full(
                s, jnp.nan), finite=lambda x: bool(jnp.all(jnp.isfinite(x))),
            last="xla")

    def direct(kind, a):
        cls = LibraSpMM if kind == "spmm" else LibraSDDMM
        return cls(a, spec=ExecSpec(tune="off", device="cpu",
                                    backend=backend))

    return types.SimpleNamespace(
        side=side, gen=tgen, serve=tserve, direct=direct,
        reg=lambda **kw: tserve.GraphRegistry(backend=backend, device="cpu",
                                              tune="off", **kw),
        arr=lambda x: torch.from_numpy(np.array(x, np.float32)),
        np=lambda x: x.detach().numpy(),
        nan=lambda *s: torch.full(s, float("nan")),
        finite=lambda x: bool(torch.isfinite(x).all()), last="torch")


PAIRS = {"xla/cuda": ("xla", "cuda"), "xla/torch": ("xla", "torch")}


def _ints(rng, *shape):
    return rng.integers(-4, 5, shape).astype(np.float32)


def _matrix(P, which, seed):
    """A generator pattern with non-zero integer values in [-4, 4]."""
    a = (P.gen.mixed_csr(96, 80, seed=seed) if which == "mixed"
         else P.gen.mixed_csr(80, 64, seed=seed) if which == "small"
         else P.gen.mixed_csr(96, 96, seed=seed) if which == "square"
         else P.gen.power_law_csr(72, 96, 5.0, seed=seed))
    r = np.random.default_rng(seed)
    vals = (r.integers(1, 5, a.nnz) * r.choice([-1, 1], a.nnz)).astype(
        np.float32)
    return P.serve.as_csr(a, vals)


def _rung(name):
    return "torch" if name == "xla" else name


def _norm(obj):
    """Read the reference's ``xla`` rung as ``torch`` in any health
    histogram, fault log or site tuple."""
    if isinstance(obj, dict):
        return {_rung(k) if isinstance(k, str) else k: _norm(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_norm(v) for v in obj)
    return _rung(obj) if isinstance(obj, str) else obj


def _enc(P, out):
    """A flush result, comparable across packages."""
    if isinstance(out, P.serve.ServeError):
        return ("error", type(out).__name__, out.reason, out.rid, out.graph,
                out.op)
    return ("ok", P.np(out))


def _results(P, out, rids):
    return [_enc(P, out[r]) for r in rids]


def _same(want, got, path=""):
    if isinstance(want, dict):
        assert set(want) == set(got), (path, sorted(want), sorted(got))
        for k in want:
            _same(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), (path, want, got)
        for i, (w, g) in enumerate(zip(want, got)):
            _same(w, g, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert want.shape == got.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert want == got, (path, want, got)


def _rule(P, **kw):
    return P.serve.FaultRule(**kw)


def _engine(P, reg, **kw):
    kw.setdefault("sleep", _NOSLEEP)
    return P.serve.SparseEngine(reg, **kw)


def _spmm_case(P, rng, *, seed, which="mixed", rules=(), n=3, policy=None,
               eng_kw=None, reg_kw=None):
    """n SpMM requests against one graph under a fault schedule."""
    a = _matrix(P, which, seed)
    reg = P.reg(max_graphs=2, width_buckets=(32,), **(reg_kw or {}))
    reg.register(a, name="g", ops=("spmm",))
    plan = P.serve.FaultPlan([_rule(P, **r) for r in rules])
    kw = dict(eng_kw or {})
    if policy is not None:
        kw["resilience"] = P.serve.ResiliencePolicy(**policy)
    sleeps = []
    eng = _engine(P, reg, faults=plan, sleep=sleeps.append, **kw)
    direct = P.direct("spmm", a)
    bs = [P.arr(_ints(rng, a.k, 32)) for _ in range(n)]
    rids = [eng.submit("g", "spmm", b=b) for b in bs]
    out = eng.flush()
    ok = all(np.array_equal(P.np(out[r]), P.np(direct(b)))
             for r, b in zip(rids, bs)
             if not isinstance(out[r], P.serve.ServeError))
    return {"results": _results(P, out, rids), "same_as_direct": ok,
            "health": _norm(eng.health()), "sleeps": sleeps,
            "log": _norm(plan.log)}


# ------------------------------------------------------------ scenarios ---
def sc_fast_fault(P, rng):
    doc = _spmm_case(P, rng, seed=31, rules=[dict(
        kth=1, graph="g", op="spmm", strategy="fast")])
    assert doc["health"]["degraded_served"]["single"] == 3
    return doc


def sc_partial(P, rng):
    doc = _spmm_case(P, rng, seed=32, rules=[dict(
        kth=2, graph="g", op="spmm", strategy="fast")],
        reg_kw={"panel_buckets": (1,)}, eng_kw={"max_panel": 4})
    assert doc["health"]["degraded_served"]["single"] == 2
    return doc


def sc_transient(P, rng):
    doc = _spmm_case(P, rng, seed=33, which="small", n=1, rules=[
        dict(kth=1, graph="g", op="spmm", strategy="fast"),
        dict(kth=1, graph="g", op="spmm", strategy="single")],
        policy=dict(backoff_base_s=0.001, backoff_cap_s=0.004))
    assert doc["sleeps"] == [0.001]
    return doc


def sc_resource(P, rng):
    doc = _spmm_case(P, rng, seed=36, which="small", n=1, rules=[dict(
        kth=1, graph="g", strategy="fast", kind="resource")])
    assert doc["health"]["failures"] == {"resource": 1}
    return doc


def sc_nan_validate(P, rng):
    doc = _spmm_case(P, rng, seed=40, which="small", n=1, rules=[dict(
        kth=1, graph="g", strategy="fast", kind="nan")],
        policy=dict(validate=True))
    assert doc["health"]["failures"] == {"nonfinite": 1}
    return doc


def sc_nan_flows(P, rng):
    a = _matrix(P, "small", 41)
    reg = P.reg(max_graphs=2, width_buckets=(32,))
    reg.register(a, name="g", ops=("spmm",))
    plan = P.serve.FaultPlan([_rule(P, kth=1, graph="g", strategy="fast",
                                    kind="nan")])
    eng = _engine(P, reg, faults=plan)
    rid = eng.submit("g", "spmm", b=P.arr(_ints(rng, a.k, 32)))
    out = eng.flush()[rid]
    return {"error": isinstance(out, P.serve.ServeError),
            "finite": P.finite(out), "nan_count": int(np.isnan(
                P.np(out)).sum()), "health": _norm(eng.health())}


def sc_exhausted(P, rng):
    a1, a2 = _matrix(P, "mixed", 34), _matrix(P, "power", 35)
    reg = P.reg(max_graphs=4, width_buckets=(32,))
    reg.register(a1, name="bad", ops=("spmm",))
    reg.register(a2, name="good", ops=("spmm",))
    eng = _engine(P, reg, resilience=P.serve.ResiliencePolicy(
        attempts_per_rung=1))
    eng.faults = P.serve.FaultPlan([_rule(P, kth=1, graph="bad",
                                          times=-1)])
    rid_bad = eng.submit("bad", "spmm", b=P.arr(_ints(rng, a1.k, 32)))
    b2 = P.arr(_ints(rng, a2.k, 32))
    rid_good = eng.submit("good", "spmm", b=b2)
    out = eng.flush()
    return {"results": _results(P, out, [rid_bad, rid_good]),
            "good": np.array_equal(P.np(out[rid_good]),
                                   P.np(P.direct("spmm", a2)(b2))),
            "health": _norm(eng.health()), "log": _norm(eng.faults.log)}


def sc_sddmm_ladder(P, rng):
    a = _matrix(P, "square", 37)
    reg = P.reg(max_graphs=2, width_buckets=(32,))
    reg.register(a, name="g")
    plan = P.serve.FaultPlan([
        _rule(P, kth=1, graph="g", op="sddmm", strategy="fast"),
        _rule(P, kth=1, graph="g", op="sddmm", strategy="single",
              times=-1)])
    eng = _engine(P, reg, faults=plan, resilience=P.serve.ResiliencePolicy(
        attempts_per_rung=1))
    x, y = P.arr(_ints(rng, a.m, 32)), P.arr(_ints(rng, a.k, 32))
    rid = eng.submit("g", "sddmm", x=x, y=y)
    out = eng.flush()
    h = _norm(eng.health())
    assert h["degraded_served"] == {"unsegmented": 1}
    return {"results": _results(P, out, [rid]),
            "same_as_direct": np.array_equal(
                P.np(out[rid]), P.np(P.direct("sddmm", a)(x, y))),
            "health": h}


def sc_edge_vals(P, rng):
    a = _matrix(P, "square", 39)
    reg = P.reg(max_graphs=2, width_buckets=(32,))
    reg.register(a, name="g", ops=("spmm",))
    plan = P.serve.FaultPlan([_rule(P, kth=1, graph="g", strategy="fast")])
    eng = _engine(P, reg, faults=plan)
    b, ev = P.arr(_ints(rng, a.k, 32)), P.arr(_ints(rng, a.nnz))
    rid = eng.submit("g", "spmm", b=b, edge_vals=ev)
    out = eng.flush()
    return {"results": _results(P, out, [rid]),
            "health": _norm(eng.health())}


def sc_poison(P, rng):
    a = _matrix(P, "mixed", 42)
    reg = P.reg(max_graphs=2, width_buckets=(32,))
    reg.register(a, name="g", ops=("spmm",))
    eng = _engine(P, reg, resilience=P.serve.ResiliencePolicy(
        validate=True, attempts_per_rung=1))
    good = [P.arr(_ints(rng, a.k, 32)) for _ in range(2)]
    rids = [eng.submit("g", "spmm", b=b) for b in good]
    rids.append(eng.submit("g", "spmm", b=P.nan(a.k, 32)))
    out = eng.flush()
    return {"results": _results(P, out, rids),
            "health": _norm(eng.health())}


def sc_breaker(P, rng):
    a = _matrix(P, "small", 43)
    reg = P.reg(max_graphs=2, width_buckets=(32,))
    reg.register(a, name="g", ops=("spmm",))
    plan = P.serve.FaultPlan([_rule(P, kth=1, graph="g", strategy="fast",
                                    times=3)])
    eng = _engine(P, reg, faults=plan, resilience=P.serve.ResiliencePolicy(
        breaker_threshold=2, probe_after=2, attempts_per_rung=1))
    states, results = [], []
    for _ in range(7):
        rid = eng.submit("g", "spmm", b=P.arr(_ints(rng, a.k, 32)))
        results.append(_enc(P, eng.flush()[rid]))
        states.append(eng.health()["breakers"]["g/spmm"])
    assert [s["state"] for s in states] == [
        "closed", "open", "open", "open", "open", "closed", "closed"]
    return {"states": states, "results": results,
            "health": _norm(eng.health())}


def sc_deadlines(P, rng):
    a = _matrix(P, "mixed", 45)
    reg = P.reg(max_graphs=2, width_buckets=(32,))
    reg.register(a, name="g", ops=("spmm",))
    eng = _engine(P, reg, resilience=P.serve.ResiliencePolicy(
        min_deadline_ms=2.0))
    b = P.arr(_ints(rng, a.k, 32))
    reasons = []
    for bad in (0.0, -5.0, 1.0):
        try:
            eng.submit("g", "spmm", b=b, deadline_ms=bad)
        except P.serve.AdmissionError as exc:
            reasons.append(exc.reason)
    rid_ok = eng.submit("g", "spmm", b=b, deadline_ms=50.0)
    rejected = eng.stats()["rejected"]
    first = _enc(P, eng.flush()[rid_ok])
    clk = _Clock()
    eng2 = _engine(P, reg, clock=clk)
    bs = [P.arr(_ints(rng, a.k, 32)) for _ in range(5)]
    rids = [eng2.submit("g", "spmm", b=x, deadline_ms=5.0) for x in bs[:3]]
    rids += [eng2.submit("g", "spmm", b=x) for x in bs[3:]]
    clk.t += 0.1
    out = eng2.flush()
    return {"reasons": reasons, "rejected": rejected, "first": first,
            "results": _results(P, out, rids),
            "health": _norm(eng2.health())}


def sc_autoflush(P, rng):
    a = _matrix(P, "small", 46)
    reg = P.reg(max_graphs=2, width_buckets=(32,))
    reg.register(a, name="g", ops=("spmm",))
    eng = _engine(P, reg, flush_at_depth=2)
    bs = [P.arr(_ints(rng, a.k, 32)) for _ in range(2)]
    rids = [eng.submit("g", "spmm", b=b) for b in bs]
    depth = eng.queue_depth
    out = eng.flush()
    clk = _Clock()
    eng2 = _engine(P, reg, flush_slack_ms=50.0, clock=clk)
    rid2 = eng2.submit("g", "spmm", b=bs[0], deadline_ms=10.0)
    depth2 = eng2.queue_depth
    out2 = eng2.flush()
    return {"depths": [depth, depth2],
            "results": _results(P, out, rids) + _results(P, out2, [rid2]),
            "health": [_norm(eng.health()), _norm(eng2.health())]}


def sc_no_resilience(P, rng):
    a1, a2 = _matrix(P, "mixed", 47), _matrix(P, "power", 48)
    reg = P.reg(max_graphs=4, width_buckets=(32,))
    reg.register(a1, name="bad", ops=("spmm",))
    reg.register(a2, name="good", ops=("spmm",))
    plan = P.serve.FaultPlan([_rule(P, kth=1, graph="bad", strategy="fast",
                                    times=-1)])
    eng = _engine(P, reg, resilience=False, faults=plan)
    rids = [eng.submit("bad", "spmm", b=P.arr(_ints(rng, a1.k, 32))),
            eng.submit("good", "spmm", b=P.arr(_ints(rng, a2.k, 32)))]
    out = eng.flush()
    return {"results": _results(P, out, rids),
            "health": _norm(eng.health())}


def sc_warm_fault(P, rng):
    a = P.gen.mixed_csr(80, 64, seed=49)
    plan = P.serve.FaultPlan([_rule(P, kth=1, strategy="warm")])
    reg = P.reg(max_graphs=2, width_buckets=(16,), panel_buckets=(1,),
                faults=plan)
    try:
        reg.register(a, name="g", ops=("spmm",), warm_widths=(16,))
    except P.serve.InjectedFault as exc:
        return {"raised": type(exc).__name__, "site": _norm(exc.site),
                "log": _norm(plan.log)}
    return {"raised": None}


def sc_gnn_fails_alone(P, rng):
    a = _matrix(P, "square", 50)
    reg = P.reg(max_graphs=4)
    eng = _engine(P, reg, resilience=P.serve.ResiliencePolicy(
        validate=True, attempts_per_rung=1))
    svc = P.serve.GNNService(eng)
    params = [{"w": _ints(rng, 32, 32)}, {"w": _ints(rng, 32, 8)}]
    if P.side == "ref":
        model = [{"w": jnp.asarray(p["w"])} for p in params]
    else:
        from repro_torch.models import convert

        model = convert.gcn_params_from_jax(params, device="cpu")
    svc.register_gcn("gcn", a, model,
                     norm_edge_vals=np.ones(a.nnz, np.float32))
    s_good = svc.submit("gcn", P.arr(_ints(rng, a.m, 32)))
    s_bad = svc.submit("gcn", P.nan(a.m, 32))
    res = svc.flush()
    raised = None
    try:
        svc.score("gcn", P.nan(a.m, 32))
    except P.serve.ServeError as exc:
        raised = exc.reason
    return {"results": _results(P, res, [s_good, s_bad]), "raised": raised,
            "health": _norm(eng.health())}


def sc_plain_rung(P, rng):
    """With every kernel rung latched, a CPU registry answers on the
    plain rung (the reference's ``xla``, the port's ``torch``); on the
    card the port's ladder ends above it (``test_torch_card.py``)."""
    a = _matrix(P, "square", 53)
    reg = P.reg(max_graphs=2, width_buckets=(32,))
    reg.register(a, name="g")
    plan = P.serve.FaultPlan([_rule(P, kth=1, graph="g", strategy=s,
                                    times=-1)
                              for s in ("fast", "single", "unsegmented")])
    eng = _engine(P, reg, faults=plan, resilience=P.serve.ResiliencePolicy(
        attempts_per_rung=1))
    b = P.arr(_ints(rng, a.k, 32))
    x, y = P.arr(_ints(rng, a.m, 32)), P.arr(_ints(rng, a.k, 32))
    rids = [eng.submit("g", "spmm", b=b), eng.submit("g", "sddmm", x=x, y=y)]
    out = eng.flush()
    h = _norm(eng.health())
    assert h["degraded_served"] == {"torch": 2}
    return {"results": _results(P, out, rids),
            "same_as_direct": [
                np.array_equal(P.np(out[rids[0]]),
                               P.np(P.direct("spmm", a)(b))),
                np.array_equal(P.np(out[rids[1]]),
                               P.np(P.direct("sddmm", a)(x, y)))],
            "health": h, "log": _norm(plan.log)}


SCENARIOS = {
    "fast_fault": sc_fast_fault, "partial": sc_partial,
    "transient": sc_transient, "resource": sc_resource,
    "nan_validate": sc_nan_validate, "nan_flows": sc_nan_flows,
    "exhausted": sc_exhausted, "sddmm_ladder": sc_sddmm_ladder,
    "edge_vals": sc_edge_vals, "poison": sc_poison, "breaker": sc_breaker,
    "deadlines": sc_deadlines, "autoflush": sc_autoflush,
    "no_resilience": sc_no_resilience, "warm_fault": sc_warm_fault,
    "gnn_fails_alone": sc_gnn_fails_alone, "plain_rung": sc_plain_rung,
}


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name, pair):
    jb, tb = PAIRS[pair]
    want = SCENARIOS[name](_pkg("ref", jb), np.random.default_rng(7))
    got = SCENARIOS[name](_pkg("port", tb), np.random.default_rng(7))
    _same(want, got)


# ------------------------------------------------------- classification ---
def _exc(side, case):
    S = jserve if side == "ref" else tserve
    E = jops.ApplyError if side == "ref" else _build.ApplyError
    site = ("g", "spmm", "fast")
    return {
        "compile": lambda: E("compile", ("k",), ValueError("x")),
        "injected": lambda: S.InjectedFault(site, 1),
        "injected_resource": lambda: S.SimulatedResourceExhausted(site, 1),
        "injected_kind_resource": lambda: S.InjectedFault(site, 2,
                                                          kind="resource"),
        "execute_injected": lambda: E("execute", ("k",),
                                      S.InjectedFault(site, 2)),
        "execute_resource": lambda: E("execute", ("k",), S.InjectedFault(
            site, 2, kind="resource")),
        "resource_msg": lambda: RuntimeError(
            "RESOURCE_EXHAUSTED: out of memory"),
        "oom": lambda: RuntimeError("CUDA out of memory"),
        "nonfinite": lambda: RuntimeError("non-finite output"),
        "nonfinite_type": lambda: S.resilience.NonFiniteOutput(site),
        "runtime": lambda: ValueError("boom"),
    }[case]()


CLASSES = ["compile", "injected", "injected_resource",
           "injected_kind_resource", "execute_injected", "execute_resource",
           "resource_msg", "oom", "nonfinite", "nonfinite_type", "runtime"]


@pytest.mark.parametrize("case", CLASSES)
def test_classify_apply_error_matches_reference(case):
    """Injected faults class as ``injected``/``resource`` in both
    packages (the port lacked the reference's ``kind`` branch)."""
    want = jops.classify_apply_error(_exc("ref", case))
    got = tops.classify_apply_error(_exc("port", case))
    assert got == want
    if case.startswith("injected") or case.startswith("execute"):
        assert got in ("injected", "resource")


def test_first_apply_failure_leaves_the_key_unseen(monkeypatch):
    """A first apply at a key whose kernel library does not build (on
    the card) raises ``ApplyError("compile")`` and does not count the
    key; the next call tries again and, once it builds, applies."""
    seen, calls = set(), []

    def broken(backend, device):
        calls.append(backend)
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(tops, "kernels_ready", broken)
    dev = torch.device("cpu")
    for _ in range(2):
        with pytest.raises(_build.ApplyError) as ei:
            tops.apply_at(seen, ("k",), dev, lambda x, backend: x + 1, 1,
                          backend="cuda")
        assert ei.value.stage == "compile"
        assert tops.classify_apply_error(ei.value) == "compile"
    assert seen == set() and calls == ["cuda", "cuda"]
    monkeypatch.setattr(tops, "kernels_ready", lambda backend, device: None)
    assert tops.apply_at(seen, ("k",), dev, lambda x, backend: x + 1, 1,
                         backend="cuda") == 2
    assert seen == {("k",)}
    monkeypatch.setattr(tops, "kernels_ready", broken)
    assert tops.apply_at(seen, ("k",), dev, lambda x, backend: x + 2, 1,
                         backend="cuda") == 3 and len(calls) == 2


def test_poison_output_clones():
    out = torch.ones(3, 2)
    bad = tserve.faults.poison_output(out)
    assert torch.isnan(bad[0, 0]) and torch.isfinite(out).all()
    pair = tserve.faults.poison_output((out, out))
    assert all(torch.isnan(p).sum() == 1 for p in pair)


# -------------------------------------------------------- cache quarantine ---
def _quarantine_doc(cache_mod, cfg_cls, corrupt, root):
    pc = cache_mod.PlanCache(str(root), max_entries=8)
    cfg = cfg_cls(threshold=4, source="search")
    pc.put("k1", cfg)
    doc = {"roundtrip": pc.get("k1") == cfg.replace(source="cache")}
    path = corrupt(pc, "k1", mode="garbage")
    doc["garbage_miss"] = pc.get("k1") is None
    doc["moved"] = (not os.path.exists(path)) and os.path.exists(
        os.path.join(pc.quarantine_dir, "k1.json"))
    pc.put("k1", cfg)
    corrupt(pc, "k1", mode="tamper")
    doc["tamper_miss"] = pc.get("k1") is None
    st = pc.stats()
    doc["stats"] = {k: st[k] for k in ("quarantined", "quarantined_by_reason",
                                       "quarantine_dir_files")}
    pc.put("k1", cfg)
    doc["healed"] = pc.get("k1") == cfg.replace(source="cache")
    doc["size"] = pc.size()
    doc["empty"] = corrupt(cache_mod.PlanCache(str(root / "none")))
    return doc


def test_cache_quarantine_matches_reference(tmp_path):
    want = _quarantine_doc(jcache, JTuneConfig, jserve.corrupt_cache_entry,
                           tmp_path / "ref")
    got = _quarantine_doc(tcache, TuneConfig, tserve.corrupt_cache_entry,
                          tmp_path / "port")
    assert got == want
    assert got["stats"]["quarantined"] == 2 and got["healed"]


# ------------------------------------------------------------ chaos storm ---
def _storm(P, seed, n_faults=6, kinds=("raise", "resource"),
           times=(1, 2, -1)):
    rng = np.random.default_rng(BASE_SEED)
    a1, a2 = _matrix(P, "mixed", 51), _matrix(P, "power", 52)
    reg = P.reg(max_graphs=4, width_buckets=(32,))
    reg.register(a1, name="g1", ops=("spmm",))
    reg.register(a2, name="g2")
    subs = [("g1", "spmm", {"b": P.arr(_ints(rng, a1.k, 32))})
            for _ in range(3)]
    subs += [("g2", "spmm", {"b": P.arr(_ints(rng, a2.k, 32))})
             for _ in range(2)]
    subs.append(("g2", "sddmm", {"x": P.arr(_ints(rng, a2.m, 32)),
                                 "y": P.arr(_ints(rng, a2.k, 32))}))
    sites = [(g, op, s) for g, op in (("g1", "spmm"), ("g2", "spmm"),
                                      ("g2", "sddmm"))
             for s in ("fast", "single", "unsegmented", P.last)]
    plan = P.serve.FaultPlan.storm(seed, sites, n_faults=n_faults, max_k=4,
                                   kinds=kinds, times=times)
    # NaN faults are caught only by the opt-in output screening.
    eng = _engine(P, reg, faults=plan, resilience=P.serve.ResiliencePolicy(
        attempts_per_rung=2, validate="nan" in kinds))
    rids = [eng.submit(g, op, **kw) for g, op, kw in subs]
    out = eng.flush()
    clean = _engine(P, reg).serve(subs)
    want = [clean[r] for r in sorted(clean)]
    for rid, w in zip(rids, want):     # never silently wrong, never lost
        got = out[rid]
        if isinstance(got, P.serve.ServeError):
            assert got.reason in ("injected", "resource", "nonfinite",
                                  "runtime")
        else:
            assert np.array_equal(P.np(got), P.np(w))
    h = eng.health()
    return {"results": _results(P, out, rids), "log": _norm(plan.log),
            "rules": [_norm((r.kth, r.graph, r.op, r.strategy, r.kind,
                             r.times)) for r in plan.rules],
            "histograms": _norm({k: h[k] for k in (
                "failures", "degraded_served", "retry_hist", "retries",
                "errors_returned", "faults_injected", "breakers")})}


@pytest.mark.parametrize("offset", range(10))
def test_fault_storm_matches_reference(offset):
    """Under the same seeded storm both packages answer the same way:
    the same results and errors, rung, retry and failure histograms."""
    seed = (BASE_SEED + offset) % 2**16
    want = _storm(_pkg("ref", "xla"), seed)
    got = _storm(_pkg("port", "cuda"), seed)
    _same(want, got)


def test_storm_replays_identically():
    """Same seed ⇒ same schedule ⇒ same fired-fault log and histograms,
    with NaN faults in the mix."""
    P = _pkg("port", "cuda")
    runs = [_storm(P, BASE_SEED + 1, n_faults=8,
                   kinds=("raise", "resource", "nan"))
            for _ in range(2)]
    _same(runs[0], runs[1])
    assert runs[0]["log"]
