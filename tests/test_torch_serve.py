"""The serving tier against the reference: ``repro_torch.serve`` holds
``repro.serve``'s contracts (``tests/test_serve_engine.py``) on the CPU.

Each scenario is written once and driven through both packages with the
same seeded matrices, panels and submission sequence: the reference on
``backend="xla"`` (``"pallas"`` with ``interpret=True`` in one case), the
port on ``device="cpu"`` with ``backend="torch"`` or ``"cuda"`` (whose
kernel wrappers run their plain twins on CPU tensors). Both registries
build untuned plans (``tune="off"``), so the plans, pack limits and apply
keys agree. What each scenario returns must agree:

* served results bit for bit on integer-valued data, within rtol 1e-5 on
  random fp32;
* ``stats()`` and ``health()`` key for key and value for value (wall
  times aside), and the Prometheus text the same series;
* ``GNNService`` scores bit for bit on integer data, within
  1e-4·max|ref| on random data, with weights carried by
  ``convert.gcn_params_from_jax`` / ``agnn_params_from_jax``.

The window-sharded scenario (``mesh=``) is in
``tests/test_torch_serve_sharded.py``: the reference's sharded apply
raises on this tree's jax (ROADMAP §3), so it is held to the batched
entries this file holds to the reference.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core.sddmm import LibraSDDMM as JSDDMM
from repro.core.spmm import LibraSpMM as JSpMM
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.sparse import generate as jgen
from repro_torch import serve as tserve
from repro_torch.api import ExecSpec
from repro_torch.core.sddmm import LibraSDDMM
from repro_torch.core.spmm import LibraSpMM
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import convert
from repro_torch.models import gnn as tgnn
from repro_torch.sparse import generate as tgen

# Wall-clock readings: equal in kind, not in value.
TIMED = {"serve_time_s", "requests_per_s"}
# Resident plan bytes: equal when both sides serve the compact view
# (xla/torch); the kernel path holds the segment view plus its derived
# lengths (held to the reference's bytes in tests/test_torch_memstat.py).
BYTES = {"resident_bytes", "peak_bytes"}


def _pkg(side: str, backend: str):
    """The calls a scenario makes, bound to one package."""
    if side == "ref":
        def reg(**kw):
            return jserve.GraphRegistry(backend=backend, tune="off", **kw)

        def direct(kind, a):
            cls = JSpMM if kind == "spmm" else JSDDMM
            op = cls(a, tune="off")
            if kind == "spmm":
                return lambda b: op(b, backend=backend)
            return lambda x, y: op(x, y, backend=backend)

        return types.SimpleNamespace(
            side=side, gen=jgen, serve=jserve, reg=reg, direct=direct,
            arr=jnp.asarray, np=np.asarray, backend=backend,
            zeros=lambda *s: jnp.zeros(s, jnp.float32),
            pad=lambda b, n: jnp.pad(b, ((0, 0), (0, n))))

    def reg(**kw):
        return tserve.GraphRegistry(backend=backend, device="cpu",
                                    tune="off", **kw)

    def direct(kind, a):
        cls = LibraSpMM if kind == "spmm" else LibraSDDMM
        op = cls(a, spec=ExecSpec(tune="off", device="cpu",
                                  backend=backend))
        return op

    return types.SimpleNamespace(
        side=side, gen=tgen, serve=tserve, reg=reg, direct=direct,
        arr=lambda x: torch.from_numpy(np.array(x, np.float32)),
        np=lambda x: x.detach().cpu().numpy(), backend=backend,
        zeros=lambda *s: torch.zeros(s),
        pad=lambda b, n: torch.nn.functional.pad(b, (0, n)))


PAIRS = {"xla/torch": ("xla", "torch"), "xla/cuda": ("xla", "cuda")}


def _pair(name):
    jb, tb = PAIRS[name]
    return _pkg("ref", jb), _pkg("port", tb)


def _skip(pair):
    return TIMED | (BYTES if pair == "xla/cuda" else set())


def _ints(rng, *shape):
    return rng.integers(-4, 5, shape).astype(np.float32)


def _nonzero_ints(rng, n):
    v = rng.integers(1, 5, n) * rng.choice([-1, 1], n)
    return v.astype(np.float32)


def _int_matrix(P, a_fn, seed):
    """The generator's pattern with non-zero integer values in [-4, 4]
    (an explicit zero would fail the SDDMM plan's nnz check in both
    packages, ROADMAP §3)."""
    a = a_fn(P.gen)
    return P.serve.as_csr(a, _nonzero_ints(np.random.default_rng(seed),
                                            a.nnz))


def _same(want, got, path="", exact=True, skip=TIMED):
    """Recursive equality of two scenario observables; arrays exactly or
    within rtol 1e-5, and the reference's ``xla`` rung read as ``torch``.
    Keys in ``skip`` must be present on both sides."""
    if isinstance(want, dict):
        want = {("torch" if k == "xla" else k): v for k, v in want.items()}
        assert set(want) == set(got), (path, sorted(want), sorted(got))
        for k in want:
            if k in skip:
                continue
            _same(want[k], got[k], f"{path}.{k}", exact, skip)
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            _same(w, g, f"{path}[{i}]", exact, skip)
    elif isinstance(want, np.ndarray):
        assert want.shape == got.shape, (path, want.shape, got.shape)
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=path)
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), path
    else:
        assert want == got, (path, want, got)


def _stats(eng):
    st = dict(eng.stats())
    st["registry"] = dict(st["registry"])
    return st


def _reason(P, fn):
    try:
        fn()
    except P.serve.AdmissionError as exc:
        return exc.reason
    raise AssertionError("no AdmissionError")


# ------------------------------------------------------------ scenarios ---
def sc_aliases(P, rng):
    a = _int_matrix(P, lambda g: g.mixed_csr(96, 80, seed=1), 1)
    reg = P.reg(max_graphs=4)
    n1 = reg.register(a, name="tenantA/g")
    n2 = reg.register(a, name="tenantB/g")
    a2 = P.serve.as_csr(a, np.asarray(a.data) * 2.0)
    n3 = reg.register(a2, name="tenantC/g")
    reg2 = P.reg(max_graphs=4)
    reg2.register(a, name="spmm-only", ops=("spmm",))
    before = sorted(reg2.resolve("spmm-only").ops)
    reg2.register(a, name="both", ops=("spmm", "sddmm"))
    return {"same": reg.resolve(n1) is reg.resolve(n2),
            "distinct": reg.resolve(n3) is not reg.resolve(n1),
            "stats": reg.stats(), "stats2": reg2.stats(),
            "ops_before": before,
            "ops_after": sorted(reg2.resolve("spmm-only").ops)}


def sc_lru(P, rng):
    mats = [_int_matrix(P, lambda g, i=i: g.power_law_csr(
        64 + 8 * i, 64, 4.0, seed=i), 10 + i) for i in range(4)]
    reg = P.reg(max_graphs=2)
    eng = P.serve.SparseEngine(reg)
    for i, a in enumerate(mats[:2]):
        reg.register(a, name=f"g{i}", ops=("spmm",))
    b0 = P.arr(_ints(rng, mats[0].k, 32))
    out0 = list(eng.serve([("g0", "spmm", {"b": b0})]).values())
    reg.register(mats[2], name="g2", ops=("spmm",))
    members = {n: n in reg for n in ("g0", "g1", "g2")}
    reason = _reason(P, lambda: eng.submit(
        "g1", "spmm", b=P.arr(_ints(rng, mats[1].k, 32))))
    reg.register(mats[1], name="g1", ops=("spmm",))
    out1 = list(eng.serve([("g1", "spmm", {
        "b": P.arr(_ints(rng, mats[1].k, 32))})]).values())
    return {"out0": [P.np(o) for o in out0], "members": members,
            "reason": reason, "out1": [P.np(o) for o in out1],
            "stats": _stats(eng)}


def sc_rebound(P, rng):
    mats = [P.gen.power_law_csr(64 + 8 * i, 64, 4.0, seed=i)
            for i in range(3)]
    reg = P.reg(max_graphs=2)
    reg.register(mats[0], name="g", ops=("spmm",))
    reg.register(mats[1], name="g", ops=("spmm",))
    k_before = reg.resolve("g").k
    reg.register(mats[2], name="h", ops=("spmm",))
    return {"k_before": k_before, "g": "g" in reg,
            "k_after": reg.resolve("g").k, "stats": reg.stats()}


def sc_alias_warm(P, rng):
    a = P.gen.mixed_csr(80, 64, seed=2)
    reg = P.reg(max_graphs=2, width_buckets=(16, 32), panel_buckets=(1,))
    reg.register(a, name="first", ops=("spmm",))
    warmed0 = reg.stats()["warmed_executables"]
    reg.register(a, name="second", ops=("spmm",), warm_widths=(16,))
    return {"warmed0": warmed0, "stats": reg.stats()}


def sc_warm(P, rng):
    a = _int_matrix(P, lambda g: g.mixed_csr(80, 64, seed=2), 2)
    reg = P.reg(max_graphs=2, width_buckets=(16, 32), panel_buckets=(1, 2))
    reg.register(a, name="g", ops=("spmm",), warm_widths=(16, 32))
    warmed = reg.stats()["warmed_executables"]
    eng = P.serve.SparseEngine(reg)
    out = eng.serve([("g", "spmm", {"b": P.arr(_ints(rng, a.k, 16))}),
                     ("g", "spmm", {"b": P.arr(_ints(rng, a.k, 32))})])
    return {"warmed": warmed, "out": [P.np(out[r]) for r in sorted(out)],
            "stats": _stats(eng)}


def sc_admission(P, rng):
    a = P.gen.mixed_csr(64, 48, seed=3)
    reg = P.reg(max_graphs=2, width_buckets=(32, 64))
    reg.register(a, name="g", ops=("spmm",))
    eng = P.serve.SparseEngine(reg, max_queue=2)
    z = P.zeros
    reasons = [
        _reason(P, lambda: eng.submit("nope", "spmm", b=z(48, 8))),
        _reason(P, lambda: eng.submit("g", "sddmm", x=z(64, 8),
                                      y=z(48, 8))),
        _reason(P, lambda: eng.submit("g", "qr", b=z(48, 8))),
        _reason(P, lambda: eng.submit("g", "spmm", b=z(47, 8))),
        _reason(P, lambda: eng.submit("g", "spmm", b=[[1.0, 2.0]])),
        _reason(P, lambda: eng.submit("g", "spmm", b=z(48, 128))),
        _reason(P, lambda: eng.submit("g", "spmm", b=z(48, 8),
                                      edge_vals=z(3))),
    ]
    eng.submit("g", "spmm", b=P.arr(_ints(rng, a.k, 8)))
    eng.submit("g", "spmm", b=P.arr(_ints(rng, a.k, 8)))
    reasons.append(_reason(P, lambda: eng.submit(
        "g", "spmm", b=P.arr(_ints(rng, a.k, 8)))))
    st = _stats(eng)
    served = len(eng.flush())
    return {"reasons": reasons, "stats": st, "served": served,
            "depth": eng.queue_depth}


def sc_packing(P, rng):
    a1 = _int_matrix(P, lambda g: g.mixed_csr(96, 80, seed=4), 4)
    a2 = _int_matrix(P, lambda g: g.power_law_csr(72, 96, 5.0, seed=5), 5)
    reg = P.reg(max_graphs=4, width_buckets=(16, 32, 64),
                panel_buckets=(1, 2, 4))
    reg.register(a1, name="g1")
    reg.register(a2, name="g2")
    eng = P.serve.SparseEngine(reg)
    rids = []
    for i in range(11):   # > max_panel ⇒ several chunks per bucket
        w = (7, 16, 23, 32, 64)[i % 5]
        rids.append(eng.submit("g1", "spmm", b=P.arr(_ints(rng, a1.k, w))))
    for i in range(3):
        w = (16, 24, 32)[i]
        rids.append(eng.submit("g2", "sddmm", x=P.arr(_ints(rng, a2.m, w)),
                               y=P.arr(_ints(rng, a2.k, w))))
    out = eng.flush()
    return {"rids": sorted(out) == sorted(rids),
            "out": [P.np(out[r]) for r in rids], "stats": _stats(eng)}


def sc_identity(P, rng, ints=True):
    """Bucket-width requests against direct operator calls, and a
    sub-bucket request against the direct call on its padded panel."""
    draw = _ints if ints else (
        lambda r, *s: r.standard_normal(s).astype(np.float32))
    a = P.gen.mixed_csr(96, 80, seed=6)
    if ints:
        a = P.serve.as_csr(a, _nonzero_ints(np.random.default_rng(6), a.nnz))
    reg = P.reg(max_graphs=2, width_buckets=(32, 64),
                panel_buckets=(1, 2, 4))
    reg.register(a, name="g")
    eng = P.serve.SparseEngine(reg)
    spmm, sddmm = P.direct("spmm", a), P.direct("sddmm", a)
    bs = [P.arr(draw(rng, a.k, 32)) for _ in range(3)]
    xys = [(P.arr(draw(rng, a.m, 64)), P.arr(draw(rng, a.k, 64)))
           for _ in range(2)]
    rids_b = [eng.submit("g", "spmm", b=b) for b in bs]
    rids_s = [eng.submit("g", "sddmm", x=x, y=y) for x, y in xys]
    b_sub = P.arr(draw(rng, a.k, 20))
    rid_sub = eng.submit("g", "spmm", b=b_sub)
    out = eng.flush()
    same = all(np.array_equal(P.np(out[r]), P.np(spmm(b)))
               for r, b in zip(rids_b, bs))
    same &= all(np.array_equal(P.np(out[r]), P.np(sddmm(x, y)))
                for r, (x, y) in zip(rids_s, xys))
    same &= np.array_equal(P.np(out[rid_sub]),
                           P.np(spmm(P.pad(b_sub, 12)))[:, :20])
    np.testing.assert_allclose(P.np(out[rid_sub]), P.np(spmm(b_sub)),
                               rtol=1e-5, atol=1e-5)
    return {"same_as_direct": same,
            "out": [P.np(out[r]) for r in rids_b + rids_s + [rid_sub]],
            "stats": _stats(eng)}


def sc_edge_vals(P, rng):
    a = _int_matrix(P, lambda g: g.mixed_csr(96, 96, seed=7), 7)
    reg = P.reg(max_graphs=2, width_buckets=(32,), panel_buckets=(1, 2, 4))
    reg.register(a, name="g", ops=("spmm",))
    eng = P.serve.SparseEngine(reg)
    op = reg.resolve("g").op("spmm").op
    reqs = []
    for _ in range(3):
        b, ev = P.arr(_ints(rng, a.k, 32)), P.arr(_ints(rng, a.nnz))
        reqs.append((eng.submit("g", "spmm", b=b, edge_vals=ev), b, ev))
    out = eng.flush()
    stats = _stats(eng)   # before the direct calls upload more views
    same = True
    for rid, b, ev in reqs:
        if P.side == "ref":
            arrs = jref.revalue_spmm_arrays(op.arrays, ev)
            direct = jops.spmm_apply(arrs, b, m=op.m, nwin=op.nwin,
                                     backend="xla", cfg=op.tune_config)
        else:
            arrs = tref.revalue_spmm_arrays(
                op.arrays.for_backend("torch", revalue=True), ev)
            direct = tops.spmm_apply(arrs, b, m=op.m, nwin=op.nwin,
                                     backend="torch")
        same &= np.array_equal(P.np(out[rid]), P.np(direct))
    return {"same_as_revalued_direct": same,
            "out": [P.np(out[r]) for r, _, _ in reqs], "stats": stats}


def sc_foreign(P, rng):
    """A request queued by one caller survives another caller draining
    the shared engine."""
    a = _int_matrix(P, lambda g: g.mixed_csr(96, 96, seed=23), 23)
    reg = P.reg(max_graphs=4)
    eng = P.serve.SparseEngine(reg)
    reg.register(a, name="direct", ops=("spmm",))
    b = P.arr(_ints(rng, a.k, 32))
    rid = eng.submit("direct", "spmm", b=b)
    svc = P.serve.GNNService(eng)
    params = [{"w": _ints(rng, 16, 8)}]
    svc.register_gcn("gcn", a, _model(P, "gcn", params))
    svc.score("gcn", P.arr(_ints(rng, a.m, 16)))
    out = eng.flush()
    got = P.np(out[rid])
    same = np.array_equal(got, P.np(P.direct("spmm", a)(b)))
    rid2 = eng.submit("direct", "spmm", b=b)
    eng.serve([("direct", "spmm", {"b": P.arr(_ints(rng, a.k, 32))})])
    return {"out": got, "same_as_direct": same,
            "redeposited": rid2 in eng.flush(), "stats": _stats(eng)}


def _model(P, kind, params):
    if P.side == "ref":
        return [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    carry = (convert.gcn_params_from_jax if kind == "gcn"
             else convert.agnn_params_from_jax)
    return carry(params, device="cpu")


def sc_gnn_batching(P, rng):
    """Concurrent GCN scorings traverse the engine as one bucket per
    layer."""
    a = P.gen.mixed_csr(80, 80, seed=22)
    reg = P.reg(max_graphs=2, width_buckets=(16, 32), panel_buckets=(1, 2, 4))
    eng = P.serve.SparseEngine(reg)
    svc = P.serve.GNNService(eng)
    params = [{"w": _ints(rng, 32, 32)}, {"w": _ints(rng, 32, 16)}]
    svc.register_gcn("gcn", a, _model(P, "gcn", params),
                     norm_edge_vals=np.ones(a.nnz, np.float32))
    rids = [svc.submit("gcn", P.arr(_ints(rng, a.m, 32))) for _ in range(4)]
    res = svc.flush()
    return {"out": [P.np(res[r]) for r in rids], "stats": _stats(eng)}


SCENARIOS = {
    "aliases": sc_aliases, "lru": sc_lru, "rebound": sc_rebound,
    "alias_warm": sc_alias_warm, "warm": sc_warm,
    "admission": sc_admission, "packing": sc_packing,
    "identity": sc_identity, "edge_vals": sc_edge_vals,
    "foreign": sc_foreign, "gnn_batching": sc_gnn_batching,
}


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name, pair):
    """The same submissions through both packages: results bit for bit
    (integer data), ``stats()`` value for value."""
    ref_p, port_p = _pair(pair)
    want = SCENARIOS[name](ref_p, np.random.default_rng(100))
    got = SCENARIOS[name](port_p, np.random.default_rng(100))
    _same(want, got, skip=_skip(pair))


def test_identity_on_random_data_within_rtol():
    ref_p, port_p = _pair("xla/cuda")
    want = sc_identity(ref_p, np.random.default_rng(5), ints=False)
    got = sc_identity(port_p, np.random.default_rng(5), ints=False)
    assert want["same_as_direct"] and got["same_as_direct"]
    _same(want, got, exact=False, skip=_skip("xla/cuda"))


def test_identity_against_the_reference_pallas_path():
    """The reference's kernel path (Pallas, interpret mode) against the
    port's kernel path (``backend="cuda"`` on the CPU twins)."""
    want = sc_identity(_pkg("ref", "pallas"), np.random.default_rng(9))
    got = sc_identity(_pkg("port", "cuda"), np.random.default_rng(9))
    _same(want, got, skip=_skip("xla/cuda"))


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_health_and_prometheus_series_match(pair):
    ref_p, port_p = _pair(pair)
    docs = []
    for P in (ref_p, port_p):
        rng = np.random.default_rng(3)
        a = _int_matrix(P, lambda g: g.mixed_csr(64, 64, seed=8), 8)
        reg = P.reg(max_graphs=2, width_buckets=(16, 32))
        reg.register(a, name="g")
        eng = P.serve.SparseEngine(reg, metrics=reg.metrics)
        eng.serve([("g", "spmm", {"b": P.arr(_ints(rng, a.k, 16))}),
                   ("g", "sddmm", {"x": P.arr(_ints(rng, a.m, 32)),
                                   "y": P.arr(_ints(rng, a.k, 32))})])
        series = set()
        for line in eng.metrics.exposition().splitlines():
            if line and not line.startswith("#"):
                series.add(line.rsplit(" ", 1)[0])
        # Byte series carry the served view in a label (compact on
        # xla/torch, segment on the kernel path).
        docs.append({"health": eng.health(), "series": sorted(
            s for s in series if "seconds" not in s
            and (pair == "xla/torch" or "bytes" not in s))})
    _same(*docs, skip=_skip(pair))


def _gnn_scores(P, kind, params, feats, node_ids, norm=None):
    reg = P.reg(max_graphs=4)
    eng = P.serve.SparseEngine(reg)
    svc = P.serve.GNNService(eng)
    a = P.gen.mixed_csr(96, 96, seed=21)
    if kind == "gcn":
        svc.register_gcn("m", a, _model(P, kind, params),
                         norm_edge_vals=norm)
    else:
        svc.register_agnn("m", a, _model(P, kind, params))
    rids = [svc.submit("m", P.arr(f), node_ids=ids)
            for f, ids in zip(feats, node_ids)]
    res = svc.flush()
    return [P.np(res[r]) for r in rids]


def _gnn_case(kind, integers, rng):
    if integers:
        dims = [8, 8, 4]
        draw = lambda *s: _ints(rng, *s)                       # noqa: E731
    else:
        dims = [32, 32, 8]
        draw = lambda *s: rng.standard_normal(s).astype(       # noqa: E731
            np.float32) / np.sqrt(s[0])
    params = [{"w": draw(dims[i], dims[i + 1])}
              for i in range(len(dims) - 1)]
    if kind == "agnn":
        for i, p in enumerate(params):
            p["beta"] = np.float32(1.0 + 0.5 * i)
    feats = [draw(96, dims[0]) * np.sqrt(dims[0]) if not integers
             else draw(96, dims[0]) for _ in range(2)]
    return params, feats, [None, np.array([0, 5, 9])]


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("kind,integers", [
    ("gcn", True), ("gcn", False), ("agnn", False)])
def test_gnn_service_scores_match_reference_service(kind, integers, pair):
    """GCN with integer edge values, weights and features is held bit
    for bit; the normalized GCN and AGNN (softmax weights) within
    1e-4·max|ref|."""
    rng = np.random.default_rng(21)
    params, feats, ids = _gnn_case(kind, integers, rng)
    ref_p, port_p = _pair(pair)
    a_nnz = jgen.mixed_csr(96, 96, seed=21).nnz
    norm = (np.asarray(_nonzero_ints(np.random.default_rng(1), a_nnz))
            if integers else None)
    want = _gnn_scores(ref_p, kind, params, feats, ids, norm)
    got = _gnn_scores(port_p, kind, params, feats, ids, norm)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        if integers:
            np.testing.assert_array_equal(g, w)
        else:
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


def test_gnn_service_matches_the_port_forward():
    """The served forward equals the port's own GCN/AGNN modules through
    ``GraphOps`` on the same tuned plans (the reference's contract)."""
    rng = np.random.default_rng(2)
    a = tgen.mixed_csr(96, 96, seed=21)
    reg = tserve.GraphRegistry(max_graphs=4, device="cpu")
    svc = tserve.GNNService(tserve.SparseEngine(reg))
    g = tgnn.GraphOps(a, spec=ExecSpec(tune="model", device="cpu"))
    gcn = tgnn.GCN([32, 32, 8], generator=torch.Generator().manual_seed(0))
    agnn = tgnn.AGNN([32, 8], generator=torch.Generator().manual_seed(1))
    svc.register_gcn("gcn", a, gcn)
    svc.register_agnn("agnn", a, agnn)
    feats = torch.from_numpy(rng.standard_normal((a.m, 32)).astype(
        np.float32))
    norm = torch.from_numpy(tgnn.gcn_norm_edges(a))
    with torch.no_grad():
        want_g = gcn(g, feats, norm)
        want_a = agnn(g, feats)
    got_g = svc.score("gcn", feats)
    got_a = svc.score("agnn", feats, node_ids=[1, 2, 3])
    torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got_a, want_a[[1, 2, 3]], rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(KeyError):
        svc.submit("missing", feats)


def test_batched_operators_match_looped_single_applies():
    """``BatchedSpMM``/``BatchedSDDMM`` on a reordered plan: each panel
    equals the single operator, rows in original order."""
    from repro_torch.dist.sparse import BatchedSDDMM, BatchedSpMM

    rng = np.random.default_rng(4)
    a = tgen.power_law_csr(120, 120, 6.0, seed=3)
    spec = ExecSpec(tune="off", reorder="on", device="cpu")
    bs = BatchedSpMM(a, spec=spec)
    bd = BatchedSDDMM(a, spec=spec)
    assert bs.op.reorder is not None
    b = torch.from_numpy(rng.standard_normal((3, a.k, 16)).astype(
        np.float32))
    ev = torch.from_numpy(rng.standard_normal((3, a.nnz)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((3, a.m, 8)).astype(np.float32))
    out = bs(b)
    out_ev = bs(b, edge_vals=ev)
    out_sd = bd(x, x)
    dense = a.to_dense()
    rows, cols, _ = a.to_coo()
    for i in range(3):
        assert torch.equal(out[i], bs.op(b[i]))
        dv = np.zeros_like(dense)
        dv[rows, cols] = ev[i].numpy()
        np.testing.assert_allclose(out_ev[i].numpy(), dv @ b[i].numpy(),
                                   rtol=1e-4, atol=1e-4)
        assert torch.equal(out_sd[i], bd.op(x[i], x[i]))
    assert len(bs._cache) == 2 and len(bd._cache) == 1


def test_stack_applies_equal_looped_single_applies():
    rng = np.random.default_rng(6)
    a = tgen.mixed_csr(64, 48, seed=9)
    op = LibraSpMM(a, spec=ExecSpec(tune="off", device="cpu"))
    sd = LibraSDDMM(a, spec=ExecSpec(tune="off", device="cpu"))
    for backend in ("cuda", "torch"):
        b = torch.from_numpy(rng.standard_normal((2, a.k, 8)).astype(
            np.float32))
        arrs = op.arrays.for_backend(backend)
        got = tops.spmm_apply_stack(arrs, b, m=op.m, nwin=op.nwin,
                                    backend=backend)
        for i in range(2):
            assert torch.equal(got[i], tops.spmm_apply(
                arrs, b[i], m=op.m, nwin=op.nwin, backend=backend))
        x = torch.from_numpy(rng.standard_normal((2, a.m, 8)).astype(
            np.float32))
        y = torch.from_numpy(rng.standard_normal((2, a.k, 8)).astype(
            np.float32))
        arrs = sd.arrays.for_backend(backend)
        got = tops.sddmm_apply_stack(arrs, x, y, nnz=sd.nnz,
                                     backend=backend)
        for i in range(2):
            assert torch.equal(got[i], tops.sddmm_apply(
                arrs, x[i], y[i], nnz=sd.nnz, backend=backend))


def test_stack_apply_matches_the_reference_vmap():
    """``spmm_apply_stack`` with per-panel ``edge_vals`` against the
    reference's vmapped stack, bit for bit on integer data."""
    rng = np.random.default_rng(8)
    a_t = tgen.mixed_csr(64, 48, seed=10)
    a_j = jgen.mixed_csr(64, 48, seed=10)
    b = _ints(rng, 3, a_t.k, 8)
    ev = _ints(rng, 3, a_t.nnz)
    jop = JSpMM(a_j, tune="off")
    want = jops.spmm_apply_stack(
        jop.arrays.for_backend("xla", revalue=True), jnp.asarray(b),
        m=jop.m, nwin=jop.nwin, backend="xla", cfg=jop.tune_config,
        edge_vals=jnp.asarray(ev))
    op = LibraSpMM(a_t, spec=ExecSpec(tune="off", device="cpu"))
    for backend in ("torch", "cuda"):
        got = tops.spmm_apply_stack(
            op.arrays.for_backend(backend, revalue=True),
            torch.from_numpy(b), m=op.m, nwin=op.nwin, backend=backend,
            edge_vals=torch.from_numpy(ev))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reordered_entry_degraded_rungs_keep_row_order():
    """Every rung of a reordered entry answers in original row order
    (the reference's unsegmented/xla rungs do not unpermute)."""
    rng = np.random.default_rng(11)
    a = tgen.power_law_csr(120, 120, 6.0, seed=3)
    a = tserve.as_csr(a, _nonzero_ints(rng, a.nnz))
    reg = tserve.GraphRegistry(width_buckets=(16,), device="cpu")
    reg.register(a, name="g", spec=ExecSpec(tune="off", reorder="on",
                                            device="cpu"))
    entry = reg.resolve("g")
    assert entry.op("spmm").op.reorder is not None
    eng = tserve.SparseEngine(reg)
    b = torch.from_numpy(_ints(rng, a.k, 16))
    x = torch.from_numpy(_ints(rng, a.m, 16))
    req_b = types.SimpleNamespace(width=16, payload=(b,), edge_vals=None)
    req_x = types.SimpleNamespace(width=16, payload=(x, x), edge_vals=None)
    want_b = entry.op("spmm").op(b)
    want_x = entry.op("sddmm").op(x, x)
    rungs_b = eng._rungs(entry, "spmm", 16, req_b)
    rungs_x = eng._rungs(entry, "sddmm", 16, req_x)
    assert [r for r, _ in rungs_b] == ["single", "unsegmented", "torch"]
    assert [r for r, _ in rungs_x] == ["single", "unsegmented", "torch"]
    for _, thunk in rungs_b:
        assert torch.equal(thunk(), want_b)
    for _, thunk in rungs_x:
        assert torch.equal(thunk(), want_x)


def test_unsegmented_view_carries_compact_lengths():
    """The kernel path's compact view (the ``unsegmented`` rung) passes
    the compact tables' real lengths, not the segment tables'."""
    from repro_torch.core import formats

    a = tgen.mixed_csr(64, 48, seed=12)
    pa = LibraSpMM(a, spec=ExecSpec(tune="off", device="cpu")).arrays
    assert pa.segmented
    seg = pa.for_backend("cuda")
    flat = pa.for_backend("cuda", segmented=False)
    assert set(flat) - {"tc_len", "vpu_len"} == set(pa.backend_keys("torch"))
    np.testing.assert_array_equal(
        flat["tc_len"].numpy(),
        formats.real_vector_lengths(pa.host["tc_pos"]))
    np.testing.assert_array_equal(
        flat["vpu_len"].numpy(),
        formats.real_prefix_lengths(pa.host["vpu_pos"]))
    assert seg["tc_len"].shape[0] == pa.host["tc_seg_vals"].shape[0]
    b = torch.from_numpy(_ints(np.random.default_rng(0), a.k, 8))
    assert torch.equal(
        tops.spmm_apply(flat, b, m=64, nwin=8),
        tops.spmm_apply(seg, b, m=64, nwin=8))


def test_registry_entry_points_default_to_the_card():
    reg = tserve.GraphRegistry(device="cpu")
    assert reg.backend == "cuda" and reg.width_buckets == (32, 64, 128)
    assert reg.panel_buckets == (1, 2, 4, 8)
    assert tserve.registry.PACK_BUDGET_BYTES == \
        jserve.registry.PACK_BUDGET_BYTES == 2 * 2**20
    a_t = tgen.mixed_csr(40, 40, seed=2)
    a_j = jgen.mixed_csr(40, 40, seed=2)
    for mode, layout in (("hybrid", "batched"), ("tcu", "batched+x")):
        assert tserve.registry.graph_key(a_t, mode, layout) == \
            jserve.registry.graph_key(a_j, mode, layout)


def test_jax_arrays_do_not_leak_into_the_port():
    """Results of the port's engine are torch tensors on the registry's
    device (a guard against mixing the packages' arrays in a scenario)."""
    a = tgen.mixed_csr(40, 40, seed=2)
    reg = tserve.GraphRegistry(width_buckets=(8,), device="cpu")
    reg.register(a, name="g")
    out = tserve.SparseEngine(reg).serve(
        [("g", "spmm", {"b": torch.ones(40, 8)})])
    (t,) = out.values()
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    assert not isinstance(t, jax.Array)
