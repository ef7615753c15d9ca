"""Window-sharded execution and training on the CPU.

The reference's sharded apply raises on this tree's jax (ROADMAP §3),
so the port's sharded outputs are held to its own single-device
operators, which ``tests/test_torch_ops.py`` and
``tests/test_torch_gnn.py`` hold to the reference:

* on integer data in [-4, 4] (every fp32 sum exact in any order),
  ``spmm_sharded``/``sddmm_sharded`` and ``ShardedSpMM``/``ShardedSDDMM``
  equal ``LibraSpMM``/``LibraSDDMM`` (and ``GraphOps``' revalued apply)
  bit for bit: both dense layouts, with and without ``edge_vals``,
  reordered partitions, all three modes, P ∈ {1, 8}, through
  ``backend="cuda"`` (the kernel wrappers' twins on CPU tensors) and
  ``backend="torch"``;
* on random fp32 they match the dense oracle within rtol/atol 1e-4, the
  reference test's tolerance, on a matrix with more shards than
  windows;
* ``DistGraphOps`` gradients match ``GraphOps``' within 1e-4, five GCN
  SGD steps (lr 0.3) give ``GraphOps``' loss trajectory within 1e-4, and
  three AGNN steps lower the loss: the scenario of the reference's
  ``test_dist_graphops_grads_and_training_8dev`` without the mesh
  subprocess.
"""
import numpy as np
import pytest
import torch

from repro.sparse import generate as jgen
from repro_torch.api import ExecSpec
from repro_torch.core.sddmm import LibraSDDMM
from repro_torch.core.spmm import LibraSpMM
from repro_torch.dist import (
    DistGraphOps,
    ShardedSDDMM,
    ShardedSpMM,
    ShardMesh,
    make_agnn_train_step,
    make_gcn_train_step,
    partition_sddmm,
    partition_spmm,
    sddmm_sharded,
    spmm_sharded,
)
from repro_torch.kernels import ref
from repro_torch.models import gnn
from repro_torch.sparse import SparseCSR


def _int_csr(m, k, seed):
    """``mixed_csr``'s pattern with non-zero integer values in [-4, 4]."""
    a = jgen.mixed_csr(m, k, seed=seed)
    vals = np.random.default_rng(seed).integers(1, 5, a.nnz) * \
        np.random.default_rng(seed + 1).choice([-1, 1], a.nnz)
    return SparseCSR(a.m, a.k, a.indptr, a.indices, vals.astype(np.float32))


def _ints(rng, *shape):
    return torch.from_numpy(rng.integers(-4, 5, shape).astype(np.float32))


def _dense(a, vals=None):
    rows = np.repeat(np.arange(a.m), np.diff(a.indptr))
    d = np.zeros((a.m, a.k), np.float64)
    d[rows, a.indices] = a.data if vals is None else vals
    return d


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("reorder", ["off", "on"])
@pytest.mark.parametrize("mode", ["hybrid", "tcu", "vpu"])
@pytest.mark.parametrize("n_shards", [1, 8])
def test_sharded_equals_single_device_on_integers(n_shards, mode, reorder,
                                                  backend):
    rng = np.random.default_rng(n_shards)
    a = _int_csr(200, 160, seed=5)
    spec = ExecSpec(mode=mode, reorder=reorder, backend=backend,
                    device="cpu")
    mesh = ShardMesh(["cpu"] * n_shards)
    b, ev = _ints(rng, a.k, 48), _ints(rng, a.nnz)
    x, y = _ints(rng, a.m, 32), _ints(rng, a.k, 32)
    spmm, sddmm = LibraSpMM(a, spec=spec), LibraSDDMM(a, spec=spec)
    want_ev = gnn.GraphOps(a, spec=spec)._a_apply(ev, b)
    part = partition_spmm(a, n_shards, spec=spec)
    sd = partition_sddmm(a, n_shards, spec=spec)
    assert (part.reorder is not None) == (reorder == "on")
    for layout in ("replicated", "rowshard"):
        got = spmm_sharded(part, b, mesh=mesh, backend=backend,
                           b_layout=layout)
        assert torch.equal(got, spmm(b)), layout
        got = spmm_sharded(part, b, mesh=mesh, backend=backend,
                           edge_vals=ev, b_layout=layout)
        assert torch.equal(got, want_ev), layout
        got = sddmm_sharded(sd, x, y, mesh=mesh, backend=backend,
                            y_layout=layout)
        assert torch.equal(got, sddmm(x, y)), layout
        lspec = spec.replace(b_layout=layout)
        op = ShardedSpMM(a, mesh, spec=lspec)
        assert torch.equal(op(b), spmm(b))
        assert torch.equal(op(b, edge_vals=ev), want_ev)
        sop = ShardedSDDMM(a, mesh, spec=lspec)
        assert torch.equal(sop(x, y), sddmm(x, y))
        assert op.b_layout == sop.y_layout == layout
    # One apply key per (operand shape, dtype, revalued).
    assert len(op._cache) == 2 and len(sop._cache) == 1
    op(b)
    assert len(op._cache) == 2


@pytest.mark.parametrize("layout", ["replicated", "rowshard"])
@pytest.mark.parametrize("mode", ["hybrid", "tcu", "vpu"])
@pytest.mark.parametrize("m,k", [(200, 160), (40, 64)])
def test_sharded_matches_dense_oracle_on_random_data(m, k, mode, layout):
    """The reference's ``test_sharded_ops_match_oracle_8dev`` on one
    process (40 rows: 5 windows for 8 shards)."""
    rng = np.random.default_rng(0)
    a = SparseCSR(*(lambda j: (j.m, j.k, j.indptr, j.indices, j.data))(
        jgen.mixed_csr(m, k, seed=5)))
    spec = ExecSpec(mode=mode, b_layout=layout, device="cpu")
    mesh = ShardMesh(["cpu"] * 8)
    dense = _dense(a)
    b = rng.standard_normal((a.k, 48)).astype(np.float32)
    op = ShardedSpMM(a, mesh, spec=spec)
    np.testing.assert_allclose(op(torch.from_numpy(b)).numpy(), dense @ b,
                               rtol=1e-4, atol=1e-4)
    x = rng.standard_normal((a.m, 32)).astype(np.float32)
    y = rng.standard_normal((a.k, 32)).astype(np.float32)
    rows = np.repeat(np.arange(a.m), np.diff(a.indptr))
    oracle = (x.astype(np.float64) @ y.T.astype(np.float64))[rows,
                                                             a.indices]
    sop = ShardedSDDMM(a, mesh, spec=spec)
    np.testing.assert_allclose(
        sop(torch.from_numpy(x), torch.from_numpy(y)).numpy(), oracle,
        rtol=1e-4, atol=1e-4)
    vals = rng.standard_normal(a.nnz).astype(np.float32)
    got = op(torch.from_numpy(b), edge_vals=torch.from_numpy(vals))
    np.testing.assert_allclose(got.numpy(), _dense(a, vals) @ b,
                               rtol=1e-4, atol=1e-4)


def test_sharded_ops_refuse_a_mismatched_mesh():
    a = _int_csr(40, 64, seed=2)
    part = partition_spmm(a, 4, spec=ExecSpec(device="cpu"))
    with pytest.raises(ValueError, match="4 shards"):
        spmm_sharded(part, torch.zeros(a.k, 8), mesh=ShardMesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="layout"):
        spmm_sharded(part, torch.zeros(a.k, 8), mesh=ShardMesh(["cpu"] * 4),
                     b_layout="columns")
    with pytest.raises(ValueError, match="b_layout"):
        ExecSpec(b_layout="columns")


def _graphs(a):
    spec = ExecSpec(device="cpu")
    return (gnn.GraphOps(a, spec=ExecSpec(tune="off", device="cpu")),
            DistGraphOps(a, ShardMesh(["cpu"] * 8), spec=spec))


def test_dist_graphops_gradients_match_graphops():
    a = SparseCSR(*(lambda j: (j.m, j.k, j.indptr, j.indices, j.data))(
        jgen.mixed_csr(96, 96, seed=21)))
    g1, gd = _graphs(a)
    assert gd.spec.tune == "model" and gd.part.n_shards == 8
    rng = np.random.default_rng(0)
    vals0 = torch.from_numpy(a.data.copy())
    b0 = torch.from_numpy(rng.standard_normal((a.k, 16)).astype(np.float32))
    x0 = torch.from_numpy(rng.standard_normal((a.m, 8)).astype(np.float32))
    y0 = torch.from_numpy(rng.standard_normal((a.k, 8)).astype(np.float32))

    def grads(g, f, u0, w0):
        u = u0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        (f(g)(u, w) ** 2).sum().backward()
        return u.grad, w.grad

    for f, u0, w0 in ((lambda g: g.spmm, vals0, b0),
                      (lambda g: g.sddmm, x0, y0)):
        for want, got in zip(grads(g1, f, u0, w0), grads(gd, f, u0, w0)):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_dist_graphops_backward_computes_only_what_is_asked(monkeypatch):
    a = _int_csr(96, 96, seed=3)
    _, gd = _graphs(a)
    calls = {"spmm": 0, "sddmm": 0}
    real_spmm, real_sddmm = gd._spmm, gd._sddmm
    monkeypatch.setattr(gd, "_spmm", lambda *a_, **k: (
        calls.__setitem__("spmm", calls["spmm"] + 1), real_spmm(*a_, **k))[1])
    monkeypatch.setattr(gd, "_sddmm", lambda *a_, **k: (
        calls.__setitem__("sddmm", calls["sddmm"] + 1),
        real_sddmm(*a_, **k))[1])
    b = torch.ones(a.k, 4, requires_grad=True)
    gd.spmm(torch.from_numpy(a.data.copy()), b).sum().backward()
    assert calls == {"spmm": 2, "sddmm": 0}   # forward + dB only


def test_dist_training_matches_graphops_and_learns():
    a = SparseCSR(*(lambda j: (j.m, j.k, j.indptr, j.indices, j.data))(
        jgen.mixed_csr(96, 96, seed=21)))
    g1, gd = _graphs(a)
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((a.m, 16)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, 4, a.m))
    norm = torch.from_numpy(gnn.gcn_norm_edges(a))
    losses = {}
    for name, g in (("single", g1), ("dist", gd)):
        model = gnn.GCN([16, 16, 4],
                        generator=torch.Generator().manual_seed(0))
        step = make_gcn_train_step(g, lr=0.3)
        losses[name] = [float(step(model, feats, labels, norm))
                        for _ in range(5)]
    np.testing.assert_allclose(losses["dist"], losses["single"],
                               rtol=0, atol=1e-4)
    model = gnn.AGNN([16, 4], generator=torch.Generator().manual_seed(1))
    step = make_agnn_train_step(gd, lr=0.2)
    agnn = [float(step(model, feats, labels)) for _ in range(3)]
    assert np.isfinite(agnn).all() and agnn[-1] < agnn[0]


def test_edge_softmax_and_fixed_spmm_take_dist_graphops():
    a = _int_csr(96, 96, seed=4)
    g1, gd = _graphs(a)
    scores = torch.from_numpy(np.random.default_rng(1).standard_normal(
        a.nnz).astype(np.float32))
    torch.testing.assert_close(gnn.edge_softmax(gd, scores),
                               gnn.edge_softmax(g1, scores))
    b = _ints(np.random.default_rng(2), a.k, 8)
    assert torch.equal(gd.fixed_spmm(b), g1.fixed_spmm(b))
    assert torch.equal(gd.fixed_spmm(b, backend="torch"),
                       torch.from_numpy(ref.spmm_dense_oracle(
                           _dense(a), b.numpy()).astype(np.float32)))
