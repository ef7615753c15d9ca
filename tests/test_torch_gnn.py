"""GCN and AGNN inference and training: the port against
``repro.models.gnn``.

The reference's parameters (``init_gcn``/``init_agnn``) are carried into
the port's modules by ``repro_torch.models.convert``; both packages get
the same graph, plan config and seeded numpy features. Tolerances:

* forward logits: rtol 1e-5 with atol 1e-5·max|ref|, because fp32 sums
  over the same products are taken in different orders in the two
  packages (segment sums, softmax normalisers, the dense ``h @ W``) and
  those differences carry through two layers at unit scale;
* the VJPs of ``GraphOps.spmm`` and ``GraphOps.sddmm`` alone: bit for bit
  on integer data in [-4, 4], whose fp32 sums are exact in any order;
* a training step's loss and gradients on random data: max|Δ| ≤
  1e-4·max|ref| per parameter (the repo's fp32-path tolerance). The
  backward sums tens of thousands of products per weight entry in
  another order than the reference, and ``edge_softmax``'s
  ``scatter_reduce("amax")`` splits the gradient among tied maxima where
  JAX's ``segment_max`` does not; that gradient is zero in exact
  arithmetic, so only rounding differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecSpec as JSpec
from repro.models import gnn as jgnn
from repro.sparse.generate import mixed_csr, power_law_csr
from repro.sparse.matrix import coo_to_csr
from repro.tune.model import TuneConfig as JTune
from repro_torch.api import ExecSpec
from repro_torch.models import gnn
from repro_torch.models.convert import agnn_params_from_jax, gcn_params_from_jax
from repro_torch.sparse import SparseCSR
from repro_torch.tune.model import TuneConfig

DIMS = [16, 32, 8]
GRAPHS = {
    "powerlaw": lambda: power_law_csr(120, 120, 6.0, seed=31),
    "mixed": lambda: mixed_csr(96, 96, seed=32),
}


def _shuffled_power_law(m, avg_row, alpha, seed):
    """The reference tests' reorder recipe: a power-law graph with its
    rows shuffled, so reordering has windows to densify."""
    a = power_law_csr(m, m, avg_row=avg_row, alpha=alpha, seed=seed)
    rows, cols, vals = a.to_coo()
    perm = np.random.default_rng(seed + 1).permutation(m)
    return coo_to_csr(m, m, perm[rows], cols, vals)


# Graphs of the training tests: the inference graphs and the shuffled
# power-law one, each with reordering off and on.
TRAIN_GRAPHS = dict(GRAPHS, shuffled=lambda: _shuffled_power_law(
    128, 8.0, 1.5, 7))
# "off": the operators' defaults (GraphOps' default); "tc": a literal
# config that puts work on both Tensor Core streams as well.
CONFIGS = {"off": None, "tc": {"threshold": 2, "ts": 2, "cs": 32}}


def _graphs(name, cfg, reorder="off", backend="cuda", a=None):
    a = TRAIN_GRAPHS[name]() if a is None else a
    port_a = SparseCSR(a.m, a.k, a.indptr, a.indices, a.data)
    tune = CONFIGS[cfg]
    jspec = JSpec(tune="off" if tune is None else JTune(**tune),
                  backend="xla", reorder=reorder)
    tspec = ExecSpec(tune="off" if tune is None else TuneConfig(**tune),
                     device="cpu", reorder=reorder, backend=backend)
    return a, jgnn.GraphOps(a, spec=jspec), gnn.GraphOps(port_a, spec=tspec)


def _features(a, seed=33):
    return np.random.default_rng(seed).standard_normal(
        (a.m, DIMS[0])).astype(np.float32)


def _check(out, want):
    out, want = out.detach().numpy(), np.asarray(want)
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_gcn_forward_matches_reference(name, cfg, backend):
    a, jg, tg = _graphs(name, cfg)
    tg.backend = backend
    params = jgnn.init_gcn(jax.random.PRNGKey(0), DIMS)
    x = _features(a)
    norm = jgnn.gcn_norm_edges(a)
    want = jgnn.gcn_forward(params, jg, jnp.asarray(x), jnp.asarray(norm))
    model = gcn_params_from_jax([{"w": np.asarray(p["w"])} for p in params],
                                device="cpu")
    with torch.no_grad():
        out = model(tg, torch.from_numpy(x), torch.from_numpy(norm))
    _check(out, want)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_agnn_forward_matches_reference(name, cfg, backend):
    a, jg, tg = _graphs(name, cfg)
    tg.backend = backend
    params = jgnn.init_agnn(jax.random.PRNGKey(1), DIMS)
    params = [{"w": p["w"], "beta": jnp.asarray(0.5 + i)}
              for i, p in enumerate(params)]
    x = _features(a)
    want = jgnn.agnn_forward(params, jg, jnp.asarray(x))
    model = agnn_params_from_jax(
        [{k: np.asarray(v) for k, v in p.items()} for p in params],
        device="cpu")
    with torch.no_grad():
        out = model(tg, torch.from_numpy(x))
    _check(out, want)


def test_gcn_forward_matches_reference_pallas():
    """The reference's Pallas path (interpret mode) gives the same
    logits as the port's kernel path on the Tensor Core config."""
    a, _, tg = _graphs("mixed", "tc")
    jg = jgnn.GraphOps(a, spec=JSpec(tune=JTune(**CONFIGS["tc"]),
                                     backend="pallas", interpret=True))
    params = jgnn.init_gcn(jax.random.PRNGKey(2), DIMS)
    x, norm = _features(a, 34), jgnn.gcn_norm_edges(a)
    want = jgnn.gcn_forward(params, jg, jnp.asarray(x), jnp.asarray(norm))
    model = gcn_params_from_jax([{"w": np.asarray(p["w"])} for p in params],
                                device="cpu")
    with torch.no_grad():
        out = model(tg, torch.from_numpy(x), torch.from_numpy(norm))
    _check(out, want)


def test_graph_helpers_match_reference():
    a, jg, tg = _graphs("powerlaw", "off")
    port_a = tg.a
    at, perm = gnn.transpose_csr(port_a)
    jat, jperm = jgnn.transpose_csr(a)
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(at, name), getattr(jat, name))
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(gnn.gcn_norm_edges(port_a),
                                  jgnn.gcn_norm_edges(a))
    scores = np.random.default_rng(35).standard_normal(a.nnz).astype(
        np.float32)
    _check(gnn.edge_softmax(tg, torch.from_numpy(scores)),
           jgnn.edge_softmax(jg, jnp.asarray(scores)))
    b = np.random.default_rng(36).standard_normal((a.k, 8)).astype(np.float32)
    _check(tg.fixed_spmm(torch.from_numpy(b)), jg.fixed_spmm(jnp.asarray(b)))


def test_convert_carries_parameters():
    params = jgnn.init_agnn(jax.random.PRNGKey(3), DIMS)
    model = agnn_params_from_jax(
        [{k: np.asarray(v) for k, v in p.items()} for p in params],
        device="cpu")
    assert model.dims == DIMS
    for w, beta, p in zip(model.weights, model.betas, params):
        np.testing.assert_array_equal(w.detach().numpy(), np.asarray(p["w"]))
        assert beta.item() == float(p["beta"])


def _int_graph(name, seed=40):
    """The graph's pattern with non-zero integer edge values."""
    a = TRAIN_GRAPHS[name]()
    vals = np.random.default_rng(seed).integers(1, 5, a.nnz)
    return coo_to_csr(a.m, a.k, *a.to_coo()[:2], vals.astype(np.float32))


def _ints(seed, *shape):
    return np.random.default_rng(seed).integers(-4, 5, shape).astype(
        np.float32)


def _vjps(tg, ev, b, dc, x, y, dv):
    """Outputs and input cotangents of the port's ``spmm`` and ``sddmm``."""
    tev, tb, tx, ty = (torch.from_numpy(t).requires_grad_()
                       for t in (ev, b, x, y))
    out_c = tg.spmm(tev, tb)
    out_c.backward(torch.from_numpy(dc))
    out_s = tg.sddmm(tx, ty)
    out_s.backward(torch.from_numpy(dv))
    return [t.detach().numpy() for t in (out_c, tev.grad, tb.grad, out_s,
                                         tx.grad, ty.grad)]


def _vjp_inputs(a):
    return (_ints(41, a.nnz), _ints(42, a.k, 8), _ints(43, a.m, 8),
            _ints(44, a.m, 8), _ints(45, a.k, 8), _ints(46, a.nnz))


def _reference_vjps(jg, ev, b, dc, x, y, dv):
    out_c, vjp_c = jax.vjp(jg.spmm, jnp.asarray(ev), jnp.asarray(b))
    out_s, vjp_s = jax.vjp(jg.sddmm, jnp.asarray(x), jnp.asarray(y))
    return [np.asarray(t) for t in (out_c, *vjp_c(jnp.asarray(dc)), out_s,
                                    *vjp_s(jnp.asarray(dv)))]


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("reorder", ["off", "on"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("name", list(TRAIN_GRAPHS))
def test_graphops_vjps_match_reference_exactly(name, cfg, reorder, backend):
    """dB = A(v)ᵀ·dC and dv = SDDMM(dC, B) for ``spmm``; dX = A(dv)·Y and
    dY = A(dv)ᵀ·X for ``sddmm``: bit for bit against ``jax.vjp``."""
    a = _int_graph(name)
    _, jg, tg = _graphs(name, cfg, reorder, backend, a=a)
    inputs = _vjp_inputs(a)
    for got, want in zip(_vjps(tg, *inputs), _reference_vjps(jg, *inputs)):
        np.testing.assert_array_equal(got, want)


def test_graphops_vjps_match_reference_pallas():
    """The reference's Pallas path (interpret mode) gives the same
    cotangents as the port's kernel path, reordered, on the Tensor Core
    config."""
    a = _int_graph("shuffled")
    _, _, tg = _graphs("shuffled", "tc", "on", a=a)
    jg = jgnn.GraphOps(a, spec=JSpec(tune=JTune(**CONFIGS["tc"]),
                                     backend="pallas", interpret=True,
                                     reorder="on"))
    assert tg.arrs.plan.meta["tc_nnz"] and tg.arrs_sd.plan.meta["tc_nnz"]
    inputs = _vjp_inputs(a)
    for got, want in zip(_vjps(tg, *inputs), _reference_vjps(jg, *inputs)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_reorder_leaves_gradients_bit_identical(cfg, backend):
    """Reordering relabels rows and nothing else: on integer data the
    outputs and cotangents are the same bits with it on and off."""
    a = _int_graph("shuffled")
    _, _, off = _graphs("shuffled", cfg, "off", backend, a=a)
    _, _, on = _graphs("shuffled", cfg, "on", backend, a=a)
    assert on.arrs.plan.meta["reorder"]["enabled"]
    assert on.arrs.plan.meta["tc_nnz"] > off.arrs.plan.meta["tc_nnz"]
    inputs = _vjp_inputs(a)
    for got, want in zip(_vjps(on, *inputs), _vjps(off, *inputs)):
        np.testing.assert_array_equal(got, want)


def test_expanded_cotangent_equals_a_dense_one():
    """``out.sum().backward()`` hands the op an expanded, stride-0
    cotangent; the backward makes it contiguous for the applies."""
    a = _int_graph("shuffled")
    _, _, tg = _graphs("shuffled", "tc", "on", a=a)
    ev, b = (torch.from_numpy(t) for t in (_ints(41, a.nnz),
                                           _ints(42, a.k, 8)))
    grads = []
    for expanded in (True, False):
        tev, tb = ev.clone().requires_grad_(), b.clone().requires_grad_()
        out = tg.spmm(tev, tb)
        if expanded:
            out.sum().backward()
        else:
            out.backward(torch.ones_like(out))
        grads.append((tev.grad, tb.grad))
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def _reference_step(model_name, jg, params, x, labels, norm):
    labels = jnp.asarray(labels)

    def ce(logits):
        lp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(lp, labels[:, None], 1).mean()

    if model_name == "gcn":
        fwd = lambda p: jgnn.gcn_forward(  # noqa: E731
            p, jg, jnp.asarray(x), jnp.asarray(norm))
    else:
        fwd = lambda p: jgnn.agnn_forward(p, jg, jnp.asarray(x))  # noqa: E731
    return jax.value_and_grad(lambda p: ce(fwd(p)))(params)


def _model(model_name, params):
    np_params = [{k: np.asarray(v) for k, v in p.items()} for p in params]
    if model_name == "gcn":
        return gcn_params_from_jax(np_params, device="cpu")
    return agnn_params_from_jax(np_params, device="cpu")


def _params(model_name):
    if model_name == "gcn":
        return jgnn.init_gcn(jax.random.PRNGKey(4), DIMS)
    return [{"w": p["w"], "beta": jnp.asarray(0.5 + i)} for i, p in
            enumerate(jgnn.init_agnn(jax.random.PRNGKey(5), DIMS))]


def _close_rel(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("reorder", ["off", "on"])
@pytest.mark.parametrize("model_name", ["gcn", "agnn"])
@pytest.mark.parametrize("name", ["shuffled", "mixed"])
def test_training_step_matches_reference(name, model_name, reorder,
                                         backend):
    """One full-batch SGD step (lr 0.2, the reference bench's): the loss
    and every weight's and β's gradient against ``jax.value_and_grad``
    of the reference's cross-entropy, and the update p − lr·∇p."""
    a, jg, tg = _graphs(name, "tc", reorder, backend)
    params = _params(model_name)
    x = _features(a, 47)
    labels = np.random.default_rng(48).integers(0, DIMS[-1], a.m)
    norm = jgnn.gcn_norm_edges(a)
    want_loss, want_grads = _reference_step(model_name, jg, params, x,
                                            labels, norm)
    model = _model(model_name, params)
    before = [p.detach().clone() for p in model.parameters()]
    args = (torch.from_numpy(norm),) if model_name == "gcn" else ()
    loss = gnn.train_step(model, tg, torch.from_numpy(x),
                          torch.from_numpy(labels), *args, lr=0.2)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for i, layer in enumerate(want_grads):
        _close_rel(model.weights[i].grad.numpy(), layer["w"])
        if model_name == "agnn":
            _close_rel(model.betas[i].grad.numpy(), layer["beta"])
    for p, p0 in zip(model.parameters(), before):
        assert torch.equal(p.detach(), p0 - 0.2 * p.grad)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(49)
    logits = rng.standard_normal((50, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, 50)
    lp = jax.nn.log_softmax(jnp.asarray(logits))
    want = -jnp.take_along_axis(lp, jnp.asarray(labels)[:, None], 1).mean()
    got = gnn.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("model_name", ["gcn", "agnn"])
def test_backward_computes_only_the_gradients_asked_for(model_name,
                                                        monkeypatch):
    """GCN's fixed ``norm`` edge values cost no SDDMM, and the first
    layer's input features no Aᵀ apply; one step applies each leg as
    many times as the reference's VJPs need."""
    _, _, tg = _graphs("shuffled", "tc", "on")
    calls = {"A": 0, "At": 0, "SDDMM": 0}
    for leg, name in (("A", "_a_apply"), ("At", "_at_apply"),
                      ("SDDMM", "_sddmm_apply")):
        def counted(*args, _leg=leg, _fn=getattr(tg, name)):
            calls[_leg] += 1
            return _fn(*args)
        monkeypatch.setattr(tg, name, counted)
    model = _model(model_name, _params(model_name))
    x = torch.from_numpy(_features(tg.a, 50))
    labels = torch.from_numpy(np.random.default_rng(51).integers(
        0, DIMS[-1], tg.m))
    args = ((torch.from_numpy(gnn.gcn_norm_edges(tg.a)),)
            if model_name == "gcn" else ())
    gnn.train_step(model, tg, x, labels, *args, lr=0.2)
    layers = len(DIMS) - 1
    if model_name == "gcn":
        # Forward A per layer; backward Aᵀ per layer (dB), no dv.
        want = {"A": layers, "At": layers, "SDDMM": 0}
    else:
        # Forward SDDMM and A per layer; backward an SDDMM per layer
        # (dv of the attention), and past the first layer, whose input
        # needs no gradient, Aᵀ for dB plus A and Aᵀ for dX and dY.
        want = {"A": 2 * layers - 1, "At": 2 * (layers - 1),
                "SDDMM": 2 * layers}
    assert calls == want
