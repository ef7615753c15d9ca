"""GCN and AGNN inference: the port against ``repro.models.gnn``.

The reference's parameters (``init_gcn``/``init_agnn``) are carried into
the port's modules by ``repro_torch.models.convert``; both packages get
the same graph, plan config and seeded numpy features. Tolerance:
rtol 1e-5 with atol 1e-5·max|ref|, because fp32 sums over the same
products are taken in different orders in the two packages (segment
sums, softmax normalisers, the dense ``h @ W``) and those differences
carry through two layers at unit scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecSpec as JSpec
from repro.models import gnn as jgnn
from repro.sparse.generate import mixed_csr, power_law_csr
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
# "off": the operators' defaults (GraphOps' default); "tc": a literal
# config that puts work on both Tensor Core streams as well.
CONFIGS = {"off": None, "tc": {"threshold": 2, "ts": 2, "cs": 32}}


def _graphs(name, cfg):
    a = GRAPHS[name]()
    port_a = SparseCSR(a.m, a.k, a.indptr, a.indices, a.data)
    tune = CONFIGS[cfg]
    jspec = JSpec(tune="off" if tune is None else JTune(**tune),
                  backend="xla")
    tspec = ExecSpec(tune="off" if tune is None else TuneConfig(**tune),
                     device="cpu")
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


@pytest.mark.parametrize("model_name", ["gcn", "agnn"])
def test_backward_raises_until_the_training_slice(model_name):
    a, _, tg = _graphs("powerlaw", "off")
    gen = torch.Generator().manual_seed(0)
    x = torch.from_numpy(_features(a))
    if model_name == "gcn":
        model = gnn.GCN(DIMS, generator=gen)
        out = model(tg, x, torch.from_numpy(gnn.gcn_norm_edges(tg.a)))
    else:
        model = gnn.AGNN(DIMS, generator=gen)
        out = model(tg, x)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        out.sum().backward()
