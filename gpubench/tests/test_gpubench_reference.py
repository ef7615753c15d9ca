"""The plain reference against the program's plain path
(``backend="torch"``) on a small graph on the CPU, and the frozen graph
generator against the program's."""
import numpy as np
import pytest
import torch

from gpubench import cells, graphs
from gpubench.reference import gcn as ref_gcn
from gpubench.reference import gnn as ref

DIMS = [12, 16, 16, 5]


@pytest.fixture(scope="module")
def graph():
    return graphs.power_law(300, 300, 6.0, seed=4)


def _port(graph):
    from repro_torch.api import ExecSpec
    from repro_torch.models.gnn import GraphOps
    from repro_torch.sparse.matrix import SparseCSR

    csr = SparseCSR(graph.m, graph.k, graph.indptr, graph.indices, graph.data)
    spec = ExecSpec(tune="off", device="cpu", backend="torch")
    return csr, GraphOps(csr, spec=spec)


def _inputs(kind, seed=7):
    cfg = {"model": kind, "dims": DIMS}
    layers = cells.draw_params(cfg, seed, torch.device("cpu"))
    gen = torch.Generator().manual_seed(seed)
    return cfg, layers, gen


def test_frozen_generator_matches_the_programs():
    from repro_torch.sparse.generate import power_law_csr

    want = power_law_csr(2000, 1500, 9.0, seed=3)
    got = graphs.power_law(2000, 1500, 9.0, seed=3)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)


def test_gcn_norm_matches_the_programs(graph):
    from repro_torch.models.gnn import gcn_norm_edges

    csr, _ = _port(graph)
    e = ref.Edges(graph.indptr, graph.indices, graph.m, "cpu")
    np.testing.assert_allclose(ref_gcn.gcn_norm(e).numpy(),
                               gcn_norm_edges(csr),
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["gcn", "agnn"])
def test_train_step_matches_the_programs_plain_path(graph, kind):
    from repro_torch.models.gnn import gcn_norm_edges, train_step

    csr, gops = _port(graph)
    cfg, layers, gen = _inputs(kind)
    x = torch.randn(graph.m, DIMS[0], generator=gen)
    labels = torch.randint(0, DIMS[-1], (graph.m,), generator=gen)
    model = cells.module(cfg, layers, torch.device("cpu"))
    args = (torch.from_numpy(gcn_norm_edges(csr)),) if kind == "gcn" else ()
    losses = [float(train_step(model, gops, x, labels, *args, lr=0.2))
              for _ in range(2)]
    e = ref.Edges(graph.indptr, graph.indices, graph.m, "cpu")
    want_losses, states = ref.train(cells.reference(cfg), layers, e, x,
                                    labels, lr=0.2, steps=2)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got = cells.model_kind(cfg).leaves(model)
    assert len(got) == len(states[-1])
    for g, w in zip(got, states[-1]):
        torch.testing.assert_close(g.detach(), w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["gcn", "agnn"])
def test_served_flush_matches_the_reference(graph, kind):
    from repro_torch.serve import GNNService, GraphRegistry, SparseEngine

    csr, _ = _port(graph)
    cfg, layers, gen = _inputs(kind, seed=9)
    model = cells.module(cfg, layers, torch.device("cpu"))
    reg = GraphRegistry(width_buckets=(16, 32), device="cpu", tune="off")
    svc = GNNService(SparseEngine(reg))
    cells.model_kind(cfg).register(svc, "m", csr, model)
    feats = [torch.randn(graph.m, DIMS[0], generator=gen) for _ in range(3)]
    ids = torch.randint(0, graph.m, (20,), generator=gen)
    rids = [svc.submit("m", f, ids if i == 2 else None)
            for i, f in enumerate(feats)]
    out = svc.flush()
    e = ref.Edges(graph.indptr, graph.indices, graph.m, "cpu")
    for i, rid in enumerate(rids):
        want = cells.reference(cfg).forward(layers, e, feats[i])
        if i == 2:
            want = want[ids]
        torch.testing.assert_close(out[rid], want, rtol=1e-4, atol=1e-5)
