"""Serving a window-sharded graph (``GraphRegistry.register(mesh=)``).

The scenario of the reference's ``test_engine_sharded_graph_end_to_end``
(whose sharded apply raises on this tree's jax, ROADMAP §3) and of
``GNNService.register_gcn(mesh=)``, on the CPU. The sharded entry's
answers are held bit for bit, on integer data, to the same submissions
against a batched registration of the same graph (which
``tests/test_torch_serve.py`` holds to the reference); its ``stats()``
count the sharded path's packing (column-packed SpMM, per-request SDDMM
and valued SpMM); its ladder is ``single`` and, on a CPU registry,
``torch``; its pack limit is priced on one shard's CUDA-core stream.
"""
import numpy as np
import pytest
import torch

from repro.sparse import generate as jgen
from repro_torch import serve
from repro_torch.api import ExecSpec
from repro_torch.dist import ShardedSDDMM, ShardedSpMM, ShardMesh
from repro_torch.models import gnn
from repro_torch.serve.faults import FaultPlan, FaultRule
from repro_torch.serve.registry import PACK_BUDGET_BYTES
from repro_torch.sparse import SparseCSR


def _int_csr(a, seed=3):
    vals = np.random.default_rng(seed).integers(1, 5, a.nnz) * \
        np.random.default_rng(seed + 1).choice([-1, 1], a.nnz)
    return SparseCSR(a.m, a.k, a.indptr, a.indices, vals.astype(np.float32))


def _ints(rng, *shape, lo=-4, hi=4):
    return torch.from_numpy(rng.integers(lo, hi + 1, shape).astype(
        np.float32))


def _submit_all(eng, name, reqs):
    rids = []
    for op, kw in reqs:
        rids.append(eng.submit(name, op, **kw))
    return rids


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_sharded_entry_serves_like_the_batched_entry(n_shards, backend):
    rng = np.random.default_rng(0)
    a = _int_csr(jgen.mixed_csr(120, 96, seed=8))
    reg = serve.GraphRegistry(max_graphs=4, width_buckets=(32,),
                              panel_buckets=(1, 2, 4), backend=backend,
                              device="cpu")
    reg.register(a, name="gs", mesh=ShardMesh(["cpu"] * n_shards))
    reg.register(a, name="gb")
    entry = reg.resolve("gs")
    assert entry.sharded and not reg.resolve("gb").sharded
    assert isinstance(entry.op("spmm"), ShardedSpMM)
    assert isinstance(entry.op("sddmm"), ShardedSDDMM)
    assert entry.key.endswith(":sharded") and entry.key != \
        reg.resolve("gb").key
    bs = [_ints(rng, a.k, 32) for _ in range(3)]
    x, y, ev = _ints(rng, a.m, 24), _ints(rng, a.k, 24), _ints(rng, a.nnz)
    reqs = [("spmm", {"b": b}) for b in bs] + [
        ("sddmm", {"x": x, "y": y}),
        ("spmm", {"b": bs[0][:, :20], "edge_vals": ev})]
    eng_s = serve.SparseEngine(reg)
    eng_b = serve.SparseEngine(reg)
    rids_s = _submit_all(eng_s, "gs", reqs)
    rids_b = _submit_all(eng_b, "gb", reqs)
    out_s, out_b = eng_s.flush(), eng_b.flush()
    for rs, rb in zip(rids_s, rids_b):
        assert torch.equal(out_s[rs], out_b[rb])
    st = eng_s.stats()
    # Three plain panels pack into one apply of 4 slots; the SDDMM and
    # the valued SpMM run one request each.
    assert (st["served"], st["panels_executed"], st["panel_slots"],
            st["real_panels"]) == (5, 3, 6, 5)
    assert st["bucket_occupancy"] == pytest.approx(5 / 6)
    assert st["exec_cache_misses"] == 3 and st["exec_cache_hits"] == 0
    assert st["computed_cells"] == 4 * a.k * 32 + (a.m + a.k) * 32 \
        + a.k * 32
    assert eng_s.health()["degraded_served"] == {}
    # The second flush of the same shapes hits every apply key.
    _submit_all(eng_s, "gs", reqs)
    eng_s.flush()
    assert eng_s.stats()["exec_cache_hits"] == 3
    # /memory counts exactly the shards' uploaded tables.
    total = sum(arr.resident_nbytes()
                for kind in ("spmm", "sddmm")
                for arr in entry.op(kind).arrays)
    graphs = {g["graph"]: g["bytes"]
              for g in reg.memory_report()["graphs"]}
    assert total > 0 and graphs[entry.key] == total


def test_sharded_entry_ladder_and_degraded_answers():
    rng = np.random.default_rng(1)
    a = _int_csr(jgen.mixed_csr(120, 96, seed=8))
    reg = serve.GraphRegistry(width_buckets=(32,), panel_buckets=(1, 2),
                              device="cpu")
    reg.register(a, name="gs", mesh=ShardMesh(["cpu"] * 3))
    b, x, y = _ints(rng, a.k, 32), _ints(rng, a.m, 32), _ints(rng, a.k, 32)
    direct = reg.resolve("gs").op("spmm")(b)
    direct_sd = reg.resolve("gs").op("sddmm")(x, y)
    eng = serve.SparseEngine(reg)
    entry = reg.resolve("gs")
    rid = eng.submit("gs", "spmm", b=b)
    rid_sd = eng.submit("gs", "sddmm", x=x, y=y)
    reqs = {r.rid: r for r in eng._queue}
    for r, want in ((reqs[rid], direct), (reqs[rid_sd], direct_sd)):
        rungs = eng._rungs(entry, r.op, 32, r)
        assert [n for n, _ in rungs] == ["single", "torch"]
        for _, thunk in rungs:
            assert torch.equal(thunk(), want)
    # On the card the plain path never answers: the ladder is single.
    reg.device = "cuda"
    assert [n for n, _ in eng._rungs(entry, "spmm", 32, reqs[rid])] == \
        ["single"]
    reg.device = "cpu"
    eng._queue.clear()
    # A failing fast path answers on single; a latched single on torch.
    eng.faults = FaultPlan([
        FaultRule(kth=1, graph="gs", strategy="fast", times=-1),
        FaultRule(kth=1, graph="gs", op="sddmm", strategy="single",
                  times=-1)])
    rid = eng.submit("gs", "spmm", b=b)
    rid_sd = eng.submit("gs", "sddmm", x=x, y=y)
    out = eng.flush()
    assert torch.equal(out[rid], direct) and torch.equal(out[rid_sd],
                                                         direct_sd)
    assert eng.health()["degraded_served"] == {"single": 1, "torch": 1}


def test_sharded_entry_packs_on_one_shards_stream():
    a = jgen.power_law_csr(3000, 3000, 8.0, seed=1)
    a = SparseCSR(a.m, a.k, a.indptr, a.indices, a.data)
    reg = serve.GraphRegistry(width_buckets=(16,), device="cpu",
                              tune="off")
    reg.register(a, name="gs", ops=("spmm",),
                 mesh=ShardMesh(["cpu"] * 8))
    reg.register(a, name="gb", ops=("spmm",))
    gs, gb = reg.resolve("gs"), reg.resolve("gb")
    vv = gs.op("spmm").part.stacked["vpu_vals"]
    assert gs.spmm_vpu_elems == vv.shape[1] * vv.shape[2]
    assert gs.spmm_vpu_elems < gb.spmm_vpu_elems
    fit = PACK_BUDGET_BYTES // (gs.spmm_vpu_elems * 16 * 4)
    assert reg.pack_limit(gs, 16) == max([1] + [
        p for p in reg.panel_buckets if p <= fit])
    assert reg.pack_limit(gs, 16) > reg.pack_limit(gb, 16) == 1
    # warm prepares the sharded SpMM at every packable panel bucket.
    assert reg.warm("gs", "spmm") == reg.pack_limit(gs, 16).bit_length()


def test_gnn_service_gcn_on_a_mesh_matches_batched():
    rng = np.random.default_rng(2)
    a = jgen.power_law_csr(400, 400, 6.0, seed=4)
    a = SparseCSR(a.m, a.k, a.indptr, a.indices, a.data)
    norm = rng.integers(1, 3, a.nnz).astype(np.float32)
    model = gnn.GCN([8, 8, 4])
    with torch.no_grad():
        for w in model.weights:
            w.copy_(_ints(rng, *w.shape, lo=-2, hi=2))
    eng = serve.SparseEngine(serve.GraphRegistry(width_buckets=(8,),
                                                 device="cpu"))
    svc = serve.GNNService(eng)
    svc.register_gcn("sharded", a, model, norm_edge_vals=norm,
                     mesh=ShardMesh(["cpu"] * 4))
    svc.register_gcn("batched", a, model, norm_edge_vals=norm)
    assert eng.registry.resolve("sharded::graph").sharded
    feats = [_ints(rng, a.m, 8, lo=-2, hi=2) for _ in range(3)]
    rids = [(svc.submit("sharded", f), svc.submit("batched", f))
            for f in feats]
    rid_ids = (svc.submit("sharded", feats[0], node_ids=[0, 7, 9]),
               svc.submit("batched", feats[0], node_ids=[0, 7, 9]))
    out = svc.flush()
    for rs, rb in rids + [rid_ids]:
        assert torch.equal(out[rs], out[rb])
    g = gnn.GraphOps(a, spec=ExecSpec(device="cpu"))
    want = model(g, feats[0], torch.from_numpy(norm)).detach()
    assert torch.equal(out[rids[0][0]], want)
