"""Window partitions against the reference (``repro.dist.partition``).

The same seeded matrices go through ``repro.dist.partition`` and
``repro_torch.dist.partition``; everything the partitioners build on the
host must agree, at ``tune="off"`` and ``"model"`` (the port's model
priced with the reference's TPU values by the ``tpu`` fixture), with
row reordering off and on, in every mode, at P ∈ {1, 3, 8}, including
more shards than windows (``mixed_csr(40, 64)``: 5 windows, 8 shards):

* every stacked key, as NumPy, in the reference's dtype;
* the gathers (``out_gather``, ``edge_perm``, ``x_take``,
  ``nnz_gather``), ``wmax``/``rows_pad``/``nnz_pad``;
* each shard's fields (halo, sub-matrix, plan fields of its config)
  and the partition's ``meta``;
* ``run_cfg``: every field at ``tune="off"``; at ``"model"`` the plan
  fields, grid order and source (the port's tuner leaves the TPU tile
  knobs at their defaults).

The reference's sharded *apply* raises on this tree's jax (ROADMAP §3),
so outputs are held in ``tests/test_torch_dist.py`` to the port's
single-device operators. The partition-level ``tune="search"`` is held
under a stub timer: its grid, its pick, the plan-cache hit of a second
construction (the reference's key, to the string), and the apply on a
mesh.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import ExecSpec as JSpec
from repro.dist import partition as jpart
from repro.sparse import generate as jgen
from repro.tune import cache as jcache
from repro_torch.api import ExecSpec
from repro_torch.core.formats import WINDOW
from repro_torch.core.spmm import LibraSpMM
from repro_torch.core.threshold import TPU_V5E
from repro_torch.dist import ShardMesh, partition as tpart, spmm_sharded
from repro_torch.dist import sddmm_sharded
from repro_torch.obs.metrics import default_registry
from repro_torch.sparse import SparseCSR
from repro_torch.tune import PlanCache, tune_key
from repro_torch.tune import model as tmodel

PLAN_FIELDS = ("threshold", "bk", "ts_tile", "ts", "cs", "grid_order",
               "source")
CASES = [((200, 160), 1), ((200, 160), 3), ((200, 160), 8), ((40, 64), 8)]


@pytest.fixture
def tpu(monkeypatch):
    """Price the port's default model with the reference's TPU values."""
    for fn in (tmodel.model_tune_spmm, tmodel.model_tune_sddmm):
        monkeypatch.setitem(fn.__kwdefaults__, "hw", TPU_V5E)


def _port(a):
    return SparseCSR(a.m, a.k, a.indptr, a.indices, a.data)


def _cfg(cfg, tune):
    if tune == "off":
        return dataclasses.asdict(cfg)
    return {f: getattr(cfg, f) for f in PLAN_FIELDS}


def _same_shards(jp, tp, tune):
    assert len(jp.shards) == len(tp.shards)
    for js, ts in zip(jp.shards, tp.shards):
        for f in ("index", "win_start", "win_end", "row_start", "rows",
                  "nnz_start", "nnz"):
            assert getattr(js, f) == getattr(ts, f), f
        np.testing.assert_array_equal(js.halo, ts.halo)
        assert js.halo.dtype == ts.halo.dtype
        assert (js.csr.m, js.csr.k) == (ts.csr.m, ts.csr.k)
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(js.csr, f),
                                          getattr(ts.csr, f))
        cf = ("threshold", "bk", "ts_tile", "ts", "cs")
        assert ({f: getattr(js.cfg, f) for f in cf}
                == {f: getattr(ts.cfg, f) for f in cf})


def _same_partition(jp, tp, tune, gathers):
    assert set(jp.stacked) == set(tp.stacked)
    for k, v in jp.stacked.items():
        ref = np.asarray(v)
        assert tp.stacked[k].dtype == ref.dtype, k
        np.testing.assert_array_equal(tp.stacked[k], ref, err_msg=k)
    for g in gathers:
        ref = getattr(jp, g)
        got = getattr(tp, g)
        if ref is None:
            assert got is None, g
        else:
            np.testing.assert_array_equal(got, np.asarray(ref), err_msg=g)
    for f in ("m", "k", "nnz", "n_shards", "wmax", "rows_pad"):
        assert getattr(jp, f) == getattr(tp, f), f
    assert _cfg(jp.run_cfg, tune) == _cfg(tp.run_cfg, tune)
    assert jp.meta == tp.meta
    assert (jp.reorder is None) == (tp.reorder is None)
    _same_shards(jp, tp, tune)


@pytest.mark.parametrize("tune", ["off", "model"])
@pytest.mark.parametrize("reorder", ["off", "on"])
@pytest.mark.parametrize("mode", ["hybrid", "tcu", "vpu"])
@pytest.mark.parametrize("shape,n_shards", CASES,
                         ids=[f"{m}x{k}-p{p}" for (m, k), p in CASES])
def test_partitions_match_reference(shape, n_shards, mode, reorder, tune,
                                    tpu):
    ja = jgen.mixed_csr(*shape, seed=5)
    a = _port(ja)
    jspec = JSpec(mode=mode, reorder=reorder, tune=tune)
    spec = ExecSpec(mode=mode, reorder=reorder, tune=tune, device="cpu")
    jp = jpart.partition_spmm(ja, n_shards, spec=jspec)
    tp = tpart.partition_spmm(a, n_shards, spec=spec)
    _same_partition(jp, tp, tune, ("out_gather", "edge_perm"))
    jsd = jpart.partition_sddmm(ja, n_shards, spec=jspec)
    tsd = tpart.partition_sddmm(a, n_shards, spec=spec)
    _same_partition(jsd, tsd, tune, ("x_take", "nnz_gather"))
    assert jsd.nnz_pad == tsd.nnz_pad
    if shape == (40, 64):
        assert tp.wmax * WINDOW == tp.rows_pad and sum(
            s.rows == 0 for s in tp.shards) >= 3     # empty shards


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_shard_windows_segment_curve_and_halo_match_reference(n_shards):
    ja = jgen.power_law_csr(400, 300, 6.0, seed=3)
    a = _port(ja)
    np.testing.assert_array_equal(tpart.shard_windows(a, n_shards),
                                  jpart.shard_windows(ja, n_shards))
    for op, thr, bk in (("spmm", 3, 32), ("sddmm", 24, 16)):
        kw = dict(op=op, threshold=thr, bk=bk, seg_ts=4, seg_cs=128,
                  ts_tile=32)
        curve = tpart.segment_curve(a, **kw)
        np.testing.assert_array_equal(curve, jpart.segment_curve(ja, **kw))
        np.testing.assert_array_equal(
            tpart.shard_windows(a, n_shards, curve),
            jpart.shard_windows(ja, n_shards, curve))
    bounds = tpart.shard_windows(a, n_shards)
    for i in range(n_shards):
        r0 = min(int(bounds[i]) * WINDOW, a.m)
        r1 = max(min(int(bounds[i + 1]) * WINDOW, a.m), r0)
        jh, jsub = jpart.column_halo(ja, r0, r1)
        th, tsub = tpart.column_halo(a, r0, r1)
        np.testing.assert_array_equal(th, jh)
        assert (tsub.m, tsub.k) == (jsub.m, jsub.k)
        np.testing.assert_array_equal(tsub.indices, jsub.indices)
        np.testing.assert_array_equal(tsub.indptr, jsub.indptr)


def test_partition_publishes_dist_gauges():
    a = _port(jgen.mixed_csr(120, 96, seed=8))
    part = tpart.partition_spmm(a, 4, spec=ExecSpec(tune="off",
                                                    device="cpu"))
    text = default_registry().exposition()
    series = {}
    for line in text.splitlines():
        if line.startswith("dist_") and '{op="spmm"}' in line:
            name, _, val = line.rpartition(" ")
            series[name.split("{")[0]] = float(val)
    assert series["dist_shards"] == 4
    assert series["dist_halo_rows"] == sum(part.meta["halo_rows"])
    assert series["dist_nnz_max_over_mean"] == \
        part.meta["balance"]["max_over_mean"]
    assert series["dist_segment_max_over_mean"] == \
        part.meta["segment_balance"]["max_over_mean"]
    assert series["dist_halo_waste_frac"] == pytest.approx(
        sum(part.meta["halo_rows"]) / a.nnz)


def _counting_timer():
    calls = {"n": 0}

    def timer(fn):
        calls["n"] += 1
        fn()
        return 1.0 / calls["n"]

    timer.calls = calls
    return timer


def test_partition_search_grid_pick_and_cache(tmp_path, rng):
    """The scenario of the reference's
    ``test_partition_search_times_run_cfgs_and_memoizes``: candidates
    are timed through the sharded apply, the pick is memoized under the
    reference's partition-level key, and a second construction times
    nothing."""
    ja = jgen.mixed_csr(120, 96, seed=9)
    a = _port(ja)
    timer = _counting_timer()
    spec = ExecSpec(tune="search", tune_cache=str(tmp_path),
                    tune_backend="torch", device="cpu")
    base = tpart.partition_spmm(a, 4, spec=spec.replace(tune="model"))
    # Neither the kernels nor the plain path read the TPU tile knobs: the
    # grid is the base alone, as the reference's "xla" grid.
    for backend in ("cuda", "torch"):
        assert tpart._run_cfg_candidates(base.run_cfg, "spmm",
                                         backend) == [base.run_cfg]
    assert jpart._run_cfg_candidates(base.run_cfg, "spmm", "xla") == \
        [base.run_cfg]
    part = tpart.partition_spmm(a, 4, spec=spec, timer=timer)
    assert timer.calls["n"] == 1
    assert part.run_cfg == base.run_cfg.replace(source="search")
    assert part.meta["run_cfg_source"] == "search"
    key = tune_key(a, op="spmm#p4", width=spec.tune_n, dtype="float32",
                   backend="torch", mode="hybrid", tune="search",
                   threshold=None, bk=base.run_cfg.bk,
                   ts_tile=base.run_cfg.ts_tile, reorder="off")
    assert key == jcache.tune_key(
        ja, op="spmm#p4", width=spec.tune_n, dtype="float32",
        backend="torch", mode="hybrid", tune="search", threshold=None,
        bk=base.run_cfg.bk, ts_tile=base.run_cfg.ts_tile, reorder="off")
    assert PlanCache(str(tmp_path)).get(key).replace(source="search") == \
        part.run_cfg
    # Memoized: the second construction takes the cache hit, no timing.
    part2 = tpart.partition_spmm(a, 4, spec=spec, timer=timer)
    assert timer.calls["n"] == 1 and part2.run_cfg.source == "cache"
    assert part2.run_cfg.replace(source="x") == \
        part.run_cfg.replace(source="x")
    # A different shard count is a different partition-level key.
    tpart.partition_spmm(a, 2, spec=spec, timer=timer)
    assert timer.calls["n"] == 2
    # The searched partition still computes the single-device answer.
    b = torch.from_numpy(rng.standard_normal((a.k, 24)).astype(np.float32))
    got = spmm_sharded(part2, b, mesh=ShardMesh(["cpu"] * 4),
                       backend="torch")
    want = LibraSpMM(a, spec=ExecSpec(device="cpu", backend="torch"))(b)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_partition_search_sddmm_on_a_mesh(tmp_path, rng):
    """The reference's ``test_partition_search_sddmm_and_mesh_path``:
    the SDDMM search, and its timing on the given mesh."""
    a = _port(jgen.mixed_csr(96, 80, seed=10))
    timer = _counting_timer()
    spec = ExecSpec(tune="search", tune_cache=str(tmp_path),
                    tune_backend="torch", device="cpu")
    part = tpart.partition_sddmm(a, 3, spec=spec, timer=timer)
    assert part.run_cfg.source == "search" and timer.calls["n"] == 1
    mesh = ShardMesh(["cpu"])
    p1 = tpart.partition_sddmm(a, 1, spec=spec, timer=timer, mesh=mesh)
    assert timer.calls["n"] == 2
    x = torch.from_numpy(rng.standard_normal((a.m, 16)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((a.k, 16)).astype(np.float32))
    got = sddmm_sharded(p1, x, y, mesh=mesh, backend="torch")
    rows = np.repeat(np.arange(a.m), np.diff(a.indptr))
    s = x.double().numpy() @ y.double().numpy().T
    oracle = s[rows, a.indices]
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-4, atol=1e-4)


def test_partition_stays_host_side_until_a_shard_uploads():
    a = _port(jgen.mixed_csr(120, 96, seed=8))
    part = tpart.partition_spmm(a, 3, spec=ExecSpec(tune="off",
                                                    device="cpu"))
    assert all(isinstance(v, np.ndarray) for v in part.stacked.values())
    arrs = part.arrays(1, "cpu")
    assert arrs.resident_nbytes() == 0
    local = arrs.for_backend("cuda")
    assert set(local) >= {"tc_len", "vpu_len"}
    # Padded segments of the stacked table have real length 0.
    seg_pos = part.stacked["tc_seg_pos"][1]
    real = (seg_pos.max(axis=(1, 2)) >= 0).sum()
    assert (local["tc_len"][real:] == 0).all()
    assert arrs.resident_nbytes() > 0
    assert part.arrays(1, "cpu") is arrs
