"""The tuner (``repro_torch.tune``) against the reference's
``repro.tune``: the analytical model's picks, the plans it builds (with
``reorder="auto"`` too), the empirical search's grid and argmin under a
deterministic stub timer, the persistent ``PlanCache``'s contracts, and
the cache keys.

Both packages get the same seeded matrices. The reference prices plans
with its TPU v5e ``HardwareModel``; the port's model defaults to the
H100's, so the parity tests set the port's default model to the
reference's values (``core.threshold.TPU_V5E``) through the ``tpu``
fixture. Plans are compared key for key (``_host_arrays``), outputs on
integer data bit for bit.
"""
import json
import os
import threading
import time
import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecSpec as JSpec
from repro.core import preprocess as jpre
from repro.core.formats import _host_arrays as j_host_arrays
from repro.models import gnn as jgnn
from repro.sparse.generate import (
    mixed_csr,
    power_law_csr,
    suitesparse_like_corpus,
)
from repro.sparse.matrix import coo_to_csr
from repro.tune import cache as jcache
from repro.tune import model as jmodel
from repro.tune import search as jsearch
from repro_torch.api import ExecSpec
from repro_torch.core import preprocess as tpre
from repro_torch.core.formats import _host_arrays
from repro_torch.core.sddmm import LibraSDDMM
from repro_torch.core.spmm import LibraSpMM
from repro_torch.core.threshold import TPU_V5E
from repro_torch.models import gnn
from repro_torch.obs.trace import Tracer, use_tracer
from repro_torch.sparse import SparseCSR
from repro_torch.tune import (
    DEFAULT_TUNE,
    SMEM_BUDGET_BYTES,
    PlanCache,
    TuneConfig,
    matrix_signature,
    model_tune_sddmm,
    model_tune_spmm,
    occupancy_report,
    sddmm_candidates,
    sddmm_footprint,
    search_sddmm,
    search_spmm,
    spmm_candidates,
    spmm_footprint,
    tune_key,
    tune_sddmm,
    tune_spmm,
)
from repro_torch.tune import cache as tcache
from repro_torch.tune import model as tmodel

CORPUS = suitesparse_like_corpus(12)
PICKED = ["uniform_sparse_0", "powerlaw_1", "banded_2", "mixed_3",
          "powerlaw_5", "mixed_7"]
PLAN_FIELDS = ("threshold", "bk", "ts_tile", "ts", "cs")


def _fields(cfg):
    return tuple(getattr(cfg, f) for f in PLAN_FIELDS)


def _port(a):
    return SparseCSR(a.m, a.k, a.indptr, a.indices, a.data)


def _shuffled_power_law(m, k, avg_row, alpha, seed):
    """The reference tests' reorder recipe: rows shuffled, so reordering
    has windows to densify."""
    a = power_law_csr(m, k, avg_row=avg_row, alpha=alpha, seed=seed)
    rows, cols, vals = a.to_coo()
    return coo_to_csr(m, k, np.random.default_rng(seed + 1).permutation(m)
                      [rows], cols, vals)


def _int_valued(a, seed=7):
    """Same pattern, non-zero integer values: fp32 sums are exact in any
    order, so any two plans of one matrix give the same bits."""
    vals = np.random.default_rng(seed).integers(1, 4, a.nnz)
    return coo_to_csr(a.m, a.k, *a.to_coo()[:2], vals.astype(np.float32))


@pytest.fixture
def tpu(monkeypatch):
    """Price the port's default model with the reference's TPU values."""
    for fn in (tmodel.model_tune_spmm, tmodel.model_tune_sddmm):
        monkeypatch.setitem(fn.__kwdefaults__, "hw", TPU_V5E)


def _seq_timer(seq):
    """Deterministic stub: returns ``seq`` values in candidate order and
    counts its calls; it still runs each candidate's apply once."""
    state = {"i": 0}

    def timer(fn):
        fn()
        v = seq[state["i"] % len(seq)]
        state["i"] += 1
        return float(v)

    timer.state = state
    return timer


# ------------------------------------------------------------- model ---
@pytest.mark.parametrize("width", [32, 128, 256])
@pytest.mark.parametrize("op", ["spmm", "sddmm"])
@pytest.mark.parametrize("name", PICKED)
def test_model_picks_match_reference(name, op, width, tpu):
    a = CORPUS[name]
    if op == "spmm":
        want = jmodel.model_tune_spmm(a, n=width)
        got = model_tune_spmm(_port(a), n=width)
    else:
        want = jmodel.model_tune_sddmm(a, kf=width)
        got = model_tune_sddmm(_port(a), kf=width)
    assert _fields(got) == _fields(want)
    assert got.source == "model"
    # The TPU tiling knobs stay at the defaults: no CUDA kernel reads them.
    tiles = ("kt", "nt", "kf_tile", "yt", "xt", "grid_order")
    assert all(getattr(got, f) == getattr(DEFAULT_TUNE, f) for f in tiles)


@pytest.mark.parametrize("kw", [
    {"threshold": 5}, {"bk": 8}, {"ts_tile": 16}, {"bk": 8, "ts_tile": 8},
    {"mode": "tcu", "threshold": 1}, {"mode": "vpu", "threshold": 9}],
    ids=["threshold", "bk", "ts_tile", "bk+ts_tile", "tcu", "vpu"])
@pytest.mark.parametrize("op", ["spmm", "sddmm"])
def test_model_keeps_explicit_knobs_as_reference(op, kw, tpu):
    a = mixed_csr(96, 96, seed=3)
    fn = {"spmm": (jmodel.model_tune_spmm, model_tune_spmm),
          "sddmm": (jmodel.model_tune_sddmm, model_tune_sddmm)}[op]
    want, got = fn[0](a, **kw), fn[1](_port(a), **kw)
    assert _fields(got) == _fields(want)
    for key, value in kw.items():
        if key != "mode":
            assert getattr(got, key) == value


def test_h100_model_prices_with_the_data_sheet():
    """The port's default model is the H100's: its analytic break-even
    sits higher than the TPU's (a smaller Tensor Core / CUDA-core rate
    ratio), and the picks it makes on the corpus are valid plans."""
    from repro_torch.core.threshold import HardwareModel, analytic_threshold

    hw = HardwareModel()
    assert (hw.mxu_tflops, hw.vpu_tflops, hw.hbm_gbps) == (495, 67, 3350)
    assert model_tune_spmm.__kwdefaults__["hw"] == hw
    assert analytic_threshold(hw) > analytic_threshold(TPU_V5E)
    for a in CORPUS.values():
        cfg = model_tune_spmm(_port(a), n=256)
        assert 1 <= cfg.threshold <= 9 and cfg.ts >= 1 and cfg.cs >= 8


def test_footprint_reads_the_kernels_sources():
    """K1: two stages of 32 rows at a pitch of nt + 4 and 8 value rows of
    40, nt = 128 columns at n >= 128 (36,352 B, 6 blocks an SM by shared
    memory). K3: 4 warps x 2 stages; at a 128-feature slice (Y of 16,384
    rows fits the L2 slice) 16 Y rows and 8 X rows at a pitch of 144
    (115,328 B), on the 169,343-row graph a 64-feature slice (86.7 MB of
    Y does not fit 44 MiB): 32 Y rows at a pitch of 80 (111,744 B); two
    blocks an SM either way."""
    fp = spmm_footprint(256, 169343)
    assert fp["smem_bytes"] == 36352 and fp["threads"] == 128
    occ = occupancy_report(fp["smem_bytes"], fp["threads"])
    assert occ["blocks_per_sm"] == 6 and occ["fits"]
    assert spmm_footprint(40, 100)["threads"] == 64
    for k, kf_slice, smem in ((16384, 128, 115328), (169343, 64, 111744)):
        fp = sddmm_footprint(128, k)
        assert (fp["k3_slice_feats"], fp["smem_bytes"]) == (kf_slice, smem)
        assert occupancy_report(fp["smem_bytes"], fp["threads"])[
            "blocks_per_sm"] == 2
    # K2's slice of B at n = 256 over 169,343 rows: the widest power of
    # two of float4 lanes whose rows fit 44 MiB (64 columns).
    assert spmm_footprint(256, 169343)["l2_slice_cols"] == 64


def test_model_records_the_footprint_on_its_span():
    a = _port(mixed_csr(96, 96, seed=3))
    tr = Tracer()
    with use_tracer(tr):
        cfg = model_tune_spmm(a, n=256)
        model_tune_sddmm(a, kf=128)
    spmm, sddmm = tr.to_dict()
    assert spmm["name"] == sddmm["name"] == "tune.model"
    assert spmm["attrs"] == {
        "op": "spmm", "m": 96, "k": 96, "nnz": a.nnz,
        "threshold": cfg.threshold, "smem_block_bytes": 36352,
        "blocks_per_sm": 6, "l2_slice_cols": 128}
    assert sddmm["attrs"]["smem_block_bytes"] == 115328
    assert sddmm["attrs"]["k3_slice_feats"] == 128


@pytest.mark.parametrize("op", ["spmm", "sddmm"])
def test_model_warns_and_narrows_over_budget(op):
    """A budget below a kernel's fixed staging: the caps narrow as far as
    they go (nothing in the port's staging shrinks with them) and the
    model warns instead of emitting the config silently."""
    a = _port(power_law_csr(256, 256, 12.0, seed=2))
    fn = model_tune_spmm if op == "spmm" else model_tune_sddmm
    with pytest.warns(RuntimeWarning, match="shared memory"):
        cfg = fn(a, budget=1024)
    assert cfg.ts == 1 and cfg.cs == cfg.ts_tile
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        assert fn(a, budget=SMEM_BUDGET_BYTES).source == "model"


def test_model_within_budget_for_the_corpus():
    for a in CORPUS.values():
        for n in (40, 128, 256):
            fp = spmm_footprint(n, a.k)
            assert occupancy_report(fp["smem_bytes"], fp["threads"])["fits"]
            fp = sddmm_footprint(n, a.k)
            assert occupancy_report(fp["smem_bytes"], fp["threads"])["fits"]


# ------------------------------------------------------------- plans ---
@pytest.mark.parametrize("reorder", ["off", "auto"])
@pytest.mark.parametrize("op", ["spmm", "sddmm"])
@pytest.mark.parametrize("name", ["mixed_3", "powerlaw_5", "shuffled"])
def test_tuned_plans_match_reference(name, op, reorder, tpu):
    a = (_shuffled_power_law(192, 160, 8.0, 1.5, 7) if name == "shuffled"
         else CORPUS[name])
    want = jpre.Plan.build(a, op, JSpec(tune="model", reorder=reorder,
                                        tune_n=64, tune_kf=32))
    got = tpre.Plan.build(_port(a), op, ExecSpec(
        tune="model", reorder=reorder, tune_n=64, tune_kf=32,
        device="cpu"))
    assert _fields(got.cfg) == _fields(want.cfg)
    assert got.plan.meta["reorder"] == want.plan.meta["reorder"]
    assert (got.reorder is None) == (want.reorder is None)
    ref_host, port_host = j_host_arrays(want.plan), _host_arrays(got.plan)
    assert list(port_host) == list(ref_host)
    for key in ref_host:
        assert port_host[key].dtype == ref_host[key].dtype, key
        np.testing.assert_array_equal(port_host[key], ref_host[key],
                                      err_msg=key)


@pytest.mark.parametrize("mode", ["tcu", "vpu"])
@pytest.mark.parametrize("op", ["spmm", "sddmm"])
def test_tuned_forced_modes_match_reference(op, mode, tpu):
    a = CORPUS["mixed_7"]
    want = jpre.Plan.build(a, op, JSpec(mode=mode))
    got = tpre.Plan.build(_port(a), op, ExecSpec(mode=mode, device="cpu"))
    assert _fields(got.cfg) == _fields(want.cfg)
    assert got.plan.meta["tc_ratio"] == want.plan.meta["tc_ratio"]
    assert got.plan.meta["tc_ratio"] == (1.0 if mode == "tcu" else 0.0)


def test_tune_off_reproduces_the_defaults():
    a = _port(mixed_csr(64, 64, seed=12))
    op = LibraSpMM(a, spec=ExecSpec(tune="off", device="cpu"))
    assert op.plan.threshold == tpre.DEFAULT_SPMM_THRESHOLD
    assert op.plan.tc.bk == tpre.DEFAULT_BK_SPMM
    assert op.tune_config == DEFAULT_TUNE
    assert LibraSpMM(a, spec=ExecSpec(device="cpu")).tune_config.source \
        == "model"


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_tuned_configs_bit_identical_outputs(backend):
    """Every tune setting builds a plan of the same matrix: on integer
    data the outputs agree to the bit (the kernel path on the CPU runs
    the kernels' plain twins)."""
    a = _port(_int_valued(power_law_csr(96, 80, 7.0, seed=8)))
    rng = np.random.default_rng(1)
    b = torch.from_numpy(rng.integers(-2, 3, (a.k, 48)).astype(np.float32))
    x = torch.from_numpy(rng.integers(-2, 3, (a.m, 24)).astype(np.float32))
    y = torch.from_numpy(rng.integers(-2, 3, (a.k, 24)).astype(np.float32))
    outs = {"spmm": [], "sddmm": []}
    for tune in ("off", "model", TuneConfig(threshold=2, ts=2, cs=16),
                 TuneConfig(threshold=1, ts=0, cs=0)):
        spec = ExecSpec(tune=tune, backend=backend, device="cpu")
        outs["spmm"].append(LibraSpMM(a, spec=spec)(b))
        outs["sddmm"].append(LibraSDDMM(a, spec=spec)(x, y))
    for got in outs.values():
        assert all(torch.equal(o, got[0]) for o in got[1:])


# ------------------------------------------------------------ search ---
@pytest.mark.parametrize("op", ["spmm", "sddmm"])
@pytest.mark.parametrize("name", ["mixed", "powerlaw"])
def test_torch_grid_is_the_reference_xla_grid(name, op, tpu):
    a = (mixed_csr(64, 64, seed=4) if name == "mixed"
         else power_law_csr(96, 96, 8.0, seed=6))
    if op == "spmm":
        want = jsearch.spmm_candidates(a, n=32, mode="hybrid",
                                       threshold=None, backend="xla")
        got = spmm_candidates(_port(a), n=32, mode="hybrid",
                              threshold=None, backend="torch")
    else:
        want = jsearch.sddmm_candidates(a, kf=32, mode="hybrid",
                                        threshold=None, backend="xla")
        got = sddmm_candidates(_port(a), kf=32, mode="hybrid",
                               threshold=None, backend="torch")
    assert [_fields(c) for c in got] == [_fields(c) for c in want]


@pytest.mark.parametrize("op", ["spmm", "sddmm"])
def test_cuda_grid_times_only_what_the_kernels_read(op, tpu):
    """On ``"cuda"``: the verbatim default config first, the model's pick,
    the §4.3 ts/cs perturbations, then the thresholds — the plans of the
    reference's ``"pallas"`` grid, less the tile and grid-order
    candidates (no CUDA kernel reads those knobs)."""
    a = power_law_csr(96, 96, 8.0, seed=6)
    if op == "spmm":
        ref = jsearch.spmm_candidates(a, n=256, mode="hybrid",
                                      threshold=None, backend="pallas")
        got = spmm_candidates(_port(a), n=256, mode="hybrid",
                              threshold=None, backend="cuda")
        default = tpre.DEFAULT_SPMM_THRESHOLD
    else:
        ref = jsearch.sddmm_candidates(a, kf=128, mode="hybrid",
                                       threshold=None, backend="pallas")
        got = sddmm_candidates(_port(a), kf=128, mode="hybrid",
                               threshold=None, backend="cuda")
        default = tpre.DEFAULT_SDDMM_THRESHOLD
    assert got[0] == DEFAULT_TUNE.replace(threshold=default)
    assert got[1].source == "model"
    want = list(dict.fromkeys(_fields(c) for c in ref))
    assert [_fields(c) for c in got] == want
    assert len(got) > len(spmm_candidates(
        _port(a), n=256, mode="hybrid", threshold=None, backend="torch"))


@pytest.mark.parametrize("winner", [0, 1, "last", "tie"])
@pytest.mark.parametrize("op", ["spmm", "sddmm"])
def test_search_picks_the_reference_index(op, winner, tpu):
    """With one deterministic stub timer, the port (``"torch"``) and the
    reference (``"xla"``) pick the same candidate; ties go to #0, the
    default plan."""
    a = mixed_csr(64, 64, seed=4)
    cands = (jsearch.spmm_candidates if op == "spmm"
             else jsearch.sddmm_candidates)(a, **{
                 "n" if op == "spmm" else "kf": 16}, mode="hybrid",
                 threshold=None, backend="xla")
    seq = [5.0] * len(cands)
    if winner != "tie":
        seq[-1 if winner == "last" else winner] = 1.0
    if op == "spmm":
        want, wt = jsearch.search_spmm(a, n=16, timer=_seq_timer(seq))
        got, gt = search_spmm(_port(a), n=16, backend="torch",
                              device="cpu", timer=_seq_timer(seq))
        default = tpre.DEFAULT_SPMM_THRESHOLD
    else:
        want, wt = jsearch.search_sddmm(a, kf=16, timer=_seq_timer(seq))
        got, gt = search_sddmm(_port(a), kf=16, backend="torch",
                               device="cpu", timer=_seq_timer(seq))
        default = tpre.DEFAULT_SDDMM_THRESHOLD
    assert gt == wt
    assert _fields(got) == _fields(want) and got.source == "search"
    if winner == "tie":
        assert got.threshold == default


def test_search_runs_every_candidate_and_records_it():
    a = _port(mixed_csr(64, 64, seed=4))
    tr = Tracer()
    with use_tracer(tr):
        cfg, timings = search_spmm(a, n=16, backend="torch", device="cpu")
    ncand = len(spmm_candidates(a, n=16, mode="hybrid", threshold=None,
                                backend="torch"))
    assert sorted(timings) == list(range(ncand))
    assert all(t > 0 for t in timings.values())
    (span,) = [s for s in tr.to_dict() if s["name"] == "tune.search"]
    assert [e["attrs"]["index"] for e in span["events"]] == list(
        range(ncand))
    assert span["attrs"]["best"] == min(timings, key=lambda i: (
        timings[i], i))
    assert cfg.source == "search"


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_search_on_the_kernel_backend_needs_a_card(device, monkeypatch):
    """``tune_backend="cuda"`` times the kernels on the card: without one
    (or on a CPU operator) it raises instead of timing the plain path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = _port(mixed_csr(48, 48, seed=4))
    timer = _seq_timer([1.0])
    err = ValueError if device == "cpu" else RuntimeError
    with pytest.raises(err):
        search_spmm(a, n=8, backend="cuda", device=device, timer=timer)
    with pytest.raises(err):
        search_sddmm(a, kf=8, backend="cuda", device=device, timer=timer)
    if device == "cpu":
        with pytest.raises(ValueError, match="tune_backend='cuda'"):
            LibraSpMM(a, spec=ExecSpec(tune="search", device="cpu"))
    assert timer.state["i"] == 0


def test_search_fails_when_a_candidate_fails(monkeypatch):
    a = _port(mixed_csr(48, 48, seed=4))

    def broken(*args, **kw):
        raise RuntimeError("launch failed")

    monkeypatch.setattr("repro_torch.core.spmm.spmm_apply", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        search_spmm(a, n=8, backend="torch", device="cpu")


def test_median_timer_waits_for_the_card(monkeypatch):
    """The timer synchronizes before and after each rep."""
    from repro_torch.tune import search

    calls = []
    monkeypatch.setattr(search, "synchronize", lambda: calls.append("sync"))
    timer = search.median_timer(reps=3, warmup=1)
    assert timer(lambda: calls.append("run")) >= 0
    assert calls == ["run"] + ["sync", "run", "sync"] * 3


# ------------------------------------------------------------- cache ---
def test_cache_roundtrip_and_signature_invalidation(tmp_path):
    a = _port(mixed_csr(64, 64, seed=5))
    pc = PlanCache(str(tmp_path))
    key = tune_key(a, op="spmm", width=128, dtype="float32", backend="cuda",
                   mode="hybrid", tune="search")
    assert pc.get(key) is None
    cfg = TuneConfig(threshold=4, ts=2, cs=64, source="search")
    pc.put(key, cfg)
    assert pc.get(key) == cfg.replace(source="cache")
    # One extra non-zero ⇒ another sparsity signature ⇒ another key.
    rows, cols, vals = a.to_coo()
    dense = np.zeros((a.m, a.k), bool)
    dense[rows, cols] = True
    r, c = map(int, np.argwhere(~dense)[0])
    a2 = coo_to_csr(a.m, a.k, np.append(rows, r).astype(np.int32),
                    np.append(cols, c).astype(np.int32),
                    np.append(vals, 1.0).astype(np.float32))
    assert matrix_signature(_port(a2)) != matrix_signature(a)
    key2 = tune_key(_port(a2), op="spmm", width=128, dtype="float32",
                    backend="cuda", mode="hybrid", tune="search")
    assert key2 != key and pc.get(key2) is None
    # Same pattern, other values ⇒ same signature (pattern-keyed).
    a3 = coo_to_csr(a.m, a.k, rows, cols, (vals + 1.0).astype(np.float32))
    assert matrix_signature(_port(a3)) == matrix_signature(a)


def test_cache_quarantines_corrupt_entries(tmp_path):
    pc = PlanCache(str(tmp_path))
    pc.put("bad_sum", TuneConfig(threshold=3))
    doc = json.load(open(pc._path("bad_sum")))
    doc["config"]["threshold"] = 7           # tampered: checksum stale
    json.dump(doc, open(pc._path("bad_sum"), "w"))
    assert pc.get("bad_sum") is None
    pc.put("bad_json", TuneConfig())
    with open(pc._path("bad_json"), "w") as f:
        f.write("{not json")
    assert pc.get("bad_json") is None
    st = pc.stats()
    assert st["quarantined"] == 2 and st["quarantine_dir_files"] == 2
    assert st["quarantined_by_reason"] == {"checksum_mismatch": 1,
                                           "unparseable": 1}
    assert st["quarantined_bytes"] > 0 and st["entries"] == 0
    assert sorted(st) == sorted(jcache.PlanCache(str(tmp_path)).stats())


def test_cache_version_skew_is_a_silent_miss(tmp_path):
    pc = PlanCache(str(tmp_path))
    pc.put("k", TuneConfig(threshold=3))
    doc = json.load(open(pc._path("k")))
    doc["version"] = tcache.CACHE_VERSION - 1
    json.dump(doc, open(pc._path("k"), "w"))
    assert pc.get("k") is None
    assert pc.stats()["quarantined"] == 0 and pc.size() == 1


def test_cache_docs_and_stale_marks(tmp_path):
    pc = PlanCache(str(tmp_path))
    pc.put_doc("d", {"enabled": False, "gain": -0.5})
    assert pc.get_doc("d") == {"enabled": False, "gain": -0.5}
    pc.put("k", TuneConfig(threshold=2))
    assert pc.mark_stale("k") and pc.mark_stale("k")
    assert not pc.mark_stale("missing")
    assert pc.get("k") is None and pc.size() == 1
    st = pc.stats()
    assert st["stale_marked"] == 1 and st["stale_misses"] == 1


def test_cache_default_dir_and_cap_from_the_environment(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.setenv("REPRO_TUNE_CACHE_DIR", str(tmp_path / "jax"))
    PlanCache().put("k", TuneConfig())
    assert (tmp_path / "env" / "k.json").exists()
    assert not (tmp_path / "jax").exists()
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE_DIR")
    assert PlanCache().root == os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch_tune")


def test_cache_size_cap_evicts_lru(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE_MAX", "3")
    pc = PlanCache(str(tmp_path))
    assert pc.max_entries == 3
    for i in range(6):
        pc.put(f"k{i}", TuneConfig(threshold=i + 1))
        time.sleep(0.01)   # distinct mtimes on coarse filesystems
    assert pc.size() == 3
    assert pc.get("k0") is None and pc.get("k1") is None
    assert pc.get("k5").threshold == 6
    # A hit refreshes recency: k3 survives the next eviction, k4 goes.
    time.sleep(0.01)
    assert pc.get("k3") is not None
    time.sleep(0.01)
    pc.put("k6", TuneConfig(threshold=7))
    assert pc.get("k3") is not None and pc.get("k4") is None


def test_cache_concurrent_writers_same_key(tmp_path):
    """Atomic replace keeps racing writers safe: no torn entries, no
    errors, and the surviving entry always parses."""
    pc = PlanCache(str(tmp_path), max_entries=8)
    errors = []

    def writer(i):
        try:
            for j in range(25):
                pc.put("shared", TuneConfig(threshold=1 + (i + j) % 4))
                got = pc.get("shared")
                assert got is None or got.source == "cache"
        except Exception as e:  # collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    got = pc.get("shared")
    assert got is not None and got.threshold in (1, 2, 3, 4)
    assert pc.size() == 1


@pytest.mark.parametrize("op", ["spmm", "sddmm"])
def test_second_construction_hits_persistent_cache(op, tmp_path):
    """A second construction of the same operator takes the cached search
    result and times nothing."""
    a = _port(mixed_csr(64, 64, seed=6))
    pc = PlanCache(str(tmp_path))
    cands = (spmm_candidates(a, n=128, mode="hybrid", threshold=None,
                             backend="torch") if op == "spmm" else
             sddmm_candidates(a, kf=128, mode="hybrid", threshold=None,
                              backend="torch"))
    timer = _seq_timer(list(range(1, len(cands) + 1)))
    tune = tune_spmm if op == "spmm" else tune_sddmm
    kw = dict(tune="search", backend="torch", device="cpu", cache=pc,
              timer=timer)
    cfg1 = tune(a, **kw)
    assert timer.state["i"] == len(cands)
    cfg2 = tune(a, **kw)
    assert timer.state["i"] == len(cands)
    assert cfg2.source == "cache"
    assert cfg2.replace(source="x") == cfg1.replace(source="x")
    # The whole-operator path takes the same hit.
    cls = LibraSpMM if op == "spmm" else LibraSDDMM
    spec = ExecSpec(tune="search", tune_backend="torch", tune_cache=pc,
                    device="cpu")
    assert cls(a, spec=spec).tune_config.source == "cache"
    assert len([n for n in os.listdir(tmp_path)
                if n.endswith(".json")]) == 1
    doc = json.load(open(next(tmp_path.glob("*.json"))))
    assert sorted(doc["meta"]["timings_s"]) == sorted(
        str(i) for i in range(len(cands)))


# -------------------------------------------------------------- keys ---
@pytest.mark.parametrize("name", PICKED)
def test_keys_equal_the_reference_strings(name):
    a = CORPUS[name]
    assert matrix_signature(_port(a)) == jcache.matrix_signature(a)
    assert tcache.CACHE_VERSION == jcache.CACHE_VERSION
    for op, thr in (("spmm", 3), ("sddmm", 24)):
        assert tcache.reorder_key(_port(a), op=op, threshold=thr) == \
            jcache.reorder_key(a, op=op, threshold=thr)
    kw = dict(op="spmm", width=128, dtype="float32", backend="cuda",
              mode="hybrid", tune="search", threshold=None, bk=16)
    assert tune_key(_port(a), **kw) == jcache.tune_key(a, **kw)
    cfg = {"threshold": 3, "ts": 2}
    assert tcache.config_checksum(cfg) == jcache.config_checksum(cfg)


# ------------------------------------------------------ reorder auto ---
@pytest.mark.parametrize("op", ["spmm", "sddmm"])
@pytest.mark.parametrize("name", ["mixed", "graph"])
def test_reorder_auto_decides_as_reference(name, op, tmp_path):
    """The mixed matrix declines; a shuffled power-law graph enables for
    SpMM and declines for SDDMM (the gain is priced at the default SDDMM
    threshold 24, above any 8×1 vector's count, so both fractions are 0,
    as in the reference). A second build with the same cache takes the
    cached decision, and a cached decline skips the sketch pass."""
    a = (mixed_csr(96, 96, seed=32) if name == "mixed"
         else _shuffled_power_law(256, 256, 8.0, 1.5, 11))
    want = jpre.Plan.build(a, op, JSpec(tune="off", reorder="auto"))
    spec = ExecSpec(tune="off", reorder="auto", tune_cache=str(tmp_path),
                    device="cpu")
    got = tpre.Plan.build(_port(a), op, spec)
    rep = got.plan.meta["reorder"]
    assert rep == want.plan.meta["reorder"]
    enabled = name == "graph" and op == "spmm"
    assert rep["enabled"] == enabled
    assert (got.reorder is None) == (not enabled)
    with mock.patch.object(tpre, "reorder_rows",
                           wraps=tpre.reorder_rows) as sketch:
        again = tpre.Plan.build(_port(a), op, spec)
    assert again.plan.meta["reorder"] == rep
    assert sketch.call_count == int(enabled)
    assert PlanCache(str(tmp_path)).size() == 1


def test_reorder_auto_memo_without_a_cache():
    a = _port(mixed_csr(88, 96, seed=41))
    spec = ExecSpec(tune="off", reorder="auto", device="cpu")
    first = tpre.Plan.build(a, "spmm", spec)
    assert not first.plan.meta["reorder"]["enabled"]
    with mock.patch.object(tpre, "reorder_rows") as sketch:
        again = tpre.Plan.build(a, "spmm", spec)
    assert sketch.call_count == 0
    assert again.plan.meta["reorder"] == first.plan.meta["reorder"]


# -------------------------------------------------------------- GNN ---
def _ints(seed, *shape):
    return np.random.default_rng(seed).integers(-4, 5, shape).astype(
        np.float32)


def test_graphops_default_spec_stays_untuned():
    """As in the reference, a spec-less ``GraphOps`` builds every leg with
    ``tune="off"`` (on the card by default: the test moves the default
    spec to the CPU)."""
    a = _port(mixed_csr(64, 64, seed=2))
    with mock.patch.object(gnn, "ExecSpec",
                           lambda **kw: ExecSpec(device="cpu", **kw)):
        g = gnn.GraphOps(a)
    assert g.spec.tune == "off"
    assert g.cfg == g.cfg_t == g.cfg_sd == DEFAULT_TUNE


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("name", ["mixed", "shuffled"])
def test_tuned_graphops_match_reference_exactly(name, backend, tpu):
    """``GraphOps(tune="model", reorder="auto")``: per-leg configs and
    reorder decisions equal the reference's, and the forward and the
    first-step cotangents (``spmm``'s dv and dB, ``sddmm``'s dX and dY)
    equal ``jax.vjp`` bit for bit on integer data."""
    a = (mixed_csr(96, 96, seed=32) if name == "mixed"
         else _shuffled_power_law(128, 128, 8.0, 1.5, 7))
    a = _int_valued(a, seed=40)
    jg = jgnn.GraphOps(a, spec=JSpec(tune="model", reorder="auto",
                                     backend="xla"))
    tg = gnn.GraphOps(_port(a), spec=ExecSpec(
        tune="model", reorder="auto", backend=backend, device="cpu"))
    for leg in ("cfg", "cfg_t", "cfg_sd"):
        assert _fields(getattr(tg, leg)) == _fields(getattr(jg, leg)), leg
    ev, b, dc = _ints(41, a.nnz), _ints(42, a.k, 8), _ints(43, a.m, 8)
    x, y, dv = _ints(44, a.m, 8), _ints(45, a.k, 8), _ints(46, a.nnz)
    tev, tb, tx, ty = (torch.from_numpy(t).requires_grad_()
                       for t in (ev, b, x, y))
    out_c = tg.spmm(tev, tb)
    out_c.backward(torch.from_numpy(dc))
    out_s = tg.sddmm(tx, ty)
    out_s.backward(torch.from_numpy(dv))
    got = [t.detach().numpy() for t in (out_c, tev.grad, tb.grad, out_s,
                                        tx.grad, ty.grad)]
    wc, vjp_c = jax.vjp(jg.spmm, jnp.asarray(ev), jnp.asarray(b))
    ws, vjp_s = jax.vjp(jg.sddmm, jnp.asarray(x), jnp.asarray(y))
    want = [np.asarray(t) for t in (wc, *vjp_c(jnp.asarray(dc)), ws,
                                    *vjp_s(jnp.asarray(dv)))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        tg.fixed_spmm(torch.from_numpy(b)).numpy(),
        np.asarray(jg.fixed_spmm(jnp.asarray(b))))


def test_tuned_graphops_shares_one_feature_pass():
    a = _port(mixed_csr(96, 96, seed=32))
    with mock.patch.object(gnn, "matrix_features",
                           wraps=gnn.matrix_features) as feats, \
            mock.patch.object(tmodel, "matrix_features",
                              wraps=tmodel.matrix_features) as inner:
        gnn.GraphOps(a, spec=ExecSpec(tune="model", device="cpu"))
    # One pass of A shared by the A-SpMM and SDDMM legs, one of Aᵀ.
    assert feats.call_count == 1 and inner.call_count == 1
