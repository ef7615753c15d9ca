"""The port's plans equal the reference's, array for array.

Both packages build a plan from the same matrix and the same explicit
``TuneConfig`` (``tests/test_torch_tune.py`` holds the tuned plans);
``_host_arrays`` must
agree key for key, dtype for dtype and value for value, with the §4.3
segment tables on and with ``ts=0, cs=0``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import ExecSpec as JSpec
from repro.core import preprocess as jpre
from repro.core.formats import PlanArrays as JPlanArrays
from repro.core.formats import _host_arrays as j_host_arrays
from repro.sparse.generate import suitesparse_like_corpus
from repro.tune.model import TuneConfig as JTune
from repro_torch.api import ExecSpec
from repro_torch.core import preprocess as tpre
from repro_torch.core.formats import PlanArrays, _host_arrays
from repro_torch.tune.model import TuneConfig

CORPUS = suitesparse_like_corpus(12)
CONFIGS = {"segments": {}, "unsegmented": {"ts": 0, "cs": 0}}


def _plans(a, op, cfg, **spec):
    ref = jpre.Plan.build(a, op, JSpec(tune=JTune(**cfg), **spec))
    port = tpre.Plan.build(a, op, ExecSpec(tune=TuneConfig(**cfg),
                                           device="cpu", **spec))
    return ref, port


def _assert_host_equal(ref_plan, port_plan):
    ref, port = j_host_arrays(ref_plan), _host_arrays(port_plan)
    assert list(ref) == list(port)
    for key in ref:
        assert ref[key].dtype == port[key].dtype, key
        np.testing.assert_array_equal(ref[key], port[key], err_msg=key)


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("op", ["spmm", "sddmm"])
@pytest.mark.parametrize("name", list(CORPUS))
def test_host_arrays_match_reference(name, op, cfg):
    ref, port = _plans(CORPUS[name], op, CONFIGS[cfg])
    assert ref.cfg.threshold == port.cfg.threshold
    assert port.plan.threshold == ref.plan.threshold
    for key in ("tc_nnz", "vpu_nnz", "seg_spt"):
        assert port.plan.meta[key] == ref.plan.meta[key], key
    _assert_host_equal(ref.plan, port.plan)


@pytest.mark.parametrize("mode", ["tcu", "vpu"])
@pytest.mark.parametrize("op", ["spmm", "sddmm"])
def test_forced_modes_match_reference(op, mode):
    a = CORPUS["mixed_3"]
    ref, port = _plans(a, op, {}, mode=mode)
    _assert_host_equal(ref.plan, port.plan)


def test_tune_off_and_explicit_knobs_match_reference():
    a = CORPUS["powerlaw_1"]
    ref = jpre.Plan.build(a, "spmm", JSpec(tune="off", threshold=2, bk=16,
                                           ts_tile=8))
    port = tpre.Plan.build(a, "spmm", ExecSpec(tune="off", threshold=2,
                                               bk=16, ts_tile=8,
                                               device="cpu"))
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(ref.cfg)
    _assert_host_equal(ref.plan, port.plan)


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("op", ["spmm", "sddmm"])
def test_backend_key_sets_mirror_reference(op, cfg):
    ref, port = _plans(CORPUS["mixed_7"], op, CONFIGS[cfg])
    jpa, tpa = JPlanArrays(ref.plan), PlanArrays(port.plan, "cpu")
    for jb, tb in (("xla", "torch"), ("pallas", "cuda")):
        for revalue in (False, True):
            assert (jpa.backend_keys(jb, revalue=revalue)
                    == tpa.backend_keys(tb, revalue=revalue))
    if cfg == "unsegmented":
        # Without segment tables the kernel path reads the compact view.
        assert (tpa.backend_keys("cuda")
                == tpa.backend_keys("torch"))


def test_upload_is_lazy_and_bitmaps_become_int32():
    _, port = _plans(CORPUS["banded_2"], "sddmm", {})
    pa = PlanArrays(port.plan, "cpu")
    assert not pa._dev
    arrs = pa.for_backend("cuda")
    assert set(pa._dev) == set(arrs)
    assert arrs["tc_seg_bitmap"].dtype == torch.int32
    assert pa.host["tc_seg_bitmap"].dtype == np.uint32
    np.testing.assert_array_equal(arrs["tc_seg_bitmap"].numpy(),
                                  pa.host["tc_seg_bitmap"].astype(np.int32))
    assert arrs["vpu_seg_mask"].dtype == torch.bool
    assert pa.for_backend("cuda") is arrs


# ------------------------------------------- SDDMM position ownership ---
def _sddmm_graph(name):
    from repro_torch.sparse import mixed_csr, power_law_csr

    if name == "power_law":
        return power_law_csr(400, 360, 9.0, seed=3)
    return mixed_csr(240, 200, seed=4)


def _ownership(tc_pos, bitmap, el_pos, el_mask, nnz):
    """The invariant K3 and K4's canonical stores rely on: a Tensor Core
    slot has its bitmap bit set exactly when its position is not −1, and
    the live slots of both streams own ``[0, nnz)`` once each."""
    bits = (bitmap[..., None, :] >> np.arange(8)[:, None]) & 1
    np.testing.assert_array_equal(bits.astype(bool), tc_pos >= 0)
    live = np.concatenate([tc_pos[tc_pos >= 0], el_pos[el_mask]])
    np.testing.assert_array_equal(np.sort(live), np.arange(nnz))


@pytest.mark.parametrize("reorder", ["off", "on"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("graph", ["power_law", "mixed"])
def test_sddmm_live_slots_own_every_position_once(graph, cfg, reorder):
    """Segment and compact tables, reordered or not: each canonical
    position has exactly one live slot, and on the Tensor Core stream a
    set bit and a position are the same thing."""
    a = _sddmm_graph(graph)
    built = tpre.Plan.build(a, "sddmm", ExecSpec(
        tune=TuneConfig(threshold=3, **CONFIGS[cfg]), reorder=reorder,
        device="cpu"))
    assert (built.reorder is not None) == (reorder == "on")
    arrs = PlanArrays(built.plan, "cpu")
    h = arrs.host
    assert ("tc_seg_out_pos" in h) == (cfg == "segments")
    for seg in (True, False):
        k = dict(zip(("cols", "bitmap", "window", "pos", "rows", "ecols",
                      "epos", "mask"),
                     arrs.backend_keys("cuda", segmented=seg)))
        assert h[k["pos"]].size and np.count_nonzero(h[k["mask"]])
        _ownership(h[k["pos"]], h[k["bitmap"]], h[k["epos"]],
                   h[k["mask"]], a.nnz)


@pytest.mark.parametrize("n_shards", [1, 3])
def test_sddmm_partition_shards_own_their_positions_once(n_shards):
    """Each shard of a partition owns its own ``[0, shard_nnz)`` once;
    the tail up to ``nnz_pad`` has no owner."""
    from repro_torch.dist.partition import partition_sddmm

    a = _sddmm_graph("power_law")
    part = partition_sddmm(a, n_shards, spec=ExecSpec(tune="off",
                                                      device="cpu"))
    for p, nnz in enumerate(part.meta["shard_nnz"]):
        h = part.arrays(p, "cpu").host
        seg = "_seg" if "vpu_seg_rows" in h else ""
        _ownership(h["tc_seg_out_pos"], h["tc_seg_bitmap"],
                   h[f"vpu{seg}_out_pos"], h[f"vpu{seg}_mask"], nnz)


def test_sddmm_slot_counters():
    """``plan.meta["sddmm_slots"]``/``["sddmm_live"]``, counted at upload
    over the kernel path's tables, and ``GraphOps``' copies of them."""
    from repro_torch.models.gnn import GraphOps

    a = _sddmm_graph("mixed")
    spec = ExecSpec(tune=TuneConfig(threshold=3), device="cpu")
    built = tpre.Plan.build(a, "sddmm", spec)
    assert "sddmm_slots" not in built.plan.meta
    h = PlanArrays(built.plan, "cpu").host
    meta = built.plan.meta
    assert meta["sddmm_slots"] == (h["tc_seg_out_pos"].size
                                   + h["vpu_seg_mask"].size)
    assert meta["sddmm_live"] == a.nnz < meta["sddmm_slots"]
    g = GraphOps(a, spec=spec)
    assert (g.sddmm_slots, g.sddmm_live) == (
        g.arrs_sd.plan.meta["sddmm_slots"], a.nnz)
