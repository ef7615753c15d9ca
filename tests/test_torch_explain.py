"""The plan explainer against the reference (``repro.obs.explain``).

The same seeded matrices go through both packages' operators (the
reference on ``backend="xla"``/Pallas in interpret mode, the port on the
CPU), untuned and tuned (the port's model priced with the reference's
TPU values), reordering off and on. Every structural field of
``explain_spmm``/``explain_sddmm``/``explain_plan``/``explain_entry``
equals the reference's: kind, shape, threshold, Tensor Core fraction
and nnz, density histogram, reorder report, segments, padding, tune
source, the ``memory`` section and the registry block;
``explain_partition`` equals it on the same partitions. The two
sections that are the card's own are held to their definitions:
``occupancy`` is the Hopper footprint functions' output at the report's
width, and ``measured`` carries the analytic counts (``hlo_flops`` = 2 ×
nnz × width). ``render_table`` names its rows; ``explain_entry`` refuses
a sharded entry.
"""
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.api import ExecSpec as JSpec
from repro.core.sddmm import LibraSDDMM as JSDDMM
from repro.core.spmm import LibraSpMM as JSpMM
from repro.dist import partition as jpart
from repro.obs import explain as jexp
from repro.sparse import generate as jgen
from repro_torch import serve as tserve
from repro_torch.api import ExecSpec
from repro_torch.core.sddmm import LibraSDDMM
from repro_torch.core.spmm import LibraSpMM
from repro_torch.core.threshold import TPU_V5E
from repro_torch.dist import ShardMesh, partition as tpart
from repro_torch.obs import explain as texp
from repro_torch.sparse import SparseCSR
from repro_torch.tune import model as tmodel
from repro_torch.tune.model import (occupancy_report, sddmm_footprint,
                                    spmm_footprint)

STRUCTURAL = ("kind", "shape", "threshold", "tc_fraction", "tc_nnz",
              "vpu_nnz", "density_hist", "reorder", "segments", "padding",
              "tune_source")
MATRICES = {
    "mixed": lambda: jgen.mixed_csr(200, 160, seed=5),
    "powerlaw": lambda: jgen.power_law_csr(128, 96, 6.0, seed=3),
}


@pytest.fixture
def tpu(monkeypatch):
    """Price the port's default model with the reference's TPU values."""
    for fn in (tmodel.model_tune_spmm, tmodel.model_tune_sddmm):
        monkeypatch.setitem(fn.__kwdefaults__, "hw", TPU_V5E)


def _port(a):
    return SparseCSR(a.m, a.k, a.indptr, a.indices, a.data)


def _structural(report):
    return {k: report[k] for k in STRUCTURAL}


def _occupancy(kind, width, k):
    foot = (spmm_footprint if kind == "spmm" else sddmm_footprint)(width, k)
    occ = occupancy_report(foot["smem_bytes"], foot["threads"])
    return {**occ, "width": width, "footprint": foot,
            "bytes_per_step": occ["smem_bytes_per_block"],
            "pipeline_depth": occ["blocks_per_sm"]}


@pytest.mark.parametrize("reorder", ["off", "on"])
@pytest.mark.parametrize("tune", ["off", "model"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_operator_reports_match_reference(name, tune, reorder, tpu):
    ja = MATRICES[name]()
    a = _port(ja)
    jspec = JSpec(tune=tune, reorder=reorder)
    spec = ExecSpec(tune=tune, reorder=reorder, device="cpu")
    for kind, jcls, tcls, jfn, tfn in (
            ("spmm", JSpMM, LibraSpMM, jexp.explain_spmm, texp.explain_spmm),
            ("sddmm", JSDDMM, LibraSDDMM, jexp.explain_sddmm,
             texp.explain_sddmm)):
        jop, top = jcls(ja, spec=jspec), tcls(a, spec=spec)
        for src in (None, "matrix"):
            want = jfn(jop, a=ja if src else None)
            got = tfn(top, a=a if src else None, width=48)
            assert _structural(got) == _structural(want), (kind, src)
            assert got["memory"] == want["memory"]
            assert got["occupancy"] == _occupancy(kind, 48, a.k)
            assert got["measured"] is None
        # explain_plan on the bare plan, and on the raw matrix.
        assert _structural(texp.explain_plan(top.plan)) == \
            _structural(jexp.explain_plan(jop.plan))
        assert texp.explain_plan(top.plan)["occupancy"] is None
        raw = tfn(a, spec=spec)
        assert _structural(raw) == _structural(jfn(ja, spec=jspec))


@pytest.mark.parametrize("reorder", ["off", "on"])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_partition_reports_match_reference(n_shards, reorder, tpu):
    ja = jgen.mixed_csr(200, 160, seed=5)
    a = _port(ja)
    for jfn, tfn in ((jpart.partition_spmm, tpart.partition_spmm),
                     (jpart.partition_sddmm, tpart.partition_sddmm)):
        want = jexp.explain_partition(jfn(ja, n_shards,
                                          spec=JSpec(reorder=reorder)))
        got = texp.explain_partition(tfn(a, n_shards, spec=ExecSpec(
            reorder=reorder, device="cpu")))
        assert got == want
        assert texp.render_table(got) == jexp.render_table(want)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("kind", ["spmm", "sddmm"])
def test_measured_carries_wall_time_and_analytic_counts(kind, backend):
    a = _port(jgen.mixed_csr(200, 160, seed=5))
    cls = LibraSpMM if kind == "spmm" else LibraSDDMM
    op = cls(a, spec=ExecSpec(tune="off", device="cpu"))
    fn = texp.explain_spmm if kind == "spmm" else texp.explain_sddmm
    calls = []

    def timer(f):
        calls.append(f())
        return 0.5e-3

    report = fn(op, measure=True, width=24, backend=backend, timer=timer)
    meas = report["measured"]
    assert meas["wall_s"] == 0.5e-3 and meas["backend"] == backend
    assert meas["counts"] == "analytic"
    assert meas["hlo_flops"] == 2.0 * a.nnz * 24
    assert meas["hlo_gflops_per_s"] == pytest.approx(
        meas["hlo_flops"] / 0.5e-3 / 1e9)
    assert meas["hlo_hbm_bytes"] > 0
    want = (a.m, 24) if kind == "spmm" else (a.nnz,)
    assert tuple(calls[0].shape) == want
    text = texp.render_table(report, title=kind)
    for row in ("operator", "tc_fraction", "tc_segments", "padding",
                "smem_per_block", "blocks_per_sm", "mem_resident",
                "measured_wall", "flops (analytic)", "bytes (analytic)",
                "gflops_per_s"):
        assert f" {row} | " in text, row
    # The default timer synchronizes and takes the median of ``reps``.
    again = fn(op, measure=True, width=24, backend=backend, reps=2)
    assert again["measured"]["wall_s"] > 0


def test_entry_reports_match_reference_and_refuse_sharded():
    ja = jgen.mixed_csr(120, 96, seed=8)
    a = _port(ja)
    jreg = jserve.GraphRegistry(backend="xla", tune="off")
    treg = tserve.GraphRegistry(device="cpu", tune="off")
    jreg.register(ja, name="g")
    treg.register(a, name="g")
    for op in ("spmm", "sddmm"):
        want = jexp.explain_entry(jreg, "g", op=op)
        got = texp.explain_entry(treg, "g", op=op)
        assert _structural(got) == _structural(want)
        assert got["registry"] == want["registry"]
        assert got["memory"] == want["memory"]
    treg.register(a, name="s", mesh=ShardMesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="sharded"):
        texp.explain_entry(treg, "s")
    with pytest.raises(KeyError):
        texp.explain_entry(treg, "nope")


def test_memory_section_tracks_uploads():
    """The reference's ``test_explain_memory_section``."""
    a = _port(jgen.power_law_csr(128, 96, 6.0, seed=3))
    op = LibraSpMM(a, spec=ExecSpec(device="cpu"))
    assert texp.explain_spmm(op)["memory"]["resident_bytes"] == 0
    op(torch.zeros((96, 8)), backend="torch")
    mem = texp.explain_spmm(op)["memory"]
    assert mem["resident_bytes"] == op.arrays.resident_nbytes() > 0
    assert mem["views"]["compact"]["resident_keys"] > 0
    text = texp.render_table(texp.explain_spmm(op))
    assert "mem_compact" in text and "mem_resident" in text
    assert np.isfinite(mem["total_bytes"])
