"""Row reordering (``repro_torch.reorder``, ``ExecSpec(reorder="on")``):
the port against ``repro.reorder`` and the reference's reordered plans.

Both packages get the same seeded matrices: the reference's shuffled
power-law recipe (``tests/test_reorder.py``), ``power_law_csr`` and
``mixed_csr``. The permutations, the reordered matrices, the feature
pass and the reordered plans must equal the reference's exactly (they
are integer and NumPy float32 data built by the same operations); the
operators' outputs must equal the reference's and the unreordered
operators' bit for bit on integer data in [-4, 4], whose fp32 sums are
exact in any order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import reorder as jre
from repro.api import ExecSpec as JSpec
from repro.core import preprocess as jpre
from repro.core.formats import _host_arrays as j_host_arrays
from repro.core.sddmm import LibraSDDMM as JSDDMM
from repro.core.spmm import LibraSpMM as JSpMM
from repro.sparse.generate import mixed_csr, power_law_csr
from repro.sparse.matrix import coo_to_csr
from repro.tune.model import TuneConfig as JTune
from repro.tune.model import matrix_features as j_matrix_features
from repro_torch import reorder as tre
from repro_torch.api import ExecSpec
from repro_torch.core import preprocess as tpre
from repro_torch.core.formats import (
    PlanArrays,
    _host_arrays,
    real_prefix_lengths,
    real_vector_lengths,
)
from repro_torch.core.sddmm import LibraSDDMM
from repro_torch.core.spmm import LibraSpMM
from repro_torch.kernels import ref
from repro_torch.kernels.spmm_mxu import real_lengths as tc_real_lengths
from repro_torch.kernels.spmm_vpu import real_lengths as vpu_real_lengths
from repro_torch.sparse import SparseCSR
from repro_torch.tune.model import TuneConfig, matrix_features


def shuffled_power_law(m, k, avg_row, alpha, seed):
    """The reference tests' recipe: a power-law matrix with its rows
    shuffled, so its windows start sparse and reordering has work."""
    a = power_law_csr(m, k, avg_row=avg_row, alpha=alpha, seed=seed)
    rng = np.random.default_rng(seed + 1)
    rows, cols, vals = a.to_coo()
    return coo_to_csr(m, k, rng.permutation(m)[rows], cols, vals)


def int_copy(a, seed):
    """Same pattern, non-zero integer values in [-4, 4]."""
    vals = np.random.default_rng(seed).integers(1, 5, a.nnz) * np.where(
        np.random.default_rng(seed + 1).random(a.nnz) < 0.5, -1, 1)
    return coo_to_csr(a.m, a.k, *a.to_coo()[:2], vals.astype(np.float32))


MATRICES = {
    "shuffled_powerlaw": lambda: shuffled_power_law(192, 160, 8.0, 1.5, 7),
    "powerlaw": lambda: power_law_csr(160, 192, 10.0, alpha=1.4, seed=5),
    "mixed": lambda: mixed_csr(96, 96, seed=32),
}
# "off": the operators' defaults; "tc": a literal config that puts work
# on both Tensor Core streams; "compact": the same without §4.3 segments.
CONFIGS = {"off": None, "tc": {"threshold": 2, "ts": 2, "cs": 32},
           "compact": {"threshold": 2, "ts": 0, "cs": 0}}


def _port(a):
    return SparseCSR(a.m, a.k, a.indptr, a.indices, a.data)


def _specs(cfg, reorder="on", backend="cuda"):
    tune = CONFIGS[cfg]
    jspec = JSpec(tune="off" if tune is None else JTune(**tune),
                  reorder=reorder)
    tspec = ExecSpec(tune="off" if tune is None else TuneConfig(**tune),
                     reorder=reorder, backend=backend, device="cpu")
    return jspec, tspec


@pytest.mark.parametrize("name", list(MATRICES))
def test_permutations_match_reference(name):
    a = MATRICES[name]()
    want, got = jre.reorder_rows(a), tre.reorder_rows(_port(a))
    for field in ("row_perm", "row_inv", "nnz_perm", "nnz_inv"):
        w, g = getattr(want, field), getattr(got, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    np.testing.assert_array_equal(tre.row_sketches(_port(a)),
                                  jre.row_sketches(a))
    assert got.is_identity == want.is_identity


def test_decide_reorder_matches_reference():
    assert tre.MIN_TC_GAIN == jre.MIN_TC_GAIN
    for gain in (-0.5, 0.0, jre.MIN_TC_GAIN - 0.01, jre.MIN_TC_GAIN,
                 jre.MIN_TC_GAIN + 0.01, 0.4):
        assert (tre.decide_reorder({"gain": gain})
                == jre.decide_reorder({"gain": gain}))


@pytest.mark.parametrize("name", list(MATRICES))
def test_apply_reorder_round_trips_values(name):
    a = MATRICES[name]()
    a_r, reord = tre.reorder_csr(_port(a))
    np.testing.assert_array_equal(a_r.data, a.data[reord.nnz_perm])
    np.testing.assert_array_equal(a_r.data[reord.nnz_inv], a.data)
    np.testing.assert_array_equal(a_r.to_dense(),
                                  a.to_dense()[reord.row_perm])
    j_r, _ = jre.reorder_csr(a)
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a_r, field),
                                      getattr(j_r, field), err_msg=field)


@pytest.mark.parametrize("name", list(MATRICES))
def test_matrix_features_and_gain_match_reference(name):
    a = MATRICES[name]()
    want, got = j_matrix_features(a), matrix_features(_port(a))
    np.testing.assert_array_equal(got.win_vec_hist, want.win_vec_hist)
    np.testing.assert_array_equal(got.row_hist, want.row_hist)
    assert got.window_density == want.window_density
    a_r = tre.apply_reorder(_port(a), tre.reorder_rows(_port(a)))
    j_r = jre.apply_reorder(a, jre.reorder_rows(a))
    for thr in (1, 3, 8):
        assert (tre.reorder_gain(got, matrix_features(a_r), thr)
                == jre.reorder_gain(want, j_matrix_features(j_r), thr))
        np.testing.assert_array_equal(got.vectors_at_least(thr),
                                      want.vectors_at_least(thr))


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("op", ["spmm", "sddmm"])
@pytest.mark.parametrize("name", list(MATRICES))
def test_reordered_plans_match_reference(name, op, cfg):
    a = MATRICES[name]()
    jspec, tspec = _specs(cfg)
    want = jpre.Plan.build(a, op, jspec)
    got = tpre.Plan.build(_port(a), op, tspec)
    assert got.plan.meta["reorder"] == want.plan.meta["reorder"]
    assert got.plan.meta["reorder"]["enabled"]
    for field in ("row_perm", "row_inv", "nnz_perm", "nnz_inv"):
        np.testing.assert_array_equal(getattr(got.reorder, field),
                                      getattr(want.reorder, field))
    for key in ("tc_nnz", "vpu_nnz", "seg_spt"):
        assert got.plan.meta[key] == want.plan.meta[key], key
    ref_host, port_host = j_host_arrays(want.plan), _host_arrays(got.plan)
    assert list(port_host) == list(ref_host)
    for key in ref_host:
        assert port_host[key].dtype == ref_host[key].dtype, key
        np.testing.assert_array_equal(port_host[key], ref_host[key],
                                      err_msg=key)
    np.testing.assert_array_equal(got.a.indices, want.a.indices)


def test_reorder_densifies_the_shuffled_matrix():
    """The reference's own check (its tests/test_reorder.py): the Tensor
    Core share grows on the shuffled power-law matrix."""
    a = _port(shuffled_power_law(256, 224, 12.0, 1.4, 11))
    off = tpre.Plan.build(a, "spmm", ExecSpec(tune="off", device="cpu"))
    on = tpre.Plan.build(a, "spmm", ExecSpec(tune="off", reorder="on",
                                             device="cpu"))
    rep = on.plan.meta["reorder"]
    assert rep["enabled"] and rep["gain"] > 0
    assert on.plan.meta["tc_ratio"] > off.plan.meta["tc_ratio"]
    assert off.reorder is None and off.plan.meta["reorder"] == {
        "mode": "off", "enabled": False}
    pos = on.plan.tc.pos
    assert pos.min() >= -1 and pos.max() < a.nnz


@pytest.mark.parametrize("shape", [(4, 8), (0, 0)], ids=["one-window",
                                                          "empty"])
def test_trivial_matrices_are_not_reordered(shape):
    m, nnz = shape
    rows = np.arange(nnz) % max(m, 1)
    a = coo_to_csr(max(m, 1), 8, rows, rows, np.ones(nnz, np.float32))
    for op in ("spmm", "sddmm"):
        built = tpre.Plan.build(_port(a), op,
                                ExecSpec(reorder="on", device="cpu"))
        assert built.reorder is None
        assert built.plan.meta["reorder"] == {"mode": "on",
                                              "enabled": False}


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("name", list(MATRICES))
def test_reordered_real_lengths_equal_the_kernels_own(name, cfg):
    """The remap keeps the −1 pattern of ``pos``, so the lengths derived
    from the reordered plan's maps equal those the kernel wrappers
    derive from the revalued tables (no real value is zero)."""
    a = _port(int_copy(MATRICES[name](), 3))
    _, tspec = _specs(cfg)
    built = tpre.Plan.build(a, "spmm", tspec)
    pa = PlanArrays(built.plan, "cpu")
    t = ref.revalue_spmm_arrays(pa.for_backend("cuda", revalue=True),
                                torch.from_numpy(a.data))
    tc = "tc_seg" if "tc_seg_vals" in t else "tc"
    vpu = "vpu_seg" if "vpu_seg_vals" in t else "vpu"
    assert torch.equal(t["tc_len"], tc_real_lengths(t[f"{tc}_vals"],
                                                    t[f"{tc}_cols"]))
    assert torch.equal(t["vpu_len"], vpu_real_lengths(t[f"{vpu}_vals"],
                                                      t[f"{vpu}_cols"]))
    # The same lengths as the plan built on the reordered matrix itself,
    # before its maps were rewritten to the original order.
    before = tpre.Plan.build(built.a, "spmm", _specs(cfg, "off")[1])
    bh, ah = _host_arrays(before.plan), _host_arrays(built.plan)
    np.testing.assert_array_equal(real_vector_lengths(ah[f"{tc}_pos"]),
                                  real_vector_lengths(bh[f"{tc}_pos"]))
    np.testing.assert_array_equal(real_prefix_lengths(ah[f"{vpu}_pos"]),
                                  real_prefix_lengths(bh[f"{vpu}_pos"]))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("name", list(MATRICES))
def test_reordered_operators_are_exact_on_integers(name, cfg, backend):
    """Reordered ``LibraSpMM``/``LibraSDDMM`` equal the reference's
    reordered operators and the port's unreordered ones bit for bit,
    in original row and nnz order."""
    a = int_copy(MATRICES[name](), 5)
    rng = np.random.default_rng(6)
    b = rng.integers(-4, 5, (a.k, 24)).astype(np.float32)
    x = rng.integers(-4, 5, (a.m, 16)).astype(np.float32)
    y = rng.integers(-4, 5, (a.k, 16)).astype(np.float32)
    jspec, tspec = _specs(cfg, backend=backend)
    _, tspec_off = _specs(cfg, "off", backend)
    want_c = np.asarray(JSpMM(a, spec=jspec)(jnp.asarray(b)))
    want_s = np.asarray(JSDDMM(a, spec=jspec)(jnp.asarray(x),
                                              jnp.asarray(y)))
    for spec in (tspec, tspec_off):
        op = LibraSpMM(_port(a), spec=spec)
        assert (op.reorder is not None) == (spec.reorder == "on")
        np.testing.assert_array_equal(op(torch.from_numpy(b)).numpy(),
                                      want_c)
        sd = LibraSDDMM(_port(a), spec=spec)
        np.testing.assert_array_equal(
            sd(torch.from_numpy(x), torch.from_numpy(y)).numpy(), want_s)


def test_reordered_sddmm_keeps_extra_rows_of_x_in_place():
    a = int_copy(shuffled_power_law(96, 80, 6.0, 1.4, 31), 7)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(-4, 5, (a.m + 5, 8)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(-4, 5, (a.k, 8)).astype(np.float32))
    off = LibraSDDMM(_port(a), spec=ExecSpec(tune="off", device="cpu"))
    on = LibraSDDMM(_port(a), spec=ExecSpec(tune="off", reorder="on",
                                            device="cpu"))
    assert on.reorder is not None
    assert torch.equal(on(x, y), off(x, y))
