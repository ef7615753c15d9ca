"""Real-vector lengths of the Tensor Core tables, and K3's slice width.

K1 (``spmm_mxu``) reads only each segment's real condensed vectors. Their
count comes from the plan's position map (``PlanArrays.tc_len``), or,
when the caller passes none, from the values and columns
(``spmm_mxu.real_lengths``). K3 (``sddmm_mxu``) gathers only columns whose
bitmap is non-zero. These tests hold the plan tables of both operators to
the prefix property over the corpus, the two derivations of K1's length
to each other, K1's wrapper to the same result with and without a length,
and K3's slice width to what the kernel is built for.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import ExecSpec
from repro_torch.core import preprocess
from repro_torch.core.formats import PlanArrays, real_vector_lengths
from repro_torch.kernels import _build, ref
from repro_torch.kernels.sddmm_mxu import MAX_SLICE, MIN_SLICE, slice_feats
from repro_torch.kernels.spmm_mxu import real_lengths, spmm_mxu
from repro_torch.sparse import power_law_csr, suitesparse_like_corpus
from repro_torch.tune.model import TuneConfig

CORPUS = suitesparse_like_corpus(12)
CORPUS["power_law_small"] = power_law_csr(300, 260, 7.0, seed=3)
# Segment tables with several blocks a segment, and the compact tables.
LAYOUTS = {"segment": {"ts": 4}, "compact": {"ts": 0, "cs": 0}}


def _arrays(a, op, layout):
    plan = preprocess.Plan.build(
        a, op, ExecSpec(tune=TuneConfig(**LAYOUTS[layout]),
                        device="cpu")).plan
    pa = PlanArrays(plan, "cpu")
    seg = "_seg" if "tc_seg_cols" in pa.host else ""
    return pa, seg


def _prefix(real):
    """True when the True entries of each row come before its False ones."""
    return not (real[:, 1:] & ~real[:, :-1]).any()


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(CORPUS))
def test_real_vectors_form_a_prefix(name, layout):
    """SpMM: a vector is real when any of its 8 rows has a position;
    SDDMM: when its bitmap is non-zero. Either way the real ones come
    first in every segment (or block)."""
    pa, seg = _arrays(CORPUS[name], "spmm", layout)
    if layout == "segment":
        assert seg == "_seg"
    pos = pa.host[f"tc{seg}_pos"]
    real = (pos >= 0).any(axis=1)
    assert _prefix(real)
    assert (real_vector_lengths(pos) == real.sum(axis=1)).all()
    pa, seg = _arrays(CORPUS[name], "sddmm", layout)
    assert _prefix(pa.host[f"tc{seg}_bitmap"] != 0)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(CORPUS))
def test_plan_lengths_equal_the_derived_ones(name, layout):
    """With no real value zero, the length from ``pos`` equals the one
    from the values and columns, for the plan's own values and for
    revalued ones."""
    a = CORPUS[name]
    assert np.count_nonzero(a.data) == a.nnz
    pa, seg = _arrays(a, "spmm", layout)
    dev = pa.for_backend("cuda")
    lens = dev["tc_len"]
    assert lens.dtype == torch.int32
    assert lens.shape == (dev[f"tc{seg}_vals"].shape[0],)
    assert torch.equal(lens, real_lengths(dev[f"tc{seg}_vals"],
                                          dev[f"tc{seg}_cols"]))
    edge = torch.from_numpy(np.random.default_rng(0).integers(
        1, 5, a.nnz).astype(np.float32))
    t = ref.revalue_spmm_arrays(pa.for_backend("cuda", revalue=True), edge)
    assert t["tc_len"] is lens
    assert torch.equal(lens, real_lengths(t[f"tc{seg}_vals"],
                                          t[f"tc{seg}_cols"]))


def test_lengths_are_no_plan_key():
    pa, _ = _arrays(CORPUS["powerlaw_1"], "spmm", "segment")
    assert "tc_len" in pa.for_backend("cuda")
    assert "tc_len" not in pa.host
    assert "tc_len" not in pa.backend_keys("cuda")
    assert "tc_len" not in pa.for_backend("torch")
    assert pa.tc_len() is pa.tc_len()
    sd, _ = _arrays(CORPUS["powerlaw_1"], "sddmm", "segment")
    assert "tc_len" not in sd.for_backend("cuda")


def test_empty_path_has_one_segment_of_length_zero():
    """A matrix with no Tensor Core work still gets one all-padding
    segment (static kernel shapes); its length is 0, so the kernel
    gathers nothing there."""
    a = power_law_csr(400, 400, 2.0, seed=1)
    plan = preprocess.Plan.build(a, "spmm", ExecSpec(
        tune=TuneConfig(threshold=8, ts=4), device="cpu")).plan
    pa = PlanArrays(plan, "cpu")
    assert plan.meta["tc_nnz"] == 0
    assert pa.tc_len().tolist() == [0] * pa.host["tc_seg_vals"].shape[0]


def test_derived_length_stops_at_the_last_non_padding_vector():
    """A vector counts when its column or any of its 8 values is
    non-zero; an all-zero vector at column 0 past the last such vector is
    taken for padding (it adds what the padding adds)."""
    vals = torch.zeros(3, 8, 5)
    cols = torch.zeros(3, 5, dtype=torch.int32)
    vals[0, 7, 0] = 1.0      # row 7 of vector 0
    cols[0, 2] = 4           # vector 2: zero values, real column
    vals[1, 3, 4] = -2.0     # the last vector of block 1
    # block 2: all padding
    assert real_lengths(vals, cols).tolist() == [3, 5, 0]
    pos = np.full((3, 8, 5), -1)
    pos[0, 7, 0], pos[0, 0, 2], pos[1, 3, 4] = 0, 1, 2
    assert real_vector_lengths(pos).tolist() == [3, 5, 0]


@pytest.mark.parametrize("n", [1, 37, 40, 128])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spmm_mxu_with_and_without_lengths_on_cpu(layout, n):
    a = power_law_csr(300, 260, 7.0, seed=3)
    pa, seg = _arrays(a, "spmm", layout)
    dev = pa.for_backend("cuda")
    vals, cols = dev[f"tc{seg}_vals"], dev[f"tc{seg}_cols"]
    rank = dev[f"tc{seg}_rank"]
    n_active = (rank.shape[0] if seg
                else dev["tc_active_row"].shape[0] // 8)
    b = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (a.k, n)).astype(np.float32))
    kw = dict(n_active=n_active, unique_ranks=bool(seg))
    out = spmm_mxu(vals, cols, rank, b, seg_len=dev["tc_len"], **kw)
    assert torch.equal(out, spmm_mxu(vals, cols, rank, b, **kw))
    assert torch.equal(out, ref.spmm_tc_compact_ref(vals, cols, rank, b,
                                                    n_active))


# (rows of Y, features): a small table, the mixed matrix, the graph and a
# table too large for any slice to fit.
SHAPES = [(k, kf) for k in (80, 16384, 169343, 4_000_000)
          for kf in (1, 16, 30, 64, 100, 128, 256)]


@pytest.mark.parametrize("k,kf", SHAPES)
def test_sddmm_mxu_slice_feats_fits_the_kernel(k, kf):
    """K3's slice: a width the kernel is built for (a power of two from
    16 to 128), within the L2 budget unless the narrowest one already
    exceeds it; no wider width would fit when it takes several slices,
    and no narrower one would take as few."""
    w = slice_feats(k, kf)
    assert w in (16, 32, 64, 128) and MIN_SLICE <= w <= MAX_SLICE
    assert k * w * 4 <= _build.L2_SLICE_BYTES or w == MIN_SLICE
    nslices = -(-kf // w)
    if nslices > 1:
        assert 2 * w > MAX_SLICE or k * 2 * w * 4 > _build.L2_SLICE_BYTES
    if w > MIN_SLICE:
        assert -(-kf // (w // 2)) > nslices


def test_sddmm_mxu_slice_widths_of_the_main_path():
    """The graph's Y (169,343 rows) takes two 64-feature slices of 43 MB
    at kf = 128; the mixed matrix's (16,384 rows) one slice of 128."""
    assert slice_feats(169343, 128) == 64
    assert 169343 * 64 * 4 == 43_351_808
    assert slice_feats(169343, 256) == 64
    assert slice_feats(16384, 128) == 128
    assert slice_feats(16384, 30) == 32
