"""Real-prefix lengths of the CUDA-core SpMM tables, and the slice widths
of the two CUDA-core streams.

K2 reads only each table row's real prefix. Its length comes from the
plan's position map (``PlanArrays.vpu_len``), or, when the caller passes
none, from the values and columns (``spmm_vpu.real_lengths``). These
tests hold the plan tables to the prefix property over the corpus, the
two derivations to each other, and the wrapper's result to be the same
with and without a length. The slice widths are the wrappers' own
arithmetic, checked for what the kernels require of them.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import ExecSpec
from repro_torch.core import preprocess
from repro_torch.core.formats import PlanArrays, real_prefix_lengths
from repro_torch.kernels import _build, ref
from repro_torch.kernels.sddmm_vpu import slice_feats
from repro_torch.kernels.spmm_vpu import real_lengths, slice_cols, spmm_vpu
from repro_torch.sparse import power_law_csr, suitesparse_like_corpus
from repro_torch.tune.model import TuneConfig

CORPUS = suitesparse_like_corpus(12)
LAYOUTS = {"segment": {}, "compact": {"ts": 0, "cs": 0}}


def _arrays(a, layout):
    plan = preprocess.Plan.build(
        a, "spmm", ExecSpec(tune=TuneConfig(**LAYOUTS[layout]),
                            device="cpu")).plan
    pa = PlanArrays(plan, "cpu")
    seg = "_seg" if layout == "segment" else ""
    return pa, seg


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(CORPUS))
def test_real_slots_form_a_prefix(name, layout):
    pa, seg = _arrays(CORPUS[name], layout)
    real = pa.host[f"vpu{seg}_pos"] >= 0
    assert not (real[:, 1:] & ~real[:, :-1]).any()
    assert (real_prefix_lengths(pa.host[f"vpu{seg}_pos"])
            == real.sum(axis=1)).all()


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(CORPUS))
def test_plan_lengths_equal_the_derived_ones(name, layout):
    """With no real value zero, the length from ``pos`` equals the one
    from ``(vals != 0) | (cols != 0)``, for the plan's own values and for
    revalued ones."""
    a = CORPUS[name]
    assert np.count_nonzero(a.data) == a.nnz
    pa, seg = _arrays(a, layout)
    dev = pa.for_backend("cuda")
    lens = dev["vpu_len"]
    assert lens.dtype == torch.int32
    assert torch.equal(lens, real_lengths(dev[f"vpu{seg}_vals"],
                                          dev[f"vpu{seg}_cols"]))
    edge = torch.from_numpy(np.random.default_rng(0).integers(
        1, 5, a.nnz).astype(np.float32))
    t = ref.revalue_spmm_arrays(pa.for_backend("cuda", revalue=True), edge)
    assert t["vpu_len"] is lens
    assert torch.equal(lens, real_lengths(t[f"vpu{seg}_vals"],
                                          t[f"vpu{seg}_cols"]))


def test_lengths_are_no_plan_key():
    pa, _ = _arrays(CORPUS["powerlaw_1"], "segment")
    assert "vpu_len" in pa.for_backend("cuda")
    assert "vpu_len" not in pa.host
    assert "vpu_len" not in pa.backend_keys("cuda")
    assert "vpu_len" not in pa.for_backend("torch")
    assert pa.vpu_len() is pa.vpu_len()


def test_derived_length_stops_at_the_last_non_padding_slot():
    """A real zero weight at column 0 past the last other real slot is
    taken for padding (it adds what the padding adds); anywhere before
    it, it counts."""
    vals = torch.tensor([[1.0, 0.0, 2.0, 0.0], [0.0, 0.0, 0.0, 0.0],
                         [0.0, 3.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0]])
    cols = torch.tensor([[5, 0, 7, 0], [0, 0, 0, 0], [9, 0, 0, 0],
                         [1, 2, 3, 0]], dtype=torch.int32)
    assert real_lengths(vals, cols).tolist() == [3, 0, 2, 4]
    pos = np.array([[0, 1, 2, -1], [-1] * 4, [3, 4, 5, -1], [6, 7, 8, 9]])
    assert real_prefix_lengths(pos).tolist() == [3, 0, 3, 4]


@pytest.mark.parametrize("n", [1, 37, 40, 128])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spmm_vpu_with_and_without_lengths_on_cpu(layout, n):
    a = power_law_csr(300, 260, 7.0, seed=3)
    pa, seg = _arrays(a, layout)
    dev = pa.for_backend("cuda")
    vals, cols = dev[f"vpu{seg}_vals"], dev[f"vpu{seg}_cols"]
    b = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (a.k, n)).astype(np.float32))
    out = spmm_vpu(vals, cols, b, seg_len=dev["vpu_len"])
    assert torch.equal(out, spmm_vpu(vals, cols, b))
    assert torch.equal(out, ref.spmm_tile_partials(vals, cols, b))


# (rows of the gathered operand, its width, float4 path); the float4 path
# takes widths that are multiples of 4 only.
SHAPES = [(k, w, vec4) for k in (80, 169343, 4_000_000)
          for w in (1, 30, 36, 40, 128, 256)
          for vec4 in (True, False) if not (vec4 and w % 4)]


@pytest.mark.parametrize("k,n,vec4", SHAPES)
def test_slice_cols_fits_the_kernel(k, n, vec4):
    """K2's slice: whole float4 (or scalar) columns for at most 32 lanes,
    within the L2 budget unless one lane's worth already exceeds it,
    and all of n in one slice when n fits."""
    unit = 4 if vec4 else 1
    w = slice_cols(k, n, vec4)
    assert w % unit == 0 and 1 <= w // unit <= 32
    assert k * w * 4 <= _build.L2_SLICE_BYTES or w == unit
    whole = -(-n // unit) * unit
    if k * whole * 4 <= _build.L2_SLICE_BYTES and whole <= 32 * unit:
        assert w == whole
    else:
        assert w // unit & (w // unit - 1) == 0


@pytest.mark.parametrize("k,kf,vec4", SHAPES)
def test_slice_feats_fits_the_kernel(k, kf, vec4):
    """K4's slice: a power-of-two group of at most 32 lanes (the
    butterfly sum needs it), within the L2 budget unless one lane's
    worth already exceeds it; no wider group would fit when it takes
    several slices, and no narrower one would take as few."""
    unit = 4 if vec4 else 1
    w = slice_feats(k, kf, vec4)
    group = w // unit
    assert w % unit == 0 and 1 <= group <= 32 and group & (group - 1) == 0
    assert k * w * 4 <= _build.L2_SLICE_BYTES or w == unit
    nslices = -(-kf // w)
    if nslices > 1:
        assert 2 * group > 32 or k * 2 * w * 4 > _build.L2_SLICE_BYTES
    if group > 1:
        assert -(-kf // (w // 2)) > nslices
