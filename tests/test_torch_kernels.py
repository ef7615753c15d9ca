"""Each kernel's plain twin against the reference's Pallas kernel.

The twins are what the CUDA kernels are held to on the card (in
``chip_smoke.py``), so here they are held to the reference's Pallas
kernels in interpret mode on the same plan tables, segment and compact
layouts. Integer-valued data must match exactly (fp32 sums of small
integers are exact in any order); random fp32 data within rtol 1e-5
(the two sides sum in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sddmm_mxu import sddmm_mxu as j_sddmm_mxu
from repro.kernels.sddmm_vpu import sddmm_vpu as j_sddmm_vpu
from repro.kernels.spmm_mxu import spmm_mxu as j_spmm_mxu
from repro.kernels.spmm_vpu import spmm_vpu as j_spmm_vpu
from repro.sparse.generate import mixed_csr, power_law_csr
from repro_torch import kernels
from repro_torch.api import ExecSpec
from repro_torch.core import preprocess
from repro_torch.core.formats import PlanArrays
from repro_torch.tune.model import TuneConfig

MATS = {"mixed": mixed_csr(96, 96, seed=13),
        "powerlaw": power_law_csr(72, 80, 6.0, seed=14)}
LAYOUTS = {"segment": {}, "compact": {"ts": 0, "cs": 0}}


def _tables(name, op, layout):
    cfg = TuneConfig(threshold=2 if op == "spmm" else 4, **LAYOUTS[layout])
    plan = preprocess.Plan.build(MATS[name], op,
                                 ExecSpec(tune=cfg, device="cpu")).plan
    pa = PlanArrays(plan, "cpu")
    return pa.host, pa.for_backend("cuda")


def _data(rng, integers, *shape):
    if integers:
        return rng.integers(-4, 5, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _check(out, want, integers):
    out = out.numpy()
    want = np.asarray(want)
    assert out.shape == want.shape
    if integers:
        np.testing.assert_array_equal(out, want)
    else:
        np.testing.assert_allclose(out, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("integers", [True, False], ids=["int", "rand"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(MATS))
def test_spmm_twins_match_pallas(name, layout, integers):
    rng = np.random.default_rng(1)
    host, _ = _tables(name, "spmm", layout)
    k = MATS[name].k
    b = _data(rng, integers, k, 128)
    tb = torch.from_numpy(b)
    if layout == "segment":
        vals, cols, rank = (host[x] for x in
                            ("tc_seg_vals", "tc_seg_cols", "tc_seg_rank"))
        n_active, uniq = rank.shape[0], True
        vvals, vcols = host["vpu_seg_vals"], host["vpu_seg_cols"]
    else:
        vals, cols, rank = (host[x] for x in
                            ("tc_vals", "tc_cols", "tc_rank"))
        n_active, uniq = host["tc_active_row"].shape[0] // 8, False
        vvals, vcols = host["vpu_vals"], host["vpu_cols"]
    if integers:
        vals = np.where(vals != 0, _data(rng, True, *vals.shape), 0)
        vvals = np.where(vvals != 0, _data(rng, True, *vvals.shape), 0)
    vals, vvals = vals.astype(np.float32), vvals.astype(np.float32)
    want = j_spmm_mxu(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(rank),
                      jnp.asarray(b), n_active=n_active, nt=128, kt=k,
                      unique_ranks=uniq, interpret=True)
    out = kernels.spmm_mxu(torch.from_numpy(vals), torch.from_numpy(cols),
                           torch.from_numpy(rank), tb, n_active=n_active,
                           unique_ranks=uniq)
    _check(out, want, integers)
    want = j_spmm_vpu(jnp.asarray(vvals), jnp.asarray(vcols), jnp.asarray(b),
                      nt=128, kt=k, interpret=True)
    out = kernels.spmm_vpu(torch.from_numpy(vvals), torch.from_numpy(vcols),
                           tb)
    _check(out, want, integers)


@pytest.mark.parametrize("integers", [True, False], ids=["int", "rand"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(MATS))
def test_sddmm_twins_match_pallas(name, layout, integers):
    rng = np.random.default_rng(2)
    host, dev = _tables(name, "sddmm", layout)
    a = MATS[name]
    x = _data(rng, integers, -(-a.m // 8) * 8, 128)
    y = _data(rng, integers, a.k, 128)
    seg = "_seg" if layout == "segment" else ""
    cols, bits, win = (host[f"tc{seg}_{s}"] for s in ("cols", "bitmap",
                                                       "window"))
    want = j_sddmm_mxu(jnp.asarray(cols), jnp.asarray(bits), jnp.asarray(win),
                       jnp.asarray(x), jnp.asarray(y), interpret=True)
    out = kernels.sddmm_mxu(dev[f"tc{seg}_cols"], dev[f"tc{seg}_bitmap"],
                            dev[f"tc{seg}_window"], torch.from_numpy(x),
                            torch.from_numpy(y))
    _check(out, want, integers)
    rows, ecols = host[f"vpu{seg}_rows"], host[f"vpu{seg}_cols"]
    want = j_sddmm_vpu(jnp.asarray(rows), jnp.asarray(ecols), jnp.asarray(x),
                       jnp.asarray(y), interpret=True)
    out = kernels.sddmm_vpu(torch.from_numpy(rows), torch.from_numpy(ecols),
                            torch.from_numpy(x), torch.from_numpy(y))
    _check(out, want, integers)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spmm_vpu_twin_multiplies_every_slot_like_pallas(layout):
    """Padding (value 0, column 0) and exact-zero weights are multiplied,
    not skipped: with non-finite B rows the twin gives the reference's
    inf/NaN pattern exactly."""
    rng = np.random.default_rng(4)
    host, _ = _tables("powerlaw", "spmm", layout)
    seg = "_seg" if layout == "segment" else ""
    vals = host[f"vpu{seg}_vals"].copy()
    cols = host[f"vpu{seg}_cols"]
    real = np.flatnonzero(vals)
    assert real.size > 1 and real.size < vals.size   # padding present
    vals.flat[real] = _data(rng, True, real.size)
    vals.flat[real[0]] = 0.0                 # an exact-zero weight
    k = MATS["powerlaw"].k
    b = _data(rng, True, k, 16)
    b[0] = np.inf                            # the padding's row
    b[cols.flat[real[1]], :8] = np.nan
    want = np.asarray(j_spmm_vpu(jnp.asarray(vals), jnp.asarray(cols),
                                 jnp.asarray(b), nt=16, kt=k,
                                 interpret=True))
    out = kernels.spmm_vpu(torch.from_numpy(vals), torch.from_numpy(cols),
                           torch.from_numpy(b)).numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(out, want)


def test_sddmm_mxu_reads_rows_past_x_as_zero():
    """The kernel contract takes an unpadded X: a window's rows past the
    end read as zero, which equals the reference on zero-padded X."""
    rng = np.random.default_rng(3)
    cols = rng.integers(0, 20, (3, 16)).astype(np.int32)
    bits = rng.integers(0, 256, (3, 16)).astype(np.uint32)
    win = np.array([0, 1, 2], np.int32)
    x = _data(rng, True, 21, 24)           # 3 windows, last one ragged
    y = _data(rng, True, 20, 24)
    xp = np.concatenate([x, np.zeros((3, 24), np.float32)])
    want = j_sddmm_mxu(jnp.asarray(cols), jnp.asarray(bits), jnp.asarray(win),
                       jnp.asarray(xp), jnp.asarray(y), kf_tile=24,
                       interpret=True)
    out = kernels.sddmm_mxu(torch.from_numpy(cols),
                            torch.from_numpy(bits.astype(np.int32)),
                            torch.from_numpy(win), torch.from_numpy(x),
                            torch.from_numpy(y))
    _check(out, want, True)


def test_cpu_twins_do_not_count_launches():
    kernels.reset_launch_counts()
    b = torch.ones(4, 8)
    kernels.spmm_vpu(torch.ones(2, 3), torch.zeros(2, 3, dtype=torch.int32), b)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


@pytest.mark.parametrize("name", list(kernels.KERNELS))
def test_wrappers_raise_instead_of_falling_back(name):
    """Tensors that are not on the CPU get the kernel or an error, never
    the plain version."""
    meta = {"device": "meta"}
    i32 = dict(dtype=torch.int32, **meta)
    args = {
        "spmm_mxu": ((torch.empty(2, 8, 4, **meta), torch.empty(2, 4, **i32),
                      torch.empty(2, **i32), torch.empty(5, 8, **meta)),
                     {"n_active": 2, "unique_ranks": True}),
        "spmm_vpu": ((torch.empty(2, 4, **meta), torch.empty(2, 4, **i32),
                      torch.empty(5, 8, **meta)), {}),
        "sddmm_mxu": ((torch.empty(2, 4, **i32), torch.empty(2, 4, **i32),
                       torch.empty(2, **i32), torch.empty(16, 8, **meta),
                       torch.empty(5, 8, **meta)), {}),
        "sddmm_vpu": ((torch.empty(2, 4, **i32), torch.empty(2, 4, **i32),
                       torch.empty(16, 8, **meta), torch.empty(5, 8, **meta)),
                      {}),
        "flash_attention": ((torch.empty(1, 64, 4, 64, dtype=torch.bfloat16,
                                         **meta),
                             torch.empty(1, 64, 2, 64, dtype=torch.bfloat16,
                                         **meta),
                             torch.empty(1, 64, 2, 64, dtype=torch.bfloat16,
                                         **meta)), {"causal": True}),
    }[name]
    before = kernels.launch_counts()
    if name == "flash_attention":
        # All-meta operands are K5's shape-only trace (the dry run): the
        # kernel's checks and empty outputs, neither a launch nor the
        # twin. Operands on mixed devices still raise.
        from unittest import mock

        from repro_torch.kernels import flash_attention as fa

        with mock.patch.object(fa, "flash_attention_ref",
                               side_effect=AssertionError("twin ran")):
            out = kernels.KERNELS[name](*args[0], **args[1])
        assert out.device.type == "meta" and out.shape == args[0][0].shape
        q, k, v = args[0]
        with pytest.raises(ValueError, match="k is on cpu"):
            kernels.KERNELS[name](q, torch.empty(k.shape, dtype=k.dtype), v,
                                  **args[1])
    else:
        with pytest.raises(ValueError, match="CUDA"):
            kernels.KERNELS[name](*args[0], **args[1])
    assert kernels.launch_counts() == before

