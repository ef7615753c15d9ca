"""The port's hybrid apply and operators against the reference package.

Both packages get the same matrix, the same explicit plan config and the
same seeded numpy inputs. The port's ``backend="cuda"`` path runs here
through the kernel wrappers' plain twins (CPU tensors), over the same
segment or compact tables the kernels take on the card; ``"torch"`` is
the plain path over the compact tables. They are held to the reference's
``"xla"`` path and to its Pallas path in interpret mode.

Integer-valued data in [-4, 4] must match exactly: every product and
partial sum is a small integer, exact in fp32 in any summation order.
Random fp32 data within rtol 1e-5 (atol 1e-5·max|ref|), because the two
packages sum the same products in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecSpec as JSpec
from repro.core.sddmm import LibraSDDMM as JSDDMM
from repro.core.spmm import LibraSpMM as JSpMM
from repro.kernels import ops as jops
from repro.kernels.ref import sddmm_dense_oracle, spmm_dense_oracle
from repro.sparse import SparseCSR as JCSR
from repro.sparse.generate import (banded_csr, mixed_csr, power_law_csr,
                                   random_uniform_csr)
from repro.tune.model import TuneConfig as JTune
from repro_torch.api import ExecSpec
from repro_torch.core.sddmm import LibraSDDMM
from repro_torch.core.spmm import LibraSpMM
from repro_torch import kernels
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels._build import ApplyError
from repro_torch.sparse import SparseCSR
from repro_torch.tune.model import TuneConfig

MATS = {
    "mixed": lambda: mixed_csr(104, 90, seed=21),
    "powerlaw": lambda: power_law_csr(77, 120, 7.0, seed=22),
    "banded": lambda: banded_csr(60, 60, 9, 0.7, seed=23),
}
MODES = ["hybrid", "tcu", "vpu"]
LAYOUTS = {"segment": {}, "compact": {"ts": 0, "cs": 0}}


def _port(a: JCSR) -> SparseCSR:
    """The same matrix as the port's container (plain numpy arrays)."""
    return SparseCSR(a.m, a.k, a.indptr, a.indices, a.data)


def _int_values(a: JCSR, seed: int) -> JCSR:
    """``a``'s pattern with non-zero integer values in [-4, 4] (an
    explicit zero would drop out of the SDDMM windows in both packages
    and trip their nnz accounting)."""
    vals = np.random.default_rng(seed).integers(1, 5, a.nnz)
    signs = np.random.default_rng(seed + 1).choice([-1, 1], a.nnz)
    return JCSR(a.m, a.k, a.indptr, a.indices,
                (vals * signs).astype(np.float32))


def _data(rng, integers, *shape):
    if integers:
        return rng.integers(-4, 5, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _check(out, want, integers):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    want = np.asarray(want)
    assert out.shape == want.shape
    if integers:
        np.testing.assert_array_equal(out, want)
    else:
        scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5 * scale)


def _specs(mode, cfg, **kw):
    return (JSpec(mode=mode, tune=JTune(**cfg), **kw),
            ExecSpec(mode=mode, tune=TuneConfig(**cfg), device="cpu", **kw))


@pytest.mark.parametrize("integers", [True, False], ids=["int", "rand"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(MATS))
def test_spmm_operator_matches_xla(name, mode, integers):
    a = MATS[name]()
    if integers:
        a = _int_values(a, 5)
    b = _data(np.random.default_rng(6), integers, a.k, 24)
    jspec, tspec = _specs(mode, {})
    want = JSpMM(a, spec=jspec)(jnp.asarray(b), backend="xla")
    op = LibraSpMM(_port(a), spec=tspec)
    for backend in ("cuda", "torch"):
        _check(op(torch.from_numpy(b), backend=backend), want, integers)


@pytest.mark.parametrize("integers", [True, False], ids=["int", "rand"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(MATS))
def test_sddmm_operator_matches_xla(name, mode, integers):
    a = MATS[name]()
    rng = np.random.default_rng(7)
    x = _data(rng, integers, a.m, 20)
    y = _data(rng, integers, a.k, 20)
    jspec, tspec = _specs(mode, {})
    want = JSDDMM(a, spec=jspec)(jnp.asarray(x), jnp.asarray(y),
                                 backend="xla")
    op = LibraSDDMM(_port(a), spec=tspec)
    for backend in ("cuda", "torch"):
        _check(op(torch.from_numpy(x), torch.from_numpy(y), backend=backend),
               want, integers)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mode", MODES)
def test_spmm_apply_matches_pallas(mode, layout):
    """The kernel path's dispatch (segment or compact tables, combine,
    output slicing) against the reference's Pallas apply."""
    a = _int_values(MATS["mixed"](), 8)
    b = _data(np.random.default_rng(8), True, a.k, 40)
    jspec, tspec = _specs(mode, LAYOUTS[layout], threshold=2)
    jop, op = JSpMM(a, spec=jspec), LibraSpMM(_port(a), spec=tspec)
    want = jops.spmm_apply(jop.arrays.for_backend("pallas"), jnp.asarray(b),
                           m=a.m, nwin=jop.nwin, backend="pallas",
                           cfg=jop.tune_config, interpret=True)
    arrs = op.arrays.for_backend("cuda")
    assert ("tc_seg_vals" in arrs) == (layout == "segment")
    out = ops.spmm_apply(arrs, torch.from_numpy(b), m=a.m, nwin=op.nwin)
    _check(out, want, True)


def combined_scores(arrs, x, y, nnz):
    """The kernels' staged scores placed by the plain combine
    (``ref.scatter_scores``: one ``index_add_`` into a swallow slot), what
    the kernel path's apply returned before its kernels stored
    canonically."""
    seg = "_seg" if "tc_seg_cols" in arrs else ""
    s_tc = kernels.sddmm_mxu(arrs[f"tc{seg}_cols"], arrs[f"tc{seg}_bitmap"],
                             arrs[f"tc{seg}_window"], x, y)
    el = "vpu_seg" if "vpu_seg_rows" in arrs else "vpu"
    mask = arrs[f"{el}_mask"]
    s_el = torch.where(mask, kernels.sddmm_vpu(arrs[f"{el}_rows"],
                                               arrs[f"{el}_cols"], x, y),
                       0.0)
    return tref.scatter_scores(s_tc, arrs[f"tc{seg}_out_pos"], s_el,
                               arrs[f"{el}_out_pos"], mask, nnz)


@pytest.mark.parametrize("kf", [16, 100, 256])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mode", MODES)
def test_sddmm_apply_matches_pallas(mode, layout, kf):
    """The kernel path's canonical stores against the reference's Pallas
    apply, and equal to the staged scores placed by the plain combine;
    ``tcu`` leaves the CUDA-core stream empty, ``vpu`` the Tensor Core
    one. Over the compact tables (no segments) the plain path reads the
    same tables, so it is equal too."""
    a = MATS["powerlaw"]()
    rng = np.random.default_rng(9)
    x, y = _data(rng, True, a.m, kf), _data(rng, True, a.k, kf)
    jspec, tspec = _specs(mode, LAYOUTS[layout], sddmm_threshold=4)
    jop, op = JSDDMM(a, spec=jspec), LibraSDDMM(_port(a), spec=tspec)
    want = jops.sddmm_apply(jop.arrays.for_backend("pallas"), jnp.asarray(x),
                            jnp.asarray(y), nnz=a.nnz, backend="pallas",
                            cfg=jop.tune_config, interpret=True)
    arrs = op.arrays.for_backend("cuda")
    assert ("tc_seg_cols" in arrs) == (layout == "segment")
    x_t, y_t = torch.from_numpy(x), torch.from_numpy(y)
    out = ops.sddmm_apply(arrs, x_t, y_t, nnz=a.nnz)
    _check(out, want, True)
    assert torch.equal(out, combined_scores(arrs, x_t, y_t, a.nnz))
    if layout == "compact":
        assert torch.equal(out, tref.sddmm_hybrid_ref(arrs, x_t, y_t, a.nnz))


def _edge_case(name):
    if name == "zero_nnz":
        return (JCSR(16, 24, np.zeros(17, np.int64), np.zeros(0, np.int32),
                     np.zeros(0, np.float32)), 8)
    if name == "one_nnz_n1":
        return (JCSR(5, 7, np.array([0, 0, 0, 1, 1, 1], np.int64),
                     np.array([4], np.int32), np.array([3.0], np.float32)), 1)
    if name == "ragged":
        return _int_values(random_uniform_csr(13, 29, 0.3, seed=11), 11), 5
    # k > 4096: columns beyond one 4096-row panel of B.
    return _int_values(random_uniform_csr(40, 5000, 0.002, seed=12), 12), 3


EDGES = ["zero_nnz", "one_nnz_n1", "ragged", "k_over_4096"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("edge", EDGES)
def test_edge_probes_match_reference_and_oracle(edge, mode):
    a, n = _edge_case(edge)
    rng = np.random.default_rng(13)
    b = _data(rng, True, a.k, n)
    x, y = _data(rng, True, a.m, n), _data(rng, True, a.k, n)
    jspec, tspec = _specs(mode, {})
    dense = a.to_dense()
    spmm_want = JSpMM(a, spec=jspec)(jnp.asarray(b), backend="xla")
    np.testing.assert_array_equal(np.asarray(spmm_want),
                                  spmm_dense_oracle(dense, b))
    sddmm_want = JSDDMM(a, spec=jspec)(jnp.asarray(x), jnp.asarray(y),
                                       backend="xla")
    np.testing.assert_array_equal(np.asarray(sddmm_want),
                                  sddmm_dense_oracle(dense, x, y))
    spmm, sddmm = (LibraSpMM(_port(a), spec=tspec),
                   LibraSDDMM(_port(a), spec=tspec))
    for backend in ("cuda", "torch"):
        out = spmm(torch.from_numpy(b), backend=backend)
        assert out.shape == (a.m, n)
        _check(out, spmm_want, True)
        out = sddmm(torch.from_numpy(x), torch.from_numpy(y),
                    backend=backend)
        assert out.shape == (a.nnz,)
        _check(out, sddmm_want, True)


def test_unknown_backend_raises():
    a = _port(MATS["banded"]())
    op = LibraSpMM(a, spec=ExecSpec(device="cpu"))
    with pytest.raises(ValueError, match="backend"):
        ops.spmm_apply(op.arrays.for_backend("cuda"), torch.zeros(a.k, 4),
                       m=a.m, nwin=op.nwin, backend="xla")
    with pytest.raises(ValueError, match="backend"):
        ExecSpec(backend="pallas", device="cpu")


def test_classify_apply_error_mirrors_reference():
    cases = [
        ApplyError("compile", "k", RuntimeError("nvcc failed")),
        ApplyError("execute", "k", RuntimeError("CUDA out of memory")),
        ApplyError("execute", "k", RuntimeError("cudaError 700")),
        MemoryError("out of memory"),
        FloatingPointError("non-finite output"),
        ValueError("bad shape"),
    ]
    for exc in cases:
        jexc = exc
        if isinstance(exc, ApplyError):
            jexc = jops.ApplyError(exc.stage, exc.key, exc.cause)
        assert ops.classify_apply_error(exc) == \
            jops.classify_apply_error(jexc)
    assert ops.classify_apply_error(cases[0]) == "compile"
    assert ops.classify_apply_error(cases[1]) == "resource"
