"""The batched form of K1–K4 on the CPU, against the reference's vmaps.

The reference runs K1–K4 with a batch grid axis in two places: the stack
applies (``repro.kernels.ops.spmm_apply_stack``/``sddmm_apply_stack``,
a ``vmap`` of the single apply over a panel stack, per-panel values
included) and the no-mesh sharded apply
(``repro.dist.partition._timed_apply(..., mesh=None)``, a ``vmap`` over
``part.stacked``). The port runs both as one batched apply: each kernel
wrapper takes dense operands with a leading batch axis and tables that
are shared or carry one of their own (on CPU tensors it runs its plain
twin element by element), and one combine covers the batch.

Held here, with the same seeded numpy inputs in both packages:

* the port's stacks (``backend="cuda"``, the wrappers' twins on the CPU)
  against the reference's ``backend="xla"`` stacks, with and without
  per-panel ``edge_vals``, at batches 1 and 4, and against its Pallas
  path in interpret mode on one small plan;
* ``spmm_sharded``/``sddmm_sharded`` on a one-device CPU ``ShardMesh``,
  P ∈ {1, 3, 8}, reordering off and on, against the reference's
  ``_timed_apply(part, op, backend="xla", mesh=None)``;
* every panel and shard against the port's own single apply (the
  panel's, or each shard's through ``ops.spmm_apply``/``sddmm_apply``),
  bit for bit on any data: the twins run the same arithmetic;
* each kernel wrapper called once an apply (one launch a stream on the
  card).

Integer data in [-4, 4] (non-zero integer matrix values) must match the
reference bit for bit: every sum is exact in fp32 in any order. Random
fp32 within rtol 1e-5 and atol 1e-5·max|ref|: the two packages sum the
same products in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecSpec as JSpec
from repro.core.sddmm import LibraSDDMM as JSDDMM
from repro.core.spmm import LibraSpMM as JSpMM
from repro.dist import partition as jpart
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.sparse import SparseCSR as JCSR
from repro.sparse.generate import mixed_csr, power_law_csr
from repro.tune.model import TuneConfig as JTune
from repro_torch.api import ExecSpec
from repro_torch.core.sddmm import LibraSDDMM
from repro_torch.core.spmm import LibraSpMM
from repro_torch.dist import (
    ShardMesh,
    partition_sddmm,
    partition_spmm,
    sddmm_sharded,
    spmm_sharded,
)
from repro_torch import kernels
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.sparse import SparseCSR
from repro_torch.tune.model import TuneConfig

WRAPPERS = ("spmm_mxu", "spmm_vpu", "sddmm_mxu", "sddmm_vpu")


def _matrix(integers: bool, m=96, k=80, seed=31) -> JCSR:
    """``mixed_csr``'s pattern (both SpMM streams and K3 get work), with
    non-zero integer values in [-4, 4] when ``integers``."""
    a = mixed_csr(m, k, seed=seed)
    if not integers:
        return a
    rng = np.random.default_rng(seed)
    vals = rng.integers(1, 5, a.nnz) * rng.choice([-1, 1], a.nnz)
    return JCSR(a.m, a.k, a.indptr, a.indices, vals.astype(np.float32))


def _port(a: JCSR) -> SparseCSR:
    return SparseCSR(a.m, a.k, a.indptr, a.indices, a.data)


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


@pytest.fixture
def calls(monkeypatch):
    """Count the kernel wrappers' calls from the applies (on the card,
    one call is one launch)."""
    counts = dict.fromkeys(WRAPPERS, 0)
    for name in WRAPPERS:
        fn = getattr(ops, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(ops, name, counted)
    return counts


# ------------------------------------------------------------- stacks ---
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("revalued", [False, True],
                         ids=["plan_values", "edge_vals"])
@pytest.mark.parametrize("integers", [True, False], ids=["int", "rand"])
def test_spmm_stack_matches_reference_vmap(integers, revalued, batch, calls):
    a = _matrix(integers)
    rng = np.random.default_rng(40 + batch)
    b = _data(rng, integers, batch, a.k, 24)
    ev = _data(rng, integers, batch, a.nnz) if revalued else None
    jspec = JSpec(tune=JTune(threshold=3))
    jop = JSpMM(a, spec=jspec)
    want = jops.spmm_apply_stack(
        jop.arrays.for_backend("xla", revalue=revalued), jnp.asarray(b),
        m=jop.m, nwin=jop.nwin, backend="xla", cfg=jop.tune_config,
        edge_vals=None if ev is None else jnp.asarray(ev))
    op = LibraSpMM(_port(a), spec=ExecSpec(tune=TuneConfig(threshold=3),
                                           device="cpu"))
    arrs = op.arrays.for_backend("cuda", revalue=revalued)
    assert "tc_seg_vals" in arrs or "tc_seg_pos" in arrs
    b_t = torch.from_numpy(b)
    ev_t = None if ev is None else torch.from_numpy(ev)
    got = ops.spmm_apply_stack(arrs, b_t, m=op.m, nwin=op.nwin,
                               edge_vals=ev_t)
    assert calls == dict.fromkeys(WRAPPERS, 0) | {"spmm_mxu": 1,
                                                  "spmm_vpu": 1}
    _check(got, want, integers)
    for i in range(batch):
        one = arrs if ev_t is None else tref.revalue_spmm_arrays(arrs,
                                                                 ev_t[i])
        assert torch.equal(got[i], ops.spmm_apply(one, b_t[i], m=op.m,
                                                  nwin=op.nwin))


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("integers", [True, False], ids=["int", "rand"])
def test_sddmm_stack_matches_reference_vmap(integers, batch, calls):
    a = _matrix(integers)
    rng = np.random.default_rng(50 + batch)
    x = _data(rng, integers, batch, a.m, 20)
    y = _data(rng, integers, batch, a.k, 20)
    jspec = JSpec(sddmm_threshold=2)
    jop = JSDDMM(a, spec=jspec)
    want = jops.sddmm_apply_stack(
        jop.arrays.for_backend("xla"), jnp.asarray(x), jnp.asarray(y),
        nnz=a.nnz, backend="xla", cfg=jop.tune_config)
    op = LibraSDDMM(_port(a), spec=ExecSpec(sddmm_threshold=2,
                                            device="cpu"))
    arrs = op.arrays.for_backend("cuda")
    x_t, y_t = torch.from_numpy(x), torch.from_numpy(y)
    got = ops.sddmm_apply_stack(arrs, x_t, y_t, nnz=a.nnz)
    assert calls == dict.fromkeys(WRAPPERS, 0) | {"sddmm_mxu": 1,
                                                  "sddmm_vpu": 1}
    _check(got, want, integers)
    for i in range(batch):
        assert torch.equal(got[i], ops.sddmm_apply(arrs, x_t[i], y_t[i],
                                                   nnz=a.nnz))


def _placed_by_the_combine(arrs, x, y, nnz):
    """The wrappers' staged scores placed by ``ref.scatter_scores`` (one
    ``index_add_`` into a swallow slot), what the kernel path returned
    before K3 and K4 stored canonically."""
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
@pytest.mark.parametrize("tables", ["shared", "own"])
@pytest.mark.parametrize("mode", ["hybrid", "tcu"])
def test_sddmm_stack_stores_what_the_combine_placed(mode, tables, kf, calls):
    """A batch of three through one call of each wrapper: the canonical
    stores equal the staged scores placed by the plain combine, under
    ``torch.equal``, with the tables shared by the batch or each
    element's own; ``tcu`` leaves the CUDA-core stream empty."""
    a = _matrix(False)
    rng = np.random.default_rng(kf)
    x = torch.from_numpy(_data(rng, False, 3, a.m, kf))
    y = torch.from_numpy(_data(rng, False, 3, a.k, kf))
    op = LibraSDDMM(_port(a), spec=ExecSpec(mode=mode, sddmm_threshold=2,
                                            device="cpu"))
    arrs = op.arrays.for_backend("cuda")
    if tables == "own":
        arrs = {k: torch.stack([v] * 3) for k, v in arrs.items()}
    el_mask = arrs["vpu_seg_mask" if "vpu_seg_mask" in arrs else "vpu_mask"]
    assert bool(el_mask.any()) == (mode == "hybrid")
    got = ops.sddmm_apply(arrs, x, y, nnz=a.nnz)
    assert calls == dict.fromkeys(WRAPPERS, 0) | {"sddmm_mxu": 1,
                                                  "sddmm_vpu": 1}
    assert got.shape == (3, a.nnz)
    assert torch.equal(got, _placed_by_the_combine(arrs, x, y, a.nnz))


@pytest.mark.parametrize("op_name", ["spmm_edge_vals", "sddmm"])
def test_stacks_match_reference_pallas_vmap(op_name):
    """One small plan through the reference's vmapped Pallas kernels in
    interpret mode (a batch grid axis on K1–K4), bit for bit on integer
    data."""
    a = _matrix(True, m=48, k=40, seed=33)
    rng = np.random.default_rng(60)
    if op_name == "sddmm":
        x, y = (_data(rng, True, 3, r, 16) for r in (a.m, a.k))
        jop = JSDDMM(a, spec=JSpec(sddmm_threshold=2))
        want = jops.sddmm_apply_stack(
            jop.arrays.for_backend("pallas"), jnp.asarray(x), jnp.asarray(y),
            nnz=a.nnz, backend="pallas", cfg=jop.tune_config,
            interpret=True)
        op = LibraSDDMM(_port(a), spec=ExecSpec(sddmm_threshold=2,
                                                device="cpu"))
        got = ops.sddmm_apply_stack(op.arrays.for_backend("cuda"),
                                    torch.from_numpy(x), torch.from_numpy(y),
                                    nnz=a.nnz)
    else:
        b = _data(rng, True, 3, a.k, 16)
        ev = _data(rng, True, 3, a.nnz)
        jop = JSpMM(a, spec=JSpec(tune=JTune(threshold=3)))
        want = jops.spmm_apply_stack(
            jop.arrays.for_backend("pallas", revalue=True), jnp.asarray(b),
            m=jop.m, nwin=jop.nwin, backend="pallas", cfg=jop.tune_config,
            interpret=True, edge_vals=jnp.asarray(ev))
        op = LibraSpMM(_port(a), spec=ExecSpec(
            tune=TuneConfig(threshold=3), device="cpu"))
        got = ops.spmm_apply_stack(op.arrays.for_backend("cuda", revalue=True),
                                   torch.from_numpy(b), m=op.m, nwin=op.nwin,
                                   edge_vals=torch.from_numpy(ev))
    _check(got, want, True)


def test_batched_revalue_is_the_per_panel_revalue():
    """``revalue_spmm_arrays`` on a ``(batch, nnz)`` stack: one gather a
    table, each panel's tables equal to its own revaluation (an empty
    matrix too)."""
    a = _matrix(False)
    op = LibraSpMM(_port(a), spec=ExecSpec(device="cpu"))
    arrs = op.arrays.for_backend("cuda", revalue=True)
    ev = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, a.nnz)).astype(np.float32))
    stacked = tref.revalue_spmm_arrays(arrs, ev)
    for i in range(3):
        one = tref.revalue_spmm_arrays(arrs, ev[i])
        for k, v in one.items():
            want = v if stacked[k].dim() == v.dim() else v[None]
            got = stacked[k] if stacked[k].dim() == v.dim() else \
                stacked[k][i:i + 1]
            assert torch.equal(got, want), k
    pos = torch.tensor([[-1, -1]])
    empty = tref.revalue_spmm_arrays({"vpu_pos": pos}, torch.zeros(2, 0))
    assert torch.equal(empty["vpu_vals"], torch.zeros(2, 1, 2))


def test_empty_stacks():
    a = _matrix(False)
    op = LibraSpMM(_port(a), spec=ExecSpec(device="cpu"))
    sd = LibraSDDMM(_port(a), spec=ExecSpec(device="cpu"))
    out = ops.spmm_apply_stack(op.arrays.for_backend("cuda"),
                               torch.zeros(0, a.k, 8), m=a.m, nwin=op.nwin)
    assert out.shape == (0, a.m, 8)
    out = ops.sddmm_apply_stack(sd.arrays.for_backend("cuda"),
                                torch.zeros(0, a.m, 8), torch.zeros(0, a.k, 8),
                                nnz=a.nnz)
    assert out.shape == (0, a.nnz)


def test_batch_helpers():
    """The batch of a launch comes from its dense operands, which must
    agree; a table with its own batch axis steps by its leading stride,
    a shared one by 0."""
    assert _build.batch_of(torch.zeros(4, 3), torch.zeros(5, 3)) is None
    assert _build.batch_of(torch.zeros(2, 4, 3), torch.zeros(5, 3)) == 2
    with pytest.raises(ValueError, match="batch"):
        _build.batch_of(torch.zeros(2, 4, 3), torch.zeros(3, 5, 3))
    assert _build.batch_stride(torch.zeros(3, 8, 5), 2) == 40
    assert _build.batch_stride(torch.zeros(8, 5), 2) == 0
    with pytest.raises(ValueError, match="batch"):
        tref.over_batch(torch.add, (torch.zeros(2, 3), 1),
                        (torch.zeros(3, 3), 1))


# ----------------------------------------------------------- sharded ---
@pytest.mark.parametrize("integers", [True, False], ids=["int", "rand"])
@pytest.mark.parametrize("reorder", ["off", "on"])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_one_device_shards_match_reference_vmap(n_shards, reorder, integers,
                                                calls):
    """The shards of a one-device mesh as one batched apply, against the
    reference's no-mesh ``vmap`` over ``part.stacked`` and against each
    shard applied alone."""
    a = power_law_csr(160, 160, 7.0, seed=34) if reorder == "on" \
        else _matrix(integers, m=200, k=160, seed=35)
    if reorder == "on" and integers:
        rng = np.random.default_rng(36)
        a = JCSR(a.m, a.k, a.indptr, a.indices,
                 (rng.integers(1, 5, a.nnz)
                  * rng.choice([-1, 1], a.nnz)).astype(np.float32))
    rng = np.random.default_rng(n_shards)
    b = _data(rng, integers, a.k, 24)
    x, y = _data(rng, integers, a.m, 16), _data(rng, integers, a.k, 16)
    jspec = JSpec(tune="off", reorder=reorder)
    jp = jpart.partition_spmm(a, n_shards, spec=jspec)
    js = jpart.partition_sddmm(a, n_shards, spec=jspec)
    want = jpart._timed_apply(jp, "spmm", backend="xla", mesh=None)(
        jnp.asarray(b))
    want_sd = jpart._timed_apply(js, "sddmm", backend="xla", mesh=None)(
        jnp.asarray(x), jnp.asarray(y))
    spec = ExecSpec(tune="off", reorder=reorder, device="cpu")
    part = partition_spmm(_port(a), n_shards, spec=spec)
    sd = partition_sddmm(_port(a), n_shards, spec=spec)
    assert (part.reorder is not None) == (reorder == "on")
    mesh = ShardMesh(["cpu"] * n_shards)
    assert mesh.one_device
    b_t, x_t, y_t = (torch.from_numpy(t) for t in (b, x, y))
    got = spmm_sharded(part, b_t, mesh=mesh)
    got_sd = sddmm_sharded(sd, x_t, y_t, mesh=mesh)
    assert calls == dict.fromkeys(WRAPPERS, 1)
    _check(got, want, integers)
    _check(got_sd, want_sd, integers)
    # Each shard alone, through the single applies on its own tables.
    outs = []
    for p in range(n_shards):
        arrs = part.arrays(p, "cpu")
        outs.append(ops.spmm_apply(arrs.for_backend("cuda"),
                                   b_t.index_select(0, arrs["halo"]),
                                   m=part.rows_pad, nwin=part.wmax))
    assert torch.equal(got, torch.cat(outs).index_select(
        0, part.index("out_gather", "cpu")))
    panels = x_t.index_select(0, sd.index("x_take", "cpu")).split(
        sd.rows_pad)
    outs = []
    for p in range(n_shards):
        arrs = sd.arrays(p, "cpu")
        outs.append(ops.sddmm_apply(arrs.for_backend("cuda"), panels[p],
                                    y_t.index_select(0, arrs["halo"]),
                                    nnz=sd.nnz_pad))
    assert torch.equal(got_sd, torch.cat(outs).index_select(
        0, sd.index("nnz_gather", "cpu")))


@pytest.mark.parametrize("n_shards", [3, 8])
def test_one_device_shards_with_edge_values(n_shards, calls):
    """``edge_vals`` revalue every shard's stacked tables by one gather;
    the batched apply equals each shard revalued and applied alone, and
    the reference's revalued single-device apply."""
    a = _matrix(True, m=200, k=160, seed=37)
    rng = np.random.default_rng(38)
    b = _data(rng, True, a.k, 32)
    ev = _data(rng, True, a.nnz)
    jop = JSpMM(a, spec=JSpec(tune="off"))
    want = jops.spmm_apply(
        jref.revalue_spmm_arrays(jop.arrays.for_backend("xla", revalue=True),
                                 jnp.asarray(ev)),
        jnp.asarray(b), m=a.m, nwin=jop.nwin, backend="xla",
        cfg=jop.tune_config)
    part = partition_spmm(_port(a), n_shards,
                          spec=ExecSpec(tune="off", device="cpu"))
    mesh = ShardMesh(["cpu"] * n_shards)
    b_t, ev_t = torch.from_numpy(b), torch.from_numpy(ev)
    got = spmm_sharded(part, b_t, mesh=mesh, edge_vals=ev_t)
    assert calls["spmm_mxu"] == calls["spmm_vpu"] == 1
    _check(got, want, True)
    outs = []
    for p in range(n_shards):
        arrs = part.arrays(p, "cpu")
        local = tref.revalue_spmm_arrays(
            arrs.for_backend("cuda", revalue=True), ev_t)
        outs.append(ops.spmm_apply(local, b_t.index_select(0, arrs["halo"]),
                                   m=part.rows_pad, nwin=part.wmax))
    assert torch.equal(got, torch.cat(outs).index_select(
        0, part.index("out_gather", "cpu")))


def test_stacked_arrays_account_like_the_shards():
    """The stacked view's projected bytes, derived lengths included, are
    the shards' together; its derived lengths are the shards' stacked."""
    a = _matrix(False, m=200, k=160, seed=39)
    part = partition_spmm(_port(a), 3, spec=ExecSpec(tune="off",
                                                     device="cpu"))
    stacked = part.stacked_arrays("cpu")
    assert part.stacked_arrays("cpu") is stacked
    shards = [part.arrays(p, "cpu") for p in range(3)]
    assert stacked.projected_nbytes("cuda") == sum(
        s.projected_nbytes("cuda") for s in shards)
    for key in ("tc_len", "vpu_len"):
        assert torch.equal(stacked.for_backend("cuda")[key], torch.stack(
            [s.for_backend("cuda")[key] for s in shards]))
