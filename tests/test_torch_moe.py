"""The port's MoE family against ``repro.models.moe`` on the CPU.

Both packages get the same seeded numpy inputs; the reference's
parameters (``api.init_params``) reach the port through
``moe_params_from_jax``. The ``SMOKE`` configs of both MoE models run
with ``compute_dtype="float32"`` (moonshot's has a shared expert,
qwen3-moe's none). The routing is compared before any value: a near-tie
between the k-th and (k+1)-th router probability can flip one expert
choice between the packages, which moves that token's output by O(1),
not by rounding, so each test that routes asserts equal ``topi`` first
and reports the smallest such gap.

Tolerances, each with its reason: the router's ``topv`` and aux within
1e-6 (one softmax and a mean in fp32, summed in other orders); the
dispatch bit for bit (gathers); the combine bit for bit on integer rows
with weights in 1/64ths, within 1e-6·max|ref| on random rows (the k
products summed in other orders); everything downstream of a matrix product within
1e-4·max|ref| (fp32 sums in other orders: K5's twin against the
reference's chunks, matmul blocking), as ``test_torch_transformer.py``.
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.core.spmm import LibraSpMM as JLibraSpMM
from repro.launch import flops as jflops
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.sparse.matrix import coo_to_csr as j_coo_to_csr
from repro_torch.api import ExecSpec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.spmm import LibraSpMM
from repro_torch.launch import flops
from repro_torch.launch.serve import generate
from repro_torch.models import api, moe
from repro_torch.models.convert import moe_params_from_jax
from repro_torch.sparse import coo_to_csr

ARCHS = ("moonshot_v1_16b_a3b", "qwen3_moe_235b_a22b")
REL = 1e-4
ROUTER_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _no_leaked_activation_context():
    """Run the reference outside any sharding activation context
    (``src/repro/train/train_step.py:33`` can leave one entered)."""
    from repro.dist import sharding

    sharding._ctx.state = None


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = j_smoke(arch).scaled(compute_dtype="float32")
    cfg = get_smoke_config(arch).scaled(compute_dtype="float32")
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    model = moe_params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    return jcfg, jparams, cfg, model


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _close(out, want, rel=REL):
    out, want = out.detach().numpy(), np.asarray(want)
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _gap(probs, k):
    """Smallest gap between the k-th and (k+1)-th probability."""
    top = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    return float((top[..., k - 1] - top[..., k]).min())


def _same_routing(got, want, logits, k):
    got, want = np.asarray(got), np.asarray(want)
    probs = jax.nn.softmax(jnp.asarray(logits, jnp.float32), axis=-1)
    flips = int((got != want).any(-1).sum())
    assert flips == 0, (f"{flips} tokens routed apart; smallest k-th to "
                        f"(k+1)-th gap {_gap(probs, k):.3e}")


# -------------------------------------------------------------- router --
@pytest.mark.parametrize("shape,k,ties", [
    ((2, 48, 8), 2, False),
    ((1, 64, 64), 6, False),
    ((3, 5, 128), 8, False),
    ((4, 16, 8), 2, True),        # integer logits: exact ties everywhere
])
def test_router_topk_matches_reference(shape, k, ties):
    rng = np.random.default_rng(7)
    if ties:
        logits = rng.integers(-2, 3, shape).astype(np.float32)
    else:
        logits = rng.standard_normal(shape).astype(np.float32)
    wv, wi, waux = jmoe.router_topk(jnp.asarray(logits), k)
    topv, topi, aux = moe.router_topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(topv.numpy(), np.asarray(wv), rtol=0,
                               atol=ROUTER_ATOL)
    assert abs(aux.item() - float(waux)) <= ROUTER_ATOL


# ------------------------------------------------- dispatch and combine --
@pytest.mark.parametrize("t,e,k,cf", [
    (96, 8, 2, 1.25), (96, 8, 2, 0.5), (200, 64, 6, 1.25), (50, 128, 8, 0.5),
    (12, 8, 2, 8.0)])
def test_dispatch_and_combine_bit_for_bit(t, e, k, cf):
    rng = np.random.default_rng(11)
    d = 24
    x = rng.standard_normal((t, d)).astype(np.float32)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    cap = max(4, min(int(cf * t * k / e), t))
    wv, wi, _ = jmoe.router_topk(jnp.asarray(logits), k)
    wbuf, wslots = jmoe._local_dispatch(jnp.asarray(x), wi, wv, e, k, cap,
                                        jnp.float32)
    _, topi, _ = moe.router_topk(torch.from_numpy(logits), k)
    _same_routing(topi, wi, logits, k)
    buf, slots = moe._local_dispatch(torch.from_numpy(x), topi, e, k, cap,
                                     torch.float32)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(wbuf))
    np.testing.assert_array_equal(slots.numpy(), np.asarray(wslots))
    dropped = int((slots == e * cap).sum())
    if cf == 0.5:
        assert dropped > 0
    if cap == t:
        assert dropped == 0
    # The combine: bit for bit on integer rows and weights in 1/64ths
    # (every product and sum exact, so the order over k cannot show), and
    # within 1e-6·max|ref| on random rows with the router's weights (XLA
    # and torch sum the k products in different orders).
    y_int = rng.integers(-4, 5, (e, cap, d)).astype(np.float32)
    v_int = np.round(np.asarray(wv) * 64) / 64
    y = rng.standard_normal((e, cap, d)).astype(np.float32)
    for yy, vv, rel in ((y_int, v_int, 0.0), (y, np.array(wv), ROUTER_ATOL)):
        want = jmoe._local_combine(jnp.asarray(yy), wslots, jnp.asarray(vv),
                                   jnp.float32)
        got = moe._local_combine(torch.from_numpy(yy), slots,
                                 torch.from_numpy(vv))
        _close(got, want, rel)


# ------------------------------------------------------------ moe_block --
@pytest.mark.parametrize("dispatch", ["local", "global_sort"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, dispatch):
    jcfg, jparams, cfg, model = _models(arch)
    jcfg, cfg = (c.scaled(moe_dispatch=dispatch) for c in (jcfg, cfg))
    x = np.random.default_rng(5).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["moe"])
    want, waux = jax.jit(lambda p, v: jmoe.moe_block(p, v, jcfg))(
        jp, jnp.asarray(x))
    logits = x @ np.asarray(jp["router"])
    _, wi, _ = jmoe.router_topk(jnp.asarray(logits), cfg.top_k)
    with torch.no_grad():
        _, topi, _ = moe.router_topk(torch.from_numpy(logits), cfg.top_k)
        out, aux = moe.moe_block(model.layers[0].moe, torch.from_numpy(x),
                                 cfg)
    _same_routing(topi, wi, logits, cfg.top_k)
    assert ("shared" in model.layers[0].moe) == bool(cfg.n_shared_experts)
    _close(out, want)
    assert abs(aux.item() - float(waux)) <= ROUTER_ATOL


# --------------------------------------------------- forward and decode --
def _reference_routing(jparams, jcfg, tokens):
    """The reference's topi of every layer, recorded eagerly (its scan runs
    layer by layer under ``disable_jit`` once remat is off)."""
    got = []
    real = jmoe.router_topk

    def record(logits, k):
        out = real(logits, k)
        got.append((np.asarray(out[1]), np.asarray(logits)))
        return out

    with mock.patch.object(jmoe, "router_topk", record), jax.disable_jit():
        japi.forward_logits(jparams, {"tokens": jnp.asarray(tokens)},
                            jcfg.scaled(remat=False))
    return got


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    jcfg, jparams, cfg, model = _models(arch)
    tokens = _tokens(cfg, 2, 48, seed=1)
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -1, np.int32)],
                            axis=1)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    want, want_aux = jax.jit(lambda p, b: japi.forward_logits(p, b, jcfg))(
        jparams, jbatch)
    want_loss = jax.jit(lambda p, b: japi.loss_fn(p, b, jcfg))(
        jparams, jbatch)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    routes = []
    real = moe.router_topk

    def record(logits, k):
        out = real(logits, k)
        routes.append(out[1])
        return out

    with torch.no_grad():
        with mock.patch.object(moe, "router_topk", record):
            out, aux = api.forward_logits(model, batch, cfg)
        loss = api.loss_fn(model, batch, cfg)
    ref_routes = _reference_routing(jparams, jcfg, tokens)
    assert len(routes) == len(ref_routes) == cfg.n_layers
    for topi, (wi, logits) in zip(routes, ref_routes):
        _same_routing(topi, wi, logits, cfg.top_k)
    assert out.dtype == torch.float32
    _close(out, want)
    assert abs(aux.item() - float(want_aux)) <= ROUTER_ATOL
    assert abs(loss.item() - float(want_loss)) <= REL * abs(float(want_loss))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    """Held to the reference's decode, not to the port's forward: the
    capacity of a decode step (t = B) differs from a forward's (B·S)."""
    jcfg, jparams, cfg, model = _models(arch)
    b, steps = 2, 12
    tokens = _tokens(cfg, b, steps, seed=2)
    jcache = japi.init_cache(jcfg, b, steps, dtype=jnp.float32)
    cache = api.init_cache(cfg, b, steps, dtype=torch.float32, device="cpu")
    assert set(cache) == set(jcache) == {"k", "v"}
    for key in cache:
        assert tuple(cache[key].shape) == jcache[key].shape
    jstep = jax.jit(lambda p, c, t, n: japi.decode_step(p, c, t, n, jcfg))
    with torch.no_grad():
        for t in range(steps):
            want, jcache = jstep(jparams, jcache,
                                 jnp.asarray(tokens[:, t:t + 1]),
                                 jnp.int32(t + 1))
            out, cache = api.decode_step(
                model, cache, torch.from_numpy(tokens[:, t:t + 1]), t + 1,
                cfg)
            _close(out, want)
    for key in cache:
        _close(cache[key], jcache[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_greedy_loop(arch):
    jcfg, jparams, cfg, model = _models(arch)
    b, prompt_len, gen = 2, 6, 6
    toks, dt = generate(cfg, b, prompt_len, gen, params=model, device="cpu")
    assert toks.shape == (b, gen) and dt > 0
    # The reference's loop (repro.launch.serve.generate) over the jitted
    # api.decode_step, without its mesh: same prompt, greedy argmax.
    prompt = np.random.default_rng(0).integers(
        0, jcfg.vocab, (b, prompt_len)).astype(np.int32)
    cache = japi.init_cache(jcfg, b, prompt_len + gen, dtype=jnp.float32)
    step = jax.jit(lambda p, c, t, n: japi.decode_step(p, c, t, n, jcfg))
    out = []
    for t in range(prompt_len + gen - 1):
        tok = jnp.asarray(prompt[:, t:t + 1]) if t < prompt_len else out[-1]
        lg, cache = step(jparams, cache, tok, jnp.int32(t + 1))
        if t >= prompt_len - 1:
            out.append(jnp.argmax(lg[:, -1], axis=-1).astype(
                jnp.int32)[:, None])
    np.testing.assert_array_equal(toks, np.concatenate(
        [np.asarray(t) for t in out], axis=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_router_balanced_aux(arch):
    """``tests/test_models.py``'s contract at the default bf16 compute:
    the Switch aux loss is >= 1, with equality at perfect balance."""
    cfg = get_smoke_config(arch)
    model = api.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    with torch.no_grad():
        logits, aux = api.forward_logits(model, {"tokens": tokens}, cfg)
    assert tuple(logits.shape) == (2, 64, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert 0.9 < aux.item() < 4.0


# ---------------------------------------------- parameters and convert --
@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_matches_reference_and_module(arch):
    for cfg, jcfg in ((get_config(arch), j_config(arch)),
                      (get_smoke_config(arch), j_smoke(arch))):
        assert flops.count_params(cfg) == jflops.count_params(jcfg)
    # count_params leaves out the norms and the vocabulary's padding.
    _, _, cfg, model = _models(arch)
    held = sum(p.numel() for p in model.parameters())
    extra = ((cfg.vocab_padded - cfg.vocab) * cfg.d_model
             + (2 * cfg.n_layers + 1) * cfg.d_model)
    assert held - extra == flops.count_params(cfg)[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_every_leaf(arch):
    jcfg, jparams, cfg, model = _models(arch)
    layers = jparams["layers"]
    names = dict(model.named_parameters())
    want = {"embedding": jparams["embed"]["embedding"],
            "final_norm": jparams["final_norm"]["scale"]}
    for path, leaf in jax.tree_util.tree_leaves_with_path(layers):
        keys = [p.key for p in path]
        for i in range(cfg.n_layers):
            if keys[-1] == "scale":
                want[f"layers.{i}.{keys[0]}"] = leaf[i]
            else:
                want[f"layers.{i}." + ".".join(keys)] = leaf[i]
    assert set(names) == set(want)
    for name, leaf in want.items():
        np.testing.assert_array_equal(names[name].detach().numpy(),
                                      np.asarray(leaf))
    assert sum(p.numel() for p in model.parameters()) == sum(
        x.size for x in jax.tree.leaves(jparams))


# ------------------------------------------- the dispatch through Libra --
@pytest.mark.parametrize("t,e,k,cf", [
    (96, 8, 2, 1.25), (96, 8, 2, 0.5), (512, 64, 6, 1.25)])
def test_libra_dispatch_equals_sort_buffer(t, e, k, cf):
    """The dispatch matrix D ((e·cap) × t, one 1.0 a kept assignment) from
    the port's own slots: ``LibraSpMM(D)(x)`` is the sort-based buffer bit
    for bit (each row is one term times 1.0), and Libra's split of D is
    the reference's (all NNZ-1 vectors: nothing on the Tensor Cores)."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((t, 40)).astype(np.float32))
    logits = torch.from_numpy(rng.standard_normal((t, e)).astype(np.float32))
    _, topi, _ = moe.router_topk(logits, k)
    cap = max(4, min(int(cf * t * k / e), t))
    buf, slots = moe._local_dispatch(x, topi, e, k, cap, torch.float32)
    s = slots.numpy().ravel()
    kept = s < e * cap
    coo = (e * cap, t, s[kept].astype(np.int32),
           np.repeat(np.arange(t, dtype=np.int32), k)[kept],
           np.ones(int(kept.sum()), np.float32))
    op = LibraSpMM(coo_to_csr(*coo), spec=ExecSpec(device="cpu"))
    assert torch.equal(op(x), buf.reshape(e * cap, -1))
    assert op.tc_ratio == JLibraSpMM(j_coo_to_csr(*coo)).tc_ratio == 0.0
