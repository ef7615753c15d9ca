"""The port's Mamba2 (``repro_torch.models.mamba2``) against
``repro.models.mamba2`` on the CPU.

Both packages get the same seeded numpy inputs; the reference's
parameters (``api.init_params``) are carried into the port by
``mamba2_params_from_jax``. The reference draws ``conv_b`` and
``conv_c`` as zeros, which zeroes B and C and with them the whole state
path, so the model tests draw those two leaves (and ``dt_bias``) from a
seeded numpy generator before both packages get them. The ``SMOKE``
config runs with ``compute_dtype="float32"``. Tolerance: 1e-4·max|ref|,
for fp32 sums taken in other orders (einsum contraction paths, the
reference's ``lax.scan`` against a Python loop).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import api as japi
from repro.models import mamba2 as jm
from repro_torch.configs import get_smoke_config
from repro_torch.launch import flops
from repro_torch.launch.serve import generate
from repro_torch.models import api, mamba2
from repro_torch.models.convert import mamba2_params_from_jax

ARCH = "mamba2-130m"
REL = 1e-4


@pytest.fixture(autouse=True)
def _no_leaked_activation_context():
    """Run the reference outside any sharding activation context (see
    ``tests/test_torch_transformer.py``)."""
    from repro.dist import sharding

    sharding._ctx.state = None


def _perturb(jparams, seed=7):
    """The reference's tree with ``conv_b``, ``conv_c`` and ``dt_bias``
    drawn from a seeded generator (numpy leaves)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jparams)
    layers = tree["layers"]
    for name, scale in (("conv_b", 0.5), ("conv_c", 0.5), ("dt_bias", 0.5)):
        layers[name] = (rng.standard_normal(layers[name].shape)
                        * scale).astype(np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = j_smoke(ARCH).scaled(compute_dtype="float32")
    cfg = get_smoke_config(ARCH).scaled(compute_dtype="float32")
    jparams = _perturb(japi.init_params(jax.random.PRNGKey(0), jcfg))
    model = mamba2_params_from_jax(jparams, cfg, device="cpu")
    return jcfg, jparams, cfg, model


def _layer0(jparams):
    return jax.tree.map(lambda a: jnp.asarray(a[0]), jparams["layers"])


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _close(out, want, rel=REL):
    out, want = out.detach().numpy(), np.asarray(want)
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _randn(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_segsum_matches_reference():
    x = _randn(1, 2, 3, 16)
    got = mamba2._segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(jm._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_causal_conv_matches_reference():
    x, w = _randn(2, 2, 20, 12), _randn(3, 12, 4)
    _close(mamba2._causal_conv(torch.from_numpy(x), torch.from_numpy(w)),
           jm._causal_conv(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("s,chunk", [(64, 16), (32, 32), (48, 64)])
def test_ssd_scan_matches_reference(s, chunk):
    b, h, p, n = 2, 3, 8, 5
    xh, b_in, c_in = _randn(4, b, s, h, p), _randn(5, b, s, n), _randn(
        6, b, s, n)
    dt = np.abs(_randn(7, b, s, h, scale=0.3))
    a = -np.exp(_randn(8, h, scale=0.5))
    args = (xh, dt, a, b_in, c_in)
    y, state = mamba2.ssd_scan(*map(torch.from_numpy, args), chunk)
    jy, jstate = jm.ssd_scan(*map(jnp.asarray, args), chunk)
    assert y.dtype == state.dtype == torch.float32
    _close(y, jy)
    _close(state, jstate)


def test_apply_layer_matches_reference():
    jcfg, jparams, cfg, model = _models()
    x = _randn(9, 2, 64, cfg.d_model)
    with torch.no_grad():
        got = mamba2.apply_layer(model.layers[0], torch.from_numpy(x), cfg)
    _close(got, jm.apply_layer(_layer0(jparams), jnp.asarray(x), jcfg))


def test_decode_layer_matches_reference():
    jcfg, jparams, cfg, model = _models()
    b = 2
    d_in, h, p, n = mamba2._dims(cfg)
    k = cfg.ssm_conv - 1
    x = _randn(10, b, 1, cfg.d_model)
    state = _randn(11, b, h, p, n)
    tail_x, tail_bc = _randn(12, b, k, d_in), _randn(13, b, k, 2 * n)
    args = (x, state, tail_x, tail_bc)
    with torch.no_grad():
        got = mamba2.decode_layer(model.layers[0],
                                  *map(torch.from_numpy, args), cfg)
    want = jm.decode_layer(_layer0(jparams), *map(jnp.asarray, args), jcfg)
    for g, w in zip(got, want):
        _close(g, w)


def test_forward_and_loss_match_reference():
    jcfg, jparams, cfg, model = _models()
    tokens = _tokens(cfg, 2, 96, seed=1)        # three 32-token chunks
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -1, np.int32)],
                            axis=1)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    want, _ = jax.jit(lambda p, b: japi.forward_logits(p, b, jcfg))(
        jparams, jbatch)
    want_loss = jax.jit(lambda p, b: japi.loss_fn(p, b, jcfg))(
        jparams, jbatch)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    with torch.no_grad():
        out, aux = api.forward_logits(model, batch, cfg)
        loss = api.loss_fn(model, batch, cfg)
    assert aux == 0.0 and out.dtype == torch.float32
    _close(out, want)
    assert abs(loss.item() - float(want_loss)) <= REL * abs(float(want_loss))


def test_decode_matches_reference_and_forward():
    jcfg, jparams, cfg, model = _models()
    b, steps = 2, 64
    tokens = _tokens(cfg, b, steps, seed=2)
    jcache = japi.init_cache(jcfg, b, steps, dtype=jnp.float32)
    cache = api.init_cache(cfg, b, steps, dtype=torch.float32, device="cpu")
    assert set(cache) == set(jcache) == {"state", "conv_x", "conv_bc"}
    jstep = jax.jit(lambda p, c, t, n: japi.decode_step(p, c, t, n, jcfg))
    outs = []
    with torch.no_grad():
        for t in range(steps):
            want, jcache = jstep(jparams, jcache,
                                 jnp.asarray(tokens[:, t:t + 1]),
                                 jnp.int32(t + 1))
            out, cache = api.decode_step(
                model, cache, torch.from_numpy(tokens[:, t:t + 1]), t + 1,
                cfg)
            _close(out, want)
            outs.append(out)
        for key in cache:
            _close(cache[key], jcache[key])
        # The recurrence against the port's own chunked forward (two
        # chunks of 32 tokens).
        fwd = model(torch.from_numpy(tokens))
    _close(torch.cat(outs, dim=1), fwd)


def test_generate_matches_reference_greedy_loop():
    jcfg, jparams, cfg, model = _models()
    b, prompt_len, gen = 2, 6, 6
    toks, dt = generate(cfg, b, prompt_len, gen, params=model, device="cpu")
    assert toks.shape == (b, gen) and dt > 0
    prompt = np.random.default_rng(0).integers(
        0, jcfg.vocab, (b, prompt_len)).astype(np.int32)
    cache = japi.init_cache(jcfg, b, prompt_len + gen, dtype=jnp.float32)
    step = jax.jit(lambda p, c, t, n: japi.decode_step(p, c, t, n, jcfg))
    out = []
    for t in range(prompt_len + gen - 1):
        tok = jnp.asarray(prompt[:, t:t + 1]) if t < prompt_len else out[-1]
        lg, cache = step(jparams, cache, tok, jnp.int32(t + 1))
        if t >= prompt_len - 1:
            out.append(jnp.argmax(lg, axis=-1).astype(jnp.int32))
    np.testing.assert_array_equal(toks, np.concatenate(
        [np.asarray(t) for t in out], axis=1))


def test_init_cache_keeps_fp32_conv_tails():
    """The reference's ``api.init_cache`` calls ``mamba2.init_cache``
    without ``dtype``: the conv tails stay fp32 for any requested type."""
    cfg = get_smoke_config(ARCH)
    cache = api.init_cache(cfg, 2, 16, dtype=torch.bfloat16, device="cpu")
    jcache = japi.init_cache(j_smoke(ARCH), 2, 16, dtype=jnp.bfloat16)
    for key in jcache:
        assert tuple(cache[key].shape) == jcache[key].shape
        assert cache[key].dtype == torch.float32 == getattr(
            torch, str(jcache[key].dtype))


def test_count_params_against_the_module():
    """``count_params`` equals the reference's, and the module's own
    count less what the formula leaves out: the padded vocabulary rows
    and the per-layer and final norms."""
    from repro.configs import get_config as j_config
    from repro.launch import flops as jflops
    from repro_torch.configs import get_config

    jcfg, jparams, cfg, model = _models()
    for c, jc in ((get_config(ARCH), j_config(ARCH)), (cfg, jcfg)):
        assert flops.count_params(c) == jflops.count_params(jc)
    n_module = sum(p.numel() for p in model.parameters())
    assert n_module == sum(x.size for x in jax.tree.leaves(jparams))
    left_out = ((cfg.vocab_padded - cfg.vocab) * cfg.d_model
                + cfg.n_layers * cfg.d_model + cfg.d_model)
    assert flops.count_params(cfg)[0] == n_module - left_out


def test_convert_carries_parameters():
    jcfg, jparams, cfg, model = _models()
    layers = jparams["layers"]
    np.testing.assert_array_equal(model.embedding.detach().numpy(),
                                  jparams["embed"]["embedding"])
    for i, lp in enumerate(model.layers):
        for name, t in lp.named_parameters():
            want = layers[name]
            want = want["scale"] if isinstance(want, dict) else want
            np.testing.assert_array_equal(t.detach().numpy(), want[i])
    assert {n for n, _ in model.layers[0].named_parameters()} == set(layers)
