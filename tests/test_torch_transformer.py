"""The port's dense transformer against ``repro.models`` on the CPU.

The reference's parameters (``api.init_params``) are carried into the
port by ``transformer_params_from_jax``; both packages get the same
seeded numpy tokens. The ``SMOKE`` configs of the four dense models run
with ``compute_dtype="float32"``, so the comparison is of the algorithm,
not of bf16 rounding points. Tolerance: 1e-4·max|logit|, because fp32
sums over the same products are taken in different orders (the twin's
64-key blocks against the reference's chunks, matmul blocking) and
those differences carry through two layers and the softcaps.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import api as japi
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import generate
from repro_torch.models import api
from repro_torch.models.convert import transformer_params_from_jax

ARCHS = ("gemma2-9b", "minitron-8b", "glm4-9b", "granite-34b")
REL = 1e-4


@pytest.fixture(autouse=True)
def _no_leaked_activation_context():
    """Run the reference outside any sharding activation context. Its
    ``train_step`` enters one by hand and leaves it entered when tracing
    raises (``src/repro/train/train_step.py:33``, on this tree's jax),
    so a test of the training stack that ran earlier in the same process
    can leave its mesh installed for the reference's layers here."""
    from repro.dist import sharding

    sharding._ctx.state = None


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = j_smoke(arch).scaled(compute_dtype="float32")
    cfg = get_smoke_config(arch).scaled(compute_dtype="float32")
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    model = transformer_params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, model


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _close(out, want):
    out, want = out.detach().numpy(), np.asarray(want)
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=REL * np.abs(want).max())


def test_configs_match_reference():
    from repro.configs import ARCHS as J_ARCHS, get_config as j_config
    from repro_torch.configs import ARCHS as T_ARCHS, get_config

    assert T_ARCHS == J_ARCHS
    for name in J_ARCHS:
        for alias in (name, name.replace("_", "-")):
            assert repr(get_config(alias)) == repr(j_config(alias))
            assert repr(get_smoke_config(alias)) == repr(j_smoke(alias))
    cfg, jcfg = get_config("gemma2-9b"), j_config("gemma2-9b")
    assert (cfg.head_dim, cfg.vocab_padded) == (jcfg.head_dim,
                                                jcfg.vocab_padded) == (256,
                                                                       256000)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    jcfg, jparams, cfg, model = _models(arch)
    tokens = _tokens(cfg, 2, 48, seed=1)     # 48 > gemma2's smoke window
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


@pytest.mark.parametrize("arch,cache_keys", [
    ("gemma2-9b", {"k_local", "v_local", "k", "v"}),   # ring wraps at 32
    ("minitron-8b", {"k", "v"}),
])
def test_decode_matches_reference(arch, cache_keys):
    jcfg, jparams, cfg, model = _models(arch)
    b, steps = 2, 48
    tokens = _tokens(cfg, b, steps, seed=2)
    jcache = japi.init_cache(jcfg, b, steps, dtype=jnp.float32)
    cache = api.init_cache(cfg, b, steps, dtype=torch.float32, device="cpu")
    assert set(cache) == set(jcache) == cache_keys
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


@pytest.mark.parametrize("arch", ["gemma2-9b", "granite-34b"])
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


def test_convert_carries_parameters():
    jcfg, jparams, cfg, model = _models("glm4-9b")
    layers = jparams["layers"]
    np.testing.assert_array_equal(model.embedding.detach().numpy(),
                                  np.asarray(jparams["embed"]["embedding"]))
    for i, lp in enumerate(model.layers):
        for group in ("attn", "mlp"):
            for name, t in getattr(lp, group).items():
                np.testing.assert_array_equal(
                    t.detach().numpy(), np.asarray(layers[group][name])[i])
    assert sum(p.numel() for p in model.parameters()) == sum(
        x.size for x in jax.tree.leaves(jparams))
