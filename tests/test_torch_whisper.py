"""The port's Whisper (``repro_torch.models.whisper``) against
``repro.models.whisper`` on the CPU.

The whisper-tiny ``SMOKE`` config (2 encoder and 2 decoder layers, 32
audio frames) runs with ``compute_dtype="float32"``; the reference's
parameters are carried into the port by ``whisper_params_from_jax`` and
both packages get the same seeded numpy tokens and frame embeddings.
Tolerance: 1e-4·max|ref|, for fp32 sums taken in other orders.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import api as japi
from repro.models import whisper as jw
from repro_torch.configs import get_smoke_config
from repro_torch.launch import flops
from repro_torch.launch.serve import generate
from repro_torch.models import api, whisper
from repro_torch.models.convert import whisper_params_from_jax

ARCH = "whisper-tiny"
REL = 1e-4


@pytest.fixture(autouse=True)
def _no_leaked_activation_context():
    """Run the reference outside any sharding activation context (see
    ``tests/test_torch_transformer.py``)."""
    from repro.dist import sharding

    sharding._ctx.state = None


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = j_smoke(ARCH).scaled(compute_dtype="float32")
    cfg = get_smoke_config(ARCH).scaled(compute_dtype="float32")
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    model = whisper_params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, jparams, cfg, model


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _frames(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)


def _close(out, want):
    out, want = out.detach().numpy(), np.asarray(want)
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=REL * np.abs(want).max())


def test_sinusoid_matches_reference():
    for n, d in ((32, 64), (1500, 384)):
        np.testing.assert_array_equal(whisper._sinusoid(n, d),
                                      np.asarray(jw._sinusoid(n, d)))


def test_encode_and_enc_kv_match_reference():
    jcfg, jparams, cfg, model = _models()
    frames = _frames(cfg, 2, seed=3)
    want = jw.encode(jparams, jnp.asarray(frames), jcfg)
    want_k, want_v = jw.enc_kv(jparams, want, jcfg)
    with torch.no_grad():
        enc = model.encode(torch.from_numpy(frames))
        xk, xv = model.enc_kv(enc)
    _close(enc, want)
    _close(xk, want_k)
    _close(xv, want_v)


@pytest.mark.parametrize("s", [24, 80])
def test_forward_and_loss_match_reference(s):
    jcfg, jparams, cfg, model = _models()
    tokens = _tokens(cfg, 2, s, seed=1)
    frames = _frames(cfg, 2, seed=4)
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -1, np.int32)],
                            axis=1)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
              "frame_embeds": jnp.asarray(frames)}
    want, _ = jax.jit(lambda p, b: japi.forward_logits(p, b, jcfg))(
        jparams, jbatch)
    want_loss = jax.jit(lambda p, b: japi.loss_fn(p, b, jcfg))(
        jparams, jbatch)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels),
             "frame_embeds": torch.from_numpy(frames)}
    with torch.no_grad():
        out, aux = api.forward_logits(model, batch, cfg)
        loss = api.loss_fn(model, batch, cfg)
    assert aux == 0.0 and out.dtype == torch.float32
    _close(out, want)
    assert abs(loss.item() - float(want_loss)) <= REL * abs(float(want_loss))


def test_decode_matches_reference_and_forward():
    jcfg, jparams, cfg, model = _models()
    b, steps = 2, 24
    tokens = _tokens(cfg, b, steps, seed=2)
    frames = _frames(cfg, b, seed=5)
    jcache = japi.init_cache(jcfg, b, steps, dtype=jnp.float32)
    cache = api.init_cache(cfg, b, steps, dtype=torch.float32, device="cpu")
    assert set(cache) == set(jcache) == {"k", "v", "xk", "xv"}
    for key in cache:
        assert tuple(cache[key].shape) == jcache[key].shape
    jxk, jxv = jw.enc_kv(jparams, jw.encode(jparams, jnp.asarray(frames),
                                            jcfg), jcfg)
    jcache = dict(jcache, xk=jxk, xv=jxv)
    with torch.no_grad():
        cache["xk"], cache["xv"] = model.enc_kv(
            model.encode(torch.from_numpy(frames)))
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
        fwd = model(torch.from_numpy(tokens),
                    frame_embeds=torch.from_numpy(frames))
    _close(torch.cat(outs, dim=1), fwd)


def test_generate_matches_reference_greedy_loop():
    """The reference's ``generate`` loop: zero frames encoded into the
    cache's cross K/V, then greedy decoding."""
    jcfg, jparams, cfg, model = _models()
    b, prompt_len, gen = 2, 6, 6
    toks, dt = generate(cfg, b, prompt_len, gen, params=model, device="cpu")
    assert toks.shape == (b, gen) and dt > 0
    prompt = np.random.default_rng(0).integers(
        0, jcfg.vocab, (b, prompt_len)).astype(np.int32)
    cache = japi.init_cache(jcfg, b, prompt_len + gen, dtype=jnp.float32)
    frame = jnp.zeros((b, jcfg.n_audio_ctx, jcfg.d_model), jnp.float32)
    xk, xv = jw.enc_kv(jparams, jw.encode(jparams, frame, jcfg), jcfg)
    cache["xk"], cache["xv"] = xk, xv
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


def test_count_params_against_the_module():
    """``count_params`` equals the reference's, and the module's count
    less the padded vocabulary rows and the norms (two an encoder layer,
    three a decoder layer, the encoder's and the final one), which the
    formula leaves out."""
    from repro.configs import get_config as j_config
    from repro.launch import flops as jflops
    from repro_torch.configs import get_config

    jcfg, jparams, cfg, model = _models()
    for c, jc in ((get_config(ARCH), j_config(ARCH)), (cfg, jcfg)):
        assert flops.count_params(c) == jflops.count_params(jc)
    n_module = sum(p.numel() for p in model.parameters())
    assert n_module == sum(x.size for x in jax.tree.leaves(jparams))
    norms = 2 * cfg.n_enc_layers + 3 * cfg.n_layers + 2
    left_out = ((cfg.vocab_padded - cfg.vocab) * cfg.d_model
                + norms * cfg.d_model)
    assert flops.count_params(cfg)[0] == n_module - left_out


def test_convert_carries_parameters():
    jcfg, jparams, cfg, model = _models()

    def leaf(tree, name, i):
        for part in name.split("."):
            tree = tree[part]
        tree = tree["scale"] if isinstance(tree, dict) else tree
        return np.asarray(tree)[i]

    np.testing.assert_array_equal(model.embedding.detach().numpy(),
                                  np.asarray(jparams["embed"]["embedding"]))
    np.testing.assert_array_equal(model.enc_norm.detach().numpy(),
                                  np.asarray(jparams["enc_norm"]["scale"]))
    for stack, tree in ((model.enc_layers, jparams["enc_layers"]),
                        (model.dec_layers, jparams["dec_layers"])):
        for i, lp in enumerate(stack):
            names = set()
            for name, t in lp.named_parameters():
                np.testing.assert_array_equal(t.detach().numpy(),
                                              leaf(tree, name, i))
                names.add(name.split(".")[0])
            assert names == set(tree)
