"""The port's VLM family (qwen2-vl: ``Transformer`` with M-RoPE and the
stubbed patch frontend) against ``repro.models.transformer`` on the CPU.

The qwen2-vl-7b ``SMOKE`` config (2 layers, head dim 16, 16 patches)
runs with ``compute_dtype="float32"``; the reference's parameters are
carried into the port by ``transformer_params_from_jax`` and both
packages get the same seeded numpy tokens and patch embeddings.
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
from repro.models import layers as jl
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import flops
from repro_torch.launch.serve import generate
from repro_torch.models import api, layers
from repro_torch.models.convert import transformer_params_from_jax

ARCH = "qwen2-vl-7b"
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
    model = transformer_params_from_jax(jax.tree.map(np.asarray, jparams),
                                        cfg, device="cpu")
    return jcfg, jparams, cfg, model


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _close(out, want):
    out, want = out.detach().numpy(), np.asarray(want)
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=REL * np.abs(want).max())


@pytest.mark.parametrize("d,sections,dtype", [
    (16, (16, 24, 24), "float32"),        # the smoke head dim
    (128, (16, 24, 24), "float32"),       # qwen2-vl-7b's
    (128, (16, 24, 24), "bfloat16"),
    (64, (1, 1, 2), "float32"),
])
def test_apply_mrope_matches_reference(d, sections, dtype):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 12, 3, d)).astype(np.float32)
    pos3 = rng.integers(0, 4096, (3, 2, 12)).astype(np.int32)
    want = np.asarray(jl.apply_mrope(
        jnp.asarray(x, dtype), jnp.asarray(pos3), 1e4,
        sections).astype(jnp.float32))
    got = layers.apply_mrope(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(pos3), 1e4, sections)
    assert got.dtype == getattr(torch, dtype)
    # bf16: both round cos, sin and each product to bf16; an ulp (2^-8
    # relative) apart at most where the fp32 angles' cos/sin differ.
    rel = REL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_mrope_on_a_text_stream_is_close_to_rope():
    """t = h = w: M-RoPE rotates every frequency by the token position,
    as RoPE does, from fp32 frequencies instead of x's type's."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 64, 2, 128)).astype(np.float32))
    pos = torch.arange(64)[None]
    got = layers.apply_mrope(x, torch.stack([pos] * 3), 1e4, (16, 24, 24))
    np.testing.assert_allclose(got.numpy(),
                               layers.apply_rope(x, pos, 1e4).numpy(),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("patches", [True, False])
def test_forward_and_loss_match_reference(patches):
    jcfg, jparams, cfg, model = _models()
    tokens = _tokens(cfg, 2, 40, seed=1)
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -1, np.int32)],
                            axis=1)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    if patches:
        pe = np.random.default_rng(3).standard_normal(
            (2, cfg.n_patches, cfg.d_model)).astype(np.float32)
        jbatch["patch_embeds"] = jnp.asarray(pe)
        batch["patch_embeds"] = torch.from_numpy(pe)
    want, _ = jax.jit(lambda p, b: japi.forward_logits(p, b, jcfg))(
        jparams, jbatch)
    want_loss = jax.jit(lambda p, b: japi.loss_fn(p, b, jcfg))(
        jparams, jbatch)
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
    jcache = japi.init_cache(jcfg, b, steps, dtype=jnp.float32)
    cache = api.init_cache(cfg, b, steps, dtype=torch.float32, device="cpu")
    assert set(cache) == set(jcache) == {"k", "v"}
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
            out.append(jnp.argmax(lg[:, -1], axis=-1).astype(
                jnp.int32)[:, None])
    np.testing.assert_array_equal(toks, np.concatenate(
        [np.asarray(t) for t in out], axis=1))


def test_count_params_against_the_module():
    from repro.configs import get_config as j_config
    from repro.launch import flops as jflops

    jcfg, jparams, cfg, model = _models()
    for c, jc in ((get_config(ARCH), j_config(ARCH)), (cfg, jcfg)):
        assert flops.count_params(c) == jflops.count_params(jc)
    n_module = sum(p.numel() for p in model.parameters())
    assert n_module == sum(x.size for x in jax.tree.leaves(jparams))
    left_out = ((cfg.vocab_padded - cfg.vocab) * cfg.d_model
                + (2 * cfg.n_layers + 1) * cfg.d_model)
    assert flops.count_params(cfg)[0] == n_module - left_out


def test_convert_carries_parameters():
    jcfg, jparams, cfg, model = _models()
    layers_tree = jparams["layers"]
    for i, lp in enumerate(model.layers):
        for name, t in lp.named_parameters():
            tree = layers_tree
            for part in name.split("."):
                tree = tree[part]
            tree = tree["scale"] if isinstance(tree, dict) else tree
            np.testing.assert_array_equal(t.detach().numpy(),
                                          np.asarray(tree)[i])
    assert model.cfg.mrope and model.cfg.family == "vlm"
