"""The port's hybrid (``repro_torch.models.hybrid``) against
``repro.models.hybrid`` on the CPU.

The zamba2 ``SMOKE`` config (5 Mamba2 layers: two groups of two, each
followed by the shared attention block, and a tail of one; window 64)
runs with ``compute_dtype="float32"``. The reference's parameters are
carried into the port by ``hybrid_params_from_jax``, with the Mamba2
layers' ``conv_b``, ``conv_c`` and ``dt_bias`` drawn from a seeded
numpy generator (the reference draws the first two as zeros, which
would zero the state path). Tolerance: 1e-4·max|ref|. 96 tokens run
past the 64-token window, so both the forward's sliding window and the
decode's ring buffer wrap.
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
from repro_torch.launch import flops
from repro_torch.launch.serve import generate
from repro_torch.models import api, hybrid
from repro_torch.models.convert import hybrid_params_from_jax

ARCH = "zamba2-7b"
REL = 1e-4


@pytest.fixture(autouse=True)
def _no_leaked_activation_context():
    """Run the reference outside any sharding activation context (see
    ``tests/test_torch_transformer.py``)."""
    from repro.dist import sharding

    sharding._ctx.state = None


def _perturb(jparams, seed=7):
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jparams)
    for stack in (tree["groups"], tree["tail"]):
        for name in ("conv_b", "conv_c", "dt_bias"):
            stack[name] = (rng.standard_normal(stack[name].shape)
                           * 0.5).astype(np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = j_smoke(ARCH).scaled(compute_dtype="float32")
    cfg = get_smoke_config(ARCH).scaled(compute_dtype="float32")
    jparams = _perturb(japi.init_params(jax.random.PRNGKey(0), jcfg))
    model = hybrid_params_from_jax(jparams, cfg, device="cpu")
    return jcfg, jparams, cfg, model


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _close(out, want):
    out, want = out.detach().numpy(), np.asarray(want)
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=REL * np.abs(want).max())


def test_group_counts_match_reference():
    from repro.configs import get_config as j_config
    from repro.models import hybrid as jh
    from repro_torch.configs import get_config

    for c, jc in ((get_config(ARCH), j_config(ARCH)),
                  (get_smoke_config(ARCH), j_smoke(ARCH))):
        assert hybrid._group_counts(c) == jh._group_counts(jc)
    assert hybrid._group_counts(get_config(ARCH)) == (13, 3)


@pytest.mark.parametrize("s", [32, 96])
def test_forward_and_loss_match_reference(s):
    jcfg, jparams, cfg, model = _models()
    tokens = _tokens(cfg, 2, s, seed=1)
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
    b, steps = 2, 96                  # the 64-slot ring wraps
    tokens = _tokens(cfg, b, steps, seed=2)
    jcache = japi.init_cache(jcfg, b, steps, dtype=jnp.float32)
    cache = api.init_cache(cfg, b, steps, dtype=torch.float32, device="cpu")
    assert set(cache) == set(jcache)
    assert cache["attn_k"].shape[2] == cfg.sliding_window
    for key in cache:
        assert tuple(cache[key].shape) == jcache[key].shape
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
    """``count_params`` equals the reference's, and the module's count
    less the padded vocabulary rows and the norms (the Mamba2 layers'
    input norms, the shared block's two, the final one), which the
    formula leaves out; the shared block is one parameter set."""
    from repro.configs import get_config as j_config
    from repro.launch import flops as jflops
    from repro_torch.configs import get_config

    jcfg, jparams, cfg, model = _models()
    for c, jc in ((get_config(ARCH), j_config(ARCH)), (cfg, jcfg)):
        assert flops.count_params(c) == jflops.count_params(jc)
    n_module = sum(p.numel() for p in model.parameters())
    assert n_module == sum(x.size for x in jax.tree.leaves(jparams))
    left_out = ((cfg.vocab_padded - cfg.vocab) * cfg.d_model
                + (cfg.n_layers + 3) * cfg.d_model)
    assert flops.count_params(cfg)[0] == n_module - left_out


def test_convert_carries_parameters():
    jcfg, jparams, cfg, model = _models()

    def leaf(tree, name, idx):
        for part in name.split("."):
            tree = tree[part]
        tree = tree["scale"] if isinstance(tree, dict) else tree
        return np.asarray(tree)[idx]

    np.testing.assert_array_equal(model.embedding.detach().numpy(),
                                  jparams["embed"]["embedding"])
    pairs = [(lp, jparams["groups"], (g, j))
             for g, group in enumerate(model.groups)
             for j, lp in enumerate(group)]
    pairs += [(lp, jparams["tail"], i) for i, lp in enumerate(model.tail)]
    pairs.append((model.shared_attn, jparams["shared_attn"], ()))
    for module, tree, idx in pairs:
        for name, t in module.named_parameters():
            np.testing.assert_array_equal(t.detach().numpy(),
                                          leaf(tree, name, idx))
    assert len(model.groups) == 2 and len(model.tail) == 1
