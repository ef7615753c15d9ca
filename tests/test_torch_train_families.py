"""Training of the MoE, SSM, hybrid, audio and VLM families in the port
against the reference on the CPU.

Each test feeds the same seeded numpy inputs to ``repro`` and to
``repro_torch``, parameters carried by the converters of
``repro_torch.models.convert``: the loss and every gradient leaf against
``jax.value_and_grad(repro.models.api.loss_fn)`` on the six ``SMOKE``
configs (64 tokens, a multiple of the smoke ``ssm_chunk``; seeded
``frame_embeds``/``patch_embeds``; masked labels), in fp32 and bf16
compute; remat at the reference's scopes (per layer in Mamba2, per group
in the hybrid, per decoder layer in whisper) recomputing bit for bit and
running K5 as often as the reference's remat runs its attention; the
port's step against ``value_and_grad`` plus ``apply_updates`` composed
by hand (the reference's ``make_train_step`` raises on this tree's jax,
ROADMAP §3); ``train_loop`` with its stub frontends, checkpoints and
resume on every family; checkpoints across the two packages.

The Mamba2 leaves ``conv_b``, ``conv_c`` and ``dt_bias`` are drawn from
a seeded generator before both packages get them: the reference draws
the first two as zeros, which zeroes the whole state path and its
gradients (``tests/test_torch_mamba2.py``).

MoE routing is held equal first. A near-tie between a token's k-th and
(k+1)-th router probability can flip one expert choice between the
packages, which moves that token by O(1), not by rounding. So the
reference's choices are recorded in its jitted run (a
``jax.debug.callback`` in ``router_topk``), the port's router is pinned
to them, the aux loss counted over the pinned choices, and each flipped
token's gap in the reference's probabilities must be a near-tie: below
1e-6 in fp32 (4.5e-8 measured) and 5e-3 in bf16 (1.4e-3 measured; bf16
rounding of the router's input moves a probability by about 2⁻⁸ of
itself).

Tolerances, each with its reason:

- fp32: the loss within 1e-5 relative and each gradient leaf within
  1e-4·max|g| (fp32 sums in other orders: the twin's 64-key blocks and
  the backward's chunks against the reference's scan, einsum paths,
  matmul blocking; 2.8e-5 the worst measured, zamba2);
- bf16, the attention families (MoE, whisper, qwen2-vl): the loss within
  1e-3 relative and each leaf within 3e-2·max|g|, as
  ``tests/test_torch_train.py`` holds the dense family (2.6e-2 the worst
  measured, moonshot's shared expert with the routing pinned);
- bf16, mamba2 and zamba2: the loss within 1e-3 relative, and each leaf
  at most 2.5 times as far from the fp32 gradient, in L2, as the
  reference's own bf16 gradient is, plus 1e-2 of the leaf's norm, and
  never as far as half its norm, with a cosine to the fp32 gradient of
  at least 0.95. Both packages' bf16 SSD gradients lie 2-43% of the
  leaf's norm (5-55% of max|g|) from their fp32 ones, the bf16
  products' rounding carried through the chunked scan; the port rounds
  less (an fp32 residual stream and conv, ROADMAP §3) and rounds
  elsewhere, so no absolute bound below that noise holds. The relative
  bound alone would exceed a leaf's norm where the reference's noise is
  largest, and so pass a zeroed or sign-flipped leaf; the cap and the
  cosine fail both (a zero leaf lies its whole norm away, a flipped one
  twice that, at cosine 0 and -1). Measured: at most 1.91 times
  (mamba2's ``dt_bias``) after the 1e-2 term, at most 0.234 of the norm
  and a cosine of at least 0.983 (zamba2's tail ``a_log``; the
  reference's own bf16 gradient there: 0.427 and 0.954);
- the optimizer step's parameters within rtol 2e-3 and atol 2e-5, as
  ``tests/test_train.py`` holds its microbatch equivalence.
"""
import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as train_launch
from repro_torch.launch.train import train_loop
from repro_torch.models import api, convert, mamba2, moe
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

FAMILIES = ("moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b", "mamba2-130m",
            "zamba2-7b", "whisper-tiny", "qwen2-vl-7b")
CONVERT = {"moe": convert.moe_params_from_jax,
           "ssm": convert.mamba2_params_from_jax,
           "hybrid": convert.hybrid_params_from_jax,
           "audio": convert.whisper_params_from_jax,
           "vlm": convert.transformer_params_from_jax}
SEQ = 64
GAP = {"float32": 1e-6, "bfloat16": 5e-3}


@pytest.fixture(autouse=True)
def _no_leaked_activation_context():
    """The reference's model outside any sharding activation context
    (``src/repro/train/train_step.py:33`` can leave one entered)."""
    from repro.dist import sharding

    sharding._ctx.state = None


def _perturb(tree, family, seed=7):
    """Numpy leaves; the Mamba2 layers' ``conv_b``, ``conv_c`` and
    ``dt_bias`` drawn from a seeded generator."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, tree)
    for key in {"ssm": ("layers",), "hybrid": ("groups", "tail")}.get(
            family, ()):
        if key in tree:
            for name in ("conv_b", "conv_c", "dt_bias"):
                tree[key][name] = (rng.standard_normal(
                    tree[key][name].shape) * 0.5).astype(np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _jparams(arch, compute_dtype):
    jcfg = j_smoke(arch).scaled(compute_dtype=compute_dtype)
    return jcfg, _perturb(japi.init_params(jax.random.PRNGKey(0), jcfg),
                          jcfg.family)


def _model(arch, compute_dtype, **kw):
    _, jparams = _jparams(arch, compute_dtype)
    cfg = get_smoke_config(arch).scaled(compute_dtype=compute_dtype, **kw)
    return cfg, CONVERT[cfg.family](jparams, cfg, device="cpu")


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, s))
    labels[:, -3:] = -1       # masked positions, as the data pipeline's
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": labels.astype(np.int32)}
    if cfg.family == "audio":
        batch["frame_embeds"] = rng.standard_normal(
            (b, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


@contextlib.contextmanager
def _recorded_routing():
    """Record every ``repro.models.moe.router_topk`` choice of a jitted
    run, with its logits: a list of (topi, logits) numpy pairs."""
    routes = []
    real = jmoe.router_topk

    def route(logits, k):
        out = real(logits, k)
        jax.debug.callback(lambda i, lg: routes.append(
            (np.asarray(i), np.asarray(lg, np.float32))), out[1], logits)
        return out

    with mock.patch.object(jmoe, "router_topk", route):
        yield routes
    jax.effects_barrier()


@contextlib.contextmanager
def _pinned_routing(routes, compute_dtype):
    """The port's ``router_topk`` choosing as the reference chose for the
    nearest recorded logits, its weights renormalised over its own
    probabilities and its aux loss counted over the pinned choice. A
    token routed apart must be a near-tie in the reference's
    probabilities (:data:`GAP`)."""
    real = moe.router_topk

    def route(logits, k):
        _, topi, _ = real(logits, k)
        lg = logits.detach().float().numpy()
        want, ref_logits = min(
            (r for r in routes if r[1].size == lg.size),
            key=lambda r: np.abs(r[1].reshape(lg.shape) - lg).max())
        want = torch.from_numpy(np.array(want.reshape(topi.shape))).long()
        apart = (topi.sort(-1).values != want.sort(-1).values).any(-1)
        if bool(apart.any()):
            top = torch.from_numpy(ref_logits.reshape(lg.shape)).softmax(
                -1).topk(k + 1, dim=-1).values
            gap = (top[..., k - 1] - top[..., k])[apart].max().item()
            assert gap < GAP[compute_dtype], (int(apart.sum()), gap)
        e = logits.shape[-1]
        probs = torch.softmax(logits.float(), dim=-1)
        picked = probs.gather(-1, want)
        f_e = torch.bincount(want.reshape(-1), minlength=e).float()
        aux = e * torch.sum(f_e / f_e.sum() * probs.reshape(-1, e).mean(0))
        return (picked / torch.clamp(picked.sum(-1, keepdim=True), min=1e-9),
                want, aux)

    with mock.patch.object(moe, "router_topk", route):
        yield


@functools.lru_cache(maxsize=None)
def _reference(arch, compute_dtype):
    """The reference's loss and gradient tree (numpy leaves) on
    ``_batch(cfg, 2, SEQ, 3)``, and its recorded routing."""
    jcfg, jparams = _jparams(arch, compute_dtype)
    batch = _batch(jcfg, 2, SEQ, 3)
    with _recorded_routing() as routes:
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: japi.loss_fn(p, b, jcfg)))(
                jax.tree.map(jnp.asarray, jparams),
                {k: jnp.asarray(v) for k, v in batch.items()})
        grads = jax.tree.map(lambda g: np.asarray(g, np.float32), grads)
    return float(loss), grads, routes


def _port_grads(model, batch, cfg, routes=()):
    params = dict(model.named_parameters())
    pin = (_pinned_routing(routes, cfg.compute_dtype)
           if cfg.family == "moe" else contextlib.nullcontext())
    with pin:
        loss = api.loss_fn(model, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, cfg)
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), dict(zip(params, grads))


def _stacked(tensors, names):
    """The port's leaf in the reference's layout, float32 numpy."""
    leaf = np.stack([tensors[n].detach().float().numpy()
                     for n in names.flat])
    return leaf.reshape(names.shape + leaf.shape[1:])


def _grad_leaves(arch, compute_dtype):
    """(path, port leaf, reference leaf) of every gradient, and both
    losses."""
    jloss, jgrads, routes = _reference(arch, compute_dtype)
    cfg, model = _model(arch, compute_dtype)
    loss, grads = _port_grads(model, _batch(cfg, 2, SEQ, 3), cfg, routes)
    leaves = [(path, _stacked(grads, names), convert.ref_leaf(jgrads, path))
              for path, names in convert.param_layout(model).items()]
    assert len(leaves) == len(jax.tree.leaves(jgrads))
    return loss, jloss, leaves


# --------------------------------------------------- loss and gradients --
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch, compute_dtype):
    loss, jloss, leaves = _grad_leaves(arch, compute_dtype)
    fp32 = compute_dtype == "float32"
    np.testing.assert_allclose(loss, jloss, rtol=1e-5 if fp32 else 1e-3)
    family = get_smoke_config(arch).family
    if fp32 or family not in ("ssm", "hybrid"):
        rel = 1e-4 if fp32 else 3e-2
        for path, got, want in leaves:
            assert got.shape == want.shape, path
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=rel * np.abs(want).max(),
                                       err_msg=str(path))
        return
    exact = _reference(arch, "float32")[1]
    for path, got, want in leaves:
        g32 = convert.ref_leaf(exact, path)
        norm = np.linalg.norm(g32)
        ref_noise = np.linalg.norm(want - g32)
        err = np.linalg.norm(got - g32)
        assert err <= min(2.5 * ref_noise + 1e-2 * norm, 0.5 * norm), (
            path, err / norm, ref_noise / norm)
        cosine = np.vdot(got, g32) / (np.linalg.norm(got) * norm)
        assert cosine >= 0.95, (path, cosine)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_changes_no_gradient_bit(arch):
    """Checkpointing at the reference's scopes recomputes the same values
    on the CPU: the loss and every gradient bit for bit."""
    _, _, routes = _reference(arch, "bfloat16")
    batch = _batch(get_smoke_config(arch), 2, SEQ, 3)
    out = []
    for remat in (True, False):
        cfg, model = _model(arch, "bfloat16", remat=remat)
        out.append(_port_grads(model, batch, cfg, routes))
    (l1, g1), (l2, g2) = out
    assert l1 == l2
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name


def _k5_and_ssm_layers(cfg) -> tuple[int, int]:
    """Attention launches (K5 on the card, its twin here) and Mamba2
    layer applications of one loss and backward under remat, as the
    reference's remat scopes give them: every checkpointed scope runs
    twice, the hybrid's tail and whisper's encoder once."""
    if cfg.family == "ssm":
        return 0, 2 * cfg.n_layers
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.hybrid_attn_every
        tail = cfg.n_layers - groups * cfg.hybrid_attn_every
        return 2 * groups, 2 * groups * cfg.hybrid_attn_every + tail
    if cfg.family == "audio":
        return cfg.n_enc_layers + 2 * 2 * cfg.n_layers, 0
    return 2 * cfg.n_layers, 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_recomputes_the_reference_scopes(arch):
    _, _, routes = _reference(arch, "bfloat16")
    cfg, model = _model(arch, "bfloat16")
    calls = {"k5": 0, "ssm": 0}

    def counted(key, fn):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run

    with mock.patch.object(fa, "_forward", counted("k5", fa._forward)), \
            mock.patch.object(mamba2, "apply_layer",
                              counted("ssm", mamba2.apply_layer)):
        _port_grads(model, _batch(cfg, 2, SEQ, 3), cfg, routes)
    assert (calls["k5"], calls["ssm"]) == _k5_and_ssm_layers(cfg)


# ---------------------------------------------------------------- step --
def _reference_step(jcfg, ocfg, params, batch, microbatches):
    """``repro.train.train_step``'s step without its mesh: value_and_grad
    of ``api.loss_fn`` per microbatch (the scan of ``train_step.py:41-57``
    written out, each microbatch with its own aux loss), then
    ``apply_updates``. Returns the new params, the loss, the metrics and
    the recorded routing."""
    vg = jax.jit(jax.value_and_grad(lambda p, b: japi.loss_fn(p, b, jcfg)))
    per = batch["tokens"].shape[0] // microbatches
    loss = 0.0
    grads = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    with _recorded_routing() as routes:
        for i in range(microbatches):
            mb = {k: jnp.asarray(v[i * per:(i + 1) * per])
                  for k, v in batch.items()}
            lo, g = vg(params, mb)
            grads = jax.tree.map(lambda a, b: a + b.astype(jnp.float32),
                                 grads, g)
            loss = loss + lo
    grads = jax.tree.map(lambda g: g / microbatches, grads)
    p2, _, m = jopt.apply_updates(params, grads,
                                  jopt.init_opt_state(params, ocfg), ocfg)
    return p2, float(loss / microbatches), m, routes


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mamba2-130m"])
def test_step_matches_hand_composed_reference(arch):
    jcfg, jparams = _jparams(arch, "float32")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _batch(jcfg, 4, SEQ, 5)
    jp2, jloss, jm, routes = _reference_step(
        jcfg, jopt.OptConfig(**kw), jax.tree.map(jnp.asarray, jparams),
        batch, 2)
    cfg, model = _model(arch, "float32")
    state = opt.init_opt_state(dict(model.named_parameters()),
                               opt.OptConfig(**kw))
    step = make_train_step(cfg, opt.OptConfig(**kw), microbatches=2)
    pin = (_pinned_routing(routes, "float32") if cfg.family == "moe"
           else contextlib.nullcontext())
    with pin:
        m = step(model, state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    params = dict(model.named_parameters())
    for path, names in convert.param_layout(model).items():
        np.testing.assert_allclose(
            _stacked(params, names),
            np.asarray(convert.ref_leaf(jp2, path), np.float32), rtol=2e-3,
            atol=2e-5, err_msg=str(path))


# ---------------------------------------------------------- checkpoints --
def _opt_pair(arch):
    """The reference's params and an AdamW state after one update, and
    the port's model and a state of the same shapes."""
    jcfg, jparams = _jparams(arch, "float32")
    ocfg = jopt.OptConfig()
    jp = jax.tree.map(jnp.asarray, jparams)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jp)
    jp, jst, _ = jopt.apply_updates(jp, grads, jopt.init_opt_state(jp, ocfg),
                                    ocfg)
    cfg, model = _model(arch, "float32")
    state = opt.init_opt_state(dict(model.named_parameters()),
                               opt.OptConfig())
    return jp, jst, model, state


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_tree_has_the_reference_layout(arch):
    """Leaf for leaf, in the order both packages flatten, the shapes and
    dtypes of the reference's ``{"params", "opt"}`` tree."""
    jp, jst, model, state = _opt_pair(arch)
    leaves, _ = ckpt.flatten(ckpt.train_tree(model, state))
    want = jax.tree.leaves({"params": jp, "opt": jst})
    assert [(a.shape, a.dtype) for a in leaves] == [
        (np.asarray(w).shape, np.asarray(w).dtype) for w in want]


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-tiny"])
def test_reference_checkpoint_restores_into_port(arch, tmp_path):
    d = str(tmp_path / "ck")
    jp, jst, model, state = _opt_pair(arch)
    jckpt.save(d, 7, {"params": jp, "opt": jst})
    tree, step = ckpt.restore_latest(
        d, ckpt.train_tree(model, state, leaf=lambda ts: None))
    assert step == 7
    ckpt.load_train_tree(model, state, tree)
    params = dict(model.named_parameters())
    for path, names in convert.param_layout(model).items():
        for tensors, ref in ((params, jp), (state["mu"], jst["mu"]),
                             (state["nu"], jst["nu"])):
            np.testing.assert_array_equal(
                _stacked(tensors, names),
                np.asarray(convert.ref_leaf(ref, path)), err_msg=str(path))
    assert int(state["step"]) == int(jst["step"]) == 1


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-tiny"])
def test_port_checkpoint_restores_into_reference(arch, tmp_path):
    d = str(tmp_path / "ck")
    jp, jst, model, state = _opt_pair(arch)
    ckpt.load_train_tree(model, state, {
        "params": jax.tree.map(np.asarray, jp),
        "opt": jax.tree.map(np.asarray, jst)})
    ckpt.save(d, 5, ckpt.train_tree(model, state))
    like = {"params": jax.tree.map(jnp.zeros_like, jp),
            "opt": jax.tree.map(jnp.zeros_like, jst)}
    restored, step = jckpt.restore_latest(d, like)
    assert step == 5
    for want, got in zip(jax.tree.leaves({"params": jp, "opt": jst}),
                         jax.tree.leaves(restored)):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------- loop --
@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-7b"])
def test_train_loop_feeds_the_stub_frontends(arch):
    """Zero fp32 ``frame_embeds`` (audio) or ``patch_embeds`` (VLM) in
    every step's batch, shaped as the reference's loop makes them."""
    cfg = get_smoke_config(arch)
    seen = []
    real = train_launch.ts.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def run(model, state, batch):
            seen.append({k: v.clone() for k, v in batch.items()})
            return step(model, state, batch)
        return run

    with mock.patch.object(train_launch.ts, "make_train_step", make):
        _, losses = train_loop(cfg, steps=2, global_batch=2, seq_len=SEQ,
                               log_every=100, device="cpu")
    key, n = (("frame_embeds", cfg.n_audio_ctx) if cfg.family == "audio"
              else ("patch_embeds", cfg.n_patches))
    assert len(seen) == 2 and np.isfinite(losses).all()
    for batch in seen:
        stub = batch[key]
        assert stub.shape == (2, n, cfg.d_model)
        assert stub.dtype == torch.float32 and not bool(stub.any())


@pytest.mark.parametrize("arch", FAMILIES)
def test_resume_equals_uninterrupted_run(arch, tmp_path):
    cfg = get_smoke_config(arch)
    d = str(tmp_path / "ck")
    kw = dict(global_batch=2, seq_len=SEQ, log_every=100, device="cpu")
    _, first = train_loop(cfg, steps=2, ckpt_dir=d, save_every=1, **kw)
    assert ckpt.available_steps(d) == [1, 2]
    # The resumed run is told 3 steps, as the uninterrupted one: the same
    # OptConfig (warm-up and cosine) in both.
    resumed, rest = train_loop(cfg, steps=3, ckpt_dir=d, resume=True, **kw)
    whole, losses = train_loop(cfg, steps=3, **kw)
    assert first + rest == losses and len(rest) == 1
    assert np.isfinite(losses).all()
    for a, b in zip(resumed.parameters(), whole.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("depth", [8, 16])
def test_zero_patch_embeddings_overflow_as_in_the_reference(depth):
    """With the loop's zero patch embeddings the residual stream at those
    positions stays zero through every layer, each norm passes their
    gradient back at rsqrt(eps) = 1000 times, and the parameter
    gradients turn 0·inf into NaN once it overflows: a fault shared with
    the reference (ROADMAP §3), NaN in both packages at 16 smoke layers
    today. The test holds the port to the reference's behaviour, not to
    the fault: the port's gradient norm is finite where the reference's
    is, and not where it is not; at 8 layers, short of the overflow, both
    are finite."""
    jcfg = j_smoke("qwen2-vl-7b").scaled(n_layers=depth)
    cfg = get_smoke_config("qwen2-vl-7b").scaled(n_layers=depth)
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch(cfg, 2, SEQ, 4)
    batch["patch_embeds"] = np.zeros_like(batch["patch_embeds"])
    _, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(p, b, jcfg)))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                              for g in jax.tree.leaves(jgrads))))
    model = convert.transformer_params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    _, grads = _port_grads(model, batch, cfg)
    got = float(torch.sqrt(sum(g.square().sum() for g in grads.values())))
    assert np.isfinite(got) == np.isfinite(want)
    if depth == 8:
        assert np.isfinite(got)
