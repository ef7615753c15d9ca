"""Dense training in the port against the reference on the CPU.

Each test feeds the same seeded numpy inputs to ``repro`` and to
``repro_torch``: the loss and its gradients through
``convert.transformer_params_from_jax`` against
``jax.value_and_grad(repro.models.api.loss_fn)``; ``apply_updates`` and
``lr_at`` against ``repro.train.optimizer``; the data pipeline array for
array; checkpoints written by one package and restored by the other; the
port's step against the reference's step composed by hand (its
``make_train_step`` fails on this tree's jax, ROADMAP §3); the flops
accounting; the input specs; and ``train_loop`` with its resume.

Tolerances, each with its reason: with ``compute_dtype="float32"`` the
loss within 1e-5 relative and each gradient within 1e-4·max|g| (fp32
sums in other orders: the twin's 64-key blocks and the backward's
chunks against the scan, matmul blocking); at the default bf16 the loss
within 1e-3 relative and each gradient within 3e-2·max|g|. The two
packages round to bf16 at different points: on these inputs the
reference's bf16 gradients lie up to 3.6e-2·max|g| from its own fp32
ones and the port's up to 3.0e-2, and plain autograd through the twin
lies up to 2.3e-2 from the reference's, so the 2e-2 that fp32-like
agreement would allow is below the noise of bf16 itself;
the optimizer within 1e-6 relative (elementwise fp32 arithmetic in the
same order; only the global norm's sum order differs); the step's
parameters within rtol 2e-3 and atol 2e-5, as ``tests/test_train.py``
holds its microbatch equivalence.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.launch import flops as jflops
from repro.models import api as japi
from repro.models import config as jconfig
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch import flops
from repro_torch.launch.train import train_loop
from repro_torch.models import api
from repro_torch.models import config as tconfig
from repro_torch.models.convert import (
    param_layout,
    transformer_params_from_jax,
)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

DENSE = ("gemma2-9b", "minitron-8b", "glm4-9b", "granite-34b")


@pytest.fixture(autouse=True)
def _no_leaked_activation_context():
    """The reference's model outside any sharding activation context
    (``src/repro/train/train_step.py:33`` can leave one entered)."""
    from repro.dist import sharding

    sharding._ctx.state = None


@functools.lru_cache(maxsize=None)
def _jparams(arch, compute_dtype):
    jcfg = j_smoke(arch).scaled(compute_dtype=compute_dtype)
    return jcfg, japi.init_params(jax.random.PRNGKey(0), jcfg)


def _model(arch, compute_dtype, **kw):
    jcfg, jparams = _jparams(arch, compute_dtype)
    cfg = get_smoke_config(arch).scaled(compute_dtype=compute_dtype, **kw)
    model = transformer_params_from_jax(jax.tree.map(np.asarray, jparams),
                                        cfg, device="cpu")
    return cfg, model


def _batch(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (b, s))
    labels[:, -3:] = -1       # masked positions, as the data pipeline's
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": labels.astype(np.int32)}


def _port_leaf(tensors, names):
    """The port's leaf stacked as ``param_layout`` names it."""
    leaf = np.stack([tensors[n].detach().float().numpy()
                     for n in names.flat])
    return leaf.reshape(names.shape + leaf.shape[1:])


def _ref_leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(jnp.asarray(tree, jnp.float32))


def _port_grads(model, batch, cfg):
    params = dict(model.named_parameters())
    loss = api.loss_fn(model, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), dict(zip(params, grads))


# --------------------------------------------------- loss and gradients --
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_jax(arch, compute_dtype):
    # 80 tokens: gemma2's smoke window (32) and attn_chunk (64) both cut.
    batch = _batch(512, 2, 80, 7)
    jcfg, jparams = _jparams(arch, compute_dtype)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(p, b, jcfg)))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg, model = _model(arch, compute_dtype)
    loss, grads = _port_grads(model, batch, cfg)
    rel = 1e-4 if compute_dtype == "float32" else 3e-2
    np.testing.assert_allclose(loss, float(jloss),
                               rtol=1e-5 if rel == 1e-4 else 1e-3)
    layout = param_layout(model)
    assert len(layout) == len(jax.tree.leaves(jgrads))
    for path, names in layout.items():
        want = _ref_leaf(jgrads, path)
        got = _port_leaf(grads, names)
        assert got.shape == want.shape, path
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=rel * np.abs(want).max(),
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", ["gemma2-9b", "granite-34b"])
def test_remat_changes_no_gradient_bit(arch):
    """Per-layer checkpointing recomputes the same values on the CPU."""
    batch = _batch(512, 2, 80, 8)
    out = []
    for remat in (True, False):
        cfg, model = _model(arch, "bfloat16", remat=remat)
        out.append(_port_grads(model, batch, cfg))
    (l1, g1), (l2, g2) = out
    assert l1 == l2
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name


def test_training_loss_equals_scoring_loss():
    """The loss under grad (out-of-place softcap, the Function, remat)
    equals the loss under no_grad (in-place softcap, K5 alone)."""
    cfg, model = _model("gemma2-9b", "bfloat16")
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(512, 2, 80, 9).items()}
    with torch.no_grad():
        want = api.loss_fn(model, batch, cfg)
    got = api.loss_fn(model, batch, cfg)
    assert got.requires_grad and torch.equal(got.detach(), want)


# ----------------------------------------------------------- optimizer --
def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "e": rng.standard_normal((3, 4, 2)).astype(np.float32)}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(moment_dtype):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=1.0,
               moment_dtype=moment_dtype)
    jcfg, tcfg = jopt.OptConfig(**cfg), opt.OptConfig(**cfg)
    p0 = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jst, tst = jopt.init_opt_state(jp, jcfg), opt.init_opt_state(tp, tcfg)
    assert tst["mu"]["w"].dtype == getattr(torch, moment_dtype)
    clipped = 0
    for step in range(5):
        # Gradients of norm 0.4 to 4: the clip acts on some steps only.
        g = _tree(10 + step)
        g = {k: v * (0.1 + step) for k, v in g.items()}
        jp, jst, jm = jopt.apply_updates(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jst, jcfg)
        tm = opt.apply_updates(tp, {k: torch.from_numpy(v)
                                    for k, v in g.items()}, tst, tcfg)
        clipped += float(jm["grad_norm"]) > 1.0
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["lr"]) == float(jm["lr"])
        for k in p0:
            for got, want in ((tp[k], jp[k]), (tst["mu"][k], jst["mu"][k]),
                              (tst["nu"][k], jst["nu"][k])):
                np.testing.assert_allclose(
                    got.float().numpy(), np.asarray(want, np.float32),
                    rtol=1e-6, atol=0)
        assert int(tst["step"]) == int(jst["step"]) == step + 1
    assert 0 < clipped < 5


def test_lr_at_matches_reference():
    """Bit for bit over the warm-up; over the cosine within lr·2⁻²²: the
    two libraries' float32 ``cos`` differ by one ulp (at most 2⁻²³) on
    some inputs, which moves the rate by at most lr·0.45·2⁻²³ plus its
    own rounding (near the end, where ``1 + cos`` is small, that is a
    few ulps of the rate)."""
    for cfg in (dict(lr=1e-3, warmup_steps=10, total_steps=100),
                dict(lr=3e-4, warmup_steps=2, total_steps=6)):
        jcfg, tcfg = jopt.OptConfig(**cfg), opt.OptConfig(**cfg)
        for s in range(cfg["total_steps"] + 3):
            got = opt.lr_at(torch.tensor(s, dtype=torch.int32), tcfg)
            want = np.asarray(jopt.lr_at(jnp.int32(s), jcfg))
            assert got.dtype == torch.float32 and want.dtype == np.float32
            if s < cfg["warmup_steps"]:
                assert got.item() == float(want), (cfg, s)
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=cfg["lr"] * 2.0 ** -22)


def test_adamw_converges_quadratic():
    cfg = opt.OptConfig(lr=0.1, warmup_steps=5, total_steps=200,
                        weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0]),
              "b": torch.tensor([[1.0, 2.0], [3.0, 4.0]])}
    state = opt.init_opt_state(params, cfg)
    for _ in range(150):
        grads = {k: 2 * v for k, v in params.items()}
        opt.apply_updates(params, grads, state, cfg)
    assert sum(float((v ** 2).sum()) for v in params.values()) < 1e-2


def test_lr_schedule_shape():
    cfg = opt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(opt.lr_at(torch.tensor(s), cfg)) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9
    assert lrs[99] < lrs[50] < lrs[10]
    assert lrs[99] >= cfg.lr * cfg.min_lr_ratio - 1e-9


def test_bf16_moments_halve_memory():
    cfg = opt.OptConfig(moment_dtype="bfloat16")
    st = opt.init_opt_state({"w": torch.zeros((64, 64))}, cfg)
    assert st["mu"]["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------- data --
def test_data_equals_reference():
    for kw in (dict(vocab=97, seq_len=16, global_batch=8, n_hosts=4),
               dict(vocab=256000, seq_len=64, global_batch=4, seed=3)):
        jc, tc = jdata.DataConfig(**kw), data.DataConfig(**kw)
        for step in (0, 3, 1000):
            for host in range(kw.get("n_hosts", 1)):
                want, got = jdata.host_batch(jc, step, host), \
                    data.host_batch(tc, step, host)
                for k in want:
                    assert got[k].dtype == want[k].dtype
                    np.testing.assert_array_equal(got[k], want[k])
            want, got = jdata.global_batch(jc, step), \
                data.global_batch(tc, step)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        assert data.skip_to(tc, 10, 3) == jdata.skip_to(jc, 10, 3) == 13
        assert data.skip_to(tc, 10, -2) == jdata.skip_to(jc, 10, -2) == 10


def test_data_deterministic_and_host_sharded():
    cfg = data.DataConfig(vocab=97, seq_len=16, global_batch=8, n_hosts=4)
    b1 = data.global_batch(cfg, 3)
    b2 = data.global_batch(cfg, 3)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    h0 = data.host_batch(cfg, 3, 0)
    np.testing.assert_array_equal(b1["tokens"][:2], h0["tokens"])
    assert not np.array_equal(b1["tokens"],
                              data.global_batch(cfg, 4)["tokens"])
    assert b1["tokens"].max() < 97
    assert (b1["labels"][:, :-1] == b1["tokens"][:, 1:]).all()
    assert (b1["labels"][:, -1] == -1).all()


# --------------------------------------------------------- checkpoints --
def test_checkpoint_roundtrip_and_corruption(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3).float(),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}
    d = str(tmp_path / "ck")
    ckpt.save(d, 10, tree)
    ckpt.save(d, 20, tree)
    restored, step = ckpt.restore_latest(d, tree)
    assert step == 20
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    leaf = os.path.join(d, "step_00000020", "leaf_00000.npy")
    with open(leaf, "wb") as f:
        f.write(b"garbage")
    restored, step = ckpt.restore_latest(d, tree)
    assert step == 10


def test_checkpoint_tmp_cleanup(tmp_path):
    d = str(tmp_path / "ck")
    os.makedirs(os.path.join(d, "step_00000005.tmp-dead"))
    assert ckpt.clean_tmp(d) == 1
    assert ckpt.available_steps(d) == []


def test_keep_last(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4):
        ckpt.save(d, s, {"a": torch.zeros(2)})
    ckpt.keep_last(d, 2)
    assert ckpt.available_steps(d) == [3, 4]


def _trained_pair(moment_dtype):
    """The reference's minitron smoke params and an AdamW state after one
    update, and the port's model and state holding the same values."""
    jcfg, jparams = _jparams("minitron-8b", "float32")
    ocfg = jopt.OptConfig(moment_dtype=moment_dtype)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jparams)
    jp, jst, _ = jopt.apply_updates(jparams, grads,
                                    jopt.init_opt_state(jparams, ocfg), ocfg)
    return jcfg, jp, jst


def test_reference_checkpoint_restores_into_port(tmp_path):
    d = str(tmp_path / "ck")
    jcfg, jp, jst = _trained_pair("bfloat16")
    jckpt.save(d, 7, {"params": jp, "opt": jst})
    cfg, model = _model("minitron-8b", "float32")
    state = opt.init_opt_state(dict(model.named_parameters()),
                               opt.OptConfig(moment_dtype="bfloat16"))
    like = ckpt.train_tree(model, state, leaf=lambda ts: None)
    tree, step = ckpt.restore_latest(d, like)
    assert step == 7
    ckpt.load_train_tree(model, state, tree)
    params = dict(model.named_parameters())
    for path, names in param_layout(model).items():
        for tensors, ref in ((params, jp), (state["mu"], jst["mu"]),
                             (state["nu"], jst["nu"])):
            np.testing.assert_array_equal(
                _port_leaf(tensors, names),
                _ref_leaf(ref, path), err_msg=str(path))
    assert state["mu"]["embedding"].dtype == torch.bfloat16
    assert int(state["step"]) == int(jst["step"]) == 1


def test_port_checkpoint_restores_into_reference(tmp_path):
    d = str(tmp_path / "ck")
    jcfg, jp, jst = _trained_pair("float32")
    cfg, model = _model("minitron-8b", "float32")
    state = opt.init_opt_state(dict(model.named_parameters()),
                               opt.OptConfig())
    ckpt.load_train_tree(model, state, {"params": jax.tree.map(np.asarray,
                                                               jp),
                                        "opt": jax.tree.map(np.asarray,
                                                            jst)})
    ckpt.save(d, 5, ckpt.train_tree(model, state))
    like = {"params": jax.tree.map(jnp.zeros_like, jp),
            "opt": jax.tree.map(jnp.zeros_like, jst)}
    restored, step = jckpt.restore_latest(d, like)
    assert step == 5
    for want, got in zip(jax.tree.leaves({"params": jp, "opt": jst}),
                         jax.tree.leaves(restored)):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    leaves, treedef = ckpt.flatten(ckpt.train_tree(model, state))
    assert len(leaves) == len(jax.tree.leaves(restored))
    assert treedef.startswith("repro_torch {'opt': {'mu': ")


# ---------------------------------------------------------------- step --
def _step_inputs():
    rng = np.random.default_rng(5)
    return {"tokens": rng.integers(0, 512, (4, 32)).astype(np.int32),
            "labels": rng.integers(0, 512, (4, 32)).astype(np.int32)}


def _reference_step(jcfg, ocfg, params, batch, microbatches):
    """``repro.train.train_step``'s step without its mesh: value_and_grad
    of ``api.loss_fn``, the microbatch scan of ``train_step.py:41-57``
    written out, then ``apply_updates``."""
    vg = jax.jit(jax.value_and_grad(lambda p, b: japi.loss_fn(p, b, jcfg)))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    if microbatches == 1:
        loss, grads = vg(params, batch)
    else:
        per = batch["tokens"].shape[0] // microbatches
        loss = 0.0
        grads = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                             params)
        for i in range(microbatches):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            l, g = vg(params, mb)
            grads = jax.tree.map(lambda a, b: a + b.astype(jnp.float32),
                                 grads, g)
            loss = loss + l
        loss = loss / microbatches
        grads = jax.tree.map(lambda g: g / microbatches, grads)
    p2, _, m = jopt.apply_updates(params, grads,
                                  jopt.init_opt_state(params, ocfg), ocfg)
    return p2, float(loss), m


@pytest.mark.parametrize("microbatches", [1, 2])
def test_step_matches_hand_composed_reference(microbatches):
    jcfg, jparams = _jparams("minitron-8b", "float32")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jp2, jloss, jm = _reference_step(jcfg, jopt.OptConfig(**kw), jparams,
                                     _step_inputs(), microbatches)
    cfg, model = _model("minitron-8b", "float32")
    state = opt.init_opt_state(dict(model.named_parameters()),
                               opt.OptConfig(**kw))
    step = make_train_step(cfg, opt.OptConfig(**kw), microbatches=microbatches)
    m = step(model, state, {k: torch.from_numpy(v)
                            for k, v in _step_inputs().items()})
    assert set(m) == {"loss", "grad_norm", "lr"}
    np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    params = dict(model.named_parameters())
    for path, names in param_layout(model).items():
        np.testing.assert_allclose(_port_leaf(params, names),
                                   _ref_leaf(jp2, path), rtol=2e-3,
                                   atol=2e-5, err_msg=str(path))
    assert all(p.grad is None for p in params.values())


def test_microbatch_equivalence():
    """k microbatches give the same update as one big batch."""
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    out = []
    for microbatches in (1, 2):
        cfg, model = _model("minitron-8b", "float32")
        state = opt.init_opt_state(dict(model.named_parameters()),
                                   opt.OptConfig(**kw))
        m = make_train_step(cfg, opt.OptConfig(**kw), microbatches=microbatches)(
            model, state, {k: torch.from_numpy(v)
                           for k, v in _step_inputs().items()})
        out.append((float(m["loss"]), list(model.parameters())))
    (l1, p1), (l2, p2) = out
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-3, atol=2e-5)


# --------------------------------------------------------------- flops --
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_equal_reference(arch):
    for cfg, jcfg in ((get_config(arch), j_config(arch)),
                      (get_smoke_config(arch), j_smoke(arch))):
        assert flops.count_params(cfg) == jflops.count_params(jcfg)
        for tshape, jshape in zip(tconfig.ALL_SHAPES, jconfig.ALL_SHAPES):
            assert flops.model_flops(cfg, tshape) == jflops.model_flops(
                jcfg, jshape)


# --------------------------------------------------------- input specs --
@pytest.mark.parametrize("arch", DENSE + (
    "moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b", "mamba2-130m",
    "zamba2-7b", "whisper-tiny", "qwen2-vl-7b"))
def test_input_specs_match_reference(arch):
    """Every leaf's shape and dtype equal the reference's (the SSM
    family's conv tails fp32 in a bf16 decode cache, as its
    ``api.init_cache`` leaves them)."""
    cfg, jcfg = get_config(arch), j_config(arch)

    def flat(tree):
        return [(tuple(x.shape), str(x.dtype).split(".")[-1])
                for x in jax.tree.leaves(tree)]

    for tshape, jshape in zip(tconfig.ALL_SHAPES, jconfig.ALL_SHAPES):
        got = api.train_input_specs(cfg, tshape)
        assert all(t.device.type == "meta" for t in got.values())
        assert flat({k: v for k, v in got.items()}) == flat(
            japi.train_input_specs(jcfg, jshape))
        got = api.decode_input_specs(cfg, tshape)
        want = japi.decode_input_specs(jcfg, jshape)
        assert set(got) == set(want)
        for k in want:
            assert flat(got[k]) == flat(want[k]), k


# ---------------------------------------------------------------- loop --
@pytest.mark.parametrize("arch", ["glm4-9b", "gemma2-9b"])
def test_train_loop_with_checkpoint_resume(arch, tmp_path):
    cfg = get_smoke_config(arch)
    d = str(tmp_path / "ck")
    _, losses1 = train_loop(cfg, steps=6, global_batch=4, seq_len=64,
                            ckpt_dir=d, save_every=3, log_every=100,
                            device="cpu")
    model, losses2 = train_loop(cfg, steps=8, global_batch=4, seq_len=64,
                                ckpt_dir=d, resume=True, log_every=100,
                                device="cpu")
    assert len(losses2) == 2  # only steps 6..7 re-run
    assert np.isfinite(losses1 + losses2).all()
    assert ckpt.available_steps(d) == [3, 6, 8]
    # The loss falls over the run: the trained model's loss on the first
    # step's batch is below the initial weights'.
    first = {k: torch.from_numpy(v) for k, v in data.global_batch(
        data.DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4),
        0).items()}
    init, _ = train_loop(cfg, steps=0, global_batch=4, seq_len=64,
                         device="cpu")
    with torch.no_grad():
        assert api.loss_fn(model, first, cfg) < api.loss_fn(init, first,
                                                             cfg)


def test_resume_equals_uninterrupted_run(tmp_path):
    cfg = get_smoke_config("gemma2-9b")
    d = str(tmp_path / "ck")
    kw = dict(global_batch=2, seq_len=48, log_every=100, device="cpu")
    _, first = train_loop(cfg, steps=2, ckpt_dir=d, **kw)
    # The resumed run is told 3 steps, as the uninterrupted one: the same
    # OptConfig (warm-up and cosine) in both.
    resumed, rest = train_loop(cfg, steps=3, ckpt_dir=d, resume=True, **kw)
    whole, losses = train_loop(cfg, steps=3, **kw)
    assert first + rest == losses[:2] + losses[2:] and len(rest) == 1
    assert first == losses[:2]
    for a, b in zip(resumed.parameters(), whole.parameters()):
        assert torch.equal(a, b)


def test_train_loop_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        train_loop(get_smoke_config("glm4-9b"), 1, 2, 16)
