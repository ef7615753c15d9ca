"""The port's train and serve steps on a ``(2, 4)`` mesh against the
reference's own ``make_train_step`` and ``make_serve_step``.

The reference runs once, in a subprocess with 8 fake XLA CPU devices and
an Auto-axis ``(2, 4)`` mesh (its steps raise on jax 0.9.0's default
Explicit axes and run on Auto ones), jitted with the shardings of
``shardings_for_train``. It writes its parameters, each step's updated
parameters and metrics at 1 and 2 microbatches, a prompt's decode
outputs and the MoE routing of every layer to an ``.npz`` that a
module-scoped fixture reads. Configs, all smoke with
``compute_dtype="float32"``:

- ``minitron_8b``: 4 query heads over 2 KV heads on a model axis of 4,
  so both packages repeat K and V twice (``kv_repeat_for_tp``);
- ``moonshot_v1_16b_a3b``: 8 experts over 4 model ranks, 2 × 4 token
  groups, the expert-parallel exchange forward and backward (routing
  compared first: a near tie flips an expert choice and moves a token by
  O(1), not by rounding);
- ``mamba2_130m``: ``dp_only`` (batch over all 8 positions, no model
  axis) and ``serve_sample`` (the serve step returns argmax tokens).

The port runs the same steps on a ``(2, 4)`` mesh of CPU positions, with
the parameters through ``convert``, the AdamW state and the batch placed
by ``shardings_for_train``. Tolerances: the loss, the grad norm, the
first moment (the step's gradient times 1 - b1) and every decode step's
logits within 1e-4·max|ref| (fp32 sums in other orders, as the family
tests hold them); argmax tokens and routing equal; the updated
parameters within rtol 2e-3 and atol 2e-5, as
``tests/test_torch_train.py`` holds its step, wherever the reference's
gradient exceeds 1e-2 of its leaf's largest (a hundred times the
gradient's tolerance), and within two learning rates elsewhere. AdamW's
first step divides each gradient by its own magnitude plus eps = 1e-8,
so an element whose gradient is small against the leaf's rounding moves
by a fraction of lr that the rounding decides.
"""
import os
import subprocess
import sys
import textwrap
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.dist import sharding as sh
from repro_torch.models import api, convert, moe
from repro_torch.models.convert import param_layout
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("minitron_8b", "moonshot_v1_16b_a3b", "mamba2_130m")
REL = 1e-4
B, S, PROMPT = 4, 64, 8
KW = dict(lr=1e-3, warmup_steps=1, total_steps=10)

REFERENCE = r'''
import sys
import jax, jax.numpy as jnp, numpy as np
from unittest import mock
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.dist import sharding as sh
from repro.models import api, moe
from repro.train import optimizer as opt, train_step as ts

out_npz = sys.argv[1]
B, S, PROMPT = (int(x) for x in sys.argv[2:5])
KW = dict(lr=1e-3, warmup_steps=1, total_steps=10)
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
arrays = {}

def name(path):
    return "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path)

def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arrays[f"{prefix}/{name(path)}"] = np.asarray(leaf)

def run(arch):
    cfg = get_smoke_config(arch).scaled(compute_dtype="float32")
    params = api.init_params(jax.random.PRNGKey(0), cfg)
    save(f"{arch}/params", params)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)], 1)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    arrays[f"{arch}/tokens"] = tokens
    arrays[f"{arch}/labels"] = labels
    ocfg = opt.OptConfig(**KW)
    for mb in (1, 2):
        state = opt.init_opt_state(params, ocfg)
        step = ts.make_train_step(cfg, ocfg, mesh, microbatches=mb)
        i_sh, o_sh = ts.shardings_for_train(mesh, params, state, batch)
        fn = jax.jit(step, in_shardings=i_sh, out_shardings=o_sh)
        p2, s2, m = fn(jax.device_put(params, i_sh[0]),
                       jax.device_put(state, i_sh[1]),
                       jax.device_put(batch, i_sh[2]))
        save(f"{arch}/step{mb}/params", p2)
        save(f"{arch}/step{mb}/mu", s2["mu"])
        for k in ("loss", "grad_norm", "lr"):
            arrays[f"{arch}/step{mb}/{k}"] = np.asarray(m[k])
        arrays[f"{arch}/step{mb}/step"] = np.asarray(s2["step"])
    serve = jax.jit(ts.make_serve_step(cfg, mesh))
    cache = api.init_cache(cfg, B, PROMPT, dtype=jnp.float32)
    for t in range(PROMPT):
        out, cache = serve(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                           jnp.int32(t + 1))
        arrays[f"{arch}/serve/{t}"] = np.asarray(out)
    if cfg.family == "moe":
        real = moe.router_topk
        got = []

        def record(logits, k):
            out = real(logits, k)
            got.append((np.asarray(out[1]), np.asarray(logits)))
            return out

        with mock.patch.object(moe, "router_topk", record), \
                jax.disable_jit(), sh.activation_context(mesh):
            api.loss_fn(params, batch, cfg.scaled(remat=False))
        for i, (topi, logits) in enumerate(got):
            arrays[f"{arch}/route/{i}"] = topi
            arrays[f"{arch}/route_logits/{i}"] = logits

for arch in sys.argv[5:]:
    with mesh:
        run(arch)
np.savez(out_npz, **arrays)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_steps_ref")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE),
         str(d / "ref.npz"), str(B), str(S), str(PROMPT), *ARCHS],
        capture_output=True, text=True, env=env, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(d / "ref.npz") as z:
        return dict(z)


@pytest.fixture(autouse=True)
def _no_leaked_activation_context():
    sh._ctx.state = None
    yield
    assert sh.current_mesh_info() == (None, None)


def _tree(arrays, prefix):
    tree = {}
    for key, val in arrays.items():
        if key.startswith(prefix):
            node = tree
            *head, last = key[len(prefix):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = val
    return tree


_CONVERT = {"dense": convert.transformer_params_from_jax,
            "moe": convert.moe_params_from_jax,
            "ssm": convert.mamba2_params_from_jax}


def _model(ref, arch):
    cfg = get_smoke_config(arch).scaled(compute_dtype="float32")
    params = _tree(ref, f"{arch}/params/")
    return cfg, _CONVERT[cfg.family](params, cfg, device="cpu")


def _mesh(shape=(2, 4)):
    return sh.Mesh(shape, ("data", "model"), "cpu")


def _close(got, want, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max(), err_msg=what)


def _batch(ref, arch):
    return {k: torch.from_numpy(ref[f"{arch}/{k}"])
            for k in ("tokens", "labels")}


def _leaf(model, names):
    params = dict(model.named_parameters())
    if names.shape == ():
        return params[names[()]]
    return torch.stack([params[names[ix]].detach()
                        for ix in np.ndindex(names.shape)]).reshape(
        names.shape + params[names.flat[0]].shape)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_mesh_matches_reference_step(ref, arch, microbatches):
    """One step of the port's ``make_train_step(cfg, ocfg, mesh)`` with
    the state and batch placed by ``shardings_for_train`` against the
    reference's jitted step on the Auto (2, 4) mesh."""
    cfg, model = _model(ref, arch)
    mesh = _mesh()
    ocfg = opt.OptConfig(**KW)
    params = dict(model.named_parameters())
    state = opt.init_opt_state(params, ocfg)
    batch = _batch(ref, arch)
    (p_sh, o_sh, b_sh), _ = ts.shardings_for_train(mesh, params, state,
                                                   batch)
    placed = sh.device_put(state, o_sh)
    step = ts.make_train_step(cfg, ocfg, mesh, microbatches=microbatches)
    m = step(model, placed, sh.device_put(batch, b_sh))
    pre = f"{arch}/step{microbatches}"
    for k in ("loss", "grad_norm", "lr"):
        want = float(ref[f"{pre}/{k}"])
        assert abs(float(m[k]) - want) <= REL * abs(want), k
    assert int(state["step"]) == int(ref[f"{pre}/step"]) == 1
    want_p = _tree(ref, f"{pre}/params/")
    want_mu = _tree(ref, f"{pre}/mu/")
    for path, names in param_layout(model).items():
        mu = torch.stack([state["mu"][n] for n in names.flat]).reshape(
            names.shape + state["mu"][names.flat[0]].shape)
        ref_mu = convert.ref_leaf(want_mu, path)
        _close(mu, ref_mu, f"mu {path}")
        got = _leaf(model, names).detach().numpy()
        want = convert.ref_leaf(want_p, path)
        resolved = np.abs(ref_mu) > 1e-2 * np.abs(ref_mu).max()
        np.testing.assert_allclose(got[resolved], want[resolved], rtol=2e-3,
                                   atol=2e-5, err_msg=str(path))
        assert np.abs(got - want).max() <= 2 * KW["lr"], path


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_on_mesh_matches_reference(ref, arch):
    """The port's ``make_serve_step(cfg, mesh)`` over a teacher-forced
    prompt against the reference's jitted serve step: logits within
    1e-4·max|ref| a step, or, for mamba2's ``serve_sample``, the argmax
    tokens (B, 1) as int32, equal."""
    cfg, model = _model(ref, arch)
    serve = ts.make_serve_step(cfg, _mesh())
    cache = api.init_cache(cfg, B, PROMPT, dtype=torch.float32,
                           device="cpu")
    tokens = torch.from_numpy(ref[f"{arch}/tokens"])
    with torch.no_grad():
        for t in range(PROMPT):
            out, cache = serve(model, cache, tokens[:, t:t + 1], t + 1)
            want = ref[f"{arch}/serve/{t}"]
            if cfg.serve_sample:
                assert out.dtype == torch.int32 and out.shape == (B, 1)
                np.testing.assert_array_equal(out.numpy(), want)
            else:
                _close(out, want, f"step {t}")


def test_expert_parallel_routing_equals_reference(ref):
    """moonshot's routing under the (2, 4) mesh, every layer, before any
    value is compared."""
    arch = "moonshot_v1_16b_a3b"
    cfg, model = _model(ref, arch)
    got = []
    real = moe.router_topk

    def record(logits, k):
        out = real(logits, k)
        got.append(out[1])
        return out

    with torch.no_grad(), mock.patch.object(moe, "router_topk", record), \
            sh.activation_context(_mesh()):
        api.loss_fn(model, _batch(ref, arch), cfg)
    assert len(got) == cfg.n_layers
    for i, topi in enumerate(got):
        np.testing.assert_array_equal(topi.numpy(), ref[f"{arch}/route/{i}"])


def test_expert_parallel_equals_per_group_composition(ref):
    """The exchange on (2, 4) against the no-mesh functions composed by
    hand over the 2 × 4 groups (dispatch per group at the group's
    capacity, each group's buffer through all experts, combine), forward
    and backward: equal bit for bit, since every expert sees the same
    rows in the same order. A (1, 1) mesh equals no mesh bit for bit."""
    arch = "moonshot_v1_16b_a3b"
    cfg, model = _model(ref, arch)
    p = model.layers[0].moe
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)).requires_grad_(True)
    with sh.activation_context(_mesh()):
        out, _ = moe.moe_block(p, x, cfg)
    g_out = torch.autograd.grad(out.square().sum(), [x, p["wi_gate"]])
    e, k = cfg.n_experts, cfg.top_k
    bl, sl = B // 2, S // 4
    tg = bl * sl
    cap = max(4, min(int(cfg.capacity_factor * tg * k / e), tg))
    topv, topi, _ = moe.router_topk(x.float() @ p["router"], k)
    rows = []
    for di in range(2):
        cols = []
        for mj in range(4):
            blk = (slice(di * bl, (di + 1) * bl),
                   slice(mj * sl, (mj + 1) * sl))
            buf, slot = moe._local_dispatch(
                x[blk].reshape(tg, -1), topi[blk].reshape(tg, k), e, k, cap,
                torch.float32)
            y = moe._experts(p, buf, torch.float32)
            cols.append(moe._local_combine(y, slot, topv[blk].reshape(tg, k))
                        .reshape(bl, sl, -1))
        rows.append(torch.cat(cols, dim=1))
    want = torch.cat(rows) + moe.L.mlp_block(p["shared"], x, cfg)
    g_want = torch.autograd.grad(want.square().sum(), [x, p["wi_gate"]])
    assert torch.equal(out, want)
    for a, b in zip(g_out, g_want):
        torch.testing.assert_close(a, b, rtol=0, atol=REL * b.abs().max())
    with torch.no_grad():
        plain, _ = moe.moe_block(p, x, cfg)
        with sh.activation_context(_mesh((1, 1))):
            one, _ = moe.moe_block(p, x, cfg)
    assert torch.equal(plain, one)


def test_one_position_mesh_step_equals_no_mesh_bit_for_bit(ref):
    """minitron's step on ``make_mesh_for(1)`` against ``mesh=None``."""
    from repro_torch.launch.train import make_mesh_for

    arch = "minitron_8b"
    metrics, models = [], []
    for mesh in (None, make_mesh_for(1, device="cpu")):
        cfg, model = _model(ref, arch)
        ocfg = opt.OptConfig(**KW)
        state = opt.init_opt_state(dict(model.named_parameters()), ocfg)
        metrics.append(ts.make_train_step(cfg, ocfg, mesh)(
            model, state, _batch(ref, arch)))
        models.append(model)
    for k in ("loss", "grad_norm"):
        assert torch.equal(metrics[0][k], metrics[1][k]), k
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a, b)


def test_steps_leave_the_context_on_error(ref):
    """A step that raises leaves no sharding context behind (the
    reference's train step leaves it entered)."""
    cfg, model = _model(ref, "minitron_8b")
    ocfg = opt.OptConfig(**KW)
    state = opt.init_opt_state(dict(model.named_parameters()), ocfg)
    bad = {"tokens": torch.zeros((B, S), dtype=torch.int32),
           "labels": torch.zeros((B, S + 1), dtype=torch.int32)}
    with pytest.raises(Exception):
        ts.make_train_step(cfg, ocfg, _mesh())(model, state, bad)
    assert sh.current_mesh_info() == (None, None)
    serve = ts.make_serve_step(cfg, _mesh())
    with pytest.raises(Exception):
        serve(model, {}, torch.zeros((B, 1), dtype=torch.int32), 1)
    assert sh.current_mesh_info() == (None, None)
