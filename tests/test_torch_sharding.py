"""The port's placement rules against ``repro.dist.sharding`` on the CPU.

The reference runs once, in a subprocess with 8 fake XLA CPU devices and
meshes with Auto axes (``jax.make_mesh(..., axis_types=Auto)``; on jax
0.9.0's default Explicit axes its ``with_sharding_constraint`` raises).
It writes its outputs to a JSON and an ``.npz`` file that a
module-scoped fixture reads:

- the sanitized spec of every parameter leaf of every smoke config and
  of gemma2-9b and qwen3-moe at published shapes (``jax.eval_shape``),
  on real ``(1, 1)``, ``(2, 4)`` and ``(2, 2, 2)`` meshes and abstract
  ``(16, 16)`` and ``(2, 16, 16)`` ones; shard shapes; each real mesh's
  ``devices_indices_map`` by device coordinate;
- ``batch_shardings``, ``cache_shardings``, ``shardings_for_train`` and
  ``shardings_for_serve``;
- the context rules (``kv_repeat_for_tp``, ``batch_shard_count``,
  ``model_axis_size``, ``constrain``'s spec) with and without
  ``dp_only``;
- ``compress_tree`` and ``crosspod_mean_compressed`` (the inputs of
  ``tests/test_distributed.py::test_crosspod_compressed_reduction_shardmap``
  and a seeded tree with error feedback), ``remesh_live`` (the inputs of
  ``test_elastic_reshard_grow_and_shrink`` and minitron's smoke
  parameters) as per-device shards, and ``degrade_plan``.

The port builds the same meshes over ``"cpu"`` (or ``"meta"`` for 256
and 512 positions) and must agree: specs, shard shapes, index maps,
context values and ``degrade_plan`` exactly; compression and the blocks
placed by ``remesh_live`` bit for bit (``torch.round`` and ``jnp.round``
both round half to even).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.dist import sharding as sh
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import api
from repro_torch.models.convert import param_layout
from repro_torch.train import compress, elastic
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

REAL = {"1x1": ((1, 1), ("data", "model")),
        "2x4": ((2, 4), ("data", "model")),
        "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
ABSTRACT = {"16x16": ((16, 16), ("data", "model")),
            "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PUBLISHED = ("gemma2_9b", "qwen3_moe_235b_a22b")
KV_H = [(kv, h) for kv in (1, 2, 4, 8, 16, 32) for h in (4, 8, 16, 28, 32,
                                                         64) if h % kv == 0]
CONSTRAIN = [((4, 64, 8, 16), ("batch", None, "model", None)),
             ((4, 64, 64), ("batch", None, None)),
             ((8, 4, 16), ("model", "batch", None)),
             ((3, 5), ("batch", "model")),
             ((2, 4, 2, 16, 16), ("batch", "model", None, None, None))]

REFERENCE = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from unittest import mock
from jax.sharding import AbstractMesh, AxisType, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import ARCHS, get_config, get_smoke_config
from repro.dist import sharding as sh
from repro.models import api
from repro.train import compress, elastic, optimizer as opt, train_step as ts

out_json, out_npz = sys.argv[1], sys.argv[2]
REAL = json.loads(sys.argv[3]); ABSTRACT = json.loads(sys.argv[4])
PUBLISHED = json.loads(sys.argv[5]); KV_H = json.loads(sys.argv[6])
CONSTRAIN = json.loads(sys.argv[7])
auto = lambda n: (AxisType.Auto,) * n
meshes = {k: jax.make_mesh(tuple(s), tuple(a), axis_types=auto(len(s)))
          for k, (s, a) in REAL.items()}
abstract = {k: AbstractMesh(tuple(s), tuple(a), axis_types=auto(len(s)))
            for k, (s, a) in ABSTRACT.items()}

def entry(e):
    if isinstance(e, tuple):
        return list(e) if len(e) > 1 else e[0]
    return e

def spec(s):
    return [entry(e) for e in tuple(s.spec if hasattr(s, "spec") else s)]

def coords(mesh, d):
    return [int(i) for i in np.argwhere(mesh.devices == d)[0]]

def idx_map(sharding, shape):
    m = sharding.devices_indices_map(tuple(shape))
    return sorted([coords(sharding.mesh, d),
                   [None if sl.start is None else [sl.start, sl.stop]
                    for sl in idx]] for d, idx in m.items())

def name(path):
    return "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path)

def flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]

def describe(mesh, shardings, tree, with_map):
    out = {}
    for (path, s), (_, leaf) in zip(flat(shardings), flat(tree)):
        d = {"shape": list(leaf.shape), "spec": spec(s),
             "shard": list(s.shard_shape(tuple(leaf.shape)))}
        if with_map:
            d["map"] = idx_map(s, leaf.shape)
        out[name(path)] = d
    return out

res = {"params": {}, "batch": {}, "cache": {}, "train": {}, "serve": {},
       "context": [], "constrain": [], "degrade": []}
cfgs = {a: get_smoke_config(a) for a in ARCHS}
cfgs.update({a + "@published": get_config(a) for a in PUBLISHED})
trees = {a: jax.eval_shape(lambda c=c: api.init_params(jax.random.PRNGKey(0), c))
         for a, c in cfgs.items()}
allm = dict(meshes, **abstract)
for a, tree in trees.items():
    for mk, mesh in allm.items():
        with_map = mk in meshes and not a.endswith("@published")
        res["params"][a + "|" + mk] = describe(
            mesh, sh.param_shardings(mesh, tree), tree, with_map)
batch = {"tokens": jax.ShapeDtypeStruct((4, 64), jnp.int32),
         "labels": jax.ShapeDtypeStruct((4, 64), jnp.int32),
         "frames": jax.ShapeDtypeStruct((4, 8, 16), jnp.float32),
         "odd": jax.ShapeDtypeStruct((3, 64), jnp.int32)}
for mk, mesh in allm.items():
    res["batch"][mk] = describe(mesh, sh.batch_shardings(mesh, batch),
                                batch, mk in meshes)
    for a in ARCHS:
        cache = jax.eval_shape(lambda c=cfgs[a]: api.init_cache(c, 4, 16))
        res["cache"][a + "|" + mk] = describe(
            mesh, sh.cache_shardings(mesh, cache), cache, mk in meshes)
for a in ("minitron_8b", "moonshot_v1_16b_a3b", "mamba2_130m"):
    cfg, tree = cfgs[a], trees[a]
    ocfg = opt.OptConfig(warmup_steps=1, total_steps=10)
    state = jax.eval_shape(lambda: opt.init_opt_state(tree, ocfg))
    for mk, mesh in meshes.items():
        (p_sh, o_sh, b_sh), (p2, o2, m_sh) = ts.shardings_for_train(
            mesh, tree, state, batch)
        res["train"][a + "|" + mk] = {
            "mu": describe(mesh, o_sh["mu"], state["mu"], False),
            "nu": describe(mesh, o_sh["nu"], state["nu"], False),
            "step": spec(o_sh["step"]),
            "batch": describe(mesh, b_sh, batch, False),
            "metrics": {k: spec(v) for k, v in m_sh.items()},
            "same": p_sh is p2 and o_sh is o2}
        cache = jax.eval_shape(lambda: api.init_cache(cfg, 4, 16))
        tok = jax.ShapeDtypeStruct((4, 1), jnp.int32)
        for sample in (False, True):
            (ps, cs, tsh, ls), (os_, cs2) = ts.shardings_for_serve(
                mesh, tree, cache, tok, sample=sample)
            res["serve"][a + "|" + mk + "|" + str(sample)] = {
                "token": spec(tsh), "len": spec(ls), "out": spec(os_),
                "cache": describe(mesh, cs, cache, False)}
for mk, mesh in allm.items():
    for dp in (False, True):
        with sh.activation_context(mesh, dp):
            res["context"].append([mk, dp, sh.batch_shard_count(),
                                   sh.model_axis_size(),
                                   [sh.kv_repeat_for_tp(kv, h)
                                    for kv, h in KV_H]])
            got = []
            with mock.patch.object(jax.lax, "with_sharding_constraint",
                                   lambda x, s: got.append(spec(s)) or x):
                for shape, axes in CONSTRAIN:
                    sh.constrain(jnp.zeros(shape), *axes)
            res["constrain"].append([mk, dp, got])
with mock.patch.object(jax.lax, "with_sharding_constraint",
                       lambda x, s: 1 / 0):
    res["outside"] = [sh.kv_repeat_for_tp(2, 4), sh.batch_shard_count(),
                      sh.model_axis_size(),
                      sh.constrain(jnp.zeros((2, 2)), "batch", "model").shape]
for n in range(0, 40, 3):
    for shape in ((16, 16), (2, 16, 16), (4, 8), (2, 2, 2)):
        res["degrade"].append([n, list(shape),
                               list(elastic.degrade_plan(n, shape))])

arrays = {}
rng = np.random.default_rng(3)
tree = {"a": rng.standard_normal((16, 8)).astype(np.float32) * 0.1,
        "b": {"c": rng.standard_normal((33,)).astype(np.float32)}}
err = {"a": rng.standard_normal((16, 8)).astype(np.float32) * 1e-3,
       "b": {"c": rng.standard_normal((33,)).astype(np.float32) * 1e-2}}
for label, e in (("zero", compress.init_error_state(tree)), ("err", err)):
    q, s, e2 = compress.compress_tree(tree, e)
    back = compress.decompress_tree(q, s)
    for k, v in (("q", q), ("s", s), ("e", e2), ("back", back)):
        for path, leaf in flat(v):
            arrays[f"compress/{label}/{k}/{name(path)}"] = np.asarray(leaf)
pm = jax.make_mesh((4, 2), ("pod", "data"), axis_types=auto(2))
g = jnp.arange(32, dtype=jnp.float32).reshape(4, 8) / 100.0
cases = {"shardmap": (g, jnp.zeros((4, 8))),
         "seeded": (jnp.asarray(rng.standard_normal((4, 8)), jnp.float32),
                    jnp.asarray(rng.standard_normal((4, 8)) * 1e-2,
                                jnp.float32))}
def f(g, err):
    o, e2 = compress.crosspod_mean_compressed({"g": g}, {"g": err},
                                              axis="pod")
    return o["g"], e2["g"]
fn = shard_map(f, mesh=pm, in_specs=(P("pod", "data"), P("pod", "data")),
               out_specs=(P("pod", "data"), P("pod", "data")))
for label, (gg, ee) in cases.items():
    o, e2 = fn(gg, ee)
    arrays[f"crosspod/{label}/g"] = np.asarray(gg)
    arrays[f"crosspod/{label}/err"] = np.asarray(ee)
    arrays[f"crosspod/{label}/out"] = np.asarray(o)
    arrays[f"crosspod/{label}/err2"] = np.asarray(e2)

def shards(x, tag):
    for s in x.addressable_shards:
        c = "_".join(map(str, coords(x.sharding.mesh, s.device)))
        arrays[f"{tag}/{c}"] = np.asarray(s.data)

p = {"layers": {"attn": {"wq": jnp.arange(64, dtype=jnp.float32)
                         .reshape(8, 8)}}}
m1, m3 = meshes["2x4"], meshes["2x2x2"]
m2 = jax.make_mesh((2, 2), ("data", "model"), axis_types=auto(2))
p1 = jax.device_put(p, sh.param_shardings(m2, p))
p2 = elastic.remesh_live(p1, m3)
p3 = elastic.remesh_live(p2, m2)
for tag, t in (("m2", p1), ("m3", p2), ("back", p3)):
    shards(t["layers"]["attn"]["wq"], f"elastic/wq/{tag}")
mp = api.init_params(jax.random.PRNGKey(0), cfgs["minitron_8b"])
for k, v in flat(mp):
    arrays[f"minitron/{name(k)}"] = np.asarray(v)
q1 = jax.device_put(mp, sh.param_shardings(m2, mp))
q2 = elastic.remesh_live(q1, m3)
for tag, t in (("m2", q1), ("m3", q2)):
    for k, v in flat(t):
        shards(v, f"elastic/minitron/{tag}/{name(k)}")
json.dump(res, open(out_json, "w"))
np.savez(out_npz, **arrays)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharding_ref")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    args = [json.dumps(x) for x in (REAL, ABSTRACT, PUBLISHED, KV_H,
                                    CONSTRAIN)]
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE),
         str(d / "ref.json"), str(d / "ref.npz"), *args],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(d / "ref.json") as fh:
        res = json.load(fh)
    with np.load(d / "ref.npz") as z:
        arrays = dict(z)
    return res, arrays


def _mesh(key):
    shape, axes = {**REAL, **ABSTRACT}[key]
    return sh.Mesh(shape, axes, "cpu" if key in REAL else "meta")


def _entry(e):
    if isinstance(e, tuple):
        return list(e) if len(e) > 1 else e[0]
    return e


def _spec(spec):
    return [_entry(e) for e in spec]


def _map(sharding, shape):
    return sorted([list(pos), [None if sl.start is None else
                               [sl.start, sl.stop] for sl in idx]]
                  for pos, idx in sharding.indices_map(shape).items())


def _describe(shardings, tree, with_map):
    out = {}
    for k, s in shardings.items():
        shape = tuple(tree[k].shape)
        d = {"shape": list(shape), "spec": _spec(s.spec),
             "shard": list(s.shard_shape(shape))}
        if with_map:
            d["map"] = _map(s, shape)
        out[k] = d
    return out


def _meta(arch):
    cfg = (get_config(arch.split("@")[0]) if arch.endswith("@published")
           else get_smoke_config(arch))
    return cfg, api.init_params(None, cfg, device="meta")


def _ref_name(path):
    return "/".join(path)


# ---------------------------------------------------------------- specs --
@pytest.mark.parametrize("arch", list(ARCHS) + [a + "@published"
                                               for a in PUBLISHED])
def test_param_shardings_equal_reference_leaf_for_leaf(ref, arch):
    """Every leaf of the reference's view of the port's module tree
    (``param_layout``) gets the reference's spec and shard shape; every
    real mesh's index map is jax's; each layer's :class:`LayerSharding`
    is its slice of the leaf's."""
    res, _ = ref
    _, model = _meta(arch)
    layout = param_layout(model)
    params = dict(model.named_parameters())
    for mk in (*REAL, *ABSTRACT):
        mesh = _mesh(mk)
        want = res["params"][f"{arch}|{mk}"]
        specs = sh.leaf_specs(mesh, model)
        assert sorted(map(_ref_name, specs)) == sorted(want), mk
        got_sh = sh.param_shardings(mesh, model)
        assert set(got_sh) == set(params)
        for path, (shape, spec) in specs.items():
            w = want[_ref_name(path)]
            assert list(shape) == w["shape"], (mk, path)
            assert _spec(spec) == w["spec"], (mk, path)
            leaf = sh.NamedSharding(mesh, spec)
            assert list(leaf.shard_shape(shape)) == w["shard"], (mk, path)
            if "map" in w:
                assert _map(leaf, shape) == w["map"], (mk, path)
            names = layout[path]
            for ix in np.ndindex(names.shape):
                s = got_sh[names[ix]]
                if not ix:
                    assert s == leaf
                    continue
                assert isinstance(s, sh.LayerSharding)
                assert s.leaf == leaf and s.index == ix
                assert list(s.shard_shape(params[names[ix]].shape)) == \
                    w["shard"][len(ix):]


@pytest.mark.parametrize("mk", list(REAL) + list(ABSTRACT))
def test_batch_and_cache_shardings_equal_reference(ref, mk):
    res, _ = ref
    mesh = _mesh(mk)
    batch = {"tokens": torch.empty((4, 64), dtype=torch.int32),
             "labels": torch.empty((4, 64), dtype=torch.int32),
             "frames": torch.empty((4, 8, 16)),
             "odd": torch.empty((3, 64), dtype=torch.int32)}
    assert _describe(sh.batch_shardings(mesh, batch), batch,
                     mk in REAL) == res["batch"][mk]
    for arch in ARCHS:
        cache = api.init_cache(get_smoke_config(arch), 4, 16, device="meta")
        want = res["cache"][f"{arch}|{mk}"]
        got = _describe(sh.cache_shardings(mesh, cache), cache, mk in REAL)
        assert got == want, arch


@pytest.mark.parametrize("arch", ["minitron_8b", "moonshot_v1_16b_a3b",
                                  "mamba2_130m"])
def test_shardings_for_train_and_serve_equal_reference(ref, arch):
    """The moments follow the parameters' leaves (``mu`` and ``nu`` are
    keyed by parameter name, so their specs are read through
    ``param_layout`` as the parameters' are), ``step`` and the metrics are
    replicated, the batch is the reference's; the serve shardings' token,
    length, output and cache specs, sampled or not."""
    res, _ = ref
    cfg, model = _meta(arch)
    params = dict(model.named_parameters())
    ocfg = opt.OptConfig(warmup_steps=1, total_steps=10)
    state = opt.init_opt_state(params, ocfg)
    batch = {"tokens": torch.empty((4, 64), dtype=torch.int32),
             "labels": torch.empty((4, 64), dtype=torch.int32),
             "frames": torch.empty((4, 8, 16)),
             "odd": torch.empty((3, 64), dtype=torch.int32)}
    layout = param_layout(model)
    for mk in REAL:
        mesh = _mesh(mk)
        want = res["train"][f"{arch}|{mk}"]
        (p_sh, o_sh, b_sh), (p2, o2, m_sh) = ts.shardings_for_train(
            mesh, model, state, batch)
        assert p2 is p_sh and o2 is o_sh and want["same"]
        for moment in ("mu", "nu"):
            for path, names in layout.items():
                w = want[moment][_ref_name(path)]
                for ix in np.ndindex(names.shape):
                    s = o_sh[moment][names[ix]]
                    leaf = s.leaf if ix else s
                    assert _spec(leaf.spec) == w["spec"], (moment, path)
        assert _spec(o_sh["step"].spec) == want["step"]
        assert {k: _spec(v.spec) for k, v in m_sh.items()} == want["metrics"]
        assert _describe(b_sh, batch, False) == want["batch"]
        cache = api.init_cache(cfg, 4, 16, device="meta")
        tok = torch.empty((4, 1), dtype=torch.int32)
        for sample in (False, True):
            w = res["serve"][f"{arch}|{mk}|{sample}"]
            (_, c_sh, t_sh, l_sh), (out_sh, c2) = ts.shardings_for_serve(
                mesh, model, cache, tok, sample=sample)
            assert c2 is c_sh
            assert _spec(t_sh.spec) == w["token"]
            assert _spec(l_sh.spec) == w["len"]
            assert _spec(out_sh.spec) == w["out"]
            assert _describe(c_sh, cache, False) == w["cache"]


def test_production_and_local_meshes():
    mesh = make_production_mesh(device="meta")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 16, "model": 16}
    pod = make_production_mesh(multi_pod=True, device="meta")
    assert pod.axis_names == ("pod", "data", "model")
    assert tuple(pod.shape.values()) == (2, 16, 16) and pod.size == 512
    local = make_local_mesh(device="cpu")
    assert local.shape == {"data": 1, "model": 1}
    assert local.device((0, 0)) == torch.device("cpu")


def test_cuda_mesh_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_local_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        sh.Mesh((2, 2), ("data", "model"))


# ------------------------------------------------------- context rules --
def test_context_rules_equal_reference(ref):
    """``batch_shard_count``, ``model_axis_size``, ``kv_repeat_for_tp``
    over a grid of (KV, H) and ``constrain``'s resolved specs, inside
    each mesh's context with and without ``dp_only``; outside any
    context every helper is a no-op and ``constrain`` returns its
    input."""
    res, _ = ref
    for (mk, dp, count, model_size, reps), (_, _, specs) in zip(
            res["context"], res["constrain"]):
        with sh.activation_context(_mesh(mk), dp):
            assert sh.batch_shard_count() == count, (mk, dp)
            assert sh.model_axis_size() == model_size, (mk, dp)
            assert [sh.kv_repeat_for_tp(kv, h) for kv, h in KV_H] == reps
            got = [_spec(sh.constraint_spec(shape, *axes))
                   for shape, axes in CONSTRAIN]
            assert got == specs, (mk, dp)
            x = torch.zeros(4, 64, 8, 16)
            assert sh.constrain(x, "batch", None, "model", None) is x
    assert sh.current_mesh_info() == (None, None)
    assert [sh.kv_repeat_for_tp(2, 4), sh.batch_shard_count(),
            sh.model_axis_size()] == res["outside"][:3]
    assert sh.constraint_spec((2, 2), "batch", "model") is None


def test_activation_context_reaches_other_threads():
    """The context is thread-local, as the reference's: a plain thread
    sees no mesh. Autograd's device thread, where a CUDA backward runs
    remat's recomputation, gets the forward's context through
    ``remat_context``: a backward run on another thread recomputes under
    the step's mesh."""
    import threading

    from torch.utils.checkpoint import checkpoint

    seen, recomputed = [], []

    def f(x):
        recomputed.append((sh.batch_shard_count(), sh.model_axis_size()))
        return x * x

    x = torch.ones(3, requires_grad=True)
    with sh.activation_context(_mesh("2x4")):
        worker = threading.Thread(target=lambda: seen.append(
            (sh.batch_shard_count(), sh.model_axis_size())))
        worker.start()
        worker.join()
        y = checkpoint(f, x, use_reentrant=False,
                       context_fn=sh.remat_context).sum()
    worker = threading.Thread(target=y.backward)
    worker.start()
    worker.join()
    assert seen == [(1, 1)]
    assert recomputed == [(2, 4), (2, 4)]
    assert torch.equal(x.grad, 2 * x.detach())
    assert sh.current_mesh_info() == (None, None)


@pytest.mark.parametrize("arch", ["gemma2_9b", "moonshot_v1_16b_a3b"])
def test_remat_backward_on_another_thread_equals_in_thread(arch):
    """A remat'ed loss on a (2, 4) mesh (gemma2: K/V repeated for the
    model axis; moonshot: the expert-parallel exchange) gives the same
    gradients, bit for bit, whether its backward runs in the step's
    thread or, as a CUDA backward does, on another thread outside any
    context."""
    import threading

    cfg = get_smoke_config(arch).scaled(compute_dtype="float32",
                                        n_layers=2, remat=True)
    model = api.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    grads = []
    for on_thread in (False, True):
        model.zero_grad(set_to_none=True)
        with sh.activation_context(_mesh("2x4")):
            loss = api.loss_fn(model, batch, cfg)
        if on_thread:
            worker = threading.Thread(target=loss.backward)
            worker.start()
            worker.join()
        else:
            loss.backward()
        grads.append({k: p.grad.clone()
                      for k, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_launch_mesh_holds_every_position_on_the_model_device():
    """``train_loop`` and ``generate`` build ``make_mesh_for`` the card
    count with every position on the model's device, so every placed
    block is a view (one process computes on whole tensors)."""
    from repro_torch.launch.train import mesh_on

    mesh = mesh_on(torch.device("cpu"))
    assert mesh.shape == {"data": 1, "model": 1}
    assert {str(d) for d in mesh.devices.flat} == {"cpu"}
    t = torch.arange(8.0)
    placed = sh.device_put(t, sh.NamedSharding(mesh, sh.P("data")))
    assert sh.gather(placed, torch.device("cpu")) is t


def test_activation_context_leaves_on_error():
    mesh = _mesh("2x4")
    with pytest.raises(ZeroDivisionError):
        with sh.activation_context(mesh):
            assert sh.model_axis_size() == 4
            1 / 0
    assert sh.current_mesh_info() == (None, None)


def test_sanitize_spec_drops_nondivisible():
    mesh = _mesh("2x4")
    assert sh.sanitize_spec(sh.P("data", "model"), (5, 8), mesh) == \
        sh.P(None, "model")
    assert sh.sanitize_spec(sh.P(("data", "model"), None, "pod"),
                            (8, 3, 4), mesh) == sh.P(("data", "model"),
                                                     None, None)


# ----------------------------------------------------------- placement --
def test_device_put_views_on_one_device_and_gather():
    """Every position on one device: blocks are views of the tensor, and
    ``gather`` returns the tensor itself; ``refresh_`` writes an update
    back into copies and into replaced plain tensors."""
    mesh = _mesh("2x2x2")
    t = torch.arange(64.0).reshape(8, 8)
    s = sh.NamedSharding(mesh, sh.P(("pod", "data"), "model"))
    placed = sh.device_put({"w": t}, {"w": s})["w"]
    assert len(placed.blocks) == 8
    for pos, idx in s.indices_map(t.shape).items():
        blk = placed.blocks[pos]
        assert blk.shape == s.shard_shape(t.shape)
        assert blk.data_ptr() == t[idx].data_ptr()
        assert torch.equal(blk, t[idx])
    assert sh.gather(placed) is t
    copy = sh.Placed(s, t.shape, t.dtype,
                     {p: b.clone() for p, b in placed.blocks.items()})
    assert torch.equal(sh.gather(copy), t)
    t2 = t * 2
    sh.refresh_(copy, t2)
    assert torch.equal(sh.gather(copy), t2)
    step = torch.zeros((), dtype=torch.int32)
    sh.refresh_({"step": step}, {"step": torch.tensor(3, dtype=torch.int32)})
    assert int(step) == 3


def test_remesh_live_equals_reference_shards(ref):
    """``test_elastic_reshard_grow_and_shrink``'s tree through (2, 2) →
    (2, 2, 2) → (2, 2), and minitron's smoke parameters (the port's
    per-layer tensors, each a layer of the reference's stacked leaf)
    through (2, 2) → (2, 2, 2): every position's block equals jax's shard
    on the device at that coordinate, bit for bit, and so does the
    gathered tree."""
    _, arrays = ref
    m2 = sh.Mesh((2, 2), ("data", "model"), "cpu")
    m3 = _mesh("2x2x2")
    p = {"layers": {"attn": {"wq": torch.arange(64.0).reshape(8, 8)}}}
    p1 = sh.device_put(p, sh.param_shardings(m2, p))
    p2 = elastic.remesh_live(p1, m3)
    p3 = elastic.remesh_live(p2, m2)
    for tag, t in (("m2", p1), ("m3", p2), ("back", p3)):
        placed = t["layers"]["attn"]["wq"]
        for pos, blk in placed.blocks.items():
            want = arrays[f"elastic/wq/{tag}/" + "_".join(map(str, pos))]
            np.testing.assert_array_equal(blk.numpy(), want)
        np.testing.assert_array_equal(sh.gather(placed).numpy(),
                                      np.arange(64.0).reshape(8, 8))

    from repro_torch.models.convert import transformer_params_from_jax

    cfg = get_smoke_config("minitron_8b")
    prefix = "minitron/"
    ref_tree = {}
    for key, val in arrays.items():
        if key.startswith(prefix):
            node = ref_tree
            *head, last = key[len(prefix):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = val
    model = transformer_params_from_jax(ref_tree, cfg, device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    layout = param_layout(model)
    q1 = sh.device_put(params, sh.param_shardings(m2, params))
    q2 = elastic.remesh_live(q1, m3)
    for tag, tree in (("m2", q1), ("m3", q2)):
        for path, names in layout.items():
            for ix in np.ndindex(names.shape):
                placed = tree[names[ix]]
                s = placed.sharding
                lead = (s.leaf.indices_map(s.leaf_shape) if ix else None)
                for pos, blk in placed.blocks.items():
                    want = arrays[f"elastic/minitron/{tag}/{_ref_name(path)}"
                                  f"/" + "_".join(map(str, pos))]
                    if ix:
                        start = [sl.start or 0 for sl in lead[pos][:len(ix)]]
                        want = want[tuple(i - s0 for i, s0 in zip(ix,
                                                                  start))]
                    np.testing.assert_array_equal(blk.numpy(), want)
                held = sum(b is not None for b in
                           s.indices_map(params[names[ix]].shape).values())
                assert len(placed.blocks) == held
        whole = sh.gather(tree)
        for k, v in params.items():
            assert torch.equal(whole[k], v)


def test_degrade_plan_equals_reference(ref):
    res, _ = ref
    for n, shape, want in res["degrade"]:
        assert list(elastic.degrade_plan(n, tuple(shape))) == want


# --------------------------------------------------------- compression --
def _tree_from(arrays, prefix):
    tree = {}
    for key, val in arrays.items():
        if key.startswith(prefix):
            node = tree
            *head, last = key[len(prefix):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = torch.from_numpy(np.array(val))
    return tree


@pytest.mark.parametrize("label", ["zero", "err"])
def test_compress_tree_equals_reference_bit_for_bit(ref, label):
    _, arrays = ref
    rng = np.random.default_rng(3)
    tree = {"a": torch.from_numpy(
                rng.standard_normal((16, 8)).astype(np.float32) * 0.1),
            "b": {"c": torch.from_numpy(
                rng.standard_normal((33,)).astype(np.float32))}}
    err = {"a": torch.from_numpy(
               rng.standard_normal((16, 8)).astype(np.float32) * 1e-3),
           "b": {"c": torch.from_numpy(
               rng.standard_normal((33,)).astype(np.float32) * 1e-2)}}
    if label == "zero":
        err = compress.init_error_state(tree)
    q, s, e = compress.compress_tree(tree, err)
    back = compress.decompress_tree(q, s)
    for k, got in (("q", q), ("s", s), ("e", e), ("back", back)):
        want = _tree_from(arrays, f"compress/{label}/{k}/")
        for path in (("a",), ("b", "c")):
            g, w = got, want
            for p in path:
                g, w = g[p], w[p]
            assert g.dtype == w.dtype, (k, path)
            assert torch.equal(g, w), (k, path)


@pytest.mark.parametrize("label", ["shardmap", "seeded"])
def test_crosspod_mean_equals_reference_bit_for_bit(ref, label):
    """The reference reduces over ``pod`` inside ``shard_map`` with g
    split ``P("pod", "data")`` over a (4, 2) mesh: each data column block
    is one reduction over the 4 pods. The port takes the 4 members of
    each block; both results agree bit for bit, and lie within the
    reference test's bound of the fp32 mean."""
    _, arrays = ref
    g = torch.from_numpy(arrays[f"crosspod/{label}/g"])
    err = torch.from_numpy(arrays[f"crosspod/{label}/err"])
    out = torch.empty_like(g)
    err2 = torch.empty_like(g)
    for j in range(2):
        cols = slice(4 * j, 4 * j + 4)
        outs, errs = compress.crosspod_mean_compressed(
            [{"g": g[i:i + 1, cols]} for i in range(4)],
            [{"g": err[i:i + 1, cols]} for i in range(4)], axis="pod")
        for i in range(4):
            out[i:i + 1, cols] = outs[i]["g"]
            err2[i:i + 1, cols] = errs[i]["g"]
    assert torch.equal(out, torch.from_numpy(arrays[f"crosspod/{label}/out"]))
    assert torch.equal(err2,
                       torch.from_numpy(arrays[f"crosspod/{label}/err2"]))
    if label == "shardmap":
        mean = g.reshape(4, 1, 8).mean(0).expand(4, 8)
        bound = float(g.abs().max()) / 127.0 + 1e-6
        assert float((out - mean).abs().max()) <= 2 * bound
