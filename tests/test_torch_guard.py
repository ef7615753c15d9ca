"""The port stands alone and never hides the device.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or the reference package ``repro`` (AST scan), and importing
  every module of the port loads no ``jax`` and builds no kernel.
* Entry points default to the card: without one they raise instead of
  running on the CPU (the operators, the GNN and language-model
  converters, the constructors of every model family,
  ``api.init_params``/``init_cache``, ``launch.serve.generate`` (dense,
  MoE and audio), and the serving tier: ``GraphRegistry``,
  ``SparseEngine``, ``BatchedSpMM``/``BatchedSDDMM``, ``GNNService``),
  and ``chip_smoke.py`` exits non-zero and prints no result.
  The sharded path (``ShardMesh``, a partition's uploads,
  ``ShardedSpMM``/``ShardedSDDMM``, ``DistGraphOps``, ``mesh=``) and
  ``explain_*(measure=True)`` default to the card the same way.
* Every family of ``configs.ARCHS`` routes through all of
  ``models.api``'s entry points on the CPU.
"""
import ast
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.api import ExecSpec
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.core.sddmm import LibraSDDMM
from repro_torch.core.spmm import LibraSpMM
from repro_torch.launch.serve import generate
from repro_torch.models import api, convert
from repro_torch.models.gnn import GraphOps
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.mamba2 import Mamba2LM
from repro_torch.models.moe import MoETransformer
from repro_torch.models.transformer import Transformer
from repro_torch.models.whisper import Whisper
from repro_torch.sparse import mixed_csr
from repro_torch.tune.model import TuneConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_reference_imports(path):
    bad = {name for name in _imported_modules(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_import_loads_no_jax_and_builds_nothing():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "from repro_torch.kernels import _build\n"
        "print(json.dumps({'jax': sorted(k for k in sys.modules"
        " if k.split('.')[0] in ('jax', 'jaxlib', 'repro')),"
        " 'built': _build.library.cache_info().currsize}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report == {"jax": [], "built": 0}


@pytest.mark.parametrize("entry", ["spmm", "sddmm", "graph",
                                   "batched_spmm", "batched_sddmm"])
def test_default_spec_raises_without_a_card(entry, monkeypatch):
    from repro_torch.dist.sparse import BatchedSDDMM, BatchedSpMM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = mixed_csr(24, 24, seed=1)
    assert ExecSpec().device == "cuda" and ExecSpec().backend == "cuda"
    cls = {"spmm": LibraSpMM, "sddmm": LibraSDDMM, "graph": GraphOps,
           "batched_spmm": BatchedSpMM,
           "batched_sddmm": BatchedSDDMM}[entry]
    with pytest.raises(RuntimeError, match="is_available"):
        cls(a)


@pytest.mark.parametrize("entry", ["GraphRegistry", "SparseEngine",
                                   "GNNService"])
def test_serving_entry_points_raise_without_a_card(entry, monkeypatch):
    from repro_torch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "GraphRegistry": lambda: serve.GraphRegistry(),
        "SparseEngine": lambda: serve.SparseEngine(serve.GraphRegistry()),
        "GNNService": lambda: serve.GNNService(
            serve.SparseEngine(serve.GraphRegistry())),
    }
    with pytest.raises(RuntimeError, match="is_available"):
        calls[entry]()


@pytest.mark.parametrize("entry", ["ShardMesh", "partition_upload",
                                   "partition_stacked_upload",
                                   "ShardedSpMM", "ShardedSDDMM",
                                   "DistGraphOps", "register_mesh",
                                   "explain_measure"])
def test_sharded_and_explain_entry_points_raise_without_a_card(
        entry, monkeypatch):
    from repro_torch import serve
    from repro_torch.dist import (DistGraphOps, ShardedSDDMM, ShardedSpMM,
                                  ShardMesh, partition_spmm)
    from repro_torch.obs.explain import explain_spmm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = mixed_csr(24, 24, seed=1)
    cpu = ExecSpec(device="cpu")
    calls = {
        "ShardMesh": lambda: ShardMesh.round_robin(2),
        "partition_upload": lambda: partition_spmm(a, 2, spec=cpu).arrays(0),
        "partition_stacked_upload": lambda: partition_spmm(
            a, 2, spec=cpu).stacked_arrays(),
        "ShardedSpMM": lambda: ShardedSpMM(a, ShardMesh.round_robin(2)),
        "ShardedSDDMM": lambda: ShardedSDDMM(a, ShardMesh.round_robin(2)),
        "DistGraphOps": lambda: DistGraphOps(a, ShardMesh.round_robin(2)),
        "register_mesh": lambda: serve.GraphRegistry(device="cpu").register(
            a, name="g", mesh=ShardMesh.round_robin(2)),
        "explain_measure": lambda: explain_spmm(a, measure=True),
    }
    with pytest.raises(RuntimeError, match="is_available"):
        calls[entry]()


def _dense_tree(cfg):
    """A reference-layout parameter tree of zeros (layers stacked)."""
    shapes = {name: tuple(t.shape) for name, t in Transformer(
        cfg, device="cpu").layers[0].named_parameters()}
    layers = {"attn_norm": {}, "attn": {}, "mlp_norm": {}, "mlp": {}}
    for name, shape in shapes.items():
        group, _, leaf = name.partition(".")
        layers[group][leaf or "scale"] = np.zeros((cfg.n_layers, *shape),
                                                  np.float32)
    return {"embed": {"embedding": np.zeros((cfg.vocab_padded, cfg.d_model),
                                            np.float32)},
            "layers": layers,
            "final_norm": {"scale": np.zeros(cfg.d_model, np.float32)}}


@pytest.mark.parametrize("entry", [
    "gcn_params_from_jax", "agnn_params_from_jax",
    "transformer_params_from_jax", "Transformer", "init_params",
    "init_cache", "generate", "moe_params_from_jax", "MoETransformer",
    "moe_init_params", "moe_generate", "Mamba2LM", "HybridLM", "Whisper",
    "vlm_Transformer", "mamba2_params_from_jax", "hybrid_params_from_jax",
    "whisper_params_from_jax", "ssm_init_cache", "audio_generate"])
def test_model_entry_points_raise_without_a_card(entry, monkeypatch):
    cfg = get_smoke_config("gemma2-9b")
    moe_cfg = get_smoke_config("moonshot-v1-16b-a3b")
    smoke = {f: get_smoke_config(a) for f, a in (
        ("ssm", "mamba2-130m"), ("hybrid", "zamba2-7b"),
        ("audio", "whisper-tiny"), ("vlm", "qwen2-vl-7b"))}
    tree = _dense_tree(cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gnn_params = [{"w": np.ones((4, 3), np.float32),
                   "beta": np.float32(1.0)}]
    calls = {
        "gcn_params_from_jax": lambda: convert.gcn_params_from_jax(
            [{"w": gnn_params[0]["w"]}]),
        "agnn_params_from_jax": lambda: convert.agnn_params_from_jax(
            gnn_params),
        "transformer_params_from_jax":
            lambda: convert.transformer_params_from_jax(tree, cfg),
        "Transformer": lambda: Transformer(
            cfg, generator=torch.Generator().manual_seed(0)),
        "init_params": lambda: api.init_params(
            torch.Generator().manual_seed(0), cfg),
        "init_cache": lambda: api.init_cache(cfg, 1, 8),
        "generate": lambda: generate(cfg, 1, 2, 2),
        "moe_params_from_jax": lambda: convert.moe_params_from_jax(
            None, moe_cfg),
        "MoETransformer": lambda: MoETransformer(
            moe_cfg, generator=torch.Generator().manual_seed(0)),
        "moe_init_params": lambda: api.init_params(
            torch.Generator().manual_seed(0), moe_cfg),
        "moe_generate": lambda: generate(moe_cfg, 1, 2, 2),
        "Mamba2LM": lambda: Mamba2LM(
            smoke["ssm"], generator=torch.Generator().manual_seed(0)),
        "HybridLM": lambda: HybridLM(
            smoke["hybrid"], generator=torch.Generator().manual_seed(0)),
        "Whisper": lambda: Whisper(
            smoke["audio"], generator=torch.Generator().manual_seed(0)),
        "vlm_Transformer": lambda: Transformer(
            smoke["vlm"], generator=torch.Generator().manual_seed(0)),
        "mamba2_params_from_jax": lambda: convert.mamba2_params_from_jax(
            None, smoke["ssm"]),
        "hybrid_params_from_jax": lambda: convert.hybrid_params_from_jax(
            None, smoke["hybrid"]),
        "whisper_params_from_jax": lambda: convert.whisper_params_from_jax(
            None, smoke["audio"]),
        "ssm_init_cache": lambda: api.init_cache(smoke["ssm"], 1, 8),
        "audio_generate": lambda: generate(smoke["audio"], 1, 2, 2),
    }
    with pytest.raises(RuntimeError, match="is_available"):
        calls[entry]()


def test_dense_tree_round_trips_on_cpu():
    cfg = get_smoke_config("granite-34b")
    model = convert.transformer_params_from_jax(_dense_tree(cfg), cfg,
                                                device="cpu")
    assert all(not p.any() for p in model.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_routes_through_the_api(arch):
    """``init_params``, ``forward_logits``, ``loss_fn``, ``init_cache``
    and ``decode_step`` on the CPU for each config's smoke size: finite
    logits of the right shape from both paths."""
    cfg = get_smoke_config(arch)
    model = api.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    b, s = 2, 32
    tokens = torch.randint(0, cfg.vocab, (b, s),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.family == "audio":
        batch["frame_embeds"] = torch.randn(b, cfg.n_audio_ctx, cfg.d_model)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(b, cfg.n_patches, cfg.d_model)
    with torch.no_grad():
        logits, _ = api.forward_logits(model, batch, cfg)
        loss = api.loss_fn(model, batch, cfg)
        cache = api.init_cache(cfg, b, 4, dtype=torch.float32, device="cpu")
        step, cache = api.decode_step(model, cache, tokens[:, :1], 1, cfg)
    assert logits.shape == (b, s, cfg.vocab) and step.shape == (b, 1,
                                                                 cfg.vocab)
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()
    assert torch.isfinite(loss)


def test_spec_takes_only_off_or_a_tune_config():
    """The reference's default (``tune="model"``), ``"search"`` timed on
    the kernel backend by default, ``"off"`` and literal configs."""
    assert ExecSpec(device="cpu").tune == "model"
    assert ExecSpec(device="cpu").tune_backend == "cuda"
    assert ExecSpec(tune="search", device="cpu").tune == "search"
    assert ExecSpec(tune="off", device="cpu").tune == "off"
    assert ExecSpec(tune=TuneConfig(ts=0), device="cpu").tune.ts == 0
    with pytest.raises(ValueError):
        ExecSpec(tune="fast", device="cpu")
    with pytest.raises(ValueError, match="tune_backend"):
        ExecSpec(tune_backend="xla", device="cpu")
    with pytest.raises(TypeError):
        ExecSpec(interpret=True)   # the TPU knob has no counterpart


def test_spec_takes_reorder_off_or_on():
    assert ExecSpec(device="cpu").reorder == "off"
    assert ExecSpec(reorder="on", device="cpu").reorder == "on"
    assert ExecSpec(reorder="auto", device="cpu").reorder == "auto"
    with pytest.raises(ValueError):
        ExecSpec(reorder="yes", device="cpu")


def _run_smoke(cwd: pathlib.Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def _printed_result(stdout: str) -> bool:
    return any(line.startswith("{") and '"ok"' in line
               for line in stdout.splitlines())


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)
    assert "is_available" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)


def test_plans_stay_host_side_until_first_use():
    a = mixed_csr(40, 40, seed=2)
    op = LibraSpMM(a, spec=ExecSpec(device="cpu"))
    assert not op.arrays._dev
    op(torch.from_numpy(np.ones((40, 3), np.float32)))
    assert set(op.arrays._dev) == set(op.arrays.backend_keys("cuda"))
