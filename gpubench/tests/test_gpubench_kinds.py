"""Model kinds found by name: each kind's module gives the interface
``gpubench/models/__init__.py`` documents, and a kind the benchmark
does not have joins it as new files alone."""
import hashlib
import json
import pathlib
import shutil

import pytest
import torch

from gpubench import cells, harness, models
from gpubench.reference import gnn as ref

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = ROOT / "gpubench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
KINDS = sorted(p.stem for p in (HERE / "models").glob("*.py")
               if p.stem != "__init__")
FUNCTIONS = ("draw_params", "build_train", "train_args", "module", "leaves",
             "register", "step_flops")
CPU = torch.device("cpu")


def _configuration(kind):
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        if cfg["model"] == kind:
            return cfg
    return None


@pytest.mark.parametrize("kind", KINDS)
def test_kind_module_exposes_the_interface(kind):
    mod = cells.model_kind({"model": kind})
    for name in FUNCTIONS:
        assert callable(getattr(mod, name)), name
        assert f"``{name}(" in models.__doc__, name
    assert mod.WIDTHS in ("dims", None)
    model = cells.reference({"model": kind})
    assert isinstance(model.KEYS, tuple) and model.KEYS
    assert callable(model.graph_terms) and callable(model.forward)
    cfg = _configuration(kind)
    if cfg is None:
        return
    # The program's model holds the drawn layers, leaf for leaf in the
    # reference's order.
    layers = mod.draw_params(cfg, 5, CPU)
    assert all(set(layer) <= set(model.KEYS) for layer in layers)
    want = ref.leaves(layers, model.KEYS)
    got = mod.leaves(mod.module(cfg, layers, CPU))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.detach(), w, rtol=0, atol=0)
    g = cfg["graph"]
    assert mod.step_flops(g["m"], round(g["m"] * g["avg_row"]), cfg) > 0


# A one-layer scaled GCN, ``s · Â (X W)``: a kind the benchmark does not
# have, with a parameter name of its own.
NEW_KIND = '''"""A one-layer scaled GCN: ``s · Â (X W)``."""
import torch

from gpubench import cells, work

WIDTHS = "dims"
REFERENCE = "scaled_gcn"


def draw_params(cfg, seed, dev):
    (w,) = cells.draw_weights(cfg["dims"], seed, dev)
    return [{"w": w, "scale": torch.full((), 0.5, device=dev)}]


def build_train(world, spec):
    from repro_torch.models.gnn import GraphOps, gcn_norm_edges

    world.gops = GraphOps(world.csr, spec=spec)
    world.norm = torch.from_numpy(gcn_norm_edges(world.csr)).to(world.dev)


def train_args(world):
    return (world.norm,)


class Scaled(torch.nn.Module):
    def __init__(self, w, scale):
        super().__init__()
        self.w = torch.nn.Parameter(w.clone())
        self.scale = torch.nn.Parameter(scale.clone())

    def forward(self, g, x, vals):
        return self.scale * g.spmm(vals, x @ self.w)


def module(cfg, layers, dev):
    return Scaled(layers[0]["w"], layers[0]["scale"]).to(dev)


def leaves(model):
    return [model.w, model.scale]


def register(service, name, csr, model):
    raise NotImplementedError("this kind is trained, not served")


def step_flops(n, nnz, cfg):
    d_in, d_out = cfg["dims"]
    return 2 * work.dense_flops(n, d_in, d_out) + 2 * (2.0 * nnz * d_out)
'''

NEW_REFERENCE = '''"""Plain PyTorch scaled GCN: ``s · Â (X W)``."""
import torch

from .gcn import gcn_norm
from .gnn import aggregate

KEYS = ("w", "scale")


def graph_terms(e):
    return gcn_norm(e)


def forward(layers, e, x, dtype=torch.float32, terms=None):
    (layer,) = layers
    v = (gcn_norm(e) if terms is None else terms).to(dtype)
    h = aggregate(e, v, x.to(dtype) @ layer["w"].to(dtype))
    return layer["scale"].to(dtype) * h
'''

NEW_CONFIG = {
    "source": "https://arxiv.org/abs/1609.02907",
    "model": "scaled_gcn",
    "num_nodes": 300, "num_features": 12, "num_classes": 5,
    "hidden_channels": 5, "num_layers": 1, "dims": [12, 5],
    "graph": {"generator": "power_law", "m": 300, "k": 300,
              "avg_row": 6.0, "alpha": 1.8, "seed": 4},
    "exec_spec": {"tune": "off"},
    "tune_cache": "build/gpubench/tune_cache",
    "optimizer": {"kind": "sgd", "lr": 0.2},
    "reduced": []}

NEW_LIMITS = {"limits": {"loss_gap": 1e-5, "grad_gap": 1e-3,
                         "update_gap": 1e-3}}


def _digests(folder: pathlib.Path) -> dict[str, str]:
    """Each file's digest, bytecode caches left out."""
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(folder.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_kind_needs_only_new_files(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    here = root / "gpubench"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(here)

    added = {"models/scaled_gcn.py": NEW_KIND,
             "reference/scaled_gcn.py": NEW_REFERENCE,
             "configs/scaled_gcn_tiny.json": json.dumps(NEW_CONFIG),
             "limits/scaled_gcn_tiny.train.json": json.dumps(NEW_LIMITS)}
    for rel, text in added.items():
        assert not (here / rel).exists(), rel
        (here / rel).write_text(text)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "scaled_gcn_tiny", "source": NEW_CONFIG["source"],
        "file": "gpubench/configs/scaled_gcn_tiny.json", "reduced": [],
        "why": "a kind added as new files"})
    bench["workloads"].append({
        "name": "scaled_gcn_tiny.train", "config": "scaled_gcn_tiny",
        "traffic": "train_fullbatch", "chips": 1,
        "why": "full-batch steps of the added kind"})
    step = next(m for m in bench["end_to_end"]
                if m["name"] == "train_step_ms")
    step["workloads"].append("scaled_gcn_tiny.train")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))

    monkeypatch.setattr(cells, "ROOT", root)
    monkeypatch.setattr(cells, "HERE", here)
    out = harness.run_cell("scaled_gcn_tiny.train", 2147483659, 0.3, False,
                           CPU)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "train_step_ms"}
    assert {k: c["limit"] for k, c in out["checks"].items()} == \
        NEW_LIMITS["limits"]
    # The comparison reads the added kind: a step that leaves the state
    # unchanged fails it.
    from repro_torch.models import gnn

    monkeypatch.setattr(gnn, "sgd_step", lambda model, lr: None)
    out = harness.run_cell("scaled_gcn_tiny.train", 2147483659, 0.3, False,
                           CPU)
    assert not out["correct"]

    after = _digests(here)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(added)
