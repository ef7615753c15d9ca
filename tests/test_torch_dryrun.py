"""The port's dry run and report (``repro_torch.launch.{dryrun,report}``)
on the CPU, on smoke configs traced on ``meta``.

- ``skip_reason``, ``DEFAULT_MICROBATCHES`` and the train/prefill input
  specs equal the reference's for every (arch × shape) cell;
- ``run_cell`` into ``tmp_path`` on every family's smoke config (head dim
  64, the smallest K5 is built for; ``attn_chunk`` 1024 as at published
  size, so the backward walks few key chunks) at each shape on the
  production meshes: status ``ok`` and the reference's JSON keys, less
  ``compile_s`` (``trace_s`` instead) and ``xla_cost_analysis``;
  ``arguments`` the largest position's blocks, the rest the global
  program over ``n_chips``; an MoE smoke config with 16 experts takes the
  expert-parallel path on (16, 16);
- a cell whose step cannot run on the card (head dim 48) is ``FAIL`` with
  its traceback; ``--reanalyze`` gives the same roofline from the saved
  counts; the command line writes one cell;
- the tables, the hill-climb picks, the fused-attention projection and
  ``build_experiments_md`` render from the cells.
"""
import json
import os

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_config
from repro.models import api as japi
from repro.models.config import ALL_SHAPES as J_SHAPES
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import report as R
from repro_torch.models.config import ALL_SHAPES, TRAIN_4K

SHAPES = {s.name: s for s in ALL_SHAPES}


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's ``repro.launch.dryrun``. Importing it sets
    ``XLA_FLAGS`` to 512 host devices; jax is initialised first so that
    this process keeps its device count, and the variable is restored."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun

    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return dryrun


@pytest.fixture(autouse=True)
def _no_leaked_activation_context():
    from repro.dist import sharding

    sharding._ctx.state = None


def _smoke(arch, **kw):
    cfg = get_smoke_config(arch)
    if cfg.n_heads:
        cfg = cfg.scaled(d_head=64)
    return cfg.scaled(attn_chunk=1024, **kw)


# ------------------------------------------------------- the reference's --
@pytest.mark.parametrize("shape", [s.name for s in ALL_SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_skip_reason_and_specs_equal_the_references(ref_dryrun, arch, shape):
    j_shape = next(s for s in J_SHAPES if s.name == shape)
    assert D.skip_reason(get_config(arch), SHAPES[shape]) == \
        ref_dryrun.skip_reason(j_config(arch), j_shape)
    if SHAPES[shape].kind == "decode":
        got = D.input_specs(get_config(arch), SHAPES[shape])["token"]
        want = japi.decode_input_specs(j_config(arch), j_shape)["token"]
        assert tuple(got.shape) == tuple(want.shape)
        return
    got = D.input_specs(get_config(arch), SHAPES[shape])
    want = japi.train_input_specs(j_config(arch), j_shape)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(v.dtype), k


def test_default_microbatches_are_the_references(ref_dryrun):
    assert D.DEFAULT_MICROBATCHES == ref_dryrun.DEFAULT_MICROBATCHES


# ------------------------------------------------------------- the cells --
REF_KEYS = {"arch", "shape", "mesh", "status", "microbatches", "kind",
            "compile_s", "n_chips", "bytes_per_device", "roofline",
            "collectives", "collective_count", "xla_cost_analysis", "params"}
CELLS = [(a, s) for a in ARCHS for s in ("train_4k", "prefill_32k",
                                         "decode_32k")] + [
    ("mamba2_130m", "long_500k"), ("zamba2_7b", "long_500k")]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Every cell of :data:`CELLS` on smoke configs, single mesh, and
    gemma2's and mamba2's on the multi-pod mesh, in one directory."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    got = {}
    for arch, shape in CELLS:
        got[arch, shape, "single"] = D.run_cell(
            arch, SHAPES[shape], False, config=_smoke(arch), out_dir=str(out))
    for arch in ("gemma2_9b", "mamba2_130m"):
        got[arch, "prefill_32k", "multi"] = D.run_cell(
            arch, SHAPES["prefill_32k"], True, config=_smoke(arch),
            out_dir=str(out))
    return out, got


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_is_ok_with_the_references_keys(cells, arch, shape):
    out, got = cells
    cell = got[arch, shape, "single"]
    assert cell["status"] == "ok", cell.get("traceback")
    assert REF_KEYS - {"compile_s", "xla_cost_analysis"} <= set(cell)
    assert "compile_s" not in cell and "xla_cost_analysis" not in cell
    assert cell["trace_s"] >= 0 and cell["per_device"] == D.PER_DEVICE
    assert cell["n_chips"] == 256 and cell["device"] == "meta"
    assert set(cell["bytes_per_device"]) == {"arguments", "output", "temp",
                                             "alias", "peak_live"}
    b = cell["bytes_per_device"]
    assert b["peak_live"] == b["arguments"] + b["temp"] and b["arguments"] > 0
    assert set(cell["roofline"]) == set(H.Roofline.__dataclass_fields__)
    assert cell["collectives"] == {} and cell["collective_count"] == 0
    assert cell["roofline"]["collective_s"] == 0.0
    assert cell["kind"] == SHAPES[shape].kind
    with open(out / f"{arch}_{shape}_single.json") as f:
        assert json.load(f) == json.loads(json.dumps(cell))
    k5 = cell["by_op"].get("flash_attention", {}).get("calls", 0)
    attends = bool(get_smoke_config(arch).n_heads) and \
        SHAPES[shape].kind != "decode"
    assert (k5 > 0) == attends


@pytest.mark.parametrize("arch", ["gemma2_9b", "mamba2_130m"])
def test_multi_pod_cell_divides_over_512_positions(cells, arch):
    _, got = cells
    single = got[arch, "prefill_32k", "single"]
    multi = got[arch, "prefill_32k", "multi"]
    assert multi["status"] == "ok" and multi["n_chips"] == 512
    assert multi["roofline"]["flops_per_dev"] * 2 == \
        single["roofline"]["flops_per_dev"]
    assert multi["by_op"] == single["by_op"]


def test_per_device_counts_are_the_global_program_over_the_positions():
    cfg = _smoke("gemma2_9b")
    mesh = D.make_production_mesh(device="meta")
    kind, stats, args, _ = D.trace_cell(cfg, SHAPES["prefill_32k"], mesh)
    cell = D.run_cell("gemma2_9b", SHAPES["prefill_32k"], False, save=False,
                      config=cfg)
    assert kind == "prefill"
    assert cell["roofline"]["flops_per_dev"] == stats.flops / 256
    assert cell["bytes_per_device"]["temp"] == stats.temp_bytes // 256
    assert cell["bytes_per_device"]["arguments"] == args


def test_arguments_are_the_largest_positions_blocks():
    """The parameter, AdamW and batch blocks of the largest position,
    summed from the shard shapes as ``chip_smoke.py`` phase 13 (a) does
    for the parameters alone."""
    from repro_torch.models import api
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    cfg = _smoke("gemma2_9b")
    mesh = D.make_production_mesh(device="meta")
    model = api.init_params(None, cfg, device="meta")
    params = dict(model.named_parameters())
    state = opt.init_opt_state(params, opt.OptConfig())
    batch = D.input_specs(cfg, TRAIN_4K)
    (p_sh, o_sh, b_sh), _ = ts.shardings_for_train(mesh, params, state, batch)
    index = {pos: i for i, pos in enumerate(mesh.positions())}
    per_pos = np.zeros(mesh.size)
    for tree, shs in ((params, p_sh), (state["mu"], o_sh["mu"]),
                      (state["nu"], o_sh["nu"]), (batch, b_sh)):
        for name, t in tree.items():
            s = shs[name]
            block = int(np.prod(s.shard_shape(t.shape))) * t.element_size()
            for pos, idx in s.indices_map(t.shape).items():
                if idx is not None:
                    per_pos[index[pos]] += block
    per_pos += state["step"].element_size()   # replicated everywhere
    got = D._largest_position_bytes(
        mesh, [(params, p_sh), (state, o_sh), (batch, b_sh)])
    assert got == int(per_pos.max())


def test_moe_cell_takes_the_expert_parallel_path():
    """16 experts divide the (16, 16) mesh's model axis: the exchange
    traces on meta, the 16·16 groups dispatched together and each model
    rank's expert run once over every batch block (every position on
    one device): three products a rank and a layer."""
    cell = D.run_cell("qwen3_moe_235b_a22b", SHAPES["prefill_32k"], False,
                      save=False, config=_smoke("qwen3_moe_235b_a22b",
                                                n_experts=16))
    assert cell["status"] == "ok", cell.get("traceback")
    assert cell["by_op"]["aten.bmm"]["calls"] == 3 * 16 * 2


def test_untraceable_cell_fails_with_its_traceback(tmp_path):
    cfg = get_smoke_config("gemma2_9b").scaled(d_head=48)
    cell = D.run_cell("gemma2_9b", SHAPES["prefill_32k"], False,
                      config=cfg, out_dir=str(tmp_path))
    assert cell["status"].startswith("FAIL: ValueError: flash_attention")
    assert "head dim 48" in cell["status"]
    assert cell["traceback"].endswith(
        "ValueError: flash_attention_fused: head dim 48 not in "
        "(64, 112, 128, 256)\n")
    assert "dryrun.py" in cell["traceback"]
    assert (tmp_path / "gemma2_9b_prefill_32k_single.json").exists()


def test_reanalyze_gives_the_same_roofline(tmp_path):
    cell = D.run_cell("mamba2_130m", SHAPES["prefill_32k"], False,
                      config=_smoke("mamba2_130m"), out_dir=str(tmp_path))
    path = tmp_path / "mamba2_130m_prefill_32k_single.json"
    saved = json.loads(path.read_text())
    saved["roofline"] = {}
    path.write_text(json.dumps(saved))
    D.reanalyze_saved(str(tmp_path))
    assert json.loads(path.read_text())["roofline"] == cell["roofline"]


def test_command_line_writes_a_cell(tmp_path, capsys):
    D.main(["--arch", "mamba2_130m", "--shape", "decode_32k", "--out-dir",
            str(tmp_path), "--override", "n_layers=1", "--override",
            "d_model=64", "--override", "vocab=512"])
    assert "[dryrun] mamba2_130m decode_32k single: ok" in \
        capsys.readouterr().out
    cell = json.loads((tmp_path / "mamba2_130m_decode_32k_single.json")
                      .read_text())
    assert cell["status"] == "ok" and cell["kind"] == "decode"


# ------------------------------------------------------------ the report --
def test_tables_render_every_cell(cells):
    out, got = cells
    roof = R.roofline_table("single", str(out)).splitlines()
    dry = R.dryrun_table("single", str(out)).splitlines()
    ok = [k for k in got if k[2] == "single"]
    assert len(roof) == 2 + len(ok) and len(dry) == 2 + len(ok)
    for line in roof[2:] + dry[2:]:
        assert line.count("|") == roof[0].count("|") or \
            line.count("|") == dry[0].count("|")
    assert "| gemma2_9b | train_4k | train |" in "\n".join(roof)
    assert len(R.dryrun_table("multi", str(out)).splitlines()) == 4


def test_fused_projection_puts_the_unfused_chain_in_place_of_k5(cells):
    out, got = cells
    lines = R.fused_attention_projection(str(out)).splitlines()
    rows = [ln for ln in lines[2:] if ln.startswith("| gemma2_9b | train_4k")]
    assert len(rows) == 1
    cell = got["gemma2_9b", "train_4k", "single"]
    hbm = H.Hardware().hbm_bw
    k5 = cell["by_op"]["flash_attention"]["bytes"] / 256 / hbm
    unfused = R._unfused_bytes(cell["kernel_calls"]["flash_attention"],
                               1024) / 256 / hbm
    mem = cell["roofline"]["memory_s"]
    ratio = (mem - k5 + unfused) / mem
    assert rows[0].endswith(f"| {ratio:.2f}× |")
    assert ratio > 1


def test_pick_hillclimb_cells(cells):
    out, _ = cells
    picks = R.pick_hillclimb_cells(str(out))
    assert [p[0] for p in picks] == ["worst-roofline-fraction",
                                    "most-collective-bound",
                                    "paper-representative"]
    assert picks[2][1] == ("qwen3_moe_235b_a22b", "train_4k")


def test_build_experiments_md_fills_the_placeholders(cells, tmp_path):
    out, _ = cells
    path = tmp_path / "EXPERIMENTS.md"
    path.write_text("# E\n<!-- ROOFLINE_TABLE -->\n<!-- DRYRUN_TABLE_SINGLE "
                    "-->\n<!-- DRYRUN_TABLE_MULTI -->\n<!-- PERF_FUSED_TABLE "
                    "-->\n")
    R.build_experiments_md(str(path), str(out))
    text = path.read_text()
    assert "<!--" not in text
    assert "### Single-pod (16×16 = 256 positions)" in text
    assert "### Multi-pod (2×16×16 = 512 positions)" in text
    assert R.roofline_table("single", str(out)) in text
    assert R.fused_attention_projection(str(out)) in text
