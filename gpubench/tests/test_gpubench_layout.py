"""The benchmark's files: found by name from data alone, within the
contract's limits, and free of JAX and of the package the port was
made from."""
import ast
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = ROOT / "gpubench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SOURCES = sorted(HERE.rglob("*.py"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\t\n\r]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: pathlib.Path) -> set[str]:
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
def test_no_jax_or_reference_package_imports(path):
    # Top-level names compared whole: ``repro_torch`` is not ``repro``.
    bad = {n for n in _imports(path) if n.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


@pytest.mark.parametrize(
    "path", sorted((HERE / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    bad = {n for n in _imports(path)
           if n.split(".")[0] in ("repro_torch", "gpubench")}
    assert not bad, f"{path.name} imports {sorted(bad)}"


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_from_data_alone(cell):
    cfg = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert (ROOT / cfg["file"]).is_file()
    assert cfg["file"] == f"gpubench/configs/{cell['config']}.json"
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    assert mix["kind"] in ("train", "serve")
    limits = json.loads((HERE / "limits" / f"{cell['name']}.json")
                        .read_text())["limits"]
    assert limits and all(v > 0 for v in limits.values())
    assert cell["chips"] == 1


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_found_by_name(metric):
    from gpubench import harness

    assert callable(harness.reader(metric["name"]))


def test_configuration_files_hold_their_model():
    from gpubench import cells

    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        # The harness draws the inputs and labels from these two.
        assert cfg["dims"][0] == cfg["num_features"]
        assert cfg["dims"][-1] == cfg["num_classes"]
        if cells.model_kind(cfg).WIDTHS == "dims":
            hidden = [cfg["hidden_channels"]] * (cfg["num_layers"] - 1)
            assert cfg["dims"] == [cfg["num_features"], *hidden,
                                   cfg["num_classes"]]
        assert cfg["graph"]["m"] == cfg["num_nodes"]


def test_names_and_units_use_the_allowed_characters():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [c["name"] for c in BENCH["configs"]] + \
        [w["traffic"] for w in BENCH["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + BENCH["command"]):
        assert ONE_LINE.match(text), text
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(BENCH["workloads"])


def test_every_moves_metric_is_reported_where_listed():
    reports = {m["name"]: set(m.get("workloads", [w["name"] for w in
                                                  BENCH["workloads"]]))
               for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in reports, m["name"]
        for cell in m["workloads"]:
            assert cell in reports[m["moves"]], (m["name"], cell)
    for w in BENCH["workloads"]:
        assert w["name"] in reports["setup_s"]
        assert sum(w["name"] in r for r in reports.values()) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_bounds_and_run_length_within_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert BENCH["paths"] == ["gpubench"]


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_a_run_without_a_card_exits_non_zero():
    cell = BENCH["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
         "2147483649", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_run_alone_in_its_folder_exits_non_zero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell = BENCH["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
         "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
