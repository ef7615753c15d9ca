"""The comparison fails what it should: each cell runs on the CPU at a
small size past the harness's look for a card, once sound and once
with the timed path broken underneath, and ``correct`` has to come out
false for every fault the cell can have. One card holds every cell, so
there is no exchange between cards to leave out.

The control (the reference in bfloat16 in the program's place) is held
here for the AGNN cells only. On the CPU, ``index_add_`` sums a row's
bfloat16 messages in float32 and rounds once, where the card adds them
one by one in bfloat16; GCN's control then reads about a hundredth of
what it reads on the card, under its limits. The card-marked test at
the end holds every cell's control at the cell's own size."""
import json

import pytest
import torch

from gpubench import cells, control, harness

CPU = torch.device("cpu")
TRAIN = ["agnn_arxiv.train", "gcn_arxiv.train"]
SERVE = ["gcn_arxiv.serve", "agnn_arxiv.serve"]


@pytest.fixture
def small(tmp_path):
    return {"config": {"graph": {"generator": "power_law", "m": 1200,
                                 "k": 1200, "avg_row": 8.0, "alpha": 1.8,
                                 "seed": 1},
                       "dims": [16, 32, 32, 8],
                       "tune_cache": str(tmp_path / "tune"),
                       "serve_knee_rps": 30},
            "traffic": {"pool_panels": 4, "subset_nodes": 50,
                        "check_requests": 4}}


def _run(cell, small, seed=2147483659, program=None):
    out = harness.run_cell(cell, seed, 0.3, False, CPU, overrides=small,
                           program=program)
    json.dumps(out)
    return out


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_sound_run_is_correct(cell, small):
    out = _run(cell, small)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert any(c["limit"] is not None for c in out["checks"].values())


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_fails(cell, small,
                                                      monkeypatch):
    from repro_torch.models import gnn

    monkeypatch.setattr(gnn, "sgd_step", lambda model, lr: None)
    out = _run(cell, small)
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out_fails(cell, small, monkeypatch):
    from repro_torch.models import gnn

    whole = gnn.cross_entropy

    def half(logits, labels):
        n = logits.shape[0] // 2
        return whole(logits[:n], labels[:n])

    monkeypatch.setattr(gnn, "cross_entropy", half)
    assert not _run(cell, small)["correct"]


@pytest.mark.parametrize("cell", ["agnn_arxiv.train"])
def test_the_control_fails_training(cell, small):
    def bf16(world, seed):
        return cells.ReferenceTrainProgram(world, seed, dtype=torch.bfloat16)

    assert not _run(cell, small, program=bf16)["correct"]


@pytest.mark.parametrize("cell", SERVE)
def test_an_answer_altered_where_it_is_produced_fails(cell, small,
                                                      monkeypatch):
    from repro_torch.serve import GNNService

    flush = GNNService.flush

    def altered(self):
        out = flush(self)
        for rid, r in out.items():
            if isinstance(r, torch.Tensor):
                r = r.clone()
                r[0] += r.abs().max()
                out[rid] = r
        return out

    monkeypatch.setattr(GNNService, "flush", altered)
    assert not _run(cell, small)["correct"]


@pytest.mark.parametrize("cell", ["agnn_arxiv.serve"])
def test_the_control_fails_serving(cell, small):
    def bf16(world, seed, pool_panels):
        return cells.ReferenceServeProgram(world, seed, pool_panels)

    assert not _run(cell, small, program=bf16)["correct"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_control_readings_separate(cell, small):
    """The readings the limits are set from, at a small size: the
    program within every limit; the control (AGNN) and the half-batch
    fault outside one."""
    lim = cells.limits(cell)
    rows = list(control.readings(cell, [11, 12], CPU, faults=1,
                                 seconds=0.5, overrides=small))
    assert {r["who"] for r in rows} >= {"program", "control"}
    for row in rows:
        over = [k for k, v in lim.items() if not row[k] <= v]
        if row["who"] == "program":
            assert not over, row
        elif row["who"] == "half_batch" or cell.startswith("agnn"):
            assert over, row


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_control_readings_separate_at_the_cells_size(cell, card):
    lim = cells.limits(cell)
    for row in control.readings(cell, [21, 22, 23], card, faults=1):
        over = [k for k, v in lim.items() if not row[k] <= v]
        assert bool(over) == (row["who"] != "program"), row
