"""The comparison that decides ``correct``.

Training: the window's own step drives the model through its first
``check_steps`` steps in set-up; the reference follows the same steps
from the same weights, features and labels. Three numbers:

* ``loss_gap``: the worst step's |loss − reference loss| / |reference loss|;
* ``grad_gap``: the first gradient as SGD got it, worked out from the
  parameters after one step (``(θ0 − θ1) / lr``); for each leaf the gap
  between its norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf; the worst leaf;
* ``update_gap``: the same for the parameters' change over the steps
  (``θk − θ0``).

A leaf whose reference gradient is under a thousandth of the median
leaf's moves by round-off alone and is left out of both.

Serving: ``score_err``, the worst over the requests the comparison
takes of ``max |served − reference| / max |reference|`` over the
scores that request asked for.

Both take ``model``, the plain reference of the cell's model kind
(:func:`gpubench.cells.reference`).
"""
from __future__ import annotations

import statistics

import torch

from gpubench.reference import gnn as ref

#: A leaf counts when its reference gradient norm reaches this share of
#: the median leaf's.
LEAF_FLOOR = 1e-3


def edges(graph, dev) -> ref.Edges:
    return ref.Edges(graph.indptr, graph.indices, graph.m, dev)


def _norms(a: list[torch.Tensor], b: list[torch.Tensor]) -> list[float]:
    return [float(torch.linalg.vector_norm((y - x).double()))
            for x, y in zip(a, b)]


def _worst_gap(prog: list[float], want: list[float], keep: list[bool]):
    kept = [w for w, k in zip(want, keep) if k]
    if not kept:
        return 0.0
    med = statistics.median(kept)
    return max(abs(p - w) / max(w, med)
               for p, w, k in zip(prog, want, keep) if k)


def train_numbers(model, layers0: list[dict], e: ref.Edges, x, labels,
                  run: dict, *, lr: float,
                  detail: dict | None = None) -> dict[str, float]:
    """The three numbers of a training cell; ``run`` holds what
    :func:`gpubench.cells.train_check_steps` kept of the program.
    ``detail``, when given, gets each leaf's reference gradient norm and
    whether the leaf counts."""
    steps = len(run["losses"])
    ref_losses, states = ref.train(model, layers0, e, x, labels, lr=lr,
                                   steps=steps)
    theta0 = ref.leaves(layers0, model.KEYS)
    g_ref = [n / lr for n in _norms(states[0], theta0)]
    med = statistics.median(g_ref)
    keep = [g >= LEAF_FLOOR * med for g in g_ref]
    if detail is not None:
        detail.update(ref_grad_norms=g_ref, leaves_counted=keep)
    loss_gap = max(abs(p - w) / abs(w)
                   for p, w in zip(run["losses"], ref_losses))
    g_prog = [n / lr for n in _norms(run["theta1"], run["theta0"])]
    grad_gap = _worst_gap(g_prog, g_ref, keep)
    update_gap = _worst_gap(_norms(run["theta0"], run["theta_k"]),
                            _norms(theta0, states[-1]), keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": update_gap}


def serve_numbers(model, layers0: list[dict], e: ref.Edges, pool,
                  plan, kept: dict) -> dict[str, float]:
    """``score_err`` over the kept requests (``kept``: request → the
    scores it was served). A request the comparison takes that was never
    served reads infinite."""
    worst = 0.0
    for j in sorted(plan.check):
        got = kept.get(j)
        if got is None:
            return {"score_err": float("inf")}
        with torch.no_grad():
            want = model.forward(layers0, e, pool[plan.panels[j]])
        if plan.subset[j]:
            want = want[plan.subset_ids(j)]
        err = float((got.float() - want).abs().max())
        scale = float(want.abs().max())
        worst = max(worst, err / max(scale, 1e-30))
    return {"score_err": worst}


def judge(numbers: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit (None where the cell compares it
    with none); ``correct`` when every compared number is within."""
    checks, ok = {}, True
    for name, value in numbers.items():
        lim = limits.get(name)
        checks[name] = {"value": value, "limit": lim}
        if lim is not None and not value <= lim:
            ok = False
    return ok, checks
