"""The shared parts of the plain PyTorch references over the graph's
edge list: the edges, the sparse products, the row softmax, the loss
and the SGD loop.

The reference the benchmark holds the program to. It takes only what
the benchmark made (the CSR arrays, the weights, the features, the
labels) and works out everything else again: the normalised edge
values, the per-row softmax, every sparse product as a gather of the
source rows and an ``index_add_`` into the destination rows. Nothing
here imports the program.

Every function takes a compute ``dtype``. ``torch.float32`` with TF32
off is the reference; a lower one (``torch.bfloat16``) is the control
that shows a comparison can fail. Parameters stay float32 (the master
copy), are cast to ``dtype`` for the products, and take their SGD
update in float32.

A model is a list of layers, each a dict of parameters. Each kind's
forward sits in a file of its own beside this one (``gcn.py``,
``agnn.py``), which the kind's module under ``gpubench/models/`` names,
and gives:

* ``KEYS``: the keys of a layer's parameters, in the order of
  :func:`leaves`;
* ``graph_terms(e)``: what the forward works out from the graph alone
  (GCN: Â's values), once a training run; None where it needs nothing;
* ``forward(layers, e, x, dtype=torch.float32, terms=None)``: the logits
  of every node in ``dtype``, working ``terms`` out where None.

The edges are taken in blocks of :data:`EDGE_BLOCK`, so a gather of
2.3 M edges at width 256 never holds more than one block.
"""
from __future__ import annotations

import torch

EDGE_BLOCK = 1 << 19


class Edges:
    """The graph as the reference sees it: destination and source row
    of every edge on one device, and the node count."""

    def __init__(self, indptr, indices, m: int, device):
        import numpy as np

        counts = np.diff(np.asarray(indptr, dtype=np.int64))
        rows = np.repeat(np.arange(m, dtype=np.int64), counts)
        self.m = m
        self.rows = torch.as_tensor(rows, device=device)
        self.cols = torch.as_tensor(np.asarray(indices, dtype=np.int64),
                                    device=device)

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def blocks(self):
        for lo in range(0, self.nnz, EDGE_BLOCK):
            hi = min(lo + EDGE_BLOCK, self.nnz)
            yield lo, hi


def aggregate(e: Edges, vals: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``out[r] = Σ_{p in row r} vals[p] · h[col_p]``."""
    out = torch.zeros((e.m, h.shape[1]), dtype=h.dtype, device=h.device)
    for lo, hi in e.blocks():
        msg = vals[lo:hi, None] * h.index_select(0, e.cols[lo:hi])
        out = out.index_add(0, e.rows[lo:hi], msg)
    return out


def edge_dots(e: Edges, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``s[p] = <x[row_p], y[col_p]>``."""
    parts = []
    for lo, hi in e.blocks():
        parts.append((x.index_select(0, e.rows[lo:hi])
                      * y.index_select(0, e.cols[lo:hi])).sum(-1))
    return torch.cat(parts)


def row_softmax(e: Edges, s: torch.Tensor) -> torch.Tensor:
    """Softmax of the edge scores over each destination row."""
    top = torch.full((e.m,), float("-inf"), dtype=s.dtype, device=s.device)
    top = top.scatter_reduce(0, e.rows, s.detach(), "amax")
    ex = torch.exp(s - top[e.rows])
    tot = torch.zeros((e.m,), dtype=s.dtype, device=s.device)
    tot = tot.index_add(0, e.rows, ex)
    return ex / tot[e.rows]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  rows: torch.Tensor | None = None) -> torch.Tensor:
    """Mean of ``-log softmax`` at each row's label, over ``rows`` (all
    rows when None)."""
    if rows is not None:
        logits, labels = logits[rows], labels[rows]
    lp = torch.log_softmax(logits, dim=-1)
    return -lp.gather(1, labels[:, None]).mean()


def leaves(layers: list[dict], keys) -> list[torch.Tensor]:
    """The parameters in a fixed order: each layer's, in the order of
    ``keys`` (the kind's ``KEYS``)."""
    return [layer[k] for layer in layers for k in keys if k in layer]


def train(model, layers: list[dict], e: Edges, x: torch.Tensor,
          labels: torch.Tensor, *, lr: float, steps: int,
          dtype=torch.float32, loss_rows: torch.Tensor | None = None):
    """``steps`` full-batch SGD steps of ``model`` (a kind's reference
    module) from ``layers`` (left unchanged).

    Returns ``(losses, states)``: each step's loss before its update (a
    float) and the parameters after each step (lists in
    :func:`leaves`' order, float32). ``loss_rows`` takes the loss over
    those rows only."""
    terms = model.graph_terms(e)
    cur = [{k: v.detach().clone().float() for k, v in layer.items()}
           for layer in layers]
    losses, states = [], []
    for _ in range(steps):
        params = leaves(cur, model.KEYS)
        for p in params:
            p.requires_grad_(True)
        logits = model.forward(cur, e, x, dtype, terms)
        loss = cross_entropy(logits.float(), labels, loss_rows)
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(lr * g.float())
                p.requires_grad_(False)
        del logits, loss, grads
        states.append([p.detach().clone() for p in leaves(cur, model.KEYS)])
    return losses, states
