"""The benchmark's frozen graph generator.

A copy of the power-law generator the port ships
(``power_law_csr`` and the COO-to-CSR step it ends in), kept here so
that a later change to the program cannot move the yardstick: the same
recipe gives the same edges, bit for bit, whatever the port does.

A graph is a configuration's dataset. Its recipe (sizes, mean row
length, exponent and a fixed generator seed) sits in the configuration
file, so every run of a cell works on the same graph; ``--seed`` draws
only weights, features, labels and traffic.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """A CSR graph as plain arrays: row ``r`` has the edges
    ``indptr[r]:indptr[r+1]``, sorted by column, with no duplicates."""

    m: int
    k: int
    indptr: np.ndarray   # (m + 1,) int64
    indices: np.ndarray  # (nnz,) int32
    data: np.ndarray     # (nnz,) float32

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def rows(self) -> np.ndarray:
        """Destination row of every edge, in CSR order."""
        return np.repeat(np.arange(self.m, dtype=np.int32),
                         np.diff(self.indptr).astype(np.int64))


def _to_csr(m, k, rows, cols, data) -> Graph:
    order = np.lexsort((cols, rows))
    rows, cols, data = rows[order], cols[order], data[order]
    if rows.size:
        key = rows.astype(np.int64) * np.int64(k) + cols.astype(np.int64)
        uniq, inv = np.unique(key, return_inverse=True)
        if uniq.size != key.size:
            merged = np.zeros(uniq.size, dtype=np.float64)
            np.add.at(merged, inv, data.astype(np.float64))
            data = merged.astype(np.float32)
            rows = (uniq // k).astype(np.int32)
            cols = (uniq % k).astype(np.int32)
    counts = np.bincount(rows, minlength=m).astype(np.int64)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return Graph(m, k, indptr, cols.astype(np.int32), data.astype(np.float32))


def power_law(m: int, k: int, avg_row: float, alpha: float = 1.8,
              seed: int = 0) -> Graph:
    """Zipf-distributed row lengths scaled to ``avg_row`` on average,
    each row's columns drawn without replacement."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(alpha, size=m).astype(np.float64)
    raw = np.minimum(raw, k)
    raw = raw * (avg_row * m / max(raw.sum(), 1.0))
    lens = np.clip(np.round(raw).astype(np.int64), 0, k)
    rows = np.repeat(np.arange(m, dtype=np.int64), lens)
    cols = (np.concatenate([rng.choice(k, size=int(n), replace=False)
                            for n in lens if n > 0])
            if lens.sum() else np.zeros(0, np.int64))
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    data = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return _to_csr(m, k, rows, cols, data)


GENERATORS = {"power_law": power_law}


def from_recipe(recipe: dict) -> Graph:
    """The graph a configuration's ``graph`` entry describes:
    ``{"generator": "power_law", "m": ..., "k": ..., "avg_row": ...,
    "alpha": ..., "seed": ...}``."""
    kw = dict(recipe)
    return GENERATORS[kw.pop("generator")](**kw)
