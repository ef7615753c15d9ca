"""SGT-style window partitioning (paper §2.1, Fig. 2).

A sparse matrix is cut into row windows of height ``WINDOW``; within each
window, non-zeros that share a column form an 8×1 *non-zero column vector*.
This module extracts, per window, the distinct columns and their occupancy
(bitmap over the 8 sublanes) — the primitive both operators distribute on.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.formats import WINDOW
from repro_torch.sparse.matrix import SparseCSR


@dataclasses.dataclass(frozen=True)
class WindowVectors:
    """Column vectors of one window.

    cols:   (nvec,) i32 distinct columns, ascending
    counts: (nvec,) i32 NNZ of each column vector (1..WINDOW)
    bitmap: (nvec,) u32 occupancy bits (bit r set ⇒ row ``window*8+r`` non-zero)
    vals:   (nvec, WINDOW) f32 dense-ified vector values
    pos:    (nvec, WINDOW) i32 canonical nnz index of each value (−1 pad)
    """

    cols: np.ndarray
    counts: np.ndarray
    bitmap: np.ndarray
    vals: np.ndarray
    pos: np.ndarray


def num_windows(m: int) -> int:
    return (m + WINDOW - 1) // WINDOW


def extract_windows(a: SparseCSR) -> list[WindowVectors]:
    """Vectorized single pass over the CSR; returns one entry per window."""
    rows, cols, vals = a.to_coo()
    nnz_idx = np.arange(rows.shape[0], dtype=np.int32)  # canonical CSR order
    win = rows // WINDOW
    sub = (rows % WINDOW).astype(np.int64)
    nwin = num_windows(a.m)
    # Sort by (window, col, sub) so each vector is a contiguous run.
    order = np.lexsort((sub, cols, win))
    win, sub, cols, vals = win[order], sub[order], cols[order], vals[order]
    nnz_idx = nnz_idx[order]
    out: list[WindowVectors] = []
    # Window boundaries.
    wptr = np.searchsorted(win, np.arange(nwin + 1))
    for w in range(nwin):
        lo, hi = wptr[w], wptr[w + 1]
        c, s, v, pidx = cols[lo:hi], sub[lo:hi], vals[lo:hi], nnz_idx[lo:hi]
        if c.size == 0:
            z = np.zeros(0, dtype=np.int32)
            out.append(WindowVectors(z, z.copy(), z.astype(np.uint32),
                                     np.zeros((0, WINDOW), np.float32),
                                     np.zeros((0, WINDOW), np.int32)))
            continue
        uc, start, cnt = np.unique(c, return_index=True, return_counts=True)
        bitmap = np.zeros(uc.size, dtype=np.uint32)
        dense = np.zeros((uc.size, WINDOW), dtype=np.float32)
        posd = np.full((uc.size, WINDOW), -1, dtype=np.int32)
        vec_id = np.repeat(np.arange(uc.size), cnt)
        np.bitwise_or.at(bitmap, vec_id, (np.uint32(1) << s.astype(np.uint32)))
        dense[vec_id, s] = v
        posd[vec_id, s] = pidx
        out.append(WindowVectors(uc.astype(np.int32), cnt.astype(np.int32),
                                 bitmap, dense, posd))
    return out


def nnz1_fraction(a: SparseCSR) -> float:
    """Fraction of non-zero column vectors containing exactly one non-zero.

    This is the paper's Figure-1 statistic: high ⇒ CUDA-core advantage,
    low ⇒ Tensor Core advantage, middle ⇒ hybrid region.
    """
    total = 0
    nnz1 = 0
    for wv in extract_windows(a):
        total += int(wv.counts.size)
        nnz1 += int((wv.counts == 1).sum())
    return nnz1 / max(total, 1)
