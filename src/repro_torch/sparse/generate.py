"""Synthetic sparse-matrix generators spanning the paper's Figure-1 spectrum.

The 500 SuiteSparse matrices in the paper range from "almost every non-zero
vector has a single element" (CUDA-core/VPU advantage region) to "column
vectors are dense" (TCU/MXU advantage region), with >70% in between. The
generators here reproduce those regimes so every benchmark/ablation has
matrices from each band.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.matrix import SparseCSR, coo_to_csr


def _finish(m, k, rows, cols, rng) -> SparseCSR:
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    data = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return coo_to_csr(m, k, rows, cols, data)


def random_uniform_csr(m: int, k: int, density: float, seed: int = 0) -> SparseCSR:
    """Erdős–Rényi sparsity: the extreme-sparse (NNZ-1) regime at low density."""
    rng = np.random.default_rng(seed)
    nnz = max(1, int(round(m * k * density)))
    flat = rng.choice(m * k, size=min(nnz, m * k), replace=False)
    return _finish(m, k, flat // k, flat % k, rng)


def power_law_csr(m: int, k: int, avg_row: float, alpha: float = 1.8,
                  seed: int = 0) -> SparseCSR:
    """Power-law row lengths (graph-like; the load-balancing stressor)."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(alpha, size=m).astype(np.float64)
    raw = np.minimum(raw, k)
    raw = raw * (avg_row * m / max(raw.sum(), 1.0))
    lens = np.clip(np.round(raw).astype(np.int64), 0, k)
    rows = np.repeat(np.arange(m, dtype=np.int64), lens)
    cols = np.concatenate([rng.choice(k, size=int(l), replace=False) for l in lens
                           if l > 0]) if lens.sum() else np.zeros(0, np.int64)
    return _finish(m, k, rows, cols, rng)


def banded_csr(m: int, k: int, bandwidth: int, density: float = 1.0,
               seed: int = 0) -> SparseCSR:
    """Banded matrices: dense column vectors, the MXU advantage regime."""
    rng = np.random.default_rng(seed)
    rows_l, cols_l = [], []
    for r in range(m):
        lo = max(0, min(r - bandwidth // 2, k - bandwidth))
        cs = np.arange(lo, min(lo + bandwidth, k))
        if density < 1.0:
            cs = cs[rng.random(cs.shape[0]) < density]
        rows_l.append(np.full(cs.shape[0], r, dtype=np.int64))
        cols_l.append(cs)
    return _finish(m, k, np.concatenate(rows_l), np.concatenate(cols_l), rng)


def block_structured_csr(m: int, k: int, block: int = 8, block_density: float = 0.05,
                         fill: float = 0.9, seed: int = 0) -> SparseCSR:
    """Dense blocks on a sparse block grid (FEM/pkustk-like hybrid regime)."""
    rng = np.random.default_rng(seed)
    mb, kb = m // block, k // block
    nblocks = max(1, int(mb * kb * block_density))
    sel = rng.choice(mb * kb, size=min(nblocks, mb * kb), replace=False)
    rows_l, cols_l = [], []
    for s in sel:
        br, bc = (s // kb) * block, (s % kb) * block
        rr, cc = np.meshgrid(np.arange(block), np.arange(block), indexing="ij")
        mask = rng.random((block, block)) < fill
        rows_l.append((br + rr[mask]).ravel())
        cols_l.append((bc + cc[mask]).ravel())
    rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
    cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64)
    return _finish(m, k, rows, cols, rng)


def mixed_csr(m: int, k: int, seed: int = 0) -> SparseCSR:
    """Hybrid-region matrix: dense blocks + a sprinkle of isolated non-zeros.

    This is the regime where the paper's hybrid computation wins (Fig. 1
    middle band): neither path alone is optimal.
    """
    rng = np.random.default_rng(seed)
    a = block_structured_csr(m, k, block=8, block_density=0.02, fill=0.85, seed=seed)
    b = random_uniform_csr(m, k, density=min(0.002, 8.0 / k), seed=seed + 1)
    rows = np.concatenate([a.to_coo()[0], b.to_coo()[0]])
    cols = np.concatenate([a.to_coo()[1], b.to_coo()[1]])
    return _finish(m, k, rows, cols, rng)


def suitesparse_like_corpus(n_small: int = 12, seed: int = 0):
    """A small corpus spanning the Fig.-1 spectrum, keyed by regime name."""
    out = {}
    base = seed
    for i in range(n_small):
        m = 256 * (1 + (i % 3))
        k = 256 * (1 + ((i + 1) % 3))
        kind = i % 4
        if kind == 0:
            mat = random_uniform_csr(m, k, density=0.004, seed=base + i)
            name = f"uniform_sparse_{i}"
        elif kind == 1:
            mat = power_law_csr(m, k, avg_row=12.0, seed=base + i)
            name = f"powerlaw_{i}"
        elif kind == 2:
            mat = banded_csr(m, k, bandwidth=12, density=0.9, seed=base + i)
            name = f"banded_{i}"
        else:
            mat = mixed_csr(m, k, seed=base + i)
            name = f"mixed_{i}"
        out[name] = mat
    return out
