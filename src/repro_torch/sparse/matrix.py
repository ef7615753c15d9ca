"""Host-side sparse matrix containers.

Preprocessing in Libra happens once per matrix and is reused across
iterations (paper §4.5), so the canonical container is a host-side CSR
backed by NumPy. Device-side formats (bitmap TC blocks + VPU tiles) are
produced by :mod:`repro_torch.core.preprocess`.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SparseCSR:
    """CSR matrix. ``indptr`` has length ``m+1``; column indices are int32."""

    m: int
    k: int
    indptr: np.ndarray  # (m+1,) int64
    indices: np.ndarray  # (nnz,) int32
    data: np.ndarray  # (nnz,) float32

    def __post_init__(self) -> None:
        assert self.indptr.shape == (self.m + 1,)
        assert self.indices.shape == self.data.shape
        assert int(self.indptr[-1]) == self.indices.shape[0]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def shape(self) -> tuple[int, int]:
        return (self.m, self.k)

    def row_slice(self, r: int) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = int(self.indptr[r]), int(self.indptr[r + 1])
        return self.indices[lo:hi], self.data[lo:hi]

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.m, self.k), dtype=self.data.dtype)
        for r in range(self.m):
            cols, vals = self.row_slice(r)
            out[r, cols] += vals
        return out

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        rows = np.repeat(
            np.arange(self.m, dtype=np.int32), np.diff(self.indptr).astype(np.int64)
        )
        return rows, self.indices.astype(np.int32), self.data

    @staticmethod
    def from_dense(dense: np.ndarray) -> "SparseCSR":
        m, k = dense.shape
        rows, cols = np.nonzero(dense)
        data = dense[rows, cols].astype(np.float32)
        return coo_to_csr(m, k, rows.astype(np.int32), cols.astype(np.int32), data)


def coo_to_csr(
    m: int, k: int, rows: np.ndarray, cols: np.ndarray, data: np.ndarray
) -> SparseCSR:
    """Deterministic COO→CSR: sorts by (row, col) and merges duplicates."""
    order = np.lexsort((cols, rows))
    rows, cols, data = rows[order], cols[order], data[order]
    # Merge duplicate (row, col) entries by summation.
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
    return SparseCSR(m, k, indptr, cols.astype(np.int32), data.astype(np.float32))
