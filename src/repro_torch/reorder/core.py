"""Sparsity-aware row reordering: manufacture 8-row Tensor Core window
density.

Libra's 2D-aware split (paper §4) takes the matrix's window structure as
given; Acc-SpMM (arxiv 2501.09251) and HC-SpMM (arxiv 2412.08902) show
that *changing* the pattern first — clustering rows with similar column
sets into the same 8-row window — grows the Tensor Core nnz fraction and
shrinks the CUDA-core residue.

The pass is bulk-vectorized NumPy and gives the reference package's
permutations bit for bit (the same hash bands, the same ``lexsort``
keys):

1. **Column bitsketches** — every row gets two 64-bit LSH band sketches,
   the OR of one hashed bit per column (two independent hash seeds).
   Rows sharing many columns share many sketch bits.
2. **Degree-sorted binning** — rows sort primarily by log2 degree bin
   (densest first, empty rows last), so rows with comparable work land
   in the same window and the threshold split stays coherent.
3. **LSH-bucket refinement** — within a degree bin rows order by band-1
   sketch then band-2 sketch, so rows with similar column signatures
   become adjacent and fill 8-row windows together.

The emitted :class:`Reordering` carries the row permutation, its
inverse, and the canonical-nnz permutation that links the reordered
matrix's CSR order back to the original's — the hook that keeps
``edge_vals`` revaluation and the segment tables working unchanged (see
:meth:`repro_torch.core.preprocess.Plan.build`). The column permutation
is the identity: window density is invariant to column order
(condensation packs whole column vectors), so permuting columns would
only force a gather of ``b`` for no density gain.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.matrix import SparseCSR

WINDOW = 8  # 8×1 column-vector granularity (mirrors core.formats.WINDOW)

#: ``reorder="auto"`` enables the permutation only when the projected
#: TC-eligible nnz fraction grows by at least this much — below it the
#: densification cannot pay for the output-unpermute gather.
MIN_TC_GAIN = 0.05

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)
# Two independent multiplicative hash bands (odd 64-bit constants).
_BANDS = (np.uint64(0x9E3779B97F4A7C15), np.uint64(0xC2B2AE3D27D4EB4F))


@dataclasses.dataclass(frozen=True)
class Reordering:
    """A row permutation and its canonical-nnz composition maps.

    row_perm: (m,) i64 — reordered row ``i`` is original row
        ``row_perm[i]`` (gather map original → reordered space).
    row_inv:  (m,) i64 — original row ``j`` lands at reordered position
        ``row_inv[j]``; ``take(out_reordered, row_inv, axis=0)`` is the
        one-gather unpermute epilogue.
    nnz_perm: (nnz,) i64 — reordered canonical nnz position ``p`` holds
        the element at original canonical position ``nnz_perm[p]``
        (canonical = CSR row-major, column-sorted). Remapping a plan's
        ``pos`` arrays through this gives position maps straight into
        *original*-order ``edge_vals``.
    nnz_inv:  (nnz,) i64 — inverse of ``nnz_perm``.
    """

    row_perm: np.ndarray
    row_inv: np.ndarray
    nnz_perm: np.ndarray
    nnz_inv: np.ndarray

    @property
    def m(self) -> int:
        return int(self.row_perm.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.nnz_perm.shape[0])

    @property
    def is_identity(self) -> bool:
        return bool(np.array_equal(self.row_perm,
                                   np.arange(self.m, dtype=np.int64)))


def row_sketches(a: SparseCSR, *, bands: tuple = _BANDS) -> np.ndarray:
    """Per-row 64-bit column bitsketches, one per hash band.

    Returns ``(len(bands), m)`` uint64. Band ``b`` of row ``r`` is the
    OR of ``1 << hash_b(c) % 64`` over the row's columns — a one-pass
    ``bitwise_or`` scatter, no per-row loop.
    """
    rows = np.repeat(np.arange(a.m, dtype=np.int64),
                     np.diff(a.indptr).astype(np.int64))
    cols = a.indices.astype(np.uint64)
    out = np.zeros((len(bands), a.m), np.uint64)
    for bi, mult in enumerate(bands):
        h = ((cols + np.uint64(1)) * mult) & _MASK64
        bit = np.uint64(1) << ((h >> np.uint64(58)) % np.uint64(64))
        np.bitwise_or.at(out[bi], rows, bit)
    return out


def reorder_rows(a: SparseCSR) -> Reordering:
    """Degree-sorted binning + LSH-bucket refinement → row permutation.

    One ``lexsort`` over (degree bin desc, band-1 sketch, band-2
    sketch, row id): rows with similar degree *and* similar column
    signature become adjacent, densifying 8-row windows. Deterministic
    (row id is the final tiebreak).
    """
    deg = np.diff(a.indptr).astype(np.int64)
    # log2 degree bins, densest first; empty rows sort last.
    with np.errstate(divide="ignore"):
        bin_ = np.where(deg > 0, np.log2(np.maximum(deg, 1)).astype(np.int64),
                        np.int64(-1))
    neg_bin = np.where(deg > 0, -bin_, np.int64(1))
    sk = row_sketches(a)
    row_perm = np.lexsort((np.arange(a.m, dtype=np.int64),
                           sk[1], sk[0], neg_bin)).astype(np.int64)
    row_inv = np.empty(a.m, np.int64)
    row_inv[row_perm] = np.arange(a.m, dtype=np.int64)
    rows, cols, _ = a.to_coo()
    new_rows = row_inv[rows.astype(np.int64)]
    # Canonical order of the reordered matrix: sort by (new row, col).
    nnz_perm = np.lexsort((cols, new_rows)).astype(np.int64)
    nnz_inv = np.empty(nnz_perm.size, np.int64)
    nnz_inv[nnz_perm] = np.arange(nnz_perm.size, dtype=np.int64)
    return Reordering(row_perm, row_inv, nnz_perm, nnz_inv)


def apply_reorder(a: SparseCSR, reord: Reordering) -> SparseCSR:
    """The row-permuted matrix, in canonical CSR order.

    ``apply_reorder(a, reord).data == a.data[reord.nnz_perm]`` — the
    value vector is the original's, gathered through the nnz map.
    """
    rows, cols, vals = a.to_coo()
    order = reord.nnz_perm
    new_rows = reord.row_inv[rows.astype(np.int64)][order]
    counts = np.bincount(new_rows, minlength=a.m).astype(np.int64)
    indptr = np.zeros(a.m + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return SparseCSR(a.m, a.k, indptr, cols[order].astype(np.int32),
                     vals[order].astype(np.float32))


def reorder_csr(a: SparseCSR) -> tuple[SparseCSR, Reordering]:
    """Convenience: compute the permutation and apply it."""
    reord = reorder_rows(a)
    return apply_reorder(a, reord), reord


def reorder_gain(feat_before, feat_after, threshold: int) -> dict:
    """Price reorder-vs-not from two ``matrix_features`` passes.

    Both features come from the same
    :func:`repro_torch.tune.model.matrix_features` machinery the tuner
    already runs; the gain metric is the projected TC-eligible nnz
    fraction at the resolved threshold — exactly what the 2D-aware
    split will see, so ``auto`` never enables a reorder that does not
    densify.
    """
    nnz = max(feat_before.nnz, 1)
    before = feat_before.nnz_at_least(threshold) / nnz
    after = feat_after.nnz_at_least(threshold) / nnz
    return {
        "tc_frac_before": float(before),
        "tc_frac_after": float(after),
        "gain": float(after - before),
        "window_density_before": float(feat_before.window_density),
        "window_density_after": float(feat_after.window_density),
        "occupancy_before": feat_before.win_vec_hist.sum(axis=0)[1:].tolist(),
        "occupancy_after": feat_after.win_vec_hist.sum(axis=0)[1:].tolist(),
    }


def decide_reorder(gain_report: dict, *, min_gain: float = MIN_TC_GAIN) -> bool:
    """The ``auto`` policy: enable only on a clear TC-fraction win."""
    return gain_report["gain"] >= min_gain
