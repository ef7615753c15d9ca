"""Plain PyTorch versions of the four kernels and of the hybrid apply.

These define the semantics the CUDA kernels reproduce:

* Tensor Core SpMM: per condensed block ``P = vals @ B[cols]``
  accumulated into the block's compacted output window.
* CUDA-core SpMM: per tile ``p = Σ_j vals[j] · B[cols[j]]``.
* Tensor Core SDDMM: per block ``S = X[win] @ Y[cols]ᵀ`` sampled by bitmap.
* CUDA-core SDDMM: per element ``s = ⟨X[row], Y[col]⟩``.

The ``*_hybrid_ref`` functions are the ``backend="torch"`` path over the
compact tables (the reference package's ``"xla"`` path). Gathers are
evaluated in chunks of at most :data:`CHUNK_ELEMS` gathered elements, so
full-size graphs fit in device memory; chunking does not change the
arithmetic of any output element.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.formats import WINDOW

#: Upper bound on gathered elements materialized at once (1 GiB of fp32).
CHUNK_ELEMS = 1 << 28


def chunks(n_units: int, elems_per_unit: int):
    """Slices over ``n_units`` whose gathers hold ≤ CHUNK_ELEMS elements."""
    step = max(1, CHUNK_ELEMS // max(elems_per_unit, 1))
    for lo in range(0, n_units, step):
        yield slice(lo, min(lo + step, n_units))


def over_batch(fn, *operands):
    """The plain form of a batched launch: ``fn`` once a batch element,
    the results stacked. Each operand is ``(tensor, ndim)``; a tensor
    with ``ndim + 1`` dims is taken one element at a time, one with
    ``ndim`` is shared by every element."""
    batch = {t.shape[0] for t, nd in operands if t.dim() == nd + 1}
    if len(batch) != 1:
        raise ValueError(f"operands disagree on the batch: {sorted(batch)}")
    return torch.stack([fn(*(t[i] if t.dim() == nd + 1 else t
                             for t, nd in operands))
                        for i in range(batch.pop())])


def spmm_tc_compact_ref(tc_vals, tc_cols, tc_rank, b, n_active):
    """Compacted Tensor Core partial ``(n_active*8, n)``: block ``i``
    adds ``tc_vals[i] @ b[tc_cols[i]]`` into slab ``tc_rank[i]``."""
    nb, _, bk = tc_vals.shape
    n = b.shape[1]
    out = torch.zeros((n_active, WINDOW, n), dtype=torch.float32,
                      device=b.device)
    for sl in chunks(nb, bk * n):
        part = torch.bmm(tc_vals[sl], b[tc_cols[sl].long()])  # (c, 8, n)
        out.index_add_(0, tc_rank[sl].long(), part)
    return out.reshape(n_active * WINDOW, n)


def spmm_tile_partials(vals, cols, b):
    """Per-tile partial rows ``(ntiles, n)``: ``Σ_j vals[t,j]·b[cols[t,j]]``."""
    nt, ts = vals.shape
    n = b.shape[1]
    out = torch.empty((nt, n), dtype=torch.float32, device=b.device)
    for sl in chunks(nt, ts * n):
        out[sl] = torch.bmm(vals[sl, None, :],
                            b[cols[sl].long()]).squeeze(1)
    return out


def spmm_vpu_ref(vpu_vals, vpu_cols, vpu_row, b, m):
    """(nt,ts)×(nt,ts) → rows of (m, n)."""
    partial = spmm_tile_partials(vpu_vals, vpu_cols, b)
    out = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=b.device)
    return out.index_add_(0, vpu_row.long(), partial)


def spmm_hybrid_ref(arrs, b, m, nwin):
    """Hybrid SpMM over the compact tables: compacted TC partials + tile
    partials → one scatter-add into C."""
    tc_rows = arrs["tc_active_row"]
    tc = spmm_tc_compact_ref(arrs["tc_vals"], arrs["tc_cols"],
                             arrs["tc_rank"], b, tc_rows.shape[0] // WINDOW)
    partials = spmm_tile_partials(arrs["vpu_vals"], arrs["vpu_cols"], b)
    rows = torch.cat([tc_rows, arrs["vpu_row"]]).long()
    data = torch.cat([tc, partials])
    out = torch.zeros((nwin * WINDOW, b.shape[1]), dtype=torch.float32,
                      device=b.device)
    return out.index_add_(0, rows, data)[:m]


def bitmap_mask(bitmap):
    """(..., bk) int → (..., 8, bk) bool, bit r of column j ⇒ row r
    (paper Fig. 8's ``(binary >> tid) & 1``)."""
    sub = torch.arange(WINDOW, dtype=bitmap.dtype, device=bitmap.device)
    sub = sub.reshape((1,) * (bitmap.dim() - 1) + (WINDOW, 1))
    return ((bitmap.unsqueeze(-2) >> sub) & 1).bool()


def sddmm_tc_ref(tc_cols, tc_bitmap, tc_window, x, y):
    """Block scores ``(nb, 8, bk) = X[window] · Y[cols]ᵀ`` masked by
    bitmap. Rows of the window past the end of ``x`` read as zero."""
    nb, bk = tc_cols.shape
    mrows, kf = x.shape
    out = torch.empty((nb, WINDOW, bk), dtype=torch.float32, device=x.device)
    sub = torch.arange(WINDOW, device=x.device)
    for sl in chunks(nb, (bk + WINDOW) * kf):
        xrow = tc_window[sl].long()[:, None] * WINDOW + sub   # (c, 8)
        valid = (xrow < mrows).unsqueeze(-1)
        xw = torch.where(valid, x[xrow.clamp(max=max(mrows - 1, 0))], 0.0)
        s = torch.bmm(xw, y[tc_cols[sl].long()].transpose(1, 2))
        out[sl] = torch.where(bitmap_mask(tc_bitmap[sl]), s, 0.0)
    return out


def sddmm_pair_scores(rows, cols, x, y):
    """Element scores ``(nt, ts) = ⟨X[rows], Y[cols]⟩`` (no mask)."""
    nt, ts = rows.shape
    kf = x.shape[1]
    out = torch.empty((nt, ts), dtype=torch.float32, device=x.device)
    for sl in chunks(nt, 2 * ts * kf):
        xg = x[rows[sl].long()]
        yg = y[cols[sl].long()]
        out[sl] = (xg * yg).sum(-1)
    return out


def sddmm_vpu_ref(rows, cols, mask, x, y):
    """Element scores ``(nt, ts) = ⟨X[row], Y[col]⟩`` where mask."""
    return torch.where(mask, sddmm_pair_scores(rows, cols, x, y), 0.0)


def sddmm_hybrid_ref(arrs, x, y, nnz):
    """Hybrid SDDMM over the compact tables → canonical nnz-ordered
    values (one scatter; slot nnz swallows -1/masked padding)."""
    s_tc = sddmm_tc_ref(arrs["tc_cols"], arrs["tc_bitmap"],
                        arrs["tc_window"], x, y)
    s_el = sddmm_vpu_ref(arrs["vpu_rows"], arrs["vpu_cols"],
                         arrs["vpu_mask"], x, y)
    return scatter_scores(s_tc, arrs["tc_out_pos"], s_el,
                          arrs["vpu_out_pos"], arrs["vpu_mask"], nnz)


def place_scores(s, pos, kept, out):
    """The SDDMM kernels' canonical store: ``out[..., pos] = s`` where
    ``kept``. ``s`` is one stream's scores laid out as its table, with a
    leading batch axis when ``out`` is ``(batch, nnz)``; ``pos`` and
    ``kept`` are laid out as the table, shared by the batch or one set
    an element. Each kept position has one owner, so this is a plain
    store; positions nothing keeps are left as they are. Returns
    ``out``."""
    nnz = out.shape[-1]
    batch = out.shape[0] if out.dim() == 2 else 1
    at = pos.expand(s.shape).reshape(batch, -1).long()
    at = at + torch.arange(batch, device=at.device)[:, None] * nnz
    keep = kept.expand(s.shape).reshape(batch, -1)
    out.view(-1)[at[keep]] = s.reshape(batch, -1)[keep]
    return out


def scatter_scores(s_tc, tc_pos, s_el, el_pos, el_mask, nnz):
    """The SDDMM combine: both streams' scores into the canonical
    ``(nnz,)`` vector by one ``index_add_`` (slot ``nnz`` swallows the
    −1 / masked padding). Scores with a leading batch axis (``s_tc``
    ``(batch, nb, 8, bk)``, ``s_el`` ``(batch, nt, ts)``; the position
    maps shared or one set an element) give ``(batch, nnz)``: the same
    ``index_add_`` into ``(batch, nnz + 1)``, each element's positions
    offset by its row."""
    lead = s_tc.shape[:-3]
    batch = math.prod(lead)
    pos_tc = torch.where(tc_pos >= 0, tc_pos, nnz).expand(s_tc.shape)
    pos_el = torch.where(el_mask, el_pos, nnz).expand(s_el.shape)
    pos = torch.cat([pos_tc.reshape(batch, -1), pos_el.reshape(batch, -1)],
                    1).long()
    pos += torch.arange(batch, device=pos.device)[:, None] * (nnz + 1)
    data = torch.cat([s_tc.reshape(batch, -1), s_el.reshape(batch, -1)], 1)
    out = torch.zeros((batch * (nnz + 1),), dtype=torch.float32,
                      device=data.device)
    out.index_add_(0, pos.reshape(-1), data.reshape(-1))
    return out.view(batch, nnz + 1)[:, :nnz].reshape(*lead, nnz)


def revalue_spmm_arrays(arrs, edge_vals):
    """Rebuild plan value tensors from a runtime per-edge value vector
    (canonical CSR nnz order). The sparsity pattern, and so the whole
    plan, is fixed; only values change (e.g. GNN attention weights).
    A ``(batch, nnz)`` stack of value vectors gives every value tensor a
    leading batch axis, one gather ``edge_vals[:, pos]`` a table: the
    per-panel tables of a stack apply."""
    src = edge_vals if edge_vals.shape[-1] else edge_vals.new_zeros(
        (*edge_vals.shape[:-1], 1))

    def from_pos(pos):
        return torch.where(pos >= 0, src[..., pos.clamp(min=0).long()],
                           0.0).to(torch.float32)

    out = dict(arrs)
    for vals_key, pos_key in (("tc_vals", "tc_pos"), ("vpu_vals", "vpu_pos"),
                              ("tc_seg_vals", "tc_seg_pos"),
                              ("vpu_seg_vals", "vpu_seg_pos")):
        if pos_key in arrs:
            out[vals_key] = from_pos(arrs[pos_key])
    return out


def spmm_dense_oracle(a_dense: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.asarray(a_dense, np.float64) @ np.asarray(b, np.float64)


def sddmm_dense_oracle(a_dense: np.ndarray, x: np.ndarray, y: np.ndarray):
    """Full dense S = X·Yᵀ sampled at a_dense's non-zeros → CSR-ordered vals."""
    s = np.asarray(x, np.float64) @ np.asarray(y, np.float64).T
    rows, cols = np.nonzero(a_dense)
    order = np.lexsort((cols, rows))
    return s[rows[order], cols[order]]
