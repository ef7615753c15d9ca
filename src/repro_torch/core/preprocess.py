"""Libra preprocessing: distribution + balancing + format build (paper §4.5).

Preprocessing runs once per sparse matrix on the host (NumPy); its
products (:class:`SpMMPlan` / :class:`SDDMMPlan`) are uploaded once and
reused every apply. The plans equal the reference package's for the
same matrix and config, array for array.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.balance import (
    BalanceParams,
    Segments,
    decompose_counts,
    propagate_atomicity,
)
from repro_torch.core.distribution import split_sddmm_window
from repro_torch.core.formats import (
    COOTiles,
    SDDMMPlan,
    SpMMPlan,
    TCBlocks,
    VPUTiles,
    WINDOW,
)
from repro_torch.core.windows import extract_windows, num_windows
from repro_torch.obs.trace import StageClock
from repro_torch.reorder import (
    Reordering,
    apply_reorder,
    decide_reorder,
    reorder_gain,
    reorder_rows,
)
from repro_torch.sparse.matrix import SparseCSR
from repro_torch.tune import PlanCache, tune_sddmm, tune_spmm
from repro_torch.tune.cache import reorder_key, tune_key
from repro_torch.tune.model import TuneConfig, matrix_features

DEFAULT_SPMM_THRESHOLD = 3    # paper Fig. 11: optimal ≈ 3 for 8×1 vectors
DEFAULT_SDDMM_THRESHOLD = 24  # paper Fig. 11: optimal ≈ 24 for 8×16 blocks
DEFAULT_BK_SPMM = 32          # condensed block depth
DEFAULT_BK_SDDMM = 16         # paper: 8×16 TC blocks for SDDMM


def threshold_for_mode_spmm(mode: str, threshold: int | None = None) -> int:
    """SpMM threshold under the single-resource ablation modes."""
    if mode == "tcu":
        return 1  # every non-zero vector passes → Tensor Core only
    if mode == "vpu":
        return WINDOW + 1  # nothing passes → CUDA cores only
    return DEFAULT_SPMM_THRESHOLD if threshold is None else threshold


def threshold_for_mode_sddmm(mode: str, bk: int,
                             threshold: int | None = None) -> int:
    """SDDMM block threshold under the single-resource ablation modes."""
    if mode == "tcu":
        return 1
    if mode == "vpu":
        return 8 * bk + 1  # no block can reach it → element path only
    return DEFAULT_SDDMM_THRESHOLD if threshold is None else threshold


def forced_threshold(op: str, spec) -> int | None:
    """The threshold ``spec`` hands the tuner for ``op``: the one its
    single-resource mode pins, else the explicit one (None: the tuner
    picks it)."""
    if op == "spmm":
        if spec.mode == "hybrid":
            return spec.threshold
        return threshold_for_mode_spmm(spec.mode, spec.threshold)
    if spec.mode == "hybrid":
        return spec.sddmm_threshold
    bk = DEFAULT_BK_SDDMM if spec.bk is None else spec.bk
    return threshold_for_mode_sddmm(spec.mode, bk, spec.sddmm_threshold)


def search_tune_key(a: SparseCSR, op: str, spec) -> str | None:
    """The :class:`~repro_torch.tune.cache.PlanCache` key a
    ``tune="search"`` build of ``op`` on ``a`` (the matrix the plan is
    built on) resolves through under ``spec``; None for any other
    ``tune``."""
    if not isinstance(spec.tune, str) or spec.tune != "search":
        return None
    return tune_key(a, op=op,
                    width=spec.tune_n if op == "spmm" else spec.tune_kf,
                    dtype="float32", backend=spec.tune_backend,
                    mode=spec.mode, tune="search",
                    threshold=forced_threshold(op, spec), bk=spec.bk,
                    ts_tile=spec.ts_tile)


def _resolve(explicit, cfg_value, default):
    """Plan parameters resolve explicit arg > TuneConfig field > default."""
    if explicit is not None:
        return explicit
    if cfg_value is not None:
        return cfg_value
    return default


def _resolve_balance(balance: BalanceParams | None,
                     cfg: TuneConfig | None) -> BalanceParams:
    """§4.3 segment caps resolve explicit ``balance`` > ``cfg.ts``/``cfg.cs``
    > the :class:`BalanceParams` defaults. A cap of 0 disables that
    path's segmentation (per-block / per-tile launch)."""
    if balance is not None:
        return balance
    return BalanceParams(
        ts=_resolve(None, cfg and cfg.ts, BalanceParams.ts),
        cs=_resolve(None, cfg and cfg.cs, BalanceParams.cs))


def _propagate_segment_atomicity(
        tc_seg: Segments | None, vpu_seg: Segments | None
) -> tuple[Segments | None, Segments | None]:
    """Paper Fig. 6 window-1 rule at segment granularity: once any
    segment writing into a window is atomic (decomposed or shared), every
    other segment of that window becomes atomic too. CUDA-core segment
    owners are rows; their window is ``row // WINDOW``."""
    if tc_seg is None or vpu_seg is None or not tc_seg.nseg \
            or not vpu_seg.nseg:
        return tc_seg, vpu_seg
    vpu_win = vpu_seg.cur // WINDOW
    hot = np.union1d(tc_seg.cur[tc_seg.atomic], vpu_win[vpu_seg.atomic])
    tc_seg = dataclasses.replace(
        tc_seg, atomic=tc_seg.atomic | np.isin(tc_seg.cur, hot))
    vpu_seg = dataclasses.replace(
        vpu_seg, atomic=vpu_seg.atomic | np.isin(vpu_win, hot))
    return tc_seg, vpu_seg


def _spmm_segments(tc_blocks_per_win: np.ndarray, shared: np.ndarray,
                   tiles_per_row: np.ndarray, row_shared: np.ndarray,
                   balance: BalanceParams, ts_tile: int
                   ) -> tuple[Segments | None, Segments | None, int]:
    """Build both §4.3 segment launch tables for one SpMM plan.

    TC segments own ≤ ``ts`` condensed blocks of one window; CUDA-core
    segments own ≤ ``cs`` residual elements (whole ``ts_tile`` tiles) of
    one row. Returns ``(tc_seg, vpu_seg, spt)`` where ``spt`` is the
    tiles-per-segment grouping.
    """
    spt = max(1, balance.cs // max(ts_tile, 1))
    tc_seg = (decompose_counts(tc_blocks_per_win, balance.ts, shared)
              if balance.ts > 0 else None)
    vpu_seg = (decompose_counts(tiles_per_row, spt, row_shared)
               if balance.cs > 0 else None)
    tc_seg, vpu_seg = _propagate_segment_atomicity(tc_seg, vpu_seg)
    return tc_seg, vpu_seg, spt


def _pad_blocks(vals, cols, bitmap, window, atomic, nnz, bk, pos=None) -> TCBlocks:
    if len(vals) == 0:
        # Dummy zero block keeps kernel shapes static; contributes nothing.
        vals = [np.zeros((WINDOW, bk), np.float32)]
        cols = [np.zeros(bk, np.int32)]
        bitmap = [np.zeros(bk, np.uint32)]
        window = [0]
        atomic = [False]
        pos = [np.full((WINDOW, bk), -1, np.int32)] if pos is not None else None
    return TCBlocks(
        vals=np.stack(vals).astype(np.float32),
        cols=np.stack(cols).astype(np.int32),
        bitmap=np.stack(bitmap).astype(np.uint32),
        window=np.asarray(window, np.int32),
        atomic=np.asarray(atomic, bool),
        nnz=nnz,
        bk=bk,
        pos=np.stack(pos).astype(np.int32) if pos is not None else None,
    )


def _empty_vpu_tiles(ts_tile: int) -> VPUTiles:
    return VPUTiles(np.zeros((1, ts_tile), np.float32),
                    np.zeros((1, ts_tile), np.int32),
                    np.zeros(1, np.int32), np.zeros(1, bool),
                    np.zeros(1, bool), 0, ts_tile,
                    pos=np.full((1, ts_tile), -1, np.int32))


def preprocess_spmm(
    a: SparseCSR,
    threshold: int | None = None,
    bk: int | None = None,
    ts_tile: int | None = None,
    balance: BalanceParams | None = None,
    cfg: TuneConfig | None = None,
) -> SpMMPlan:
    """2D-aware distribution at vector granularity + hybrid balancing.

    Bulk-vectorized NumPy (no per-element Python). Plan parameters come
    from ``cfg`` when one is passed — explicit arguments still win,
    module defaults back-stop both.

    Ordering contracts: TC blocks are window-sorted (so
    :class:`TCBlocks` derives the compaction rank map) and residual
    tiles are row-sorted.
    """
    threshold = _resolve(threshold, cfg and cfg.threshold,
                         DEFAULT_SPMM_THRESHOLD)
    bk = _resolve(bk, cfg and cfg.bk, DEFAULT_BK_SPMM)
    ts_tile = _resolve(ts_tile, cfg and cfg.ts_tile, 32)
    balance = _resolve_balance(balance, cfg)
    nwin = num_windows(a.m)
    rows, cols, vals = a.to_coo()
    pos = np.arange(rows.shape[0], dtype=np.int32)
    win = (rows // WINDOW).astype(np.int64)
    sub = (rows % WINDOW).astype(np.int64)

    # ---- Stage 1 (paper Alg. 1 step 1): vector identification.
    order = np.lexsort((sub, cols, win))
    winS, subS, colS, valS, posS = (win[order], sub[order], cols[order],
                                    vals[order], pos[order])
    if winS.size == 0:
        return _empty_spmm_plan(a, threshold, bk, ts_tile, balance)
    newvec = np.ones(winS.size, bool)
    newvec[1:] = (winS[1:] != winS[:-1]) | (colS[1:] != colS[:-1])
    vec_id = np.cumsum(newvec) - 1
    nvec = int(vec_id[-1]) + 1
    vec_count = np.bincount(vec_id, minlength=nvec)
    vec_win = winS[newvec]
    vec_col = colS[newvec]

    # ---- Stage 2: 2D-aware threshold split at vector granularity.
    vec_tc = vec_count >= threshold
    el_tc = vec_tc[vec_id]
    tc_nnz = int(vec_count[vec_tc].sum())
    vpu_nnz = a.nnz - tc_nnz
    win_has_tc = np.zeros(nwin, bool)
    win_has_vpu = np.zeros(nwin, bool)
    win_has_tc[vec_win[vec_tc]] = True
    win_has_vpu[vec_win[~vec_tc]] = True
    shared = win_has_tc & win_has_vpu

    # ---- Stage 3a: condense TC vectors into 8×bk blocks (bulk scatter).
    tc_vec_idx = np.nonzero(vec_tc)[0]
    if tc_vec_idx.size:
        tws = vec_win[tc_vec_idx]
        first_in_win = np.ones(tc_vec_idx.size, bool)
        first_in_win[1:] = tws[1:] != tws[:-1]
        grp_start = np.maximum.accumulate(
            np.where(first_in_win, np.arange(tc_vec_idx.size), 0))
        rank = np.arange(tc_vec_idx.size) - grp_start
        blk_in_win = rank // bk
        slot = rank % bk
        blocks_per_win = np.zeros(nwin, np.int64)
        np.add.at(blocks_per_win, tws, (slot == 0).astype(np.int64))
        win_blk_off = np.zeros(nwin, np.int64)
        np.cumsum(blocks_per_win, out=win_blk_off[:])
        win_blk_off = np.concatenate([[0], win_blk_off])[:-1]
        vec_blk = win_blk_off[tws] + blk_in_win  # global block per TC vector
        nblk = int(blocks_per_win.sum())
        tc_vals_arr = np.zeros((nblk, WINDOW, bk), np.float32)
        tc_cols_arr = np.zeros((nblk, bk), np.int32)
        tc_bits_arr = np.zeros((nblk, bk), np.uint32)
        tc_pos_arr = np.full((nblk, WINDOW, bk), -1, np.int32)
        tc_win_arr = np.zeros(nblk, np.int32)
        tc_cols_arr[vec_blk, slot] = vec_col[tc_vec_idx]
        tc_win_arr[vec_blk] = tws
        # per-vector → per-element scatter
        vec_to_tcrank = np.full(nvec, -1, np.int64)
        vec_to_tcrank[tc_vec_idx] = np.arange(tc_vec_idx.size)
        el_rank = vec_to_tcrank[vec_id]
        sel = el_tc
        eb = vec_blk[el_rank[sel]]
        es = slot[el_rank[sel]]
        tc_vals_arr[eb, subS[sel], es] = valS[sel]
        tc_pos_arr[eb, subS[sel], es] = posS[sel]
        np.bitwise_or.at(tc_bits_arr, (eb, es),
                         np.uint32(1) << subS[sel].astype(np.uint32))
        blk_atomic = shared[tc_win_arr]
        tc_blocks_per_win = blocks_per_win
    else:
        tc_vals_arr = None
        tc_win_arr = np.zeros(0, np.int32)
        blk_atomic = np.zeros(0, bool)
        tc_blocks_per_win = np.zeros(nwin, np.int64)

    # ---- Stage 3b: residue → row tiles (short/long split, Cs bounded).
    res_sel = ~el_tc
    r_rows = rows[order][res_sel]
    r_cols = colS[res_sel]
    r_vals = valS[res_sel]
    r_pos = posS[res_sel]
    order2 = np.lexsort((r_cols, r_rows))
    r_rows, r_cols, r_vals, r_pos = (r_rows[order2], r_cols[order2],
                                     r_vals[order2], r_pos[order2])
    if r_rows.size:
        firstr = np.ones(r_rows.size, bool)
        firstr[1:] = r_rows[1:] != r_rows[:-1]
        rstart = np.maximum.accumulate(
            np.where(firstr, np.arange(r_rows.size), 0))
        rrank = np.arange(r_rows.size) - rstart
        row_len = np.bincount(r_rows, minlength=a.m)
        tile_in_row = rrank // ts_tile
        tslot = rrank % ts_tile
        tiles_per_row = (row_len + ts_tile - 1) // ts_tile
        row_tile_off = np.concatenate([[0], np.cumsum(tiles_per_row)])[:-1]
        el_tile = row_tile_off[r_rows] + tile_in_row
        ntiles = int(tiles_per_row.sum())
        t_vals_arr = np.zeros((ntiles, ts_tile), np.float32)
        t_cols_arr = np.zeros((ntiles, ts_tile), np.int32)
        t_pos_arr = np.full((ntiles, ts_tile), -1, np.int32)
        t_vals_arr[el_tile, tslot] = r_vals
        t_cols_arr[el_tile, tslot] = r_cols
        t_pos_arr[el_tile, tslot] = r_pos
        t_row_arr = np.zeros(ntiles, np.int32)
        t_row_arr[el_tile] = r_rows
        t_long_arr = row_len[t_row_arr] > balance.short_len
        tile_atomic = (win_has_tc[t_row_arr // WINDOW]
                       | (tiles_per_row[t_row_arr] > 1))
    else:
        t_vals_arr = None
        t_row_arr = np.zeros(0, np.int32)
        tile_atomic = np.zeros(0, bool)
        tiles_per_row = np.zeros(a.m, np.int64)

    if len(tc_win_arr):
        blk_atomic, tile_atomic = propagate_atomicity(
            tc_win_arr.astype(np.int64), blk_atomic,
            t_row_arr.astype(np.int64) // WINDOW, tile_atomic)

    if tc_vals_arr is not None:
        tc = TCBlocks(tc_vals_arr, tc_cols_arr, tc_bits_arr, tc_win_arr,
                      np.asarray(blk_atomic, bool), tc_nnz, bk,
                      pos=tc_pos_arr)
    else:
        tc = _pad_blocks([], [], [], [], [], 0, bk, pos=[])
    if t_vals_arr is not None:
        vpu = VPUTiles(t_vals_arr, t_cols_arr, t_row_arr, t_long_arr,
                       np.asarray(tile_atomic, bool), vpu_nnz, ts_tile,
                       pos=t_pos_arr)
    else:
        vpu = _empty_vpu_tiles(ts_tile)

    row_shared = win_has_tc[np.arange(a.m, dtype=np.int64) // WINDOW] \
        if a.m else np.zeros(0, bool)
    tc_seg, vpu_seg, spt = _spmm_segments(
        tc_blocks_per_win, shared, tiles_per_row, row_shared,
        balance, ts_tile)
    meta = {
        "tc_segments": tc_seg,
        "vpu_segments": vpu_seg,
        "seg_spt": spt,
        "tc_nnz": tc_nnz,
        "vpu_nnz": vpu_nnz,
        "tc_ratio": tc_nnz / max(a.nnz, 1),
        "has_tc": bool(tc_nnz),
        "has_vpu": bool(vpu_nnz),
        "balance": balance,
    }
    if tc_nnz + vpu_nnz != a.nnz:
        raise AssertionError((tc_nnz, vpu_nnz, a.nnz))
    return SpMMPlan(a.m, a.k, a.nnz, threshold, tc, vpu, meta)


def _empty_spmm_plan(a, threshold, bk, ts_tile, balance) -> SpMMPlan:
    tc = _pad_blocks([], [], [], [], [], 0, bk, pos=[])
    vpu = _empty_vpu_tiles(ts_tile)
    tc_seg, vpu_seg, spt = _spmm_segments(
        np.zeros(num_windows(a.m), np.int64),
        np.zeros(num_windows(a.m), bool),
        np.zeros(a.m, np.int64),
        np.zeros(a.m, bool), balance, ts_tile)
    meta = {"tc_segments": tc_seg, "vpu_segments": vpu_seg, "seg_spt": spt,
            "tc_nnz": 0, "vpu_nnz": 0, "tc_ratio": 0.0,
            "has_tc": False, "has_vpu": False, "balance": balance}
    return SpMMPlan(a.m, a.k, a.nnz, threshold, tc, vpu, meta)


def preprocess_sddmm(
    a: SparseCSR,
    threshold: int | None = None,
    bk: int | None = None,
    ts_tile: int | None = None,
    balance: BalanceParams | None = None,
    cfg: TuneConfig | None = None,
) -> SDDMMPlan:
    """Block-granularity distribution for SDDMM (densest-first packing).

    Like :func:`preprocess_spmm`, plan parameters resolve explicit arg >
    ``cfg`` > default.
    """
    threshold = _resolve(threshold, cfg and cfg.threshold,
                         DEFAULT_SDDMM_THRESHOLD)
    bk = _resolve(bk, cfg and cfg.bk, DEFAULT_BK_SDDMM)
    ts_tile = _resolve(ts_tile, cfg and cfg.ts_tile, 32)
    balance = _resolve_balance(balance, cfg)
    wvs = extract_windows(a)
    nwin = num_windows(a.m)

    # Canonical (row, col) → nnz-position map, following CSR order.
    pos_lookup: dict[tuple[int, int], int] = {}
    rows, cols, _ = a.to_coo()
    for p, (r, c) in enumerate(zip(rows.tolist(), cols.tolist())):
        pos_lookup[(r, c)] = p

    blk_cols, blk_bits, blk_win, blk_pos, blk_vals = [], [], [], [], []
    tc_blocks_per_win = np.zeros(nwin, np.int64)
    tc_nnz = 0
    el_rows, el_cols, el_pos = [], [], []
    win_has_tc = np.zeros(nwin, bool)
    win_has_vpu = np.zeros(nwin, bool)

    for w, wv in enumerate(wvs):
        split = split_sddmm_window(wv, threshold, bk)
        for blk in split.blocks:
            win_has_tc[w] = True
            c = np.zeros(bk, np.int32)
            b = np.zeros(bk, np.uint32)
            v = np.zeros((WINDOW, bk), np.float32)
            p = np.full((WINDOW, bk), -1, np.int32)
            c[: blk.size] = wv.cols[blk]
            b[: blk.size] = wv.bitmap[blk]
            v[:, : blk.size] = wv.vals[blk].T
            for j, vi in enumerate(blk):
                for sub in np.nonzero(wv.vals[vi])[0]:
                    p[sub, j] = pos_lookup[(w * WINDOW + int(sub), int(wv.cols[vi]))]
                    tc_nnz += 1
            blk_cols.append(c)
            blk_bits.append(b)
            blk_vals.append(v)
            blk_win.append(w)
            blk_pos.append(p)
            tc_blocks_per_win[w] += 1
        for vi in split.vpu_vec_idx:
            win_has_vpu[w] = True
            col = int(wv.cols[vi])
            for sub in np.nonzero(wv.vals[vi])[0]:
                r = w * WINDOW + int(sub)
                el_rows.append(r)
                el_cols.append(col)
                el_pos.append(pos_lookup[(r, col)])

    shared = win_has_tc & win_has_vpu
    blk_atomic = np.asarray([bool(shared[w]) for w in blk_win], bool) \
        if blk_win else np.zeros(0, bool)

    if blk_cols:
        tc = TCBlocks(
            np.stack(blk_vals), np.stack(blk_cols), np.stack(blk_bits),
            np.asarray(blk_win, np.int32), blk_atomic, tc_nnz, bk,
        )
        tc_out_pos = np.stack(blk_pos)
    else:
        tc = TCBlocks(
            np.zeros((1, WINDOW, bk), np.float32), np.zeros((1, bk), np.int32),
            np.zeros((1, bk), np.uint32), np.zeros(1, np.int32),
            np.zeros(1, bool), 0, bk,
        )
        tc_out_pos = np.full((1, WINDOW, bk), -1, np.int32)

    # Element tiles for the CUDA-core path.
    n_el = len(el_rows)
    nt = max(1, (n_el + ts_tile - 1) // ts_tile)
    er = np.zeros((nt, ts_tile), np.int32)
    ec = np.zeros((nt, ts_tile), np.int32)
    ep = np.zeros((nt, ts_tile), np.int32)
    em = np.zeros((nt, ts_tile), bool)
    if n_el:
        er.reshape(-1)[:n_el] = np.asarray(el_rows, np.int32)
        ec.reshape(-1)[:n_el] = np.asarray(el_cols, np.int32)
        ep.reshape(-1)[:n_el] = np.asarray(el_pos, np.int32)
        em.reshape(-1)[:n_el] = True
    vpu = COOTiles(er, ec, ep, em, n_el, ts_tile)

    meta = {
        "tc_nnz": tc_nnz,
        "vpu_nnz": n_el,
        "tc_ratio": tc_nnz / max(a.nnz, 1),
        "has_tc": bool(tc_nnz),
        "has_vpu": bool(n_el),
        # §4.3 segment tables: windows decomposed at ≤ ts blocks. SDDMM
        # element tiles are flat (every score has its own canonical
        # output slot ⇒ no atomicity), so the Cs cap only batches
        # ``seg_spt`` tiles per segment.
        "tc_segments": (decompose_counts(tc_blocks_per_win, balance.ts,
                                         shared)
                        if balance.ts > 0 else None),
        "vpu_segments": None,
        "seg_spt": max(1, balance.cs // max(ts_tile, 1)),
        "balance": balance,
    }
    if tc_nnz + n_el != a.nnz:
        raise AssertionError((tc_nnz, n_el, a.nnz))
    return SDDMMPlan(a.m, a.k, a.nnz, threshold, tc, tc_out_pos, vpu, meta)


def preprocess_spmm_loop(a: SparseCSR, threshold: int = DEFAULT_SPMM_THRESHOLD,
                         bk: int = DEFAULT_BK_SPMM, ts_tile: int = 32,
                         balance: BalanceParams | None = None) -> SpMMPlan:
    """Scalar-loop baseline (the paper's sequential-CPU comparison point).

    Walks the matrix one element at a time in pure Python — window
    extraction, vector counting, bitmap building, threshold split, block
    condensation and residue tiling all scalar. Produces a plan with the
    same tensors as :func:`preprocess_spmm` (bit-identity tested); used by
    the preprocessing benchmark to quantify the bulk-vectorized win (the
    analogue of the paper's GPU-vs-OpenMP 17.1×).
    """
    balance = balance or BalanceParams()
    nwin = num_windows(a.m)
    # 1) scalar window extraction: (win, col) → [(sub, val, pos)]
    wincols: list[dict[int, list[tuple[int, float, int]]]] = \
        [dict() for _ in range(nwin)]
    p = 0
    for r in range(a.m):
        lo, hi = int(a.indptr[r]), int(a.indptr[r + 1])
        for i in range(lo, hi):
            c = int(a.indices[i])
            wincols[r // WINDOW].setdefault(c, []).append(
                (r % WINDOW, float(a.data[i]), p))
            p += 1

    blk_vals, blk_cols, blk_bits, blk_win, blk_pos = [], [], [], [], []
    t_vals, t_cols, t_row, t_long, t_pos = [], [], [], [], []
    tc_nnz = vpu_nnz = 0
    for w in range(nwin):
        tc_sel = []
        residue: dict[int, list[tuple[int, float, int]]] = {}
        for c in sorted(wincols[w]):
            entries = wincols[w][c]
            if len(entries) >= threshold:
                tc_sel.append(c)
                tc_nnz += len(entries)
            else:
                for sub, v, pp in entries:
                    residue.setdefault(w * WINDOW + sub, []).append((c, v, pp))
                    vpu_nnz += 1
        for s in range(0, len(tc_sel), bk):
            part = tc_sel[s : s + bk]
            v = np.zeros((WINDOW, bk), np.float32)
            cc = np.zeros(bk, np.int32)
            bb = np.zeros(bk, np.uint32)
            ppos = np.full((WINDOW, bk), -1, np.int32)
            for j, c in enumerate(part):
                cc[j] = c
                for sub, val, pp in wincols[w][c]:
                    v[sub, j] = val
                    bb[j] |= np.uint32(1) << np.uint32(sub)
                    ppos[sub, j] = pp
            blk_vals.append(v)
            blk_cols.append(cc)
            blk_bits.append(bb)
            blk_win.append(w)
            blk_pos.append(ppos)
        for r in sorted(residue):
            ent = residue[r]
            is_long = len(ent) > balance.short_len
            for s in range(0, len(ent), ts_tile):
                seg = ent[s : s + ts_tile]
                cc = np.zeros(ts_tile, np.int32)
                vv = np.zeros(ts_tile, np.float32)
                pp = np.full(ts_tile, -1, np.int32)
                for j, (c, val, pos_) in enumerate(seg):
                    cc[j], vv[j], pp[j] = c, val, pos_
                t_cols.append(cc)
                t_vals.append(vv)
                t_pos.append(pp)
                t_row.append(r)
                t_long.append(is_long)

    tc = _pad_blocks(blk_vals, blk_cols, blk_bits, blk_win,
                     [False] * len(blk_win), tc_nnz, bk, pos=blk_pos)
    if t_vals:
        vpu = VPUTiles(np.stack(t_vals), np.stack(t_cols),
                       np.asarray(t_row, np.int32),
                       np.asarray(t_long, bool),
                       np.zeros(len(t_row), bool), vpu_nnz, ts_tile,
                       pos=np.stack(t_pos))
    else:
        vpu = _empty_vpu_tiles(ts_tile)
    meta = {"tc_nnz": tc_nnz, "vpu_nnz": vpu_nnz,
            "tc_ratio": tc_nnz / max(a.nnz, 1), "has_tc": bool(tc_nnz),
            "has_vpu": bool(vpu_nnz), "balance": balance,
            "tc_segments": None, "vpu_segments": None, "seg_spt": 1}
    return SpMMPlan(a.m, a.k, a.nnz, threshold, tc, vpu, meta)


#: The stages of :meth:`Plan.build`, timed in ``plan.meta["build_s"]``.
BUILD_STAGES = ("features", "reorder", "tune", "preprocess")

#: Process-local reorder decisions for runs without a PlanCache,
#: keyed like the cache entries (pattern signature + op + threshold).
_REORDER_MEMO: dict[str, dict] = {}


def _reorder_store(cache):
    if cache is None:
        return None
    return cache if isinstance(cache, PlanCache) else PlanCache(cache)


def _get_reorder_decision(cache, key: str) -> dict | None:
    pc = _reorder_store(cache)
    return _REORDER_MEMO.get(key) if pc is None else pc.get_doc(key)


def _put_reorder_decision(cache, key: str, doc: dict) -> None:
    pc = _reorder_store(cache)
    if pc is None:
        _REORDER_MEMO[key] = doc
    else:
        pc.put_doc(key, doc)


def _maybe_reorder(a: SparseCSR, *, op: str, spec, threshold: int, feat,
                   stages: StageClock | None = None):
    """Resolve ``spec.reorder`` for one build.

    Returns ``(a_eff, reord, report, feat_eff)``: the matrix to
    preprocess (reordered or original), the
    :class:`repro_torch.reorder.Reordering` (None when off, declined, or
    the matrix is empty or one window tall), the report
    ``plan.meta["reorder"]`` keeps, and the matrix features describing
    ``a_eff`` (``feat`` unchanged when never computed), so the tuner
    prices the reordered matrix without a second pass.

    ``"auto"`` prices the permutation from the same
    :func:`~repro_torch.tune.model.matrix_features` pass the tuner
    consumes — projected Tensor Core nnz fraction at ``threshold``
    (:func:`~repro_torch.reorder.reorder_gain`) against
    :data:`~repro_torch.reorder.MIN_TC_GAIN` — and keeps the decision
    under :func:`~repro_torch.tune.cache.reorder_key` in
    ``spec.tune_cache`` (or the process memo without one). A decline
    cached before skips the sketch pass. ``stages`` times the reordering
    and its feature passes (``plan.reorder`` > ``plan.features``).
    """
    mode = spec.reorder
    if mode == "off" or a.nnz == 0 or a.m <= WINDOW:
        return a, None, {"mode": mode, "enabled": False}, feat
    stages = StageClock() if stages is None else stages
    with stages.stage("reorder"):
        key = reorder_key(a, op=op, threshold=threshold)
        if mode == "auto":
            cached = _get_reorder_decision(spec.tune_cache, key)
            if cached is not None and not cached.get("enabled"):
                # Declined before for this pattern: skip the sketch pass.
                return a, None, {"mode": mode, **cached}, feat
        reord = reorder_rows(a)
        a_r = apply_reorder(a, reord)
        with stages.stage("features"):
            if feat is None:
                feat = matrix_features(a)
            feat_r = matrix_features(a_r)
        gain = reorder_gain(feat, feat_r, threshold)
    enabled = True if mode == "on" else decide_reorder(gain)
    report = {"mode": mode, "enabled": bool(enabled), **gain}
    if mode == "auto":
        _put_reorder_decision(spec.tune_cache, key,
                              {"enabled": bool(enabled), **gain})
    if not enabled:
        return a, None, report, feat
    return a_r, reord, report, feat_r


def _remap_positions(pos: np.ndarray, nnz_perm: np.ndarray) -> np.ndarray:
    """Rewrite a plan ``pos`` tensor (−1 padded) from reordered-canonical
    to original-canonical nnz positions, so revaluation keeps taking
    original-order ``edge_vals``. The −1 pattern, and with it the real
    lengths derived from it, is unchanged."""
    take = nnz_perm.astype(np.int32)
    return np.where(pos >= 0, take[np.maximum(pos, 0)],
                    np.int32(-1)).astype(np.int32)


def _remap_spmm_plan(plan: SpMMPlan, nnz_perm: np.ndarray) -> SpMMPlan:
    tc = plan.tc
    if tc.pos is not None:
        tc = dataclasses.replace(tc, pos=_remap_positions(tc.pos, nnz_perm))
    vpu = plan.vpu
    if vpu.pos is not None:
        vpu = dataclasses.replace(vpu,
                                  pos=_remap_positions(vpu.pos, nnz_perm))
    return dataclasses.replace(plan, tc=tc, vpu=vpu)


def _remap_sddmm_plan(plan: SDDMMPlan, nnz_perm: np.ndarray) -> SDDMMPlan:
    out_pos = _remap_positions(plan.tc_out_pos, nnz_perm)
    take = nnz_perm.astype(np.int32)
    vpu = plan.vpu
    # COOTiles pads with mask=False / out_pos=0 — keep padding at 0.
    vpu = dataclasses.replace(
        vpu, out_pos=np.where(vpu.mask, take[vpu.out_pos],
                              np.int32(0)).astype(np.int32))
    return dataclasses.replace(plan, tc_out_pos=out_pos, vpu=vpu)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The supported entry point for building one operator's plan.

    ``Plan.build(a, op, spec)`` wraps the whole pipeline: resolve the
    :class:`repro_torch.api.ExecSpec` (mode → forced threshold), price
    and apply row reordering (:mod:`repro_torch.reorder`), tune
    (:mod:`repro_torch.tune`: ``tune`` → :class:`TuneConfig`) and
    preprocess. A reordered plan's position maps (``pos``, ``out_pos``)
    are rewritten to the *original* matrix's canonical nnz positions, so
    ``edge_vals`` revaluation takes original-order values and SDDMM
    outputs land in original order.

    Fields:
      op:      "spmm" | "sddmm"
      spec:    the :class:`~repro_torch.api.ExecSpec`
      cfg:     the tuned :class:`~repro_torch.tune.model.TuneConfig`
      plan:    :class:`SpMMPlan` / :class:`SDDMMPlan`; ``plan.meta
               ["reorder"]`` records the decision and density deltas
      a:       the matrix the plan was built on — the reordered view
               when reordering was applied, else the input matrix
      reorder: the :class:`~repro_torch.reorder.Reordering`, or None.
               SpMM callers unpermute outputs with one
               ``index_select(0, reorder.row_inv)``; SDDMM callers gather
               X's rows with ``reorder.row_perm`` (outputs already land
               in original canonical order).

    ``plan.meta["build_s"]`` holds the build's host seconds by stage:
    ``features`` (the feature passes of the reorder pricing), ``reorder``,
    ``tune`` (a feature pass the tuner makes itself included),
    ``preprocess`` (with the position remap) and ``rest``; each is also
    a ``plan.<stage>`` span under the build's ``plan.build``.
    """

    op: str
    spec: "object"
    cfg: TuneConfig
    plan: SpMMPlan | SDDMMPlan
    a: SparseCSR
    reorder: Reordering | None

    @classmethod
    def build(cls, a: SparseCSR, op: str, spec=None, *,
              balance: BalanceParams | None = None, timer=None,
              feat=None, leg: str | None = None) -> "Plan":
        """Build the plan for ``op`` on ``a`` under ``spec``.

        ``balance`` (explicit §4.3 caps, overriding ``cfg.ts/cs``),
        ``timer`` (search timing hook) and ``feat`` (a precomputed
        ``matrix_features(a)``) are expert escape hatches forwarded to
        the pipeline stages. ``leg`` names the build on its span
        (default ``"A"`` for SpMM, ``"SDDMM"`` for SDDMM).
        """
        from repro_torch.api import ExecSpec

        spec = ExecSpec() if spec is None else spec
        if op not in ("spmm", "sddmm"):
            raise ValueError(f"op must be 'spmm' or 'sddmm', got {op!r}")
        leg = leg or ("A" if op == "spmm" else "SDDMM")
        stages = StageClock()
        with stages.stage("build", op=op, leg=leg):
            built = cls._build(a, op, spec, balance, timer, feat, stages)
        seconds = {k: stages.seconds.get(k, 0.0) for k in BUILD_STAGES}
        seconds["rest"] = stages.seconds["build"]
        built.plan.meta["build_s"] = seconds
        return built

    @classmethod
    def _build(cls, a, op, spec, balance, timer, feat,
               stages: StageClock) -> "Plan":
        mode = spec.mode
        forced = forced_threshold(op, spec)
        if op == "spmm":
            guess = DEFAULT_SPMM_THRESHOLD if forced is None else forced
        else:
            bk_eff = DEFAULT_BK_SDDMM if spec.bk is None else spec.bk
            guess = DEFAULT_SDDMM_THRESHOLD if forced is None else forced
        a_eff, reord, report, feat_eff = _maybe_reorder(
            a, op=op, spec=spec, threshold=guess, feat=feat, stages=stages)
        tune_kw = dict(mode=mode, threshold=forced, tune=spec.tune,
                       backend=spec.tune_backend, cache=spec.tune_cache,
                       timer=timer, bk=spec.bk, ts_tile=spec.ts_tile,
                       feat=feat_eff, device=spec.device)
        if op == "spmm":
            with stages.stage("tune"):
                cfg = tune_spmm(a_eff, n=spec.tune_n, **tune_kw)
            with stages.stage("preprocess"):
                thr = threshold_for_mode_spmm(mode, cfg.threshold)
                plan = preprocess_spmm(a_eff, thr, bk=spec.bk,
                                       ts_tile=spec.ts_tile,
                                       balance=balance, cfg=cfg)
                if reord is not None:
                    plan = _remap_spmm_plan(plan, reord.nnz_perm)
        else:
            with stages.stage("tune"):
                cfg = tune_sddmm(a_eff, kf=spec.tune_kf, **tune_kw)
            with stages.stage("preprocess"):
                thr = threshold_for_mode_sddmm(mode, bk_eff, cfg.threshold)
                plan = preprocess_sddmm(a_eff, thr, bk=spec.bk,
                                        ts_tile=spec.ts_tile,
                                        balance=balance, cfg=cfg)
                if reord is not None:
                    plan = _remap_sddmm_plan(plan, reord.nnz_perm)
        plan.meta["reorder"] = report
        return cls(op=op, spec=spec, cfg=cfg, plan=plan, a=a_eff,
                   reorder=reord)
