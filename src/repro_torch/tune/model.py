"""Occupancy-aware analytical tuner (paper §4.2 + §4.4 choices, modeled).

The paper's gains come from *choosing well* per sparsity pattern: the
2D-aware workload distribution picks the Tensor Core / CUDA-core split,
and occupancy-aware task scheduling sizes work to the hardware. This
module makes those choices analytically — no timing — from cheap matrix
features, with the reference package's pricing and picks:

* a **vector histogram** (per window, how many 8×1 column vectors have
  1..8 non-zeros — the Fig.-1 statistic at full resolution), which
  prices every candidate threshold through the same roofline formulas as
  :mod:`repro_torch.core.threshold` *without building a plan per
  candidate*;
* the §4.3 Ts/Cs segment caps from the blocks-per-window and nnz-per-row
  histograms, and the residual tile width from the row histogram;
* a **Hopper footprint model** in place of the reference's VMEM model:
  the shared memory one thread block of K1 (SpMM) or K3 (SDDMM) takes,
  read from the kernels' sources, against the card's per-block budget,
  the blocks an SM holds at that footprint, and the L2-sized column
  slice K2/K4 gather from. No port kernel takes a tile from the tuner,
  so the footprint is recorded on the ``tune.model`` span and checked
  against the budget; it picks nothing.

The result is a :class:`TuneConfig` — the single object every layer
(preprocess, apply, benchmarks) is parameterized through.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from repro_torch.core.balance import BalanceParams
from repro_torch.core.formats import WINDOW
from repro_torch.core.threshold import HardwareModel
from repro_torch.kernels.sddmm_mxu import slice_feats as k3_slice_feats
from repro_torch.kernels.sddmm_vpu import slice_feats as k4_slice_feats
from repro_torch.kernels.spmm_vpu import slice_cols as k2_slice_cols
from repro_torch.obs.trace import get_tracer
from repro_torch.sparse.matrix import SparseCSR


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """One plan-selection decision.

    The plan-shaping fields keep the reference package's meaning, so a
    plan built here equals the reference plan for the same config:
    ``threshold``/``bk``/``ts_tile`` parameterize preprocessing (the
    2D-aware distribution) and ``ts``/``cs`` are the §4.3 Ts/Cs segment
    caps (None = operator default, 0 = no segmentation).

    ``kt``, ``nt``, ``kf_tile``, ``yt``, ``xt`` and ``grid_order`` are
    the TPU kernels' tiling knobs. The CUDA kernels ignore them: they
    gather rows straight from device memory and choose their own tiles,
    so the port's tuner leaves them at :data:`DEFAULT_TUNE`'s values.
    The fields stay so one config describes a plan in both packages.
    """

    kt: int = 512
    nt: int = 128
    kf_tile: int = 128
    yt: int | None = None
    xt: int | None = None
    threshold: int | None = None  # TC/VPU split (None = operator default)
    bk: int | None = None    # condensed block depth (None = operator default)
    ts_tile: int | None = None    # VPU tile width (None = operator default)
    ts: int | None = None    # max TC blocks per segment (paper Ts)
    cs: int | None = None    # max VPU elements per row-segment (paper Cs)
    grid_order: str = "n_outer"
    source: str = "default"  # default | model | search | cache

    def replace(self, **kw) -> "TuneConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_TUNE = TuneConfig()


@dataclasses.dataclass(frozen=True)
class MatrixFeatures:
    """Cheap pattern statistics driving the analytical tuner (and the
    row-reordering gain report)."""

    m: int
    k: int
    nnz: int
    nwin: int
    row_hist: np.ndarray   # (m,) nnz per row
    win_vec_hist: np.ndarray  # (nwin, WINDOW+1) vectors per window by count
    # win_vec_hist[w, c] = number of 8×1 column vectors in window w with
    # exactly c non-zeros (c in 1..WINDOW; column 0 unused).

    @property
    def window_density(self) -> float:
        """Mean fraction of occupied sublanes over non-empty vectors."""
        counts = np.arange(WINDOW + 1)
        tot_vec = self.win_vec_hist.sum()
        if tot_vec == 0:
            return 0.0
        occ = (self.win_vec_hist * counts[None, :]).sum()
        return float(occ / (tot_vec * WINDOW))

    def vectors_at_least(self, threshold: int) -> np.ndarray:
        """Per-window count of vectors with ≥ ``threshold`` non-zeros."""
        t = int(np.clip(threshold, 1, WINDOW + 1))
        return self.win_vec_hist[:, t:].sum(axis=1)

    def nnz_at_least(self, threshold: int) -> int:
        """Total non-zeros living in vectors with ≥ ``threshold`` nnz."""
        t = int(np.clip(threshold, 1, WINDOW + 1))
        counts = np.arange(WINDOW + 1)
        return int((self.win_vec_hist[:, t:] * counts[None, t:]).sum())


def matrix_features(a: SparseCSR) -> MatrixFeatures:
    """One vectorized pass: row histogram + per-window vector histogram."""
    rows, cols, _ = a.to_coo()
    nwin = (a.m + WINDOW - 1) // WINDOW
    row_hist = np.diff(a.indptr).astype(np.int64)
    win_vec_hist = np.zeros((max(nwin, 1), WINDOW + 1), np.int64)
    if rows.size:
        win = (rows // WINDOW).astype(np.int64)
        order = np.lexsort((cols, win))
        winS, colS = win[order], cols[order]
        newvec = np.ones(winS.size, bool)
        newvec[1:] = (winS[1:] != winS[:-1]) | (colS[1:] != colS[:-1])
        vec_id = np.cumsum(newvec) - 1
        vec_count = np.bincount(vec_id)
        vec_win = winS[newvec]
        np.add.at(win_vec_hist, (vec_win, vec_count), 1)
    return MatrixFeatures(a.m, a.k, a.nnz, nwin, row_hist, win_vec_hist)


# ------------------------------------------------------ Hopper footprint ---
# Shared memory one thread block keeps, from the kernels' sources. K1
# (csrc/spmm_mxu.cu, stage_floats and spmm_mxu_launch): kStages chunks of
# 32 condensed vectors, each 32 B rows at a pitch of nt + 4 and 8 value
# rows at a pitch of 40, over a tile of nt = min(128, n rounded up to a
# warp) columns, one thread a column. K3 (csrc/sddmm_mxu.cu,
# smem_bytes<kF>): 4 warps × 2 stages, each a chunk's Y rows (32, or 16
# at kF >= 128) and 8 X rows at a pitch of kF + 16 (kF when not a
# multiple of 32), 8 rows of earlier scores and the chunk's bitmaps,
# window, first column and segment, for a feature slice of kF. K2 and K4
# keep nothing in shared memory: they gather from one L2-sized column
# slice of the dense operand at a time (kernels/_build.L2_SLICE_BYTES).
K1_STAGES, K1_CHUNK, K1_TILE_COLS, K1_VPITCH = 2, 32, 128, 40
K3_WARPS, K3_STAGES = 4, 2

#: Dynamic shared memory one block may opt in to on an H100 (sm_90).
SMEM_BUDGET_BYTES = 227 * 1024
#: Shared memory of one SM, of which each resident block also takes 1 KB
#: for the system; an SM holds at most 32 blocks and 2048 threads.
SMEM_PER_SM_BYTES = 228 * 1024
SMEM_RESERVED_PER_BLOCK = 1024
MAX_BLOCKS_PER_SM, MAX_THREADS_PER_SM = 32, 2048


def k1_tile_cols(n: int) -> int:
    """Output columns (and threads) of one K1 block at width ``n``."""
    return min(K1_TILE_COLS, -(-n // 32) * 32)


def k1_smem_bytes(nt: int) -> int:
    """K1's dynamic shared memory a block, for a tile of ``nt`` columns."""
    return 4 * K1_STAGES * (K1_CHUNK * (nt + 4) + WINDOW * K1_VPITCH)


def k3_smem_bytes(kf_slice: int) -> int:
    """K3's dynamic shared memory a block, for a feature slice."""
    cols = 16 if kf_slice >= 128 else 32
    pitch = kf_slice + 16 if kf_slice % 32 == 0 else kf_slice
    stage = (cols + WINDOW) * pitch + WINDOW * cols + cols + 4
    return 4 * K3_WARPS * K3_STAGES * ((stage + 3) & ~3)


def spmm_footprint(n: int, k: int) -> dict:
    """Hopper footprint of an SpMM apply at width ``n`` over a ``k``-row
    B: K1's shared memory and threads a block, and the B columns of K2's
    L2 slice (float4 lanes when ``n`` is a multiple of 4)."""
    nt = k1_tile_cols(n)
    return {"smem_bytes": k1_smem_bytes(nt), "threads": nt,
            "l2_slice_cols": k2_slice_cols(k, n, n % 4 == 0)}


def sddmm_footprint(kf: int, k: int) -> dict:
    """Hopper footprint of an SDDMM apply at feature width ``kf`` over a
    ``k``-row Y: K3's shared memory and threads a block at its feature
    slice, and the features of K4's L2 slice. K3's wrapper sizes its
    slice on the Y rows a launch can touch, at most ``k``, so a small
    plan may take a wider slice than this."""
    kf_slice = k3_slice_feats(k, kf)
    return {"smem_bytes": k3_smem_bytes(kf_slice),
            "threads": K3_WARPS * 32, "k3_slice_feats": kf_slice,
            "l2_slice_cols": k4_slice_feats(k, kf, kf % 4 == 0)}


def occupancy_report(smem_bytes: int, threads: int,
                     budget: int = SMEM_BUDGET_BYTES) -> dict:
    """Occupancy view of a block's footprint: whether it fits the
    per-block shared-memory budget, and how many such blocks one SM
    holds by shared memory, threads and the block cap (registers, which
    ``ptxas -v`` reports, are not counted)."""
    per_sm = min(MAX_BLOCKS_PER_SM, MAX_THREADS_PER_SM // max(threads, 1),
                 SMEM_PER_SM_BYTES // (smem_bytes + SMEM_RESERVED_PER_BLOCK))
    return {
        "smem_bytes_per_block": int(smem_bytes),
        "budget_bytes": int(budget),
        "threads_per_block": int(threads),
        "blocks_per_sm": int(per_sm),
        "fits": bool(smem_bytes <= budget),
    }


# ---------------------------------------------------- threshold model ---
def _modeled_spmm_time(feat: MatrixFeatures, threshold: int, *, n: int,
                       bk: int, hw: HardwareModel) -> float:
    """Roofline time of the hybrid split at ``threshold`` — same formulas
    as :func:`repro_torch.core.threshold.model_spmm_time` but priced
    directly off the vector histogram (no plan construction per
    candidate)."""
    vec_ge = feat.vectors_at_least(threshold)
    nblk = int(np.ceil(vec_ge / bk).sum())
    tc_nnz = feat.nnz_at_least(threshold)
    vpu_nnz = feat.nnz - tc_nnz
    flops_mxu = 2.0 * nblk * WINDOW * bk * n
    bytes_mxu = 4.0 * nblk * bk * n + 4.0 * nblk * WINDOW * bk
    t_mxu = max(flops_mxu / (hw.mxu_tflops * 1e12),
                bytes_mxu / (hw.hbm_gbps * 1e9))
    flops_vpu = 2.0 * vpu_nnz * n
    bytes_vpu = 4.0 * vpu_nnz * n
    t_vpu = max(flops_vpu / (hw.vpu_tflops * 1e12),
                bytes_vpu / (hw.hbm_gbps * 1e9))
    return max(t_mxu, t_vpu) + 1e-12


def sddmm_window_split(feat: MatrixFeatures, threshold: int, bk: int
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-window SDDMM Tensor Core / CUDA-core split approximation.

    SDDMM distributes at 8×bk-block granularity (densest-first packing):
    approximate each window's candidate blocks by packing its vectors
    densest-first and keeping blocks with ≥ ``threshold`` mean nnz on
    the Tensor Cores. Returns ``(tc_mask, nblk_w, nnz_w)`` per window.
    """
    hist = feat.win_vec_hist
    counts = np.arange(WINDOW + 1)
    nvec_w = hist.sum(axis=1)
    nnz_w = (hist * counts[None, :]).sum(axis=1)
    nblk_w = np.ceil(nvec_w / bk)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean_blk_nnz = np.where(nblk_w > 0, nnz_w / np.maximum(nblk_w, 1), 0)
    return mean_blk_nnz >= threshold, nblk_w, nnz_w


def _modeled_sddmm_time(feat: MatrixFeatures, threshold: int, *, kf: int,
                        bk: int, hw: HardwareModel) -> float:
    """Roofline time of the SDDMM block split at ``threshold`` nnz/block
    (see :func:`sddmm_window_split` for the split approximation)."""
    tc_mask, nblk_w, nnz_w = sddmm_window_split(feat, threshold, bk)
    nblk = int(nblk_w[tc_mask].sum())
    tc_nnz = int(nnz_w[tc_mask].sum())
    vpu_nnz = feat.nnz - tc_nnz
    flops_mxu = 2.0 * nblk * WINDOW * bk * kf
    bytes_mxu = 4.0 * nblk * (WINDOW + bk) * kf
    t_mxu = max(flops_mxu / (hw.mxu_tflops * 1e12),
                bytes_mxu / (hw.hbm_gbps * 1e9))
    flops_vpu = 2.0 * vpu_nnz * kf
    bytes_vpu = 8.0 * vpu_nnz * kf
    t_vpu = max(flops_vpu / (hw.vpu_tflops * 1e12),
                bytes_vpu / (hw.hbm_gbps * 1e9))
    return max(t_mxu, t_vpu) + 1e-12


# ------------------------------------------------------------ tuners ---
_TS_SEG_CANDIDATES = (1, 2, 4, 8, 16, 32)
_SPT_CANDIDATES = (1, 2, 4, 8)   # CUDA-core tiles per segment (cs / ts_tile)
# Grid-step overhead in units of one block/tile of work. Each segment
# pays a fixed scheduling cost on top of its payload; the cost of a cap
# is ``nseg·(overhead + cap)`` — padded work plus per-segment overhead —
# so heavy owners merge (a window of ~8 real blocks becomes one segment)
# while 1-unit owners keep cap 1 and never pad. (The reference measured
# about one block/tile of work per step on its substrate; the port keeps
# the value so both packages pick the same caps.)
_SEG_STEP_OVERHEAD = 1


def _pick_seg_ts(feat: MatrixFeatures, threshold: int | None,
                 bk: int) -> int:
    """§4.3 Ts cap from the blocks/window histogram: minimize the modeled
    Tensor Core sweep cost ``nseg · (overhead + ts)``. A wide cap
    amortizes per-segment overhead across decomposed (power-law)
    windows; a narrow one avoids padding 1-block windows up to the cap."""
    vec_ge = feat.vectors_at_least(threshold or 1) \
        if feat.win_vec_hist.size else np.zeros(0, np.int64)
    blocks_w = -(-vec_ge // bk)
    blocks_w = blocks_w[blocks_w > 0]
    if blocks_w.size == 0:
        return BalanceParams().ts
    best, best_cost = _TS_SEG_CANDIDATES[0], None
    for ts in _TS_SEG_CANDIDATES:
        nseg = int(np.ceil(blocks_w / ts).sum())
        cost = nseg * (_SEG_STEP_OVERHEAD + ts)
        if best_cost is None or cost < best_cost:
            best, best_cost = ts, cost
    return best


def _pick_seg_cs(feat: MatrixFeatures, ts_tile: int) -> int:
    """§4.3 Cs cap (whole CUDA-core tiles per row-segment) from the
    nnz/row histogram — residual rows are never longer than their source
    rows, so the row histogram upper-bounds tiles per row."""
    rows = feat.row_hist[feat.row_hist > 0] if feat.row_hist.size \
        else np.zeros(0, np.int64)
    if rows.size == 0:
        return BalanceParams().cs
    tiles_r = np.ceil(rows / max(ts_tile, 1))
    best, best_cost = _SPT_CANDIDATES[0], None
    for spt in _SPT_CANDIDATES:
        nseg = int(np.ceil(tiles_r / spt).sum())
        cost = nseg * (_SEG_STEP_OVERHEAD + spt)
        if best_cost is None or cost < best_cost:
            best, best_cost = spt, cost
    return best * ts_tile


def _pick_ts_tile(feat: MatrixFeatures) -> int:
    """Residual-tile width from the nnz/row histogram: rows shorter than
    the tile waste padded slots, so size the tile to the p95 row length
    (residual rows are never longer than their source row)."""
    if not feat.row_hist.size:
        return 32
    p95 = float(np.percentile(feat.row_hist, 95))
    return 8 if p95 <= 8 else 16 if p95 <= 16 else 32


def _narrow_caps(fits, seg_ts: int, seg_cs: int,
                 ts_tile: int) -> tuple[int, int]:
    """Narrow the §4.3 caps while the footprint is over budget, as the
    reference does. No port kernel's staging grows with ts or cs (K1
    stages fixed 32-vector chunks of a segment, K2 walks a row's prefix
    in device memory), so this only narrows when a kernel's fixed
    staging alone is over the budget, and the caller then warns."""
    while not fits() and seg_ts > 1:
        seg_ts //= 2
    while not fits() and seg_cs > ts_tile:
        seg_cs //= 2
    return seg_ts, seg_cs


def model_tune_spmm(a: SparseCSR, *, n: int = 128,
                    bk: int | None = None, ts_tile: int | None = None,
                    mode: str = "hybrid",
                    threshold: int | None = None,
                    hw: HardwareModel = HardwareModel(),
                    budget: int = SMEM_BUDGET_BYTES,
                    feat: MatrixFeatures | None = None) -> TuneConfig:
    """Emit a full SpMM :class:`TuneConfig` from matrix features.

    Explicit ``threshold`` (or a forcing ``mode``) is respected — the
    model then only sizes the segment caps and tile width. Explicit
    ``bk``/``ts_tile`` are likewise kept (and priced), so the emitted
    config always describes the plan that will actually be built. Warns
    (RuntimeWarning) when K1's block is over the shared-memory budget.
    """
    from repro_torch.core import preprocess as P

    _sp = get_tracer().span("tune.model", op="spmm", m=a.m, k=a.k,
                            nnz=a.nnz).open()
    bk = P.DEFAULT_BK_SPMM if bk is None else bk
    feat = feat or matrix_features(a)
    ts_tile = _pick_ts_tile(feat) if ts_tile is None else ts_tile

    if threshold is None and mode == "hybrid":
        cand = range(1, WINDOW + 2)
        times = {t: _modeled_spmm_time(feat, t, n=n, bk=bk, hw=hw)
                 for t in cand}
        threshold = min(times, key=lambda t: (times[t], t))

    # §4.3 segment caps from the blocks/window and nnz/row histograms.
    seg_ts = _pick_seg_ts(feat, threshold, bk)
    seg_cs = _pick_seg_cs(feat, ts_tile)

    fp = spmm_footprint(n, a.k)
    occ = occupancy_report(fp["smem_bytes"], fp["threads"], budget)
    seg_ts, seg_cs = _narrow_caps(lambda: occ["fits"], seg_ts, seg_cs,
                                  ts_tile)
    if not occ["fits"]:
        warnings.warn(
            f"model_tune_spmm: K1 needs {fp['smem_bytes']} B of shared "
            f"memory per block at n={n}, over the {budget} B budget",
            RuntimeWarning, stacklevel=2)

    cfg = TuneConfig(threshold=threshold, bk=bk, ts_tile=ts_tile,
                     ts=seg_ts, cs=seg_cs, source="model")
    _sp.set(threshold=threshold, smem_block_bytes=fp["smem_bytes"],
            blocks_per_sm=occ["blocks_per_sm"],
            l2_slice_cols=fp["l2_slice_cols"]).close()
    return cfg


def model_tune_sddmm(a: SparseCSR, *, kf: int = 128,
                     bk: int | None = None, ts_tile: int | None = None,
                     mode: str = "hybrid",
                     threshold: int | None = None,
                     hw: HardwareModel = HardwareModel(),
                     budget: int = SMEM_BUDGET_BYTES,
                     feat: MatrixFeatures | None = None) -> TuneConfig:
    """Emit a full SDDMM :class:`TuneConfig` from matrix features.

    Warns (RuntimeWarning) when K3's block at its feature slice is over
    the shared-memory budget.
    """
    from repro_torch.core import preprocess as P

    _sp = get_tracer().span("tune.model", op="sddmm", m=a.m, k=a.k,
                            nnz=a.nnz).open()
    bk = P.DEFAULT_BK_SDDMM if bk is None else bk
    feat = feat or matrix_features(a)
    ts_tile = 32 if ts_tile is None else ts_tile

    if threshold is None and mode == "hybrid":
        cand = (1, 8, 16, 24, 32, 48, 64, WINDOW * bk + 1)
        times = {t: _modeled_sddmm_time(feat, t, kf=kf, bk=bk, hw=hw)
                 for t in cand}
        threshold = min(times, key=lambda t: (times[t], t))

    # §4.3 segment caps (same histograms as SpMM; SDDMM CUDA-core tiles
    # are flat element lists, so cs only batches tiles per segment there).
    seg_ts = _pick_seg_ts(feat, 1, bk)
    seg_cs = _pick_seg_cs(feat, ts_tile)

    fp = sddmm_footprint(kf, a.k)
    occ = occupancy_report(fp["smem_bytes"], fp["threads"], budget)
    seg_ts, seg_cs = _narrow_caps(lambda: occ["fits"], seg_ts, seg_cs,
                                  ts_tile)
    if not occ["fits"]:
        warnings.warn(
            f"model_tune_sddmm: K3 needs {fp['smem_bytes']} B of shared "
            f"memory per block at a {fp['k3_slice_feats']}-feature slice, "
            f"over the {budget} B budget", RuntimeWarning, stacklevel=2)

    cfg = TuneConfig(threshold=threshold, bk=bk, ts_tile=ts_tile,
                     ts=seg_ts, cs=seg_cs, source="model")
    _sp.set(threshold=threshold, smem_block_bytes=fp["smem_bytes"],
            blocks_per_sm=occ["blocks_per_sm"],
            k3_slice_feats=fp["k3_slice_feats"],
            l2_slice_cols=fp["l2_slice_cols"]).close()
    return cfg
