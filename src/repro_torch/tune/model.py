"""The plan-selection record every layer is parameterized through, and
the matrix feature pass.

The record and :func:`matrix_features` (the one vectorized pattern pass
that prices Tensor Core eligibility; row reordering reports its gain
with it) are ported. The analytical tuner that fills the record from
those features (``tune="model"``) and the empirical search
(``tune="search"``) wait for a Hopper cost model (ROADMAP queue 1
item 9); until then callers pass ``tune="off"`` or a literal
:class:`TuneConfig`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.formats import WINDOW
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
    gather rows straight from device memory and choose their own tiles.
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
    source: str = "default"

    def replace(self, **kw) -> "TuneConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_TUNE = TuneConfig()


@dataclasses.dataclass(frozen=True)
class MatrixFeatures:
    """Cheap pattern statistics: the row-reordering report reads them
    today, the analytical tuner (ROADMAP queue 1 item 9) will."""

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
