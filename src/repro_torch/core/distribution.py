"""2D-aware workload distribution (paper §4.2).

Dimension 1 — *data reusability* fixes the distribution granularity:
  SpMM:  R_spmm  = NNZ / k = m·ρ        ⇒ per 8×1 column vector
  SDDMM: R_sddmm = 2·NNZ / (m + n)      ⇒ per 8×BK TC block

Dimension 2 — *practical performance*: a threshold on NNZ decides which
unit gets each vector/block. The threshold is hardware-dependent, not
matrix-dependent (paper §5.4.1 finds a single value per architecture).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.formats import WINDOW
from repro_torch.core.windows import WindowVectors


def r_spmm(nnz: int | np.ndarray, k: int):
    """Data-access-cost ratio CUDA/TCU for SpMM (Eq. 2): NNZ / k."""
    return np.asarray(nnz, dtype=np.float64) / float(k)


def r_sddmm(nnz: int | np.ndarray, m: int, n: int):
    """Data-access-cost ratio CUDA/TCU for SDDMM (Eq. 3): 2·NNZ / (m+n)."""
    return 2.0 * np.asarray(nnz, dtype=np.float64) / float(m + n)


@dataclasses.dataclass(frozen=True)
class SpMMSplit:
    """Per-window split decision for SpMM (vector granularity)."""

    tc_idx: np.ndarray   # indices into WindowVectors arrays → Tensor Cores
    vpu_idx: np.ndarray  # indices → CUDA cores


def split_spmm_window(wv: WindowVectors, threshold: int) -> SpMMSplit:
    """Vectors with NNZ ≥ threshold go to the Tensor Cores; the rest to
    the CUDA cores.

    threshold=1 ⇒ Tensor Core only; threshold=WINDOW+1 ⇒ CUDA cores only
    (the single-resource ablations).
    """
    dense = wv.counts >= threshold
    return SpMMSplit(np.nonzero(dense)[0], np.nonzero(~dense)[0])


@dataclasses.dataclass(frozen=True)
class SDDMMSplit:
    """Per-window split for SDDMM (block granularity).

    blocks: list of arrays of vector indices — each array is one candidate
    TC block (≤ bk vectors, densest-first packing per paper Fig. 5);
    to_tc[i] says whether blocks[i] runs on the MXU.
    """

    blocks: list[np.ndarray]
    to_tc: np.ndarray
    vpu_vec_idx: np.ndarray  # vector indices handled element-wise on the VPU


def split_sddmm_window(wv: WindowVectors, threshold: int, bk: int) -> SDDMMSplit:
    """Sort vectors by NNZ descending, pack bk-wide blocks, threshold on
    block NNZ (paper: "condense the densest vectors into TC blocks")."""
    nvec = wv.counts.size
    if nvec == 0:
        return SDDMMSplit([], np.zeros(0, bool), np.zeros(0, np.int64))
    order = np.argsort(-wv.counts, kind="stable")
    blocks, flags, vpu = [], [], []
    for s in range(0, nvec, bk):
        blk = order[s : s + bk]
        blk_nnz = int(wv.counts[blk].sum())
        if blk_nnz >= threshold:
            blocks.append(np.sort(blk))
            flags.append(True)
        else:
            vpu.append(blk)
    vpu_idx = np.sort(np.concatenate(vpu)) if vpu else np.zeros(0, np.int64)
    return SDDMMSplit(blocks, np.asarray(flags, bool), vpu_idx)


def distribution_stats(counts_per_vec: np.ndarray, threshold: int) -> dict:
    """Summary used by the threshold tuner and the Fig.-1 benchmark."""
    tc = counts_per_vec >= threshold
    tc_nnz = int(counts_per_vec[tc].sum())
    total = int(counts_per_vec.sum())
    return {
        "vectors": int(counts_per_vec.size),
        "tc_vectors": int(tc.sum()),
        "tc_nnz": tc_nnz,
        "vpu_nnz": total - tc_nnz,
        "tc_ratio": tc_nnz / max(total, 1),
        "tc_redundancy": float(
            (tc.sum() * WINDOW - tc_nnz) / max(tc.sum() * WINDOW, 1)
        ),
    }
