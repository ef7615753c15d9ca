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

from repro_torch.core.windows import WindowVectors


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
