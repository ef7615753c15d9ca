"""Hybrid load balancing (paper §4.3, Fig. 6).

The paper decomposes windows whose TCU/CUDA workloads exceed ``Ts`` TC
blocks / ``Cs`` tile elements, marking decomposed segments with an
``Atomic`` flag so partial results are atomically accumulated.

The decomposition serves two purposes:

1. **Bounded segments** — every segment is a fixed-size unit of work
   (one thread block or warp), so the launch is balanced regardless of
   the row-length distribution (the paper's power-law case).
2. **Combine** — the ``atomic`` flag marks segments whose output
   row/window is written by >1 producer (another segment or the other
   compute path). In this package both streams' partials still combine
   in one ``index_add_`` outside the kernels; the flag is kept so a
   later kernel can store for owned rows and atomically add only where
   necessary.

Auxiliary arrays map 1:1 to the paper's: ``window_offset``/``row_offset``
(work per segment), ``cur_window``/``cur_row`` (original indices), and
``atomic``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BalanceParams:
    ts: int = 8           # max TC blocks per segment (paper Ts)
    cs: int = 128         # max VPU elements per row-segment (paper Cs)
    short_len: int = 3    # rows with ≤ short_len residual nnz are "short tiles"


@dataclasses.dataclass(frozen=True)
class Segments:
    """Decomposition result for one kind of workload.

    sizes:   (nseg,) work units per segment
    cur:     (nseg,) original window (TC) or row (VPU) index
    atomic:  (nseg,) bool — output shared with another producer
    start:   (nseg,) offset of the segment's first work unit in the
             owner-sorted unit array (TC blocks are window-sorted, VPU
             tiles row-sorted, so a segment is a contiguous unit slice)
    limit:   the Ts/Cs cap the decomposition was built with
    """

    sizes: np.ndarray
    cur: np.ndarray
    atomic: np.ndarray
    start: np.ndarray = None
    limit: int = 0

    @property
    def nseg(self) -> int:
        return int(self.sizes.shape[0])


def decompose_counts(counts: np.ndarray, limit: int,
                     shared_output: np.ndarray) -> Segments:
    """Split per-owner work counts into segments of ≤ limit units.

    ``shared_output[i]`` is True when owner ``i``'s output is also produced
    elsewhere (e.g. the window has both TC and VPU work) — its segments are
    atomic even without decomposition (paper Fig. 6, window 1 rule).

    Fully vectorized (``repeat``/``cumsum`` splits — this sits on the
    preprocessing hot path now that segments drive kernel launch): owner
    ``i`` with ``c`` units yields ``ceil(c/limit)`` segments, all of size
    ``limit`` except a ragged last one.
    """
    counts = np.asarray(counts, np.int64)
    shared_output = np.asarray(shared_output, bool)
    nseg_per = -(-counts // limit)              # ceil; 0 stays 0
    total = int(nseg_per.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return Segments(z, z.copy(), np.zeros(0, bool), z.copy(), limit)
    cur = np.repeat(np.arange(counts.size, dtype=np.int64), nseg_per)
    seg_off = np.cumsum(nseg_per) - nseg_per    # first segment id per owner
    within = np.arange(total, dtype=np.int64) - seg_off[cur]
    sizes = np.minimum(limit, counts[cur] - within * limit)
    unit_off = np.cumsum(counts) - counts       # first unit per owner
    start = unit_off[cur] + within * limit
    atomic = shared_output[cur] | (nseg_per[cur] > 1)
    return Segments(sizes, cur, atomic, start, limit)


def segment_take(seg: Segments) -> np.ndarray:
    """Segment-granular launch table: ``(nseg, limit)`` indices into the
    owner-sorted unit array (TC blocks / VPU tiles), ``-1`` beyond each
    segment's ragged end. This is the Ts/Cs-padded work slice the kernels
    iterate the grid over: ``take[s, j]`` is unit ``j`` of segment ``s``.
    """
    lanes = np.arange(seg.limit, dtype=np.int64)[None, :]
    take = seg.start[:, None] + lanes
    return np.where(lanes < seg.sizes[:, None], take, -1).astype(np.int64)


def propagate_atomicity(tc_windows: np.ndarray, tc_atomic: np.ndarray,
                        vpu_windows: np.ndarray, vpu_atomic: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Paper Fig. 6 window-1 rule: once either path in a window is
    decomposed, the other path's segments in that window become atomic too."""
    hot = set(np.asarray(tc_windows)[np.asarray(tc_atomic)].tolist())
    hot |= set(np.asarray(vpu_windows)[np.asarray(vpu_atomic)].tolist())
    tc_atomic = np.asarray(
        [a or (w in hot) for w, a in zip(tc_windows, tc_atomic)], dtype=bool)
    vpu_atomic = np.asarray(
        [a or (w in hot) for w, a in zip(vpu_windows, vpu_atomic)], dtype=bool)
    return tc_atomic, vpu_atomic


def balance_report(seg_sizes: np.ndarray, n_shards: int) -> dict:
    """Imbalance metric: max/mean work per shard under round-robin segment
    assignment — what the dry-run sharding uses to validate balance."""
    if seg_sizes.size == 0:
        return {"max_over_mean": 1.0, "shards": n_shards}
    per = np.zeros(n_shards, np.int64)
    order = np.argsort(-seg_sizes)  # LPT-ish greedy
    for s in seg_sizes[order]:
        per[np.argmin(per)] += int(s)
    return {
        "max_over_mean": float(per.max() / max(per.mean(), 1e-9)),
        "shards": n_shards,
    }
