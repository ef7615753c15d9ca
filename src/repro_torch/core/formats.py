"""Device-side formats produced by Libra preprocessing.

Two storage families, mirroring the paper's bitmap (TC-block) + CSR split:

* :class:`TCBlocks` — the Tensor Core portion. Non-zero 8×1 column
  vectors whose NNZ passed the threshold, condensed into ``8 × BK``
  blocks. Each condensed column keeps its source column index and an
  8-bit occupancy bitmap (the paper's Bit-Decoding format).

* :class:`VPUTiles` — the CUDA-core portion (the reference package's
  "VPU" stream; the key names are kept so plans compare key for key).
  The residual non-zeros are packed into fixed-width tiles of ``TS``
  elements, each tile owned by a single output row (SpMM) or a flat
  element list (SDDMM). Zero padding in a tile multiplies row 0 of B
  by 0.0.

Both carry segment/accumulation metadata from the hybrid load balancer
(paper §4.3): ``segment_id`` plays the role of the ``CurWindow/CurRow``
arrays and ``atomic`` marks partials that must be reduced.

Host arrays stay NumPy in the reference's dtypes, so
:func:`_host_arrays` equals the reference's key for key.
:class:`PlanArrays` uploads them lazily as ``torch`` tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.balance import segment_take

WINDOW = 8  # paper: 8×1 non-zero column vectors (swap-and-transpose granularity)

#: The three device views a plan's arrays fall into (see
#: :func:`view_of_key` / :class:`PlanArrays`): the compact
#: per-block/per-tile tensors, the §4.3 segment launch tables, and the
#: revaluation position maps.
PLAN_VIEWS = ("compact", "segment", "revalue")

# SpMM revaluation maps: canonical-nnz position tensors read only by
# ref.revalue_spmm_arrays. (SDDMM's *_out_pos keys are structural
# scatter maps every apply needs — they stay in compact/segment.)
_REVALUE_KEYS = frozenset(
    {"tc_pos", "vpu_pos", "tc_seg_pos", "vpu_seg_pos"})


def view_of_key(key: str) -> str:
    """Classify one device-array key into a :data:`PLAN_VIEWS` view."""
    if key in _REVALUE_KEYS:
        return "revalue"
    if "_seg_" in key:
        return "segment"
    return "compact"


@dataclasses.dataclass(frozen=True)
class TCBlocks:
    """Condensed Tensor Core blocks for one sparse matrix.

    vals:    (nblk, WINDOW, bk) f32 — condensed dense tiles (zero padded)
    cols:    (nblk, bk) i32 — source column index per condensed vector
    bitmap:  (nblk, bk) u32 — 8-bit occupancy of each 8×1 vector
    window:  (nblk,) i32 — output window (row-block) id of each block
    atomic:  (nblk,) bool — True if this window's output is also written by
             another path/segment and must go through the combine reduction
    nnz:     int — non-zeros covered by this portion

    Two fields are *derived* from ``window`` (the TC-window compaction map):

    rank:       (nblk,) i32 — dense rank of each block's window among the
                windows that have TC work; the kernel writes its output at
                ``rank``, so the TC partial buffer is ``(n_active, 8, n)``.
    active_win: (n_active,) i32 — rank → window id.
    """

    vals: np.ndarray
    cols: np.ndarray
    bitmap: np.ndarray
    window: np.ndarray
    atomic: np.ndarray
    nnz: int
    bk: int
    pos: np.ndarray | None = None  # (nblk, WINDOW, bk) canonical nnz idx, −1 pad
    rank: np.ndarray = dataclasses.field(init=False)
    active_win: np.ndarray = dataclasses.field(init=False)

    def __post_init__(self):
        win = np.asarray(self.window, np.int32)
        active = np.unique(win)
        object.__setattr__(self, "active_win", active.astype(np.int32))
        object.__setattr__(
            self, "rank", np.searchsorted(active, win).astype(np.int32))

    @property
    def nblk(self) -> int:
        return int(self.vals.shape[0])

    @property
    def n_active(self) -> int:
        return int(self.active_win.shape[0])

    @property
    def padded_zeros(self) -> int:
        return int(self.vals.size - self.nnz)


@dataclasses.dataclass(frozen=True)
class VPUTiles:
    """Residual-nonzero tiles for the CUDA-core path (SpMM flavour).

    vals: (nt, ts) f32, cols: (nt, ts) i32, row: (nt,) i32 output row.
    long_tile: (nt,) bool — True for tiles from decomposed long rows.
    """

    vals: np.ndarray
    cols: np.ndarray
    row: np.ndarray
    long_tile: np.ndarray
    atomic: np.ndarray
    nnz: int
    ts: int
    pos: np.ndarray | None = None  # (nt, ts) canonical nnz idx, −1 pad

    @property
    def ntiles(self) -> int:
        return int(self.vals.shape[0])


@dataclasses.dataclass(frozen=True)
class COOTiles:
    """Element tiles for the SDDMM CUDA-core path: flat (row, col) lists."""

    rows: np.ndarray  # (nt, ts) i32
    cols: np.ndarray  # (nt, ts) i32
    out_pos: np.ndarray  # (nt, ts) i32 — position in the canonical nnz array
    mask: np.ndarray  # (nt, ts) bool
    nnz: int
    ts: int

    @property
    def ntiles(self) -> int:
        return int(self.rows.shape[0])


@dataclasses.dataclass(frozen=True)
class SpMMPlan:
    """Full Libra plan for SpMM on one sparse matrix."""

    m: int
    k: int
    nnz: int
    threshold: int
    tc: TCBlocks
    vpu: VPUTiles
    meta: dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SDDMMPlan:
    """Full Libra plan for SDDMM on one sparse mask."""

    m: int
    k: int  # number of columns of the sparse mask (= rows of B)
    nnz: int
    threshold: int
    tc: TCBlocks  # vals unused (mask only); bitmap/cols/window are the block defs
    tc_out_pos: np.ndarray  # (nblk, WINDOW, bk) i32 → canonical nnz positions (-1 pad)
    vpu: COOTiles
    meta: dict[str, Any]


def _seg_take_map(seg, n_units: int) -> tuple[np.ndarray, np.ndarray]:
    """(take, mask) for one §4.3 segment table: ``take`` is ``(nseg,
    limit)`` indices into the owner-sorted unit array (clamped to valid
    units) and ``mask`` marks real units. Plans whose path is empty get
    one dummy all-padding segment so kernel shapes stay static."""
    if seg.nseg == 0:
        take = np.full((1, max(seg.limit, 1)), -1, np.int64)
    else:
        take = segment_take(seg)
    mask = take >= 0
    return np.minimum(np.maximum(take, 0), max(n_units - 1, 0)), mask


def _spmm_segment_arrays(plan: "SpMMPlan") -> dict[str, np.ndarray]:
    """Segment-granular launch tables for the SpMM kernels (§4.3).

    Tensor Core: segment ``s`` owns ≤ ``ts`` condensed blocks of one
    window, flattened to an ``(8, ts·bk)`` operand (the sum of per-block
    ``8×bk @ bk×n`` products equals one ``8×(ts·bk) @ (ts·bk)×n``
    product). Every segment has its own output slot (``rank = arange``).
    CUDA cores: segment ``s`` owns ≤ ``cs`` residual elements (whole
    tiles) of one row. Padding is inert: zero values multiply B row 0;
    ``pos`` stays −1 so revaluation skips it.
    """
    out: dict[str, np.ndarray] = {}
    tc_seg = plan.meta.get("tc_segments")
    if tc_seg is not None:
        tc = plan.tc
        take, mask = _seg_take_map(tc_seg, tc.nblk)
        nseg, w = take.shape
        win = (tc_seg.cur if tc_seg.nseg else np.zeros(1, np.int64))
        vals = tc.vals[take] * mask[:, :, None, None]       # (nseg,w,8,bk)
        cols = np.where(mask[:, :, None], tc.cols[take], 0)
        pos = (np.where(mask[:, :, None, None], tc.pos[take], -1)
               if tc.pos is not None else None)
        bk = tc.vals.shape[-1]
        out["tc_seg_vals"] = vals.transpose(0, 2, 1, 3).reshape(
            nseg, WINDOW, w * bk).astype(np.float32)
        out["tc_seg_cols"] = cols.reshape(nseg, w * bk).astype(np.int32)
        if pos is not None:
            out["tc_seg_pos"] = pos.transpose(0, 2, 1, 3).reshape(
                nseg, WINDOW, w * bk).astype(np.int32)
        out["tc_seg_rank"] = np.arange(nseg, dtype=np.int32)
        out["tc_seg_row"] = (
            win[:, None].astype(np.int64) * WINDOW
            + np.arange(WINDOW, dtype=np.int64)[None, :]
        ).reshape(-1).astype(np.int32)
    vpu_seg = plan.meta.get("vpu_segments")
    if vpu_seg is not None:
        vpu = plan.vpu
        take, mask = _seg_take_map(vpu_seg, vpu.ntiles)
        nseg, spt = take.shape
        row = (vpu_seg.cur if vpu_seg.nseg else np.zeros(1, np.int64))
        ts = vpu.vals.shape[-1]
        out["vpu_seg_vals"] = (vpu.vals[take] * mask[:, :, None]).reshape(
            nseg, spt * ts).astype(np.float32)
        out["vpu_seg_cols"] = np.where(
            mask[:, :, None], vpu.cols[take], 0
        ).reshape(nseg, spt * ts).astype(np.int32)
        if vpu.pos is not None:
            out["vpu_seg_pos"] = np.where(
                mask[:, :, None], vpu.pos[take], -1
            ).reshape(nseg, spt * ts).astype(np.int32)
        out["vpu_seg_row"] = row.astype(np.int32)
    return out


def _sddmm_segment_arrays(plan: "SDDMMPlan") -> dict[str, np.ndarray]:
    """Segment-granular launch tables for the SDDMM kernels (§4.3).

    Tensor Core: a segment's ≤ ``ts`` blocks share one window, so one
    thread block scores an ``8×kf @ kf×(ts·bk)`` product sampled by the
    concatenated bitmaps (zero bitmap padding, ``out_pos`` −1, stores
    nothing; the plain path's combine adds it into a swallow slot). CUDA
    cores:
    element tiles are flat, so the Cs cap just batches ``seg_spt`` tiles
    per segment (mask-False padding).
    """
    out: dict[str, np.ndarray] = {}
    tc_seg = plan.meta.get("tc_segments")
    if tc_seg is not None:
        tc = plan.tc
        take, mask = _seg_take_map(tc_seg, tc.nblk)
        nseg, w = take.shape
        win = (tc_seg.cur if tc_seg.nseg else np.zeros(1, np.int64))
        bk = tc.cols.shape[-1]
        out["tc_seg_cols"] = np.where(
            mask[:, :, None], tc.cols[take], 0
        ).reshape(nseg, w * bk).astype(np.int32)
        out["tc_seg_bitmap"] = np.where(
            mask[:, :, None], tc.bitmap[take], 0
        ).reshape(nseg, w * bk).astype(np.uint32)
        out["tc_seg_window"] = win.astype(np.int32)
        out["tc_seg_out_pos"] = np.where(
            mask[:, :, None, None], plan.tc_out_pos[take], -1
        ).transpose(0, 2, 1, 3).reshape(nseg, WINDOW, w * bk).astype(np.int32)
    spt = int(plan.meta.get("seg_spt", 1))
    if spt > 1:
        vpu = plan.vpu
        nt, ts = vpu.rows.shape
        nsegE = -(-nt // spt)
        pad = nsegE * spt - nt

        def _grp(x, fill):
            x = np.concatenate(
                [x, np.full((pad, ts), fill, x.dtype)]) if pad else x
            return x.reshape(nsegE, spt * ts)

        out["vpu_seg_rows"] = _grp(vpu.rows, 0).astype(np.int32)
        out["vpu_seg_cols"] = _grp(vpu.cols, 0).astype(np.int32)
        out["vpu_seg_out_pos"] = _grp(vpu.out_pos, 0).astype(np.int32)
        out["vpu_seg_mask"] = _grp(vpu.mask, False)
    return out


def _host_arrays(plan) -> dict[str, np.ndarray]:
    """Every device-uploadable array of one plan, host-side, in the
    reference package's dtypes."""
    out: dict[str, np.ndarray] = {}
    if isinstance(plan, SpMMPlan):
        # tc_active_row: flat output-row index of every compacted TC row
        # (rank r owns rows active_win[r]*8 .. active_win[r]*8+7 of C).
        active_rows = (
            plan.tc.active_win[:, None].astype(np.int64) * WINDOW
            + np.arange(WINDOW, dtype=np.int64)[None, :]
        ).reshape(-1)
        out.update(
            tc_vals=np.asarray(plan.tc.vals, np.float32),
            tc_cols=np.asarray(plan.tc.cols, np.int32),
            tc_bitmap=np.asarray(plan.tc.bitmap, np.uint32),
            tc_rank=np.asarray(plan.tc.rank, np.int32),
            tc_active_row=np.asarray(active_rows, np.int32),
            vpu_vals=np.asarray(plan.vpu.vals, np.float32),
            vpu_cols=np.asarray(plan.vpu.cols, np.int32),
            vpu_row=np.asarray(plan.vpu.row, np.int32),
        )
        if plan.tc.pos is not None:
            out["tc_pos"] = np.asarray(plan.tc.pos, np.int32)
        if plan.vpu.pos is not None:
            out["vpu_pos"] = np.asarray(plan.vpu.pos, np.int32)
        for k, v in _spmm_segment_arrays(plan).items():
            out[k] = np.asarray(v)
    elif isinstance(plan, SDDMMPlan):
        out.update(
            tc_cols=np.asarray(plan.tc.cols, np.int32),
            tc_bitmap=np.asarray(plan.tc.bitmap, np.uint32),
            tc_window=np.asarray(plan.tc.window, np.int32),
            tc_out_pos=np.asarray(plan.tc_out_pos, np.int32),
            vpu_rows=np.asarray(plan.vpu.rows, np.int32),
            vpu_cols=np.asarray(plan.vpu.cols, np.int32),
            vpu_out_pos=np.asarray(plan.vpu.out_pos, np.int32),
            vpu_mask=np.asarray(plan.vpu.mask, np.bool_),
        )
        for k, v in _sddmm_segment_arrays(plan).items():
            out[k] = np.asarray(v)
    else:
        raise TypeError(type(plan))
    return out


# Compact key sets per stream (SpMM / SDDMM) and their §4.3 segment
# replacements — the ingredients of PlanArrays.backend_keys.
_SPMM_TC = ("tc_vals", "tc_cols", "tc_rank", "tc_active_row")
_SPMM_TC_SEG = ("tc_seg_vals", "tc_seg_cols", "tc_seg_rank", "tc_seg_row")
_SPMM_VPU = ("vpu_vals", "vpu_cols", "vpu_row")
_SPMM_VPU_SEG = ("vpu_seg_vals", "vpu_seg_cols", "vpu_seg_row")
_SDDMM_TC = ("tc_cols", "tc_bitmap", "tc_window", "tc_out_pos")
_SDDMM_TC_SEG = ("tc_seg_cols", "tc_seg_bitmap", "tc_seg_window",
                 "tc_seg_out_pos")
_SDDMM_VPU = ("vpu_rows", "vpu_cols", "vpu_out_pos", "vpu_mask")
_SDDMM_VPU_SEG = ("vpu_seg_rows", "vpu_seg_cols", "vpu_seg_out_pos",
                  "vpu_seg_mask")

# vals tensor → the pos map that rebuilds it (ref.revalue_spmm_arrays).
_REVALUE_OF = {"tc_vals": "tc_pos", "vpu_vals": "vpu_pos",
               "tc_seg_vals": "tc_seg_pos", "vpu_seg_vals": "vpu_seg_pos"}


def real_prefix_lengths(pos: np.ndarray) -> np.ndarray:
    """(rows,) i32: one past the last real slot (``pos >= 0``) of each row
    of a CUDA-core SpMM table (the last axis; a leading shard axis
    stays). Real slots form a prefix of every row (:func:`segment_take`
    puts a segment's real tiles first, and a tile fills its slots in
    order), so this is each row's real length."""
    slot = np.arange(1, pos.shape[-1] + 1, dtype=np.int32)
    return np.where(pos >= 0, slot, 0).max(axis=-1, initial=0).astype(
        np.int32)


def real_vector_lengths(pos: np.ndarray) -> np.ndarray:
    """(blocks,) i32: one past the last real condensed vector of each
    block or segment of a Tensor Core SpMM table (``pos`` is ``(nb, 8,
    bk)``, or ``(P, nb, 8, bk)`` stacked; a vector is real when any of
    its 8 rows is). Only a window's last block is partly filled, and
    :func:`segment_take` puts a segment's real blocks first, so real
    vectors form a prefix."""
    return real_prefix_lengths(pos.max(axis=-2, initial=-1))


def sddmm_slot_counts(host: dict[str, np.ndarray]) -> tuple[int, int]:
    """(slots, live) of an SDDMM plan's kernel-path tables (the segment
    tables where the plan has them, else the compact ones): every score
    slot K3 and K4 compute, and those that store a score (a Tensor Core
    slot whose position is not −1, a CUDA-core slot its mask keeps). The
    live slots own the ``nnz`` canonical positions once each, so
    ``slots - live`` is the padding the kernels compute and store
    nowhere."""
    tc = host["tc_seg_out_pos" if "tc_seg_out_pos" in host
               else "tc_out_pos"]
    mask = host["vpu_seg_mask" if "vpu_seg_mask" in host else "vpu_mask"]
    return (int(tc.size + mask.size),
            int(np.count_nonzero(tc >= 0) + np.count_nonzero(mask)))


def _to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    # 8-bit occupancy bitmaps travel as int32: torch's uint32 lacks shift
    # and bitwise ops on many builds, and the bits fit either way.
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class PlanArrays(Mapping):
    """Lazy, byte-accounted device views of one plan (paper §4.1 ③:
    upload once, reuse).

    The plan stays host-side; each array uploads to ``device`` on first
    use. :meth:`for_backend` returns the exact key set one backend's
    apply reads: ``"torch"`` → compact tables only, ``"cuda"`` → segment
    tables for segmented streams and compact tables otherwise
    (``segmented=False`` asks for the compact tables on the kernel path,
    the serving ladder's ``unsegmented`` rung); ``revalue=True`` swaps
    each value tensor for its position map, which
    :func:`repro_torch.kernels.ref.revalue_spmm_arrays` turns back into
    values from a runtime edge-value vector. An SpMM plan's ``"cuda"``
    dict also carries ``"tc_len"`` (:meth:`tc_len`) and ``"vpu_len"``
    (:meth:`vpu_len`) of the tables it holds, which are derived on the
    host and are no plan keys.

    An SDDMM plan's ``meta`` gains ``"sddmm_slots"`` and
    ``"sddmm_live"`` here (:func:`sddmm_slot_counts`, on the host).

    Every upload is recorded (key, view, ``nbytes``, dtype), the derived
    lengths too: under ``tc_seg_len``/``vpu_seg_len`` (view
    ``"segment"``) or ``tc_len``/``vpu_len`` (``"compact"``), the view
    of the table they describe. An *accountant* callback
    (:meth:`set_accountant`, usually a
    :class:`repro_torch.obs.memstat.MemLedger` binder) receives each
    record, with earlier uploads replayed on attach, so the ledger sums
    exactly the ``nbytes`` of the tensors on the device.
    """

    def __init__(self, plan, device: torch.device | str, *,
                 host: dict[str, np.ndarray] | None = None,
                 kind: str | None = None):
        self.plan = plan
        self.device = torch.device(device)
        if plan is not None:
            kind = "spmm" if isinstance(plan, SpMMPlan) else "sddmm"
            host = _host_arrays(plan)
            if kind == "sddmm":
                plan.meta["sddmm_slots"], plan.meta["sddmm_live"] = \
                    sddmm_slot_counts(host)
        self.kind = kind
        self._host = host
        self._views = {k: view_of_key(k) for k in self._host}
        self._dev: dict[str, torch.Tensor] = {}
        self._derived: dict[str, torch.Tensor] = {}
        self._uploads: dict[str, tuple[str, int, str]] = {}
        self._bcache: dict[tuple, dict] = {}
        self._accountant = None

    @classmethod
    def from_host(cls, host: dict[str, np.ndarray], kind: str,
                  device: torch.device | str) -> "PlanArrays":
        """Lazy views of host tables that no single plan owns (one shard's
        slice of a partition's stacked tables, keyed like a plan's)."""
        return cls(None, device, host=host, kind=kind)

    def _record(self, key: str, view: str, arr: torch.Tensor) -> None:
        rec = (view, arr.numel() * arr.element_size(), str(arr.dtype))
        self._uploads[key] = rec
        if self._accountant is not None:
            self._accountant(view, key, rec[1], rec[2])

    def __getitem__(self, key: str) -> torch.Tensor:
        arr = self._dev.get(key)
        if arr is None:
            arr = self._dev[key] = _to_tensor(self._host[key], self.device)
            self._record(key, self._views[key], arr)
        return arr

    def __iter__(self):
        return iter(self._host)

    def __len__(self) -> int:
        return len(self._host)

    def __contains__(self, key) -> bool:
        return key in self._host

    @property
    def host(self) -> dict[str, np.ndarray]:
        """The host-side NumPy arrays (reference dtypes)."""
        return self._host

    # ------------------------------------------------- backend views ---
    @property
    def segmented(self) -> bool:
        """True when the plan carries §4.3 segment launch tables."""
        return any(self._views[k] == "segment" for k in self._host)

    def backend_keys(self, backend: str, *, revalue: bool = False,
                     segmented: bool = True) -> tuple[str, ...]:
        """The exact key set ``backend``'s apply reads for this plan."""
        ks = self._host
        compact = backend == "torch" or not segmented
        if self.kind == "spmm":
            if compact:
                keys = list(_SPMM_TC + _SPMM_VPU)
            else:
                keys = list(_SPMM_TC_SEG if "tc_seg_vals" in ks
                            else _SPMM_TC)
                keys += list(_SPMM_VPU_SEG if "vpu_seg_vals" in ks
                             else _SPMM_VPU)
            if revalue:
                keys = [_REVALUE_OF[k] if _REVALUE_OF.get(k) in ks else k
                        for k in keys]
            return tuple(keys)
        if compact:
            return _SDDMM_TC + _SDDMM_VPU
        keys = list(_SDDMM_TC_SEG if "tc_seg_cols" in ks else _SDDMM_TC)
        keys += list(_SDDMM_VPU_SEG if "vpu_seg_rows" in ks
                     else _SDDMM_VPU)
        return tuple(keys)

    def _carries_lengths(self, backend: str) -> bool:
        """True when ``backend``'s dict carries derived lengths (SpMM on
        the kernel path)."""
        return self.kind == "spmm" and backend == "cuda"

    def _length_source(self, stream: str, segmented: bool) -> tuple:
        """The resident key of one stream's derived lengths
        (``tc_seg_len``, ``vpu_len``, ...) and the position map they
        derive from: the segment table's when the plan has one and
        ``segmented``, else the compact table's."""
        seg = "_seg" if segmented and f"{stream}_seg_vals" in self._host \
            else ""
        return f"{stream}{seg}_len", f"{stream}{seg}_pos"

    def for_backend(self, backend: str, *, revalue: bool = False,
                    segmented: bool = True) -> dict[str, torch.Tensor]:
        """Upload on first use and return the minimal device dict for
        one backend; memoized per (backend, revalue, segmented)."""
        ck = (backend, revalue, segmented)
        cached = self._bcache.get(ck)
        if cached is None:
            cached = {k: self[k] for k in self.backend_keys(
                backend, revalue=revalue, segmented=segmented)}
            if self._carries_lengths(backend):
                cached["tc_len"] = self.tc_len(segmented=segmented)
                cached["vpu_len"] = self.vpu_len(segmented=segmented)
            self._bcache[ck] = cached
        return cached

    def _length(self, stream: str, segmented: bool) -> torch.Tensor:
        key, table = self._length_source(stream, segmented)
        arr = self._derived.get(key)
        if arr is None:
            lengths = (real_vector_lengths if stream == "tc"
                       else real_prefix_lengths)(self._host[table])
            arr = self._derived[key] = _to_tensor(lengths, self.device)
            self._record(key, view_of_key(key), arr)
        return arr

    def tc_len(self, *, segmented: bool = True) -> torch.Tensor:
        """(nb,) i32 real-vector count of each segment (else block) of the
        Tensor Core SpMM table the kernel path reads (the compact blocks
        when ``segmented=False``), derived once from its position map and
        kept on the device."""
        return self._length("tc", segmented)

    def vpu_len(self, *, segmented: bool = True) -> torch.Tensor:
        """(ntiles,) i32 real length of each row of the CUDA-core SpMM
        table the kernel path reads (Cs segments, else tiles; the tiles
        when ``segmented=False``), derived once from its position map and
        kept on the device."""
        return self._length("vpu", segmented)

    def materialize_all(self) -> dict[str, torch.Tensor]:
        """Upload every host key and return the full device dict."""
        return {k: self[k] for k in self._host}

    # ---------------------------------------------------- accounting ---
    def set_accountant(self, accountant) -> None:
        """Attach a ``(view, key, nbytes, dtype) -> None`` upload
        recorder; uploads that already happened (e.g. during a tune
        search) are replayed into it immediately."""
        self._accountant = accountant
        if accountant is not None:
            for key, (view, nbytes, dtype) in self._uploads.items():
                accountant(view, key, nbytes, dtype)

    def resident_items(self) -> list[tuple[str, torch.Tensor]]:
        """The device tensors currently uploaded, derived lengths
        included (the ledger's ground truth)."""
        return sorted({**self._dev, **self._derived}.items())

    def resident_nbytes(self, view: str | None = None) -> int:
        """Exact bytes resident on the device (sum of the uploaded
        tensors' ``nbytes``), optionally for one view."""
        return sum(nb for v, nb, _ in self._uploads.values()
                   if view is None or v == view)

    def view_nbytes(self) -> dict[str, int]:
        """Resident bytes per view (zero-filled over all views)."""
        out = {v: 0 for v in PLAN_VIEWS}
        for v, nb, _ in self._uploads.values():
            out[v] += nb
        return out

    def projected_nbytes(self, backend: str | None = None, *,
                         revalue: bool = False,
                         segmented: bool = True) -> int:
        """Bytes this plan *would* hold resident once served: the
        backend key set's host ``nbytes`` (device dtypes are as wide as
        the host's) plus its derived lengths (int32, one per row of the
        table), or all host keys when ``backend`` is None. No upload
        happens."""
        if backend is None:
            return sum(int(h.nbytes) for h in self._host.values())
        keys = self.backend_keys(backend, revalue=revalue,
                                 segmented=segmented)
        lengths = 0
        if self._carries_lengths(backend):
            # One length a row: the table's shape up to its (8, bk)
            # blocks or its slots (a stacked table keeps its shard axis).
            lengths = sum(
                4 * math.prod(self._host[self._length_source(
                    s, segmented)[1]].shape[:-2 if s == "tc" else -1])
                for s in ("tc", "vpu"))
        return sum(int(self._host[k].nbytes) for k in keys) + lengths

    def memory(self) -> dict:
        """Per-view resident/lazy breakdown of the host keys."""
        views: dict[str, dict] = {
            v: {"keys": 0, "resident_keys": 0, "bytes": 0,
                "resident_bytes": 0} for v in PLAN_VIEWS}
        for k, host in self._host.items():
            st = views[self._views[k]]
            st["keys"] += 1
            st["bytes"] += int(host.nbytes)
            rec = self._uploads.get(k)
            if rec is not None:
                st["resident_keys"] += 1
                st["resident_bytes"] += rec[1]
        return {
            "views": {v: st for v, st in views.items() if st["keys"]},
            "resident_bytes": self.resident_nbytes(),
            "total_bytes": sum(int(h.nbytes) for h in self._host.values()),
        }
