"""Window-sharded partitioning of Libra plans (the distribution layer).

A :class:`~repro_torch.sparse.matrix.SparseCSR` is split into ``P``
shards of *contiguous 8-row windows* (the paper's SGT granularity — a
window never straddles shards, so every Tensor Core block and CUDA-core
tile lives wholly on one shard). Shard boundaries are chosen on the
cumulative cost curve, the contiguous analogue of the hybrid balancer's
segment decomposition: per-shard cost is within one window of the ideal
``total/P`` split (:func:`repro_torch.core.balance.balance_report`
quantifies the residue in ``meta``).

Each shard is then a self-contained Libra problem:

* **column-halo compaction** — the shard's column indices are remapped
  onto the sorted-unique set of B/Y rows they touch (``Shard.halo``).
  The remap is monotone, so the shard's canonical CSR nnz order is
  exactly the global order restricted to its row range — value vectors
  slice, they never permute.
* **per-shard autotuning** — :mod:`repro_torch.tune` runs on every
  shard's own pattern, so a dense-window shard and a hyper-sparse shard
  of the same matrix get different Tensor Core / CUDA-core thresholds.
  Preprocessing consumes the per-shard config; the tile fields are
  combined conservatively (min across shards) into one ``run_cfg``, as
  in the reference package, whose ``shard_map`` body is one program.
  ``tune="search"`` keeps the per-shard *thresholds* model-tuned and
  times candidate ``run_cfg``\\ s through the sharded apply itself
  (:func:`repro_torch.dist.sparse.spmm_sharded` on the given mesh, or on
  one holding every shard on the spec's device), memoized under a
  partition-level key in the persistent plan cache.
* **padded stacking** — per-shard tables are padded to common shapes and
  stacked on a leading shard axis. Padding is *inert by construction*:
  dummy Tensor Core blocks carry zero values and cover exactly the
  compacted output ranks a shard is missing, dummy segments and tiles
  scatter zeros onto local row 0, dummy SDDMM entries carry bitmap 0 /
  mask False and store nothing.

``out_gather`` / ``nnz_gather`` invert the padding: one global gather
reassembles the row-partitioned C (or the canonical nnz value vector)
from the stacked per-shard outputs.

The stacked tables stay host-side NumPy in the reference's dtypes, key
for key (``part.stacked``). :meth:`SpMMPartition.arrays` gives one
shard's slice as a lazy :class:`~repro_torch.core.formats.PlanArrays`
on a device (uploaded on first use, byte-accounted, with the kernel
path's derived lengths), and :meth:`SpMMPartition.index` one of the
global gathers as a device tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.api import ExecSpec, checked_device
from repro_torch.core import preprocess
from repro_torch.core.balance import BalanceParams, balance_report
from repro_torch.core.formats import (
    WINDOW,
    PlanArrays,
    _sddmm_segment_arrays,
    _spmm_segment_arrays,
)
from repro_torch.core.preprocess import (
    threshold_for_mode_sddmm,
    threshold_for_mode_spmm,
)
from repro_torch.core.windows import num_windows
from repro_torch.obs.metrics import default_registry
from repro_torch.sparse.matrix import SparseCSR
from repro_torch.tune import TuneConfig, tune_sddmm, tune_spmm


def _publish_partition_gauges(op: str, meta: dict, n_shards: int) -> None:
    """Shard-balance gauges on the process metrics registry — the §4.3
    balance residue and halo overhead of the most recent partition of
    each operator, labeled by op."""
    m = default_registry()
    m.gauge("dist_shards", "Shard count of the last partition",
            labels=("op",)).set(n_shards, op=op)
    m.gauge("dist_nnz_max_over_mean",
            "nnz balance residue of the last partition",
            labels=("op",)).set(meta["balance"]["max_over_mean"], op=op)
    sb = meta.get("segment_balance")
    if sb:
        m.gauge("dist_segment_max_over_mean",
                "Segment-load balance residue of the last partition",
                labels=("op",)).set(sb["max_over_mean"], op=op)
    halo = sum(meta.get("halo_rows", []))
    nnz = max(sum(meta.get("shard_nnz", [])), 1)
    m.gauge("dist_halo_rows", "Total halo rows of the last partition",
            labels=("op",)).set(halo, op=op)
    m.gauge("dist_halo_waste_frac",
            "Halo rows / total nnz of the last partition",
            labels=("op",)).set(halo / nnz, op=op)


# ------------------------------------------------------- window split ---
def shard_windows(a: SparseCSR, n_shards: int,
                  weights: np.ndarray | None = None) -> np.ndarray:
    """Contiguous window ranges balanced on a per-window cost curve.

    Returns ``bounds`` of shape ``(n_shards + 1,)``: shard ``i`` owns
    windows ``[bounds[i], bounds[i+1])``. Boundaries sit where the
    cumulative cost curve crosses ``i · total/P``, so every shard's cost
    is within one window's cost of the ideal split (shards may be empty
    when ``P > nwin``). ``weights`` is the per-window cost (the
    partitioners pass the §4.3 *segment curve* — kernel launch-table
    rows, the quantity that bounds a shard's latency on skewed
    matrices); ``None`` falls back to raw nnz.
    """
    nwin = num_windows(a.m)
    if weights is None:
        row_ends = np.minimum((np.arange(nwin) + 1) * WINDOW, a.m)
        cum = a.indptr[row_ends].astype(np.float64)  # nnz through window w
        total = float(a.nnz)
    else:
        weights = np.asarray(weights, np.float64)
        if weights.shape != (nwin,):
            raise ValueError(f"weights {weights.shape} for {nwin} windows")
        cum = np.cumsum(weights)
        total = float(cum[-1]) if nwin else 0.0
    targets = total * (np.arange(1, n_shards) / n_shards)
    inner = np.searchsorted(cum, targets, side="left") + 1
    bounds = np.concatenate([[0], np.minimum(inner, nwin), [nwin]])
    return np.maximum.accumulate(bounds).astype(np.int64)


def segment_curve(a: SparseCSR, *, op: str, threshold: int, bk: int,
                  seg_ts: int, seg_cs: int, ts_tile: int,
                  feat=None) -> np.ndarray:
    """Per-window §4.3 segment counts — the number of launch-table rows
    (thread blocks) each window contributes under the given caps.

    This is the curve the partitioners balance on: on power-law
    matrices, raw nnz under-weights windows whose work decomposes into
    many bounded segments. The CUDA-core term lower-bounds segments by
    ``ceil(residual/cs)`` (row raggedness ignored — a balance heuristic,
    not a launch table). ``feat`` (a precomputed
    :func:`~repro_torch.tune.model.matrix_features`) avoids a second
    feature pass when the caller already tuned on the same matrix.
    """
    from repro_torch.tune.model import matrix_features, sddmm_window_split

    feat = feat if feat is not None else matrix_features(a)
    hist = feat.win_vec_hist
    counts = np.arange(WINDOW + 1)
    nnz_w = (hist * counts[None, :]).sum(axis=1)
    if op == "spmm":
        t = int(np.clip(threshold, 1, WINDOW + 1))
        vec_tc_w = feat.vectors_at_least(threshold)
        tc_nnz_w = (hist[:, t:] * counts[None, t:]).sum(axis=1)
        blocks_w = -(-vec_tc_w // bk)
    else:  # sddmm: the cost model's block-granularity split, shared
        tc_mask, nblk_w, nnz_win = sddmm_window_split(feat, threshold, bk)
        blocks_w = np.where(tc_mask, nblk_w, 0).astype(np.int64)
        tc_nnz_w = np.where(tc_mask, nnz_win, 0)
    tc_segs = -(-blocks_w // seg_ts) if seg_ts > 0 else blocks_w
    res_w = nnz_w - tc_nnz_w
    cs_eff = max(seg_cs if seg_cs > 0 else ts_tile, 1)
    vpu_segs = -(-res_w // cs_eff)
    # matrix_features pads the histogram to max(nwin, 1) rows; trim so
    # an empty (m=0) matrix yields the empty curve shard_windows expects.
    return (tc_segs + vpu_segs).astype(np.int64)[:num_windows(a.m)]


def column_halo(a: SparseCSR, r0: int, r1: int
                ) -> tuple[np.ndarray, SparseCSR]:
    """Halo map + halo-remapped sub-CSR for global rows ``[r0, r1)``.

    The halo is the sorted-unique set of global B/Y-row ids the row
    range's column indices touch; the returned CSR has shape
    ``(r1 - r0, len(halo))`` with columns remapped onto halo positions.
    The remap is monotone (sorted halo), so canonical nnz order is
    preserved.
    """
    lo, hi = int(a.indptr[r0]), int(a.indptr[r1])
    cols = a.indices[lo:hi]
    halo = np.unique(cols).astype(np.int32)
    local_cols = np.searchsorted(halo, cols).astype(np.int32)
    indptr = (a.indptr[r0:r1 + 1] - lo).astype(np.int64)
    sub = SparseCSR(r1 - r0, max(int(halo.size), 1), indptr, local_cols,
                    a.data[lo:hi].astype(np.float32))
    return halo, sub


@dataclasses.dataclass(frozen=True)
class Shard:
    """One contiguous-window shard of a sparse matrix."""

    index: int
    win_start: int
    win_end: int
    row_start: int
    rows: int
    nnz_start: int
    nnz: int
    halo: np.ndarray     # (h,) i32 sorted unique global B/Y-row ids
    csr: SparseCSR       # (rows, max(h,1)) halo-remapped local matrix
    cfg: TuneConfig      # this shard's tuned plan-selection config


def _make_shards(a: SparseCSR, n_shards: int,
                 weights: np.ndarray | None = None) -> list[tuple]:
    bounds = shard_windows(a, n_shards, weights)
    out = []
    for p in range(n_shards):
        w0, w1 = int(bounds[p]), int(bounds[p + 1])
        r0 = min(w0 * WINDOW, a.m)
        r1 = max(min(w1 * WINDOW, a.m), r0)
        halo, sub = column_halo(a, r0, r1)
        out.append((p, w0, w1, r0, r1, halo, sub,
                    int(a.indptr[r0]), int(a.indptr[r1])))
    return out


def _combine_run_cfg(cfgs: list[TuneConfig], bk, ts_tile,
                     seg_ts, seg_cs) -> TuneConfig:
    """One config every shard can run: min tiles across shards (the
    reference's VMEM-safe rule; the CUDA kernels read none of these),
    always-legal grid order. The §4.3 segment caps ride through
    verbatim — they are unified across shards before preprocessing
    (stacked launch tables must agree in width), like
    ``bk``/``ts_tile``."""
    def opt_min(vals):
        got = [v for v in vals if v is not None]
        return min(got) if got else None

    return TuneConfig(
        kt=min(c.kt for c in cfgs),
        nt=min(c.nt for c in cfgs),
        kf_tile=min(c.kf_tile for c in cfgs),
        yt=opt_min([c.yt for c in cfgs]),
        xt=opt_min([c.xt for c in cfgs]),
        threshold=None, bk=bk, ts_tile=ts_tile,
        ts=seg_ts, cs=seg_cs,
        grid_order="n_outer", source="dist",
    )


def _offset_pos(pos: np.ndarray, off: int) -> np.ndarray:
    """Shift shard-local canonical nnz positions to global (−1 stays)."""
    return np.where(pos >= 0, pos + off, -1).astype(np.int32)


# ------------------------------------------------- run_cfg search (dist) ---
def _run_cfg_candidates(base: TuneConfig, op: str,
                        backend: str) -> list[TuneConfig]:
    """Candidate run_cfgs around the model-combined base (candidate #0,
    the floor the search can't lose to). The reference perturbs the TPU
    kernels' tiles; the CUDA kernels choose their own tiles and the
    plain path reads none, so on either backend the grid is the base
    alone (the reference's ``"xla"`` grid)."""
    return [base]


def _search_run_cfg(part, op: str, a: SparseCSR, *, width: int,
                    mode: str, threshold, bk, ts_tile, backend: str,
                    mesh, timer, cache, device,
                    reorder=None) -> TuneConfig:
    """Time candidate run_cfgs through the sharded apply on ``mesh``
    (or on one holding every shard on ``device``), memoized under a
    partition-level plan-cache key."""
    from repro_torch.tune import PlanCache, median_timer, tune_key
    from repro_torch.tune.search import _timing_device

    pc = cache if isinstance(cache, PlanCache) else PlanCache(cache)
    key = tune_key(a, op=f"{op}#p{part.n_shards}", width=width,
                   dtype="float32", backend=backend, mode=mode,
                   tune="search", threshold=threshold, bk=bk,
                   ts_tile=ts_tile, reorder=reorder)
    hit = pc.get(key)
    if hit is not None:
        return hit
    if mesh is None:
        from repro_torch.dist.sparse import ShardMesh

        mesh = ShardMesh([_timing_device(backend, device)] * part.n_shards)
    dev = mesh.device(0)
    timer = timer or median_timer()
    rng = np.random.default_rng(0)

    def operand(rows):
        return torch.from_numpy(rng.standard_normal(
            (rows, width)).astype(np.float32)).to(dev)

    operands = ((operand(a.k),) if op == "spmm"
                else (operand(a.m), operand(a.k)))
    candidates = _run_cfg_candidates(part.run_cfg, op, backend)
    best_i, timings = 0, {}
    for i, cand in enumerate(candidates):
        fn = _timed_apply(dataclasses.replace(part, run_cfg=cand), op,
                          backend=backend, mesh=mesh)
        timings[i] = timer(lambda: fn(*operands))
        if timings[i] < timings[best_i]:
            best_i = i
    cfg = candidates[best_i].replace(source="search")
    pc.put(key, cfg, meta={"timings_s": {str(i): t
                                         for i, t in timings.items()},
                           "n_shards": part.n_shards})
    return cfg


def _timed_apply(part, op: str, *, backend: str, mesh):
    """The sharded apply of one candidate partition on ``mesh``: on a
    mesh whose shards share one device, the batched apply over the
    stacked tables (the reference's no-mesh ``vmap`` over
    ``part.stacked``), the one that is served."""
    from repro_torch.dist.sparse import sddmm_sharded, spmm_sharded

    if op == "spmm":
        return lambda b: spmm_sharded(part, b, mesh=mesh, backend=backend)
    return lambda x, y: sddmm_sharded(part, x, y, mesh=mesh,
                                      backend=backend)


def _stack_spmm_segments(plans, shards, n_shards) -> dict[str, np.ndarray]:
    """Pad/stack each shard's §4.3 segment launch tables on the leading
    shard axis. Padding segments are inert: zero values scatter zeros
    onto local row 0, pos −1 skips revaluation (and gives the kernel
    path a real length of 0), and ranks stay unique (``arange``) so K1
    writes every padded output slot."""
    seg_list = [_spmm_segment_arrays(p) for p in plans]
    out: dict[str, np.ndarray] = {}
    if "tc_seg_vals" in seg_list[0]:
        ns = max(s["tc_seg_rank"].shape[0] for s in seg_list)
        wbk = seg_list[0]["tc_seg_vals"].shape[-1]
        vals = np.zeros((n_shards, ns, WINDOW, wbk), np.float32)
        cols = np.zeros((n_shards, ns, wbk), np.int32)
        pos = np.full((n_shards, ns, WINDOW, wbk), -1, np.int32)
        row = np.zeros((n_shards, ns * WINDOW), np.int32)
        for p, (s, sh) in enumerate(zip(seg_list, shards)):
            k = s["tc_seg_rank"].shape[0]
            vals[p, :k] = s["tc_seg_vals"]
            cols[p, :k] = s["tc_seg_cols"]
            pos[p, :k] = _offset_pos(s["tc_seg_pos"], sh.nnz_start)
            row[p, :k * WINDOW] = s["tc_seg_row"]
        rank = np.broadcast_to(np.arange(ns, dtype=np.int32),
                               (n_shards, ns)).copy()
        out.update(tc_seg_vals=vals, tc_seg_cols=cols, tc_seg_pos=pos,
                   tc_seg_row=row, tc_seg_rank=rank)
    if "vpu_seg_vals" in seg_list[0]:
        ns = max(s["vpu_seg_row"].shape[0] for s in seg_list)
        w = seg_list[0]["vpu_seg_vals"].shape[-1]
        vals = np.zeros((n_shards, ns, w), np.float32)
        cols = np.zeros((n_shards, ns, w), np.int32)
        pos = np.full((n_shards, ns, w), -1, np.int32)
        row = np.zeros((n_shards, ns), np.int32)
        for p, (s, sh) in enumerate(zip(seg_list, shards)):
            k = s["vpu_seg_row"].shape[0]
            vals[p, :k] = s["vpu_seg_vals"]
            cols[p, :k] = s["vpu_seg_cols"]
            pos[p, :k] = _offset_pos(s["vpu_seg_pos"], sh.nnz_start)
            row[p, :k] = s["vpu_seg_row"]
        out.update(vpu_seg_vals=vals, vpu_seg_cols=cols, vpu_seg_pos=pos,
                   vpu_seg_row=row)
    return out


def _segment_load_meta(plans) -> dict[str, Any]:
    """Per-shard §4.3 segment counts (= launch-table rows) — the load
    the segment-curve split balances."""
    def nseg(p):
        tc = p.meta.get("tc_segments")
        vpu = p.meta.get("vpu_segments")
        n = (tc.nseg if tc is not None else 0) \
            + (vpu.nseg if vpu is not None else 0)
        if vpu is None:  # SDDMM: flat element tiles grouped by seg_spt
            n += -(-p.vpu.ntiles // int(p.meta.get("seg_spt", 1)))
        return int(n)

    per = [nseg(p) for p in plans]
    mean = max(sum(per) / max(len(per), 1), 1e-9)
    return {"shard_segments": per,
            "segment_balance": {"max_over_mean": max(per) / mean,
                                "shards": len(per)}}


# ----------------------------------------------------------- partitions ---
class _DeviceViews:
    """Lazy device views of a partition: one
    :class:`~repro_torch.core.formats.PlanArrays` per (shard, device)
    over that shard's slice of the stacked tables, and the global
    gathers as int64 tensors. Nothing uploads before first use."""

    kind = "spmm"
    _GATHERS: tuple[str, ...] = ()

    def arrays(self, p: int, device="cuda") -> PlanArrays:
        """Shard ``p``'s tables on ``device`` (its ``"halo"`` key
        included), uploaded on first use."""
        dev = checked_device(device, f"{type(self).__name__}.arrays")
        key = ("arrays", p, str(dev))
        got = self._views.get(key)
        if got is None:
            host = {k: v[p] for k, v in self.stacked.items()}
            got = self._views[key] = PlanArrays.from_host(host, self.kind,
                                                          dev)
        return got

    def stacked_arrays(self, device="cuda") -> PlanArrays:
        """Every shard's tables at once on ``device``: the stacked tables
        with their leading shard axis (``"halo"`` included), uploaded on
        first use. The batched apply of a mesh whose shards share one
        device reads them (:mod:`repro_torch.dist.sparse`)."""
        dev = checked_device(device,
                             f"{type(self).__name__}.stacked_arrays")
        key = ("stacked", str(dev))
        got = self._views.get(key)
        if got is None:
            got = self._views[key] = PlanArrays.from_host(
                dict(self.stacked), self.kind, dev)
        return got

    def index(self, name: str, device="cuda") -> torch.Tensor:
        """One of the partition's global gathers (``out_gather``,
        ``x_take``, ``nnz_gather``, ``edge_perm``) on ``device``."""
        if name not in self._GATHERS:
            raise KeyError(f"{type(self).__name__} has no gather {name!r}")
        dev = checked_device(device, f"{type(self).__name__}.index")
        key = ("index", name, str(dev))
        got = self._views.get(key)
        if got is None:
            got = self._views[key] = torch.from_numpy(
                getattr(self, name).astype(np.int64)).to(dev)
        return got


@dataclasses.dataclass(frozen=True)
class SpMMPartition(_DeviceViews):
    """Window-sharded SpMM execution plan for one sparse matrix."""

    m: int
    k: int
    nnz: int
    n_shards: int
    shards: list[Shard]
    stacked: dict[str, np.ndarray]   # (P, ...) leading shard axis (+halo)
    wmax: int                        # windows per shard, padded
    rows_pad: int                    # = wmax * WINDOW, local C height
    run_cfg: TuneConfig              # tiles every shard can run
    out_gather: np.ndarray           # (m,) stacked-row id of global row
    meta: dict[str, Any]
    reorder: Any = None              # repro_torch.reorder.Reordering | None
    edge_perm: np.ndarray | None = None  # eff pos → original nnz pos
    _views: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    kind = "spmm"
    _GATHERS = ("out_gather", "edge_perm")


def partition_spmm(a: SparseCSR, n_shards: int, *,
                   spec: ExecSpec | None = None, mesh=None,
                   timer=None) -> SpMMPartition:
    """Split + per-shard tune + preprocess + pad/stack for sharded SpMM.

    Execution knobs live on one :class:`repro_torch.api.ExecSpec`.
    ``spec.tune`` accepts ``"model"``/``"search"``/``"off"``/a
    :class:`TuneConfig`. ``"search"`` keeps per-shard thresholds
    model-tuned and times candidate ``run_cfg``\\ s through the sharded
    apply (on ``mesh`` when given, else on a mesh holding every shard on
    ``spec.device``), memoizing the winner under a partition-level key
    in the persistent plan cache (``spec.tune_cache``);
    ``spec.tune_backend`` selects the timed backend. ``bk``/``ts_tile``
    are unified across shards (stacked block shapes must agree); each
    shard still gets its own threshold.

    ``spec.reorder`` prices/applies the row permutation on the *full*
    matrix before sharding, so shard boundaries balance the reordered
    segment curve. The composition is free at run time: ``out_gather``
    is pre-composed with the inverse row permutation (outputs come back
    in original row order) and ``edge_perm`` records the one extra
    gather sharded revaluation needs.
    """
    spec = ExecSpec() if spec is None else spec
    mode, threshold, tune = spec.mode, spec.threshold, spec.tune
    bk, ts_tile = spec.bk, spec.ts_tile
    tune_n = spec.tune_n
    if tune == "search":
        part = partition_spmm(a, n_shards, spec=spec.replace(tune="model"))
        cfg = _search_run_cfg(part, "spmm", a, width=tune_n, mode=mode,
                              threshold=threshold, bk=part.run_cfg.bk,
                              ts_tile=part.run_cfg.ts_tile,
                              backend=spec.tune_backend, mesh=mesh,
                              timer=timer, cache=spec.tune_cache,
                              device=spec.device, reorder=spec.reorder)
        meta = {**part.meta, "run_cfg_source": cfg.source}
        return dataclasses.replace(part, run_cfg=cfg, meta=meta)
    # One global feature pass fixes the common block geometry (shared by
    # the base tune and the segment curve — no second O(nnz) pass).
    from repro_torch.tune.model import matrix_features

    feat = matrix_features(a)
    forced = (threshold_for_mode_spmm(mode, threshold)
              if mode != "hybrid" else threshold)
    guess = preprocess.DEFAULT_SPMM_THRESHOLD if forced is None else forced
    a, reord, re_report, feat = preprocess._maybe_reorder(
        a, op="spmm", spec=spec, threshold=guess, feat=feat)
    base = tune_spmm(a, mode=mode, threshold=threshold, tune=tune,
                     n=tune_n, bk=bk, ts_tile=ts_tile, feat=feat)
    bk_c = bk if bk is not None else (base.bk or preprocess.DEFAULT_BK_SPMM)
    ts_c = ts_tile if ts_tile is not None else (base.ts_tile or 32)
    # §4.3 segment caps are unified like bk/ts_tile: stacked launch
    # tables must agree in width across shards.
    seg_ts = base.ts if base.ts is not None else BalanceParams.ts
    seg_cs = base.cs if base.cs is not None else BalanceParams.cs
    curve = segment_curve(
        a, op="spmm", threshold=threshold_for_mode_spmm(
            mode, forced if forced is not None else base.threshold),
        bk=bk_c, seg_ts=seg_ts, seg_cs=seg_cs, ts_tile=ts_c, feat=feat)
    raw = _make_shards(a, n_shards, weights=curve)
    shards, plans = [], []
    for p, w0, w1, r0, r1, halo, sub, nz0, nz1 in raw:
        cfg = tune_spmm(sub, mode=mode, threshold=forced, tune=tune,
                        n=tune_n, bk=bk_c, ts_tile=ts_c)
        cfg = cfg.replace(ts=seg_ts, cs=seg_cs)
        thr = threshold_for_mode_spmm(mode, cfg.threshold)
        plan = preprocess.preprocess_spmm(sub, thr, cfg=cfg)
        shards.append(Shard(p, w0, w1, r0, r1 - r0, nz0, nz1 - nz0,
                            halo, sub, cfg))
        plans.append(plan)

    wmax = max(1, max(s.win_end - s.win_start for s in shards))
    rows_pad = wmax * WINDOW
    na = max(p.tc.n_active for p in plans)
    nb = max(p.tc.nblk + (na - p.tc.n_active) for p in plans)
    nt = max(p.vpu.ntiles for p in plans)
    hmax = max(1, max(int(s.halo.size) for s in shards))

    tc_vals = np.zeros((n_shards, nb, WINDOW, bk_c), np.float32)
    tc_cols = np.zeros((n_shards, nb, bk_c), np.int32)
    tc_rank = np.zeros((n_shards, nb), np.int32)
    tc_pos = np.full((n_shards, nb, WINDOW, bk_c), -1, np.int32)
    tc_active_row = np.zeros((n_shards, na * WINDOW), np.int32)
    vpu_vals = np.zeros((n_shards, nt, ts_c), np.float32)
    vpu_cols = np.zeros((n_shards, nt, ts_c), np.int32)
    vpu_row = np.zeros((n_shards, nt), np.int32)
    vpu_pos = np.full((n_shards, nt, ts_c), -1, np.int32)
    halo_arr = np.zeros((n_shards, hmax), np.int32)

    for p, (shard, plan) in enumerate(zip(shards, plans)):
        tc, vpu = plan.tc, plan.vpu
        nblk, nact = tc.nblk, tc.n_active
        tc_vals[p, :nblk] = tc.vals
        tc_cols[p, :nblk] = tc.cols
        tc_pos[p, :nblk] = _offset_pos(tc.pos, shard.nnz_start)
        # Real ranks, then one dummy block per missing rank (so every
        # compacted output block is written), then repeat the last rank
        # (accumulates zeros).
        rank_pad = np.full(nb, na - 1, np.int32)
        rank_pad[:nblk] = tc.rank
        rank_pad[nblk:nblk + (na - nact)] = np.arange(nact, na,
                                                      dtype=np.int32)
        tc_rank[p] = rank_pad
        active_rows = (tc.active_win[:, None].astype(np.int64) * WINDOW
                       + np.arange(WINDOW)[None, :]).reshape(-1)
        tc_active_row[p, :nact * WINDOW] = active_rows
        ntl = vpu.ntiles
        vpu_vals[p, :ntl] = vpu.vals
        vpu_cols[p, :ntl] = vpu.cols
        vpu_row[p, :ntl] = vpu.row
        vpu_pos[p, :ntl] = _offset_pos(vpu.pos, shard.nnz_start)
        halo_arr[p, :shard.halo.size] = shard.halo

    out_gather = np.zeros(a.m, np.int32)
    for shard in shards:
        rr = np.arange(shard.rows)
        out_gather[shard.row_start + rr] = shard.index * rows_pad + rr
    if reord is not None:
        # Compose the unpermute into the existing reassembly gather:
        # original row j lives at reordered row row_inv[j]. Zero extra
        # run-time cost — same single gather as before.
        out_gather = out_gather[reord.row_inv]

    stacked = dict(
        tc_vals=tc_vals, tc_cols=tc_cols, tc_rank=tc_rank,
        tc_active_row=tc_active_row, tc_pos=tc_pos,
        vpu_vals=vpu_vals, vpu_cols=vpu_cols, vpu_row=vpu_row,
        vpu_pos=vpu_pos, halo=halo_arr)
    stacked.update(_stack_spmm_segments(plans, shards, n_shards))
    meta = {
        "balance": balance_report(
            np.asarray([s.nnz for s in shards], np.int64), n_shards),
        "halo_rows": [int(s.halo.size) for s in shards],
        "shard_nnz": [s.nnz for s in shards],
        "mode": mode,
        "reorder": re_report,
        **_segment_load_meta(plans),
    }
    _publish_partition_gauges("spmm", meta, n_shards)
    return SpMMPartition(a.m, a.k, a.nnz, n_shards, shards, stacked,
                         wmax, rows_pad,
                         _combine_run_cfg([s.cfg for s in shards], bk_c,
                                          ts_c, seg_ts, seg_cs),
                         out_gather, meta, reorder=reord,
                         edge_perm=(None if reord is None else
                                    reord.nnz_perm.astype(np.int32)))


def _stack_sddmm_segments(plans, n_shards) -> dict[str, np.ndarray]:
    """SDDMM flavour of :func:`_stack_spmm_segments`. Out-positions stay
    shard-local (the kernels store into the local nnz slice;
    ``nnz_gather`` reassembles) — padding carries bitmap 0 / mask False
    and pos −1/0, and stores nothing."""
    seg_list = [_sddmm_segment_arrays(p) for p in plans]
    out: dict[str, np.ndarray] = {}
    if "tc_seg_cols" in seg_list[0]:
        ns = max(s["tc_seg_window"].shape[0] for s in seg_list)
        wbk = seg_list[0]["tc_seg_cols"].shape[-1]
        cols = np.zeros((n_shards, ns, wbk), np.int32)
        bitmap = np.zeros((n_shards, ns, wbk), np.uint32)
        win = np.zeros((n_shards, ns), np.int32)
        opos = np.full((n_shards, ns, WINDOW, wbk), -1, np.int32)
        for p, s in enumerate(seg_list):
            k = s["tc_seg_window"].shape[0]
            cols[p, :k] = s["tc_seg_cols"]
            bitmap[p, :k] = s["tc_seg_bitmap"]
            win[p, :k] = s["tc_seg_window"]
            opos[p, :k] = s["tc_seg_out_pos"]
        out.update(tc_seg_cols=cols, tc_seg_bitmap=bitmap,
                   tc_seg_window=win, tc_seg_out_pos=opos)
    if "vpu_seg_rows" in seg_list[0]:
        ns = max(s["vpu_seg_rows"].shape[0] for s in seg_list)
        w = seg_list[0]["vpu_seg_rows"].shape[-1]
        rows = np.zeros((n_shards, ns, w), np.int32)
        cols = np.zeros((n_shards, ns, w), np.int32)
        opos = np.zeros((n_shards, ns, w), np.int32)
        mask = np.zeros((n_shards, ns, w), bool)
        for p, s in enumerate(seg_list):
            k = s["vpu_seg_rows"].shape[0]
            rows[p, :k] = s["vpu_seg_rows"]
            cols[p, :k] = s["vpu_seg_cols"]
            opos[p, :k] = s["vpu_seg_out_pos"]
            mask[p, :k] = s["vpu_seg_mask"]
        out.update(vpu_seg_rows=rows, vpu_seg_cols=cols,
                   vpu_seg_out_pos=opos, vpu_seg_mask=mask)
    return out


@dataclasses.dataclass(frozen=True)
class SDDMMPartition(_DeviceViews):
    """Window-sharded SDDMM execution plan for one sparse mask."""

    m: int
    k: int
    nnz: int
    n_shards: int
    shards: list[Shard]
    stacked: dict[str, np.ndarray]
    wmax: int
    rows_pad: int
    nnz_pad: int                     # local padded nnz per shard
    run_cfg: TuneConfig
    x_take: np.ndarray               # (P*rows_pad,) global X row per slot
    nnz_gather: np.ndarray           # (nnz,) stacked slot of global nnz p
    meta: dict[str, Any]
    reorder: Any = None              # repro_torch.reorder.Reordering | None
    _views: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    kind = "sddmm"
    _GATHERS = ("x_take", "nnz_gather")


def partition_sddmm(a: SparseCSR, n_shards: int, *,
                    spec: ExecSpec | None = None, mesh=None,
                    timer=None) -> SDDMMPartition:
    """SDDMM flavour of :func:`partition_spmm` (same sharding geometry;
    scores come back in canonical global nnz order via ``nnz_gather``;
    same partition-level ``tune="search"`` and ``spec.reorder``
    semantics; the threshold is ``spec.sddmm_threshold``). Under
    reordering, ``x_take`` is pre-composed with the row permutation and
    ``nnz_gather`` with the inverse nnz permutation, so X arrives and
    scores return in original order at no extra run-time cost."""
    spec = ExecSpec() if spec is None else spec
    mode, threshold, tune = spec.mode, spec.sddmm_threshold, spec.tune
    bk, ts_tile = spec.bk, spec.ts_tile
    tune_kf = spec.tune_kf
    if tune == "search":
        part = partition_sddmm(a, n_shards, spec=spec.replace(tune="model"))
        cfg = _search_run_cfg(part, "sddmm", a, width=tune_kf, mode=mode,
                              threshold=threshold, bk=part.run_cfg.bk,
                              ts_tile=part.run_cfg.ts_tile,
                              backend=spec.tune_backend, mesh=mesh,
                              timer=timer, cache=spec.tune_cache,
                              device=spec.device, reorder=spec.reorder)
        meta = {**part.meta, "run_cfg_source": cfg.source}
        return dataclasses.replace(part, run_cfg=cfg, meta=meta)
    from repro_torch.tune.model import matrix_features

    feat = matrix_features(a)
    bk_eff = preprocess.DEFAULT_BK_SDDMM if bk is None else bk
    forced0 = (threshold_for_mode_sddmm(mode, bk_eff, threshold)
               if mode != "hybrid" else threshold)
    guess = preprocess.DEFAULT_SDDMM_THRESHOLD if forced0 is None else forced0
    a, reord, re_report, feat = preprocess._maybe_reorder(
        a, op="sddmm", spec=spec, threshold=guess, feat=feat)
    base = tune_sddmm(a, mode=mode, threshold=threshold, tune=tune,
                      kf=tune_kf, bk=bk, ts_tile=ts_tile, feat=feat)
    bk_c = bk if bk is not None else (base.bk or preprocess.DEFAULT_BK_SDDMM)
    ts_c = ts_tile if ts_tile is not None else (base.ts_tile or 32)
    seg_ts = base.ts if base.ts is not None else BalanceParams.ts
    seg_cs = base.cs if base.cs is not None else BalanceParams.cs

    forced = (threshold_for_mode_sddmm(mode, bk_c, threshold)
              if mode != "hybrid" else threshold)
    curve = segment_curve(
        a, op="sddmm", threshold=threshold_for_mode_sddmm(
            mode, bk_c, forced if forced is not None else base.threshold),
        bk=bk_c, seg_ts=seg_ts, seg_cs=seg_cs, ts_tile=ts_c, feat=feat)
    raw = _make_shards(a, n_shards, weights=curve)
    shards, plans = [], []
    for p, w0, w1, r0, r1, halo, sub, nz0, nz1 in raw:
        cfg = tune_sddmm(sub, mode=mode, threshold=forced, tune=tune,
                         kf=tune_kf, bk=bk_c, ts_tile=ts_c)
        cfg = cfg.replace(ts=seg_ts, cs=seg_cs)
        thr = threshold_for_mode_sddmm(mode, bk_c, cfg.threshold)
        plan = preprocess.preprocess_sddmm(sub, thr, cfg=cfg)
        shards.append(Shard(p, w0, w1, r0, r1 - r0, nz0, nz1 - nz0,
                            halo, sub, cfg))
        plans.append(plan)

    wmax = max(1, max(s.win_end - s.win_start for s in shards))
    rows_pad = wmax * WINDOW
    nb = max(p.tc.nblk for p in plans)
    ntl = max(p.vpu.ntiles for p in plans)
    hmax = max(1, max(int(s.halo.size) for s in shards))
    nnz_pad = max(1, max(s.nnz for s in shards))

    tc_cols = np.zeros((n_shards, nb, bk_c), np.int32)
    tc_bitmap = np.zeros((n_shards, nb, bk_c), np.uint32)
    tc_window = np.zeros((n_shards, nb), np.int32)
    tc_out_pos = np.full((n_shards, nb, WINDOW, bk_c), -1, np.int32)
    vpu_rows = np.zeros((n_shards, ntl, ts_c), np.int32)
    vpu_cols = np.zeros((n_shards, ntl, ts_c), np.int32)
    vpu_out_pos = np.zeros((n_shards, ntl, ts_c), np.int32)
    vpu_mask = np.zeros((n_shards, ntl, ts_c), bool)
    halo_arr = np.zeros((n_shards, hmax), np.int32)

    for p, (shard, plan) in enumerate(zip(shards, plans)):
        tc, vpu = plan.tc, plan.vpu
        tc_cols[p, :tc.nblk] = tc.cols
        tc_bitmap[p, :tc.nblk] = tc.bitmap
        tc_window[p, :tc.nblk] = tc.window
        tc_out_pos[p, :tc.nblk] = plan.tc_out_pos  # shard-local positions
        vpu_rows[p, :vpu.ntiles] = vpu.rows
        vpu_cols[p, :vpu.ntiles] = vpu.cols
        vpu_out_pos[p, :vpu.ntiles] = vpu.out_pos
        vpu_mask[p, :vpu.ntiles] = vpu.mask
        halo_arr[p, :shard.halo.size] = shard.halo

    x_take = np.zeros(n_shards * rows_pad, np.int32)
    nnz_gather = np.zeros(a.nnz, np.int32)
    for shard in shards:
        sl = slice(shard.index * rows_pad, (shard.index + 1) * rows_pad)
        x_take[sl] = np.clip(shard.row_start + np.arange(rows_pad),
                             0, max(a.m - 1, 0))
        nnz_gather[shard.nnz_start:shard.nnz_start + shard.nnz] = \
            shard.index * nnz_pad + np.arange(shard.nnz)
    if reord is not None:
        # Compose the un-reorder into the existing gathers: X slots name
        # original rows directly (eff row i = original row row_perm[i]),
        # and original nnz p sits at reordered position nnz_inv[p].
        x_take = reord.row_perm.astype(np.int32)[x_take]
        nnz_gather = nnz_gather[reord.nnz_inv]

    stacked = dict(
        tc_cols=tc_cols, tc_bitmap=tc_bitmap, tc_window=tc_window,
        tc_out_pos=tc_out_pos, vpu_rows=vpu_rows, vpu_cols=vpu_cols,
        vpu_out_pos=vpu_out_pos, vpu_mask=vpu_mask, halo=halo_arr)
    stacked.update(_stack_sddmm_segments(plans, n_shards))
    meta = {
        "balance": balance_report(
            np.asarray([s.nnz for s in shards], np.int64), n_shards),
        "halo_rows": [int(s.halo.size) for s in shards],
        "shard_nnz": [s.nnz for s in shards],
        "mode": mode,
        "reorder": re_report,
        **_segment_load_meta(plans),
    }
    _publish_partition_gauges("sddmm", meta, n_shards)
    return SDDMMPartition(a.m, a.k, a.nnz, n_shards, shards, stacked,
                          wmax, rows_pad, nnz_pad,
                          _combine_run_cfg([s.cfg for s in shards],
                                           bk_c, ts_c, seg_ts, seg_cs),
                          x_take, nnz_gather, meta, reorder=reord)
