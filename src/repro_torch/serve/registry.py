"""Multi-tenant graph/operator registry: the serving plan store.

Libra's preprocessing + autotuning is a per-matrix, amortizable cost —
exactly the shape that wins in a serving setting where one tuned plan
answers thousands of feature-panel requests. The registry owns that
amortized state:

* **register once** — a :class:`~repro_torch.sparse.matrix.SparseCSR`
  is registered under a tenant-chosen name; construction runs
  :mod:`repro_torch.tune` (threshold + segment caps, optionally through
  the persistent plan cache) and preprocessing, and builds the
  panel-stack operators (:class:`~repro_torch.dist.sparse.BatchedSpMM`
  / :class:`~repro_torch.dist.sparse.BatchedSDDMM`, or the sharded
  :class:`~repro_torch.dist.sparse.ShardedSpMM` /
  :class:`~repro_torch.dist.sparse.ShardedSDDMM` when a
  :class:`~repro_torch.dist.sparse.ShardMesh` is given).
* **content-addressed + multi-tenant** — entries are keyed by the
  sparsity signature (:func:`repro_torch.tune.cache.matrix_signature`)
  plus a value digest and mode/layout, so two tenants registering the
  same matrix share one plan (the second registration is a reuse hit,
  not a rebuild). Any number of names may alias one entry.
* **LRU cap** — at most ``max_graphs`` entries stay resident; the
  least-recently-*served* entry is evicted (its prepared applies and
  plan tensors are dropped; the persistent tune cache keeps re-tuning
  cheap on re-registration).
* **byte budget** — an optional ``max_bytes`` cap (env
  ``REPRO_TORCH_REGISTRY_MAX_BYTES``) evicts least-recently-served
  entries by *accounted device bytes* (every lazy plan upload lands in a
  :class:`repro_torch.obs.memstat.MemLedger`), and rejects
  registrations whose serving-view footprint exceeds the budget outright
  with a typed :class:`~repro_torch.obs.memstat.MemoryPressure`.
* **warmup** — :meth:`warm` prepares one apply per (op, feature-width
  bucket, panel-size bucket, dtype, backend) ahead of traffic (on the
  card: the kernel library's build and the plan tables' upload), so the
  first request of each bucket shape doesn't pay them.

Entries serve on ``backend="cuda"`` (K1–K4) by default, on the card
(``device="cuda"``); without one the registry raises instead of running
on the CPU.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.api import ExecSpec, checked_device
from repro_torch.obs.memstat import MemLedger, MemoryPressure
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.sparse.matrix import SparseCSR
from repro_torch.tune.cache import matrix_signature

def graph_key(a: SparseCSR, mode: str, layout: str) -> str:
    """Registry content key: sparsity signature **plus a value digest**.

    Plan *selection* is pattern-only (:func:`matrix_signature`), but a
    registered plan bakes the value vector in — two graphs with one
    pattern and different values (e.g. a GCN's normalized adjacency vs
    the raw graph) must not share an entry.
    """
    vals = hashlib.blake2b(np.ascontiguousarray(a.data).tobytes(),
                           digest_size=8).hexdigest()
    return f"{matrix_signature(a)}:{vals}:{mode}:{layout}"

DEFAULT_WIDTH_BUCKETS = (32, 64, 128)
DEFAULT_PANEL_BUCKETS = (1, 2, 4, 8)

# Column-packing budget for the CUDA-core stream's gather working set
# (ntiles · ts · packed-width · 4B), the reference package's value and
# rule. It prices the gather tensor the reference's residual path
# materializes, which K2 does not build (K2 gathers B rows straight
# from L2-sized column slices); the card's own value is measured by
# chip_smoke.py phase 7 (d) and is ROADMAP work.
PACK_BUDGET_BYTES = 2 * 2**20


@dataclasses.dataclass
class RegisteredGraph:
    """One resident graph: its operators and serving metadata."""

    key: str
    names: set[str]
    m: int
    k: int
    nnz: int
    mode: str
    sharded: bool
    ops: dict[str, object]          # "spmm"/"sddmm" → Batched*/Sharded* op
    spmm_vpu_elems: int = 0         # CUDA-core elements of the SpMM plan
    plan_cache_hits: int = 0        # tune configs served from PlanCache
    warmed: int = 0                 # applies prepared by warm()
    # Host seconds of building the operators by plan-build stage, summed
    # over them (``Plan.build``'s ``plan.meta["build_s"]``); ``rest`` is
    # the remainder of the builds' wall time.
    build_s: dict[str, float] = dataclasses.field(default_factory=dict)

    def op(self, kind: str):
        try:
            return self.ops[kind]
        except KeyError:
            raise KeyError(f"graph {sorted(self.names)} has no "
                           f"{kind!r} operator") from None


class GraphRegistry:
    """LRU-capped, signature-keyed store of ready-to-serve operators."""

    def __init__(self, max_graphs: int = 8, *,
                 width_buckets=DEFAULT_WIDTH_BUCKETS,
                 panel_buckets=DEFAULT_PANEL_BUCKETS,
                 backend: str = "cuda", device="cuda",
                 tune="model", tune_cache=None, faults=None,
                 metrics: MetricsRegistry | None = None,
                 max_bytes: int | None = None, mem: bool = True):
        if max_graphs < 1:
            raise ValueError(f"max_graphs must be >= 1, got {max_graphs}")
        self.max_graphs = max_graphs
        if max_bytes is None:
            env = os.environ.get("REPRO_TORCH_REGISTRY_MAX_BYTES")
            max_bytes = int(env) if env else None
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError(f"max_bytes must be > 0, got {max_bytes}")
        self.max_bytes = max_bytes
        self.width_buckets = tuple(sorted(width_buckets))
        self.panel_buckets = tuple(sorted(panel_buckets))
        self.backend = backend
        self.device = str(checked_device(device, "GraphRegistry"))
        self.tune = tune
        self.tune_cache = tune_cache
        # Optional repro_torch.serve.faults.FaultPlan: warmup applies
        # tick it at the "warm" strategy, so preparation-time faults are
        # as schedulable as execution-time ones.
        self.faults = faults
        self._entries: OrderedDict[str, RegisteredGraph] = OrderedDict()
        self._names: dict[str, str] = {}
        # Counters live on the metrics registry; stats() is a thin view.
        self.metrics = MetricsRegistry() if metrics is None else metrics
        m = self.metrics
        self._reuse_hits = m.counter(
            "registry_reuse_hits_total",
            "register() calls resolved to a resident graph")
        self._evictions = m.counter(
            "registry_evictions_total", "Graphs evicted by the LRU cap")
        self._registered_total = m.counter(
            "registry_registered_total", "Distinct graphs ever built")
        self._resident = m.gauge(
            "registry_graphs_resident", "Graphs currently resident")
        self._invalidations = m.counter(
            "registry_invalidations_total",
            "Graphs dropped by drift invalidation")
        # Byte accounting: every PlanArrays upload lands in the ledger,
        # so eviction pressure and /memory report exact device bytes.
        self.mem = MemLedger(metrics=m) if mem else None
        self._pressure_evictions = m.counter(
            "registry_pressure_evictions_total",
            "Graphs evicted to satisfy the max_bytes budget")
        self._pressure_rejects = m.counter(
            "registry_pressure_rejects_total",
            "Registrations rejected: plan bytes exceed max_bytes alone")

    # ------------------------------------------------------------ admit ---
    def register(self, a: SparseCSR, *, name: str | None = None,
                 ops=("spmm", "sddmm"), mesh=None, warm_widths=(),
                 spec: ExecSpec | None = None) -> str:
        """Register a sparse matrix; returns the (possibly generated)
        tenant name. Re-registering an identical matrix (same mode,
        layout and reorder policy) aliases the existing entry instead
        of rebuilding.

        Execution knobs ride one :class:`repro_torch.api.ExecSpec`
        (``spec=``; its ``reorder`` field is picked up transparently —
        the built operators un-permute internally, so serving callers
        see original row/nnz order). When no spec is given, the
        registry's own construction defaults (``tune``, ``tune_cache``,
        ``backend``, ``device``) make it.

        ``mesh`` (a :class:`~repro_torch.dist.sparse.ShardMesh`)
        switches the entry to window-sharded execution
        (:class:`~repro_torch.dist.sparse.ShardedSpMM`);
        ``warm_widths`` prepares those width buckets across all panel
        buckets right away (see :meth:`warm`).
        """
        spec = spec if spec is not None else ExecSpec(
            tune=self.tune, tune_cache=self.tune_cache,
            backend=self.backend, device=self.device)
        mode = spec.mode
        layout = "sharded" if mesh is not None else "batched"
        if spec.reorder != "off":
            # Reordered plans are different assets: don't alias them
            # with unreordered registrations of the same pattern.
            layout += f"+reorder-{spec.reorder}"
        key = graph_key(a, mode, layout)
        name = name if name is not None else f"g-{key[:10]}"
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            # A name may have been rebound elsewhere since: re-point it.
            old_key = self._names.get(name)
            if old_key is not None and old_key != key:
                other = self._entries.get(old_key)
                if other is not None:
                    other.names.discard(name)
            entry.names.add(name)
            self._names[name] = key
            self._reuse_hits.inc()
            missing = [kind for kind in ops if kind not in entry.ops]
            if missing:   # alias asked for more operators: top up in place
                built, hits, build_s = self._build(a, missing, mesh=mesh,
                                                   spec=spec)
                entry.ops.update(built)
                entry.plan_cache_hits += hits
                for k, v in build_s.items():
                    entry.build_s[k] = entry.build_s.get(k, 0.0) + v
                self._account_entry(key, built)
            for w in warm_widths:    # aliases may warm new buckets too
                for kind in entry.ops:
                    self.warm(name, kind, widths=(w,))
            self.enforce_budget()
            return name

        built, hits, build_s = self._build(a, ops, mesh=mesh, spec=spec)
        if not built:
            raise ValueError(f"no operators requested: ops={ops!r}")

        if self.max_bytes is not None:
            # Admission: the projected serving-view footprint must fit
            # the budget on its own — otherwise no eviction could admit
            # it. Priced from host nbytes; nothing uploads here.
            need = self._entry_bytes(built)
            if need > self.max_bytes:
                self._pressure_rejects.inc()
                raise MemoryPressure(
                    f"graph {name!r} needs {need} plan bytes for the "
                    f"{self.backend!r} serving view; registry budget is "
                    f"{self.max_bytes}", required=need,
                    budget=self.max_bytes)

        vpu_elems = 0
        if "spmm" in built:
            if mesh is None:
                vpu = built["spmm"].op.plan.vpu
                vpu_elems = int(vpu.ntiles) * int(vpu.vals.shape[-1])
            else:
                # Sharded: the cache-resident stream is per shard.
                vv = built["spmm"].part.stacked["vpu_vals"]
                vpu_elems = int(vv.shape[1]) * int(vv.shape[2])
        entry = RegisteredGraph(key=key, names={name}, m=a.m, k=a.k,
                                nnz=a.nnz, mode=mode,
                                sharded=mesh is not None, ops=built,
                                spmm_vpu_elems=vpu_elems,
                                plan_cache_hits=hits, build_s=build_s)
        self._entries[key] = entry
        old_key = self._names.get(name)
        if old_key is not None:        # name rebound to a new graph
            other = self._entries.get(old_key)
            if other is not None:
                other.names.discard(name)
        self._names[name] = key
        self._registered_total.inc()
        self._resident.set(len(self._entries))
        self._account_entry(key, built)
        while len(self._entries) > self.max_graphs:
            old_key, old = self._entries.popitem(last=False)
            self._drop_entry(old_key, old)
            self._evictions.inc()
            self._resident.set(len(self._entries))
        for w in warm_widths:
            for kind in built:
                self.warm(name, kind, widths=(w,))
        self.enforce_budget()
        return name

    def _account_entry(self, key: str, built: dict) -> None:
        """Attach byte accounting to an entry's operators: plan uploads
        (a sharded entry's stacked tables, or each shard's under
        ``shard<p>/`` keys on a spread mesh)
        stream into the ledger as they materialize, and uploads that
        already happened replay on attach."""
        if self.mem is None:
            return
        for kind, op in built.items():
            for prefix, arrays in _plan_arrays(op):
                arrays.set_accountant(_prefixed(self.mem.binder(key, kind),
                                                prefix))

    def _entry_bytes(self, built: dict) -> int:
        """Projected resident bytes of an entry once serving on the
        registry backend (host nbytes plus the kernel path's derived
        lengths; each shard's halo map for sharded entries)."""
        return sum(arrays.projected_nbytes(self.backend)
                   + int(arrays.host.get("halo", np.empty(0)).nbytes)
                   for op in built.values()
                   for _, arrays in _plan_arrays(op))

    def _drop_entry(self, old_key: str, old: RegisteredGraph) -> None:
        """Unbind an evicted entry's aliases and release its bytes."""
        for alias in old.names:
            # Only unbind aliases still pointing at the evicted
            # entry — a rebound name belongs to a resident graph.
            if self._names.get(alias) == old_key:
                self._names.pop(alias)
        if self.mem is not None:
            self.mem.release(old_key)
            for op in old.ops.values():
                for _, arrays in _plan_arrays(op):
                    arrays.set_accountant(None)

    def enforce_budget(self) -> int:
        """Evict least-recently-served entries until accounted resident
        bytes fit ``max_bytes`` (at least one entry always stays).
        Called after register/warm and at the end of engine flushes —
        the points where residency grows. Returns evictions."""
        if self.max_bytes is None or self.mem is None:
            return 0
        dropped = 0
        while (self.mem.resident_bytes() > self.max_bytes
               and len(self._entries) > 1):
            old_key, old = self._entries.popitem(last=False)
            self._drop_entry(old_key, old)
            self._evictions.inc()
            self._pressure_evictions.inc()
            self._resident.set(len(self._entries))
            dropped += 1
        return dropped

    def _build(self, a: SparseCSR, kinds, *, mesh, spec: ExecSpec
               ) -> tuple[dict[str, object], int, dict[str, float]]:
        """The operators of ``kinds``, the tune-cache hits, and the
        build's host seconds by plan-build stage (a sharded entry's
        partitions count whole under ``rest``)."""
        from repro_torch.dist.sparse import (BatchedSDDMM, BatchedSpMM,
                                             ShardedSDDMM, ShardedSpMM)

        t0 = time.perf_counter()
        built: dict[str, object] = {}
        hits = 0
        build_s: dict[str, float] = {}
        for kind in kinds:
            if mesh is None:
                cls = BatchedSpMM if kind == "spmm" else BatchedSDDMM
                op = cls(a, spec=spec)
                hits += op.op.tune_config.source == "cache"
                for k, v in op.op.plan.meta["build_s"].items():
                    if k != "rest":
                        build_s[k] = build_s.get(k, 0.0) + v
            else:
                cls = ShardedSpMM if kind == "spmm" else ShardedSDDMM
                op = cls(a, mesh, spec=spec)
                hits += op.tune_config.source == "cache"
            built[kind] = op
        build_s["rest"] = time.perf_counter() - t0 - sum(build_s.values())
        return built, hits, build_s

    # ------------------------------------------------------------ serve ---
    def resolve(self, name: str) -> RegisteredGraph:
        """Entry lookup without an LRU touch (admission-control path).
        Raises ``KeyError`` for unknown / evicted names."""
        return self._entries[self._names[name]]

    def get(self, name: str) -> RegisteredGraph:
        """Entry lookup, counted as a use (moves the entry to the LRU
        front)."""
        key = self._names[name]
        self._entries.move_to_end(key)
        return self._entries[key]

    def __contains__(self, name: str) -> bool:
        return name in self._names

    def warm(self, name: str, op: str = "spmm", *, widths=None,
             panels=None, dtype=torch.float32) -> int:
        """Run each apply the engine will run, one for each (width
        bucket, panel bucket), once on zeros; returns how many apply keys
        were new. SpMM panel buckets ride the column
        axis (the engine packs a bucket's panels side by side into one
        ``(k, p·w)`` apply, capped by :meth:`pack_limit`); SDDMM panel
        buckets are ``(p, rows, w)`` stacks; a sharded SDDMM serves per
        request, so it warms one panel."""
        entry = self.get(name)
        fn = entry.op(op)
        dev = fn.mesh.device(0) if entry.sharded else fn.op.device
        compiled = 0
        for w in (widths if widths is not None else self.width_buckets):
            for p in (panels if panels is not None else self.panel_buckets):
                if self.faults is not None:
                    self.faults.check(name, op, "warm")
                if op == "spmm":
                    if p > self.pack_limit(entry, w):
                        continue   # the engine will never run this shape
                    b = torch.zeros((entry.k, p * w), dtype=dtype, device=dev)
                    cache = fn._cache if entry.sharded else \
                        fn.op._apply_cache
                    before = len(cache)
                    if entry.sharded:
                        fn(b)
                    else:
                        fn.op(b, backend=self.backend)
                elif entry.sharded:
                    if p > 1:
                        continue   # sharded SDDMM serves per request
                    cache = fn._cache
                    before = len(cache)
                    fn(torch.zeros((entry.m, w), dtype=dtype, device=dev),
                       torch.zeros((entry.k, w), dtype=dtype, device=dev))
                else:
                    cache = fn._cache
                    before = len(cache)
                    fn(torch.zeros((p, entry.m, w), dtype=dtype, device=dev),
                       torch.zeros((p, entry.k, w), dtype=dtype, device=dev),
                       backend=self.backend)
                compiled += len(cache) > before
        entry.warmed += compiled
        self.enforce_budget()   # warmup materializes lazy views
        return compiled

    def invalidate(self, signature: str) -> int:
        """Drop every resident entry for a sparsity ``signature``
        (:func:`~repro_torch.tune.cache.matrix_signature`), unbinding
        its aliases. The drift feedback path: after
        :func:`repro_torch.obs.calibrate.apply_drift` stales a
        tune-cache key, invalidating the signature forces the next
        registration to rebuild — and hence re-tune — instead of reusing
        the resident applies. Returns how many entries were dropped."""
        doomed = [key for key in self._entries
                  if key.startswith(signature + ":")]
        for key in doomed:
            old = self._entries.pop(key)
            self._drop_entry(key, old)
            self._invalidations.inc()
        self._resident.set(len(self._entries))
        return len(doomed)

    # ------------------------------------------------------------ stats ---
    def width_bucket(self, width: int) -> int | None:
        """Smallest width bucket holding ``width`` (None = too wide)."""
        for w in self.width_buckets:
            if width <= w:
                return w
        return None

    def panel_bucket(self, count: int) -> int:
        """Smallest panel bucket holding ``count`` panels."""
        for p in self.panel_buckets:
            if count <= p:
                return p
        return self.panel_buckets[-1]

    def pack_limit(self, entry: RegisteredGraph, width: int) -> int:
        """Largest panel bucket whose column-packed SpMM apply keeps the
        plan's CUDA-core gather working set inside
        :data:`PACK_BUDGET_BYTES` (1 ⇒ serve panels singly). For sharded
        entries the resident stream is one shard's slice, so they pack
        deeper."""
        top = self.panel_buckets[-1]
        if entry.spmm_vpu_elems == 0:
            return top
        fit = PACK_BUDGET_BYTES // (entry.spmm_vpu_elems * width * 4)
        best = 1
        for p in self.panel_buckets:
            if p <= fit:
                best = max(best, p)
        return min(best, top)

    def stats(self) -> dict:
        out = {
            "graphs_resident": len(self._entries),
            "registered_total": self._registered_total.value,
            "reuse_hits": self._reuse_hits.value,
            "evictions": self._evictions.value,
            "invalidations": self._invalidations.value,
            "plan_cache_hits": sum(e.plan_cache_hits
                                   for e in self._entries.values()),
            "warmed_executables": sum(e.warmed
                                      for e in self._entries.values()),
            "names": {n: self._entries[k].key[:10]
                      for n, k in sorted(self._names.items())},
        }
        if self.mem is not None:
            out["resident_bytes"] = self.mem.resident_bytes()
            out["peak_bytes"] = self.mem.peak_bytes()
            out["max_bytes"] = self.max_bytes
            out["pressure_evictions"] = self._pressure_evictions.value
            out["pressure_rejects"] = self._pressure_rejects.value
        return out

    def plan_build_s(self) -> dict[str, float]:
        """Host seconds of building the resident entries' operators, by
        plan-build stage (each entry's ``build_s``), summed."""
        out: dict[str, float] = {}
        for entry in self._entries.values():
            for k, v in entry.build_s.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def memory_report(self, top_k: int = 8) -> dict:
        """Exact device-byte attribution (see
        :meth:`repro_torch.obs.memstat.MemLedger.memory_report`); adds the
        budget so dashboards can show headroom."""
        if self.mem is None:
            raise ValueError("byte accounting disabled (mem=False)")
        report = self.mem.memory_report(top_k=top_k)
        report["max_bytes"] = self.max_bytes
        return report


def _plan_arrays(op) -> list[tuple[str, object]]:
    """``(key prefix, PlanArrays)`` of one registered operator: its plan's
    for a batched op; for a sharded op the stacked tables (unprefixed,
    as the reference books them) when its shards share one device, else
    one a shard."""
    shards = getattr(op, "arrays", None)
    if shards is None:
        return [("", op.op.arrays)]
    if op.mesh.one_device:
        return [("", shards[0])]
    return [(f"shard{p}/", arrays) for p, arrays in enumerate(shards)]


def _prefixed(account, prefix: str):
    """An upload accountant that files each key under ``prefix``."""
    if not prefix:
        return account
    return lambda view, key, nbytes, dtype: account(
        view, prefix + key, nbytes, dtype)


def as_csr(a, values: np.ndarray | None = None) -> SparseCSR:
    """Clone a CSR, optionally swapping its values (pattern untouched) —
    the hook for registering value-parameterized graphs (e.g. a GCN's
    normalized adjacency) without mutating the caller's matrix."""
    data = a.data if values is None else np.asarray(values, np.float32)
    if data.shape != a.data.shape:
        raise ValueError(f"values {data.shape} for {a.data.shape} entries")
    return SparseCSR(a.m, a.k, a.indptr, a.indices, data)
