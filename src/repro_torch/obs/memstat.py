"""Device-memory accounting for the serve tier.

Libra's §4.1 "upload once, reuse across iterations" design makes plan
arrays the dominant resident state of a serving registry.  This module
attributes every uploaded array to *(graph, view, op, dtype)* with
exact ``nbytes`` so the registry can report, budget, and evict by
bytes instead of entry count:

* :class:`MemLedger` — the accountant.  Plans
  (:class:`repro_torch.core.formats.PlanArrays`) call a per-graph *binder*
  on every device upload; the ledger keeps running per-view totals,
  per-graph attributions, and a high-watermark, all mirrored into
  Prometheus-style gauges (``registry_resident_bytes{view=...}``) and
  counters on a shared :class:`repro_torch.obs.metrics.MetricsRegistry`.
* :class:`MemoryPressure` — the typed admission reject raised when a
  registration cannot fit the registry byte budget even after evicting
  every other entry.
* :func:`render_memory` — terminal rendering of
  :meth:`MemLedger.memory_report`.

The ledger is exact by construction: every number it reports is a sum
of the uploaded tensors' ``nbytes`` (``numel × element_size``, the
derived ``tc_len``/``vpu_len`` lengths of the kernel path included),
never an estimate.
"""

from __future__ import annotations

import threading

from repro_torch.core.formats import PLAN_VIEWS

__all__ = ["MemLedger", "MemoryPressure", "render_memory"]


class MemoryPressure(RuntimeError):
    """A registration's plan bytes cannot fit the registry byte budget.

    Raised by :meth:`repro_torch.serve.registry.GraphRegistry.register`
    (and surfaced through
    :meth:`repro_torch.serve.engine.SparseEngine.register`,
    which counts it under ``serve_rejected_total{reason=
    "memory_pressure"}``) when the projected serving-view footprint of
    a new graph exceeds ``max_bytes`` on its own — no amount of
    eviction could admit it.
    """

    reason = "memory_pressure"

    def __init__(self, message: str, *, required: int, budget: int):
        super().__init__(message)
        self.required = required
        self.budget = budget


class MemLedger:
    """Exact per-graph device-byte attribution.

    Attribution key: ``graph`` (registry key / signature) → ``(op,
    array key)`` → ``(view, nbytes, dtype)``.  Re-accounting the same
    ``(op, key)`` for a graph applies a delta, so replayed uploads
    (accountant attached after a tune search already materialized
    arrays) and re-uploads after eviction stay exact.

    All methods are thread-safe; the serve tier accounts uploads from
    request threads while ``/memory`` scrapes concurrently.
    """

    def __init__(self, metrics=None):
        self._lock = threading.Lock()
        # graph -> (op, key) -> (view, nbytes, dtype)
        self._graphs: dict[str, dict[tuple[str, str], tuple[str, int, str]]] = {}
        self._view_bytes = {v: 0 for v in PLAN_VIEWS}
        self._peak = 0
        self._evicted = 0
        self.metrics = metrics
        if metrics is not None:
            self._g_resident = metrics.gauge(
                "registry_resident_bytes",
                "Accounted plan bytes resident on device, by view.",
                labels=("view",))
            for v in PLAN_VIEWS:  # materialize series so /metrics shows 0s
                self._g_resident.set(0, view=v)
            self._g_peak = metrics.gauge(
                "registry_resident_bytes_peak",
                "High-watermark of total accounted resident plan bytes.")
            self._c_uploaded = metrics.counter(
                "registry_bytes_uploaded_total",
                "Total plan bytes uploaded to device, by view.",
                labels=("view",))
            self._c_evicted = metrics.counter(
                "registry_bytes_evicted_total",
                "Total accounted plan bytes released by eviction.")
        else:
            self._g_resident = self._g_peak = None
            self._c_uploaded = self._c_evicted = None

    # ------------------------------------------------------ recording ---
    def binder(self, graph: str, op: str):
        """An accountant callback for one (graph, op) —
        ``PlanArrays.set_accountant``-compatible."""
        def account(view, key, nbytes, dtype):
            self.account(graph, op, view, key, nbytes, dtype)
        return account

    def account(self, graph: str, op: str, view: str, key: str,
                nbytes: int, dtype: str) -> None:
        """Record one uploaded array (idempotent per ``(op, key)``)."""
        nbytes = int(nbytes)
        with self._lock:
            recs = self._graphs.setdefault(graph, {})
            prev = recs.get((op, key))
            delta = nbytes - (prev[1] if prev is not None else 0)
            recs[(op, key)] = (view, nbytes, dtype)
            if delta:
                self._view_bytes[view] += delta
                if self._g_resident is not None:
                    self._g_resident.set(self._view_bytes[view], view=view)
                if delta > 0 and self._c_uploaded is not None:
                    self._c_uploaded.inc(delta, view=view)
            total = sum(self._view_bytes.values())
            if total > self._peak:
                self._peak = total
                if self._g_peak is not None:
                    self._g_peak.set(total)

    def release(self, graph: str) -> int:
        """Drop a graph's attributions (on eviction / invalidation);
        returns the bytes freed."""
        with self._lock:
            recs = self._graphs.pop(graph, None)
            if not recs:
                return 0
            freed = 0
            for view, nbytes, _ in recs.values():
                self._view_bytes[view] -= nbytes
                freed += nbytes
                if self._g_resident is not None:
                    self._g_resident.set(self._view_bytes[view], view=view)
            self._evicted += freed
            if self._c_evicted is not None:
                self._c_evicted.inc(freed)
            return freed

    # -------------------------------------------------------- queries ---
    def resident_bytes(self, view: str | None = None) -> int:
        with self._lock:
            if view is not None:
                return self._view_bytes.get(view, 0)
            return sum(self._view_bytes.values())

    def graph_bytes(self, graph: str) -> int:
        with self._lock:
            recs = self._graphs.get(graph, {})
            return sum(nb for _, nb, _ in recs.values())

    def peak_bytes(self) -> int:
        with self._lock:
            return self._peak

    def memory_report(self, top_k: int = 8) -> dict:
        """Exact resident-byte breakdown: per view, per op, and the
        ``top_k`` heaviest graphs.  Every total is a sum of recorded
        tensor ``nbytes``."""
        with self._lock:
            by_op: dict[str, int] = {}
            graphs = []
            for graph, recs in self._graphs.items():
                g_total = 0
                g_views = {v: 0 for v in PLAN_VIEWS}
                for (op, _key), (view, nbytes, _dt) in recs.items():
                    by_op[op] = by_op.get(op, 0) + nbytes
                    g_views[view] += nbytes
                    g_total += nbytes
                graphs.append({
                    "graph": graph,
                    "bytes": g_total,
                    "by_view": {v: b for v, b in g_views.items() if b},
                })
            graphs.sort(key=lambda g: (-g["bytes"], g["graph"]))
            return {
                "kind": "memory_report",
                "resident_bytes": sum(self._view_bytes.values()),
                "peak_bytes": self._peak,
                "evicted_bytes": self._evicted,
                "by_view": dict(self._view_bytes),
                "by_op": by_op,
                "n_graphs": len(self._graphs),
                "graphs": graphs[:top_k],
            }


def _fmt_bytes(n: int) -> str:
    if n >= 1 << 20:
        return f"{n / (1 << 20):.2f} MiB"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f} KiB"
    return f"{n} B"


def render_memory(report: dict) -> str:
    """Terminal table for :meth:`MemLedger.memory_report`."""
    rows = [("resident", _fmt_bytes(report["resident_bytes"])),
            ("peak", _fmt_bytes(report["peak_bytes"])),
            ("evicted", _fmt_bytes(report["evicted_bytes"])),
            ("graphs", str(report["n_graphs"]))]
    for view, nbytes in sorted(report["by_view"].items()):
        rows.append((f"view/{view}", _fmt_bytes(nbytes)))
    for op, nbytes in sorted(report["by_op"].items()):
        rows.append((f"op/{op}", _fmt_bytes(nbytes)))
    for g in report["graphs"]:
        label = g["graph"]
        if len(label) > 40:
            label = label[:37] + "..."
        rows.append((f"graph/{label}", _fmt_bytes(g["bytes"])))
    width = max(len(k) for k, _ in rows) if rows else 0
    lines = ["memory report", "-" * (width + 14)]
    lines += [f"{k.ljust(width)}  {v}" for k, v in rows]
    return "\n".join(lines)
