"""repro_torch.obs — zero-dependency observability: spans, metrics,
perf ledger, calibration, memory accounting, scrape endpoint.

Seven pieces (see the module docstrings for depth):

* :mod:`repro_torch.obs.trace` — nestable spans with an injectable
  clock, Chrome-trace/Perfetto + dict-tree exporters, and a disabled
  process default so instrumented paths cost one check; that default
  records while ``torch.profiler`` does, each span a profiler range;
  the few spans the benchmark's shares read are also timed on the
  card's stream by CUDA events.
* :mod:`repro_torch.obs.metrics` — counter/gauge/histogram registry
  with labeled series, Prometheus text exposition and JSON snapshot;
  ``SparseEngine``/``GraphRegistry``/``PlanCache`` report into it.
* :mod:`repro_torch.obs.ledger` — persistent JSONL store of measured
  apply samples (wall time joined to the H100 cost model's prediction),
  recorded from operator applies, search candidates, and engine
  sampling.
* :mod:`repro_torch.obs.calibrate` — per-regime model-error reports over
  the ledger, plus the drift detector whose flags stale PlanCache
  entries (the re-tune trigger).
* :mod:`repro_torch.obs.memstat` — exact device-memory accounting: a
  :class:`MemLedger` attributing every uploaded plan tensor to (graph,
  view, op, dtype) by ``nbytes``, backing the registry byte budget and
  the :class:`MemoryPressure` admission reject.
* :mod:`repro_torch.obs.serve_http` — stdlib scrape endpoint
  (``/metrics``, ``/health``, ``/memory``, ``/stats``,
  ``/explain/<graph>``) for a running engine.
* :mod:`repro_torch.obs.explain` — plan/partition explainer: the
  Tensor Core split, segments, padding, Hopper occupancy and a measured
  apply as a dict and a text table.

Exports resolve lazily (PEP 562) so ``import repro_torch.obs`` stays
cheap.
"""
from __future__ import annotations

_LAZY = {
    "Tracer": "repro_torch.obs.trace",
    "Span": "repro_torch.obs.trace",
    "NULL_SPAN": "repro_torch.obs.trace",
    "get_tracer": "repro_torch.obs.trace",
    "set_tracer": "repro_torch.obs.trace",
    "use_tracer": "repro_torch.obs.trace",
    "Counter": "repro_torch.obs.metrics",
    "Gauge": "repro_torch.obs.metrics",
    "Histogram": "repro_torch.obs.metrics",
    "MetricsRegistry": "repro_torch.obs.metrics",
    "NullMetricsRegistry": "repro_torch.obs.metrics",
    "DEFAULT_BUCKETS": "repro_torch.obs.metrics",
    "default_registry": "repro_torch.obs.metrics",
    "PerfLedger": "repro_torch.obs.ledger",
    "get_ledger": "repro_torch.obs.ledger",
    "set_ledger": "repro_torch.obs.ledger",
    "use_ledger": "repro_torch.obs.ledger",
    "ledger_key": "repro_torch.obs.ledger",
    "config_digest": "repro_torch.obs.ledger",
    "record_apply": "repro_torch.obs.ledger",
    "calibration_report": "repro_torch.obs.calibrate",
    "render_calibration": "repro_torch.obs.calibrate",
    "detect_drift": "repro_torch.obs.calibrate",
    "apply_drift": "repro_torch.obs.calibrate",
    "MemLedger": "repro_torch.obs.memstat",
    "MemoryPressure": "repro_torch.obs.memstat",
    "render_memory": "repro_torch.obs.memstat",
    "explain_plan": "repro_torch.obs.explain",
    "explain_spmm": "repro_torch.obs.explain",
    "explain_sddmm": "repro_torch.obs.explain",
    "explain_entry": "repro_torch.obs.explain",
    "explain_partition": "repro_torch.obs.explain",
    "render_table": "repro_torch.obs.explain",
    "ObsHTTPServer": "repro_torch.obs.serve_http",
    "serve_obs_http": "repro_torch.obs.serve_http",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.obs' has no attribute "
                             f"{name!r}")
    import importlib

    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
