"""repro_torch.obs — zero-dependency observability: spans and metrics.

The two pure-Python pieces of the reference package's ``repro.obs``:

* :mod:`repro_torch.obs.trace` — nestable spans with an injectable
  clock, Chrome-trace/Perfetto + dict-tree exporters, and a disabled
  process default so instrumented paths cost one attribute check. The
  tuner (``tune.model``, ``tune.search``) opens spans through it.
* :mod:`repro_torch.obs.metrics` — counter/gauge/histogram registry
  with labeled series, Prometheus text exposition and JSON snapshot;
  :class:`~repro_torch.tune.cache.PlanCache` reports into it.
"""
from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullMetricsRegistry,
    default_registry,
)
from repro_torch.obs.trace import (
    NULL_SPAN,
    Span,
    Tracer,
    get_tracer,
    set_tracer,
    use_tracer,
)

__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_SPAN",
    "NullMetricsRegistry",
    "Span",
    "Tracer",
    "default_registry",
    "get_tracer",
    "set_tracer",
    "use_tracer",
]
