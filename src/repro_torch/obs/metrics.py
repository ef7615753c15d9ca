"""Counter/gauge/histogram registry with labeled series.

The always-on half of the observability layer (spans answer "where did
the time go", metrics answer "how often / how much, since process
start"). Zero dependencies; two export forms:

* :meth:`MetricsRegistry.exposition` — Prometheus-style text
  (``# HELP`` / ``# TYPE`` headers, one ``name{label="v"} value`` line
  per series, ``_bucket``/``_sum``/``_count`` for histograms);
* :meth:`MetricsRegistry.snapshot` — a JSON-able dict of the same.

Instruments are get-or-create by name (re-asking for an existing name
with a matching kind returns the same object; a kind clash raises), so
a component can hold handles at construction time while views and
exporters walk the registry. Label values are passed as kwargs on the
write call (``c.inc(reason="unparseable")``) and series materialize on
first write — a labeled instrument with no writes exports nothing,
exactly like Prometheus client libraries.

A copy of the reference package's ``repro.obs.metrics`` (pure Python),
so both packages expose the same text for the same writes. Each
component owns a registry instance (``PlanCache(metrics=...)``) so
tests stay isolated; :func:`default_registry` is the process-wide sink
for module-level instrumentation.
"""
from __future__ import annotations

import math
import time


def _check_labels(declared: tuple, got: dict, name: str) -> tuple:
    if set(got) != set(declared):
        raise ValueError(
            f"metric {name!r} declared labels {declared}, got "
            f"{tuple(sorted(got))}")
    return tuple(got[k] for k in declared)


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() else repr(f)


def _escape(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _series_suffix(labels: tuple, values: tuple, extra: dict | None = None
                   ) -> str:
    pairs = [f'{k}="{_escape(v)}"' for k, v in zip(labels, values)]
    for k, v in (extra or {}).items():
        pairs.append(f'{k}="{_escape(v)}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


class Counter:
    """Monotonically increasing value (or a labeled family of them)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labels: tuple = ()):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._v = 0.0
        self._series: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **label_values) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        if self.labels:
            key = _check_labels(self.labels, label_values, self.name)
            self._series[key] = self._series.get(key, 0.0) + amount
        else:
            self._v += amount

    @property
    def value(self):
        """Unlabeled value, as int when integral (the thin-view-friendly
        form: ``stats()`` dicts keep printing ``3``, not ``3.0``)."""
        return int(self._v) if self._v.is_integer() else self._v

    def series(self) -> dict:
        """Labeled values keyed by the label-value tuple (single-label
        instruments key by the bare value), ints when integral."""
        out = {}
        for key, v in self._series.items():
            k = key[0] if len(key) == 1 else key
            out[k] = int(v) if v.is_integer() else v
        return out

    def get(self, **label_values):
        key = _check_labels(self.labels, label_values, self.name)
        v = self._series.get(key, 0.0)
        return int(v) if v.is_integer() else v

    def _lines(self) -> list[str]:
        if not self.labels:
            return [f"{self.name} {_fmt_value(self._v)}"]
        return [f"{self.name}{_series_suffix(self.labels, k)} "
                f"{_fmt_value(v)}" for k, v in sorted(
                    self._series.items(), key=lambda kv: kv[0])]

    def _snap(self) -> dict:
        if not self.labels:
            return {"value": self.value}
        return {"series": [{"labels": dict(zip(self.labels, k)),
                            "value": int(v) if v.is_integer() else v}
                           for k, v in sorted(self._series.items(),
                                              key=lambda kv: kv[0])]}


class Gauge(Counter):
    """Point-in-time value; :meth:`set` replaces, :meth:`inc` adjusts."""

    kind = "gauge"

    def set(self, value: float, **label_values) -> None:
        if self.labels:
            key = _check_labels(self.labels, label_values, self.name)
            self._series[key] = float(value)
        else:
            self._v = float(value)

    def inc(self, amount: float = 1.0, **label_values) -> None:
        if self.labels:
            key = _check_labels(self.labels, label_values, self.name)
            self._series[key] = self._series.get(key, 0.0) + amount
        else:
            self._v += amount


# Seconds-scale latency buckets (deadline slack, serve time): 1ms–10s.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


class _HistogramTimer:
    """Context manager from :meth:`Histogram.time`: observes elapsed
    wall seconds on exit and keeps them readable as ``.elapsed`` (for
    callers that also feed a counter from the same measurement)."""

    __slots__ = ("_hist", "_label_values", "_t0", "elapsed")

    def __init__(self, hist, label_values: dict):
        self._hist = hist
        self._label_values = label_values
        self.elapsed = 0.0

    def __enter__(self) -> "_HistogramTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.elapsed = time.perf_counter() - self._t0
        self._hist.observe(self.elapsed, **self._label_values)
        return False


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: ``le`` upper
    bounds, implicit ``+Inf``, plus ``_sum``/``_count``)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels: tuple = (),
                 buckets: tuple = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self.buckets = tuple(sorted(buckets))
        # series key -> [per-bucket counts..., +Inf count, sum]
        self._series: dict[tuple, list[float]] = {}

    def _cell(self, key: tuple) -> list[float]:
        cell = self._series.get(key)
        if cell is None:
            cell = self._series[key] = [0.0] * (len(self.buckets) + 2)
        return cell

    def observe(self, value: float, **label_values) -> None:
        key = (_check_labels(self.labels, label_values, self.name)
               if self.labels else ())
        cell = self._cell(key)
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                cell[i] += 1
                break
        else:
            cell[len(self.buckets)] += 1
        cell[-1] += value

    def count(self, **label_values) -> int:
        key = (_check_labels(self.labels, label_values, self.name)
               if self.labels else ())
        cell = self._series.get(key)
        return int(sum(cell[:-1])) if cell else 0

    def sum(self, **label_values) -> float:
        key = (_check_labels(self.labels, label_values, self.name)
               if self.labels else ())
        cell = self._series.get(key)
        return cell[-1] if cell else 0.0

    def time(self, **label_values) -> _HistogramTimer:
        """Timing context manager: ``with h.time(): ...`` observes the
        block's wall seconds on exit (the replacement for hand-rolled
        ``perf_counter`` pairs feeding :meth:`observe`)."""
        if self.labels:
            _check_labels(self.labels, label_values, self.name)
        return _HistogramTimer(self, label_values)

    def _lines(self) -> list[str]:
        out = []
        for key, cell in sorted(self._series.items(),
                                key=lambda kv: kv[0]):
            cum = 0.0
            for i, ub in enumerate(self.buckets):
                cum += cell[i]
                out.append(
                    f"{self.name}_bucket"
                    f"{_series_suffix(self.labels, key, {'le': _fmt_value(ub)})}"
                    f" {_fmt_value(cum)}")
            cum += cell[len(self.buckets)]
            out.append(f"{self.name}_bucket"
                       f"{_series_suffix(self.labels, key, {'le': '+Inf'})}"
                       f" {_fmt_value(cum)}")
            out.append(f"{self.name}_sum{_series_suffix(self.labels, key)}"
                       f" {_fmt_value(cell[-1])}")
            out.append(f"{self.name}_count"
                       f"{_series_suffix(self.labels, key)}"
                       f" {_fmt_value(cum)}")
        return out

    def _snap(self) -> dict:
        series = []
        for key, cell in sorted(self._series.items(),
                                key=lambda kv: kv[0]):
            series.append({
                "labels": dict(zip(self.labels, key)),
                "buckets": {_fmt_value(ub): int(cell[i])
                            for i, ub in enumerate(self.buckets)},
                "inf": int(cell[len(self.buckets)]),
                "sum": cell[-1],
                "count": int(sum(cell[:-1])),
            })
        return {"series": series, "bucket_bounds": list(self.buckets)}


class MetricsRegistry:
    """Named instrument store; get-or-create accessors, two exporters."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get_or_create(self, cls, name, help, labels, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls) or type(m) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            if tuple(labels) != m.labels:
                raise ValueError(
                    f"metric {name!r} already registered with labels "
                    f"{m.labels}")
            return m
        m = self._metrics[name] = cls(name, help, tuple(labels), **kw)
        return m

    def counter(self, name: str, help: str = "",
                labels: tuple = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: tuple = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: tuple = (),
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str):
        return self._metrics[name]

    def exposition(self) -> str:
        """Prometheus text exposition of every instrument."""
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m._lines())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """JSON-able dict: name → {type, help, value|series}."""
        return {name: {"type": m.kind, "help": m.help, **m._snap()}
                for name, m in sorted(self._metrics.items())}


class _NullCounter(Counter):
    """Write-discarding counter: reads keep working (zeros)."""

    def inc(self, amount: float = 1.0, **label_values) -> None:
        pass


class _NullGauge(Gauge):
    def inc(self, amount: float = 1.0, **label_values) -> None:
        pass

    def set(self, value: float, **label_values) -> None:
        pass


class _NullHistogram(Histogram):
    def observe(self, value: float, **label_values) -> None:
        pass

    def time(self, **label_values) -> _HistogramTimer:
        # Still measures (callers read .elapsed) but discards the
        # observation — _NullHistogram.observe above is a no-op.
        return super().time(**label_values)


class NullMetricsRegistry(MetricsRegistry):
    """A registry handing out write-discarding instruments.

    The metrics analogue of a disabled Tracer: components built against
    it keep their instrument handles and thin ``stats()`` views (reads
    return zeros/empty series), but every ``inc``/``set``/``observe``
    is a no-op: a component built against it opts out of accounting.
    """

    def counter(self, name: str, help: str = "",
                labels: tuple = ()) -> Counter:
        return self._get_or_create(_NullCounter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: tuple = ()) -> Gauge:
        return self._get_or_create(_NullGauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: tuple = (),
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(_NullHistogram, name, help, labels,
                                   buckets=buckets)


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry module-level instrumentation reports
    into."""
    return _DEFAULT
