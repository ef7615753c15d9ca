"""Process-local span tracer: nestable spans, typed attributes, export.

A copy of the reference package's ``repro.obs.trace`` (pure Python), so
both packages export the same trees for the same calls. Every
instrumented host path (the analytical tuner, the empirical search's
candidates) opens a span, and the resulting tree answers "where did
this construction's milliseconds go".

Design constraints, in order:

* **disabled is (near) free** — the default process tracer is a
  disabled :class:`Tracer`; ``span()`` on it returns one shared no-op
  context manager and ``event()`` returns immediately, so instrumented
  code pays one attribute check.
* **tracing never perturbs results** — spans only read the clock and
  append to host-side lists; no tensor is touched.
* **injectable time** — ``Tracer(clock=...)`` takes any monotonic
  ``() -> float``, so tests drive deterministic timestamps.

Spans nest lexically through a stack (single-threaded by design — the
whole stack is host-driven from one thread); exporters emit the
Chrome-trace/Perfetto JSON event form (``chrome://tracing``, ui.perfetto.dev)
and a plain-dict tree.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable


class Span:
    """One timed region. Use as a context manager (``with tr.span(...)``)
    or manually via :meth:`open`/:meth:`close`. Attributes are typed
    key/values frozen into the export; :meth:`set` adds attributes after
    opening (e.g. a request id assigned mid-span), :meth:`event` attaches
    a zero-duration point annotation."""

    __slots__ = ("name", "attrs", "t0", "t1", "events", "children",
                 "_tracer")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0: float | None = None
        self.t1: float | None = None
        self.events: list[dict] = []
        self.children: list[Span] = []

    # -- lifecycle --
    def open(self) -> "Span":
        tr = self._tracer
        self.t0 = tr._clock()
        stack = tr._stack
        (stack[-1].children if stack else tr.roots).append(self)
        stack.append(self)
        return self

    def close(self) -> None:
        tr = self._tracer
        self.t1 = tr._clock()
        # Tolerate out-of-order closes (an exception skipped a close):
        # pop back to — and including — this span.
        while tr._stack:
            if tr._stack.pop() is self:
                break

    def __enter__(self) -> "Span":
        return self.open()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- annotation --
    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs) -> "Span":
        self.events.append({"name": name, "t": self._tracer._clock(),
                            "attrs": attrs})
        return self

    @property
    def duration(self) -> float:
        if self.t0 is None:
            return 0.0
        end = self._tracer._clock() if self.t1 is None else self.t1
        return end - self.t0


class _NullSpan:
    """The shared do-nothing span a disabled tracer hands out."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def open(self):
        return self

    def close(self):
        return None

    def set(self, **attrs):
        return self

    def event(self, name, **attrs):
        return self

    @property
    def duration(self) -> float:
        return 0.0


NULL_SPAN = _NullSpan()


class Tracer:
    """Process-local span collector.

    ``enabled=False`` makes every call a near-no-op (shared
    :data:`NULL_SPAN`, nothing recorded). ``clock`` is any monotonic
    ``() -> float``; timestamps in exports are relative to the first
    span opened (µs in Chrome-trace form, seconds in the dict tree).
    """

    def __init__(self, *, enabled: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self.enabled = enabled
        self._clock = clock
        self.roots: list[Span] = []
        self._stack: list[Span] = []

    # -- recording --
    def span(self, name: str, **attrs):
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        """Point annotation on the innermost open span (dropped when no
        span is open — events belong to a region)."""
        if not self.enabled or not self._stack:
            return
        self._stack[-1].event(name, **attrs)

    @property
    def current(self) -> Span | None:
        return self._stack[-1] if self._stack else None

    def clear(self) -> None:
        self.roots = []
        self._stack = []

    # -- export --
    def _epoch(self) -> float:
        return self.roots[0].t0 if self.roots else 0.0

    def to_dict(self) -> list[dict]:
        """Plain-dict span tree (seconds relative to the first span)."""
        t0 = self._epoch()

        def conv(sp: Span) -> dict:
            end = sp.t1 if sp.t1 is not None else sp.t0
            return {
                "name": sp.name,
                "start_s": round(sp.t0 - t0, 9),
                "dur_s": round(end - sp.t0, 9),
                "attrs": dict(sp.attrs),
                "events": [{"name": e["name"],
                            "t_s": round(e["t"] - t0, 9),
                            "attrs": dict(e["attrs"])}
                           for e in sp.events],
                "children": [conv(c) for c in sp.children],
            }

        return [conv(sp) for sp in self.roots]

    def to_chrome_trace(self, *, pid: int = 1, tid: int = 1) -> dict:
        """Chrome-trace / Perfetto JSON: ``{"traceEvents": [...]}`` of
        complete (``ph="X"``) span events and instant (``ph="i"``)
        annotations, timestamps in µs relative to the first span.

        Spans/events carrying the reserved ``flow_id`` attribute (or
        ``flow_ids``, a list — e.g. one execute span serving many
        request ids) are additionally linked with Chrome-trace *flow
        events* (``ph`` ``s``/``t``/``f`` sharing a ``cat``+``id``):
        Perfetto draws an arrow through every point of the same flow, so
        a request's ``serve.admit`` → ``serve.execute`` →
        ``serve.complete`` lifecycle reads as one connected track. The
        reserved keys are stripped from the exported ``args``."""
        t0 = self._epoch()
        out: list[dict] = []
        flows: dict[Any, list[float]] = {}

        def note_flow(attrs: dict, ts: float) -> None:
            ids = attrs.get("flow_ids", ())
            if "flow_id" in attrs:
                ids = list(ids) + [attrs["flow_id"]]
            for fid in ids:
                flows.setdefault(fid, []).append(ts)

        def args_of(attrs: dict) -> dict:
            return {k: _jsonable(v) for k, v in attrs.items()
                    if k not in ("flow_id", "flow_ids")}

        def emit(sp: Span) -> None:
            end = sp.t1 if sp.t1 is not None else sp.t0
            ts = round((sp.t0 - t0) * 1e6, 3)
            note_flow(sp.attrs, ts)
            out.append({
                "name": sp.name, "ph": "X", "cat": "repro",
                "ts": ts,
                "dur": round((end - sp.t0) * 1e6, 3),
                "pid": pid, "tid": tid,
                "args": args_of(sp.attrs),
            })
            for e in sp.events:
                ets = round((e["t"] - t0) * 1e6, 3)
                note_flow(e["attrs"], ets)
                out.append({
                    "name": e["name"], "ph": "i", "cat": "repro",
                    "ts": ets,
                    "pid": pid, "tid": tid, "s": "t",
                    "args": args_of(e["attrs"]),
                })
            for c in sp.children:
                emit(c)

        for sp in self.roots:
            emit(sp)
        for seq, fid in enumerate(sorted(flows, key=str)):
            points = sorted(flows[fid])
            if len(points) < 2:
                continue        # a flow needs something to connect
            last = len(points) - 1
            for i, ts in enumerate(points):
                ev = {
                    "name": str(fid), "cat": "repro.flow", "id": seq,
                    "ph": "s" if i == 0 else ("f" if i == last else "t"),
                    "ts": ts, "pid": pid, "tid": tid,
                }
                if i == last:
                    ev["bp"] = "e"     # bind the finish to the enclosing slice
                out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}


def _jsonable(v: Any):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# ------------------------------------------------- process default ---
# The process tracer everything consults by default: disabled, so the
# uninstrumented path costs one attribute check. ``set_tracer`` (or the
# ``use_tracer`` scope) turns the whole stack's spans on at once;
# components that take an explicit ``tracer=`` (e.g. SparseEngine)
# bypass the global.
_ACTIVE: Tracer = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _ACTIVE


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process tracer; returns the previous
    one (so callers can restore it)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tracer
    return prev


@contextlib.contextmanager
def use_tracer(tracer: Tracer):
    """Scope-limited :func:`set_tracer`."""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)
