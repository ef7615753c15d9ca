"""Process-local span tracer: nestable spans, typed attributes, export.

The reference package's ``repro.obs.trace``, so both packages export
the same trees for the same host-only calls, with three additions for
the card: a profiler bridge, a device clock and a span stack per
thread. Instrumented paths (the plan build by stage, the
GNN step, the operators' applies, the serving tier) open spans, and the
tree answers "where did this step's or this flush's time go".

Design constraints, in order:

* **disabled is (near) free** — the default process tracer is a
  disabled :class:`Tracer`; with the profiler off, ``span()`` on it
  returns one shared no-op context manager after one check (and one
  flag set, which ends a follow-mode session) and ``event()`` returns
  immediately. Call sites build no attribute that
  costs anything unless :attr:`Tracer.active` says the span records.
* **tracing never perturbs results** — spans only read clocks, record
  CUDA events and append to host-side lists; no tensor is touched and
  nothing synchronises the card.
* **injectable time** — ``Tracer(clock=...)`` takes any monotonic
  ``() -> float``, so tests drive deterministic timestamps.

The card additions:

* **profiler bridge** — while ``torch.profiler`` records, every span a
  tracer records is also a ``record_function`` range of the same name,
  so the spans sit in the profiler's trace on the device's clock, around
  the kernels they launch.
* **follow mode** — the process default tracer (``follow=True``) stays
  disabled, but records the spans opened while the profiler records,
  and only then: a profiled stretch of a program leaves its span tree
  in :func:`get_tracer`. It holds the last profiler session's spans
  alone: a span asked for while the profiler is off marks the session
  over, and the next recorded root drops the old roots. Within a
  session it keeps about the newest :data:`FOLLOW_SPANS` spans, by
  whole roots.
* **device clock** — ``span(name, device=t)``, where ``t`` is a CUDA
  tensor or ``torch.device``, records a timing ``torch.cuda.Event`` on
  the current stream at open and at close; :attr:`Span.device_s` is the
  stream's interval between the two, read once the reader has
  synchronised (None before, and on the CPU). That interval is the
  span's kernels when the host runs ahead of the card, plus the card's
  idle time inside the span when it does not. The events are the
  costly part of a recorded span: recorded behind queued work, each
  takes tens of microseconds of the host. So the program puts the
  device clock only on the few spans a reader divides (a whole step or
  flush, and the SpMM combines), not on every span.

Spans nest through a stack per thread. Autograd runs a card's backward
on a thread of its own while the caller waits inside ``backward()``:
a span opened inside an autograd backward, on a thread with no open
span of its own, nests under the newest open span of another thread.
Any other span opened on an empty stack is a root. Exporters emit the
Chrome-trace/Perfetto JSON event form (``chrome://tracing``,
ui.perfetto.dev) and a plain-dict tree.
"""
from __future__ import annotations

import bisect
import contextlib
import threading
import time
from typing import Any, Callable

import torch
from torch.autograd import profiler as _torch_profiler

#: About the most spans a follow-mode tracer keeps in one profiler
#: session: past it, the oldest roots holding half of them are dropped.
FOLLOW_SPANS = 1 << 17

#: The autograd node running on this thread, or None outside a backward.
_autograd_node = getattr(torch._C, "_current_autograd_node", lambda: None)


def profiler_on() -> bool:
    """Whether ``torch.profiler`` (or ``torch.autograd.profiler``) is
    recording in this process."""
    return _torch_profiler._is_profiler_enabled


def _device_stream(device):
    """The current CUDA stream of ``device`` (a tensor or a
    ``torch.device``), or None off the card."""
    dev = getattr(device, "device", device)
    if getattr(dev, "type", None) != "cuda":
        return None
    return torch.cuda.current_stream(dev)


def _open_range(name: str):
    """A profiler range named ``name``, entered: torch's low-overhead
    ``_RecordFunctionFast`` where it has one (about 1 µs against
    ``record_function``'s 9-13 µs), else ``record_function``."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    rng = fast(name) if fast is not None else \
        _torch_profiler.record_function(name)
    rng.__enter__()
    return rng


class Span:
    """One timed region. Use as a context manager (``with tr.span(...)``)
    or manually via :meth:`open`/:meth:`close`. Attributes are typed
    key/values frozen into the export; :meth:`set` adds attributes after
    opening (e.g. a request id assigned mid-span), :meth:`event` attaches
    a zero-duration point annotation."""

    __slots__ = ("name", "attrs", "t0", "t1", "events", "children",
                 "_tracer", "_device", "_dev", "_range", "_stack", "_seq")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict,
                 device=None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0: float | None = None
        self.t1: float | None = None
        self.events: list[dict] = []
        self.children: list[Span] = []
        self._device = device
        self._dev = None        # (start, end) CUDA events, then seconds
        self._range = None      # the profiler's record_function
        self._stack = None
        self._seq = 0           # the tracer's span count at the open

    # -- lifecycle --
    def open(self) -> "Span":
        tr = self._tracer
        self.t0 = tr._clock()
        tr._count += 1
        self._seq = tr._count
        stack = tr._thread_stack()
        if stack:
            stack[-1].children.append(self)
        else:
            parent = tr._foreign_parent()
            if parent is not None:
                parent.children.append(self)
            else:
                tr._add_root(self)
            tr._stacks[id(stack)] = stack
        stack.append(self)
        self._stack = stack
        if profiler_on():
            self._range = _open_range(self.name)
        if self._device is not None:
            # Keep the stream, not the tensor: a span outlives its step.
            stream = _device_stream(self._device)
            self._device = None
            if stream is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(stream)
                self._dev = (ev, None, stream)
        return self

    def close(self) -> None:
        tr = self._tracer
        self.t1 = tr._clock()
        if isinstance(self._dev, tuple) and self._dev[1] is None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self._dev[2])
            self._dev = (self._dev[0], ev, None)
        self._end_range()
        # Tolerate out-of-order closes (an exception skipped a close):
        # pop back to — and including — this span.
        stack = self._stack if self._stack is not None else []
        while stack:
            sp = stack.pop()
            if sp is self:
                break
            sp._end_range()
        if not stack:
            tr._stacks.pop(id(stack), None)

    def _end_range(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

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

    @property
    def device_s(self) -> float | None:
        """Seconds of the CUDA stream between the span's open and close:
        None without a device clock, and until the card has passed the
        close (the reader synchronises; the span never does)."""
        dev = self._dev
        if dev is None or isinstance(dev, float):
            return dev
        start, end, _ = dev
        if end is None or not end.query():
            return None
        self._dev = start.elapsed_time(end) / 1e3
        return self._dev


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
    :data:`NULL_SPAN`, nothing recorded), except that with ``follow``
    the tracer records while the profiler records (the process default;
    see the module docstring). ``clock`` is any monotonic
    ``() -> float``; timestamps in exports are relative to the first
    span opened (µs in Chrome-trace form, seconds in the dict tree).
    """

    def __init__(self, *, enabled: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 follow: bool = False):
        self.enabled = enabled
        self.follow = follow
        self._clock = clock
        self.roots: list[Span] = []
        self.lapsed = False     # the profiler was off since the last root
        self._count = 0         # spans opened
        self._local = threading.local()
        # The threads' stacks that hold an open span, by the stack's id.
        self._stacks: dict[int, list[Span]] = {}

    @property
    def active(self) -> bool:
        """Whether :meth:`span` records now: call sites build costly
        attributes only then."""
        return self.enabled or (self.follow and profiler_on())

    # -- recording --
    def span(self, name: str, device=None, **attrs):
        """A span named ``name`` with ``attrs``; ``device`` (a tensor or
        ``torch.device``) adds the device clock on a CUDA device."""
        if self.enabled or (self.follow and profiler_on()):
            return Span(self, name, attrs, device)
        self.lapsed = True
        return NULL_SPAN

    def event(self, name: str, **attrs) -> None:
        """Point annotation on the innermost open span (dropped when no
        span is open — events belong to a region)."""
        if not self.active:
            return
        stack = self._thread_stack()
        if stack:
            stack[-1].event(name, **attrs)

    @property
    def current(self) -> Span | None:
        stack = self._thread_stack()
        return stack[-1] if stack else None

    def clear(self) -> None:
        self.roots = []
        self.lapsed = False
        self._local = threading.local()
        self._stacks = {}

    def _thread_stack(self) -> list[Span]:
        try:
            return self._local.stack
        except AttributeError:
            stack = self._local.stack = []
            return stack

    def _foreign_parent(self) -> Span | None:
        """Inside an autograd backward, the newest span open on another
        thread (the caller waiting in ``backward()``); else None."""
        if _autograd_node() is None:
            return None
        tops = [st[-1] for st in list(self._stacks.values()) if st]
        return max(tops, key=lambda sp: sp.t0, default=None)

    def _add_root(self, sp: Span) -> None:
        if not self.enabled:
            # Follow mode: the last session alone, and a bounded one. A
            # dropped span frees its CUDA events with it.
            if self.lapsed:
                self.lapsed = False
                self.roots = []
            elif self.roots and \
                    self._count - self.roots[0]._seq > FOLLOW_SPANS:
                cut = bisect.bisect_left(
                    self.roots, self._count - FOLLOW_SPANS // 2,
                    key=lambda root: root._seq)
                del self.roots[:cut]
        self.roots.append(sp)

    # -- export --
    def _epoch(self) -> float:
        return self.roots[0].t0 if self.roots else 0.0

    def to_dict(self) -> list[dict]:
        """Plain-dict span tree (seconds relative to the first span)."""
        t0 = self._epoch()

        def conv(sp: Span) -> dict:
            end = sp.t1 if sp.t1 is not None else sp.t0
            out = {
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
            dev = sp.device_s
            if dev is not None:
                out["device_dur_s"] = round(dev, 9)
            return out

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
            args = args_of(sp.attrs)
            dev = sp.device_s
            if dev is not None:
                args["device_dur_us"] = round(dev * 1e6, 3)
            out.append({
                "name": sp.name, "ph": "X", "cat": "repro",
                "ts": ts,
                "dur": round((end - sp.t0) * 1e6, 3),
                "pid": pid, "tid": tid,
                "args": args,
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


class StageClock:
    """Self host seconds by stage, each stage also a span of the process
    tracer (``<prefix><name>``) opened at the same boundary.

    A stage's seconds leave out the stages nested inside it, so the
    values sum to the wall time of the outermost stages. Always on: a
    stage costs a few clock reads, for the plan build's stages of
    seconds each."""

    def __init__(self, prefix: str = "plan."):
        self.prefix = prefix
        self.seconds: dict[str, float] = {}
        self._nested: list[float] = []

    @contextlib.contextmanager
    def stage(self, name: str, **attrs):
        with get_tracer().span(self.prefix + name, **attrs):
            self._nested.append(0.0)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                inner = self._nested.pop()
                self.seconds[name] = self.seconds.get(name, 0.0) + dt - inner
                if self._nested:
                    self._nested[-1] += dt


def _jsonable(v: Any):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# ------------------------------------------------- process default ---
# The process tracer everything consults by default: disabled and
# following the profiler, so the uninstrumented path costs one check.
# ``set_tracer`` (or the ``use_tracer`` scope) turns the whole stack's
# spans on at once; components that take an explicit ``tracer=`` (e.g.
# SparseEngine) bypass the global.
_ACTIVE: Tracer = Tracer(enabled=False, follow=True)


def get_tracer() -> Tracer:
    return _ACTIVE


def span(name: str, device=None, **attrs):
    """``get_tracer().span(name, device, **attrs)``, with the check
    inlined: the instrumented hot paths call this."""
    tr = _ACTIVE
    if tr.enabled or (tr.follow and _torch_profiler._is_profiler_enabled):
        return Span(tr, name, attrs, device)
    tr.lapsed = True
    return NULL_SPAN


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
