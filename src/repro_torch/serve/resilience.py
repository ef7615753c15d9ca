"""Resilience layer for the sparse-operator engine.

Libra's hybrid design hands the serving tier a rare gift: every request
already has a *ladder* of bit-equivalent execution strategies —

========  ==========================================================
rung      what runs
========  ==========================================================
``fast``      the packed/stacked bucket apply (one prepared apply, many
              requests — the hot path)
``single``    the same operator, one request per apply (isolates a
              poison request: one bad submission fails alone)
``unsegmented``  the per-request apply with the §4.3 segment launch
              tables stripped (the compact tables on the kernel path —
              same kernels and combine, simpler launch)
``torch``     the plain PyTorch apply (no kernels — the last resort
              that only dies if torch itself does; the reference
              package's ``xla`` rung). CPU registries only: on the card
              the ladder ends at ``unsegmented``, and a request whose
              kernel rungs all fail is returned as ``ExecutionFailed``
========  ==========================================================

All rungs compute the same values (the segment/packing/stacking
transforms are verified inert by the serving and §4.3 test suites), so
degradation trades throughput for survival, never correctness.

This module owns the *policy* side: typed per-request failure results
(:class:`ServeError` and friends — returned from ``flush``, never
raised, so one request's failure can't poison its neighbours' results),
the retry/backoff/validation knobs (:class:`ResiliencePolicy`), and
per-``(graph, op)`` :class:`CircuitBreaker`\\ s that stop hammering a
failing fast path and probe it back open. The engine consumes these in
``repro_torch.serve.engine``; faults to exercise them come from
``repro_torch.serve.faults``.
"""
from __future__ import annotations

import dataclasses

# The ladder, fastest first. ``fast`` is chunk-granular; the rest are
# per-request. Plans without segment tables skip ``unsegmented``, and
# registries on the card stop above ``torch``.
LADDER = ("fast", "single", "unsegmented", "torch")


class ServeError(RuntimeError):
    """Typed per-request failure, *returned* as a flush result.

    ``flush()`` maps every admitted rid to either its result array or a
    ``ServeError`` — a failed request surfaces as data, not as an
    exception that would discard the rest of the batch. ``reason`` is a
    short machine-readable class (``deadline_exceeded``, ``compile``,
    ``resource``, ``injected``, ``nonfinite``, ``runtime``).
    """

    def __init__(self, reason: str, *, rid: int | None = None,
                 graph: str = "", op: str = "", detail: str = ""):
        super().__init__(
            f"{reason}: rid={rid} {graph}/{op}"
            + (f" ({detail})" if detail else ""))
        self.reason = reason
        self.rid = rid
        self.graph = graph
        self.op = op
        self.detail = detail


class DeadlineExceeded(ServeError):
    """The request was already past its deadline when its bucket came up
    for execution — dropped before it could waste a packed apply."""

    def __init__(self, *, rid=None, graph="", op="", detail=""):
        super().__init__("deadline_exceeded", rid=rid, graph=graph, op=op,
                         detail=detail)


class ExecutionFailed(ServeError):
    """Every rung of the degradation ladder failed for this request;
    ``reason`` carries the last failure's classification."""


class NonFiniteOutput(RuntimeError):
    """Raised (engine-internal) when ``validate=True`` finds NaN/Inf in
    an apply's output — treated exactly like an apply crash:
    the bucket degrades and the breaker records a failure."""

    def __init__(self, site: tuple):
        super().__init__(f"non-finite output from {site}")
        self.site = site


@dataclasses.dataclass
class ResiliencePolicy:
    """Engine resilience knobs (all host-side, all deterministic).

    * ``attempts_per_rung`` — tries per ladder rung before falling to
      the next one; ≥2 lets a transient k-th-call fault heal in place.
    * ``backoff_base_s``/``backoff_cap_s`` — capped exponential backoff
      slept between attempts (``min(cap, base·2^i)``; the engine's
      ``sleep=`` is injectable so tests record instead of waiting).
    * ``breaker_threshold`` — consecutive fast-path failures per
      ``(graph, op)`` before its breaker opens.
    * ``probe_after`` — bucket executions served degraded while open
      before a half-open probe re-tries the fast path.
    * ``validate`` — opt-in non-finite output screening (costs a host
      readback per apply; off on the hot path by default).
    * ``min_deadline_ms`` — admission floor: a request whose
      ``deadline_ms`` is below this (or ≤0) is rejected as
      ``infeasible_deadline`` instead of being admitted to die.
    """

    attempts_per_rung: int = 2
    backoff_base_s: float = 0.001
    backoff_cap_s: float = 0.05
    breaker_threshold: int = 3
    probe_after: int = 4
    validate: bool = False
    min_deadline_ms: float = 0.0


class CircuitBreaker:
    """closed → (N consecutive fast failures) → open → (``probe_after``
    degraded buckets) → half_open probe → closed on success, re-open on
    failure. Call-count based, so transitions are deterministic."""

    def __init__(self, threshold: int = 3, probe_after: int = 4):
        self.threshold = threshold
        self.probe_after = probe_after
        self.state = "closed"
        self.failures = 0            # consecutive fast-path failures
        self._open_ticks = 0
        self.opened = 0              # lifetime transition counters
        self.reopened = 0
        self.probes = 0
        self.recoveries = 0

    def allow_fast(self) -> bool:
        """Gate one bucket execution: may the fast path run? While open,
        ticks the probe countdown; reaching it arms a half-open probe
        (this very call runs fast)."""
        if self.state == "closed":
            return True
        if self.state == "open":
            self._open_ticks += 1
            if self._open_ticks >= self.probe_after:
                self.state = "half_open"
                self.probes += 1
                return True
            return False
        # half_open: a previous gate armed the probe but its bucket
        # never reported (e.g. every request was deadline-dropped) —
        # keep probing.
        self.probes += 1
        return True

    def on_fast_success(self) -> None:
        if self.state == "half_open":
            self.recoveries += 1
        self.state = "closed"
        self.failures = 0
        self._open_ticks = 0

    def on_fast_failure(self) -> None:
        if self.state == "half_open":
            self.state = "open"       # probe failed: back to cooldown
            self._open_ticks = 0
            self.reopened += 1
            return
        self.failures += 1
        if self.state == "closed" and self.failures >= self.threshold:
            self.state = "open"
            self._open_ticks = 0
            self.opened += 1

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "consecutive_failures": self.failures,
            "opened": self.opened,
            "reopened": self.reopened,
            "probes": self.probes,
            "recoveries": self.recoveries,
        }


def backoff_delay(policy: ResiliencePolicy, attempt: int) -> float:
    """Capped exponential backoff before retry ``attempt`` (0-based)."""
    return min(policy.backoff_cap_s,
               policy.backoff_base_s * (2.0 ** attempt))
