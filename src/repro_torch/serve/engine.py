"""Panel-bucketed sparse-operator request engine.

The serving counterpart of the training stack: requests against graphs
resident in a :class:`~repro_torch.serve.registry.GraphRegistry` are
admitted host-side, bucketed by (graph, op, feature-width bucket),
packed into panel stacks, and executed one prepared apply per bucket:

* **SpMM** — a bucket's ``(k, n_i)`` panels are width-padded to the
  bucket width and **column-packed** side by side into one ``(k, p·w)``
  panel served by a single hybrid apply (columns of an SpMM are
  independent, so packing is exact). How many panels pack into one
  apply is priced per plan by
  :meth:`~repro_torch.serve.registry.GraphRegistry.pack_limit`.
  Per-request canonical ``edge_vals`` (attention serving) can't
  column-pack — values change the plan — so they ride a
  :class:`~repro_torch.dist.sparse.BatchedSpMM` stack instead.
* **SDDMM** — the feature axis is the reduction axis (nothing packs), so
  ``(x, y)`` pairs stack on a leading batch axis through one
  :class:`~repro_torch.dist.sparse.BatchedSDDMM` call.
* **sharded graphs** — SpMM panels column-pack the same way into one
  :class:`~repro_torch.dist.sparse.ShardedSpMM` apply (the pack limit is
  priced on one shard's stream, so sharded graphs pack deeper);
  sharded SDDMM and per-request-valued sharded SpMM run per request.

On ``backend="cuda"`` every apply runs K1–K4; a stack runs them panel
by panel.

Numerical contract: every bucket **computes at its bucket width**.
Requests whose width already equals a bucket width get results bit for
bit equal to direct single-operator calls (column packing, stacking and
batch padding are inert — see ``tests/test_torch_serve.py``); narrower
requests are zero-padded up to the bucket width, which quantizes the
compute width exactly the way a direct call on the padded panel would.

Admission control is host-side and explicit: unknown graphs, missing
operators, over-wide panels, shape mismatches, queue overflow, and
infeasible deadlines are rejected at ``submit`` with a typed
:class:`AdmissionError`, never discovered at execution time.

Resilience (see :mod:`repro_torch.serve.resilience`): ``flush`` maps
every admitted rid to its result **or** a typed
:class:`~repro_torch.serve.resilience.ServeError` — one failing bucket
never discards the results of buckets that already executed. With a
:class:`~repro_torch.serve.resilience.ResiliencePolicy` (the default),
an apply failure walks the degradation ladder
``fast → single → unsegmented → torch`` with capped-backoff retries (the
``single`` rung re-executes the chunk per request, so one poison
submission fails alone; ``unsegmented`` runs the kernels over the
compact tables; ``torch`` is the plain path, the reference package's
``xla`` rung, offered by CPU registries only: on the card the ladder
ends at ``unsegmented``, so a request whose kernel rungs are spent comes
back as a typed ``ExecutionFailed`` and is never answered by the plain
path), per-(graph, op) circuit breakers stop hammering a
failing fast path and half-open probe it back, and requests already
past their ``deadline_ms`` are dropped with a typed
:class:`~repro_torch.serve.resilience.DeadlineExceeded` instead of
poisoning their packed chunk. ``flush_at_depth``/``flush_slack_ms``
auto-flush the queue host-side when it gets deep or a deadline gets
close. ``stats()`` surfaces throughput, padding waste, bucket occupancy,
and apply/plan-cache hit counters; ``health()`` surfaces breaker states,
per-reason reject counters, deadline-miss rate, and the
retry/degradation histograms. A seeded
:class:`~repro_torch.serve.faults.FaultPlan` (``faults=``) makes any of
it reproducibly fail on demand.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

import torch

from repro_torch.core.threshold import synchronize
from repro_torch.kernels import ref
from repro_torch.kernels.ops import (
    classify_apply_error,
    sddmm_apply,
    spmm_apply,
)
from repro_torch.obs.ledger import dtype_name, record_apply
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import get_tracer
from repro_torch.serve.registry import GraphRegistry
from repro_torch.serve.resilience import (
    CircuitBreaker,
    DeadlineExceeded,
    ExecutionFailed,
    NonFiniteOutput,
    ResiliencePolicy,
    ServeError,
    backoff_delay,
)


class AdmissionError(RuntimeError):
    """A request the engine refuses to queue; ``reason`` is one of
    ``queue_full | unknown_graph | op_unavailable | width_too_large |
    bad_shape | infeasible_deadline``."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


@dataclasses.dataclass
class SparseRequest:
    """One admitted request (internal queue record)."""

    rid: int
    graph: str                  # tenant name, resolved at admission
    op: str                     # "spmm" | "sddmm"
    width: int                  # caller's feature width (pre-padding)
    bucket_width: int
    payload: tuple              # (b,) for spmm; (x, y) for sddmm
    edge_vals: torch.Tensor | None = None
    deadline_ms: float | None = None
    deadline_at: float | None = None     # engine-clock absolute deadline


def _pad_width(arr: torch.Tensor, w: int) -> torch.Tensor:
    """``arr`` zero-padded on the right to ``w`` columns, contiguous (the
    kernels take contiguous operands)."""
    pad = w - arr.shape[1]
    if pad == 0:
        return arr.contiguous()
    return torch.nn.functional.pad(arr, (0, pad))


class SparseEngine:
    """Admit → bucket → pack → execute → unpad/scatter, resiliently."""

    #: Breaker state → numeric gauge value (Prometheus-friendly).
    _BREAKER_LEVEL = {"closed": 0, "half_open": 1, "open": 2}

    def __init__(self, registry: GraphRegistry, *, max_queue: int = 256,
                 max_panel: int | None = None,
                 resilience: ResiliencePolicy | bool = True,
                 faults=None, flush_at_depth: int | None = None,
                 flush_slack_ms: float | None = None,
                 clock=time.monotonic, sleep=time.sleep,
                 metrics: MetricsRegistry | None = None, tracer=None,
                 ledger=None, sample_every: int | None = None):
        self.registry = registry
        self.max_queue = max_queue
        self.max_panel = (max(registry.panel_buckets)
                          if max_panel is None else max_panel)
        # resilience=True (default) → default policy; False/None → the
        # bare fast-path engine (failures still surface as typed
        # per-request results, but no ladder, breakers, or validation).
        self.policy: ResiliencePolicy | None = (
            ResiliencePolicy() if resilience is True
            else (resilience or None))
        self.faults = faults
        self.flush_at_depth = flush_at_depth
        self.flush_slack_ms = flush_slack_ms
        self._clock = clock
        self._sleep = sleep
        self._queue: list[SparseRequest] = []
        self._redeposited: dict[int, torch.Tensor | ServeError] = {}
        self._next_rid = 0
        self._next_deadline: float | None = None
        self._breakers: dict[tuple, CircuitBreaker] = {}
        # Opt-in perf-ledger sampling: every ``sample_every``-th packed
        # SpMM apply (plain batched path only) is timed to completion
        # and recorded into ``ledger`` (a repro_torch.obs.ledger
        # .PerfLedger).
        # Off by default — the fast path pays one attribute check.
        self._ledger = ledger
        self._sample_every = (int(sample_every) if sample_every else 0)
        self._apply_seq = 0
        # Every lifecycle counter lives on the metrics registry;
        # stats()/health() stay thin dict views over the instruments.
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self._tracer = tracer
        m = self.metrics
        self._stats = {
            k: m.counter(f"serve_{k}_total", help)
            for k, help in (
                ("submitted", "Requests admitted"),
                ("served", "Requests answered by flush"),
                ("flushes", "Explicit flush calls"),
                ("panels_executed", "Apply invocations"),
                ("panel_slots", "Panel slots dispatched (incl. padding)"),
                ("real_panels", "Panel slots carrying a real request"),
                ("real_cells", "Output cells requested"),
                ("computed_cells", "Output cells computed (incl. padding)"),
                ("exec_cache_hits", "Prepared-apply cache hits"),
                ("exec_cache_misses", "Prepared-apply cache misses"),
                ("serve_time_s", "Wall seconds spent inside flush"),
            )}
        self._rejected = m.counter(
            "serve_rejected_total", "Requests rejected at admission",
            labels=("reason",))
        self._applies = m.counter(
            "serve_applies_total", "Apply invocations by strategy",
            labels=("strategy",))
        self._health = {
            "deadline_submitted": m.counter(
                "serve_deadline_submitted_total",
                "Requests admitted with a deadline"),
            "deadline_misses": m.counter(
                "serve_deadline_misses_total",
                "Requests dropped past their deadline"),
            "retries": m.counter(
                "serve_retries_total", "Degraded-ladder retry attempts"),
            "retry_hist": m.counter(
                "serve_retry_attempts_total",
                "Retries by global attempt number",
                labels=("attempts",)),
            "degraded_served": m.counter(
                "serve_degraded_served_total",
                "Requests answered below the fast path, by rung",
                labels=("rung",)),
            "failures": m.counter(
                "serve_failures_total",
                "Apply failures by classification", labels=("kind",)),
            "breaker_skips": m.counter(
                "serve_breaker_skips_total",
                "Fast-path skips while a breaker was open"),
            "errors_returned": m.counter(
                "serve_errors_returned_total",
                "Typed ServeError results returned"),
            "autoflushes": m.counter(
                "serve_autoflushes_total",
                "Host-side auto-flush triggers", labels=("kind",)),
        }
        self._deadline_slack = m.histogram(
            "serve_deadline_slack_seconds",
            "Deadline slack (deadline − now) at execution time")
        self._flush_hist = m.histogram(
            "serve_flush_seconds", "Wall seconds per flush call")
        self._breaker_gauge = m.gauge(
            "serve_breaker_state",
            "Circuit-breaker state (0 closed, 1 half-open, 2 open)",
            labels=("graph", "op"))

    @property
    def tracer(self):
        """The explicit ``tracer=`` when given, else the process
        tracer (:func:`repro_torch.obs.trace.get_tracer`)."""
        return self._tracer if self._tracer is not None else get_tracer()

    # -------------------------------------------------------- admission ---
    def _reject(self, reason: str, detail: str = "") -> None:
        self._rejected.inc(reason=reason)
        raise AdmissionError(reason, detail)

    def register(self, a, **kwargs) -> str:
        """Register through the engine so byte-budget rejections are
        engine-typed: a registration whose serving-view plan bytes
        cannot fit the registry's ``max_bytes`` raises
        :class:`~repro_torch.obs.memstat.MemoryPressure` and is counted
        under ``serve_rejected_total{reason="memory_pressure"}``."""
        from repro_torch.obs.memstat import MemoryPressure

        try:
            return self.registry.register(a, **kwargs)
        except MemoryPressure:
            self._rejected.inc(reason="memory_pressure")
            raise

    def memory_report(self, top_k: int = 8) -> dict:
        """Delegates to
        :meth:`~repro_torch.serve.registry.GraphRegistry.memory_report`."""
        return self.registry.memory_report(top_k=top_k)

    def submit(self, graph: str, op: str, *, b=None, x=None, y=None,
               edge_vals=None, deadline_ms: float | None = None) -> int:
        """Admit one request; returns its rid (claim the result from the
        dict :meth:`flush` returns) or raises :class:`AdmissionError`.

        ``deadline_ms`` is a relative deadline on the engine clock: an
        infeasible one (≤0, or below the policy's ``min_deadline_ms``)
        is rejected here; a feasible one that still expires before its
        bucket executes yields a typed
        :class:`~repro_torch.serve.resilience.DeadlineExceeded` result.
        """
        tr = self.tracer
        if not tr.active:
            return self._submit(graph, op, b=b, x=x, y=y,
                                edge_vals=edge_vals,
                                deadline_ms=deadline_ms)
        with tr.span("serve.admit", graph=graph, op=op) as sp:
            rid = self._submit(graph, op, b=b, x=x, y=y,
                               edge_vals=edge_vals,
                               deadline_ms=deadline_ms)
            # flow_id links this request's admit → execute → complete
            # spans into one Perfetto flow (see to_chrome_trace).
            sp.set(rid=rid, flow_id=f"rid{rid}")
            return rid

    def _submit(self, graph: str, op: str, *, b=None, x=None, y=None,
                edge_vals=None, deadline_ms: float | None = None) -> int:
        if len(self._queue) >= self.max_queue:
            self._reject("queue_full", f"max_queue={self.max_queue}")
        try:
            entry = self.registry.resolve(graph)
        except KeyError:
            self._reject("unknown_graph", graph)
        if op not in entry.ops:
            self._reject("op_unavailable", f"{graph} has no {op!r}")
        if op == "spmm":
            if (getattr(b, "ndim", None) != 2
                    or b.shape[0] != entry.k):
                self._reject("bad_shape",
                             f"spmm needs a 2-d array b with shape "
                             f"({entry.k}, n)")
            if edge_vals is not None and \
                    getattr(edge_vals, "shape", None) != (entry.nnz,):
                self._reject("bad_shape",
                             f"edge_vals must have shape ({entry.nnz},)")
            width, payload = b.shape[1], (self._tensor(b),)
        elif op == "sddmm":
            # Exact row counts: a bucket stacks its requests, so ragged
            # row padding (which LibraSDDMM itself would tolerate) is
            # rejected rather than silently mis-bucketed.
            if (getattr(x, "ndim", None) != 2
                    or getattr(y, "ndim", None) != 2
                    or x.shape[0] != entry.m or y.shape[0] != entry.k
                    or x.shape[1] != y.shape[1]):
                self._reject("bad_shape",
                             f"sddmm needs 2-d arrays x ({entry.m}, kf), "
                             f"y ({entry.k}, kf)")
            if edge_vals is not None:
                self._reject("bad_shape", "sddmm takes no edge_vals")
            width, payload = x.shape[1], (self._tensor(x), self._tensor(y))
        else:
            self._reject("op_unavailable", f"unknown op {op!r}")
        wb = self.registry.width_bucket(width)
        if wb is None:
            self._reject("width_too_large",
                         f"{width} > {self.registry.width_buckets[-1]}")
        if edge_vals is not None:
            edge_vals = self._tensor(edge_vals)
        deadline_at = None
        if deadline_ms is not None:
            floor = self.policy.min_deadline_ms if self.policy else 0.0
            if deadline_ms <= 0 or deadline_ms < floor:
                self._reject("infeasible_deadline",
                             f"deadline_ms={deadline_ms} (floor "
                             f"{max(floor, 0.0)}ms)")
            deadline_at = self._clock() + deadline_ms / 1e3
            self._health["deadline_submitted"].inc()
            if (self._next_deadline is None
                    or deadline_at < self._next_deadline):
                self._next_deadline = deadline_at
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(SparseRequest(rid, graph, op, width, wb, payload,
                                         edge_vals, deadline_ms,
                                         deadline_at))
        self._stats["submitted"].inc()
        self._maybe_autoflush()
        return rid

    def _tensor(self, arr) -> torch.Tensor:
        """An admitted operand as a tensor on the registry's device."""
        return torch.as_tensor(arr, device=self.registry.device)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def _maybe_autoflush(self) -> None:
        """Host-side auto-flush triggers: queue depth, or the earliest
        queued deadline within ``flush_slack_ms``. Results land in the
        redeposit buffer, so the submitter's next :meth:`flush` returns
        them as usual."""
        kind = None
        if (self.flush_at_depth is not None
                and len(self._queue) >= self.flush_at_depth):
            kind = "depth"
        elif (self.flush_slack_ms is not None
                and self._next_deadline is not None
                and self._next_deadline - self._clock()
                <= self.flush_slack_ms / 1e3):
            kind = "deadline"
        if kind is not None:
            self._health["autoflushes"].inc(kind=kind)
            self.redeposit(self.flush())

    # -------------------------------------------------------- execution ---
    def flush(self) -> dict[int, torch.Tensor | ServeError]:
        """Serve everything queued; returns ``{rid: result}`` — plus any
        results a cooperative intermediary :meth:`redeposit`-ed for
        their original submitter to claim.

        Per-request failures come back as typed
        :class:`~repro_torch.serve.resilience.ServeError` values in the same
        dict: an exception mid-bucket never discards the results of
        buckets (or sub-chunks) that already executed.
        """
        pending, self._queue = self._queue, []
        self._next_deadline = None
        results, self._redeposited = self._redeposited, {}
        if not pending:
            return results
        tr = self.tracer
        with self._flush_hist.time() as timing:
            with tr.span("serve.flush", requests=len(pending)):
                buckets: dict[tuple, list[SparseRequest]] = \
                    defaultdict(list)
                for r in pending:
                    key = (r.graph, r.op, r.bucket_width,
                           dtype_name(r.payload[0].dtype),
                           r.edge_vals is not None)
                    buckets[key].append(r)
                for key in sorted(buckets, key=str):
                    reqs = buckets[key]
                    for i in range(0, len(reqs), self.max_panel):
                        chunk = reqs[i:i + self.max_panel]
                        self._execute(key, chunk, results)
                        if tr.active:
                            for r in chunk:
                                if r.rid in results:
                                    tr.event(
                                        "serve.complete", rid=r.rid,
                                        flow_id=f"rid{r.rid}",
                                        ok=not isinstance(results[r.rid],
                                                          ServeError))
        self._stats["flushes"].inc()
        self._stats["served"].inc(len(pending))
        self._stats["serve_time_s"].inc(timing.elapsed)
        # Serving materializes lazy plan views; re-check the byte
        # budget now that residency may have grown.
        self.registry.enforce_budget()
        return results

    def serve(self, submissions) -> dict[int, torch.Tensor | ServeError]:
        """Convenience: submit a list of ``(graph, op, kwargs)`` tuples,
        then flush. Raises on the first inadmissible request. Results
        of other callers' queued requests are redeposited, not lost."""
        rids = [self.submit(g, op, **kw) for g, op, kw in submissions]
        out = self.flush()
        mine = {rid: out.pop(rid) for rid in rids}
        self.redeposit(out)
        return mine

    def redeposit(self, results: dict) -> None:
        """Hand back results claimed from :meth:`flush` that belong to
        another submitter; the next :meth:`flush` returns them. Lets an
        intermediary (e.g. the GNN service) drive the shared queue
        without swallowing foreign requests' results."""
        self._redeposited.update(results)

    # ----------------------------------------------------- fault/guard ---
    def _breaker(self, graph: str, op: str) -> CircuitBreaker:
        br = self._breakers.get((graph, op))
        if br is None:
            br = self._breakers[(graph, op)] = CircuitBreaker(
                self.policy.breaker_threshold, self.policy.probe_after)
        return br

    def _publish_breaker(self, graph: str, op: str,
                         br: CircuitBreaker) -> None:
        self._breaker_gauge.set(self._BREAKER_LEVEL[br.state],
                                graph=graph, op=op)

    def _validate(self, out, site: tuple) -> None:
        if not bool(torch.isfinite(out).all()):
            raise NonFiniteOutput(site)

    def _fail(self, results: dict, err: ServeError) -> None:
        self._health["errors_returned"].inc()
        results[err.rid] = err

    def _account_exec(self, p: int, c: int) -> None:
        st = self._stats
        st["panels_executed"].inc()
        st["panel_slots"].inc(p)
        st["real_panels"].inc(c)

    def _call(self, fn, cache, *args, _site=None, _sample=None, **kw):
        """One apply invocation: fault-plan tick, cache-hit accounting,
        optional NaN poisoning and non-finite screening.

        ``_sample`` (a ``(wall_s) -> None`` recorder) opts this call
        into the engine's every-Nth perf-ledger sampling: on a taken
        sample the apply is timed from a synchronised card to
        ``torch.cuda.synchronize()`` after it (asynchronous launches
        would time the enqueue, not the kernels)."""
        nan = (self.faults.check(*_site)
               if self.faults is not None and _site is not None else None)
        strategy = _site[2] if _site is not None else "fast"
        self._applies.inc(strategy=strategy)
        take = False
        if _sample is not None and self._sample_every:
            self._apply_seq += 1
            take = self._apply_seq % self._sample_every == 0
        before = len(cache)
        with self.tracer.span("serve.apply", strategy=strategy):
            if take:
                synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                synchronize()
                _sample(time.perf_counter() - t0)
            else:
                out = fn(*args, **kw)
        if len(cache) > before:
            self._stats["exec_cache_misses"].inc()
        else:
            self._stats["exec_cache_hits"].inc()
        if nan == "nan":
            from repro_torch.serve.faults import poison_output

            out = poison_output(out)
        if self.policy is not None and self.policy.validate \
                and _site is not None:
            self._validate(out, _site)
        return out

    def _guarded(self, graph: str, op: str, strategy: str, thunk):
        """A degraded-rung invocation under the same fault/validation
        discipline as :meth:`_call` (no apply-cache accounting — the
        degraded rungs trade dispatch cost for isolation)."""
        nan = (self.faults.check(graph, op, strategy)
               if self.faults is not None else None)
        self._applies.inc(strategy=strategy)
        with self.tracer.span("serve.apply", strategy=strategy):
            out = thunk()
        if nan == "nan":
            from repro_torch.serve.faults import poison_output

            out = poison_output(out)
        if self.policy is not None and self.policy.validate:
            self._validate(out, (graph, op, strategy))
        return out

    # ------------------------------------------------------- fast path ---
    def _pack_spmm(self, entry, apply_one, cache, chunk, w, results,
                   limit, site, sample_op=None) -> None:
        """Column-pack ``chunk`` into ``(k, p·w)`` applies, at most
        ``limit`` panels per apply (sub-chunks and the trailing batch
        pad stay on the panel-bucket grid for apply reuse).

        ``sample_op`` (the underlying :class:`LibraSpMM`, plain batched
        path only) enables the engine's every-Nth ledger sampling for
        these applies — each taken sample records the *packed* width, so
        measured and predicted time price the same apply."""
        reg = self.registry
        st = self._stats
        tr = self.tracer
        for i in range(0, len(chunk), limit):
            sub = chunk[i:i + limit]
            cs = len(sub)
            p = min(reg.panel_bucket(cs), limit)
            with tr.span("serve.pack", panels=p, requests=cs):
                parts = [_pad_width(r.payload[0], w) for r in sub]
                if p > cs:
                    parts.append(parts[0].new_zeros(
                        (entry.k, (p - cs) * w)))
                wide = parts[0] if len(parts) == 1 else torch.cat(
                    parts, dim=1)
            sampler = None
            if sample_op is not None:
                def sampler(wall_s, _pw=int(wide.shape[1]),
                            _dt=dtype_name(wide.dtype)):
                    record_apply(sample_op, "spmm", width=_pw, dtype=_dt,
                                 backend=reg.backend, wall_s=wall_s,
                                 source="engine", ledger=self._ledger)
            out = self._call(apply_one, cache, wide, _site=site,
                             _sample=sampler)
            for j, r in enumerate(sub):
                results[r.rid] = out[:, j * w:j * w + r.width]
            self._account_exec(p, cs)
            st["computed_cells"].inc(p * entry.k * w)

    def _execute(self, key, chunk, results) -> None:
        """Serve one bucket chunk: deadline drops, then the fast packed
        path behind its circuit breaker, then — on failure — the
        per-request degradation ladder. Requests a partially-executed
        fast path already answered keep their results."""
        graph, op, w, _dtype, _has_ev = key
        tr = self.tracer
        if not tr.active:
            self._execute_chunk(key, chunk, results)
            return
        with tr.span("serve.execute", graph=graph, op=op,
                     width=w, requests=len(chunk),
                     flow_ids=[f"rid{r.rid}" for r in chunk]):
            self._execute_chunk(key, chunk, results)

    def _execute_chunk(self, key, chunk, results) -> None:
        graph, op, w, _dtype, _has_ev = key
        entry = self.registry.get(graph)       # LRU touch per execution
        chunk = self._drop_expired(graph, op, chunk, results)
        if not chunk:
            return
        cells = entry.k if op == "spmm" else entry.m + entry.k
        for r in chunk:
            self._stats["real_cells"].inc(cells * r.width)
        br = self._breaker(graph, op) if self.policy is not None else None
        detail, kind = "", "runtime"
        if br is None or br.allow_fast():
            try:
                self._execute_fast(key, entry, chunk, results)
                if br is not None:
                    br.on_fast_success()
                    self._publish_breaker(graph, op, br)
                return
            except Exception as exc:
                kind = classify_apply_error(exc)
                self._health["failures"].inc(kind=kind)
                detail = f"fast path: {exc}"
                if br is not None:
                    br.on_fast_failure()
                    self._publish_breaker(graph, op, br)
        else:
            self._health["breaker_skips"].inc()
            self._publish_breaker(graph, op, br)
            kind, detail = "breaker_open", f"breaker open for {graph}/{op}"
        remaining = [r for r in chunk if r.rid not in results]
        if self.policy is None:
            for r in remaining:
                self._fail(results, ExecutionFailed(
                    kind, rid=r.rid, graph=graph, op=op, detail=detail))
            return
        for r in remaining:
            out = self._serve_degraded(entry, graph, op, w, r)
            if isinstance(out, ServeError):
                self._fail(results, out)
            else:
                results[r.rid] = out
                self._stats["computed_cells"].inc(cells * w)
                self._account_exec(1, 1)

    def _drop_expired(self, graph, op, chunk, results) -> list:
        if all(r.deadline_at is None for r in chunk):
            return chunk
        now = self._clock()
        live = []
        for r in chunk:
            if r.deadline_at is None:
                live.append(r)
                continue
            slack = r.deadline_at - now
            self._deadline_slack.observe(max(slack, 0.0))
            if slack < 0:
                self._health["deadline_misses"].inc()
                self._fail(results, DeadlineExceeded(
                    rid=r.rid, graph=graph, op=op,
                    detail=f"late by {-slack * 1e3:.1f}ms"))
            else:
                live.append(r)
        return live

    def _execute_fast(self, key, entry, chunk, results) -> None:
        graph, op, w, _dtype, has_ev = key
        fn = entry.op(op)
        reg = self.registry
        c = len(chunk)
        st = self._stats
        site = (graph, op, "fast")
        if op == "spmm":
            if entry.sharded and has_ev:
                # Values change the tables per request: no packing.
                for r in chunk:
                    out = self._call(fn, fn._cache,
                                     _pad_width(r.payload[0], w),
                                     edge_vals=r.edge_vals, _site=site)
                    results[r.rid] = out[:, :r.width]
                    self._account_exec(1, 1)
                    st["computed_cells"].inc(entry.k * w)
                return
            if entry.sharded:
                self._pack_spmm(entry, fn, fn._cache, chunk, w, results,
                                reg.pack_limit(entry, w), site)
                return
            if has_ev:
                # Revalued panels ride a stack (plan values differ per
                # panel — column-packing can't express that).
                p = reg.panel_bucket(c)
                stack = torch.stack([_pad_width(r.payload[0], w)
                                     for r in chunk])
                ev = torch.stack([r.edge_vals for r in chunk])
                if p > c:
                    stack = torch.cat(
                        [stack, stack.new_zeros((p - c,) + stack.shape[1:])])
                    ev = torch.cat([ev, ev.new_zeros((p - c, entry.nnz))])
                out = self._call(fn, fn._cache, stack, backend=reg.backend,
                                 edge_vals=ev, _site=site)
                for i, r in enumerate(chunk):
                    results[r.rid] = out[i, :, :r.width]
                self._account_exec(p, c)
                st["computed_cells"].inc(p * entry.k * w)
                return
            # Plain panels: cost-aware column packing through the
            # single hybrid apply (one prepared apply per packed width).
            single = fn.op

            def apply_one(b):
                return single(b, backend=reg.backend)

            # SDDMM stacks and sharded applies are excluded from ledger
            # sampling: their wall time covers p panels / P shards, which
            # would pollute the per-plan measured-vs-predicted ratio the
            # calibrator joins on.
            sample_op = (single if self._ledger is not None
                         and self._sample_every else None)
            self._pack_spmm(entry, apply_one, single._apply_cache, chunk,
                            w, results, reg.pack_limit(entry, w), site,
                            sample_op=sample_op)
            return
        # ---- sddmm ----
        if entry.sharded:
            # kf is the reduction axis — no packing across requests.
            for r in chunk:
                out = self._call(fn, fn._cache,
                                 _pad_width(r.payload[0], w),
                                 _pad_width(r.payload[1], w), _site=site)
                results[r.rid] = out
                self._account_exec(1, 1)
                st["computed_cells"].inc((entry.m + entry.k) * w)
            return
        p = reg.panel_bucket(c)
        xs = torch.stack([_pad_width(r.payload[0], w) for r in chunk])
        ys = torch.stack([_pad_width(r.payload[1], w) for r in chunk])
        if p > c:
            xs = torch.cat([xs, xs.new_zeros((p - c,) + xs.shape[1:])])
            ys = torch.cat([ys, ys.new_zeros((p - c,) + ys.shape[1:])])
        out = self._call(fn, fn._cache, xs, ys, backend=reg.backend,
                         _site=site)
        for i, r in enumerate(chunk):
            results[r.rid] = out[i]
        self._account_exec(p, c)
        st["computed_cells"].inc(p * (entry.m + entry.k) * w)

    # ------------------------------------------------ degradation ladder ---
    def _rungs(self, entry, op: str, w: int, r: SparseRequest) -> list:
        """The per-request rungs below ``fast`` for one request, in
        degradation order: ``single`` (isolate the poison request on
        the same operator), ``unsegmented`` (the kernels over the compact
        tables, the §4.3 launch tables stripped — plans that have them
        only), ``torch`` (the plain PyTorch path; CPU registries only, so
        that a kernel that fails on the card never hands its request to
        the plain path). Every rung gives the fast path's values, in
        original row order for reordered plans (the reference package's
        ``unsegmented``/``xla`` rungs skip that unpermute). A sharded
        entry has ``single`` and, on a CPU registry, ``torch`` (the
        sharded apply on the plain path)."""
        reg = self.registry
        fn = entry.op(op)
        width = r.width
        plain = torch.device(reg.device).type == "cpu"
        if entry.sharded:
            return self._sharded_rungs(fn, op, w, r, plain)
        if op == "spmm":
            bp = _pad_width(r.payload[0], w)
            one = fn.op                     # the underlying LibraSpMM

            def arrays(backend: str, segmented: bool):
                # Lazy per-rung view: only the keys this rung's apply
                # reads materialize (revalue maps instead of baked-in
                # values when the request carries edge_vals).
                arrs = one.arrays.for_backend(
                    backend, segmented=segmented,
                    revalue=r.edge_vals is not None)
                return (arrs if r.edge_vals is None
                        else ref.revalue_spmm_arrays(arrs, r.edge_vals))

            def apply(backend: str, segmented: bool):
                out = spmm_apply(arrays(backend, segmented), bp, m=one.m,
                                 nwin=one.nwin, backend=backend)
                if one._row_unperm is not None:
                    out = out.index_select(0, one._row_unperm)
                return out[:, :width]

            def single():
                if r.edge_vals is None:
                    return one(bp, backend=reg.backend)[:, :width]
                out = fn(bp[None], backend=reg.backend,
                         edge_vals=r.edge_vals[None])
                return out[0, :, :width]

            rungs = [("single", single)]
            if one.arrays.segmented:
                rungs.append(("unsegmented",
                              lambda: apply(reg.backend, False)))
            if plain:
                rungs.append(("torch", lambda: apply("torch", True)))
            return rungs
        # ---- sddmm ----
        xp = _pad_width(r.payload[0], w)
        yp = _pad_width(r.payload[1], w)
        one = fn.op                         # the underlying LibraSDDMM
        if one._row_perm is not None:
            xr = xp.index_select(0, one._row_perm)
        else:
            xr = xp

        def sd_single():
            return one(xp, yp, backend=reg.backend)

        def sd_apply(backend: str, segmented: bool):
            return sddmm_apply(
                one.arrays.for_backend(backend, segmented=segmented),
                xr, yp, nnz=one.nnz, backend=backend)

        rungs = [("single", sd_single)]
        if one.arrays.segmented:
            rungs.append(("unsegmented",
                          lambda: sd_apply(reg.backend, False)))
        if plain:
            rungs.append(("torch", lambda: sd_apply("torch", True)))
        return rungs

    @staticmethod
    def _sharded_rungs(fn, op: str, w: int, r: SparseRequest,
                       plain: bool) -> list:
        """The rungs below ``fast`` for a sharded entry's request."""
        from repro_torch.dist.sparse import sddmm_sharded, spmm_sharded

        if op == "spmm":
            bp = _pad_width(r.payload[0], w)
            rungs = [("single", lambda: fn(
                bp, edge_vals=r.edge_vals)[:, :r.width])]
            if plain:
                rungs.append(("torch", lambda: spmm_sharded(
                    fn.part, bp, mesh=fn.mesh, axis=fn.axis,
                    backend="torch", edge_vals=r.edge_vals,
                    b_layout=fn.b_layout)[:, :r.width]))
            return rungs
        xp = _pad_width(r.payload[0], w)
        yp = _pad_width(r.payload[1], w)
        rungs = [("single", lambda: fn(xp, yp))]
        if plain:
            rungs.append(("torch", lambda: sddmm_sharded(
                fn.part, xp, yp, mesh=fn.mesh, axis=fn.axis,
                backend="torch", y_layout=fn.y_layout)))
        return rungs

    def _serve_degraded(self, entry, graph: str, op: str, w: int,
                        r: SparseRequest):
        """Walk the ladder for one request: ``attempts_per_rung`` tries
        per rung with capped exponential backoff between attempts, then
        fall one rung. Returns the result array, or an
        :class:`~repro_torch.serve.resilience.ExecutionFailed` carrying the
        last failure's classification when the whole ladder is
        exhausted."""
        policy = self.policy
        kind, detail = "runtime", ""
        attempt_no = 0
        for rung, thunk in self._rungs(entry, op, w, r):
            for _ in range(policy.attempts_per_rung):
                if attempt_no > 0:
                    self._sleep(backoff_delay(policy, attempt_no - 1))
                    self._health["retries"].inc()
                    self._health["retry_hist"].inc(attempts=attempt_no)
                attempt_no += 1
                try:
                    out = self._guarded(graph, op, rung, thunk)
                except Exception as exc:
                    kind = classify_apply_error(exc)
                    detail = f"{rung}: {exc}"
                    self._health["failures"].inc(kind=kind)
                    continue
                self._health["degraded_served"].inc(rung=rung)
                return out
        return ExecutionFailed(kind, rid=r.rid, graph=graph, op=op,
                               detail=detail)

    # ------------------------------------------------------------ stats ---
    def stats(self) -> dict:
        """Thin dict view over the metrics registry (same schema as when
        these were plain ints; the instruments are the ground truth)."""
        st = {k: c.value for k, c in self._stats.items()}
        served, t = st["served"], st["serve_time_s"]
        return {
            **st,
            "rejected": self._rejected.series(),
            "queue_depth": len(self._queue),
            "bucket_occupancy": st["real_panels"] / max(st["panel_slots"], 1),
            "padding_waste": 1.0 - st["real_cells"]
            / max(st["computed_cells"], 1),
            "requests_per_s": served / t if t > 0 else float("nan"),
            "registry": self.registry.stats(),
        }

    def health(self) -> dict:
        """Resilience telemetry: breaker states and transition counts,
        per-reason reject counters, deadline-miss rate, retry and
        degradation histograms, and fault-injection accounting. Like
        :meth:`stats`, a thin view over the metrics registry."""
        h = self._health
        submitted = h["deadline_submitted"].value
        misses = h["deadline_misses"].value
        rejected = self._rejected.series()
        return {
            "resilience_enabled": self.policy is not None,
            "breakers": {f"{g}/{o}": br.snapshot()
                         for (g, o), br in sorted(self._breakers.items())},
            "rejected": rejected,
            "deadline": {
                "submitted": submitted,
                "misses": misses,
                "miss_rate": misses / max(submitted, 1),
                "infeasible_rejected":
                    rejected.get("infeasible_deadline", 0),
            },
            "retries": h["retries"].value,
            "retry_hist": h["retry_hist"].series(),
            "degraded_served": h["degraded_served"].series(),
            "failures": h["failures"].series(),
            "breaker_skips": h["breaker_skips"].value,
            "errors_returned": h["errors_returned"].value,
            "autoflushes": h["autoflushes"].series(),
            "faults_injected": (len(self.faults.log)
                                if self.faults is not None else 0),
        }

    def serve_http(self, host: str = "127.0.0.1", port: int = 0):
        """Start (and return) a scrapeable observability endpoint for
        this engine — ``/metrics`` (Prometheus exposition), ``/health``,
        ``/memory``, ``/stats`` — on a daemon thread; see
        :class:`repro_torch.obs.serve_http.ObsHTTPServer`. Port 0 binds
        an ephemeral port (read it back from ``.port``/``.url``)."""
        from repro_torch.obs.serve_http import ObsHTTPServer

        return ObsHTTPServer(self, host=host, port=port).start()
