"""Deterministic fault injection for the serving stack.

Chaos testing a serving tier only works when the chaos is replayable: a
:class:`FaultPlan` is a *schedule* — a list of :class:`FaultRule`\\ s (or
a seeded random draw over call sites) that makes a chosen apply
fail on exactly its k-th invocation. The engine (and the registry's
warmup path) tick the plan once per apply call with the call's
``(graph, op, strategy)`` site; the plan answers with the fault to
inject, if any:

* ``"raise"``     — the call raises :class:`InjectedFault` *instead of*
  executing (a crashed apply, or kernels that did not build);
* ``"resource"``  — the call raises
  :class:`SimulatedResourceExhausted` (out of memory — classified as
  ``resource`` by :func:`repro_torch.kernels.ops.classify_apply_error`);
* ``"nan"``       — the call executes, then its output is poisoned with
  a NaN (silent numerical corruption — only the engine's opt-in
  ``validate=True`` mode catches it).

Strategy names match the engine's execution ladder (``"fast"`` is the
packed/stacked rung, then ``"single"``, ``"unsegmented"``, ``"torch"``;
the registry's warmup ticks as ``"warm"``). ``None`` fields in a
rule are wildcards; ``kth`` indexes the *site's own* call counter
(1-based), so two graphs' fast paths count independently.

Everything the plan fired is recorded in ``plan.log`` for test
assertions ("the poison request failed alone") and for the chaos
benchmark's accounting. :func:`corrupt_cache_entry` rounds the harness
out by tearing a persistent :class:`~repro_torch.tune.cache.PlanCache` file
on disk (the quarantine path's test hook).
"""
from __future__ import annotations

import dataclasses
import os
from collections import defaultdict


class InjectedFault(RuntimeError):
    """An apply failure manufactured by a :class:`FaultPlan`."""

    def __init__(self, site: tuple, count: int, kind: str = "raise"):
        super().__init__(f"injected {kind} fault at {site} call #{count}")
        self.site = site
        self.count = count
        self.kind = kind


class SimulatedResourceExhausted(InjectedFault):
    """Injected stand-in for RESOURCE_EXHAUSTED / OOM on an apply."""

    def __init__(self, site: tuple, count: int):
        super().__init__(site, count, kind="resource")


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """Fire ``kind`` on a site's ``kth``..``kth+times-1`` calls.

    ``graph``/``op``/``strategy`` are exact-match selectors; ``None``
    matches anything. ``times=-1`` keeps the fault latched forever (a
    permanently broken apply); the default ``times=1`` models a
    transient fault a retry survives.
    """

    kth: int
    graph: str | None = None
    op: str | None = None
    strategy: str | None = None
    kind: str = "raise"          # raise | resource | nan
    times: int = 1

    def matches(self, site: tuple, count: int) -> bool:
        graph, op, strategy = site
        if self.graph is not None and self.graph != graph:
            return False
        if self.op is not None and self.op != op:
            return False
        if self.strategy is not None and self.strategy != strategy:
            return False
        if count < self.kth:
            return False
        return self.times < 0 or count < self.kth + self.times


class FaultPlan:
    """A replayable fault schedule, consumed one apply call at a
    time via :meth:`on_call`."""

    def __init__(self, rules=()):
        self.rules: list[FaultRule] = list(rules)
        self._counts: dict[tuple, int] = defaultdict(int)
        self.log: list[tuple] = []   # (site, call#, kind) actually fired

    @classmethod
    def storm(cls, seed: int, sites, *, n_faults: int = 8,
              max_k: int = 6, kinds=("raise",),
              times=(1,)) -> "FaultPlan":
        """Seeded random schedule over ``sites`` (an iterable of
        ``(graph, op, strategy)`` triples) — the property/chaos tests'
        generator. Same seed ⇒ same schedule, always."""
        import numpy as np

        rng = np.random.default_rng(seed)
        sites = list(sites)
        rules = []
        for _ in range(n_faults):
            g, o, s = sites[int(rng.integers(len(sites)))]
            rules.append(FaultRule(
                kth=int(rng.integers(1, max_k + 1)), graph=g, op=o,
                strategy=s, kind=kinds[int(rng.integers(len(kinds)))],
                times=int(times[int(rng.integers(len(times)))])))
        return cls(rules)

    def call_count(self, site: tuple) -> int:
        return self._counts[site]

    def on_call(self, graph: str, op: str, strategy: str) -> str | None:
        """Tick one apply call; returns the fault kind to inject
        (``raise``/``resource``/``nan``) or ``None`` for a clean call.
        First matching rule wins."""
        site = (graph, op, strategy)
        self._counts[site] += 1
        count = self._counts[site]
        for rule in self.rules:
            if rule.matches(site, count):
                self.log.append((site, count, rule.kind))
                return rule.kind
        return None

    def check(self, graph: str, op: str, strategy: str) -> str | None:
        """Tick and *raise* for ``raise``/``resource`` faults; returns
        ``"nan"`` (caller poisons the output) or ``None``."""
        kind = self.on_call(graph, op, strategy)
        site = (graph, op, strategy)
        if kind == "raise":
            raise InjectedFault(site, self._counts[site])
        if kind == "resource":
            raise SimulatedResourceExhausted(site, self._counts[site])
        return kind


def poison_output(out):
    """A clone of a tensor (or of each tensor of a tuple/list) with its
    first element set to NaN — the ``"nan"`` fault's corruption. The
    original is untouched."""
    if isinstance(out, (tuple, list)):
        return type(out)(poison_output(o) for o in out)
    flat = out.clone().reshape(-1)
    flat[0] = float("nan")
    return flat.reshape(out.shape)


def corrupt_cache_entry(cache, key: str | None = None, *,
                        mode: str = "garbage") -> str | None:
    """Tear a persistent :class:`~repro_torch.tune.cache.PlanCache` file.

    ``key=None`` corrupts the lexically-first resident entry. ``mode``:
    ``"garbage"`` truncates the JSON mid-document (a torn write without
    the atomic rename), ``"tamper"`` keeps valid JSON but flips a config
    field so the stored checksum no longer matches. Returns the path
    corrupted, or ``None`` when the cache is empty.
    """
    if key is not None:
        path = cache._path(key)
    else:
        try:
            names = sorted(n for n in os.listdir(cache.root)
                           if n.endswith(".json"))
        except OSError:
            return None
        if not names:
            return None
        path = os.path.join(cache.root, names[0])
    if not os.path.exists(path):
        return None
    if mode == "tamper":
        import json

        with open(path) as f:
            doc = json.load(f)
        doc.setdefault("config", {})["kt"] = -7   # checksum now stale
        with open(path, "w") as f:
            json.dump(doc, f)
    else:
        with open(path, "w") as f:
            f.write('{"version": ')   # torn mid-write
    return path
