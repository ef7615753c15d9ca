"""Continuous-batching scheduler for the serving path.

Production serving keeps the decode batch full by admitting new
requests into freed slots every step (vLLM-style continuous batching,
with whole-slot granularity — the cache layout here is a dense
(layers, B, S, …) block per slot, as lowered by the decode cells).

The scheduler is deliberately host logic only: it decides *which*
request occupies each cache slot and at what fill length; the decode
step it drives stays shape-static. Eviction is FIFO-on-completion;
prompts longer than the cache are rejected up front (the paged-cache
extension would lift this).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    pos: int = 0           # tokens of the prompt already consumed
    done: bool = False


@dataclasses.dataclass
class Slot:
    req: Request | None = None
    length: int = 0        # filled cache length


class ContinuousBatcher:
    """Admits requests into a fixed-size decode batch, one token per
    slot per step (prompts stream token-by-token through the same
    decode path — "teacher-forced prefill")."""

    def __init__(self, batch_size: int, max_len: int):
        self.slots = [Slot() for _ in range(batch_size)]
        self.queue: deque[Request] = deque()
        self.max_len = max_len
        self.finished: list[Request] = []
        # Mean fraction of busy slots over the steps driven so far — a
        # proper field (updated by run_to_completion), not an ad-hoc
        # attribute that only exists after a full drain.
        self.mean_utilization: float = 0.0

    # -- host-side scheduling -------------------------------------------
    def submit(self, req: Request) -> bool:
        if len(req.prompt) + req.max_new > self.max_len:
            return False  # would overflow the cache slot
        if req.max_new == 0:
            # Nothing to generate: complete immediately (empty output)
            # without ever occupying a decode slot.
            req.done = True
            self.finished.append(req)
            return True
        self.queue.append(req)
        return True

    def _admit(self) -> None:
        for slot in self.slots:
            if slot.req is None and self.queue:
                slot.req = self.queue.popleft()
                slot.length = 0

    def step_plan(self) -> tuple[list[int], list[int], list[bool]]:
        """Returns (token per slot, new length per slot, active mask).

        Idle slots feed token 0 at their current length (their cache
        writes land in already-dead positions — harmless and
        shape-static).
        """
        self._admit()
        toks, lens, active = [], [], []
        for slot in self.slots:
            r = slot.req
            if r is None:
                toks.append(0)
                lens.append(max(slot.length, 1))
                active.append(False)
                continue
            if r.pos < len(r.prompt):
                toks.append(r.prompt[r.pos])
            else:
                toks.append(r.out[-1])
            slot.length += 1
            lens.append(slot.length)
            active.append(True)
        return toks, lens, active

    def feed(self, sampled: list[int]) -> None:
        """Consume one step's sampled tokens; retire finished requests."""
        for slot, tok in zip(self.slots, sampled):
            r = slot.req
            if r is None:
                continue
            if r.pos < len(r.prompt) - 1:
                r.pos += 1  # still prefilling: sampled token discarded
                continue
            if r.pos == len(r.prompt) - 1:
                r.pos += 1  # prompt done: first generated token is real
            r.out.append(int(tok))
            if len(r.out) >= r.max_new:
                r.done = True
                self.finished.append(r)
                slot.req = None
                slot.length = 0

    @property
    def idle(self) -> bool:
        return not self.queue and all(s.req is None for s in self.slots)

    def utilization(self) -> float:
        busy = sum(1 for s in self.slots if s.req is not None)
        return busy / len(self.slots)


def run_to_completion(batcher: ContinuousBatcher,
                      step_fn: Callable[[list[int], list[int]], list[int]],
                      max_steps: int = 10_000) -> list[Request]:
    """Drive the batcher against a per-step decode function.

    ``step_fn(tokens, lengths) -> sampled tokens`` wraps the decode
    step; the scheduler never sees device tensors. The per-run mean
    slot utilization lands in ``batcher.mean_utilization`` (0.0 when no
    step was needed, e.g. every request had ``max_new=0``).
    """
    steps = 0
    util = []
    while not batcher.idle and steps < max_steps:
        toks, lens, _ = batcher.step_plan()
        util.append(batcher.utilization())  # slots busy *during* the step
        sampled = step_fn(toks, lens)
        batcher.feed(sampled)
        steps += 1
    batcher.mean_utilization = sum(util) / max(len(util), 1)
    return batcher.finished
