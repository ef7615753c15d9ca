"""The one traffic generator: it reads a mix's data file
(``gpubench/traffic/<mix>.json``) and the cell's seed.

A ``train`` mix is a closed loop of full-batch steps; its file gives the
number of steps the comparison follows (``check_steps``).

A ``serve`` mix is an open loop of scoring requests. Its file gives:

* ``load``: the offered rate as a share of the configuration's
  ``serve_knee_rps`` (the highest rate it sustained in the sweep);
* ``trace_seed``: the fixed draw of arrival times every seed replays,
  turned by a seeded offset (see :func:`arrivals`);
* ``max_batch``: the most requests the server loop hands one flush; the
  rest wait for the next, so a stall cannot pile an unbounded batch
  (and its device memory) onto one flush;
* ``pool_panels``: feature panels made at set-up, each request drawing
  one uniformly;
* ``subset_every``/``subset_nodes``: one request in ``subset_every``
  scores ``subset_nodes`` node ids, the rest score every node;
* ``check_requests``: how many of the window's requests the comparison
  takes, drawn from the seed.

Every seed gets the same requests: the same count, the same number of
subset requests and the same arrival gaps; the seed moves their order,
the offset of the arrivals, the panels and the node ids.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Schedule:
    seconds: float
    due: list[float]          # seconds after the window opens, ascending
    panels: list[int]         # pool panel of each request
    subset: list[bool]        # whether it scores a subset of the nodes
    check: set[int]           # requests the comparison takes
    ids: torch.Tensor         # (subset requests, subset_nodes) node ids
    slot: dict[int, int]      # request → its row of ``ids``

    def subset_ids(self, i: int) -> torch.Tensor:
        return self.ids[self.slot.get(i, i % len(self.ids))]


def rate(mix: dict, cfg: dict) -> float:
    return mix["load"] * cfg["serve_knee_rps"]


def arrivals(mix: dict, n: int, seconds: float,
             rng: np.random.Generator) -> np.ndarray:
    """``n`` arrival times in ``[0, seconds)``.

    The times are one fixed draw from ``trace_seed`` (uniform over the
    window, which is a Poisson process held to ``n`` requests), turned
    on the window as on a circle by an offset drawn from ``rng``: every
    seed replays the same arrivals and gaps in another order, so the
    seed does not change how bunched a window is."""
    trace = np.random.default_rng([mix["trace_seed"], n])
    return np.sort((trace.uniform(0.0, seconds, n)
                    + rng.uniform(0.0, seconds)) % seconds)


def schedule(mix: dict, cfg: dict, seed: int, seconds: float, n_nodes: int,
             dev: torch.device, offered: float | None = None) -> Schedule:
    """The requests of one window of ``seconds`` at the mix's rate (or
    at ``offered`` requests a second, for the sweep)."""
    rng = np.random.default_rng([seed, 0x5E4E])
    r = rate(mix, cfg) if offered is None else offered
    n = max(1, int(round(r * seconds)))
    due = arrivals(mix, n, seconds, rng)
    subset = np.zeros(n, bool)
    subset[: n // mix["subset_every"]] = True
    rng.shuffle(subset)
    panels = rng.integers(0, mix["pool_panels"], n)
    check = rng.choice(n, size=min(n, mix["check_requests"]), replace=False)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**62)))
    n_sub = max(1, int(subset.sum()))
    ids = torch.randint(0, n_nodes, (n_sub, mix["subset_nodes"]),
                        generator=gen, device=dev)
    slot = {int(i): j for j, i in enumerate(np.flatnonzero(subset))}
    return Schedule(seconds, due.tolist(), panels.tolist(), subset.tolist(),
                    set(int(c) for c in check), ids, slot)
