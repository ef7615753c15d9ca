"""Deterministic, shardable synthetic data pipeline.

The port's own copy of ``repro.train.data`` (numpy only): the same
seeds give the same arrays in both packages.

Design goals at 1000+ nodes:

* **Stateless indexing** — batch(step, host) is a pure function of
  (seed, step, host), so any host can (re)compute its shard without
  coordination: restart, elastic re-shard, and straggler skip-ahead all
  reduce to calling ``global_batch`` with new arguments.
* **Straggler mitigation** — a host that falls behind may skip to the
  next step boundary (``skip_to``); determinism guarantees every other
  host agrees on what it skipped (no desync).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1


def _philox(seed: int, step: int, host: int, size: int) -> np.ndarray:
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, host]))
    return rng


def host_batch(cfg: DataConfig, step: int, host: int) -> dict[str, np.ndarray]:
    """The per-host shard of the global batch for one step."""
    assert cfg.global_batch % cfg.n_hosts == 0
    per = cfg.global_batch // cfg.n_hosts
    rng = _philox(cfg.seed, step, host, per)
    # Markov-ish synthetic stream: token t+1 = f(t) + noise (gives a
    # learnable signal so convergence tests are meaningful).
    start = rng.integers(0, cfg.vocab, size=(per, 1))
    steps = rng.integers(0, 7, size=(per, cfg.seq_len - 1))
    toks = np.concatenate([start, steps], axis=1)
    tokens = np.cumsum(toks, axis=1) % cfg.vocab
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1  # masked
    return {"tokens": tokens.astype(np.int32),
            "labels": labels.astype(np.int32)}


def global_batch(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    parts = [host_batch(cfg, step, h) for h in range(cfg.n_hosts)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def skip_to(cfg: DataConfig, current_step: int, lag_steps: int) -> int:
    """Straggler policy: a lagging host drops to the next boundary.

    Returns the step this host should produce next. Because batches are
    stateless, no other host needs to know: they all compute batch(step)
    independently.
    """
    return current_step + max(lag_steps, 0)
