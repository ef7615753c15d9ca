"""Persistent plan cache: tune once per sparsity pattern, ever.

The reference package's ``repro.tune.cache`` with the same contract.
Repeated benchmarks and services construct the same operators over and
over; empirical search in particular is too expensive to redo per
process. Tuned :class:`~repro_torch.tune.model.TuneConfig` objects are
stored as one JSON file per key under a configurable directory:

* default root: ``$REPRO_TORCH_TUNE_CACHE_DIR`` if set, else
  ``~/.cache/repro_torch_tune`` — the port's own, so an entry the
  reference package tuned for its chip never reaches a card's build;
* key = BLAKE2b hash of the matrix's *sparsity signature* (shape, nnz,
  ``indptr``/``indices`` bytes — values don't change plan selection)
  plus the tuning context (operator kind, dense width, dtype, backend,
  mode, any explicit threshold override, tuner version), computed as the
  reference computes it;
* writes are atomic (``os.replace`` of a temp file) so concurrent
  processes never observe a torn entry; every entry carries a BLAKE2b
  checksum over its config, verified on ``get()`` — an unparseable or
  checksum-mismatched file is **quarantined** (moved to a
  ``quarantine/`` subdir for post-mortem, counted in :meth:`PlanCache.stats`)
  rather than silently treated as a cold miss, so disk corruption and
  tampering are observable. Version-skewed entries (an old
  :data:`CACHE_VERSION`) stay silent misses — stale format, not
  corruption;
* the store is **LRU-capped** (``max_entries``, default
  :data:`DEFAULT_MAX_ENTRIES`, overridable via
  ``$REPRO_TORCH_TUNE_CACHE_MAX``): every hit refreshes the entry's
  mtime and every write evicts the stalest entries beyond the cap, so
  the on-disk footprint is bounded no matter how many distinct matrices
  a process churns through. Eviction tolerates concurrent writers —
  losing a race to unlink (or to replace) a file is treated as
  already-done, never an error.

Bumping :data:`CACHE_VERSION` invalidates every entry (the version is
hashed into the key), which is how model/search changes roll out without
a manual cache wipe.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.sparse.matrix import SparseCSR
from repro_torch.tune.model import TuneConfig

CACHE_VERSION = 5  # v5: reorder decisions in keys + cached decision docs
_ENV_VAR = "REPRO_TORCH_TUNE_CACHE_DIR"
_ENV_MAX = "REPRO_TORCH_TUNE_CACHE_MAX"
DEFAULT_MAX_ENTRIES = 512


def default_max_entries() -> int:
    env = os.environ.get(_ENV_MAX)
    return int(env) if env else DEFAULT_MAX_ENTRIES


def default_cache_dir() -> str:
    env = os.environ.get(_ENV_VAR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch_tune")


def matrix_signature(a: SparseCSR) -> str:
    """Hash of the sparsity *pattern* (not the values): plan selection —
    threshold split, tiling, grid order — depends only on the pattern."""
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{a.m}:{a.k}:{a.nnz}:".encode())
    h.update(a.indptr.astype("int64").tobytes())
    h.update(a.indices.astype("int32").tobytes())
    return h.hexdigest()


def tune_key(a: SparseCSR, *, op: str, width: int, dtype: str,
             backend: str, mode: str, tune: str,
             threshold: int | None = None, bk: int | None = None,
             ts_tile: int | None = None,
             reorder: str | None = None) -> str:
    """Full cache key: sparsity signature + tuning context (including any
    explicit plan-parameter overrides — a result searched for one ``bk``
    must not be served for another, nor a reordered pattern's for the
    original's)."""
    h = hashlib.blake2b(digest_size=16)
    payload = (f"v{CACHE_VERSION}|{matrix_signature(a)}|{op}|{width}|"
               f"{dtype}|{backend}|{mode}|{tune}|{threshold}|{bk}|{ts_tile}"
               f"|{reorder}")
    h.update(payload.encode())
    return h.hexdigest()


def reorder_key(a: SparseCSR, *, op: str, threshold: int) -> str:
    """Cache key for one ``reorder="auto"`` decision: the pattern
    signature plus the threshold the TC-fraction gain was priced at.
    Values never enter — the decision depends only on the pattern."""
    h = hashlib.blake2b(digest_size=16)
    payload = (f"v{CACHE_VERSION}|reorder|{matrix_signature(a)}|{op}|"
               f"{threshold}")
    h.update(payload.encode())
    return h.hexdigest()


def config_checksum(config: dict) -> str:
    """BLAKE2b content checksum over an entry's config dict (canonical
    JSON, sorted keys) — what :meth:`PlanCache.get` verifies."""
    payload = json.dumps(config, sort_keys=True).encode()
    return hashlib.blake2b(payload, digest_size=16).hexdigest()


class PlanCache:
    """File-per-key JSON store for tuned configs, LRU-capped,
    checksum-verified with quarantine of corrupt entries."""

    def __init__(self, root: str | None = None,
                 max_entries: int | None = None,
                 metrics: MetricsRegistry | None = None):
        self.root = root or default_cache_dir()
        self.max_entries = (default_max_entries() if max_entries is None
                            else max_entries)
        assert self.max_entries >= 1
        self.metrics = MetricsRegistry() if metrics is None else metrics
        m = self.metrics
        self._hits = m.counter(
            "tune_cache_hits_total", "PlanCache lookups served from disk")
        self._misses = m.counter(
            "tune_cache_misses_total",
            "PlanCache lookups that fell through (cold/stale/corrupt)")
        self._quarantined = m.counter(
            "tune_cache_quarantined_total",
            "Corrupt entries moved to quarantine", labels=("reason",))
        self._quarantined_bytes = m.counter(
            "tune_cache_quarantined_bytes_total",
            "Bytes of corrupt entries moved to quarantine")
        self._stale_marked = m.counter(
            "tune_cache_stale_marked_total",
            "Entries marked stale by drift feedback")
        self._stale_misses = m.counter(
            "tune_cache_stale_misses_total",
            "Lookups that dropped a drift-staled entry (forcing re-tune)")

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.json")

    @property
    def quarantine_dir(self) -> str:
        return os.path.join(self.root, "quarantine")

    # Back-compat views over the metric counters (old attribute names).
    @property
    def quarantined(self) -> int:
        return sum(self._quarantined.series().values())

    @property
    def quarantined_by_reason(self) -> dict:
        return self._quarantined.series()

    def _quarantine(self, path: str, reason: str) -> None:
        """Move a corrupt entry aside for post-mortem instead of leaving
        it to masquerade as a cold miss on every future lookup."""
        qdir = self.quarantine_dir
        try:
            nbytes = os.path.getsize(path)
        except OSError:
            nbytes = 0
        try:
            os.makedirs(qdir, exist_ok=True)
            os.replace(path, os.path.join(qdir, os.path.basename(path)))
        except OSError:
            return  # concurrently evicted/quarantined: nothing to move
        self._quarantined.inc(reason=reason)
        self._quarantined_bytes.inc(nbytes)

    def get(self, key: str) -> TuneConfig | None:
        path = self._path(key)
        try:
            with open(path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            self._misses.inc()
            return None                      # cold miss, not corruption
        except (OSError, ValueError):
            self._quarantine(path, "unparseable")
            self._misses.inc()
            return None
        if doc.get("version") != CACHE_VERSION:
            self._misses.inc()
            return None          # stale format: version bumps are benign
        if doc.get("stale"):
            # Drift feedback marked this entry suspect: drop it so this
            # lookup (and only this one) re-tunes and re-writes fresh.
            try:
                os.unlink(path)
            except OSError:
                pass             # concurrent re-tune already replaced it
            self._stale_misses.inc()
            self._misses.inc()
            return None
        cfg = doc.get("config")
        if not isinstance(cfg, dict) \
                or doc.get("checksum") != config_checksum(cfg):
            self._quarantine(path, "checksum_mismatch")
            self._misses.inc()
            return None
        try:
            out = TuneConfig(**cfg).replace(source="cache")
        except TypeError:
            self._misses.inc()
            return None  # field drift ⇒ treat as miss
        try:
            os.utime(path)  # LRU touch: a hit is a use
        except OSError:
            pass  # concurrently evicted — the parsed doc is still good
        self._hits.inc()
        return out

    def put(self, key: str, cfg: TuneConfig, meta: dict | None = None) -> str:
        os.makedirs(self.root, exist_ok=True)
        config = dataclasses.asdict(cfg)
        doc = {
            "version": CACHE_VERSION,
            "config": config,
            "checksum": config_checksum(config),
            "meta": meta or {},
        }
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1)
                f.write("\n")
            os.replace(tmp, self._path(key))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._evict()
        return self._path(key)

    def get_doc(self, key: str) -> dict | None:
        """Fetch a plain-dict entry (e.g. a cached ``reorder="auto"``
        decision) with the same verification/quarantine semantics as
        :meth:`get`, minus the :class:`TuneConfig` parse."""
        path = self._path(key)
        try:
            with open(path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            self._misses.inc()
            return None
        except (OSError, ValueError):
            self._quarantine(path, "unparseable")
            self._misses.inc()
            return None
        if doc.get("version") != CACHE_VERSION or doc.get("stale"):
            self._misses.inc()
            return None
        cfg = doc.get("config")
        if not isinstance(cfg, dict) \
                or doc.get("checksum") != config_checksum(cfg):
            self._quarantine(path, "checksum_mismatch")
            self._misses.inc()
            return None
        try:
            os.utime(path)  # LRU touch
        except OSError:
            pass
        self._hits.inc()
        return cfg

    def put_doc(self, key: str, config: dict, meta: dict | None = None) -> str:
        """Store a plain-dict entry under the standard checksummed,
        atomic, LRU-capped envelope (see :meth:`put`)."""
        os.makedirs(self.root, exist_ok=True)
        doc = {
            "version": CACHE_VERSION,
            "config": config,
            "checksum": config_checksum(config),
            "meta": meta or {},
        }
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1)
                f.write("\n")
            os.replace(tmp, self._path(key))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._evict()
        return self._path(key)

    def mark_stale(self, key: str) -> bool:
        """Mark an entry stale (drift feedback; the reference's
        ``obs.calibrate.apply_drift`` is ROADMAP item 10): the next
        :meth:`get` drops it and reports a miss, so the next
        ``tune="search"`` construction re-times the candidate grid
        instead of trusting a config that no longer predicts reality. Atomic
        rewrite; returns False when the entry doesn't exist or can't be
        parsed (nothing to stale)."""
        path = self._path(key)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return False
        if doc.get("stale"):
            return True          # already marked
        doc["stale"] = True
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1)
                f.write("\n")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._stale_marked.inc()
        return True

    def size(self) -> int:
        """Number of resident entries (quarantined files excluded)."""
        try:
            return sum(n.endswith(".json") for n in os.listdir(self.root))
        except OSError:
            return 0

    def stats(self) -> dict:
        """Stable schema (thin view over the metric counters): entry
        count, hit/miss totals, quarantine reason → count plus total
        bytes moved, and the on-disk quarantine file count."""
        try:
            in_quarantine = len(os.listdir(self.quarantine_dir))
        except OSError:
            in_quarantine = 0
        return {
            "entries": self.size(),
            "hits": self._hits.value,
            "misses": self._misses.value,
            "quarantined": self.quarantined,
            "quarantined_by_reason": dict(self.quarantined_by_reason),
            "quarantined_bytes": self._quarantined_bytes.value,
            "quarantine_dir_files": in_quarantine,
            "stale_marked": self._stale_marked.value,
            "stale_misses": self._stale_misses.value,
        }

    def _evict(self) -> None:
        """Drop least-recently-used entries beyond ``max_entries``.

        mtime is the recency signal (``get`` touches it). Races with
        concurrent writers are benign: a vanished file mid-scan or
        mid-unlink means someone else evicted it first.
        """
        try:
            names = [n for n in os.listdir(self.root) if n.endswith(".json")]
        except OSError:
            return
        over = len(names) - self.max_entries
        if over <= 0:
            return
        aged = []
        for n in names:
            try:
                aged.append((os.path.getmtime(os.path.join(self.root, n)), n))
            except OSError:
                pass  # concurrently removed
        aged.sort()
        for _, n in aged[:over]:
            try:
                os.unlink(os.path.join(self.root, n))
            except OSError:
                pass
