"""Perf ledger: a persistent JSONL store of measured apply samples.

The tracer and metrics say where the time went *in this process*; the
ledger is the durable counterpart: every recorded sample joins a
measured wall time to the analytical tuner's prediction for the same
(sparsity signature, op, width/dtype/backend, TuneConfig) key, so
:mod:`repro_torch.obs.calibrate` can quantify model error per feature
regime and detect keys whose measured/predicted ratio drifts over time
(the re-tune trigger).

Storage contract (sibling of the tune cache):

* root: ``$REPRO_TORCH_PERF_LEDGER_DIR`` if set, else
  ``~/.cache/repro_torch_perf_ledger``; one ``samples.jsonl`` file;
* appends are **atomic**: each sample is one ``os.write`` to an
  ``O_APPEND`` fd (POSIX guarantees append atomicity for writes below
  ``PIPE_BUF``; samples are a few hundred bytes), so concurrent
  processes interleave whole lines, never torn ones;
* the store is **capped**: :meth:`PerfLedger.compact` keeps the newest
  ``max_per_key`` samples per key (``$REPRO_TORCH_PERF_LEDGER_MAX``
  overrides) and runs automatically every ``_COMPACT_EVERY`` appends —
  rewrite is temp-file + ``os.replace``, the same atomic-replace idiom
  as :class:`repro_torch.tune.cache.PlanCache`;
* corrupt lines (a torn write from a crashed process) are skipped and
  counted, never fatal.

A sample's model fields are the port's own: ``predicted_s`` prices the
split with the H100 :class:`~repro_torch.core.threshold.HardwareModel`,
``vmem_step_bytes``/``pipeline_depth`` carry the Hopper footprint (K1's
or K3's shared memory a block, and blocks an SM), and
``hlo_flops``/``hlo_bytes`` are analytic counts of the apply: 2 × nnz ×
width operations; each real entry's table bytes, each row of a gathered
operand once and the output once.

Recording sites (all opt-in — the default process ledger is ``None``
and every hook is a single ``is not None`` check):

* :func:`repro_torch.kernels.ops.apply_at` — the operator apply
  path (``source="execute"``);
* ``tune="search"`` candidate timings (``source="search"``);
* :class:`repro_torch.serve.engine.SparseEngine` — every Nth packed
  apply (``source="engine"``).
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import time

import numpy as np

_ENV_DIR = "REPRO_TORCH_PERF_LEDGER_DIR"
_ENV_MAX = "REPRO_TORCH_PERF_LEDGER_MAX"
DEFAULT_MAX_PER_KEY = 256
_COMPACT_EVERY = 512      # appends between automatic compaction sweeps


def default_ledger_dir() -> str:
    env = os.environ.get(_ENV_DIR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "repro_torch_perf_ledger")


def default_max_per_key() -> int:
    env = os.environ.get(_ENV_MAX)
    return int(env) if env else DEFAULT_MAX_PER_KEY


def ledger_key(sig: str, op: str, width: int, dtype: str, backend: str,
               cfg_digest: str) -> str:
    """Sample-group key: sparsity signature + apply context + config
    digest. Samples sharing a key are directly comparable measurements
    of one (plan, apply shape)."""
    payload = f"{sig}|{op}|{width}|{dtype}|{backend}|{cfg_digest}"
    return hashlib.blake2b(payload.encode(), digest_size=16).hexdigest()


def dtype_name(dtype) -> str:
    """A dtype's short name (``torch.float32`` → ``"float32"``): the
    form ledger keys and engine buckets carry."""
    return str(dtype).removeprefix("torch.")


def config_digest(cfg) -> str:
    """Content digest of a :class:`~repro_torch.tune.model.TuneConfig` —
    ``source`` excluded (a cached copy of a searched config is the same
    plan)."""
    import dataclasses

    d = dataclasses.asdict(cfg)
    d.pop("source", None)
    payload = json.dumps(d, sort_keys=True).encode()
    return hashlib.blake2b(payload, digest_size=8).hexdigest()


class PerfLedger:
    """Append-mostly JSONL sample store; see the module docstring for
    the atomicity/capping contract."""

    def __init__(self, root: str | None = None,
                 max_per_key: int | None = None, clock=time.time):
        self.root = root or default_ledger_dir()
        self.max_per_key = (default_max_per_key() if max_per_key is None
                            else max_per_key)
        assert self.max_per_key >= 1
        self._clock = clock
        self._appends = 0

    @property
    def path(self) -> str:
        return os.path.join(self.root, "samples.jsonl")

    # -------------------------------------------------------- writing ---
    def record(self, sample: dict) -> dict:
        """Append one sample (must carry ``key``; ``t`` is stamped from
        the ledger clock when absent). One atomic O_APPEND write."""
        if "key" not in sample:
            raise ValueError("ledger sample must carry a 'key'")
        sample.setdefault("t", float(self._clock()))
        line = json.dumps(sample, sort_keys=True,
                          separators=(",", ":")) + "\n"
        os.makedirs(self.root, exist_ok=True)
        fd = os.open(self.path,
                     os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, line.encode())
        finally:
            os.close(fd)
        self._appends += 1
        if self._appends >= _COMPACT_EVERY:
            self._appends = 0
            self.compact()
        return sample

    # -------------------------------------------------------- reading ---
    def _read(self) -> tuple[list[dict], int]:
        try:
            with open(self.path) as f:
                lines = f.readlines()
        except OSError:
            return [], 0
        out, corrupt = [], 0
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                corrupt += 1        # torn line from a crashed writer
                continue
            if isinstance(doc, dict) and "key" in doc:
                out.append(doc)
            else:
                corrupt += 1
        return out, corrupt

    def samples(self, key: str | None = None) -> list[dict]:
        """All samples (append order), optionally filtered by key."""
        docs, _ = self._read()
        if key is None:
            return docs
        return [d for d in docs if d["key"] == key]

    def keys(self) -> set[str]:
        return {d["key"] for d in self._read()[0]}

    def stats(self) -> dict:
        docs, corrupt = self._read()
        try:
            nbytes = os.path.getsize(self.path)
        except OSError:
            nbytes = 0
        return {"path": self.path, "samples": len(docs),
                "keys": len({d["key"] for d in docs}),
                "corrupt_lines": corrupt, "bytes": nbytes,
                "max_per_key": self.max_per_key}

    # ------------------------------------------------------- capping ---
    def compact(self) -> int:
        """Rewrite the store keeping the newest ``max_per_key`` samples
        per key (and dropping corrupt lines); returns how many samples
        were dropped. Atomic (temp file + ``os.replace``); losing a
        concurrent append between read and replace loses only that
        window's appends — acceptable for a sampling store."""
        docs, corrupt = self._read()
        if not docs and not corrupt:
            return 0
        per_key: dict[str, list[dict]] = {}
        for d in docs:
            per_key.setdefault(d["key"], []).append(d)
        keep: list[dict] = []
        for k in per_key:
            keep.extend(per_key[k][-self.max_per_key:])
        keep.sort(key=lambda d: d.get("t", 0.0))
        dropped = len(docs) - len(keep)
        if dropped == 0 and corrupt == 0:
            return 0
        import tempfile

        os.makedirs(self.root, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                for d in keep:
                    f.write(json.dumps(d, sort_keys=True,
                                       separators=(",", ":")) + "\n")
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return dropped

    def clear(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


# ------------------------------------------------- process default ---
# Disabled by default (None): every recording hook pays one global
# check, mirroring the disabled-tracer idiom in repro_torch.obs.trace.
_ACTIVE: PerfLedger | None = None


def get_ledger() -> PerfLedger | None:
    return _ACTIVE


def set_ledger(ledger: PerfLedger | None) -> PerfLedger | None:
    """Install ``ledger`` as the process ledger; returns the previous
    one (so callers can restore it)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, ledger
    return prev


@contextlib.contextmanager
def use_ledger(ledger: PerfLedger | None):
    """Scope-limited :func:`set_ledger`."""
    prev = set_ledger(ledger)
    try:
        yield ledger
    finally:
        set_ledger(prev)


# ---------------------------------------------- operator sampling ---
class _OpLedgerContext:
    """Lazily-built, per-operator sample metadata (signature, model
    predictions, per-stream grid steps). Memoized on the operator so the
    feature pass and signature hash are paid once per op — and only when
    a ledger is actually recording."""

    def __init__(self, op, kind: str):
        from repro_torch.tune.cache import matrix_signature

        self.op = op
        self.kind = kind
        self.sig = matrix_signature(op._a)
        self.cfg_digest = config_digest(op.tune_config)
        plan = op.plan
        meta = plan.meta
        tc_seg = meta.get("tc_segments")
        vpu_seg = meta.get("vpu_segments")
        self.base = {
            "sig": self.sig, "op": kind, "cfg": self.cfg_digest,
            "m": int(plan.m), "k": int(plan.k), "nnz": int(plan.nnz),
            "tc_frac": float(meta.get("tc_ratio", 0.0)),
            "tune_source": op.tune_config.source,
            # Per-stream grid steps: segments when the §4.3 launch is
            # on, condensed blocks / tiles otherwise.
            "tc_steps": (int(tc_seg.nseg) if tc_seg is not None
                         and tc_seg.nseg else int(plan.tc.vals.shape[0])),
            "vpu_steps": (int(vpu_seg.nseg) if vpu_seg is not None
                          and vpu_seg.nseg else int(plan.vpu.ntiles)),
        }
        self.tune_key = self._search_tune_key()
        self._feat = None
        self._per_width: dict[int, dict] = {}
        self._gathered: tuple[int, int] | None = None

    def _search_tune_key(self) -> str | None:
        """The PlanCache key a ``tune="search"`` construction of this
        operator resolves through — what drift staling invalidates.
        None for model/off/explicit-config operators (nothing cached to
        stale)."""
        spec = getattr(self.op, "spec", None)
        if spec is None:
            return None
        from repro_torch.core.preprocess import search_tune_key

        return search_tune_key(self.op._a, self.kind, spec)

    def _model(self, width: int) -> dict:
        cached = self._per_width.get(width)
        if cached is None:
            from repro_torch.core.threshold import HardwareModel
            from repro_torch.tune.model import (
                _modeled_sddmm_time,
                _modeled_spmm_time,
                matrix_features,
                occupancy_report,
                sddmm_footprint,
                spmm_footprint,
            )

            op, plan = self.op, self.op.plan
            if self._feat is None:
                self._feat = matrix_features(op._a)
            hw = HardwareModel()
            bk, thr = int(plan.tc.bk), int(plan.threshold)
            if self.kind == "spmm":
                pred = _modeled_spmm_time(self._feat, thr, n=width,
                                          bk=bk, hw=hw)
                foot = spmm_footprint(width, int(plan.k))
            else:
                pred = _modeled_sddmm_time(self._feat, thr, kf=width,
                                           bk=bk, hw=hw)
                foot = sddmm_footprint(width, int(plan.k))
            occ = occupancy_report(foot["smem_bytes"], foot["threads"])
            cached = self._per_width[width] = {
                "predicted_s": float(pred),
                "vmem_step_bytes": int(occ["smem_bytes_per_block"]),
                "pipeline_depth": int(occ["blocks_per_sm"]),
            }
        return dict(cached)

    def _hlo(self, width: int) -> dict:
        """Analytic operations and bytes of one apply at ``width``:
        2 × nnz × width operations; each real entry's (value, column) or
        (row, column) pair, each row of a gathered operand once, and the
        output once (4 bytes a number)."""
        a = self.op._a
        if self._gathered is None:
            cols = int(np.unique(np.asarray(a.indices)).size)
            rows = int(np.count_nonzero(np.diff(np.asarray(a.indptr))))
            self._gathered = (rows, cols)
        rows, cols = self._gathered
        nnz = int(a.nnz)
        if self.kind == "spmm":
            nbytes = 8 * nnz + 4 * cols * width + 4 * int(a.m) * width
        else:
            nbytes = 8 * nnz + 4 * (rows + cols) * width + 4 * nnz
        return {"hlo_flops": 2.0 * nnz * width, "hlo_bytes": float(nbytes)}

    def sample(self, *, width: int, dtype: str, backend: str,
               wall_s: float, source: str) -> dict:
        s = dict(self.base)
        s.update(
            key=ledger_key(self.sig, self.kind, width, dtype, backend,
                           self.cfg_digest),
            width=int(width), dtype=str(dtype), backend=str(backend),
            wall_s=float(wall_s), source=source,
        )
        if self.tune_key is not None:
            s["tune_key"] = self.tune_key
        s.update(self._model(width))
        s.update(self._hlo(width))
        arrays = getattr(self.op, "arrays", None)
        if hasattr(arrays, "view_nbytes"):
            # Per-sample, not memoized: residency grows as lazy views
            # materialize, and calibration buckets error by footprint.
            vb = arrays.view_nbytes()
            s["mem_bytes"] = {**vb, "total": sum(vb.values())}
        return s


def _op_context(op, kind: str) -> _OpLedgerContext:
    ctx = getattr(op, "_perf_ledger_ctx", None)
    if ctx is None:
        ctx = op._perf_ledger_ctx = _OpLedgerContext(op, kind)
    return ctx


def operator_sample(op, kind: str, *, width: int, dtype: str,
                    backend: str, wall_s: float, source: str) -> dict:
    """Full ledger sample for one LibraSpMM/LibraSDDMM apply: measured
    wall seconds joined to the model's prediction, the Hopper footprint,
    per-stream grid steps, and the apply's analytic flops/bytes."""
    return _op_context(op, kind).sample(width=width, dtype=dtype,
                                        backend=backend, wall_s=wall_s,
                                        source=source)


def record_apply(op, kind: str, *, width: int, dtype: str, backend: str,
                 wall_s: float, source: str,
                 ledger: PerfLedger | None = None) -> dict | None:
    """Record one apply into ``ledger`` (default: the process ledger).
    No-op when no ledger is active; disk errors are swallowed (recording
    must never fail an apply)."""
    led = ledger if ledger is not None else get_ledger()
    if led is None:
        return None
    sample = operator_sample(op, kind, width=width, dtype=dtype,
                             backend=backend, wall_s=wall_s,
                             source=source)
    try:
        return led.record(sample)
    except OSError:
        return None


def apply_sampler(op, kind: str, *, width: int, dtype: str,
                  backend: str, source: str = "execute"):
    """A ``(wall_s) -> None`` recorder for :func:`apply_at`'s
    sampling hook, or None when no process ledger is active (the
    fast-path check the operators pay per call)."""
    if get_ledger() is None:
        return None

    def sample(wall_s: float) -> None:
        record_apply(op, kind, width=width, dtype=dtype, backend=backend,
                     wall_s=wall_s, source=source)

    return sample
