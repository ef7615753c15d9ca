"""Cost-model calibration and drift detection over the perf ledger.

Two distinct questions, kept deliberately separate:

* **Calibration** (:func:`calibration_report`): how far off is the
  analytical tuner, per feature regime? The roofline model prices the
  H100's peak rates, and an apply also pays launches, combines and
  gathers the model leaves out — the absolute measured/predicted ratio
  is therefore systematically above 1, and that *bias* is exactly what
  the report quantifies (geomean ratio + a log10-ratio histogram per
  ``op/backend/tc-fraction`` regime). A calibrated deployment reads the
  geomean off this report to rescale
  :class:`~repro_torch.core.threshold.HardwareModel` for its device.

* **Drift** (:func:`detect_drift`): has a *key's own* ratio changed
  over time? Drift compares a key's recent samples against its own
  baseline window (geomean over log-ratios), so the device-systematic
  bias cancels and what remains is a real change — thermal throttling,
  a runtime upgrade, the matrix's value distribution shifting under
  streaming updates. Flagged keys feed :func:`apply_drift`, which marks
  the PlanCache entry stale (next construction re-tunes) and drops the
  registry's resident applies for that sparsity signature.
"""
from __future__ import annotations

import math

DRIFT_THRESHOLD = 1.5       # recent/baseline geomean ratio beyond this flags
DRIFT_MIN_SAMPLES = 6       # need ≥ this many samples to split windows
_HIST_EDGES = (-3.0, -2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, 3.0)


def _ratios(samples) -> list[float]:
    out = []
    for s in samples:
        wall = s.get("wall_s")
        pred = s.get("predicted_s")
        if wall and pred and wall > 0 and pred > 0:
            out.append(float(wall) / float(pred))
    return out


def _geomean(ratios) -> float:
    if not ratios:
        return float("nan")
    return math.exp(sum(math.log(r) for r in ratios) / len(ratios))


def _log_hist(ratios) -> dict[str, int]:
    """Histogram of log10(measured/predicted) over fixed edges — the
    shape of the model's error distribution, robust to the magnitude of
    the device-systematic bias."""
    buckets = {f"<={e:g}": 0 for e in _HIST_EDGES}
    buckets[f">{_HIST_EDGES[-1]:g}"] = 0
    for r in ratios:
        lg = math.log10(r)
        for e in _HIST_EDGES:
            if lg <= e:
                buckets[f"<={e:g}"] += 1
                break
        else:
            buckets[f">{_HIST_EDGES[-1]:g}"] += 1
    return buckets


def _samples_of(ledger_or_samples) -> list[dict]:
    if hasattr(ledger_or_samples, "samples"):
        return ledger_or_samples.samples()
    return list(ledger_or_samples)


def _tc_bucket(frac: float) -> str:
    if frac < 0.33:
        return "tc-low"
    if frac < 0.66:
        return "tc-mid"
    return "tc-high"


def _bytes_bucket(nbytes: int) -> str:
    """Footprint regime of a sample's resident plan bytes."""
    if nbytes < 1 << 20:
        return "mem-<1mb"
    if nbytes < 8 << 20:
        return "mem-1-8mb"
    if nbytes < 64 << 20:
        return "mem-8-64mb"
    return "mem-64mb+"


def calibration_report(ledger_or_samples) -> dict:
    """Join measured wall times against model predictions and summarize
    error per feature regime (``op/backend/tc-fraction`` bucket).

    Accepts a :class:`~repro_torch.obs.ledger.PerfLedger` or an iterable of
    sample dicts. Render with :func:`render_calibration`.
    """
    samples = _samples_of(ledger_or_samples)
    by_key: dict[str, list[dict]] = {}
    regimes: dict[str, list[float]] = {}
    footprints: dict[str, list[float]] = {}
    for s in samples:
        by_key.setdefault(s["key"], []).append(s)
        r = _ratios([s])
        if r:
            regime = (f"{s.get('op', '?')}/{s.get('backend', '?')}/"
                      f"{_tc_bucket(float(s.get('tc_frac', 0.0)))}")
            regimes.setdefault(regime, []).extend(r)
            mem = s.get("mem_bytes")
            if mem:   # resident plan bytes at sample time
                fp = (f"{s.get('op', '?')}/"
                      f"{_bytes_bucket(int(mem.get('total', 0)))}")
                footprints.setdefault(fp, []).extend(r)

    def _rows(groups):
        return {g: {"n": len(groups[g]),
                    "geomean_ratio": _geomean(groups[g]),
                    "log10_hist": _log_hist(groups[g])}
                for g in sorted(groups)}

    regime_rows = _rows(regimes)
    footprint_rows = _rows(footprints)

    worst = []
    for key, docs in by_key.items():
        ratios = _ratios(docs)
        if not ratios:
            continue
        gm = _geomean(ratios)
        worst.append({"key": key, "op": docs[0].get("op"),
                      "sig": docs[0].get("sig"), "n": len(ratios),
                      "geomean_ratio": gm,
                      "abs_log_ratio": abs(math.log(gm))})
    worst.sort(key=lambda d: d["abs_log_ratio"], reverse=True)

    return {
        "kind": "calibration",
        "n_samples": len(samples),
        "n_keys": len(by_key),
        "regimes": regime_rows,
        "footprints": footprint_rows,
        "worst_keys": worst[:8],
    }


def render_calibration(report: dict, *, title: str | None = None) -> str:
    """Aligned ``key | value`` table, same shape as
    the reference package's ``explain.render_table``."""
    rows: list[tuple[str, str]] = [
        ("samples", str(report["n_samples"])),
        ("keys", str(report["n_keys"])),
    ]
    for regime, stats in report["regimes"].items():
        gm = stats["geomean_ratio"]
        rows.append((regime,
                     f"n={stats['n']} geomean meas/pred={gm:.3g}"))
        hist = stats["log10_hist"]
        populated = {k: v for k, v in hist.items() if v}
        rows.append((f"{regime} log10 hist",
                     " ".join(f"{k}:{v}" for k, v in populated.items())
                     or "(empty)"))
    # Footprint regimes are absent from reports without byte samples.
    for fp, stats in report.get("footprints", {}).items():
        rows.append((fp, f"n={stats['n']} geomean meas/pred="
                         f"{stats['geomean_ratio']:.3g}"))
    for w in report["worst_keys"][:4]:
        rows.append((f"worst {w['key'][:12]}",
                     f"{w['op']} n={w['n']} "
                     f"geomean={w['geomean_ratio']:.3g}"))
    w = max((len(k) for k, _ in rows), default=0)
    lines = [f"{k:>{w}} | {v}" for k, v in rows]
    bar = "-" * max((len(line) for line in lines), default=0)
    head = [title, bar] if title else ["calibration", bar]
    return "\n".join(head + lines + [bar])


def detect_drift(ledger_or_samples, *,
                 threshold: float = DRIFT_THRESHOLD,
                 min_samples: int = DRIFT_MIN_SAMPLES) -> list[dict]:
    """Flag keys whose measured/predicted ratio *changed* between their
    baseline (older half) and recent (newer half) sample windows.

    A key is flagged when ``recent/baseline > threshold`` or
    ``< 1/threshold``. Keys with fewer than ``min_samples`` usable
    samples are skipped (not enough evidence to split windows).
    """
    samples = _samples_of(ledger_or_samples)
    by_key: dict[str, list[dict]] = {}
    for s in samples:
        by_key.setdefault(s["key"], []).append(s)

    flags = []
    for key, docs in by_key.items():
        docs = sorted(docs, key=lambda d: d.get("t", 0.0))
        usable = [d for d in docs if _ratios([d])]
        if len(usable) < min_samples:
            continue
        half = len(usable) // 2
        baseline = _geomean(_ratios(usable[:half]))
        recent = _geomean(_ratios(usable[half:]))
        drift = recent / baseline
        if drift > threshold or drift < 1.0 / threshold:
            flags.append({
                "key": key,
                "sig": usable[-1].get("sig"),
                "op": usable[-1].get("op"),
                "tune_key": usable[-1].get("tune_key"),
                "n": len(usable),
                "baseline_ratio": baseline,
                "recent_ratio": recent,
                "drift": drift,
            })
    flags.sort(key=lambda f: abs(math.log(f["drift"])), reverse=True)
    return flags


def apply_drift(flags, cache, registry=None) -> dict:
    """Feed drift flags back into the tuning loop: mark each flagged
    key's PlanCache entry stale (so the next ``tune="search"``
    construction re-times instead of reusing the cached config) and —
    when a :class:`~repro_torch.serve.registry.GraphRegistry` is given — drop
    resident entries for the flagged sparsity signatures so the next
    registration rebuilds (and hence re-tunes) them.

    Returns ``{"flagged", "staled", "invalidated"}`` counts.
    """
    staled = 0
    invalidated = 0
    seen_sigs = set()
    for f in flags:
        tk = f.get("tune_key")
        if tk and cache is not None and cache.mark_stale(tk):
            staled += 1
        sig = f.get("sig")
        if registry is not None and sig and sig not in seen_sigs:
            seen_sigs.add(sig)
            invalidated += registry.invalidate(sig)
    return {"flagged": len(flags), "staled": staled,
            "invalidated": invalidated}
