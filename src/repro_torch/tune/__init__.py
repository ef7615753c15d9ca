"""Resolution of the ``tune=`` knob (subset: ``"off"`` and literal configs)."""
from __future__ import annotations

from repro_torch.tune.model import DEFAULT_TUNE, TuneConfig

__all__ = ["DEFAULT_TUNE", "TuneConfig", "resolve_tune"]


def resolve_tune(tune, *, threshold: int | None = None,
                 bk: int | None = None,
                 ts_tile: int | None = None) -> TuneConfig:
    """``TuneConfig`` → itself; ``"off"`` → the defaults with the
    explicit plan parameters filled in (the reference's ``tune="off"``)."""
    if isinstance(tune, TuneConfig):
        return tune
    if tune == "off":
        return DEFAULT_TUNE.replace(threshold=threshold, bk=bk,
                                    ts_tile=ts_tile)
    raise ValueError(f"tune must be 'off' or a TuneConfig, got {tune!r}")
