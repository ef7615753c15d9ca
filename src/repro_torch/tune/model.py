"""The plan-selection record every layer is parameterized through.

Only the record is ported so far. The analytical tuner that fills it
from matrix features (``tune="model"``) and the empirical search
(``tune="search"``) wait for a Hopper cost model (ROADMAP queue 1
item 9); until then callers pass ``tune="off"`` or a literal
:class:`TuneConfig`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """One plan-selection decision.

    The plan-shaping fields keep the reference package's meaning, so a
    plan built here equals the reference plan for the same config:
    ``threshold``/``bk``/``ts_tile`` parameterize preprocessing (the
    2D-aware distribution) and ``ts``/``cs`` are the §4.3 Ts/Cs segment
    caps (None = operator default, 0 = no segmentation).

    ``kt``, ``nt``, ``kf_tile``, ``yt``, ``xt`` and ``grid_order`` are
    the TPU kernels' tiling knobs. The CUDA kernels ignore them: they
    gather rows straight from device memory and choose their own tiles.
    The fields stay so one config describes a plan in both packages.
    """

    kt: int = 512
    nt: int = 128
    kf_tile: int = 128
    yt: int | None = None
    xt: int | None = None
    threshold: int | None = None  # TC/VPU split (None = operator default)
    bk: int | None = None    # condensed block depth (None = operator default)
    ts_tile: int | None = None    # VPU tile width (None = operator default)
    ts: int | None = None    # max TC blocks per segment (paper Ts)
    cs: int | None = None    # max VPU elements per row-segment (paper Cs)
    grid_order: str = "n_outer"
    source: str = "default"

    def replace(self, **kw) -> "TuneConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_TUNE = TuneConfig()
