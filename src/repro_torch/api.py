"""`ExecSpec`: the one execution-knob surface for every operator.

Plan shape (``mode``, thresholds, ``bk``, ``ts_tile``, ``reorder``,
``tune``) keeps the reference package's meaning and defaults, so the
same spec builds the same plan in both packages; tuning prices the plan
for the H100 (:mod:`repro_torch.tune`). Execution differs:

* ``backend="cuda"`` (default) runs the hand-written Hopper kernels over
  the §4.3 segment launch tables (the reference's ``"pallas"``);
* ``backend="torch"`` runs the plain PyTorch path over the compact
  per-block/per-tile tables (the reference's ``"xla"``);
* ``device`` says where plans and outputs live. It defaults to
  ``"cuda"``; asking for the card where none exists raises
  :class:`RuntimeError` instead of running on the CPU.

On a CPU ``device`` the kernel wrappers run their plain twins, which is
how the CPU tests exercise the ``"cuda"`` backend's dispatch. The port
never had the reference's legacy per-operator kwargs, so it has no
``resolve_spec`` shim: every operator takes ``spec=`` alone.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.tune.model import TuneConfig

BACKENDS = ("cuda", "torch")
B_LAYOUTS = ("replicated", "rowshard")
_REORDER_MODES = ("auto", "on", "off")
_TUNE_MODES = ("model", "search", "off")


@dataclasses.dataclass(frozen=True)
class ExecSpec:
    """Frozen, hashable execution spec.

    Plan shape:
      mode:             "hybrid" | "tcu" | "vpu" (paper §5.4.1 ablations)
      threshold:        SpMM TC/VPU vector threshold (None → tuner/default)
      sddmm_threshold:  SDDMM block threshold (None → tuner/default)
      bk / ts_tile:     condensed block depth / VPU tile width overrides
      reorder:          "auto" | "on" | "off" — row reordering
                        (:mod:`repro_torch.reorder`); "auto" prices the
                        permutation from the matrix features and caches
                        the decision in the PlanCache (or a process memo)

    Tuning:
      tune:             "model" | "search" | "off" | TuneConfig
      tune_backend:     backend the empirical search times ("cuda" times
                        the kernels on the card, "torch" the plain path)
      tune_n / tune_kf: dense width the tuner prices (SpMM B columns /
                        SDDMM feature dim)
      tune_cache:       PlanCache instance or cache-dir path (None → the
                        default root, :mod:`repro_torch.tune.cache`)

    Execution:
      backend:          "cuda" (kernels) | "torch" (plain path)
      device:           where plan tables and outputs live
      b_layout:         dense-operand layout for sharded ops
                        ("replicated" | "rowshard")
    """

    mode: str = "hybrid"
    threshold: int | None = None
    sddmm_threshold: int | None = None
    bk: int | None = None
    ts_tile: int | None = None
    reorder: str = "off"
    tune: str | TuneConfig = "model"
    tune_backend: str = "cuda"
    tune_n: int = 128
    tune_kf: int = 128
    tune_cache: Any = None
    backend: str = "cuda"
    device: str = "cuda"
    b_layout: str = "replicated"

    def __post_init__(self):
        if self.mode not in ("hybrid", "tcu", "vpu"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.reorder not in _REORDER_MODES:
            raise ValueError(
                f"reorder must be one of {_REORDER_MODES}, got "
                f"{self.reorder!r}")
        if not (isinstance(self.tune, TuneConfig)
                or self.tune in _TUNE_MODES):
            raise ValueError(
                f"tune must be one of {_TUNE_MODES} or a TuneConfig, got "
                f"{self.tune!r}")
        for name in ("backend", "tune_backend"):
            if getattr(self, name) not in BACKENDS:
                raise ValueError(
                    f"{name} must be one of {BACKENDS}, got "
                    f"{getattr(self, name)!r}")
        if self.b_layout not in B_LAYOUTS:
            raise ValueError(
                f"b_layout must be one of {B_LAYOUTS}, got "
                f"{self.b_layout!r}")

    def replace(self, **kw) -> "ExecSpec":
        return dataclasses.replace(self, **kw)

    def torch_device(self) -> torch.device:
        """The spec's device, checked: a CUDA device needs a card."""
        return checked_device(self.device, f"ExecSpec(device={self.device!r})")


def checked_device(device, who: str = "device") -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device needs a card.

    Every entry point of the port defaults to ``"cuda"`` and goes through
    this check, so without a card it raises instead of running on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} asks for a CUDA device but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain path on the CPU")
    return dev
