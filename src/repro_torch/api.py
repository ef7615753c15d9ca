"""`ExecSpec`: the one execution-knob surface for every operator.

Plan shape (``mode``, thresholds, ``bk``, ``ts_tile``, ``tune``) keeps
the reference package's meaning, so the same spec builds the same plan
in both packages. Execution differs:

* ``backend="cuda"`` (default) runs the hand-written Hopper kernels over
  the §4.3 segment launch tables (the reference's ``"pallas"``);
* ``backend="torch"`` runs the plain PyTorch path over the compact
  per-block/per-tile tables (the reference's ``"xla"``);
* ``device`` says where plans and outputs live. It defaults to
  ``"cuda"``; asking for the card where none exists raises
  :class:`RuntimeError` instead of running on the CPU.

On a CPU ``device`` the kernel wrappers run their plain twins, which is
how the CPU tests exercise the ``"cuda"`` backend's dispatch.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tune.model import TuneConfig

BACKENDS = ("cuda", "torch")


@dataclasses.dataclass(frozen=True)
class ExecSpec:
    """Frozen, hashable execution spec.

    Plan shape:
      mode:             "hybrid" | "tcu" | "vpu" (paper §5.4.1 ablations)
      threshold:        SpMM TC/VPU vector threshold (None → default)
      sddmm_threshold:  SDDMM block threshold (None → default)
      bk / ts_tile:     condensed block depth / VPU tile width overrides
      reorder:          "off" | "on" (row reordering,
                        :mod:`repro_torch.reorder`; "auto": item 9)
      tune:             "off" | TuneConfig ("model"/"search": item 9)
      tune_n / tune_kf: SpMM / SDDMM dense width the model tuner prices;
                        no effect until that tuner is ported (item 9)

    Execution:
      backend:          "cuda" (kernels) | "torch" (plain path)
      device:           where plan tables and outputs live
    """

    mode: str = "hybrid"
    threshold: int | None = None
    sddmm_threshold: int | None = None
    bk: int | None = None
    ts_tile: int | None = None
    reorder: str = "off"
    tune: str | TuneConfig = "off"
    tune_n: int = 128
    tune_kf: int = 128
    backend: str = "cuda"
    device: str = "cuda"

    def __post_init__(self):
        if self.mode not in ("hybrid", "tcu", "vpu"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.reorder == "auto":
            raise NotImplementedError(
                "reorder='auto' is not ported yet: its decision is priced "
                "and cached with the tuner (ROADMAP queue 1 item 9); pass "
                "'off' or 'on'")
        if self.reorder not in ("off", "on"):
            raise ValueError(
                f"reorder must be 'off' or 'on', got {self.reorder!r}")
        if self.tune in ("model", "search"):
            raise NotImplementedError(
                f"tune={self.tune!r} is not ported yet (ROADMAP queue 1 "
                "item 9, Hopper tuner); pass 'off' or a TuneConfig")
        if not (self.tune == "off" or isinstance(self.tune, TuneConfig)):
            raise ValueError(
                f"tune must be 'off' or a TuneConfig, got {self.tune!r}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}")

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
