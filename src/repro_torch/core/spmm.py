"""Public hybrid SpMM: the paper's headline operator, end to end.

Usage::

    op = LibraSpMM(a_csr)                     # preprocess + autotune once
    c = op(b)                                 # reuse every apply
    op = LibraSpMM(a, spec=ExecSpec(mode="tcu", device="cpu"))

Every knob lives on one frozen :class:`repro_torch.api.ExecSpec`. The
single-resource ablation modes (paper §5.4.1) are exposed through the
threshold: ``mode="tcu"`` forces every vector to the Tensor Core
stream, ``mode="vpu"`` everything to the CUDA-core stream, and
``mode="hybrid"`` uses the 2D-aware distribution.

Autotuning (``ExecSpec.tune``, paper §4.2's 2D-aware choices made per
matrix instead of hardcoded):

* ``tune="model"`` (default) — the analytical model in
  :mod:`repro_torch.tune` picks the Tensor Core / CUDA-core threshold
  from the matrix's vector histogram at the width ``tune_n``, the §4.3
  Ts/Cs segment caps and the residual tile width, priced with the H100's
  rates and checked against K1's shared-memory footprint. Cheap (one
  feature pass, no timing).
* ``tune="search"`` — times a small candidate grid through this apply
  path on ``tune_backend`` (``"cuda"``: the kernels on the card;
  ``"torch"``: the plain path) and keeps the argmin; memoized in the
  persistent :class:`~repro_torch.tune.cache.PlanCache`
  (``tune_cache=`` overrides the cache dir / instance), so constructing
  the same operator again never re-times. The hardcoded default config
  is always a candidate, so search can't lose to it.
* ``tune="off"`` — the hardcoded defaults.
* ``tune=TuneConfig(...)`` — exactly that config (expert escape hatch).

An explicit ``threshold`` (or a forcing ``mode``) always wins over the
tuner's threshold; the tuner then only sizes the rest. The chosen
config is ``op.tune_config``. ``ExecSpec.reorder`` ("auto"/"on"/"off")
runs the row reordering pass (:mod:`repro_torch.reorder`) before
planning; a reordered output is unpermuted by one gather and the
:class:`~repro_torch.reorder.Reordering` is ``op.reorder``.
"""
from __future__ import annotations

import torch

from repro_torch.api import ExecSpec
from repro_torch.core import preprocess
from repro_torch.core.balance import BalanceParams
from repro_torch.core.formats import PlanArrays, SpMMPlan
from repro_torch.core.windows import num_windows
from repro_torch.kernels.ops import apply_at, spmm_apply
from repro_torch.obs.ledger import apply_sampler, dtype_name
from repro_torch.sparse.matrix import SparseCSR
from repro_torch.tune.model import TuneConfig


def threshold_for_mode(mode: str, threshold: int | None = None) -> int:
    """The SpMM threshold that ``mode`` pins (the reference's name for
    :func:`repro_torch.core.preprocess.threshold_for_mode_spmm`)."""
    return preprocess.threshold_for_mode_spmm(mode, threshold)


class LibraSpMM:
    """Preprocess-once, apply-many hybrid SpMM operator."""

    def __init__(self, a: SparseCSR, *, spec: ExecSpec | None = None,
                 balance: BalanceParams | None = None):
        spec = ExecSpec() if spec is None else spec
        self.spec = spec
        self.device = spec.torch_device()
        self.m, self.k = a.shape
        self.nwin = num_windows(a.m)
        self.mode = spec.mode
        built = preprocess.Plan.build(a, "spmm", spec, balance=balance)
        self.tune_config: TuneConfig = built.cfg
        self.plan: SpMMPlan = built.plan
        self.reorder = built.reorder
        # One-gather unpermute epilogue: reordered output row
        # row_inv[j] is original row j.
        self._row_unperm = (None if built.reorder is None else
                            torch.from_numpy(built.reorder.row_inv).to(
                                self.device))
        self.arrays = PlanArrays(self.plan, self.device)
        # The apply keys (n, dtype, backend) used so far: see
        # kernels.ops.apply_at.
        self._apply_cache: set = set()
        # The matrix the plan was built on (the reordered view when
        # reordering applied: search entries are cached under its
        # signature), read only while a perf ledger is recording.
        self._a = built.a

    def __call__(self, b: torch.Tensor,
                 backend: str | None = None) -> torch.Tensor:
        if b.shape[0] != self.k:
            raise ValueError(f"b has {b.shape[0]} rows, A has {self.k} "
                             "columns")
        backend = self.spec.backend if backend is None else backend

        out = apply_at(
            self._apply_cache, (b.shape[1], str(b.dtype), backend),
            self.device, spmm_apply, self.arrays.for_backend(backend), b,
            m=self.m, nwin=self.nwin, backend=backend,
            sample=apply_sampler(self, "spmm", width=b.shape[1],
                                 dtype=dtype_name(b.dtype), backend=backend))
        if self._row_unperm is not None:
            out = out.index_select(0, self._row_unperm)
        return out

    @property
    def tc_ratio(self) -> float:
        """Fraction of non-zeros handled by the Tensor Core stream."""
        return self.plan.meta["tc_ratio"]
