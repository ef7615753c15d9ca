"""Threshold tuner (paper §4.2.2, Fig. 11), priced for the H100.

The distribution threshold is a *hardware* property, not a matrix
property: Tensor Core practical throughput ≈ peak × density, so the
break-even density where the Tensor Cores beat the CUDA cores depends on
the ratio of unit throughputs and the data-reuse factor — both fixed per
chip.

Two tuners, with the reference package's formulas word for word:

* :func:`analytic_threshold` — closed-form from the hardware model. For a
  vector of ``c`` non-zeros the Tensor Core stream spends the full 8-wide
  MAC column (8 MACs at its rate, reuse-free B traffic amortized k-fold);
  the CUDA-core stream spends ``c`` MACs at its rate plus ``c`` B-row
  loads. Break-even: ``c* ≈ 8 × (vpu_rate/mxu_rate) × mem_penalty``.
* :func:`empirical_threshold` — measure a calibration matrix at every
  threshold (paper's Fig. 11 protocol) and return the times.

:class:`HardwareModel` keeps the reference's field names: ``mxu_*`` is
the Tensor Core stream (K1/K3) and ``vpu_*`` the CUDA-core stream
(K2/K4), as the port's kernel files name them.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.formats import WINDOW


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Per-chip capability model (defaults: NVIDIA H100 SXM data sheet,
    dense rates at the 700 W limit)."""

    mxu_tflops: float = 495.0   # TF32 Tensor Core peak (K1/K3 compute TF32)
    vpu_tflops: float = 67.0    # fp32 CUDA-core peak (K2/K4)
    hbm_gbps: float = 3350.0
    ici_gbps: float = 450.0     # NVLink, one direction

    @property
    def unit_ratio(self) -> float:
        return self.mxu_tflops / self.vpu_tflops


#: The reference package's default model (TPU v5e), for parity tests.
TPU_V5E = HardwareModel(mxu_tflops=197.0, vpu_tflops=13.0, hbm_gbps=819.0,
                        ici_gbps=50.0)


def synchronize() -> None:
    """Wait until the card has run everything queued on it. Kernel
    launches return before the work is done, so a host clock read after
    this times the device; without CUDA in use there is nothing queued."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def analytic_threshold(hw: HardwareModel = HardwareModel(),
                       reuse_discount: float = 2.0) -> int:
    """Break-even NNZ per 8×1 vector.

    Tensor Core cost/vector ≈ WINDOW/mxu_rate (pays all 8 rows regardless
    of density). CUDA-core cost/vector ≈ c/vpu_rate × reuse_discount (it
    re-loads a B row per non-zero; ``reuse_discount`` folds the paper's
    R_spmm memory term into compute units). Equal at
    c* = WINDOW × (vpu/mxu) × reuse_discount — clamped to [1, WINDOW].
    """
    c_star = WINDOW * (hw.vpu_tflops / hw.mxu_tflops) * reuse_discount * WINDOW / 2
    return int(np.clip(round(c_star), 1, WINDOW))


def model_spmm_time(plan, n: int, hw: HardwareModel = HardwareModel()) -> float:
    """Modeled execution time of a hybrid SpMM plan (seconds).

    The two streams are priced as if they ran concurrently, so
    t = max(t_mxu, t_vpu), each stream roofline-limited by
    max(compute, memory); the combine is not priced:

    * the Tensor Core stream pays the *padded* FLOPs (8×bk blocks
      regardless of density — the paper's computational redundancy) at
      its rate, and gathers bk B-rows per block once (the data-reuse
      win);
    * the CUDA-core stream pays exact-nnz FLOPs at its rate but gathers
      one B-row per non-zero (no reuse).
    """
    nb = plan.tc.nblk if plan.meta["tc_nnz"] else 0
    bk = plan.tc.bk
    flops_mxu = 2.0 * nb * 8 * bk * n
    bytes_mxu = 4.0 * nb * bk * n + 4.0 * nb * 8 * bk
    t_mxu = max(flops_mxu / (hw.mxu_tflops * 1e12),
                bytes_mxu / (hw.hbm_gbps * 1e9))
    nnz_v = plan.meta["vpu_nnz"]
    flops_vpu = 2.0 * nnz_v * n
    bytes_vpu = 4.0 * nnz_v * n
    t_vpu = max(flops_vpu / (hw.vpu_tflops * 1e12),
                bytes_vpu / (hw.hbm_gbps * 1e9))
    return max(t_mxu, t_vpu) + 1e-9


def model_sddmm_time(plan, kf: int, hw: HardwareModel = HardwareModel()) -> float:
    """Modeled time of a hybrid SDDMM plan (seconds).

    Tensor Core stream: each 8×bk block computes (8, kf)·(kf, bk) —
    full-tile FLOPs regardless of block density (the redundancy term),
    but X/Y rows are loaded once per block (the reuse term, Eq. 3).
    CUDA-core stream: one X-row + one Y-row load and a kf-MAC dot per
    isolated element.
    """
    nb = plan.tc.nblk if plan.meta["tc_nnz"] else 0
    bk = plan.tc.bk
    flops_mxu = 2.0 * nb * 8 * bk * kf
    bytes_mxu = 4.0 * nb * (8 + bk) * kf
    t_mxu = max(flops_mxu / (hw.mxu_tflops * 1e12),
                bytes_mxu / (hw.hbm_gbps * 1e9))
    nnz_v = plan.meta["vpu_nnz"]
    flops_vpu = 2.0 * nnz_v * kf
    bytes_vpu = 8.0 * nnz_v * kf  # both operand rows per element
    t_vpu = max(flops_vpu / (hw.vpu_tflops * 1e12),
                bytes_vpu / (hw.hbm_gbps * 1e9))
    return max(t_mxu, t_vpu) + 1e-9


def modeled_best_sddmm_threshold(a, kf: int = 32,
                                 hw: HardwareModel = HardwareModel(),
                                 thresholds=(1, 8, 16, 24, 32, 48, 64, 129)
                                 ) -> dict:
    from repro_torch.core import preprocess

    return {int(t): model_sddmm_time(preprocess.preprocess_sddmm(a, t), kf,
                                     hw)
            for t in thresholds}


def modeled_best_threshold(a, n: int = 128,
                           hw: HardwareModel = HardwareModel(),
                           thresholds=range(1, WINDOW + 2)) -> dict:
    """Sweep thresholds through the cost model; returns modeled seconds."""
    from repro_torch.core import preprocess

    return {int(t): model_spmm_time(preprocess.preprocess_spmm(a, t), n, hw)
            for t in thresholds}


def empirical_threshold(make_op, apply_op, thresholds, reps: int = 3) -> dict:
    """Sweep thresholds on a calibration op; returns {threshold: seconds}.

    ``make_op(threshold)`` builds the operator; ``apply_op(op)`` runs one
    iteration. The card is synchronized after the warm-up and after the
    timed iterations, so the host clock times the device's work.
    """
    out = {}
    for t in thresholds:
        op = make_op(t)
        apply_op(op)  # warm-up: first upload of the plan tables
        synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            apply_op(op)
        synchronize()
        out[int(t)] = (time.perf_counter() - t0) / reps
    return out
