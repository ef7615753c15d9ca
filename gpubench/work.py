"""Operations, bytes and peaks: the yardstick behind every roofline and
utilization the benchmark reports.

The work of an operator is counted from the graph and the widths, never
from a plan, so it stays the same whatever implements the operator:

* bytes: the CSR pattern (``int32`` row pointers and column indices),
  the edge values, each dense operand and the output, each once;
* operations: ``2 · nnz · width`` (a multiply and an add per edge and
  column).

A model step's operations are the dense and sparse products its
equations need, forward and backward, as its kind's ``step_flops``
counts them (``gpubench/models/<kind>.py``); elementwise work (norms,
softmax, ReLU, the loss) is not counted.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense rates (no sparsity).
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12

F32 = 4
I32 = 4


def pattern_bytes(m: int, nnz: int) -> int:
    """CSR row pointers (``m + 1``) and column indices, ``int32``."""
    return (m + 1) * I32 + nnz * I32


def spmm_work(m: int, k: int, nnz: int, n: int) -> tuple[float, int]:
    """(operations, bytes) of ``C = A(v) @ B``: A is ``m × k`` with
    ``nnz`` valued edges, B is ``k × n``, C is ``m × n``, all fp32."""
    flops = 2.0 * nnz * n
    nbytes = pattern_bytes(m, nnz) + nnz * F32 + k * n * F32 + m * n * F32
    return flops, nbytes


def sddmm_work(m: int, k: int, nnz: int, kf: int) -> tuple[float, int]:
    """(operations, bytes) of ``v[p] = <X[row_p], Y[col_p]>`` over A's
    pattern: X is ``m × kf``, Y is ``k × kf``, v has ``nnz`` values."""
    flops = 2.0 * nnz * kf
    nbytes = pattern_bytes(m, nnz) + m * kf * F32 + k * kf * F32 + nnz * F32
    return flops, nbytes


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_TF32_FLOPS,
            peak_bytes: float = PEAK_BYTES_PER_S) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(flops / peak_flops, nbytes / peak_bytes)


def dense_flops(n: int, d_in: int, d_out: int) -> float:
    """``(n × d_in) @ (d_in × d_out)``: a multiply and an add each."""
    return 2.0 * n * d_in * d_out
