"""Operations, bytes and peaks: the yardstick behind every roofline and
utilization the benchmark reports.

The work of an operator is counted from the graph and the widths, never
from a plan, so it stays the same whatever implements the operator:

* bytes: the CSR pattern (``int32`` row pointers and column indices),
  the edge values, each dense operand and the output, each once;
* operations: ``2 · nnz · width`` (a multiply and an add per edge and
  column).

A model step's operations are the dense and sparse products its
equations need, forward and backward (see :func:`gcn_step_flops` and
:func:`agnn_step_flops`); elementwise work (norms, softmax, ReLU, the
loss) is not counted.
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


def _dense(n: int, d_in: int, d_out: int) -> float:
    return 2.0 * n * d_in * d_out


def gcn_step_flops(n: int, nnz: int, dims: list[int]) -> float:
    """One full-batch GCN step, ``H' = A(v) (H W)`` a layer.

    Forward: ``H W`` and the SpMM at ``d_out``. Backward: the SpMM on
    Aᵀ at ``d_out``, ``dW = Hᵀ dY`` and, except for the first layer,
    whose input (the features) needs no gradient, ``dH = dY Wᵀ``. The
    edge values are constants: no SDDMM."""
    total = 0.0
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        dense = _dense(n, d_in, d_out)
        total += dense * (2 if i == 0 else 3)
        total += 2 * (2.0 * nnz * d_out)
    return total


def agnn_step_flops(n: int, nnz: int, dims: list[int]) -> float:
    """One full-batch AGNN step. A layer at input width ``d``:
    scores by SDDMM over the normalised ``H`` (``d``), the SpMM of the
    attention over ``H`` (``d``), then ``H W``.

    Backward: ``dW`` and ``d(agg) = dZ Wᵀ``; the SpMM's value gradient
    (an SDDMM at ``d``), needed for β in every layer. From the second
    layer on, ``H`` needs a gradient too: the SpMM on Aᵀ at ``d``
    and both SpMMs of the SDDMM's backward at ``d``. The first layer's
    input is the features, which need none."""
    total = 0.0
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        sparse = 2.0 * nnz * d_in
        dense = _dense(n, d_in, d_out)
        total += 2 * sparse + dense          # forward
        total += 2 * dense + sparse          # dW, d(agg), d(attention)
        if i > 0:
            total += 3 * sparse              # dH through Aᵀ, dX, dY
    return total


STEP_FLOPS = {"gcn": gcn_step_flops, "agnn": agnn_step_flops}
