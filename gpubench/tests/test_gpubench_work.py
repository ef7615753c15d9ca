"""The yardstick's counts against hand counts."""
import pytest

from gpubench import cells, work

ARXIV_N, ARXIV_NNZ = 169_343, 2_291_338


def test_spmm_work_by_hand():
    # m=3, k=4, nnz=5, n=2: pattern 4*4 + 5*4, values 5*4, B 4*2*4, C 3*2*4.
    flops, nbytes = work.spmm_work(3, 4, 5, 2)
    assert flops == 2 * 5 * 2
    assert nbytes == 16 + 20 + 20 + 32 + 24


def test_sddmm_work_by_hand():
    # X 3x2, Y 4x2, 5 output values.
    flops, nbytes = work.sddmm_work(3, 4, 5, 2)
    assert flops == 2 * 5 * 2
    assert nbytes == 16 + 20 + 24 + 32 + 20


def test_spmm_work_at_the_cells_size():
    flops, nbytes = work.spmm_work(ARXIV_N, ARXIV_N, ARXIV_NNZ, 256)
    assert round(nbytes / 1e6, 1) == 365.8
    assert round(flops / 1e9, 3) == 1.173
    # Memory-bound: 0.109 ms at 3.35 TB/s.
    assert work.bound_s(flops, nbytes) == pytest.approx(nbytes / 3.35e12)
    assert round(work.bound_s(flops, nbytes) * 1e3, 3) == 0.109


def test_bound_takes_the_larger_term():
    assert work.bound_s(495e12, 1.0) == pytest.approx(1.0)
    assert work.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def _step_flops(kind, n, nnz, dims):
    return cells.model_kind({"model": kind}).step_flops(n, nnz,
                                                        {"dims": dims})


def test_gcn_step_flops_by_hand():
    n, nnz, dims = 10, 7, [3, 4, 2]
    first = 2 * (2 * n * 3 * 4) + 2 * (2 * nnz * 4)
    second = 3 * (2 * n * 4 * 2) + 2 * (2 * nnz * 2)
    assert _step_flops("gcn", n, nnz, dims) == first + second


def test_agnn_step_flops_by_hand():
    n, nnz, dims = 10, 7, [3, 4, 2]
    # layer 0 (d=3): SDDMM, SpMM, HW; dW, d(agg), SDDMM for the values.
    first = 3 * (2 * nnz * 3) + 3 * (2 * n * 3 * 4)
    # layer 1 (d=4): as layer 0 plus Aᵀ, dX and dY of the SDDMM.
    second = 6 * (2 * nnz * 4) + 3 * (2 * n * 4 * 2)
    assert _step_flops("agnn", n, nnz, dims) == first + second


def test_step_flops_at_the_cells_size():
    dims = [128, 256, 256, 40]
    assert round(_step_flops("gcn", ARXIV_N, ARXIV_NNZ, dims) / 1e9, 1) \
        == 104.2
    assert round(_step_flops("agnn", ARXIV_N, ARXIV_NNZ, dims) / 1e9, 1) \
        == 126.1
