"""The threshold tuner and cost model (``repro_torch.core.threshold``)
against the reference's ``repro.core.threshold``: the paper's Fig.-11
structure under the port's H100 model, and the reference's numbers to
the bit under its own TPU v5e values (``TPU_V5E``), since the formulas
are the same word for word.
"""
import numpy as np
import pytest

from repro.core import preprocess as jpre
from repro.core import threshold as jthr
from repro.sparse import banded_csr, random_uniform_csr
from repro.sparse.generate import mixed_csr, power_law_csr
from repro_torch.core import preprocess as tpre
from repro_torch.core.formats import WINDOW
from repro_torch.core.threshold import (
    TPU_V5E,
    HardwareModel,
    analytic_threshold,
    empirical_threshold,
    model_sddmm_time,
    model_spmm_time,
    modeled_best_sddmm_threshold,
    modeled_best_threshold,
)
from repro_torch.sparse import SparseCSR

MATRICES = {
    "sparse": lambda: random_uniform_csr(256, 256, 0.002, seed=1),
    "banded": lambda: banded_csr(256, 256, 16, 1.0, seed=1),
    "mixed": lambda: mixed_csr(384, 384, seed=8),
    "powerlaw": lambda: power_law_csr(320, 288, 9.0, seed=4),
}


def _port(a):
    return SparseCSR(a.m, a.k, a.indptr, a.indices, a.data)


def test_tpu_values_are_the_reference_defaults():
    assert TPU_V5E == HardwareModel(**vars(jthr.HardwareModel()))
    assert TPU_V5E.unit_ratio == jthr.HardwareModel().unit_ratio


@pytest.mark.parametrize("hw", ["h100", "tpu"])
def test_analytic_threshold_in_range(hw):
    model = HardwareModel() if hw == "h100" else TPU_V5E
    t = analytic_threshold(model)
    assert 1 <= t <= WINDOW
    if hw == "tpu":
        assert t == jthr.analytic_threshold(jthr.HardwareModel())


@pytest.mark.parametrize("name", list(MATRICES))
def test_modeled_sweeps_equal_the_reference_under_its_model(name):
    a = MATRICES[name]()
    assert modeled_best_threshold(_port(a), n=128, hw=TPU_V5E) == \
        jthr.modeled_best_threshold(a, n=128)
    assert modeled_best_sddmm_threshold(_port(a), kf=32, hw=TPU_V5E) == \
        jthr.modeled_best_sddmm_threshold(a, kf=32)


@pytest.mark.parametrize("width", [40, 256])
@pytest.mark.parametrize("name", list(MATRICES))
def test_model_times_price_the_same_plans(name, width):
    a = MATRICES[name]()
    jp, tp = jpre.preprocess_spmm(a), tpre.preprocess_spmm(_port(a))
    assert model_spmm_time(tp, width, TPU_V5E) == \
        jthr.model_spmm_time(jp, width)
    jp, tp = jpre.preprocess_sddmm(a, 8), tpre.preprocess_sddmm(_port(a), 8)
    assert model_sddmm_time(tp, width, TPU_V5E) == \
        jthr.model_sddmm_time(jp, width)


@pytest.mark.parametrize("hw", ["h100", "tpu"])
def test_cost_model_monotone_regimes(hw):
    """Extreme-sparse matrices prefer the CUDA cores (high threshold);
    dense-banded ones prefer the Tensor Cores (low threshold)."""
    model = HardwareModel() if hw == "h100" else TPU_V5E
    m_sparse = modeled_best_threshold(_port(MATRICES["sparse"]()), n=128,
                                      hw=model)
    m_banded = modeled_best_threshold(_port(MATRICES["banded"]()), n=128,
                                      hw=model)
    assert m_banded[1] < m_banded[WINDOW + 1]
    assert m_sparse[WINDOW + 1] < m_sparse[1]


@pytest.mark.parametrize("hw", ["h100", "tpu"])
def test_hybrid_sweet_point_interior_for_mixed(hw):
    """Paper Fig. 11: a hybrid-regime matrix's optimum lies between the
    single-resource extremes."""
    model = HardwareModel() if hw == "h100" else TPU_V5E
    m = modeled_best_threshold(_port(MATRICES["mixed"]()), n=128, hw=model)
    best = min(m, key=m.get)
    assert m[best] <= m[1] and m[best] <= m[WINDOW + 1]
    assert m[best] < max(m[1], m[WINDOW + 1])


def test_model_time_positive_and_finite():
    plan = tpre.preprocess_spmm(_port(mixed_csr(128, 128, seed=2)))
    t = model_spmm_time(plan, 128)
    assert np.isfinite(t) and t > 0


def test_empirical_threshold_times_every_threshold():
    """The Fig.-11 protocol: one operator a threshold, a warm-up apply,
    then ``reps`` timed applies; the times are seconds per apply."""
    import torch

    from repro_torch.api import ExecSpec
    from repro_torch.core.spmm import LibraSpMM
    from repro_torch.tune.model import TuneConfig

    a = _port(mixed_csr(128, 128, seed=2))
    b = torch.ones(a.k, 16)
    made, applied = [], []

    def make_op(t):
        made.append(t)
        return LibraSpMM(a, spec=ExecSpec(tune=TuneConfig(threshold=t),
                                          device="cpu"))

    def apply_op(op):
        applied.append(op.plan.threshold)
        return op(b)

    out = empirical_threshold(make_op, apply_op, range(1, WINDOW + 2),
                              reps=2)
    assert sorted(out) == list(range(1, WINDOW + 2)) == made
    assert applied == [t for t in made for _ in range(3)]
    assert all(v > 0 for v in out.values())
