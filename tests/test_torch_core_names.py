"""The reference's public names of the core modules, in the port, value
for value on the corpus generators: the §4.2 redundancy ratios and the
SpMM split (``core/distribution.py``), Fig. 1's ``nnz1_fraction``
(``core/windows.py``), the loop-form preprocessing
(``core/preprocess.py`` ``preprocess_spmm_loop``) and the single-
resource thresholds (``core/spmm.py``/``core/sddmm.py``
``threshold_for_mode``). Integer and boolean results must be equal;
floats too, since both sides run the same numpy arithmetic."""
import dataclasses

import numpy as np
import pytest

from repro.core import distribution as jdist
from repro.core import preprocess as jpre
from repro.core import sddmm as jsddmm
from repro.core import spmm as jspmm
from repro.core import windows as jwin
from repro.sparse.generate import suitesparse_like_corpus
from repro_torch.core import distribution as tdist
from repro_torch.core import preprocess as tpre
from repro_torch.core import sddmm as tsddmm
from repro_torch.core import spmm as tspmm
from repro_torch.core import windows as twin
from repro_torch.core.formats import WINDOW

CORPUS = suitesparse_like_corpus(12)
NAMES = sorted(CORPUS)


def test_reuse_ratios():
    nnz = np.array([0, 8, 24, 1000])
    np.testing.assert_array_equal(tdist.r_spmm(nnz, 4),
                                  jdist.r_spmm(nnz, 4))
    np.testing.assert_array_equal(tdist.r_sddmm(nnz, 8, 16),
                                  jdist.r_sddmm(nnz, 8, 16))
    assert tdist.r_spmm(8, 4) == 2.0 and tdist.r_sddmm(24, 8, 16) == 2.0


@pytest.mark.parametrize("name", NAMES)
def test_split_and_stats_equal_reference(name):
    a = CORPUS[name]
    tw, jw = twin.extract_windows(a), jwin.extract_windows(a)
    counts = np.concatenate([w.counts for w in jw]) if jw else np.zeros(0)
    for thr in (1, 2, 3, 6, WINDOW + 1):
        for t, j in zip(tw, jw):
            ts, js = tdist.split_spmm_window(t, thr), \
                jdist.split_spmm_window(j, thr)
            np.testing.assert_array_equal(ts.tc_idx, js.tc_idx)
            np.testing.assert_array_equal(ts.vpu_idx, js.vpu_idx)
        assert tdist.distribution_stats(counts, thr) == \
            jdist.distribution_stats(counts, thr)
    assert twin.nnz1_fraction(a) == jwin.nnz1_fraction(a)


def test_nnz1_fraction_regimes():
    from repro_torch.sparse import banded_csr, random_uniform_csr

    assert twin.nnz1_fraction(random_uniform_csr(256, 256, 0.002,
                                                 seed=9)) > 0.8
    assert twin.nnz1_fraction(banded_csr(256, 256, 16, 1.0, seed=9)) < 0.2


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("name", NAMES[::3])
def test_preprocess_spmm_loop_equals_reference(name):
    a = CORPUS[name]
    for thr in (1, 3):
        got, want = tpre.preprocess_spmm_loop(a, thr), \
            jpre.preprocess_spmm_loop(a, thr)
        for part in ("tc", "vpu"):
            g, w = _fields(getattr(got, part)), _fields(getattr(want, part))
            assert list(g) == list(w)
            for key in w:
                np.testing.assert_array_equal(np.asarray(g[key]),
                                              np.asarray(w[key]),
                                              err_msg=f"{part}.{key}")
        assert {k: v for k, v in got.meta.items() if k != "balance"} == \
            {k: v for k, v in want.meta.items() if k != "balance"}
        # and the loop form builds the vectorized form's tensors
        fast = tpre.preprocess_spmm(a, thr)
        np.testing.assert_array_equal(got.tc.vals, fast.tc.vals)
        np.testing.assert_array_equal(got.vpu.vals, fast.vpu.vals)


def test_threshold_for_mode_equals_reference():
    for mode in ("hybrid", "tcu", "vpu"):
        for thr in (None, 1, 5):
            assert tspmm.threshold_for_mode(mode, thr) == \
                jspmm.threshold_for_mode(mode, thr)
            for bk in (8, 16, 32):
                assert tsddmm.threshold_for_mode(mode, bk, thr) == \
                    jsddmm.threshold_for_mode(mode, bk, thr)
