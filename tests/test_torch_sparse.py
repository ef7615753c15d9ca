"""The port's matrix generators equal the reference package's, seed for seed.

Every later parity test feeds both packages the same matrix, so this is
the foundation: identical ``indptr``/``indices``/``data`` arrays.
"""
import numpy as np
import pytest

from repro import sparse as jsparse
from repro.sparse import generate as jgen
from repro_torch import sparse as tsparse
from repro_torch.sparse import generate as tgen

GENERATORS = [
    ("random_uniform_csr", (300, 200, 0.02), {"seed": 3}),
    ("power_law_csr", (256, 300, 9.0), {"seed": 4}),
    ("power_law_csr", (300, 300, 5.0), {"alpha": 2.2, "seed": 5}),
    ("banded_csr", (200, 180, 9, 0.8), {"seed": 6}),
    ("banded_csr", (64, 64, 5), {}),
    ("block_structured_csr", (256, 256),
     {"block": 8, "block_density": 0.05, "fill": 0.9, "seed": 7}),
    ("mixed_csr", (320, 320), {"seed": 8}),
    ("mixed_csr", (100, 77), {"seed": 9}),
]


def _same(a, b):
    assert (a.m, a.k) == (b.m, b.k)
    for name in ("indptr", "indices", "data"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("name,args,kw", GENERATORS,
                         ids=[f"{g[0]}-{i}" for i, g in enumerate(GENERATORS)])
def test_generator_identical(name, args, kw):
    _same(getattr(jgen, name)(*args, **kw), getattr(tgen, name)(*args, **kw))


def test_corpus_identical():
    ref = jgen.suitesparse_like_corpus(12)
    port = tgen.suitesparse_like_corpus(12)
    assert list(ref) == list(port)
    for key in ref:
        _same(ref[key], port[key])


def test_coo_to_csr_merges_duplicates_identically():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 20, 200).astype(np.int32)
    cols = rng.integers(0, 30, 200).astype(np.int32)
    data = rng.standard_normal(200).astype(np.float32)
    _same(jsparse.coo_to_csr(20, 30, rows, cols, data),
          tsparse.coo_to_csr(20, 30, rows, cols, data))


def test_dense_and_coo_views_match():
    a = tgen.mixed_csr(48, 40, seed=2)
    r = jgen.mixed_csr(48, 40, seed=2)
    np.testing.assert_array_equal(a.to_dense(), r.to_dense())
    for x, y in zip(a.to_coo(), r.to_coo()):
        np.testing.assert_array_equal(x, y)
    _same(tsparse.SparseCSR.from_dense(a.to_dense()),
          jsparse.SparseCSR.from_dense(r.to_dense()))
