"""K5's plain twin and the port's attention layer against the reference.

The twin (``repro_torch.kernels.flash_attention.flash_attention_ref``) is
what the CUDA kernel is held to on the card, so here it is held to the
reference's Pallas kernel in interpret mode on the cases of
``tests/test_flash_attention.py`` plus bf16 ones, and the port's
``layers.flash_attention`` (which runs the twin on CPU tensors) to the
reference's ``layers.flash_attention`` with GQA, window, softcap and a
query offset. Tolerances: 2e-3 (rtol and atol) in fp32, where the two
sides differ only in block size and summation order; 2e-2 in fp16 and
bf16, where ``p`` is rounded to V's type per block and the two sides
cut blocks differently (32 keys against the twin's 64).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.models import layers as jL
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import layers as tL

CASES = [
    # b, sq, sk, h, kv, d, causal, window, softcap, dtype
    (1, 128, 128, 4, 4, 64, True, 0, 0.0, "float32"),
    (2, 64, 64, 4, 2, 32, True, 0, 0.0, "float32"),
    (1, 96, 96, 8, 1, 64, True, 48, 0.0, "float32"),   # MQA + window
    (1, 64, 64, 4, 2, 64, True, 0, 50.0, "float32"),   # softcap
    (2, 80, 80, 2, 2, 32, True, 0, 0.0, "float32"),    # non-multiple len
    (1, 64, 64, 4, 4, 64, True, 0, 0.0, "float16"),    # low precision
    (1, 96, 96, 4, 2, 64, True, 32, 50.0, "bfloat16"),  # gemma2's options
    (1, 72, 72, 8, 1, 32, False, 0, 0.0, "bfloat16"),  # MQA, not causal
]
TOL = {"float32": 2e-3, "float16": 2e-2, "bfloat16": 2e-2}


def _inputs(seed, b, sq, sk, h, kv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, d)).astype(np.float32))


def _both(arrays, dtype):
    """The same values in both packages: fp32 → dtype rounds to nearest
    even on both sides."""
    return ([jnp.asarray(a).astype(dtype) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _close(out, want, tol):
    out = out.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_twin_matches_pallas_kernel(case):
    b, sq, sk, h, kv, d, causal, window, softcap, dt = case
    (jq, jk, jv), (q, k, v) = _both(_inputs(1, b, sq, sk, h, kv, d), dt)
    want = jfa.flash_attention_fused(jq, jk, jv, causal=causal,
                                     window=window, softcap=softcap,
                                     bq=32, bk=32, interpret=True)
    out = tfa.flash_attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=softcap)
    assert out.dtype == q.dtype
    _close(out, want, TOL[dt])
    # On CPU tensors the wrapper is the twin, and it launches nothing.
    tfa.flash_attention_fused.launches = 0
    same = tfa.flash_attention_fused(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    assert torch.equal(same, out) and tfa.flash_attention_fused.launches == 0


@pytest.mark.parametrize("window,softcap,q_offset,dt", [
    (None, 0.0, 0, "float32"),
    (24, 50.0, 0, "float32"),
    (24, 50.0, 0, "bfloat16"),
    (None, 30.0, 40, "float32"),     # queries 40..71 over 72 keys
    (16, 0.0, 40, "float32"),
])
def test_layer_matches_reference_layer(window, softcap, q_offset, dt):
    sk = 72
    sq = sk - q_offset
    (jq, jk, jv), (q, k, v) = _both(_inputs(2, 2, sq, sk, 8, 2, 32), dt)
    want = jL.flash_attention(jq, jk, jv, causal=True, window=window,
                              softcap_val=softcap, chunk=32,
                              q_offset=q_offset)
    out = tL.flash_attention(q, k, v, causal=True, window=window,
                             softcap_val=softcap, chunk=32,
                             q_offset=q_offset)
    _close(out, want, TOL[dt])
    plain = tfa.flash_attention_ref(
        q, k, v, causal=True, window=sk + sq + 1 if window is None else window,
        softcap=softcap, q_offset=q_offset)
    assert torch.equal(plain, out)


def test_layer_calls_the_kernel_wrapper(monkeypatch):
    """The layer hands every call to K5's wrapper (the kernel on the card),
    with ``window=None`` as the reference's unbounded ``Sk + Sq + 1``."""
    calls = []

    def spy(q, k, v, **kw):
        calls.append(kw)
        return q

    monkeypatch.setattr(tL, "flash_attention_fused", spy)
    q, k = torch.zeros(1, 5, 2, 8), torch.zeros(1, 7, 1, 8)
    assert tL.flash_attention(q, k, k, causal=True) is q
    tL.flash_attention(q, k, k, causal=False, window=3, softcap_val=50.0,
                       q_offset=2, chunk=4, remat_chunks=False)
    assert calls == [
        dict(causal=True, window=13, softcap=0.0, q_offset=0),
        dict(causal=False, window=3, softcap=50.0, q_offset=2)]


def test_skipped_blocks_change_nothing(monkeypatch):
    """Window and causal skipping against the same twin walking every key
    block: fully masked blocks only add garbage that the next rescale
    wipes, so the results are equal bit for bit."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 200, 200, 4, 2, 16))
    skipped = tfa.flash_attention_ref(q, k, v, causal=True, window=40,
                                      softcap=50.0)
    monkeypatch.setattr(tfa, "_key_blocks",
                        lambda sq, sk, block_k, **kw: range(0, sk, block_k))
    full = tfa.flash_attention_ref(q, k, v, causal=True, window=40,
                                   softcap=50.0)
    assert torch.equal(skipped, full)


@pytest.mark.parametrize("args", [
    dict(b=16, sq=4096, sk=4096, h=64, kv=4, d=128, chunk=1024),
    dict(b=1, sq=8192, sk=8192, h=16, kv=8, d=256, chunk=1024),
    dict(b=2, sq=100, sk=300, h=6, kv=3, d=64, chunk=64, dtype_bytes=4),
])
def test_traffic_model_equals_reference(args):
    assert tfa.hbm_traffic_model(**args) == jfa.hbm_traffic_model(**args)
