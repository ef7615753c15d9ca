"""Attention under autograd: the port's ``FlashAttention`` Function (the
twin's forward with its logsumexp, and the chunked backward
``flash_attention_bwd_ref``) against the reference.

The reference has no attention backward of its own: it differentiates
its XLA scan (``repro.models.layers.flash_attention``), with the chunk
scores stored (``remat_chunks=False``) or recomputed (``True``). Both
are held here to the port's ``layers.flash_attention`` under grad, which
goes through the Function, on the same seeded numpy inputs and the same
random cotangent. Tolerances: fp32 inputs within 1e-4·max|ref| (fp32
sums in another order: the twin's 64-key blocks and the backward's
chunks against the scan's), bf16 inputs within 2e-2·max|ref| (the two
round P to bf16 at different points, and the port's backward keeps
fp32 throughout). The Function is also held to plain autograd through
the twin (1e-5·max|ref|, fp32), and the logsumexp to a float64 one of
the masked, softcapped scores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jL
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as tL

CASES = {
    # b, sq, sk, h, kv, d, causal, window, softcap, q_offset, chunk
    "causal": (2, 48, 48, 4, 2, 16, True, None, 0.0, 0, 16),
    "window": (1, 64, 64, 4, 2, 16, True, 20, 0.0, 0, 16),
    "softcap50": (1, 48, 48, 4, 2, 16, True, None, 50.0, 0, 16),
    "mqa": (1, 40, 40, 4, 1, 16, True, None, 0.0, 0, 16),
    "ragged_chunk": (2, 37, 37, 4, 2, 8, True, None, 0.0, 0, 16),
    "gemma2_like": (1, 70, 70, 4, 2, 16, True, 24, 50.0, 0, 16),
    "not_causal": (1, 30, 45, 2, 2, 8, False, None, 0.0, 0, 16),
    "q_offset": (1, 24, 56, 4, 2, 8, True, 40, 50.0, 32, 16),
}
REL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _no_leaked_activation_context():
    """The reference's layers outside any sharding activation context
    (``src/repro/train/train_step.py:33`` can leave one entered)."""
    from repro.dist import sharding

    sharding._ctx.state = None


def _arrays(seed, b, sq, sk, h, kv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d),
                      (b, sq, h, d))]


def _port_grads(arrays, dtype, case):
    b, sq, sk, h, kv, d, causal, window, cap, q_off, chunk = case
    q, k, v, ct = (torch.from_numpy(a).to(getattr(torch, dtype))
                   for a in arrays)
    for t in (q, k, v):
        t.requires_grad_(True)
    out = tL.flash_attention(q, k, v, causal=causal, window=window,
                             softcap_val=cap, chunk=chunk, q_offset=q_off)
    assert out.grad_fn is not None and "FlashAttention" in str(
        type(out.grad_fn))
    return out, torch.autograd.grad(out, (q, k, v), ct)


def _close(got, want, rel):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("remat_chunks", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_function_grads_match_jax_grad(name, dtype, remat_chunks):
    case = CASES[name]
    b, sq, sk, h, kv, d, causal, window, cap, q_off, chunk = case
    arrays = _arrays(1, b, sq, sk, h, kv, d)
    jq, jk, jv, jct = (jnp.asarray(a).astype(dtype) for a in arrays)

    def f(q, k, v):
        return jL.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap_val=cap, chunk=chunk,
                                  q_offset=q_off, remat_chunks=remat_chunks)

    jout, vjp = jax.vjp(f, jq, jk, jv)
    want = vjp(jct)
    out, got = _port_grads(arrays, dtype, case)
    _close(out.detach(), jout, REL[dtype])
    for label, g, w in zip("qkv", got, want):
        assert g.dtype == getattr(torch, dtype), label
        _close(g, w, REL[dtype])


@pytest.mark.parametrize("name", list(CASES))
def test_function_grads_match_autograd_through_twin(name):
    case = CASES[name]
    b, sq, sk, h, kv, d, causal, window, cap, q_off, chunk = case
    arrays = _arrays(2, b, sq, sk, h, kv, d)
    _, got = _port_grads(arrays, "float32", case)
    q, k, v, ct = (torch.from_numpy(a) for a in arrays)
    for t in (q, k, v):
        t.requires_grad_(True)
    ref = fa.flash_attention_ref(
        q, k, v, causal=causal, softcap=cap, q_offset=q_off,
        window=sk + sq + 1 if window is None else window)
    want = torch.autograd.grad(ref, (q, k, v), ct)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * w.abs().max().item())


@pytest.mark.parametrize("name", list(CASES))
def test_lse_matches_plain_logsumexp(name):
    b, sq, sk, h, kv, d, causal, window, cap, q_off, _ = CASES[name]
    window = 0 if window is None else window
    q, k, v, _ = _arrays(3, b, sq, sk, h, kv, d)
    out, lse = fa.flash_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window, softcap=cap, q_offset=q_off, return_lse=True)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    kr = np.repeat(k, h // kv, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kr) / np.sqrt(d)
    if cap:
        s = cap * np.tanh(s / cap)
    qpos = q_off + np.arange(sq)[:, None]
    kpos = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = np.where(mask, s, -np.inf)
    mx = s.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)


def test_rows_without_visible_keys():
    """Causal queries placed before every key (``q_offset`` -8): no row
    sees a key. The logsumexp is +inf, so P is 0 and every gradient is
    0, not NaN; a chunk hidden from every query adds nothing."""
    arrays = _arrays(4, 1, 8, 40, 2, 1, 8)
    q, k, v, ct = (torch.from_numpy(a) for a in arrays)
    _, lse = fa.flash_attention_ref(q, k, v, causal=True, q_offset=-8,
                                    return_lse=True)
    assert bool(torch.isinf(lse).all()) and bool((lse > 0).all())
    o = torch.zeros_like(q)
    grads = fa.flash_attention_bwd_ref(q, k, v, o, lse, ct, causal=True,
                                       q_offset=-8, chunk=16)
    for g in grads:
        assert bool(torch.isfinite(g).all()) and not bool(g.any())


def test_fused_under_grad_goes_through_the_function():
    """``flash_attention_fused`` given inputs that require grad returns
    the Function's output, equal to the call without grad, bit for bit."""
    q, k, v, _ = (torch.from_numpy(a) for a in _arrays(5, 1, 20, 20, 4, 2,
                                                        8))
    with torch.no_grad():
        want = fa.flash_attention_fused(q, k, v, causal=True, softcap=50.0)
    q.requires_grad_(True)
    out = fa.flash_attention_fused(q, k, v, causal=True, softcap=50.0)
    assert "FlashAttention" in str(type(out.grad_fn))
    assert torch.equal(out.detach(), want)
