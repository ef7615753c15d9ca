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
import math

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
    # The families' shapes, small: whisper's cross attention (non-causal,
    # Sq != Sk, a ragged last key block), zamba2's head dim 112 with its
    # window, qwen2-vl's seven query heads a KV head (28/4).
    "cross_d112": (2, 24, 75, 2, 2, 112, False, None, 0.0, 0, 32),
    "window_d112": (1, 72, 72, 2, 2, 112, True, 24, 0.0, 0, 32),
    "gqa_7": (1, 40, 40, 14, 2, 16, True, None, 0.0, 0, 16),
    # One chunk holds every key: Δ from P and dP (whisper's decoder).
    "one_chunk": (2, 48, 48, 4, 2, 16, True, None, 0.0, 0, 64),
    "one_chunk_softcap": (1, 40, 40, 4, 2, 16, True, 24, 50.0, 0, 64),
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
    grads = fa.flash_attention_bwd_ref(q, k, v, lse, ct, causal=True,
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


@pytest.mark.parametrize("causal,window,q_offset", [
    (False, None, 0), (False, 20, 0), (True, None, 0), (True, 20, 0),
    (True, 40, 32), (False, 33, 5)])
def test_visible_rows_hold_every_row_that_sees_the_chunk(causal, window,
                                                         q_offset):
    """``_visible_rows`` against the mask itself: every query row with an
    unmasked key in a chunk lies in the chunk's ``[lo, hi)``, and the
    rows it leaves out see none. A non-causal call whose window is the
    layers' ``sk + sq + 1`` (whisper's encoder and cross attention) keeps
    every row of every chunk."""
    sq, sk, chunk = 30, 75, 16
    window = sk + sq + 1 if window is None else window
    qpos = q_offset + np.arange(sq)[:, None]
    kpos = np.arange(sk)[None, :]
    mask = kpos > qpos - window
    if causal:
        mask &= kpos <= qpos
    for k0 in range(0, sk, chunk):
        k1 = min(k0 + chunk, sk)
        lo, hi = fa._visible_rows(k0, k1, sq, causal=causal, window=window,
                                  q_offset=q_offset)
        rows = np.flatnonzero(mask[:, k0:k1].any(1))
        assert all(lo <= r < hi for r in rows), (k0, lo, hi, rows)
        if not causal and window == sk + sq + 1:
            assert (lo, hi) == (0, sq)


@pytest.mark.parametrize("chunk", [128, 96, 48, 32, 16])
def test_one_chunk_backward_holds_near_uniform_attention(chunk):
    """Δ is the softmax's own ``rowsum(P∘dP)`` in fp32, whether one chunk
    holds every key (128, 96) or the keys span several (48, 32, 16).
    Values that share one large component (near-uniform attention over
    similar values, as in whisper's decoder at random weights) make
    ``dP - Δ`` cancel; ``rowsum(dO∘O)`` over the bf16 ``O`` then puts dQ
    and dK about 10% of max|ref| from the exact gradient here (an fp32 O
    summed from bf16 P still lands beyond the bound), where this Δ keeps
    every gradient within 1e-2·max|ref| of autograd through the twin in
    fp32 on the same bf16 values (0.23% the worst measured, the final
    cast to bf16)."""
    rng = np.random.default_rng(5)
    b, s, h, d = 2, 96, 4, 32
    q, k = (0.05 * rng.standard_normal((b, s, h, d)) for _ in range(2))
    v = (4 * rng.standard_normal((1, 1, h, d))
         + 0.1 * rng.standard_normal((b, s, h, d)))
    ct = rng.standard_normal((b, s, h, d))
    q, k, v, ct = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                   for a in (q, k, v, ct))
    exact = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_ref(*exact, causal=True),
                               exact, ct.float())
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention_grad(*ins, causal=True,
                                                      chunk=chunk), ins, ct)
    for label, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16, label
        torch.testing.assert_close(g.float(), w, rtol=0,
                                   atol=1e-2 * w.abs().max().item(),
                                   msg=label)


@pytest.mark.parametrize("s", [96, 512])
def test_delta_from_an_fp32_o_over_bf16_p_misses_the_bound(s):
    """Why the backward takes Δ = rowsum(P∘dP) in a pass over the keys
    and not rowsum(dO∘O) from an fp32 O written by the forward.

    On the near-uniform attention of the test above, K5's fp32 O (the
    twin's accumulator over bf16 P, divided by the row sum of the fp32 P)
    gives a Δ that puts dQ or dK beyond 1e-2·max|ref| of autograd through
    the twin in fp32, at every length: the bf16 rounding of P does not
    cancel against the fp32 sum it is divided by. The backward's own Δ
    (chunks of 32 keys, so the pass ahead of the loop) stays within. The
    same accumulator divided by the row sum of the bf16 P it summed lands
    within as well: a forward that wrote that O could give the backward
    its Δ without the pass."""
    rng = np.random.default_rng(5)
    b, h, d = 2, 4, 32
    q, k = (0.05 * rng.standard_normal((b, s, h, d)) for _ in range(2))
    v = (4 * rng.standard_normal((1, 1, h, d))
         + 0.1 * rng.standard_normal((b, s, h, d)))
    ct = rng.standard_normal((b, s, h, d))
    q, k, v, ct = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                   for a in (q, k, v, ct))
    exact = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_ref(*exact, causal=True),
                               exact, ct.float())

    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, ct))
    scores = (qf @ kf.transpose(-1, -2)) / math.sqrt(d)
    scores = scores.masked_fill(
        ~torch.ones(s, s, dtype=torch.bool).tril(), -math.inf)
    p = torch.softmax(scores, -1)
    dp = dof @ vf.transpose(-1, -2)

    def worst(delta):
        """max|Δ| of dQ and dK over max|ref|, with this Δ."""
        ds = p * (dp - delta)
        dq = (ds @ kf / math.sqrt(d)).transpose(1, 2)
        dk = (ds.transpose(-1, -2) @ qf / math.sqrt(d)).transpose(1, 2)
        return max(((g - w).abs().max() / w.abs().max()).item()
                   for g, w in ((dq, want[0]), (dk, want[1])))

    # K5's arithmetic: P·V over bf16 P in fp32, the twin with fp32 Q, K.
    o32 = fa.flash_attention_ref(q.float(), k.float(), v, causal=True)
    assert o32.dtype == torch.float32
    assert worst((dof * o32.transpose(1, 2)).sum(-1, keepdim=True)) > 1e-2
    p16 = torch.exp(scores - scores.amax(-1, keepdim=True)).to(
        torch.bfloat16).float()
    o_used = (p16 @ vf) / p16.sum(-1, keepdim=True)
    assert worst((dof * o_used).sum(-1, keepdim=True)) < 1e-2

    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention_grad(*ins, causal=True,
                                                      chunk=32), ins, ct)
    for label, g, w in zip("qk", got, want):
        assert (g.float() - w).abs().max() <= 1e-2 * w.abs().max(), label
