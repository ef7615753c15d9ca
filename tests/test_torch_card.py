"""K5 and the dense path on the card: the CUDA kernel against its twin.

These tests need an NVIDIA GPU (Hopper, ``sm_90a``) and ``nvcc``; they
are marked ``cuda`` and skip without a card. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

Tolerance: max|Δ| ≤ 2e-2·max|ref| (the repo's low-precision tolerance),
and on every row (last axis) ‖Δ‖₂ ≤ 2e-2·‖ref‖₂, so that the test scales
with rows far smaller than the largest: the kernel and the twin round the
same values at the same points and differ only in the order of fp32
sums, which flips the last bit of a bf16/fp16 value here and there.
"""
from unittest import mock

import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import api, layers

REL = 2e-2

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(out, want):
    out, want = out.float(), want.float()
    assert bool(torch.isfinite(out).all())
    err = (out - want).abs().max().item()
    assert err <= REL * want.abs().max().item(), err
    d_row = torch.linalg.vector_norm(out - want, dim=-1)
    r_row = torch.linalg.vector_norm(want, dim=-1)
    assert bool((d_row <= REL * r_row).all()), (d_row / r_row).max().item()


def _qkv(dev, b, sq, sk, h, kv, d, dtype, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]


@pytest.mark.parametrize("case", [
    # b, sq, sk, h, kv, d, causal, window, softcap, q_offset, dtype
    (1, 1000, 1000, 16, 8, 256, True, 0, 50.0, 0, torch.bfloat16),
    (1, 1000, 1000, 16, 8, 256, True, 300, 50.0, 0, torch.bfloat16),
    (2, 257, 257, 32, 8, 128, True, 0, 0.0, 0, torch.bfloat16),
    (1, 300, 300, 48, 1, 128, True, 0, 0.0, 0, torch.float16),
    (2, 130, 130, 4, 2, 64, False, 0, 0.0, 0, torch.bfloat16),
    (1, 100, 612, 8, 2, 128, True, 200, 30.0, 512, torch.bfloat16),
    # No key tile to visit: the output is the twin's zeros.
    (1, 130, 0, 4, 2, 256, True, 0, 0.0, 0, torch.bfloat16),
    (1, 64, 64, 4, 2, 128, True, 10, 50.0, 200, torch.bfloat16),
], ids=["d256", "d256-window", "d128-gqa", "mqa-fp16", "d64-full",
        "q_offset", "no-keys", "window-empties-all"])
def test_kernel_matches_twin(card, case):
    b, sq, sk, h, kv, d, causal, window, softcap, q_offset, dt = case
    _check(card, b, sq, sk, h, kv, d, dt, causal=causal, window=window,
           softcap=softcap, q_offset=q_offset)


def _check(card, b, sq, sk, h, kv, d, dt, seed=0, q_scale=1.0, **kw):
    """One K5 launch against the twin on seeded inputs (Q times q_scale)."""
    q, k, v = _qkv(card, b, sq, sk, h, kv, d, dt, seed)
    if q_scale != 1.0:
        q = (q.float() * q_scale).to(dt)
    before = fa.flash_attention_fused.launches
    out = fa.flash_attention_fused(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_fused.launches == before + 1
    want = fa.flash_attention_ref(q, k, v, **kw)
    assert out.shape == want.shape and out.dtype == dt
    _close(out, want)


@pytest.mark.parametrize("sq", [1, 37, 64, 65, 129, 200])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_kernel_ragged_query_tiles(card, sq, d):
    """Query tiles of 128 rows over two warpgroups of 64: Sq not a
    multiple of 128, and Sq <= 64, where the second warpgroup has no
    row."""
    _check(card, 2, sq, sq + 3, 4, 2, d, torch.bfloat16, causal=True,
           q_offset=3, softcap=30.0)


@pytest.mark.parametrize("window", [1, 63, 65, 4095])
@pytest.mark.parametrize("q_offset", [1, 63, 64, 65, 127])
def test_kernel_tile_classes(card, q_offset, window):
    """Every tile class for both warpgroups: interior, cut by the causal
    diagonal, by the window's edge and by the end of Sk (Sk = q_offset +
    Sq, so each query sees its own key)."""
    sq = 300
    _check(card, 1, sq, q_offset + sq, 4, 1, 128, torch.bfloat16,
           seed=q_offset, causal=True, window=window, q_offset=q_offset)


@pytest.mark.parametrize("window", [0, 65])
def test_kernel_window_without_causal(card, window):
    _check(card, 1, 190, 260, 4, 2, 64, torch.bfloat16, causal=False,
           window=window, q_offset=70)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_kernel_head_dims_and_types(card, d, dtype):
    _check(card, 1, 333, 333, 8, 2, d, dtype, causal=True, softcap=50.0)
    _check(card, 1, 333, 333, 8, 2, d, dtype, seed=1, causal=True)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_kernel_near_saturation_softcap(card, d):
    """Q scaled by 50, so that |s / sqrt(D)| reaches 2-4x the cap of 50:
    most scores sit near +-50, where the kernel's tanh must stay accurate
    in absolute terms (an error e in tanh moves the logit by 50 e)."""
    _check(card, 1, 512, 512, 8, 4, d, torch.bfloat16, q_scale=50.0,
           causal=True, softcap=50.0)


def test_kernel_reads_strided_inputs(card):
    """Q, K, V as views of one packed projection (no copies)."""
    b, s, h, kv, d = 1, 200, 8, 2, 128
    g = torch.Generator(card).manual_seed(1)
    qkv = torch.randn((b, s, (h + 2 * kv) * d), generator=g,
                      device=card).to(torch.bfloat16)
    q = qkv[..., : h * d].unflatten(-1, (h, d))
    k = qkv[..., h * d:(h + kv) * d].unflatten(-1, (kv, d))
    v = qkv[..., (h + kv) * d:].unflatten(-1, (kv, d))
    assert not q.is_contiguous()
    out = fa.flash_attention_fused(q, k, v, causal=True)
    want = fa.flash_attention_ref(q, k, v, causal=True)
    _close(out, want)


def test_kernel_refuses_what_it_does_not_take(card):
    q, k, v = _qkv(card, 1, 64, 64, 4, 2, 128, torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention_fused(q, k, v)
    q, k, v = _qkv(card, 1, 64, 64, 4, 2, 96, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fused(q, k, v)
    q, k, v = _qkv(card, 1, 64, 64, 4, 2, 128, torch.bfloat16)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        fa.flash_attention_fused(q, k, v)


def test_dense_forward_through_k5_matches_twin(card):
    """A two-layer gemma2 at head dim 64: logits through K5 against the
    same model with the plain twin, and one K5 launch per layer."""
    cfg = get_smoke_config("gemma2-9b").scaled(d_head=64)
    model = api.init_params(torch.Generator(card).manual_seed(0), cfg,
                            device=card)
    tokens = torch.randint(0, cfg.vocab, (2, 100), device=card,
                           generator=torch.Generator(card).manual_seed(1))
    with torch.no_grad():
        kernels.reset_launch_counts()
        out, _ = api.forward_logits(model, {"tokens": tokens}, cfg)
        assert kernels.launch_counts()["flash_attention"] == cfg.n_layers
        with mock.patch.object(layers, "flash_attention_fused",
                               fa.flash_attention_ref):
            want, _ = api.forward_logits(model, {"tokens": tokens}, cfg)
        assert kernels.launch_counts()["flash_attention"] == cfg.n_layers
    _close(out, want)
