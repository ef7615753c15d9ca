"""Kernels on the card against their plain twins: K5 and the dense path
(scoring, and training through K5's autograd Function, also at the
other families' training shapes), the MoE family
(scoring through K5, and its dispatch matrix through ``LibraSpMM``), the
SSM, hybrid, audio and VLM families (scoring through K5 at full width,
K5 at head dim 112 and at whisper's non-causal shapes),
the two CUDA-core streams K2 (``spmm_vpu``) and K4 (``sddmm_vpu``), the
two Tensor Core streams K1 (``spmm_mxu``) and K3 (``sddmm_mxu``), and
GNN training through all four (``GraphOps`` forward and backward, with
row reordering off and on, against the plain ``backend="torch"`` path),
the tuner's search timing its candidates through them, the attention
backward over several key chunks, placement on a mesh of ``cuda:0``
positions (the MoE expert-parallel exchange, K5 through a KV repeat,
int8 gradient compression against the CPU), and the op counter of the
reports on the card against its ``meta`` trace.

These tests need an NVIDIA GPU (Hopper, ``sm_90a``) and ``nvcc``; they
are marked ``cuda`` and skip without a card. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

K5's tolerance: max|Δ| ≤ 2e-2·max|ref| (the repo's low-precision
tolerance), and on every row (last axis) ‖Δ‖₂ ≤ 2e-2·‖ref‖₂, so that the
test scales with rows far smaller than the largest: the kernel and the
twin round the same values at the same points and differ only in the
order of fp32 sums, which flips the last bit of a bf16/fp16 value here
and there. K2 and K4: exact on integer data in [-4, 4] (fp32 sums of
small integers are exact in any order), rtol 1e-5 and atol
1e-5·max|ref| on random fp32 data (sums in another order). K1 and K3
compute in TF32 (10 mantissa bits): exact on integer data in [-4, 4]
(TF32 holds such values exactly), max|Δ| ≤ 2e-2·max|ref| on random data.
"""
import copy
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.api import ExecSpec
from repro_torch.configs import get_smoke_config
from repro_torch.core.sddmm import LibraSDDMM
from repro_torch.core.spmm import LibraSpMM
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels.spmm_mxu import real_lengths as tc_real_lengths
from repro_torch.kernels.spmm_vpu import real_lengths
from repro_torch.models import api, gnn, layers
from repro_torch.sparse import coo_to_csr, mixed_csr, power_law_csr
from repro_torch.tune.model import TuneConfig

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
@pytest.mark.parametrize("d", [64, 112, 128, 256])
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
@pytest.mark.parametrize("d", [64, 112, 128, 256])
def test_kernel_head_dims_and_types(card, d, dtype):
    _check(card, 1, 333, 333, 8, 2, d, dtype, causal=True, softcap=50.0)
    _check(card, 1, 333, 333, 8, 2, d, dtype, seed=1, causal=True)


@pytest.mark.parametrize("d", [64, 112, 128, 256])
def test_kernel_near_saturation_softcap(card, d):
    """Q scaled by 50, so that |s / sqrt(D)| reaches 2-4x the cap of 50:
    most scores sit near +-50, where the kernel's tanh must stay accurate
    in absolute terms (an error e in tanh moves the logit by 50 e)."""
    _check(card, 1, 512, 512, 8, 4, d, torch.bfloat16, q_scale=50.0,
           causal=True, softcap=50.0)


@pytest.mark.parametrize("case", [
    # b, sq, sk, h, kv, d, causal, window, softcap
    (1, 1500, 1500, 32, 32, 112, True, 0, 0.0),
    (1, 5000, 5000, 8, 8, 112, True, 4096, 0.0),
    (2, 300, 300, 8, 4, 112, True, 100, 50.0),
    (8, 1500, 1500, 6, 6, 64, False, 0, 0.0),
    (8, 448, 1500, 6, 6, 64, False, 0, 0.0),
], ids=["d112-causal", "d112-window", "d112-softcap", "whisper-encoder",
        "whisper-cross"])
def test_kernel_family_shapes(card, case):
    """zamba2's head dim 112 (the kernel's 128-column pitch: QKᵀ over
    the real columns, V's pad zeroed in shared memory, the extra output
    columns dropped) causal, windowed and softcapped; whisper's
    non-causal encoder (1500 frames, 1500 = 23·64 + 28) and cross
    attention (448 decoder tokens over 1500 frames)."""
    b, sq, sk, h, kv, d, causal, window, cap = case
    _check(card, b, sq, sk, h, kv, d, torch.bfloat16, causal=causal,
           window=window, softcap=cap)


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
    # Under grad the kernel runs inside the autograd Function: the same
    # launch, the same output, and a graph to differentiate.
    q, k, v = _qkv(card, 1, 64, 64, 4, 2, 128, torch.bfloat16)
    with torch.no_grad():
        want = fa.flash_attention_fused(q, k, v)
    q.requires_grad_(True)
    before = fa.flash_attention_fused.launches
    out = fa.flash_attention_fused(q, k, v)
    assert fa.flash_attention_fused.launches == before + 1
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(out.detach(), want)


LSE_CASES = {
    # b, sq, sk, h, kv, d, causal, window, softcap, q_offset, dtype
    "d256": (1, 1000, 1000, 16, 8, 256, True, 0, 50.0, 0, torch.bfloat16),
    "d256-window": (1, 1000, 1000, 16, 8, 256, True, 300, 50.0, 0,
                    torch.bfloat16),
    "d128-gqa": (2, 257, 257, 32, 8, 128, True, 0, 0.0, 0, torch.bfloat16),
    "mqa-fp16": (1, 300, 300, 48, 1, 128, True, 0, 0.0, 0, torch.float16),
    "d64-full": (2, 130, 130, 4, 2, 64, False, 0, 0.0, 0, torch.bfloat16),
    "q_offset": (1, 100, 612, 8, 2, 128, True, 200, 30.0, 512,
                 torch.bfloat16),
    "no-keys": (1, 130, 0, 4, 2, 256, True, 0, 0.0, 0, torch.bfloat16),
    "window-empties-all": (1, 64, 64, 4, 2, 128, True, 10, 50.0, 200,
                           torch.bfloat16),
}


@pytest.mark.parametrize("name", list(LSE_CASES))
def test_kernel_lse_matches_twin(card, name):
    """K5's logsumexp output against the twin's within 1e-3 absolute
    (the kernel's ex2/tanh approximations move it by about 1e-6
    relative); +inf on the same rows (no visible key); the output is the
    scoring launch's bit for bit."""
    b, sq, sk, h, kv, d, causal, window, cap, q_off, dt = LSE_CASES[name]
    q, k, v = _qkv(card, b, sq, sk, h, kv, d, dt)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_off)
    out, lse = fa._forward(q, k, v, causal, window, cap, q_off, True)
    torch.cuda.synchronize()
    want_out, want = fa.flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    fin = torch.isfinite(want)
    assert bool((lse[~fin] > 0).all())
    if bool(fin.any()):
        assert (lse[fin] - want[fin]).abs().max().item() <= 1e-3
    assert torch.equal(out, fa.flash_attention_fused(q, k, v, **kw))
    _close(out, want_out)


@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("d", [64, 112, 128, 256])
def test_function_grads_match_twin_autograd(card, d, window, cap):
    """dQ, dK, dV through the Function (K5 forward, chunked backward,
    128-key chunks) against plain autograd through the twin, within
    2e-2·max|ref|: the two round P and dP to bf16 at different points."""
    q, k, v = _qkv(card, 1, 300, 300, 8, 2, d, torch.bfloat16, seed=d)
    do = torch.randn(q.shape, generator=torch.Generator(card).manual_seed(9),
                     device=card).to(torch.bfloat16)
    kw = dict(causal=True, window=window, softcap=cap)
    grads = []
    for fn in (lambda *t: fa.flash_attention_grad(*t, chunk=128, **kw),
               lambda *t: fa.flash_attention_ref(*t, **kw)):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*ins), ins, do))
    for got, want in zip(*grads):
        assert got.dtype == torch.bfloat16
        got, want = got.float(), want.float()
        assert bool(torch.isfinite(got).all())
        err = (got - want).abs().max().item()
        assert err <= REL * want.abs().max().item(), err


@pytest.mark.parametrize("case", [
    # b, sq, sk, h, kv, d, causal, window
    (8, 448, 1500, 6, 6, 64, False, 448 + 1500 + 1),
    (8, 1500, 1500, 6, 6, 64, False, 1500 + 1500 + 1),
    (1, 6144, 6144, 4, 4, 112, True, 4096),
    (1, 2048, 2048, 28, 4, 128, True, 0),
], ids=["whisper-cross", "whisper-encoder", "zamba2-d112-window",
        "qwen2-vl-gqa-28-4"])
def test_function_grads_at_family_shapes(card, case):
    """The Function (K5 forward with its logsumexp, the chunked backward
    over 1024-key chunks) against plain autograd through the twin at the
    families' training shapes: whisper's non-causal cross attention (Sq
    != Sk) and encoder (1500 = 23·64 + 28 keys) with the window
    ``sk + sq + 1`` the layers pass for "none", zamba2's head dim 112
    with its window (heads cut to 4 so the twin's autograd fits), and
    qwen2-vl's seven query heads a KV head. Within 2e-2·max|ref|: the two
    round P and dP to bf16 at different points."""
    b, sq, sk, h, kv, d, causal, window = case
    q, k, v = _qkv(card, b, sq, sk, h, kv, d, torch.bfloat16, seed=sq + d)
    do = torch.randn(q.shape, generator=torch.Generator(card).manual_seed(7),
                     device=card).to(torch.bfloat16)
    kw = dict(causal=causal, window=window)
    outs, grads = [], []
    for fn in (lambda *t: fa.flash_attention_grad(*t, chunk=1024, **kw),
               lambda *t: fa.flash_attention_ref(*t, **kw)):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*ins)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, ins, do))
        del ins, out
    for got, want in zip((outs[0], *grads[0]), (outs[1], *grads[1])):
        assert got.dtype == torch.bfloat16
        got, want = got.float(), want.float()
        assert bool(torch.isfinite(got).all())
        err = (got - want).abs().max().item()
        assert err <= REL * want.abs().max().item(), err


def test_gemma2_training_step_matches_cpu(card):
    """A two-layer gemma2 at head dim 64, the same weights on the card
    and on the CPU: first-microbatch gradients within 2e-2·max|g| (K5
    against the twin, bf16 products in another order), and one training
    step's loss and gradient norm within 1e-2 relative, with K5 launched
    twice a layer (forward and recompute)."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cfg = get_smoke_config("gemma2-9b").scaled(d_head=64)
    gpu = api.init_params(torch.Generator(card).manual_seed(0), cfg,
                          device=card)
    cpu = copy.deepcopy(gpu).cpu()
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 100), generator=g,
                                     dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab, (2, 100), generator=g,
                                     dtype=torch.int32)}
    on_card = {k: t.to(card) for k, t in batch.items()}
    got = torch.autograd.grad(api.loss_fn(gpu, on_card, cfg),
                              list(gpu.parameters()))
    want = torch.autograd.grad(api.loss_fn(cpu, batch, cfg),
                               list(cpu.parameters()))
    for a, b in zip(got, want):
        err = (a.cpu() - b).abs().max().item()
        assert err <= REL * b.abs().max().item(), err
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    metrics = []
    for model, b in ((gpu, on_card), (cpu, batch)):
        state = opt.init_opt_state(dict(model.named_parameters()), ocfg)
        kernels.reset_launch_counts()
        metrics.append(make_train_step(cfg, ocfg, microbatches=2)(model, state, b))
        if model is gpu:
            assert kernels.launch_counts()["flash_attention"] == \
                2 * cfg.n_layers * 2
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[0][key]),
                                   float(metrics[1][key]), rtol=1e-2)


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


#: arch → (config at full width, 2 layers; batch; tokens; K5 launches).
FAMILY_CASES = {
    "mamba2-130m": (dict(n_layers=2), 1, 2048, 0),
    # One group of two Mamba2 layers and the shared attention; 4608
    # tokens run past zamba2's 4096-token window at head dim 112.
    "zamba2-7b": (dict(n_layers=2, hybrid_attn_every=2), 1, 4608, 1),
    # Two encoder and two decoder layers: 2 + 2 + 2 cross launches.
    "whisper-tiny": (dict(n_layers=2, n_enc_layers=2), 2, 448, 6),
    "qwen2-vl-7b": (dict(n_layers=2), 1, 2048, 2),
}


@pytest.mark.parametrize("arch", list(FAMILY_CASES))
def test_family_forward_through_k5_matches_twin(card, arch):
    """Each family at full width, 2 layers: logits through K5 against
    the same model with the plain twin (whisper over seeded frame
    embeddings, qwen2-vl with seeded patch embeddings), and K5's
    launches."""
    from repro_torch.configs import get_config

    scale, b, s, launches = FAMILY_CASES[arch]
    cfg = get_config(arch).scaled(**scale)
    model = api.init_params(torch.Generator(card).manual_seed(0), cfg,
                            device=card)
    g = torch.Generator(card).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), device=card,
                                     generator=g)}
    if cfg.family == "audio":
        batch["frame_embeds"] = torch.randn(
            (b, cfg.n_audio_ctx, cfg.d_model), device=card, generator=g)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (b, cfg.n_patches, cfg.d_model), device=card, generator=g)
    with torch.no_grad():
        kernels.reset_launch_counts()
        out, _ = api.forward_logits(model, batch, cfg)
        assert kernels.launch_counts()["flash_attention"] == launches
        with mock.patch.object(layers, "flash_attention_fused",
                               fa.flash_attention_ref):
            want, _ = api.forward_logits(model, batch, cfg)
        assert kernels.launch_counts()["flash_attention"] == launches
    assert out.shape == (b, s, cfg.vocab)
    _close(out, want)


# ------------------------------------------------------------------ MoE
def _routing(pin=None):
    """Patch ``moe.router_topk`` to record each call's expert choice; with
    ``pin`` (an earlier run's record) each call chooses as that run did,
    its weights renormalised over this run's probabilities: a near-tie
    that rounding flips moves a token by O(1), not by rounding. As
    ``chip_smoke.routing``."""
    from repro_torch.models import moe

    real = moe.router_topk
    rec = {"topi": []}

    def route(logits, k):
        topv, topi, aux = real(logits, k)
        if pin is not None:
            topi = pin[len(rec["topi"])]
            picked = torch.softmax(logits.float(), dim=-1).gather(-1, topi)
            topv = picked / torch.clamp(picked.sum(-1, keepdim=True),
                                        min=1e-9)
        rec["topi"].append(topi)
        return topv, topi, aux

    return mock.patch.object(moe, "router_topk", route), rec


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "qwen3-moe-235b-a22b"])
def test_moe_forward_through_k5_matches_twin(card, arch):
    """A two-layer MoE at head dim 64 (moonshot's with a shared expert,
    qwen3-moe's GQA): logits and aux through K5 against the same model
    with the plain twin, the twin's routing pinned to K5's, and one K5
    launch per layer."""
    cfg = get_smoke_config(arch).scaled(d_head=64)
    model = api.init_params(torch.Generator(card).manual_seed(0), cfg,
                            device=card)
    tokens = torch.randint(0, cfg.vocab, (2, 100), device=card,
                           generator=torch.Generator(card).manual_seed(1))
    with torch.no_grad():
        kernels.reset_launch_counts()
        patch, rec = _routing()
        with patch:
            out, aux = api.forward_logits(model, {"tokens": tokens}, cfg)
        assert kernels.launch_counts()["flash_attention"] == cfg.n_layers
        patch, _ = _routing(pin=rec["topi"])
        with patch, mock.patch.object(layers, "flash_attention_fused",
                                      fa.flash_attention_ref):
            want, want_aux = api.forward_logits(model, {"tokens": tokens},
                                                cfg)
        assert kernels.launch_counts()["flash_attention"] == cfg.n_layers
    _close(out, want)
    assert abs(aux.item() - want_aux.item()) <= REL * want_aux.item()


@pytest.mark.parametrize("t,e,k", [(512, 8, 2), (4096, 64, 6)])
def test_moe_dispatch_through_libra_on_the_card(card, t, e, k):
    """The dispatch matrix of the sort-based dispatch, (e·cap) × t with
    one 1.0 a kept assignment, through ``LibraSpMM`` on the card: the
    buffer bit for bit and nothing on the Tensor Cores: K2 carries it, and
    K1, which the apply launches on every call, runs over the plan's one
    empty segment (0 real vectors)."""
    from repro_torch.models import moe

    gen = torch.Generator(card).manual_seed(3)
    x = torch.randn(t, 64, generator=gen, device=card)
    logits = torch.randn(t, e, generator=gen, device=card)
    _, topi, _ = moe.router_topk(logits, k)
    cap = max(4, min(int(1.25 * t * k / e), t))
    buf, slots = moe._local_dispatch(x, topi, e, k, cap, torch.float32)
    s = slots.reshape(-1).cpu().numpy()
    kept = s < e * cap
    d = coo_to_csr(e * cap, t, s[kept].astype(np.int32),
                   np.repeat(np.arange(t, dtype=np.int32), k)[kept],
                   np.ones(int(kept.sum()), np.float32))
    op = LibraSpMM(d)
    assert op.tc_ratio == 0.0
    kernels.reset_launch_counts()
    out = op(x)
    counts = kernels.launch_counts()
    assert int(op.arrays.tc_len().sum()) == 0
    assert counts["spmm_mxu"] <= 1 and counts["spmm_vpu"] >= 1
    assert torch.equal(out, buf.reshape(e * cap, -1))


# --------------------------------------------------------------- K2, K4
# B and Y have enough rows that all but the narrowest widths below take
# several column slices.
K_BIG = 200_000
FP32_RTOL = 1e-5
# Real lengths of the rows of a Cs segment table 128 slots wide: empty
# (the dummy segment of an empty path), one slot, either side of a
# 32-slot tile, a full row, and a spread of others.
SEG_LENS = [0, 1, 31, 33, 128, 127, 64, 2, 17, 96]


def _data(gen, integers, *shape):
    if integers:
        return torch.randint(-4, 5, shape, generator=gen).float()
    return torch.randn(*shape, generator=gen)


def _seg_table(gen, k, nrows, width=128, integers=True):
    """A segment table with real prefixes of the lengths above (cycled)
    and padding (value 0, column 0) after them; real values non-zero."""
    lens = torch.tensor(SEG_LENS * -(-nrows // len(SEG_LENS)))[:nrows]
    real = torch.arange(width)[None, :] < lens[:, None]
    vals = _data(gen, integers, nrows, width)
    vals = torch.where(vals == 0, 1.0, vals)
    cols = torch.randint(0, k, (nrows, width), generator=gen,
                         dtype=torch.int32)
    return (torch.where(real, vals, 0.0), torch.where(real, cols, 0),
            lens.to(torch.int32))


def _agree(out, want, integers):
    torch.cuda.synchronize()
    assert out.shape == want.shape
    if integers:
        assert torch.equal(out, want)
    else:
        scale = want.abs().max().item()
        assert torch.allclose(out, want, rtol=FP32_RTOL,
                              atol=FP32_RTOL * scale)


@pytest.mark.parametrize("integers", [True, False], ids=["int", "rand"])
@pytest.mark.parametrize("n", [256, 128, 40, 37, 100])
def test_spmm_vpu_matches_twin(card, n, integers):
    """Every main-path width (n = 256, 128, 40: one slice of all 40
    columns), the scalar path (37) and widths that are no multiple of the
    slice width (37: 32 + 5; 100: 3 x 32 + 4); the explicit and the
    derived lengths give identical results."""
    gen = torch.Generator().manual_seed(n)
    vals, cols, lens = _seg_table(gen, K_BIG, 1500, integers=integers)
    b = _data(gen, integers, K_BIG, n).to(card)
    vals, cols, lens = vals.to(card), cols.to(card), lens.to(card)
    assert torch.equal(real_lengths(vals, cols), lens)
    before = kernels.spmm_vpu.launches
    out = kernels.spmm_vpu(vals, cols, b, seg_len=lens)
    derived = kernels.spmm_vpu(vals, cols, b)
    assert kernels.spmm_vpu.launches == before + 2
    _agree(out, ref.spmm_tile_partials(vals, cols, b), integers)
    assert torch.equal(out, derived)


@pytest.mark.parametrize("n", [256, 40, 37])
def test_spmm_vpu_non_finite_pattern_matches_twin(card, n):
    """Non-finite B rows, B[0] (the padding's row) among them, an
    exact-zero weight inside a real prefix and a real zero weight at
    column 0 in the last slot of a full row: the twin's inf/NaN pattern,
    bit for bit, with explicit and derived lengths. Rows 4 and 14 are
    full (128 real slots), so only they can hold an inf."""
    gen = torch.Generator().manual_seed(7)
    vals, cols, lens = _seg_table(gen, K_BIG, 400)
    vals[4, 10] = 0.0                      # exact zero, real column
    vals[5, 63], cols[5, 63] = 0.0, 0      # real zero at column 0
    vals[14, 127], cols[14, 127] = 0.0, 0  # ... in a full row's last slot
    b = _data(gen, True, K_BIG, n)
    b[0] = float("inf")
    b[cols[4, 3], : n // 2] = float("nan")
    b[cols[4, 5], n // 2:] = -float("inf")
    vals, cols, lens, b = (t.to(card) for t in (vals, cols, lens, b))
    want = ref.spmm_tile_partials(vals, cols, b)
    for got in (kernels.spmm_vpu(vals, cols, b, seg_len=lens),
                kernels.spmm_vpu(vals, cols, b)):
        torch.cuda.synchronize()
        same = (got == want) | (got.isnan() & want.isnan())
        assert bool(same.all())
    assert bool(want.isnan().any()) and bool(want.isinf().any())


def test_spmm_vpu_full_rows_skip_the_padding_term(card):
    """Rows with every slot real take no padding term: a non-finite B[0]
    that no real slot names leaves them finite, as in the twin."""
    gen = torch.Generator().manual_seed(8)
    vals = _data(gen, True, 64, 32).clamp(min=1.0)
    cols = torch.randint(1, 500, (64, 32), generator=gen, dtype=torch.int32)
    b = _data(gen, True, 500, 64)
    b[0] = float("nan")
    vals, cols, b = vals.to(card), cols.to(card), b.to(card)
    out = kernels.spmm_vpu(vals, cols, b)
    _agree(out, ref.spmm_tile_partials(vals, cols, b), True)


def test_spmm_operator_reads_plan_lengths(card):
    """The apply passes the plan's own lengths (``PlanArrays.vpu_len``):
    the operator through the kernels equals the plain path exactly."""
    a = power_law_csr(3000, 2500, 9.0, seed=5)
    rng = np.random.default_rng(5)
    a.data[:] = rng.integers(1, 5, a.nnz) * rng.choice([-1, 1], a.nnz)
    op = LibraSpMM(a, spec=ExecSpec(tune="off", device="cuda"))
    b = torch.from_numpy(rng.integers(-4, 5, (a.k, 40)).astype(
        np.float32)).to(card)
    lens = op.arrays.for_backend("cuda")["vpu_len"]
    t = op.arrays.for_backend("cuda")
    assert torch.equal(lens, real_lengths(t["vpu_seg_vals"],
                                          t["vpu_seg_cols"]))
    assert torch.equal(op(b), op(b, backend="torch"))


@pytest.mark.parametrize("integers", [True, False], ids=["int", "rand"])
@pytest.mark.parametrize("kf", [128, 256, 30, 36])
def test_sddmm_vpu_matches_twin(card, kf, integers):
    """Every main-path width (kf = 128, 256), the scalar path (30) and a
    width that is no multiple of the slice width (36: 32 + 4)."""
    gen = torch.Generator().manual_seed(kf)
    nel, m = 32 * 700 + 13, 3000
    rows = torch.randint(0, m, (nel,), generator=gen, dtype=torch.int32)
    rows = rows.sort().values.reshape(-1, 1)   # runs of one row, as in a plan
    cols = torch.randint(0, K_BIG, (nel, 1), generator=gen, dtype=torch.int32)
    x = _data(gen, integers, m, kf).to(card)
    y = _data(gen, integers, K_BIG, kf).to(card)
    rows, cols = rows.to(card), cols.to(card)
    before = kernels.sddmm_vpu.launches
    out = kernels.sddmm_vpu(rows, cols, x, y)
    assert kernels.sddmm_vpu.launches == before + 1
    _agree(out, ref.sddmm_pair_scores(rows, cols, x, y), integers)


def test_sddmm_vpu_unaligned_operand_takes_the_scalar_path(card):
    """X at an address that is not 16-byte aligned: one feature a lane,
    over several slices, still exact."""
    gen = torch.Generator().manual_seed(3)
    m, kf = 500, 128
    buf = _data(gen, True, m * kf + 1).to(card)
    x = buf[1:].view(m, kf)
    y = _data(gen, True, K_BIG, kf).to(card)
    rows = torch.randint(0, m, (40, 32), generator=gen,
                         dtype=torch.int32).to(card)
    cols = torch.randint(0, K_BIG, (40, 32), generator=gen,
                         dtype=torch.int32).to(card)
    _agree(kernels.sddmm_vpu(rows, cols, x, y),
           ref.sddmm_pair_scores(rows, cols, x, y), True)


# --------------------------------------------------------------- K1, K3
TF32_REL = 2e-2


def _agree_tf32(out, want, integers):
    torch.cuda.synchronize()
    assert out.shape == want.shape
    if integers:
        assert torch.equal(out, want)
    else:
        assert bool(torch.isfinite(out).all())
        err = (out - want).abs().max().item()
        assert err <= TF32_REL * want.abs().max().item(), err


def _same_non_finite(got, want):
    torch.cuda.synchronize()
    same = (got == want) | (got.isnan() & want.isnan())
    assert bool(same.all())


def _tc_table(gen, k, nb, width=128, integers=True):
    """A K1 segment table: real prefixes of the SEG_LENS lengths (cycled,
    clipped to the width) with random values in all 8 rows (row 0 never
    zero, so every real vector shows in its values) and padding (values
    0, column 0) after them."""
    lens = torch.tensor(SEG_LENS * -(-nb // len(SEG_LENS)))[:nb]
    lens = lens.clamp(max=width)
    real = torch.arange(width)[None, :] < lens[:, None]
    vals = _data(gen, integers, nb, 8, width)
    vals[:, 0] = torch.where(vals[:, 0] == 0, 1.0, vals[:, 0])
    cols = torch.randint(0, k, (nb, width), generator=gen, dtype=torch.int32)
    return (torch.where(real[:, None, :], vals, 0.0),
            torch.where(real, cols, 0), lens.to(torch.int32))


def _spmm_mxu_both(vals, cols, rank, b, n_active, unique, lens):
    """K1 with the table's lengths and with the lengths it derives: both
    launch and give identical results."""
    before = kernels.spmm_mxu.launches
    out = kernels.spmm_mxu(vals, cols, rank, b, n_active=n_active,
                           unique_ranks=unique, seg_len=lens)
    derived = kernels.spmm_mxu(vals, cols, rank, b, n_active=n_active,
                               unique_ranks=unique)
    assert kernels.spmm_mxu.launches == before + 2
    torch.cuda.synchronize()
    if unique:
        assert torch.equal(out, derived)
    return out


@pytest.mark.parametrize("integers", [True, False], ids=["int", "rand"])
@pytest.mark.parametrize("n", [256, 128, 40, 37, 300])
@pytest.mark.parametrize("width", [128, 48])
def test_spmm_mxu_matches_twin(card, n, width, integers):
    """Every main-path width (n = 256, 128, 40), the scalar path (37) and
    a width of two column tiles (300); segment lengths 0, 1, partial and
    full, over tables of four 32-vector chunks and of one and a half;
    unique ranks in a shuffled order; explicit and derived lengths."""
    gen = torch.Generator().manual_seed(n + width)
    nb = 700
    vals, cols, lens = _tc_table(gen, 5000, nb, width, integers)
    assert torch.equal(tc_real_lengths(vals, cols), lens)
    rank = torch.randperm(nb, generator=gen).to(torch.int32)
    b = _data(gen, integers, 5000, n)
    vals, cols, lens, rank, b = (t.to(card) for t in (vals, cols, lens,
                                                      rank, b))
    out = _spmm_mxu_both(vals, cols, rank, b, nb, True, lens)
    _agree_tf32(out, ref.spmm_tc_compact_ref(vals, cols, rank, b, nb),
                integers)


@pytest.mark.parametrize("integers", [True, False], ids=["int", "rand"])
@pytest.mark.parametrize("n", [256, 40])
def test_spmm_mxu_shared_ranks_add_atomically(card, n, integers):
    """The compact per-block layout: blocks share output slabs, the
    wrapper zeroes the output and the kernel adds atomically (integer
    sums are exact in any order)."""
    gen = torch.Generator().manual_seed(n)
    nb, n_active = 600, 97
    vals, cols, lens = _tc_table(gen, 3000, nb, 32, integers)
    rank = torch.randint(0, n_active, (nb,), generator=gen,
                         dtype=torch.int32)
    b = _data(gen, integers, 3000, n)
    vals, cols, lens, rank, b = (t.to(card) for t in (vals, cols, lens,
                                                      rank, b))
    out = _spmm_mxu_both(vals, cols, rank, b, n_active, False, lens)
    want = ref.spmm_tc_compact_ref(vals, cols, rank, b, n_active)
    _agree_tf32(out, want, integers)
    _agree_tf32(kernels.spmm_mxu(vals, cols, rank, b, n_active=n_active),
                want, integers)


@pytest.mark.parametrize("n", [256, 40, 37])
def test_spmm_mxu_non_finite_pattern_matches_twin(card, n):
    """Non-finite B rows, B[0] (the padding's row) among them, an
    exact-zero weight inside a real vector, and a real all-zero vector
    at column 0 in the last slot of a full segment: the twin's inf/NaN
    pattern, bit for bit, with explicit and derived lengths."""
    gen = torch.Generator().manual_seed(9)
    vals, cols, lens = _tc_table(gen, 2000, 300)
    vals[4, 3, 10] = 0.0                           # exact zero, real vector
    vals[14, :, 127], cols[14, 127] = 0.0, 0       # real zero vector at 0
    b = _data(gen, True, 2000, n)
    b[0] = float("inf")
    b[cols[4, 10], : n // 2] = float("nan")
    b[cols[4, 5], n // 2:] = -float("inf")
    rank = torch.arange(300, dtype=torch.int32)
    vals, cols, lens, rank, b = (t.to(card) for t in (vals, cols, lens,
                                                      rank, b))
    want = ref.spmm_tc_compact_ref(vals, cols, rank, b, 300)
    for got in (kernels.spmm_mxu(vals, cols, rank, b, n_active=300,
                                 unique_ranks=True, seg_len=lens),
                kernels.spmm_mxu(vals, cols, rank, b, n_active=300,
                                 unique_ranks=True)):
        _same_non_finite(got, want)
    assert bool(want.isnan().any()) and bool(want.isinf().any())


def test_spmm_mxu_unaligned_operands_take_the_scalar_path(card):
    """B and the values at addresses that are not 16-byte aligned, and a
    table width that is no multiple of 4: 4-byte copies, still exact."""
    gen = torch.Generator().manual_seed(4)
    nb, width, k, n = 300, 18, 900, 64
    vals, cols, lens = _tc_table(gen, k, nb, width)
    vbuf = torch.zeros(vals.numel() + 1)
    vbuf[1:] = vals.flatten()
    bbuf = _data(gen, True, k * n + 1)
    rank = torch.arange(nb, dtype=torch.int32)
    vbuf, bbuf, cols, lens, rank = (t.to(card) for t in (vbuf, bbuf, cols,
                                                         lens, rank))
    vals, b = vbuf[1:].view(nb, 8, width), bbuf[1:].view(k, n)
    out = _spmm_mxu_both(vals, cols, rank, b, nb, True, lens)
    _agree_tf32(out, ref.spmm_tc_compact_ref(vals, cols, rank, b, nb), True)


def _int_csr(a, seed):
    rng = np.random.default_rng(seed)
    a.data[:] = rng.integers(1, 5, a.nnz) * rng.choice([-1, 1], a.nnz)
    return a, rng


@pytest.mark.parametrize("layout", [{}, {"ts": 0, "cs": 0}],
                         ids=["segment", "compact"])
def test_spmm_operator_tensor_core_path_reads_plan_lengths(card, layout):
    """A plan that puts most non-zeros on K1: the apply passes the plan's
    real-vector counts (``PlanArrays.tc_len``), equal to the derived ones,
    and the operator equals the plain path exactly."""
    a, rng = _int_csr(mixed_csr(1024, 1024, seed=3), 5)
    op = LibraSpMM(a, spec=ExecSpec(device="cuda", tune=TuneConfig(
        threshold=6, bk=32, ts_tile=32, **({"ts": 4} | layout))))
    assert op.plan.meta["tc_nnz"] > 0.5 * a.nnz
    t = op.arrays.for_backend("cuda")
    seg = "_seg" if "tc_seg_vals" in t else ""
    assert torch.equal(t["tc_len"], tc_real_lengths(t[f"tc{seg}_vals"],
                                                    t[f"tc{seg}_cols"]))
    b = torch.from_numpy(rng.integers(-4, 5, (a.k, 256)).astype(
        np.float32)).to(card)
    before = kernels.spmm_mxu.launches
    got = op(b)
    assert kernels.spmm_mxu.launches == before + 1
    assert torch.equal(got, op(b, backend="torch"))


def _sddmm_table(gen, k, m, nb, width, one_bit=False):
    """A K3 segment table: windows in runs (as the plan orders them), the
    last ones past the end of X; real columns a prefix of the SEG_LENS
    lengths with random non-zero bitmaps (one bit each, as on a graph,
    with ``one_bit``), padding (column 0, bitmap 0) after them."""
    lens = torch.tensor(SEG_LENS * -(-nb // len(SEG_LENS)))[:nb]
    lens = lens.clamp(max=width)
    real = torch.arange(width)[None, :] < lens[:, None]
    if one_bit:
        bits = 1 << torch.randint(0, 8, (nb, width), generator=gen)
    else:
        bits = torch.randint(1, 256, (nb, width), generator=gen)
    cols = torch.randint(0, k, (nb, width), generator=gen, dtype=torch.int32)
    window = torch.randint(0, -(-m // 8) + 1, (nb,), generator=gen).sort()
    return (torch.where(real, cols, 0),
            torch.where(real, bits, 0).to(torch.int32),
            window.values.to(torch.int32))


@pytest.mark.parametrize("integers", [True, False], ids=["int", "rand"])
@pytest.mark.parametrize("kf", [128, 64, 256, 30, 36])
@pytest.mark.parametrize("width,one_bit", [(32, True), (128, False)],
                         ids=["graph-like", "mixed-like"])
def test_sddmm_mxu_matches_twin(card, kf, width, one_bit, integers):
    """Every main-path width (kf = 128, 256) and 64, the scalar path
    (30), a width that is no multiple of 16 (36); Y has enough rows that
    kf is cut into 64-feature slices (two at kf = 128). Tables like the
    graph's (32 columns, one bit a column, many chunks a warp) and the
    mixed matrix's (128 columns, full bitmaps), with windows past the end
    of X and segment lengths 0, 1, partial and full."""
    gen = torch.Generator().manual_seed(kf + width)
    m = 3001
    cols, bits, window = _sddmm_table(gen, K_BIG, m, 3000, width, one_bit)
    x = _data(gen, integers, m, kf).to(card)
    y = _data(gen, integers, K_BIG, kf).to(card)
    cols, bits, window = cols.to(card), bits.to(card), window.to(card)
    before = kernels.sddmm_mxu.launches
    out = kernels.sddmm_mxu(cols, bits, window, x, y)
    assert kernels.sddmm_mxu.launches == before + 1
    _agree_tf32(out, ref.sddmm_tc_ref(cols, bits, window, x, y), integers)


@pytest.mark.parametrize("budget", [1, 64 * 4 * 3001], ids=["16", "64"])
def test_sddmm_mxu_over_many_slices(card, budget):
    """A smaller L2 budget cuts kf = 128 into eight 16-feature slices (or
    two of 64): the later launches add their partial dot products to the
    kept scores in order, exactly on integers."""
    gen = torch.Generator().manual_seed(budget % 1000)
    m, k, kf = 900, 3001, 128
    cols, bits, window = _sddmm_table(gen, k, m, 500, 128)
    x = _data(gen, True, m, kf).to(card)
    y = _data(gen, True, k, kf).to(card)
    cols, bits, window = cols.to(card), bits.to(card), window.to(card)
    with mock.patch.object(_build, "L2_SLICE_BYTES", budget):
        out = kernels.sddmm_mxu(cols, bits, window, x, y)
    _agree_tf32(out, ref.sddmm_tc_ref(cols, bits, window, x, y), True)


def test_sddmm_mxu_nan_rows_behind_zero_bitmaps(card):
    """NaN Y rows that only padding or zero-bitmap columns name (Y[0],
    the padding's row, among them), and NaN in an X row: the twin's
    pattern bit for bit; a zero-bitmap column scores 0 whatever its Y row
    holds."""
    gen = torch.Generator().manual_seed(5)
    m, k, kf = 800, 4000, 128
    cols, bits, window = _sddmm_table(gen, k, m, 400, 128)
    bits[3, 5:9] = 0                        # real columns, nothing kept
    x = _data(gen, True, m, kf)
    y = _data(gen, True, k, kf)
    named = torch.zeros(k, dtype=torch.bool)
    named[cols[bits != 0].long()] = True
    hidden = torch.nonzero(~named).flatten()
    y[0] = float("nan")
    y[hidden[1:50]] = float("nan")
    cols[3, 5:9] = hidden[1:5].to(torch.int32)
    x[8 * int(window[7]) + 2] = float("nan")  # one X row of a window
    x, y, cols, bits, window = (t.to(card) for t in (x, y, cols, bits,
                                                     window))
    got = kernels.sddmm_mxu(cols, bits, window, x, y)
    want = ref.sddmm_tc_ref(cols, bits, window, x, y)
    _same_non_finite(got, want)
    assert bool(want.isnan().any())
    assert not bool(got[3, :, 5:9].isnan().any())


def test_sddmm_mxu_unaligned_operand_takes_the_scalar_path(card):
    """X at an address that is not 16-byte aligned: 4-byte copies and
    scalar X loads, over two 128-feature slices, still exact."""
    gen = torch.Generator().manual_seed(6)
    m, kf = 500, 256
    buf = _data(gen, True, m * kf + 1).to(card)
    x = buf[1:].view(m, kf)
    y = _data(gen, True, K_BIG, kf).to(card)
    cols, bits, window = (t.to(card) for t in _sddmm_table(
        gen, K_BIG, m, 300, 32))
    _agree_tf32(kernels.sddmm_mxu(cols, bits, window, x, y),
                ref.sddmm_tc_ref(cols, bits, window, x, y), True)


@pytest.mark.parametrize("layout", [{}, {"ts": 0, "cs": 0}],
                         ids=["segment", "compact"])
def test_sddmm_operator_tensor_core_path_matches_plain(card, layout):
    """A plan that puts every non-zero on K3: the operator through the
    kernels equals the plain path exactly on integers."""
    a, rng = _int_csr(mixed_csr(1024, 1024, seed=3), 6)
    op = LibraSDDMM(a, spec=ExecSpec(device="cuda", tune=TuneConfig(
        threshold=1, bk=16, ts_tile=32, **({"ts": 8} | layout))))
    assert op.plan.meta["tc_nnz"] == a.nnz
    x = torch.from_numpy(rng.integers(-4, 5, (a.m, 128)).astype(
        np.float32)).to(card)
    y = torch.from_numpy(rng.integers(-4, 5, (a.k, 128)).astype(
        np.float32)).to(card)
    before = kernels.sddmm_mxu.launches
    got = op(x, y)
    assert kernels.sddmm_mxu.launches == before + 1
    assert torch.equal(got, op(x, y, backend="torch"))


def _training_graph(card, reorder, backend="cuda"):
    """A shuffled power-law graph (rows permuted, so reordering has
    windows to densify) with non-zero integer edge values, and a config
    that puts work on both Tensor Core streams."""
    a = power_law_csr(1000, 1000, 8.0, alpha=1.5, seed=7)
    rows, cols, _ = a.to_coo()
    rng = np.random.default_rng(8)
    vals = rng.integers(1, 5, a.nnz) * rng.choice([-1, 1], a.nnz)
    a = coo_to_csr(a.m, a.k, rng.permutation(a.m)[rows], cols,
                   vals.astype(np.float32))
    return gnn.GraphOps(a, spec=ExecSpec(
        device="cuda", backend=backend, reorder=reorder,
        tune=TuneConfig(threshold=2, ts=2, cs=32)))


def _plain(g):
    """The same plans through the plain PyTorch path."""
    plain = copy.copy(g)
    plain.backend = "torch"
    return plain


def _graph_vjps(g, inputs, expanded=False):
    ev, b, dc, x, y, dv = (t.clone() for t in inputs)
    for t in (ev, b, x, y):
        t.requires_grad_()
    out_c, out_s = g.spmm(ev, b), g.sddmm(x, y)
    if expanded:
        (out_c.sum() + out_s.sum()).backward()
    else:
        out_c.backward(dc)
        out_s.backward(dv)
    return [t.detach() for t in (out_c, ev.grad, b.grad, out_s, x.grad,
                                 y.grad)]


def _graph_inputs(g, card, integers, width=40):
    gen = torch.Generator().manual_seed(9)
    return [_data(gen, integers, *shape).to(card) for shape in (
        (g.nnz,), (g.k, width), (g.m, width), (g.m, width), (g.k, width),
        (g.nnz,))]


@pytest.mark.parametrize("integers", [True, False], ids=["int", "rand"])
@pytest.mark.parametrize("reorder", ["off", "on"])
def test_graphops_backward_through_kernels_matches_plain(card, reorder,
                                                         integers):
    """``spmm``'s and ``sddmm``'s outputs and cotangents through K1–K4
    (A, Aᵀ and SDDMM(A) plans) against the plain path: exact on integers,
    TF32's tolerance on random data."""
    g = _training_graph(card, reorder)
    for arrs in (g.arrs, g.arrs_t, g.arrs_sd):
        assert arrs.plan.meta["tc_nnz"] and arrs.plan.meta["vpu_nnz"]
        assert arrs.plan.meta["reorder"]["enabled"] == (reorder == "on")
    inputs = _graph_inputs(g, card, integers)
    kernels.reset_launch_counts()
    got = _graph_vjps(g, inputs)
    counts = kernels.launch_counts()
    # Forward: A and SDDMM(A); backward: Aᵀ and SDDMM(A) for spmm, A and
    # Aᵀ for sddmm.
    assert counts == {"spmm_mxu": 4, "spmm_vpu": 4, "sddmm_mxu": 2,
                      "sddmm_vpu": 2, "flash_attention": 0}
    for out, want in zip(got, _graph_vjps(_plain(g), inputs)):
        _agree_tf32(out, want, integers)


def test_graphops_expanded_cotangent_reaches_the_kernels(card):
    """``sum().backward()`` hands in stride-0 cotangents: the backward
    makes them contiguous for the kernels and gives the dense
    cotangent's result bit for bit."""
    g = _training_graph(card, "on")
    inputs = _graph_inputs(g, card, True)
    ones = [torch.ones(g.m, 40, device=card), torch.ones(g.nnz, device=card)]
    dense = _graph_vjps(g, inputs[:2] + ones[:1] + inputs[3:5] + ones[1:])
    for got, want in zip(_graph_vjps(g, inputs, expanded=True), dense):
        assert torch.equal(got, want)


@pytest.mark.parametrize("model_name", ["gcn", "agnn"])
@pytest.mark.parametrize("reorder", ["off", "on"])
def test_training_step_through_kernels_matches_plain(card, reorder,
                                                     model_name):
    """One SGD step of GCN and AGNN ``[40, 64, 8]``: loss, gradients and
    updated weights through the kernels against the plain path, within
    TF32's tolerance (random features)."""
    g = _training_graph(card, reorder)
    gen = torch.Generator().manual_seed(10)
    cls = gnn.GCN if model_name == "gcn" else gnn.AGNN
    model = cls([40, 64, 8], generator=gen).to(card)
    x = torch.randn(g.m, 40, generator=gen).to(card)
    labels = torch.randint(0, 8, (g.m,), generator=gen).to(card)
    args = ((torch.from_numpy(gnn.gcn_norm_edges(g.a)).to(card),)
            if model_name == "gcn" else ())
    models = [model, copy.deepcopy(model)]
    losses = [gnn.train_step(mdl, gg, x, labels, *args, lr=0.2)
              for mdl, gg in zip(models, (g, _plain(g)))]
    _agree_tf32(losses[0], losses[1], False)
    for p, q in zip(*(mdl.parameters() for mdl in models)):
        _agree_tf32(p.grad, q.grad, False)
        _agree_tf32(p.detach(), q.detach(), False)


# ------------------------------------------------------------ the tuner ---
@pytest.mark.parametrize("op_name", ["spmm", "sddmm"])
def test_search_on_the_card_runs_every_candidate(card, op_name, tmp_path):
    """``tune="search"`` with ``tune_backend="cuda"``: every candidate runs
    through both kernels of its operator on the card (one warm-up and
    three timed applies each), the pick's output equals the plain path
    exactly on integer data, and a second construction against the same
    cache launches nothing."""
    from repro_torch.tune import sddmm_candidates, spmm_candidates

    a = power_law_csr(3000, 2500, 9.0, seed=5)
    rng = np.random.default_rng(6)
    a.data[:] = rng.integers(1, 5, a.nnz) * rng.choice([-1, 1], a.nnz)
    spec = ExecSpec(tune="search", tune_backend="cuda", tune_n=40,
                    tune_kf=40, tune_cache=str(tmp_path), device="cuda")
    if op_name == "spmm":
        cls, kerns = LibraSpMM, ("spmm_mxu", "spmm_vpu")
        ncand = len(spmm_candidates(a, n=40, mode="hybrid", threshold=None,
                                    backend="cuda"))
        args = (torch.from_numpy(rng.integers(-4, 5, (a.k, 40)).astype(
            np.float32)).to(card),)
    else:
        cls, kerns = LibraSDDMM, ("sddmm_mxu", "sddmm_vpu")
        ncand = len(sddmm_candidates(a, kf=40, mode="hybrid",
                                     threshold=None, backend="cuda"))
        args = tuple(torch.from_numpy(rng.integers(-4, 5, (rows, 40)).astype(
            np.float32)).to(card) for rows in (a.m, a.k))
    kernels.reset_launch_counts()
    op = cls(a, spec=spec)
    counts = kernels.launch_counts()
    assert ncand >= 4
    assert [counts[k] for k in kerns] == [4 * ncand] * 2
    assert op.tune_config.source == "search"
    assert torch.equal(op(*args), op(*args, backend="torch"))
    kernels.reset_launch_counts()
    again = cls(a, spec=spec)
    assert again.tune_config.source == "cache"
    assert again.tune_config.replace(source="x") == \
        op.tune_config.replace(source="x")
    assert not any(kernels.launch_counts().values())


def test_median_timer_waits_for_the_card(card):
    """A rep that only queues about 25 ms of device sleep reads as that
    long: the timer synchronizes the card around each rep."""
    from repro_torch.tune import median_timer

    seconds = median_timer(reps=3, warmup=1)(
        lambda: torch.cuda._sleep(50_000_000))
    assert seconds > 5e-3


# --------------------------------------------------------- serving tier ---
def _serving_ops(card, seed=3):
    """A mixed matrix with non-zero integer values, with SpMM and SDDMM
    plans that put work on all four kernels."""
    from repro_torch.serve import as_csr

    a = mixed_csr(1024, 1024, seed=seed)
    rng = np.random.default_rng(seed)
    a = as_csr(a, (rng.integers(1, 5, a.nnz)
                   * rng.choice([-1, 1], a.nnz)).astype(np.float32))
    spmm = LibraSpMM(a, spec=ExecSpec(device="cuda", tune=TuneConfig(
        threshold=6, bk=32, ts_tile=32, ts=4, cs=128)))
    sddmm = LibraSDDMM(a, spec=ExecSpec(device="cuda", tune=TuneConfig(
        threshold=1, bk=16, ts_tile=32, ts=8, cs=128)))
    assert spmm.plan.meta["tc_nnz"] and spmm.plan.meta["vpu_nnz"]
    assert sddmm.plan.meta["tc_nnz"]
    return a, rng, spmm, sddmm


def _ints_on(rng, card, *shape):
    return torch.from_numpy(rng.integers(-4, 5, shape).astype(
        np.float32)).to(card)


@pytest.mark.parametrize("revalued", [False, True],
                         ids=["plan_values", "edge_vals"])
def test_stack_applies_match_looped_single_applies(card, revalued):
    """``spmm_apply_stack``/``sddmm_apply_stack`` run K1–K4 panel by
    panel: each panel equals its single apply bit for bit."""
    from repro_torch.kernels import ops

    a, rng, spmm, sddmm = _serving_ops(card)
    b = _ints_on(rng, card, 3, a.k, 64)
    ev = _ints_on(rng, card, 3, a.nnz) if revalued else None
    arrs = spmm.arrays.for_backend("cuda", revalue=revalued)
    kernels.reset_launch_counts()
    got = ops.spmm_apply_stack(arrs, b, m=spmm.m, nwin=spmm.nwin,
                               edge_vals=ev)
    assert kernels.spmm_mxu.launches == kernels.spmm_vpu.launches == 3
    for i in range(3):
        t = arrs if ev is None else ref.revalue_spmm_arrays(arrs, ev[i])
        assert torch.equal(got[i], ops.spmm_apply(t, b[i], m=spmm.m,
                                                  nwin=spmm.nwin))
    x = _ints_on(rng, card, 2, a.m, 64)
    y = _ints_on(rng, card, 2, a.k, 64)
    sd = sddmm.arrays.for_backend("cuda")
    got = ops.sddmm_apply_stack(sd, x, y, nnz=sddmm.nnz)
    for i in range(2):
        assert torch.equal(got[i], ops.sddmm_apply(sd, x[i], y[i],
                                                   nnz=sddmm.nnz))
    assert kernels.sddmm_mxu.launches >= 4 and kernels.sddmm_vpu.launches


@pytest.mark.parametrize("budget", [None, 1024 * 32 * 4],
                         ids=["whole", "32col"])
def test_packed_spmm_matches_direct_panels(card, budget):
    """Four 64-wide panels packed into one 256-wide apply of K1 and K2
    equal the direct 64-wide applies bit for bit. The packed width spans
    two of K2's column slices (128 float4 columns each), and with a
    patched L2 budget eight 32-column ones against two for a panel."""
    from repro_torch.kernels.spmm_vpu import slice_cols
    from repro_torch.serve import GraphRegistry, SparseEngine, registry

    a, rng, _, _ = _serving_ops(card)
    reg = GraphRegistry(width_buckets=(64,), panel_buckets=(1, 2, 4),
                        tune=TuneConfig(threshold=6, bk=32, ts_tile=32,
                                        ts=4, cs=128))
    reg.register(a, name="g", ops=("spmm",))
    entry = reg.resolve("g")
    with mock.patch.object(registry, "PACK_BUDGET_BYTES", 1 << 40):
        assert reg.pack_limit(entry, 64) == 4
    op = entry.op("spmm").op
    bs = [_ints_on(rng, card, a.k, 64) for _ in range(4)]
    eng = SparseEngine(reg)
    patch = (mock.patch.object(_build, "L2_SLICE_BYTES", budget)
             if budget else mock.patch.object(_build, "L2_SLICE_BYTES",
                                              _build.L2_SLICE_BYTES))
    with patch, mock.patch.object(registry, "PACK_BUDGET_BYTES", 1 << 40):
        assert slice_cols(a.k, 256, True) < 256
        rids = [eng.submit("g", "spmm", b=b) for b in bs]
        out = eng.flush()
        assert eng.stats()["panels_executed"] == 1
        for rid, b in zip(rids, bs):
            assert torch.equal(out[rid], op(b))
    assert not eng.health()["failures"]


@pytest.mark.parametrize("kind", ["spmm", "sddmm"])
def test_unsegmented_path_matches_segmented(card, kind):
    """The serving ladder's ``unsegmented`` rung: K1–K4 over the compact
    tables (with their own real lengths) give the segmented apply's
    result bit for bit."""
    from repro_torch.kernels import ops

    a, rng, spmm, sddmm = _serving_ops(card, seed=4)
    kernels.reset_launch_counts()
    if kind == "spmm":
        b = _ints_on(rng, card, a.k, 128)
        flat = spmm.arrays.for_backend("cuda", segmented=False)
        assert "tc_vals" in flat and "tc_seg_vals" not in flat
        got = ops.spmm_apply(flat, b, m=spmm.m, nwin=spmm.nwin)
        want = spmm(b)
        names = ("spmm_mxu", "spmm_vpu")
    else:
        x = _ints_on(rng, card, a.m, 128)
        y = _ints_on(rng, card, a.k, 128)
        flat = sddmm.arrays.for_backend("cuda", segmented=False)
        assert "tc_cols" in flat and "tc_seg_cols" not in flat
        got = ops.sddmm_apply(flat, x, y, nnz=sddmm.nnz)
        want = sddmm(x, y)
        names = ("sddmm_mxu", "sddmm_vpu")
    counts = kernels.launch_counts()
    assert all(counts[n] >= 2 for n in names), counts
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["spmm", "sddmm"])
def test_card_ladder_ends_above_the_plain_path(card, kind):
    """On the card the ladder stops at ``unsegmented``: with the kernel
    rungs all failing, the request comes back as a typed
    ``ExecutionFailed`` and the plain path never answers it."""
    from repro_torch.serve import (
        ExecutionFailed,
        FaultPlan,
        FaultRule,
        GraphRegistry,
        SparseEngine,
    )

    a, rng, _, _ = _serving_ops(card)
    reg = GraphRegistry(width_buckets=(64,), tune=TuneConfig(
        threshold=6, bk=32, ts_tile=32, ts=4, cs=128))
    reg.register(a, name="g", ops=(kind,))
    plan = FaultPlan([FaultRule(kth=1, graph="g", strategy=s, times=-1)
                      for s in ("fast", "single", "unsegmented")])
    eng = SparseEngine(reg, faults=plan, sleep=lambda s: None)
    if kind == "spmm":
        rid = eng.submit("g", "spmm", b=_ints_on(rng, card, a.k, 64))
    else:
        rid = eng.submit("g", "sddmm", x=_ints_on(rng, card, a.m, 64),
                         y=_ints_on(rng, card, a.k, 64))
    got = eng.flush()[rid]
    assert isinstance(got, ExecutionFailed) and got.reason == "injected"
    h = eng.health()
    assert not h["degraded_served"]
    assert "torch" not in eng._applies.series()


# ---------------------------------------------------------- sharded path ---
def _sharded_matrix(card):
    """The serving tier's integer mixed matrix, partitioned into 8
    window shards with plans that put work on all four kernels."""
    from repro_torch.dist import ShardMesh, partition_sddmm, partition_spmm

    a, rng, spmm, sddmm = _serving_ops(card)
    mesh = ShardMesh([card] * 8)
    part = partition_spmm(a, 8, spec=spmm.spec)
    sd = partition_sddmm(a, 8, spec=sddmm.spec)
    return a, rng, spmm, sddmm, mesh, part, sd


def _nan_empty(monkeypatch):
    """Make every ``torch.empty`` float tensor start as NaN, so a kernel
    that leaves an output element unwritten shows it."""
    real = torch.empty

    def nan_empty(*args, **kwargs):
        t = real(*args, **kwargs)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    monkeypatch.setattr(torch, "empty", nan_empty)


def test_padded_shard_segments_write_zeros(card, monkeypatch):
    """Every shard is padded to the largest shard's segment count: K1's
    padded segments (real length 0, one slab each, ``torch.empty``
    output) and K2's padded rows must still write zeros, or the combine
    adds garbage into local row 0."""
    from repro_torch.kernels import spmm_mxu, spmm_vpu

    a, rng, _, _, mesh, part, _ = _sharded_matrix(card)
    counts = [(part.stacked["tc_seg_pos"][p].max(axis=(1, 2)) >= 0).sum()
              for p in range(8)]
    p = int(np.argmin(counts))
    arrs = part.arrays(p, card).for_backend("cuda")
    ns = arrs["tc_seg_rank"].shape[0]
    assert counts[p] < ns and (arrs["tc_len"][counts[p]:] == 0).all()
    pad_rows = (arrs["vpu_len"] == 0).nonzero().flatten()
    assert pad_rows.numel() > 0
    b = _ints_on(rng, card, int(part.stacked["halo"].shape[1]), 256)
    _nan_empty(monkeypatch)
    tc = spmm_mxu(arrs["tc_seg_vals"], arrs["tc_seg_cols"],
                  arrs["tc_seg_rank"], b, n_active=ns, unique_ranks=True,
                  seg_len=arrs["tc_len"])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(tc).all())
    assert (tc[counts[p] * 8:] == 0).all()
    assert torch.equal(tc, ref.spmm_tc_compact_ref(
        arrs["tc_seg_vals"], arrs["tc_seg_cols"], arrs["tc_seg_rank"], b,
        ns))
    vpu = spmm_vpu(arrs["vpu_seg_vals"], arrs["vpu_seg_cols"], b,
                   seg_len=arrs["vpu_len"])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(vpu).all())
    assert (vpu[pad_rows] == 0).all()


@pytest.mark.parametrize("layout", ["replicated", "rowshard"])
def test_sharded_applies_equal_single_device(card, layout):
    """``spmm_sharded``/``sddmm_sharded`` over 8 shards on the card equal
    the single-device operators bit for bit on integer data, and every
    shard launches K1–K4."""
    from repro_torch.dist import sddmm_sharded, spmm_sharded

    a, rng, spmm, sddmm, mesh, part, sd = _sharded_matrix(card)
    b, ev = _ints_on(rng, card, a.k, 256), _ints_on(rng, card, a.nnz)
    x, y = _ints_on(rng, card, a.m, 128), _ints_on(rng, card, a.k, 128)
    kernels.reset_launch_counts()
    got = spmm_sharded(part, b, mesh=mesh, b_layout=layout)
    got_ev = spmm_sharded(part, b, mesh=mesh, b_layout=layout, edge_vals=ev)
    got_sd = sddmm_sharded(sd, x, y, mesh=mesh, y_layout=layout)
    counts = kernels.launch_counts()
    assert counts["spmm_mxu"] == counts["spmm_vpu"] == 16
    assert counts["sddmm_mxu"] >= 8 and counts["sddmm_vpu"] >= 8
    assert torch.equal(got, spmm(b))
    assert torch.equal(got_sd, sddmm(x, y))
    g = gnn.GraphOps(a, spec=spmm.spec)
    assert torch.equal(got_ev, g._a_apply(ev, b))


def test_dist_graphops_training_step_matches_plain(card):
    """One GCN SGD step through ``DistGraphOps`` (8 shards, K1–K4) against
    the same partitions on the plain path, within TF32's tolerance."""
    from repro_torch.dist import DistGraphOps, ShardMesh

    a = _training_graph(card, "off").a
    g = DistGraphOps(a, ShardMesh([card] * 8), spec=ExecSpec(
        device="cuda", tune=TuneConfig(threshold=2, ts=2, cs=32)))
    gen = torch.Generator().manual_seed(11)
    model = gnn.GCN([40, 64, 8], generator=gen).to(card)
    x = torch.randn(g.m, 40, generator=gen).to(card)
    labels = torch.randint(0, 8, (g.m,), generator=gen).to(card)
    norm = torch.from_numpy(gnn.gcn_norm_edges(a)).to(card)
    models = [model, copy.deepcopy(model)]
    kernels.reset_launch_counts()
    loss = gnn.train_step(models[0], g, x, labels, norm, lr=0.2)
    counts = kernels.launch_counts()
    # Forward A and backward A^T, each layer and each shard (GCN's fixed
    # edge values need no SDDMM).
    assert counts["spmm_mxu"] == counts["spmm_vpu"] == 2 * 2 * 8
    want = gnn.train_step(models[1], _plain(g), x, labels, norm, lr=0.2)
    _agree_tf32(loss, want, False)
    for p, q in zip(*(mdl.parameters() for mdl in models)):
        _agree_tf32(p.grad, q.grad, False)


# ----------------------------------------------- the attention backward --
@pytest.mark.parametrize("chunk", [128, 1024])
def test_backward_holds_near_uniform_attention_on_the_card(card, chunk):
    """K5's Function on the card, keys over four chunks (Δ from the pass
    ahead of the loop) and in one: every gradient within 1e-2·max|ref| of
    autograd through the twin in fp32 on the same bf16 values, on
    near-uniform attention over values that share one large component
    (where ``rowsum(dO∘O)`` over the bf16 O lands about 10% away)."""
    g = torch.Generator(card).manual_seed(5)
    b, s, h, d = 2, 512, 4, 64
    q, k = (0.05 * torch.randn((b, s, h, d), generator=g, device=card)
            for _ in range(2))
    v = (4 * torch.randn((1, 1, h, d), generator=g, device=card)
         + 0.1 * torch.randn((b, s, h, d), generator=g, device=card))
    ct = torch.randn((b, s, h, d), generator=g, device=card)
    q, k, v, ct = (t.to(torch.bfloat16) for t in (q, k, v, ct))
    exact = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_ref(*exact, causal=True),
                               exact, ct.float())
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kernels.reset_launch_counts()
    got = torch.autograd.grad(fa.flash_attention_grad(*ins, causal=True,
                                                      chunk=chunk), ins, ct)
    assert kernels.launch_counts()["flash_attention"] == 1
    for label, a, w in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16, label
        err = (a.float() - w).abs().max().item()
        assert err <= 1e-2 * w.abs().max().item(), (label, err)


# ------------------------------------------------- placement on a mesh --
def _per_group(p, x, cfg, gd, gm):
    """The no-mesh MoE functions composed by hand over gd × gm token
    groups at the group's capacity."""
    from repro_torch.models import moe

    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cd = layers.dtype_of(cfg, "compute_dtype")
    bl, sl = b // gd, s // gm
    tg = bl * sl
    cap = max(4, min(int(cfg.capacity_factor * tg * k / e), tg))
    topv, topi, _ = moe.router_topk(x.float() @ p["router"], k)
    rows = []
    for di in range(gd):
        cols = []
        for mj in range(gm):
            blk = (slice(di * bl, (di + 1) * bl),
                   slice(mj * sl, (mj + 1) * sl))
            buf, slot = moe._local_dispatch(
                x[blk].reshape(tg, d), topi[blk].reshape(tg, k), e, k, cap,
                cd)
            cols.append(moe._local_combine(
                moe._experts(p, buf, cd), slot,
                topv[blk].reshape(tg, k).to(cd)).reshape(bl, sl, d))
        rows.append(torch.cat(cols, dim=1))
    return torch.cat(rows) + layers.mlp_block(p["shared"], x, cfg)


def test_expert_parallel_exchange_matches_per_group_composition(card):
    """moonshot's MoE block on a (2, 4) mesh of ``cuda:0`` positions
    against the no-mesh functions over the 8 groups, forward and
    backward (the exchange's backward is the mirrored exchange), both in
    bf16 within 2e-2·max|ref|; a (1, 1) mesh equals no mesh bit for
    bit."""
    from repro_torch.dist import sharding as sh
    from repro_torch.models import moe

    cfg = get_smoke_config("moonshot_v1_16b_a3b").scaled(n_layers=1)
    model = api.init_params(torch.Generator(card).manual_seed(0), cfg,
                            device=card)
    p = model.layers[0].moe
    g = torch.Generator(card).manual_seed(1)
    x = torch.randn((4, 64, cfg.d_model), generator=g, device=card).to(
        torch.bfloat16).requires_grad_(True)
    with sh.activation_context(sh.make_mesh((2, 4), ("data", "model"))):
        out, _ = moe.moe_block(p, x, cfg)
    want = _per_group(p, x, cfg, 2, 4)
    _close(out, want)
    ct = torch.randn(out.shape, generator=g, device=card).to(out.dtype)
    wrt = [x, p["wi_gate"], p["wo"]]
    for a, b in zip(torch.autograd.grad(out, wrt, ct),
                    torch.autograd.grad(want, wrt, ct)):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= REL * b.float().abs().max().item(), err
    with torch.no_grad():
        plain, _ = moe.moe_block(p, x, cfg)
        with sh.activation_context(sh.make_mesh((1, 1), ("data", "model"))):
            one, _ = moe.moe_block(p, x, cfg)
    assert torch.equal(plain, one)


def test_exchange_dispatch_backward_is_each_groups_own_in_bf16(card):
    """The grouped dispatch of the exchange in bf16 on the card: the
    tokens' gradient equals each group's own dispatch's bit for bit, and
    a second run's, since a token's k slot gradients add in a fixed order
    (``index_put_`` after a sort, where ``torch.gather``'s backward adds
    them with atomics in an order that changes from run to run). The MoE
    block's gradients on a (2, 4) mesh repeat bit for bit."""
    from repro_torch.dist import sharding as sh
    from repro_torch.models import moe

    cfg = get_smoke_config("moonshot_v1_16b_a3b").scaled(n_layers=1)
    e, k, g, t, d = cfg.n_experts, cfg.top_k, 8, 256, cfg.d_model
    gen = torch.Generator(card).manual_seed(2)
    x = torch.randn((g, t, d), generator=gen, device=card).to(
        torch.bfloat16).requires_grad_(True)
    _, topi, _ = moe.router_topk(
        torch.randn((g, t, e), generator=gen, device=card), k)
    cap = moe._capacity(cfg, t, 4)
    ct = torch.randn((g, e, cap, d), generator=gen, device=card).to(
        torch.bfloat16)

    def grouped():
        return moe._dispatch_groups(x, topi, e, k, cap, torch.bfloat16)[0]

    def apart():
        return torch.stack([moe._local_dispatch(
            x[i], topi[i], e, k, cap, torch.bfloat16)[0] for i in range(g)])

    want = torch.autograd.grad(apart(), x, ct)[0]
    for _ in range(2):
        assert torch.equal(torch.autograd.grad(grouped(), x, ct)[0], want)

    model = api.init_params(torch.Generator(card).manual_seed(0), cfg,
                            device=card)
    p = model.layers[0].moe
    xb = torch.randn((4, 64, d), generator=gen, device=card).to(
        torch.bfloat16).requires_grad_(True)
    ctb = torch.randn(xb.shape, generator=gen, device=card).to(
        torch.bfloat16)
    runs = []
    for _ in range(2):
        with sh.activation_context(sh.make_mesh((2, 4), ("data", "model"))):
            out, _ = moe.moe_block(p, xb, cfg)
        runs.append(torch.autograd.grad(out, [xb, p["wi_gate"], p["wo"]],
                                        ctb))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs two cards")
def test_expert_parallel_exchange_over_two_cards(card):
    """moonshot's MoE block on a round-robin (1, 2) mesh, its positions on
    ``cuda:0`` and ``cuda:1`` (each rank's experts run on its own card
    from weights brought there), equals the same mesh with both positions
    on ``cuda:0``, forward and backward; the launchers' mesh keeps every
    position on the model's card."""
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.train import mesh_on
    from repro_torch.models import moe

    cfg = get_smoke_config("moonshot_v1_16b_a3b").scaled(n_layers=1)
    model = api.init_params(torch.Generator(card).manual_seed(0), cfg,
                            device=card)
    p = model.layers[0].moe
    g = torch.Generator(card).manual_seed(1)
    x = torch.randn((2, 64, cfg.d_model), generator=g, device=card).to(
        torch.bfloat16).requires_grad_(True)
    ct = torch.randn((2, 64, cfg.d_model), generator=g, device=card).to(
        torch.bfloat16)
    outs, grads = [], []
    for mesh in (sh.Mesh((1, 2), ("data", "model"), ["cuda:0", "cuda:1"]),
                 sh.Mesh((1, 2), ("data", "model"), "cuda:0")):
        with sh.activation_context(mesh):
            out, _ = moe.moe_block(p, x, cfg)
        outs.append(out)
        grads.append(torch.autograd.grad(out, [x, p["wi_gate"], p["wo"]],
                                         ct))
    assert outs[0].device == x.device
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    launch = mesh_on(card)
    assert launch.shape["model"] * launch.shape["data"] == \
        torch.cuda.device_count()
    assert {d for d in launch.devices.flat} == {
        torch.device("cuda", torch.cuda.current_device())}


def test_k5_through_a_kv_repeat_equals_no_repeat(card):
    """gemma2's 16/8 heads at D=256 under a model axis of 16: K and V are
    repeated twice and K5 runs at 16/16, giving the 16/8 output bit for
    bit."""
    from repro_torch.dist import sharding as sh

    q, k, v = _qkv(card, 1, 640, 640, 16, 8, 256, torch.bfloat16, seed=3)
    kw = dict(causal=True, window=4096, softcap_val=50.0)
    seen = []
    real = layers.flash_attention_fused

    def spy(q_, k_, v_, **kw_):
        seen.append(k_.shape[2])
        return real(q_, k_, v_, **kw_)

    kernels.reset_launch_counts()
    with mock.patch.object(layers, "flash_attention_fused", spy):
        with sh.activation_context(sh.make_mesh((1, 16), ("data",
                                                          "model"))):
            got = layers.flash_attention(q, k, v, **kw)
        want = layers.flash_attention(q, k, v, **kw)
    assert seen == [16, 8]
    assert kernels.launch_counts()["flash_attention"] == 2
    assert torch.equal(got, want)


def test_crosspod_compression_on_the_card_equals_the_cpu(card):
    """``compress_tree`` and ``crosspod_mean_compressed`` over 4 members:
    the card's quantized payloads, scales, means and errors equal the
    CPU's bit for bit."""
    from repro_torch.train import compress

    g = torch.Generator(card).manual_seed(7)
    trees = [{"a": torch.randn((64, 48), generator=g, device=card),
              "b": {"c": 3 * torch.randn((1000,), generator=g,
                                         device=card)}}
             for _ in range(4)]
    errs = [compress.init_error_state(t) for t in trees]
    errs[1]["a"] += 1e-3
    cpu = lambda tree: {k: cpu(v) if isinstance(v, dict) else v.cpu()
                        for k, v in tree.items()}
    for got, want in zip(
            compress.compress_tree(trees[0], errs[1]),
            compress.compress_tree(cpu(trees[0]), cpu(errs[1]))):
        assert torch.equal(got["a"].cpu(), want["a"])
        assert torch.equal(got["b"]["c"].cpu(), want["b"]["c"])
    outs, new = compress.crosspod_mean_compressed(trees, errs)
    outs_c, new_c = compress.crosspod_mean_compressed(
        [cpu(t) for t in trees], [cpu(e) for e in errs])
    for got, want in zip(outs + new, outs_c + new_c):
        assert got["a"].device.type == "cuda"
        assert torch.equal(got["a"].cpu(), want["a"])
        assert torch.equal(got["b"]["c"].cpu(), want["b"]["c"])


# ------------------------------------------------------------ the reports --
def _counted_forward(cfg, where):
    from repro_torch.launch import hlo_analysis as H

    gen = torch.Generator(where).manual_seed(0) if where.type == "cuda" \
        else None
    model = api.init_params(gen, cfg, device=where)
    toks = torch.zeros((2, 256), dtype=torch.int32, device=where)

    def fwd(model, batch):
        with torch.no_grad():
            return api.forward_logits(model, batch, cfg)[0]

    return H.analyze_step(fwd, model, {"tokens": toks})


def test_counter_on_the_card_equals_the_meta_trace(card):
    """A 2-layer gemma2 smoke forward (head dim 64, the smallest K5 is
    built for) counted on the card equals its ``meta`` trace: flops,
    bytes, ops and peak live bytes; K5's counted calls equal its
    launches."""
    cfg = get_smoke_config("gemma2-9b").scaled(d_head=64)
    kernels.reset_launch_counts()
    on_card = _counted_forward(cfg, card)
    launched = kernels.launch_counts()["flash_attention"]
    on_meta = _counted_forward(cfg, torch.device("meta"))
    for field in ("flops", "hbm_bytes", "flops_by_dtype", "by_op",
                  "kernel_calls", "arg_bytes", "temp_bytes"):
        assert getattr(on_card, field) == getattr(on_meta, field), field
    assert launched == cfg.n_layers
    assert on_card.by_op["flash_attention"]["calls"] == launched
    assert kernels.launch_counts()["flash_attention"] == launched


def test_meta_call_of_k5_launches_nothing(card):
    """On ``meta`` operands K5's wrapper makes the kernel's checks and
    returns empty outputs; nothing launches, on the card's machine too."""
    q, k, v = (torch.empty(s, dtype=torch.bfloat16, device="meta")
               for s in ((1, 128, 4, 128), (1, 128, 2, 128),
                         (1, 128, 2, 128)))
    kernels.reset_launch_counts()
    out = fa.flash_attention_fused(q, k, v, causal=True)
    assert out.device.type == "meta" and tuple(out.shape) == (1, 128, 4, 128)
    assert kernels.launch_counts()["flash_attention"] == 0
