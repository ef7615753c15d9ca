"""The port's op counter (``repro_torch.launch.hlo_analysis``) on the CPU.

- Hand-built programs: a loop of L matrix products counts exactly
  2·L·B·D² flops, views count 0 bytes, an elementwise op reads its
  inputs and writes its output once, and the peak of live bytes above
  the arguments is known.
- K5 reports its own work (4·D flops a visible (query, key) pair) on the
  CPU, where its twin's aten ops are kept apart, and on ``meta``, where
  the wrapper makes the kernel's checks and launches nothing.
- ``roofline_from_stats`` equals the reference's function field for
  field, given the same stats and a reference ``Hardware`` with the
  H100's numbers.
- Flop parity: every family's smoke ``forward_logits`` at 2 × 256,
  counted with K5's twin added back in place of K5's own report, equals
  the reference's ``analyze_hlo`` of its jitted ``forward_logits``. The
  reference pads the keys of each attention to a multiple of
  ``attn_chunk`` (``src/repro/models/layers.py:103-108``) and multiplies
  the padding in QKᵀ and PV; whisper-tiny's 32 smoke frames pad to its
  chunk of 64 in the encoder's self-attention and the decoder's
  cross-attention, 9,437,184 flops (4.1%) the port does not do. The test
  adds those named products and asserts equality.
- CPU against ``meta``: a training step, a prefill and a decode step of
  every family's smoke config (at head dim 64, the smallest K5 is built
  for: ``meta`` makes the kernel's checks) count the same flops, bytes,
  ops and peak live bytes exactly.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch import hlo_analysis as RH
from repro.models import api as japi
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import hlo_analysis as H
from repro_torch.models import api
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts


@pytest.fixture(autouse=True)
def _no_leaked_activation_context():
    """The reference's model outside any sharding activation context
    (``src/repro/train/train_step.py:33`` can leave one entered)."""
    from repro.dist import sharding

    sharding._ctx.state = None


# ------------------------------------------------- hand-built programs ---
def _loop(ws, x):
    for w in ws:
        x = x @ w
    return x


@pytest.mark.parametrize("L,B,D", [(1, 4, 8), (6, 16, 32), (3, 5, 64)])
def test_loop_of_products_counts_exact_flops(L, B, D):
    g = torch.Generator().manual_seed(0)
    ws = [torch.randn(D, D, generator=g) for _ in range(L)]
    x = torch.randn(B, D, generator=g)
    st = H.analyze_step(_loop, ws, x)
    assert st.flops == 2 * L * B * D * D
    assert st.flops_by_dtype == {"float32": 2.0 * L * B * D * D}
    assert st.by_op["aten.mm"]["calls"] == L
    # Each product reads x and w and writes its output once.
    assert st.hbm_bytes == L * 4 * (B * D + D * D + B * D)
    assert st.arg_bytes == 4 * (L * D * D + B * D)


@pytest.mark.parametrize("view", [
    lambda t: t.view(4, 16), lambda t: t.reshape(2, 32),
    lambda t: t.transpose(0, 1), lambda t: t.permute(1, 0),
    lambda t: t.unsqueeze(0), lambda t: t[1:3], lambda t: t.detach(),
])
def test_views_move_no_bytes_and_allocate_nothing(view):
    x = torch.randn(8, 8)
    st = H.analyze_step(view, x)
    assert st.hbm_bytes == 0
    assert st.temp_bytes == 0
    assert sum(st.op_calls().values()) >= 1


def test_elementwise_reads_inputs_and_writes_its_output():
    x, y = torch.randn(100), torch.randn(100)
    st = H.analyze_step(torch.add, x, y)
    assert st.hbm_bytes == 3 * 400
    assert st.temp_bytes == 400
    assert st.output_bytes == 400 and st.alias_bytes == 0


def test_in_place_op_allocates_nothing_and_aliases_its_argument():
    x = torch.randn(100)
    st = H.analyze_step(lambda t: t.add_(1.0), x)
    assert st.hbm_bytes == 2 * 400
    assert st.temp_bytes == 0
    assert st.alias_bytes == 400


def _chain(x):
    a = x * 2.0             # a: live 1
    b = a + 1.0             # a, b: live 2  <- peak
    del a
    c = b * b               # b, c: live 2
    del b
    return c.sum()          # c and the scalar


@pytest.mark.parametrize("n", [10, 1000])
def test_peak_live_bytes_follow_allocation_and_death(n):
    x = torch.randn(n)
    st = H.analyze_step(_chain, x)
    assert st.arg_bytes == 4 * n
    assert st.temp_bytes == 2 * 4 * n
    assert st.peak_live_bytes == 3 * 4 * n


def test_counter_is_uninstalled_after_the_step():
    H.analyze_step(torch.sin, torch.randn(4))
    assert _build.COUNTERS == []


# ------------------------------------------------------ K5's own report ---
@pytest.mark.parametrize("b,sq,sk,causal,window,q_offset", [
    (1, 64, 64, True, 0, 0), (2, 100, 100, True, 30, 0),
    (1, 7, 90, True, 0, 83), (2, 48, 33, False, 0, 0),
    (1, 40, 120, False, 50, 20), (1, 1, 300, True, 0, 299),
])
def test_visible_pairs_counts_the_unmasked_pairs(b, sq, sk, causal, window,
                                                 q_offset):
    qpos = q_offset + np.arange(sq)[:, None]
    kpos = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    h = 3
    assert fa.visible_pairs(b, sq, sk, h, causal=causal, window=window,
                            q_offset=q_offset) == int(mask.sum()) * b * h


def _qkv(device, b=2, sq=96, sk=96, h=4, kv=2, d=64, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(3)
    mk = lambda s, n: torch.randn(b, s, n, d, generator=g).to(dtype)  # noqa: E731
    return tuple(t.to(device) for t in (mk(sq, h), mk(sk, kv), mk(sk, kv)))


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("want_lse", [False, True])
def test_k5_reports_its_work_and_keeps_its_own_ops_apart(device, want_lse):
    q, k, v = _qkv(device)
    kw = dict(causal=True, window=40, softcap=50.0, q_offset=0)
    launches = fa.flash_attention_fused.launches

    def call(q, k, v):
        if want_lse:
            return fa._forward(q, k, v, True, 40, 50.0, 0, True)
        return fa.flash_attention_fused(q, k, v, **kw)

    st = H.analyze_step(call, q, k, v)
    assert fa.flash_attention_fused.launches == launches
    pairs = fa.visible_pairs(2, 96, 96, 4, causal=True, window=40)
    moved = 2 * (3 * 2 * 96 * 4 * 64) + (4 * 2 * 4 * 96 if want_lse else 0)
    assert st.by_op == {"flash_attention": {
        "flops": 4.0 * 64 * pairs, "bytes": float(moved), "calls": 1}}
    assert st.flops == 4.0 * 64 * pairs and st.hbm_bytes == moved
    assert st.flops_by_dtype == {"bfloat16": 4.0 * 64 * pairs}
    assert st.kernel_calls == {"flash_attention": {"2,96,96,4,2,64": 1}}
    scope = "flash_attention/" + ("twin" if device == "cpu" else "outputs")
    assert list(st.apart) == [scope]
    assert st.temp_bytes == 2 * 96 * 4 * 64 * 2 + (
        2 * 4 * 96 * 4 if want_lse else 0)


@pytest.mark.parametrize("case,exc", [
    (dict(d=48), ValueError), (dict(dtype=torch.float32), TypeError)])
def test_k5_on_meta_makes_the_kernels_checks(case, exc):
    q, k, v = _qkv("meta", **case)
    with pytest.raises(exc):
        fa.flash_attention_fused(q, k, v, causal=True)


def test_k5_on_meta_returns_the_kernels_outputs():
    q, k, v = _qkv("meta", sq=64, sk=128)
    out, lse = fa._forward(q, k, v, True, 0, 0.0, 64, True)
    assert out.device.type == "meta" and tuple(out.shape) == (2, 64, 4, 64)
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    assert tuple(lse.shape) == (2, 4, 64) and lse.dtype == torch.float32


# ------------------------------------------------------------- roofline ---
@pytest.mark.parametrize("flops,hbm,link,mf,n", [
    (3.1e14, 2.5e12, 0.0, 2.0e14, 256), (1e9, 5e11, 0.0, 0.0, 1),
    (5e12, 1e9, 1e12, 4e15, 512), (0.0, 1e6, 0.0, 1e9, 16)])
def test_roofline_equals_the_references_formula(flops, hbm, link, mf, n):
    ref_hw = RH.Hardware(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)
    want = RH.roofline_from_stats(
        RH.HloStats(flops, hbm, {"all-gather": link}, link, 1), ref_hw,
        model_flops_global=mf, n_chips=n)
    got = H.roofline_from_stats(
        H.HloStats(flops, hbm, {"all-gather": link}, link, 1),
        model_flops_global=mf, n_chips=n)
    assert got.as_dict() == want.as_dict()


@pytest.mark.parametrize("n_chips", [1, 4])
def test_roofline_from_step_is_the_counted_step_over_the_chips(n_chips):
    g = torch.Generator().manual_seed(0)
    ws = [torch.randn(32, 32, generator=g) for _ in range(3)]
    x = torch.randn(16, 32, generator=g)
    got = H.roofline_from_step(_loop, ws, x, model_flops_global=1e5,
                               n_chips=n_chips)
    want = H.roofline_from_stats(
        H.analyze_step(_loop, ws, x).per_device(n_chips),
        model_flops_global=1e5, n_chips=n_chips)
    assert got.as_dict() == want.as_dict()
    assert got.flops_per_dev == 2 * 3 * 16 * 32 * 32 / n_chips


def test_compute_time_is_each_dtypes_flops_over_its_own_peak():
    hw = H.Hardware()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)
    st = H.HloStats(3e12, 0.0, {}, 0.0, 0,
                    flops_by_dtype={"bfloat16": 2e12, "float32": 1e12})
    rl = H.roofline_from_stats(st)
    assert rl.compute_s == 2e12 / 989e12 + 1e12 / 67e12
    assert rl.bottleneck == "compute"


# ---------------------------------------------------------- flop parity ---
B, S = 2, 256


def _port_batch(cfg, device="cpu", b=B, s=S, seed=1):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=g,
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    if cfg.family == "audio":
        batch["frame_embeds"] = torch.randn(b, cfg.n_audio_ctx, cfg.d_model,
                                            generator=g)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(b, cfg.n_patches or 256,
                                            cfg.d_model, generator=g)
    return {k: v.to(device) for k, v in batch.items()}


def _ref_forward_flops(arch) -> float:
    jc = j_smoke(arch)
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if jc.family == "audio":
        batch["frame_embeds"] = jax.ShapeDtypeStruct(
            (B, jc.n_audio_ctx, jc.d_model), jnp.float32)
    if jc.family == "vlm":
        batch["patch_embeds"] = jax.ShapeDtypeStruct(
            (B, jc.n_patches or 256, jc.d_model), jnp.float32)
    params = jax.eval_shape(lambda: japi.init_params(jax.random.PRNGKey(0),
                                                     jc))
    compiled = jax.jit(lambda p, b: japi.forward_logits(p, b, jc)[0]).lower(
        params, batch).compile()
    return RH.analyze_hlo(compiled.as_text()).flops


def _padded_key_flops(kernel_calls, chunk) -> float:
    """QKᵀ and PV over the keys the reference pads each attention's keys
    with, up to a multiple of ``attn_chunk``."""
    total = 0.0
    for key, calls in kernel_calls.items():
        b, sq, sk, h, _, d = map(int, key.split(","))
        pad = math.ceil(sk / chunk) * chunk - sk
        total += calls * 4.0 * b * h * sq * d * pad
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_flops_equal_the_references_hlo(arch):
    cfg = get_smoke_config(arch)
    model = api.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    batch = _port_batch(cfg)

    def fwd(model, batch):
        with torch.no_grad():
            return api.forward_logits(model, batch, cfg)[0]

    st = H.analyze_step(fwd, model, batch)
    k5 = st.by_op.get("flash_attention", {"flops": 0.0})["flops"]
    twin = st.apart.get("flash_attention/twin", {"flops": 0.0})["flops"]
    padded = _padded_key_flops(st.kernel_calls.get("flash_attention", {}),
                               cfg.attn_chunk)
    assert (padded > 0) == (arch == "whisper_tiny")
    if arch == "whisper_tiny":
        assert padded == 9437184.0
    assert st.flops - k5 + twin + padded == _ref_forward_flops(arch)


# ------------------------------------------------------ CPU against meta ---
def _programs(arch, device):
    """The three steps of the smoke config at head dim 64 on ``device``:
    kind → (fn, args)."""
    cfg = get_smoke_config(arch)
    if cfg.n_heads:
        cfg = cfg.scaled(d_head=64)
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(0) if device == "cpu" else None
    model = api.init_params(gen, cfg, device=dev)
    batch = _port_batch(cfg, dev, s=128)
    ocfg = opt.OptConfig()
    state = opt.init_opt_state(dict(model.named_parameters()), ocfg)

    def prefill(model, batch):
        with torch.no_grad():
            return api.forward_logits(model, batch, cfg)[0]

    cache = api.init_cache(cfg, B, 136, device=dev)
    serve = ts.make_serve_step(cfg)

    def decode(model, cache, token):
        with torch.no_grad():
            return serve(model, cache, token, 128)

    return {"train": (ts.make_train_step(cfg, ocfg), (model, state, batch)),
            "prefill": (prefill, (model, {k: v for k, v in batch.items()
                                          if k != "labels"})),
            "decode": (decode, (model, cache, batch["tokens"][:, :1]))}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_and_meta_counts_agree_exactly(arch, kind):
    got = {}
    for device in ("cpu", "meta"):
        fn, args = _programs(arch, device)[kind]
        got[device] = H.analyze_step(fn, *args)
    cpu, meta = got["cpu"], got["meta"]
    for field in ("flops", "hbm_bytes", "flops_by_dtype", "by_op",
                  "kernel_calls", "arg_bytes", "temp_bytes",
                  "output_bytes", "alias_bytes"):
        assert getattr(cpu, field) == getattr(meta, field), field
    assert cpu.flops > 0 and cpu.temp_bytes > 0
    k5 = cpu.by_op.get("flash_attention", {}).get("calls", 0)
    assert (k5 > 0) == (kind != "decode" and bool(get_smoke_config(arch)
                                                  .n_heads))
    assert set(cpu.apart) <= {"flash_attention/twin"}
    assert set(meta.apart) <= {"flash_attention/outputs"}
