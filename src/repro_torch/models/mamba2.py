"""Mamba2 (SSD, state-space duality) LM as an ``nn.Module``, chunked scan.

Mirrors ``repro.models.mamba2``: the quadratic-intra-chunk /
linear-inter-chunk SSD algorithm (arXiv:2405.21060). The sequence is cut
into chunks of ``ssm_chunk`` tokens; within a chunk the recurrence is an
attention-like masked product, across chunks a short loop carries the
(H, P, N) state. The reference computes the SSD outside any Pallas
kernel, so here it is plain PyTorch: ``torch.einsum`` in fp32, and the
inter-chunk recurrence a Python loop over the chunks in fp32.

Projections stay separate (``wz``/``wx``/``wb``/``wc``/``wdt``), as the
reference keeps them for sharding; one card has no mesh, so its
``constrain`` calls (identities outside one) are dropped.

The residual stream between layers stays in fp32 (each layer's input
norm rounds to the compute type once, where the reference's norm of a
compute-type stream rounds). The reference keeps the stream in the
compute type; in bf16 its rounding at every residual add quantizes the
stream coarsely once it has grown over many layers, which amplifies
summation-order noise: on an H100, zamba2-7b's logits through K5 and
through its twin (the same rounding points, fp32 sums in another order)
moved apart by 4.1% of max|logit| with a bf16 stream and 1.9% with an
fp32 one, and decode against forward by 5.3% and 3.6%. In fp32 compute
nothing changes.

Each layer (:class:`Mamba2Layer`) holds the reference's leaves under
their names: ``norm``, ``wz``, ``wx``, ``wb``, ``wc``, ``wdt``,
``conv_x``, ``conv_b``, ``conv_c``, ``a_log``, ``d_skip``, ``dt_bias``,
``gate_norm``, ``out_proj``. With ``cfg.remat`` and grad enabled each
layer of :meth:`Mamba2LM.forward` runs under ``torch.utils.checkpoint``
(non-reentrant), the reference's per-layer ``jax.checkpoint(...,
policy=nothing_saveable)``: the backward recomputes the layer's SSD from
its input. Decoding (:meth:`Mamba2LM.decode_step`)
carries an O(1) cache: each layer's recurrent state and the last
``ssm_conv - 1`` inputs of its causal convolutions, updated in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.api import checked_device
from repro_torch.dist import sharding as sh
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig


def _dims(cfg: ArchConfig):
    """(d_inner, heads, head dim, state size) of the SSD."""
    return cfg.ssm_d_inner, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state


class Mamba2Layer(nn.Module):
    """One pre-norm Mamba2 block's parameters (``init_layer``)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator | None,
                 device):
        super().__init__()
        d = cfg.d_model
        d_in, h, _, n = _dims(cfg)
        pd = L.dtype_of(cfg, "param_dtype")
        sc = 1.0 / math.sqrt(d)

        f32 = dict(dtype=torch.float32, device=device)
        self.norm = nn.Parameter(L.init_norm(cfg, device))
        self.wz = nn.Parameter(L._normal(gen, (d, d_in), sc, pd, device))
        self.wx = nn.Parameter(L._normal(gen, (d, d_in), sc, pd, device))
        self.wb = nn.Parameter(L._normal(gen, (d, n), sc, pd, device))
        self.wc = nn.Parameter(L._normal(gen, (d, n), sc, pd, device))
        self.wdt = nn.Parameter(L._normal(gen, (d, h), sc, pd, device))
        self.conv_x = nn.Parameter(
            L._normal(gen, (d_in, cfg.ssm_conv), 0.1, pd, device))
        self.conv_b = nn.Parameter(
            torch.zeros((n, cfg.ssm_conv), dtype=pd, device=device))
        self.conv_c = nn.Parameter(
            torch.zeros((n, cfg.ssm_conv), dtype=pd, device=device))
        self.a_log = nn.Parameter(
            torch.log(torch.linspace(1.0, 16.0, h, **f32)))
        self.d_skip = nn.Parameter(torch.ones(h, **f32))
        self.dt_bias = nn.Parameter(torch.zeros(h, **f32))
        self.gate_norm = nn.Parameter(
            torch.zeros(d_in, dtype=pd, device=device))
        self.out_proj = nn.Parameter(
            L._normal(gen, (d_in, d), 1.0 / math.sqrt(d_in), pd, device))


def _causal_conv(x, w):
    """Depthwise causal conv: x (B, S, C), w (C, K), in x's type.

    The K taps are multiplied and summed in fp32 and rounded to x's type
    once, as the decode step's conv (an einsum that accumulates in fp32)
    rounds them. The reference's unrolled sum rounds each product and
    partial sum to the compute type (XLA's CPU backend does so op by
    op); in bf16 those seven roundings a conv, against the decode step's
    one, made decode drift from the forward by 3.8% of max|logit| over
    mamba2-130m's 24 layers and 7.5% over zamba2-7b's 81 on an H100.
    In fp32 the two orders agree to rounding.
    """
    k, s = w.shape[1], x.shape[1]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    wf = w.float()
    return sum(xp[:, i:i + s, :] * wf[None, None, :, i]
               for i in range(k)).to(x.dtype)


def _segsum(x):
    """Stable segment sum: out[..., i, j] = Σ_{j<t≤i} x[..., t], −inf
    where j > i."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -math.inf)


def ssd_scan(xh, dt, a, b_in, c_in, chunk: int):
    """Chunked SSD. xh: (B, S, H, P), dt: (B, S, H), a: (H,) (negative),
    b_in/c_in: (B, S, N). Returns y (B, S, H, P) and the final state
    (B, H, P, N) in fp32."""
    bsz, s, h, p = xh.shape
    n = b_in.shape[-1]
    q = min(chunk, s)
    assert s % q == 0, (s, q)
    nc = s // q
    xc = xh.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h)
    bc = b_in.reshape(bsz, nc, q, n)
    cc = c_in.reshape(bsz, nc, q, n)

    da = dtc * a                                   # (B, nc, Q, H)
    da_cs = torch.cumsum(da, dim=2)

    # Intra-chunk: masked products, quadratic in Q.
    lmat = torch.exp(_segsum(da.movedim(2, 3)))    # (B, nc, H, Q, Q)
    scores = torch.einsum("bcin,bcjn,bchij->bchij", cc, bc, lmat)
    del lmat
    y_intra = torch.einsum("bchij,bcjh,bcjhp->bcihp", scores, dtc, xc)
    del scores

    # Chunk summary states: (B, nc, H, P, N).
    decay_end = torch.exp(da_cs[:, :, -1:, :] - da_cs)   # (B, nc, Q, H)
    states = torch.einsum("bcjh,bcjhp,bcjn->bchpn", dtc * decay_end, xc, bc)

    # Inter-chunk linear recurrence: the state entering each chunk.
    chunk_decay = torch.exp(da_cs[:, :, -1, :])    # (B, nc, H)
    carry = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                        device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c].float()
    prev_states = torch.stack(prev, dim=1)         # (B, nc, H, P, N)

    in_decay = torch.exp(da_cs)                    # (B, nc, Q, H)
    y_inter = torch.einsum("bcin,bcih,bchpn->bcihp", cc, in_decay,
                           prev_states.to(cc.dtype))
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y, carry


def _project(lp: Mamba2Layer, x, cfg: ArchConfig):
    """The five separate input projections: z, x, B, C, dt."""
    cd = L.dtype_of(cfg, "compute_dtype")
    return (x @ lp.wz.to(cd), x @ lp.wx.to(cd), x @ lp.wb.to(cd),
            x @ lp.wc.to(cd), x @ lp.wdt.to(cd))


def apply_layer(lp: Mamba2Layer, x, cfg: ArchConfig):
    """x: (B, S, D) → (B, S, D) in x's type (the residual stream's). The
    full (prefill) pass."""
    d_in, h, p, _ = _dims(cfg)
    cd = L.dtype_of(cfg, "compute_dtype")
    res = x
    x = L.rms_norm(x, lp.norm, cfg.norm_eps).to(cd)
    z, xr, b_in, c_in, dt = _project(lp, x, cfg)
    xr = F.silu(_causal_conv(xr, lp.conv_x.to(cd)))
    b_in = F.silu(_causal_conv(b_in, lp.conv_b.to(cd)))
    c_in = F.silu(_causal_conv(c_in, lp.conv_c.to(cd)))
    xh = xr.reshape(*x.shape[:2], h, p)
    dt_sp = F.softplus(dt.float() + lp.dt_bias)
    a = -torch.exp(lp.a_log)
    y, _ = ssd_scan(xh.float(), dt_sp, a, b_in.float(), c_in.float(),
                    cfg.ssm_chunk)
    y = y + lp.d_skip[None, None, :, None] * xh.float()
    y = y.reshape(*x.shape[:2], d_in).to(cd)
    y = L.rms_norm(y * F.silu(z), lp.gate_norm, cfg.norm_eps)
    return res + y @ lp.out_proj.to(cd)


def decode_layer(lp: Mamba2Layer, x, state, tail_x, tail_bc,
                 cfg: ArchConfig):
    """One-token step. x: (B, 1, D); state (B, H, P, N) fp32; tails
    (B, K-1, C). Returns (y, state', tail_x', tail_bc'), new tensors; y
    in x's type (the residual stream's)."""
    d_in, h, p, n = _dims(cfg)
    cd = L.dtype_of(cfg, "compute_dtype")
    res = x
    x = L.rms_norm(x, lp.norm, cfg.norm_eps).to(cd)
    z, xr, b_in, c_in, dt = _project(lp, x, cfg)

    def conv_step(tail, new, w):
        seq = torch.cat([tail, new.to(tail.dtype)], dim=1)   # (B, K, C)
        out = F.silu(torch.einsum("bkc,ck->bc", seq.to(cd), w.to(cd)))
        return out, seq[:, 1:, :]

    xr_c, tail_x2 = conv_step(tail_x, xr, lp.conv_x)
    bc_c, tail_bc2 = conv_step(tail_bc, torch.cat([b_in, c_in], dim=-1),
                               torch.cat([lp.conv_b, lp.conv_c], dim=0))
    b_c, c_c = bc_c[:, :n], bc_c[:, n:]
    xh = xr_c.reshape(-1, h, p).float()
    dtv = F.softplus(dt[:, 0].float() + lp.dt_bias)       # (B, H)
    a = -torch.exp(lp.a_log)
    decay = torch.exp(dtv * a)
    state = state * decay[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dtv, xh, b_c.float())
    y = torch.einsum("bhpn,bn->bhp", state, c_c.float())
    y = y + lp.d_skip[None, :, None] * xh
    y = y.reshape(-1, 1, d_in).to(cd)
    y = L.rms_norm(y * F.silu(z), lp.gate_norm, cfg.norm_eps)
    return res + y @ lp.out_proj.to(cd), state, tail_x2, tail_bc2


def decode_layers(layers, x, state, conv_x, conv_bc, cfg: ArchConfig):
    """:func:`decode_layer` over ``layers``, layer ``i`` reading and
    updating in place ``state[i]``, ``conv_x[i]`` and ``conv_bc[i]``."""
    for i, lp in enumerate(layers):
        x, st, tx, tbc = decode_layer(lp, x, state[i], conv_x[i],
                                      conv_bc[i], cfg)
        state[i] = st
        conv_x[i] = tx
        conv_bc[i] = tbc
    return x


class Mamba2LM(nn.Module):
    """Attention-free Mamba2 LM.

    Args:
      cfg: an ``ssm`` :class:`ArchConfig`.
      generator: draws every weight (on the generator's device, then
        moved to ``device``); ``None`` leaves the drawn weights
        uninitialised for :func:`repro_torch.models.convert.mamba2_params_from_jax`.
      device: where the parameters live; ``"cuda"`` (the default) needs a
        card and raises without one.
    """

    def __init__(self, cfg: ArchConfig, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        if cfg.family != "ssm":
            raise NotImplementedError(
                f"Mamba2LM is the ssm family; got {cfg.family!r}")
        dev = checked_device(device, "Mamba2LM")
        self.cfg = cfg
        self.embedding = nn.Parameter(L.init_embedding(generator, cfg, dev))
        self.layers = nn.ModuleList(Mamba2Layer(cfg, generator, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(L.init_norm(cfg, dev))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Prefill forward: logits (B, S, vocab) in fp32."""
        cfg = self.cfg
        x = L.embed(self.embedding, tokens, cfg).float()
        remat = cfg.remat and torch.is_grad_enabled()
        for lp in self.layers:
            if remat:
                # The layer draws no random numbers: no RNG state to keep.
                x = checkpoint(apply_layer, lp, x, cfg, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=sh.remat_context)
            else:
                x = apply_layer(lp, x, cfg)
        return final_logits(self, x)

    def decode_step(self, cache: dict, token: torch.Tensor, cache_len: int):
        """One-token decode; the state is O(1), so ``cache_len`` does not
        enter the recurrence. Returns (logits, cache), updated in place."""
        del cache_len
        cfg = self.cfg
        x = L.embed(self.embedding, token, cfg).float()
        x = decode_layers(self.layers, x, cache["state"], cache["conv_x"],
                          cache["conv_bc"], cfg)
        return final_logits(self, x), cache


def final_logits(model, x):
    """The final norm of the fp32 residual stream, rounded to the compute
    type, and the unembedding."""
    cfg = model.cfg
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return L.unembed(model.embedding, x.to(L.dtype_of(cfg, "compute_dtype")),
                     cfg)


def init_cache(cfg: ArchConfig, batch: int, max_len: int = 0,
               dtype=torch.float32, device="cuda") -> dict:
    """SSM cache: each layer's recurrent state (fp32) and conv tails
    (``dtype``), O(1) in the sequence length."""
    del max_len
    dev = checked_device(device, "init_cache")
    d_in, h, p, n = _dims(cfg)
    k = cfg.ssm_conv - 1
    return {
        "state": torch.zeros((cfg.n_layers, batch, h, p, n),
                             dtype=torch.float32, device=dev),
        "conv_x": torch.zeros((cfg.n_layers, batch, k, d_in), dtype=dtype,
                              device=dev),
        "conv_bc": torch.zeros((cfg.n_layers, batch, k, 2 * n), dtype=dtype,
                               device=dev),
    }
