"""K5 — fused flash-attention forward, and attention under autograd.

The reference package runs this kernel on the TPU
(``src/repro/kernels/flash_attention.py`` ``flash_attention_fused``);
here it is a hand-written CUDA kernel for Hopper
(``csrc/flash_attention.cu``): one block of two warpgroups per
(128-query tile, batch × query head), 64-key tiles of K and V in a
two-stage ``cp.async`` double buffer in 128-byte-swizzled shared memory,
both products on ``wgmma`` (QKᵀ with Q and K from shared memory, PV with
P from registers) with fp32 accumulators, and the online softmax in
registers on ``ex2``/``tanh`` intrinsics, masking only the tiles that a
mask edge cuts.

:func:`flash_attention_fused` launches the kernel for CUDA tensors and
runs :func:`flash_attention_ref`, its plain twin, for CPU tensors; it
never falls back from the card to the plain version. On ``meta``
tensors (a shape-only trace, ``repro_torch.launch.dryrun``) it makes the
kernel's checks and returns empty outputs. Every call reports its work,
``4·D`` operations a visible (query, key) pair (:func:`visible_pairs`),
to an installed op counter (``repro_torch.launch.hlo_analysis``).

The layout is the reference's ``(B, S, H, D)``; the kernel reads Q, K
and V through their strides, so no transposed copies are made.

Training goes through :class:`FlashAttention`, a
``torch.autograd.Function`` (:func:`flash_attention_grad`): its forward
is the same kernel (or twin) with the optional fp32 logsumexp output,
and its backward is :func:`flash_attention_bwd_ref`, plain PyTorch on
the card and the CPU alike. The reference has no backward kernel to
port: it differentiates its XLA scan over ``attn_chunk``-key chunks
(``repro.models.layers.flash_attention``), and the backward here walks
the same chunks, recomputing each chunk's probabilities from the saved
logsumexp.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import _build

NEG = -1e30
BLOCK_K = 64
#: Head dimensions the kernel is built for. 112 (zamba2) runs at a
#: 128-column tile pitch inside the kernel: QKᵀ over the 112 real columns,
#: PV at 128 with V's pad columns zeroed in shared memory and the extra
#: output columns dropped.
HEAD_DIMS = (64, 112, 128, 256)
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}


def _key_blocks(sq, sk, *, causal, window, q_offset, block_k=BLOCK_K):
    """Start offsets of the key blocks that hold an unmasked key for some
    query (the kernel skips the others per query tile; skipping a fully
    masked block changes no result, see :func:`flash_attention_ref`)."""
    kend = sk
    if causal:
        kend = min(kend, q_offset + sq)
    kbeg = max(0, q_offset - window + 1) if window > 0 else 0
    return range(kbeg // block_k * block_k, max(kend, 0), block_k)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0,
                        block_k: int = BLOCK_K, return_lse: bool = False):
    """Plain PyTorch twin of the kernel: the same arithmetic, block by block.

    Per ``block_k`` keys: scores in fp32 from the inputs' exact values,
    ``* 1/sqrt(D)``, then ``softcap · tanh(s / softcap)``, then the mask
    (masked scores take the finite ``NEG``), then the online-softmax
    update with ``p`` cast to V's type before PV. A block masked for
    every query is skipped, as the kernel skips it: a row whose running
    max is still ``NEG`` gets ``exp(0)`` garbage from such a block, which
    the first real key's rescale ``exp(NEG - m) = 0`` wipes exactly, so
    the result is the same either way.

    With ``return_lse`` it also returns the kernel's fp32 ``(B, H, Sq)``
    logsumexp of the scaled, softcapped, masked scores, ``m + log l``,
    and ``+inf`` on a row that saw no unmasked key.
    """
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    qf = q.float().reshape(b, sq, kv, g, d).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3).unsqueeze(2)   # (b, kv, 1, sk, d)
    vt = v.permute(0, 2, 1, 3).unsqueeze(2)           # (b, kv, 1, sk, d)
    qpos = q_offset + torch.arange(sq, device=dev)[:, None]
    m = torch.full((b, kv, g, sq, 1), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kv, g, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kv, g, sq, d), dtype=torch.float32, device=dev)
    for k0 in _key_blocks(sq, sk, causal=causal, window=window,
                          q_offset=q_offset, block_k=block_k):
        kb = kf[:, :, :, k0:k0 + block_k]
        s = (qf @ kb.transpose(-1, -2)) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        kpos = k0 + torch.arange(kb.shape[3], device=dev)[None, :]
        mask = kpos < sk
        if causal:
            mask = mask & (kpos <= qpos)
        if window > 0:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = p.to(v.dtype).float() @ vt[:, :, :, k0:k0 + block_k].float()
        acc = acc * alpha + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    # Contiguous, as the kernel writes it, so that what follows runs the
    # same ops on either.
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(
        q.dtype, memory_format=torch.contiguous_format)
    if not return_lse:
        return out
    lse = torch.where(m == NEG, math.inf, m + torch.log(l))
    return out, lse.reshape(b, h, sq)


def _kernel_layout_ok(t) -> bool:
    """Last dim contiguous, 16-byte aligned rows (cp.async of 16 bytes)."""
    return (t.stride(3) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def flash_attention_fused(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, q_offset: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D). Returns (B, Sq, H, D).

    ``window == 0`` disables the sliding-window constraint; otherwise key
    ``kpos`` is visible to query ``qpos`` when ``kpos > qpos - window``.
    ``q_offset`` is the absolute position of ``q[:, 0]``. On the card the
    kernel takes bfloat16 or float16 (Q, K and V of one type) and head
    dimensions in :data:`HEAD_DIMS`; anything else raises.

    When grad is enabled and an input requires it, the call goes through
    :func:`flash_attention_grad` (the same kernel, and a backward), so
    the result never silently drops the graph.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_attention_grad(q, k, v, causal=causal, window=window,
                                    softcap=softcap, q_offset=q_offset)
    return _forward(q, k, v, causal, int(window), float(softcap),
                    int(q_offset), False)


def visible_pairs(b, sq, sk, h, *, causal=True, window=0, q_offset=0):
    """Unmasked (query, key) pairs of one call, over every batch row and
    query head: the work these inputs need, ``4·D`` operations a pair
    (QKᵀ and PV). Query ``i`` sits at ``q_offset + i``; key ``kpos`` is
    visible to it when ``kpos <= qpos`` (causal) and ``kpos > qpos -
    window`` (``window > 0``)."""
    qpos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else 0
    return int(np.maximum(hi - lo, 0).sum()) * b * h


def _forward(q, k, v, causal, window, softcap, q_offset, want_lse):
    """The kernel on CUDA tensors, the twin on CPU tensors, and on
    ``meta`` tensors the kernel's checks and outputs alone (a shape-only
    trace: nothing launches and the launch count stays); with
    ``want_lse`` returns ``(out, lse)``. Each call that has work reports
    it to an installed op counter (:func:`_build.report_work`)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if h % kv or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"flash_attention_fused: shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")

    def report(out, lse):
        if not _build.COUNTERS:
            return
        pairs = visible_pairs(b, sq, sk, h, causal=causal, window=window,
                              q_offset=q_offset)
        moved = sum(t.numel() * t.element_size()
                    for t in (q, k, v, out) + ((lse,) if want_lse else ()))
        _build.report_work("flash_attention", 4.0 * d * pairs, moved,
                           q.dtype, (b, sq, sk, h, kv, d))

    if _build.on_cpu(q, k, v):
        with _build.kernel_scope("flash_attention", twin=True) as scope:
            got = flash_attention_ref(q, k, v, causal=causal, window=window,
                                      softcap=softcap, q_offset=q_offset,
                                      return_lse=want_lse)
            outs = got if want_lse else (got,)
            scope.outputs(*outs)
        if outs[0].numel():
            report(outs[0], outs[-1] if want_lse else None)
        return got
    dev = q.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError("flash_attention_fused: operands must all be CUDA "
                         "tensors (or all CPU tensors for the plain "
                         "version, or all meta tensors for a shape-only "
                         f"trace), got {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention_fused: {name} is on "
                             f"{t.device}, not {dev}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(
                "flash_attention_fused: the kernel takes bfloat16 or float16 "
                f"q, k, v of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
        if not _kernel_layout_ok(t):
            raise ValueError(
                f"flash_attention_fused: {name} needs a contiguous last dim, "
                "strides in multiples of 8 elements and a 16-byte aligned "
                f"pointer; got strides {t.stride()}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fused: head dim {d} not in "
                         f"{HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"flash_attention_fused: B*H = {b * h} > 65535")
    with _build.kernel_scope("flash_attention", twin=False) as scope:
        out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
        lse = (torch.empty((b, h, sq), dtype=torch.float32, device=dev)
               if want_lse else None)
        scope.outputs(out, *((lse,) if want_lse else ()))
    if out.numel() == 0:
        return (out, lse) if want_lse else out
    if dev.type == "meta":
        report(out, lse)
        return (out, lse) if want_lse else out
    with torch.cuda.device(dev):
        err = _build.library().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if want_lse else None, b, sq, sk, h, kv, d,
            *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], 1.0 / math.sqrt(d), float(softcap),
            int(causal), window, int(q_offset), _DTYPES[q.dtype],
            _build.stream_handle(dev))
    _build.check(err, "flash_attention")
    flash_attention_fused.launches += 1
    report(out, lse)
    return (out, lse) if want_lse else out


flash_attention_fused.launches = 0


# ------------------------------------------------------------ backward ---
def _visible_rows(k0, k1, sq, *, causal, window, q_offset):
    """Query rows ``[lo, hi)`` that may see a key in ``[k0, k1)``; the
    other rows' probabilities in that chunk are all 0."""
    lo, hi = 0, sq
    if causal:                      # kpos <= qpos for some kpos >= k0
        lo = max(0, k0 - q_offset)
    if window > 0:                  # kpos > qpos - window, kpos <= k1 - 1
        hi = min(sq, k1 - 1 + window - q_offset)
    return lo, hi


def flash_attention_bwd_ref(q, k, v, lse, do, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0,
                            q_offset: int = 0, chunk: int = 1024):
    """dQ, dK, dV of the attention, plain PyTorch, ``chunk`` keys a step.

    ``lse`` is the forward's fp32 ``(B, H, Sq)`` logsumexp; ``do`` is the
    output's cotangent. Per key chunk, over the query rows that may see
    it (chunks that the causal and window masks hide from every query are
    skipped): the scores in fp32, ``* 1/sqrt(D)``, the softcap
    ``c·tanh(s/c)``, ``P = exp(s - lse)`` zeroed where masked, ``dV +=
    Pᵀ·dO``, ``dP = dO·Vᵀ``, ``dS = P∘(dP - Δ)``, ``dS ∘= 1 - tanh²``
    through the softcap, ``dQ += dS·K/sqrt(D)``, ``dK += dSᵀ·Q/sqrt(D)``.
    dK and dV are summed over each GQA group; all three are cast to the
    inputs' type at the end. The same function runs on the card and the
    CPU.

    ``Δ = rowsum(P∘dP)``, the softmax's own backward, in fp32 on every
    path: inside the loop where one chunk holds every key, else from a
    pass over the chunks ahead of the loop (one more QKᵀ and dO·Vᵀ a
    chunk). Its value in exact arithmetic, ``rowsum(dO∘O)``, is no
    substitute: where attention is near uniform ``dP - Δ`` cancels, and
    the rounding of O (the kernel's bf16 O, or an fp32 O summed over
    bf16 P) then puts dQ and dK beyond 1e-2·max|ref| of autograd
    (``tests/test_torch_flash_backward.py``).
    """
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    dev = q.device

    def heads(t):                   # (b, s, h, d) -> (b, kv, g, s, d) fp32
        return t.float().reshape(b, -1, kv, g, d).permute(0, 2, 3, 1, 4)

    qf, dof = heads(q), heads(do)
    kf = k.float().permute(0, 2, 1, 3).unsqueeze(2)   # (b, kv, 1, sk, d)
    vf = v.float().permute(0, 2, 1, 3).unsqueeze(2)
    lse = lse.reshape(b, kv, g, sq, 1)

    def probs(k0, k1):
        """The rows ``[lo, hi)`` that may see keys ``[k0, k1)``, their P
        (b, kv, g, n, c) and, with a softcap, ``tanh(s/c)``; None when no
        row sees the chunk."""
        lo, hi = _visible_rows(k0, k1, sq, causal=causal, window=window,
                               q_offset=q_offset)
        if lo >= hi:
            return None
        s = (qf[:, :, :, lo:hi] @ kf[:, :, :, k0:k1].transpose(-1, -2))
        s.mul_(scale)
        t = None
        if softcap:
            t = s.div_(softcap).tanh_()
            s = t * softcap
        qpos = q_offset + torch.arange(lo, hi, device=dev)[:, None]
        kpos = torch.arange(k0, k1, device=dev)[None, :]
        mask = torch.ones_like(kpos, dtype=torch.bool)
        if causal:
            mask = mask & (kpos <= qpos)
        if window > 0:
            mask = mask & (kpos > qpos - window)
        p = s.sub_(lse[:, :, :, lo:hi]).exp_().masked_fill_(~mask, 0.0)
        return lo, hi, p, t

    chunks = [(k0, min(k0 + chunk, sk)) for k0 in range(0, sk, chunk)]
    one_chunk = len(chunks) <= 1
    if not one_chunk:                                 # (b, kv, g, sq, 1)
        delta = torch.zeros((b, kv, g, sq, 1), dtype=torch.float32,
                            device=dev)
        for k0, k1 in chunks:
            got = probs(k0, k1)
            if got is None:
                continue
            lo, hi, p, _ = got
            dp = dof[:, :, :, lo:hi] @ vf[:, :, :, k0:k1].transpose(-1, -2)
            delta[:, :, :, lo:hi] += (p.mul_(dp)).sum(-1, keepdim=True)
            del p, dp
    dq = torch.zeros((b, kv, g, sq, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, kv, sk, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, kv, sk, d), dtype=torch.float32, device=dev)
    for k0, k1 in chunks:
        got = probs(k0, k1)
        if got is None:
            continue
        lo, hi, p, t = got
        qc, doc = qf[:, :, :, lo:hi], dof[:, :, :, lo:hi]
        kc, vc = kf[:, :, :, k0:k1], vf[:, :, :, k0:k1]
        dv[:, :, k0:k1] += (p.transpose(-1, -2) @ doc).sum(2)
        ds = doc @ vc.transpose(-1, -2)
        ds.sub_((p * ds).sum(-1, keepdim=True) if one_chunk
                else delta[:, :, :, lo:hi]).mul_(p)
        del p
        if softcap:
            ds.mul_(t.square_().neg_().add_(1.0))
            del t
        dq[:, :, :, lo:hi] += (ds @ kc).mul_(scale)
        dk[:, :, k0:k1] += (ds.transpose(-1, -2) @ qc).sum(2).mul_(scale)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    return (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Attention with K5's forward (the twin on CPU tensors) and
    :func:`flash_attention_bwd_ref` as its backward. Saves Q, K, V and
    the fp32 logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset, chunk):
        out, lse = _forward(q, k, v, causal, window, softcap, q_offset,
                            True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.args = dict(causal=causal, window=window, softcap=softcap,
                        q_offset=q_offset, chunk=chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_ref(q, k, v, lse, do,
                                             **ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_grad(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, q_offset: int = 0,
                         chunk: int = 1024):
    """:class:`FlashAttention` with keyword arguments; ``chunk`` is the
    backward's key chunk (``ArchConfig.attn_chunk``)."""
    return FlashAttention.apply(q, k, v, bool(causal), int(window),
                                float(softcap), int(q_offset), int(chunk))


def hbm_traffic_model(b, sq, sk, h, kv, d, chunk, dtype_bytes=2):
    """Analytic HBM bytes: fused kernel vs unfused chunked attention.

    Unfused: the (b·kv·g·sq·chunk) score tensor is written and read ~3×
    per chunk sweep (QKᵀ out, softmax in/out, PV in) in f32.
    Fused: q, k, v read once; o written once.
    """
    g = h // kv
    nchunks = (sk + chunk - 1) // chunk
    scores = b * kv * g * sq * chunk * 4  # f32
    unfused = 3 * scores * nchunks + (2 * b * sq * h * d
                                      + 2 * b * sk * kv * d) * dtype_bytes
    fused = (2 * b * sq * h * d + 2 * b * sk * kv * d * g) * dtype_bytes
    return {"unfused": float(unfused), "fused": float(fused),
            "reduction": float(unfused / max(fused, 1))}
