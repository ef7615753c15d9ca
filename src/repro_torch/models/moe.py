"""Mixture-of-Experts decoder LM (qwen3-moe, moonshot/moonlight) as an
``nn.Module``.

Mirrors ``repro.models.moe`` on one card. Dispatch is a sparse matrix
product: the token→expert assignment matrix D ((E·C) × tokens, one
non-zero a row) times the token matrix, the paper's Fig. 1 regime where
every 8×1 column vector holds one non-zero, so Libra's analysis sends all
of it to the CUDA-core stream. The dispatch below is that decision made
by hand, as in the reference: a sort-based gather/scatter with no
redundant work. ``chip_smoke.py`` runs the same D through
:class:`~repro_torch.core.spmm.LibraSpMM` (K2) and holds it to this
buffer bit for bit.

The experts are (E, C, d) × (E, d, f) batched products (``torch.bmm``),
weights cast to ``compute_dtype`` per use. Each layer's attention runs K5
(``layers.attention_block``); decoding runs the plain
``layers.decode_attention`` with no window and no softcap over the dense
family's cache (``transformer.init_cache``), as the reference does.

One card has no mesh, so this is the reference's no-mesh branch
(``moe_block`` with one token group): the expert-parallel all-to-all
(``_moe_ep_shardmap``) and the sharding constraints, identities outside a
mesh, belong to ROADMAP queue 1 item 13d.

The module tree follows :class:`~repro_torch.models.transformer.Transformer`:
``embedding``, ``layers`` (each with ``attn_norm``, ``attn.{wq,wk,wv,wo}``,
``mlp_norm``, ``moe.{router,wi_gate,wi_up,wo}`` and, with shared experts,
``moe.shared.{wi_gate,wi_up,wo}``) and ``final_norm``. With ``cfg.remat``
and grad enabled each layer runs under ``torch.utils.checkpoint``.

Capacity depends on the tokens in the call (B·S in a forward, B in a
decode step), so a forward can drop assignments that decoding keeps:
decoding equals the forward only where the capacity reaches the tokens
(``capacity_factor >= n_experts / top_k``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.api import checked_device
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig


def init_moe(gen: torch.Generator | None, cfg: ArchConfig, device) -> dict:
    """Router (d, e) in fp32, experts (e, d, f) and (e, f, d) in
    ``param_dtype``, and ``shared`` (an MLP ``n_shared_experts`` experts
    wide) when the config has shared experts."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    pd = L.dtype_of(cfg, "param_dtype")
    p = {
        "router": L._normal(gen, (d, e), 1.0 / math.sqrt(d), torch.float32,
                            device),
        "wi_gate": L._normal(gen, (e, d, f), 1.0 / math.sqrt(d), pd, device),
        "wi_up": L._normal(gen, (e, d, f), 1.0 / math.sqrt(d), pd, device),
        "wo": L._normal(gen, (e, f, d), 1.0 / math.sqrt(f), pd, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(gen, cfg, device,
                                 d_ff=cfg.n_shared_experts * f)
    return p


def router_topk(logits, k: int):
    """Top-k routing with renormalised weights and the Switch aux loss
    E·Σ_e f_e·P_e, where f_e counts every assignment, dropped ones too.

    ``lax.top_k`` breaks ties by the lower index and ``torch.topk`` on the
    card promises no order, so the choice is a stable descending sort,
    which keeps the lower index first among equal probabilities.
    """
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    e = logits.shape[-1]
    f_e = torch.bincount(topi.reshape(-1), minlength=e).float()
    f_e = f_e / torch.clamp(f_e.sum(), min=1.0)
    p_e = probs.reshape(-1, e).mean(dim=0)
    return topv, topi, e * torch.sum(f_e * p_e)


def _local_dispatch(xg, topi, e: int, k: int, cap: int, cd):
    """Dispatch one token group. xg: (t, d); topi: (t, k).

    Returns the buffer (e, cap, d) in ``cd`` and each assignment's slot
    (t, k); a dropped assignment (rank ≥ cap in its expert) gets the
    sentinel slot ``e·cap``. The sort is stable, so an expert keeps its
    first ``cap`` assignments in token order, as ``jnp.argsort`` does.
    The only index written more than once below is the sentinel, whose
    entry is discarded (``[:-1]``), so the order in which duplicate
    writes land does not matter.
    """
    t, d = xg.shape
    dev = xg.device
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    rank = torch.arange(t * k, device=dev) - starts[sorted_e]
    keep = rank < cap
    dest = torch.where(keep, sorted_e * cap + rank, e * cap)
    src_token = order // k
    tok_of_slot = torch.zeros(e * cap + 1, dtype=torch.long, device=dev)
    tok_of_slot[dest] = src_token
    valid_slot = torch.zeros(e * cap + 1, dtype=torch.bool, device=dev)
    valid_slot[dest] = keep
    buf = torch.where(valid_slot[:-1, None], xg[tok_of_slot[:-1]], 0).to(cd)
    slot_of_assign = torch.full((t * k,), e * cap, dtype=torch.long,
                                device=dev)
    slot_of_assign[order] = dest
    return buf.reshape(e, cap, d), slot_of_assign.reshape(t, k)


def _local_combine(y, slot_of_assign, topv):
    """y: (e, cap, d) expert outputs → (t, d) tokens: one row gather per
    (token, k) assignment (a dropped one reads a zero row), weighted and
    summed over k in y's type."""
    d = y.shape[-1]
    y_flat = torch.cat([y.reshape(-1, d), y.new_zeros(1, d)])
    picked = y_flat[slot_of_assign]
    return (picked * topv[..., None].to(y.dtype)).sum(dim=1)


def _experts(p, buf, cd):
    """The expert FFNs on the dispatch buffer: (e, cap, d) → (e, cap, d)."""
    gate = F.silu(torch.bmm(buf, p["wi_gate"].to(cd)))
    up = torch.bmm(buf, p["wi_up"].to(cd))
    return torch.bmm(gate * up, p["wo"].to(cd))


def _capacity(cfg: ArchConfig, t: int, floor: int) -> int:
    cap = int(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts)
    return max(floor, min(cap, t))


def moe_block_global_sort(p, x, cfg: ArchConfig):
    """``moe_dispatch="global_sort"``: one sort over all B·S·k
    assignments, capacity floor 8."""
    b, s, d = x.shape
    e, k, t = cfg.n_experts, cfg.top_k, b * s
    cd = L.dtype_of(cfg, "compute_dtype")
    xf = x.reshape(t, d)
    topv, topi, aux = router_topk(xf.float() @ p["router"], k)
    buf, slots = _local_dispatch(xf, topi, e, k, _capacity(cfg, t, 8), cd)
    out = _local_combine(_experts(p, buf, cd), slots, topv)
    if cfg.n_shared_experts:
        out = out + L.mlp_block(p["shared"], xf, cfg)
    return out.reshape(b, s, d), aux


def moe_block(p, x, cfg: ArchConfig):
    """x: (B, S, D) → (B, S, D), plus the aux loss.

    ``moe_dispatch="local"`` with one token group (no mesh): capacity
    ``max(4, min(int(capacity_factor·t·k/e), t))`` over the t = B·S
    tokens of the call.
    """
    if cfg.moe_dispatch == "global_sort":
        return moe_block_global_sort(p, x, cfg)
    b, s, d = x.shape
    e, k, t = cfg.n_experts, cfg.top_k, b * s
    cd = L.dtype_of(cfg, "compute_dtype")
    topv, topi, aux = router_topk(x.float() @ p["router"], k)
    topv = topv.reshape(t, k).to(cd)
    buf, slots = _local_dispatch(x.reshape(t, d), topi.reshape(t, k), e, k,
                                 _capacity(cfg, t, 4), cd)
    out = _local_combine(_experts(p, buf, cd), slots, topv).reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + L.mlp_block(p["shared"], x, cfg)
    return out, aux


class MoELayer(nn.Module):
    """One pre-norm attention + MoE block's parameters."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator | None,
                 device):
        super().__init__()
        self.attn_norm = nn.Parameter(L.init_norm(cfg, device))
        self.attn = nn.ParameterDict(L.init_attention(gen, cfg, device))
        self.mlp_norm = nn.Parameter(L.init_norm(cfg, device))
        p = init_moe(gen, cfg, device)
        shared = p.pop("shared", None)
        self.moe = nn.ParameterDict(p)
        if shared is not None:
            self.moe["shared"] = nn.ParameterDict(shared)


class MoETransformer(nn.Module):
    """Decoder-only MoE LM.

    Args:
      cfg: a ``moe`` :class:`ArchConfig`.
      generator: draws every weight (on the generator's device, then
        moved to ``device``); ``None`` allocates them uninitialised for
        :func:`repro_torch.models.convert.moe_params_from_jax`.
      device: where the parameters live; ``"cuda"`` (the default) needs a
        card and raises without one.
    """

    def __init__(self, cfg: ArchConfig, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        if cfg.family != "moe":
            raise NotImplementedError(
                f"MoETransformer is the moe family; got {cfg.family!r}")
        dev = checked_device(device, "MoETransformer")
        self.cfg = cfg
        self.embedding = nn.Parameter(L.init_embedding(generator, cfg, dev))
        self.layers = nn.ModuleList(MoELayer(cfg, generator, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(L.init_norm(cfg, dev))

    def _layer(self, lp: MoELayer, x, positions):
        cfg = self.cfg
        h = L.rms_norm(x, lp.attn_norm, cfg.norm_eps)
        h = L.attention_block(lp.attn, h, cfg, layer_window=x.shape[1] + 1,
                              positions=positions)
        x = x + h
        h = L.rms_norm(x, lp.mlp_norm, cfg.norm_eps)
        h, aux = moe_block(lp.moe, h, cfg)
        return x + h, aux

    def forward(self, tokens: torch.Tensor):
        """Train/prefill forward: (logits (B, S, vocab) in fp32, the mean
        aux loss over layers)."""
        cfg = self.cfg
        x = L.embed(self.embedding, tokens, cfg)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        remat = cfg.remat and torch.is_grad_enabled()
        auxs = []
        for lp in self.layers:
            if remat:
                # The layer draws no random numbers: no RNG state to keep.
                x, aux = checkpoint(self._layer, lp, x, positions,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = self._layer(lp, x, positions)
            auxs.append(aux)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        return L.unembed(self.embedding, x, cfg), torch.stack(auxs).mean()

    def decode_step(self, cache: dict, token: torch.Tensor, cache_len: int):
        """One-token decode. token: (B, 1) ints; cache_len: filled length
        *including* the new token's slot. Returns (logits, cache); the
        cache updates in place."""
        cfg = self.cfg
        cd = L.dtype_of(cfg, "compute_dtype")
        cache_len = int(cache_len)
        x = L.embed(self.embedding, token, cfg)
        pos = torch.full((x.shape[0], 1), cache_len - 1, dtype=torch.int32,
                         device=x.device)
        for i, lp in enumerate(self.layers):
            kc, vc = cache["k"][i], cache["v"][i]
            h = L.rms_norm(x, lp.attn_norm, cfg.norm_eps)
            q, k, v = L.qkv_project(lp.attn, h, cfg)
            q = L.apply_rope(q, pos, cfg.rope_theta)
            k = L.apply_rope(k, pos, cfg.rope_theta)
            kc[:, cache_len - 1] = k[:, 0].to(kc.dtype)
            vc[:, cache_len - 1] = v[:, 0].to(vc.dtype)
            o = L.decode_attention(q, kc, vc, cache_len)
            x = x + o.reshape(o.shape[0], 1, -1) @ lp.attn["wo"].to(cd)
            h = L.rms_norm(x, lp.mlp_norm, cfg.norm_eps)
            h, _ = moe_block(lp.moe, h, cfg)
            x = x + h
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        return L.unembed(self.embedding, x, cfg), cache

