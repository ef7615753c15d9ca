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

Inside :func:`repro_torch.dist.sharding.activation_context`,
``moe_block`` groups tokens as the reference does: gd =
``batch_shard_count()`` groups over the batch and gm =
``model_axis_size()`` over the sequence, each reset to 1 where it does
not divide, with the capacity of one group's tg = (B/gd)·(S/gm) tokens.
Where gm > 1, :func:`_moe_ep` is the counterpart of the reference's
``_moe_ep_shardmap``: each of the gd·gm groups dispatches locally, one
tiled exchange over ``model`` hands each model rank its e/gm experts'
slots from all gm groups, the rank runs those experts, and the mirror
exchange brings the results back before the combine. In one process the
groups dispatch and combine together on the tokens' device, and the
exchange is a split and a cat, copied to each rank's position's device
and back, so autograd gives the mirrored exchange in backward, as the
reference's ``all_to_all`` does. Where gm = 1 but gd > 1, all B·S
tokens dispatch as one group at the per-group capacity, as in the
reference (decode included). The reference's sharding constraints change
no value and are left out.

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

import itertools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.api import checked_device
from repro_torch.dist import sharding as sh
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
    # An exact count (integers below 2^24 in fp32, in any order) that also
    # runs on ``meta`` tensors, which ``torch.bincount`` does not.
    flat = topi.reshape(-1)
    f_e = torch.zeros(e, dtype=torch.float32, device=flat.device).index_add_(
        0, flat, torch.ones(flat.numel(), dtype=torch.float32,
                            device=flat.device))
    f_e = f_e / torch.clamp(f_e.sum(), min=1.0)
    p_e = probs.reshape(-1, e).mean(dim=0)
    return topv, topi, e * torch.sum(f_e * p_e)


def _dispatch_groups(xg, topi, e: int, k: int, cap: int, cd):
    """Dispatch g token groups at once, each on its own. xg: (g, t, d);
    topi: (g, t, k).

    Returns the buffers (g, e, cap, d) in ``cd`` and each assignment's
    slot (g, t, k) in its group's buffer; a dropped assignment (rank ≥ cap
    in its expert) gets the sentinel slot ``e·cap``. The sort is stable,
    so an expert keeps its first ``cap`` assignments of a group in token
    order, as ``jnp.argsort`` does. The only index written more than once
    below is the sentinel, whose entry is discarded (``[:, :-1]``), so the
    order in which duplicate writes land does not matter. The rows are
    read by indexing the (g·t, d) tokens: its backward is ``index_put_``,
    which adds a token's k slot gradients in a fixed order, where a
    ``torch.gather``'s ``scatter_add_`` adds them with atomics in x's
    type, in an order that changes from run to run.
    """
    g, t, d = xg.shape
    dev = xg.device
    flat_e = topi.reshape(g, t * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    starts = torch.searchsorted(
        sorted_e, torch.arange(e, device=dev).expand(g, e).contiguous())
    rank = (torch.arange(t * k, device=dev)
            - torch.gather(starts, 1, sorted_e))
    keep = rank < cap
    dest = torch.where(keep, sorted_e * cap + rank, e * cap)
    tok_of_slot = torch.zeros((g, e * cap + 1), dtype=torch.long,
                              device=dev).scatter_(1, dest, order // k)
    valid_slot = torch.zeros((g, e * cap + 1), dtype=torch.bool,
                             device=dev).scatter_(1, dest, keep)
    first_row = torch.arange(g, device=dev)[:, None] * t
    rows = xg.reshape(g * t, d)[tok_of_slot[:, :-1] + first_row]
    buf = torch.where(valid_slot[:, :-1, None], rows, 0).to(cd)
    slot_of_assign = torch.full((g, t * k), e * cap, dtype=torch.long,
                                device=dev).scatter_(1, order, dest)
    return buf.reshape(g, e, cap, d), slot_of_assign.reshape(g, t, k)


def _combine_groups(y, slot_of_assign, topv):
    """y: (g, e, cap, d) expert outputs → (g, t, d) tokens: one row read
    per (token, k) assignment of its own group (a dropped one reads a
    zero row), weighted and summed over k in y's type."""
    g, e, cap, d = y.shape
    y_flat = torch.cat([y.reshape(g, e * cap, d), y.new_zeros(g, 1, d)],
                       dim=1).reshape(g * (e * cap + 1), d)
    first_row = torch.arange(g, device=y.device)[:, None, None] * (
        e * cap + 1)
    picked = y_flat[slot_of_assign + first_row]
    return (picked * topv[..., None].to(y.dtype)).sum(dim=2)


def _local_dispatch(xg, topi, e: int, k: int, cap: int, cd):
    """Dispatch one token group. xg: (t, d); topi: (t, k). Returns the
    buffer (e, cap, d) and each assignment's slot (t, k), as
    :func:`_dispatch_groups` does for one group."""
    buf, slots = _dispatch_groups(xg[None], topi[None], e, k, cap, cd)
    return buf[0], slots[0]


def _local_combine(y, slot_of_assign, topv):
    """y: (e, cap, d) expert outputs → (t, d) tokens, as
    :func:`_combine_groups` does for one group."""
    return _combine_groups(y[None], slot_of_assign[None], topv[None])[0]


def _experts(p, buf, cd):
    """The FFNs of the experts in ``p`` (``wi_gate``, ``wi_up``, ``wo``,
    each with a leading expert axis) on their dispatch buffer: (e', cap, d)
    → (e', cap, d), with the weights brought to the buffer's device (a
    mesh position's, in :func:`_moe_ep`)."""
    def w(name):
        return p[name].to(buf.device, cd)

    gate = F.silu(torch.bmm(buf, w("wi_gate")))
    up = torch.bmm(buf, w("wi_up"))
    return torch.bmm(gate * up, w("wo"))


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


def _group_positions(mesh, ba, gd, gm):
    """The mesh position of each token group (di, mj): data coordinates
    from di over the batch axes ``ba`` (row-major, the first axis major),
    model coordinate mj. Axes outside ``ba`` and ``model`` are 0."""
    names = mesh.axis_names
    sizes = [mesh.shape[n] for n in ba]
    out = {}
    for di in range(gd):
        coords = dict.fromkeys(names, 0)
        rest = di
        for n, size in zip(reversed(ba), reversed(sizes)):
            coords[n], rest = rest % size, rest // size
        for mj in range(gm):
            coords[sh.MODEL_AXIS] = mj
            out[di, mj] = tuple(coords[n] for n in names)
    return out


def _moe_ep(p, x, topi, topv, cfg, cap, cd, mesh, ba, gd, gm):
    """Expert parallelism over the ``model`` axis (the reference's
    ``_moe_ep_shardmap``), in one process.

    Tokens split ``P(batch, "model", None)``: group (di, mj) holds batch
    block di and sequence block mj and dispatches its tg tokens locally
    into (e, cap, d); the gd·gm groups dispatch and combine together on
    ``x``'s device along a leading group axis. The exchange gives model
    rank r of batch block di the slots of its experts ``[r·e/gm,
    (r+1)·e/gm)`` from every peer group of that block, concatenated over
    the peers in order, (e/gm, gm·cap, d), on position (di, r)'s device;
    the rank runs those experts on its slice of the weights; the mirror
    exchange brings every rank's output back for the combine. Batch
    blocks whose rank r sits on one device in a row (every block, where
    all positions share a card) run rank r's experts in one call. Each
    expert's FFN acts on each row alone, so that changes only the shape
    of the products. The copies and the cats are differentiable, so the
    backward is the mirrored exchange.
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    bl, sl, el, g = b // gd, s // gm, e // gm, gd * gm
    pos = _group_positions(mesh, ba, gd, gm)

    def groups(a):                      # (b, s, c) → (g, t, c)
        return (a.reshape(gd, bl, gm, sl, a.shape[-1]).transpose(1, 2)
                .reshape(g, bl * sl, a.shape[-1]))

    buf, slots = _dispatch_groups(groups(x), groups(topi), e, k, cap, cd)
    # Each rank's experts and slots by ``split``, whose backward is one
    # cat, where a slice's would fill a whole zero tensor for every rank.
    names = ("wi_gate", "wi_up", "wo")
    rank_w = zip(*(p[n].split(el) for n in names))
    rank_buf = buf.reshape(gd, gm, e, cap, d).split(el, dim=2)
    ys = []
    for r, (w, rb) in enumerate(zip(rank_w, rank_buf)):
        runs = [(dev, len(list(blocks))) for dev, blocks in itertools.groupby(
            mesh.device(pos[di, r]) for di in range(gd))]
        outs = []
        for (dev, n), blk in zip(runs, rb.split([n for _, n in runs])):
            # EP exchange: (n, gm, e/gm, cap, d) → (e/gm, n·gm·cap, d).
            recv = (blk.permute(2, 0, 1, 3, 4).reshape(el, n * gm * cap, d)
                    .to(dev))
            y = _experts(dict(zip(names, w)), recv, cd)
            # Mirror exchange: back to the tokens' device.
            outs.append(y.reshape(el, n, gm, cap, d).permute(1, 2, 0, 3, 4)
                        .to(x.device))
        ys.append(torch.cat(outs))
    y = torch.cat(ys, dim=2).reshape(g, e, cap, d)
    out = _combine_groups(y, slots, groups(topv))
    return (out.reshape(gd, gm, bl, sl, d).transpose(1, 2)
            .reshape(b, s, d))


def moe_block(p, x, cfg: ArchConfig):
    """x: (B, S, D) → (B, S, D), plus the aux loss.

    ``moe_dispatch="local"``: gd = ``batch_shard_count()`` and gm =
    ``model_axis_size()`` of the sharding context (1 outside one), each
    reset to 1 where it does not divide; capacity ``max(4,
    min(int(capacity_factor·tg·k/e), tg))`` over one group's tg =
    (B/gd)·(S/gm) tokens. With a mesh and gm > 1, :func:`_moe_ep`;
    otherwise all B·S tokens dispatch as one group at that capacity.
    """
    if cfg.moe_dispatch == "global_sort":
        return moe_block_global_sort(p, x, cfg)
    b, s, d = x.shape
    e, k, t = cfg.n_experts, cfg.top_k, b * s
    gd, gm = sh.batch_shard_count(), sh.model_axis_size()
    if b % gd:
        gd = 1
    if s % gm or e % gm:
        gm = 1
    tg = (b // gd) * (s // gm)
    cap = _capacity(cfg, tg, 4)
    cd = L.dtype_of(cfg, "compute_dtype")
    # x feeds the router, the experts and the shared experts. Autograd adds
    # a tensor's gradients as they arrive, which on a mesh over several
    # cards is the order in which the cards finish; the views of one
    # expand hand theirs to one sum, in a fixed order, rounded once.
    x_router, x_experts, *x_shared = x.expand(
        3 if cfg.n_shared_experts else 2, b, s, d).unbind(0)
    topv, topi, aux = router_topk(x_router.float() @ p["router"], k)
    topv = topv.to(cd)
    mesh, ba = sh.current_mesh_info()
    if mesh is not None and gm > 1:
        out = _moe_ep(p, x_experts, topi, topv, cfg, cap, cd, mesh, ba, gd,
                      gm)
    else:
        buf, slots = _local_dispatch(x_experts.reshape(t, d),
                                     topi.reshape(t, k), e, k, cap, cd)
        out = _local_combine(_experts(p, buf, cd), slots,
                             topv.reshape(t, k)).reshape(b, s, d)
    if x_shared:
        out = out + L.mlp_block(p["shared"], x_shared[0], cfg)
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
                                    preserve_rng_state=False,
                                    context_fn=sh.remat_context)
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

