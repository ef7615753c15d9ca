"""Int8 gradient compression with error feedback (cross-pod reductions).

Mirrors ``repro.train.compress``: each gradient leaf is quantized to
int8 with a per-leaf scale before the cross-pod reduction, and the
quantization residual is carried into the next step (error feedback).
Trees are nested mappings of tensors. ``torch.round`` rounds half to
even, as ``jnp.round`` does, so both packages give the same bits.

:func:`crosspod_mean_compressed` is the reference's collective over a
named mesh axis, in one process: it takes the axis's members (one tree
a member, each on its own device) and returns one result a member. The
shared scale is the max over the members, the int8 payloads are summed
as int32, and each member gets ``qsum · scale / n`` and its own new
error.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch


def _map(fn, *trees):
    """``fn`` over the leaves of same-shaped nested mappings; a leaf's
    result may be a tuple, kept whole."""
    if isinstance(trees[0], Mapping):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _pick(tree, i):
    """Element ``i`` of every tuple leaf of ``tree``."""
    if isinstance(tree, Mapping):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def init_error_state(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def _quantize(g32, scale):
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, g32 - q.float() * scale


def quantize_leaf(g, err):
    """Returns (q_int8, scale, new_err)."""
    g32 = g.float() + err
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q, new_err = _quantize(g32, scale)
    return q, scale, new_err


def dequantize_leaf(q, scale):
    return q.float() * scale


def compress_tree(grads, err_state):
    """Quantize every leaf; returns (q_tree, scale_tree, err_tree)."""
    trips = _map(quantize_leaf, grads, err_state)
    return tuple(_pick(trips, i) for i in range(3))


def decompress_tree(q, s):
    return _map(dequantize_leaf, q, s)


def crosspod_mean_compressed(grads, err_state, axis: str = "pod"):
    """Error-feedback int8 all-reduce-mean over the members of a mesh
    axis.

    ``grads`` and ``err_state`` are sequences with one tree a member of
    ``axis`` (the axis the reference's collective reduces over). Returns
    ``(out, err)``, each a list with one tree a member: every member's
    ``out`` is the mean of the dequantized payloads, on its own device.
    """
    del axis
    n = len(grads)
    if n != len(err_state) or n == 0:
        raise ValueError(f"{n} gradient trees for {len(err_state)} error "
                         "trees")

    def leaf(*pairs):
        g32 = [g.float() + e for g, e in zip(pairs[:n], pairs[n:])]
        dev = g32[0].device
        amax = torch.stack([x.abs().max().to(dev) for x in g32]).max()
        scale = torch.clamp(amax, min=1e-12) / 127.0
        qs, errs = zip(*(_quantize(x, scale.to(x.device)) for x in g32))
        qsum = sum(q.to(device=dev, dtype=torch.int32) for q in qs)
        return tuple((qsum.to(x.device).float() * scale.to(x.device)) / n
                     for x in g32) + errs

    res = _map(leaf, *grads, *err_state)
    return ([_pick(res, i) for i in range(n)],
            [_pick(res, n + i) for i in range(n)])
