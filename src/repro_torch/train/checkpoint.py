"""Atomic, verified checkpoints in the reference's layout.

Layout, as ``repro.train.checkpoint`` writes it::

    <dir>/step_00000100.tmp-<nonce>/   (written first)
        leaf_00000.npy ...             (one file per tree leaf)
        manifest.json                  (treedef, shapes, dtypes, sha1s)
    <dir>/step_00000100/               (atomic rename on success)

A tree is nested dicts (keys taken in sorted order, as ``jax.tree``
flattens dicts), lists and tuples; anything else is a leaf (a tensor, an
array or a scalar). Leaves are stored whole on the host. A bfloat16
tensor is stored as the reference stores a bfloat16 array: its raw 2-byte
values (numpy dtype ``V2``) with ``"bfloat16"`` in the manifest.

The manifest's ``treedef`` is this module's own string (``repro_torch``
and the tree with ``*`` for each leaf), not a ``jax`` treedef: the
reference's restore reads only the leaves, in order, so each package
restores the other's checkpoints. :func:`train_tree` and
:func:`load_train_tree` carry a model of any language-model family and
its optimizer state to and from the reference's ``{"params": ...,
"opt": ...}`` tree, whose leaves are stacked as
:func:`repro_torch.models.convert.param_layout` describes (``layers``
over ``n_layers``; the hybrid's ``groups`` over ``(ngroups, every)``).

Guarantees: a crash mid-write leaves only a ``.tmp-*`` directory, which
:func:`available_steps` ignores and :func:`clean_tmp` removes; a leaf
whose sha1 differs from the manifest's fails the restore of its
checkpoint, and :func:`restore_latest` falls back to the one before.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import uuid

import numpy as np
import torch

from repro_torch.models.convert import param_layout, ref_leaf


# ------------------------------------------------------------------ trees --
def flatten(tree) -> tuple[list, str]:
    """Leaves in the reference's order and this module's treedef string."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, (list, tuple)):
            inner = ", ".join(walk(x) for x in node)
            return f"[{inner}]" if isinstance(node, list) else f"({inner})"
        leaves.append(node)
        return "*"

    return leaves, "repro_torch " + walk(tree)


def unflatten(like_tree, leaves):
    """``leaves`` (in :func:`flatten`'s order) in ``like_tree``'s shape."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(like_tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _leaf_hash(arr: np.ndarray) -> str:
    return hashlib.sha1(arr.tobytes()).hexdigest()


# ------------------------------------------------------ save and restore --
def save(ckpt_dir: str, step: int, tree) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp)
    leaves, treedef = flatten(tree)
    manifest = {"step": step, "treedef": treedef, "leaves": []}
    for i, leaf in enumerate(leaves):
        arr = _to_numpy(leaf)
        path = os.path.join(tmp, f"leaf_{i:05d}.npy")
        np.save(path, arr)
        manifest["leaves"].append({
            "file": os.path.basename(path),
            "shape": list(arr.shape),
            "dtype": _dtype_name(leaf, arr),
            "sha1": _leaf_hash(arr),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and ".tmp-" not in name:
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return sorted(out)


def _load_verified(path: str, like_tree):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for spec in manifest["leaves"]:
        arr = np.load(os.path.join(path, spec["file"]))
        if _leaf_hash(arr) != spec["sha1"]:
            raise IOError(f"corrupt leaf {spec['file']} in {path}")
        leaves.append(_to_tensor(arr, spec["dtype"]))
    return unflatten(like_tree, leaves), manifest["step"]


def restore_latest(ckpt_dir: str, like_tree):
    """Restore the newest valid checkpoint; skip corrupt ones.

    Returns (tree, step), the tree shaped like ``like_tree`` (whose
    leaves are not read) with CPU tensor leaves, or (None, -1) when
    nothing valid exists.
    """
    for step in reversed(available_steps(ckpt_dir)):
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
        try:
            return _load_verified(path, like_tree)
        except Exception as exc:  # corrupt/partial → try older
            print(f"[checkpoint] skipping {path}: {exc}")
    return None, -1


def clean_tmp(ckpt_dir: str) -> int:
    """Remove leftover .tmp-* dirs from crashed writers."""
    n = 0
    if not os.path.isdir(ckpt_dir):
        return 0
    for name in os.listdir(ckpt_dir):
        if ".tmp-" in name:
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
            n += 1
    return n


def keep_last(ckpt_dir: str, n: int = 3) -> None:
    steps = available_steps(ckpt_dir)
    for s in steps[:-n]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


# ------------------------------------------------- model and optimizer --
def _param_tree(tensors: dict, layout: dict, leaf) -> dict:
    def pick(names):
        if isinstance(names, list):
            return [pick(n) for n in names]
        return tensors[names]

    tree: dict = {}
    for path, names in layout.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf(pick(names.tolist()))
    return tree


def _stacked(ts):
    if isinstance(ts, list):
        return np.stack([_stacked(t) for t in ts])
    return _to_numpy(ts)


def train_tree(model, opt_state: dict, *, leaf=_stacked) -> dict:
    """The reference's ``{"params": ..., "opt": {"mu", "nu", "step"}}``
    tree of ``model`` (any language-model family) and its optimizer
    state, with host numpy leaves stacked as
    :func:`~repro_torch.models.convert.param_layout` says. ``leaf`` maps
    a tensor, or a stacked leaf's (nested) list of tensors, to the tree's
    leaf (a structure-only tree for :func:`restore_latest`:
    ``leaf=lambda ts: None``)."""
    layout = param_layout(model)
    params = dict(model.named_parameters())
    return {"params": _param_tree(params, layout, leaf),
            "opt": {"mu": _param_tree(opt_state["mu"], layout, leaf),
                    "nu": _param_tree(opt_state["nu"], layout, leaf),
                    "step": leaf(opt_state["step"])}}


@torch.no_grad()
def load_train_tree(model, opt_state: dict, tree: dict) -> None:
    """Copy a :func:`train_tree`-shaped tree (tensor or array leaves) into
    ``model`` and ``opt_state`` in place."""
    def put(dst, src):
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.array(src))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"checkpoint leaf {tuple(src.shape)} does not "
                             f"fit {tuple(dst.shape)}")
        dst.copy_(src)

    layout = param_layout(model)
    params = dict(model.named_parameters())
    for tensors, sub in ((params, tree["params"]),
                         (opt_state["mu"], tree["opt"]["mu"]),
                         (opt_state["nu"], tree["opt"]["nu"])):
        for path, names in layout.items():
            src = ref_leaf(sub, path)
            for ix in np.ndindex(names.shape):
                put(tensors[names[ix]], src[ix])
    put(opt_state["step"], tree["opt"]["step"])
