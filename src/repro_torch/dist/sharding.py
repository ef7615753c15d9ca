"""2D (data × model) placement rules for the dense models, in one process.

Mirrors ``repro.dist.sharding`` rule for rule:

* **Logical axes.** Layer code never names mesh axes; it asks for
  ``"batch"`` (every data axis of the current mesh) or ``"model"`` (the
  tensor-parallel axis) through :func:`constrain`. Meshes may be 2D
  (``data × model``) or 3D (``pod × data × model``).
* **Divisibility sanitation.** :func:`sanitize_spec` replicates any spec
  entry whose axis product does not divide its dim.
* **Context, not globals-by-import.** :func:`activation_context` installs
  the mesh (and the small-model ``dp_only`` escape hatch) for the scope
  of one step; outside any context every helper is a no-op.

Parameter placement (:func:`spec_for`) is the reference's Megatron-style
2D layout: matrices shard their penultimate dim over ``data`` and their
last dim over ``model``; embeddings transpose that.

The reference runs one controller over a ``jax.sharding.Mesh`` and lets
GSPMD partition the program. Here the mesh is a :class:`Mesh` of
positions in one process, each with a torch device; positions may share
a device (:meth:`Mesh.round_robin` puts position ``p`` on card ``p %
torch.cuda.device_count()``, so all of them on ``cuda:0`` with one
card). It is not built on ``torch.distributed``: a ``DeviceMesh`` needs a
process a rank. The rules are the reference's; the program is not
partitioned:

- :func:`device_put` gives each position its block of a tensor
  (:class:`Placed`): a view where the position shares the tensor's
  device, a copy elsewhere; :func:`gather` gives the whole tensor back
  (the tensor itself where every block is a view of it);
- the steps compute on whole tensors, so :func:`constrain` resolves its
  spec as the reference does and returns its input;
- what the mesh changes in the arithmetic is read from the context:
  :func:`kv_repeat_for_tp` (attention) and :func:`batch_shard_count` /
  :func:`model_axis_size` (the MoE block's token groups and its
  expert-parallel exchange, :mod:`repro_torch.models.moe`).

A :class:`PartitionSpec` (``P``) is a tuple with one entry a dim: None,
an axis name, or a tuple of names (major first). A :class:`Mesh` has no
axis types: jax 0.9.0's default Explicit axes reject the reference's
``with_sharding_constraint``, its Auto axes run it, and nothing here
depends on the difference.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
import types
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.api import checked_device

MODEL_AXIS = "model"

#: The active context, thread-local as the reference's. Autograd runs a
#: CUDA backward, and remat's recomputation inside it, on its own device
#: threads: :func:`remat_context` carries the forward's context there.
_ctx = threading.local()


class PartitionSpec(tuple):
    """One entry a dim: None (replicated), an axis name, or a tuple of
    axis names (their product shards the dim, the first name major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


class Mesh:
    """Named axes over positions in one process.

    Args:
      shape: the axes' sizes.
      axis_names: one name an axis.
      devices: a device a position, in row-major order (positions may
        repeat a device), or one device for every position. ``None`` puts
        the positions round robin over the cards (:meth:`round_robin`).
        Every device is checked: a CUDA device needs a card.
    """

    def __init__(self, shape, axis_names, devices=None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names):
            raise ValueError(f"mesh axes {axis_names} for shape {shape}")
        n = math.prod(shape)
        if devices is None:
            n_cards = max(torch.cuda.device_count(), 1)
            devices = [f"cuda:{p % n_cards}" for p in range(n)]
        elif isinstance(devices, (str, torch.device)):
            devices = [devices] * n
        devices = [checked_device(d, "Mesh") for d in devices]
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for a mesh of {n} "
                             "positions")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.devices = np.empty(shape, dtype=object)
        for pos, d in zip(self.positions(), devices):
            self.devices[pos] = d

    @classmethod
    def round_robin(cls, shape, axis_names) -> "Mesh":
        """Position ``p`` (row-major) on card ``p %
        torch.cuda.device_count()``."""
        return cls(shape, axis_names)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def positions(self):
        """Every position's coordinates, row-major."""
        return itertools.product(*(range(s) for s in self.shape.values()))

    def device(self, pos) -> torch.device:
        return self.devices[tuple(pos)]

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices {devs})"


def make_mesh(shape, axis_names, *, device="cuda") -> Mesh:
    """``jax.make_mesh``'s counterpart: ``device="cuda"`` puts the
    positions round robin over the cards; any other device holds every
    position."""
    if str(device) == "cuda":
        return Mesh.round_robin(shape, axis_names)
    return Mesh(shape, axis_names, device)


# ----------------------------------------------------------- mesh axes ---
def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """Every mesh axis that is not the tensor-parallel axis."""
    return tuple(n for n in mesh.axis_names if n != MODEL_AXIS)


def _axis_size(mesh: Mesh, name: str) -> int:
    return int(mesh.shape[name]) if name in mesh.axis_names else 1


def _names(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _entry_size(mesh: Mesh, entry) -> int:
    """Total number of shards one spec entry implies."""
    if entry is None:
        return 1
    return math.prod(_axis_size(mesh, n) for n in _names(entry))


def _entry_valid(mesh: Mesh, entry) -> bool:
    return all(n in mesh.axis_names for n in _names(entry))


def sanitize_spec(spec, shape, mesh: Mesh) -> P:
    """Replicate every spec entry whose axis product does not divide the
    corresponding dim (or that names axes absent from the mesh)."""
    out = []
    for d, entry in enumerate(tuple(spec)):
        if entry is None or d >= len(shape) or not _entry_valid(mesh,
                                                                 entry):
            out.append(None)
            continue
        size = _entry_size(mesh, entry)
        out.append(entry if size and shape[d] % size == 0 else None)
    return P(*out)


# ----------------------------------------------------------- placement ---
class NamedSharding:
    """A spec resolved against a mesh: which block of a tensor each
    position holds."""

    def __init__(self, mesh: Mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)
        self._maps = {}

    def _check(self, shape):
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} for a {len(shape)}-D shape")
        for d, entry in enumerate(self.spec):
            size = _entry_size(self.mesh, entry)
            if shape[d] % size:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"into {size} ({self.spec})")

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The shape of one position's block (``jax``'s
        ``NamedSharding.shard_shape``)."""
        self._check(shape)
        return tuple(s // _entry_size(self.mesh, self.spec[d])
                     if d < len(self.spec) else s
                     for d, s in enumerate(shape))

    def indices_map(self, shape) -> dict:
        """Position → its block as a tuple of slices, one a dim (the
        counterpart of ``jax``'s ``devices_indices_map``, keyed by
        position since positions may share a device; kept for the next
        call with the same shape)."""
        shape = tuple(shape)
        if shape in self._maps:
            return self._maps[shape]
        self._check(shape)
        coord = dict(zip(self.mesh.axis_names, range(len(self.mesh.shape))))
        out = {}
        for pos in self.mesh.positions():
            idx = []
            for d, s in enumerate(shape):
                entry = self.spec[d] if d < len(self.spec) else None
                if _entry_size(self.mesh, entry) == 1:
                    idx.append(slice(None))
                    continue
                i = 0
                for name in _names(entry):
                    i = i * self.mesh.shape[name] + pos[coord[name]]
                blk = s // _entry_size(self.mesh, entry)
                idx.append(slice(i * blk, (i + 1) * blk))
            out[pos] = tuple(idx)
        self._maps[shape] = out
        return out

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and self.mesh is other.mesh
                and self.spec == other.spec)

    __hash__ = None

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec})"


class LayerSharding:
    """One layer's slice ``leaf[index]`` of a stacked leaf placed by
    ``leaf``: the reference stacks layers in one array, the port holds
    a tensor a layer.

    A position holds the layer when its block of the leaf's leading dims
    contains ``index`` (a stacked leaf whose layer axis is sharded over
    ``data`` keeps each layer on the data coordinates that hold its
    index) and holds nothing of it otherwise.
    """

    def __init__(self, leaf: NamedSharding, leaf_shape, index):
        self.leaf = leaf
        self.leaf_shape = tuple(leaf_shape)
        self.index = tuple(index)
        self.mesh = leaf.mesh
        self.spec = P(*tuple(leaf.spec)[len(self.index):])

    def shard_shape(self, shape) -> tuple[int, ...]:
        return self.leaf.shard_shape(self.leaf_shape)[len(self.index):]

    def indices_map(self, shape) -> dict:
        """Position → the layer's block, or None where the position
        holds nothing of the layer."""
        out = {}
        n = len(self.index)
        for pos, idx in self.leaf.indices_map(self.leaf_shape).items():
            lead = idx[:n]
            held = all(sl.start is None or sl.start <= i < sl.stop
                       for sl, i in zip(lead, self.index))
            out[pos] = idx[n:] if held else None
        return out

    def __repr__(self) -> str:
        return (f"LayerSharding({self.index} of {self.leaf_shape}, "
                f"{self.leaf})")


class Placed:
    """A tensor placed on a mesh: ``blocks`` maps each position that holds
    some of it to its block on the position's device.

    ``whole`` is the tensor placed, kept where every block is a view of
    it (every holding position shares its device); :func:`gather` then
    returns it without a copy.
    """

    def __init__(self, sharding, shape, dtype, blocks, whole=None):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.dtype = dtype
        self.blocks = blocks
        self.whole = whole

    def __repr__(self) -> str:
        return (f"Placed({self.shape}, {self.dtype}, {len(self.blocks)} "
                f"blocks, {self.sharding})")


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, Placed))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves (tensors, :class:`Placed`) of nested dicts,
    lists and tuples; ``rest`` are trees of the same structure, or a
    single leaf-level object (a sharding) used for every leaf."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] if isinstance(r, Mapping) else r
                                     for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_leaf(tree):
        return type(tree)(tree_map(fn, v, *(
            r[i] if isinstance(r, (list, tuple)) else r
            for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def _put(t, sharding):
    if isinstance(t, Placed):
        t = gather(t)
    idx_map = sharding.indices_map(t.shape)
    blocks = {pos: t[idx].to(sharding.mesh.device(pos))
              for pos, idx in idx_map.items() if idx is not None}
    views = all(sharding.mesh.device(pos) == t.device for pos in blocks)
    return Placed(sharding, t.shape, t.dtype, blocks, t if views else None)


def device_put(tree, shardings):
    """Place every tensor of ``tree`` by the sharding at the same place in
    ``shardings`` (or by one sharding for all): a tree of
    :class:`Placed`. A :class:`Placed` leaf is gathered first."""
    return tree_map(_put, tree, shardings)


def _gather(x, device=None):
    if not isinstance(x, Placed):
        return x if device is None else x.to(device)
    if x.whole is not None and (device is None
                                or x.whole.device == torch.device(device)):
        return x.whole
    if device is None:
        device = next(iter(x.blocks.values())).device
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    idx_map = x.sharding.indices_map(x.shape)
    for pos, blk in x.blocks.items():
        out[idx_map[pos]] = blk.to(device)
    return out


def gather(tree, device=None):
    """The whole tensors of a tree of :class:`Placed` (plain tensors pass
    through), on ``device`` or on the first block's device."""
    return tree_map(lambda x: _gather(x, device), tree)


def _refresh(x, whole):
    with torch.no_grad():
        if not isinstance(x, Placed):
            if x is not whole:
                x.copy_(whole)
            return
        if x.whole is whole:
            return
        idx_map = x.sharding.indices_map(x.shape)
        for pos, blk in x.blocks.items():
            blk.copy_(whole[idx_map[pos]])


def refresh_(placed, wholes) -> None:
    """Write ``wholes`` (the gathered tree, since updated) back into
    ``placed``: into every block that is not a view of its whole, and
    into every plain tensor that ``wholes`` replaced."""
    tree_map(_refresh, placed, wholes)


# ------------------------------------------------------- step context ----
def dp_only_of(cfg) -> bool:
    """Small-model escape hatch: batch over *all* mesh axes, no TP."""
    return bool(getattr(cfg, "dp_only", False))


@contextlib.contextmanager
def _installed(state):
    prev = _current()
    _ctx.state = state
    try:
        yield
    finally:
        _ctx.state = prev


def activation_context(mesh: Mesh, dp_only: bool = False):
    """Install the mesh for :func:`constrain` and friends for one step,
    in the calling thread."""
    return _installed((mesh, bool(dp_only)))


def remat_context():
    """``torch.utils.checkpoint``'s ``context_fn``: the recomputation runs
    inside the context that was active when the forward ran, on whichever
    thread autograd runs it (a CUDA backward runs on autograd's device
    thread, which has no context of its own)."""
    return contextlib.nullcontext(), _installed(_current())


def _current():
    return getattr(_ctx, "state", None)


def current_mesh_info():
    """(mesh, batch-axes spec entry) of the active context, or (None,
    None). The second element is what ``"batch"`` resolves to."""
    state = _current()
    if state is None:
        return None, None
    mesh, dp_only = state
    ba = tuple(mesh.axis_names) if dp_only else data_axes(mesh)
    return mesh, ba


def model_axis_size() -> int:
    """Size of the TP axis in the active context (1 outside / dp_only)."""
    state = _current()
    if state is None:
        return 1
    mesh, dp_only = state
    return 1 if dp_only else _axis_size(mesh, MODEL_AXIS)


def batch_shard_count() -> int:
    """Number of batch shards in the active context (1 outside)."""
    mesh, ba = current_mesh_info()
    if mesh is None:
        return 1
    return math.prod(_axis_size(mesh, n) for n in ba)


def kv_repeat_for_tp(kv: int, h: int) -> int:
    """How many times to repeat KV heads so the kv-head dim divides the TP
    axis (GQA groups absorb the repetition). 1 outside a context, when
    the split already divides, or when no valid repetition exists."""
    mt = model_axis_size()
    if mt <= 1 or kv % mt == 0:
        return 1
    rep = mt // math.gcd(kv, mt)
    if rep > 1 and kv * rep <= h and h % (kv * rep) == 0:
        return rep
    return 1


def constraint_spec(shape, *axes):
    """The sanitized spec that :func:`constrain` resolves ``axes`` to for
    a tensor of ``shape``, or None outside a context."""
    state = _current()
    if state is None:
        return None
    mesh, dp_only = state
    _, ba = current_mesh_info()
    entries = []
    for a in axes:
        if a == "batch":
            entries.append(ba if ba else None)
        elif a == MODEL_AXIS:
            entries.append(None if dp_only else MODEL_AXIS)
        else:
            entries.append(a)
    return sanitize_spec(P(*entries), tuple(shape), mesh)


def constrain(x, *axes):
    """``with_sharding_constraint`` by logical axis names: ``"batch"``,
    ``"model"`` or None a dim. The spec resolves as the reference's does
    (:func:`constraint_spec`); one process computes on whole tensors, so
    ``x`` comes back as it is."""
    constraint_spec(x.shape, *axes)
    return x


# --------------------------------------------------- placement rules -----
def _key_names(path) -> list[str]:
    out = []
    for part in path:
        key = getattr(part, "key", None)
        if key is None:
            key = getattr(part, "name", part)
        out.append(str(key))
    return out


def spec_for(path, leaf) -> P:
    """Logical parameter spec from a key path and a leaf with ``ndim``:
    embeddings → ``("model", "data")`` on their last two dims; anything
    else with ≥ 2 dims → ``("data", "model")`` on its last two dims,
    leading dims replicated; vectors and scalars replicated."""
    ndim = getattr(leaf, "ndim", 0)
    names = _key_names(path)
    if any("embed" in n for n in names) and ndim >= 2:
        return P(*([None] * (ndim - 2) + [MODEL_AXIS, "data"]))
    if ndim >= 2:
        return P(*([None] * (ndim - 2) + ["data", MODEL_AXIS]))
    return P(*([None] * ndim))


def _resolve(mesh: Mesh, spec) -> P:
    """Map the logical ``"data"`` entry onto every data axis of the mesh
    (a 3D ``pod×data×model`` mesh shards over pod and data together)."""
    da = data_axes(mesh)
    return P(*((da if len(da) > 1 else (da[0] if da else None))
               if entry == "data" else entry for entry in tuple(spec)))


def _leaf_sharding(mesh: Mesh, spec, shape) -> NamedSharding:
    return NamedSharding(mesh, sanitize_spec(_resolve(mesh, spec), shape,
                                             mesh))


def _flat_names(tree, prefix=()):
    """(dotted name, leaf) of a nested mapping, depth first."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat_names(v, prefix + (str(k),))
        else:
            yield ".".join(prefix + (str(k),)), v


def _unflatten_like(tree, values, prefix=()):
    out = {}
    for k, v in tree.items():
        name = ".".join(prefix + (str(k),))
        out[k] = (_unflatten_like(v, values, prefix + (str(k),))
                  if isinstance(v, Mapping) else values[name])
    return out


def _stacked(mesh: Mesh, tree):
    """(path, layout grid, stacked shape, sanitized spec) of every leaf of
    the reference's view of ``tree``, and ``tree`` as a mapping."""
    from repro_torch.models.convert import layout_of

    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    leaves = dict(_flat_names(tree))
    out = []
    for path, grid in layout_of(leaves).items():
        shape = grid.shape + tuple(leaves[grid.flat[0]].shape)
        spec = spec_for(path, types.SimpleNamespace(ndim=len(shape),
                                                    shape=shape))
        out.append((path, grid, shape,
                    sanitize_spec(_resolve(mesh, spec), shape, mesh)))
    return out, tree


def leaf_specs(mesh: Mesh, tree) -> dict:
    """The reference's view of a parameter tree: path → (stacked shape,
    sanitized spec), for a module, a mapping of port parameter names
    (``dict(model.named_parameters())``, the AdamW moments) or a nested
    mapping in the reference's layout.

    Parameters ``<container>.<i>.<rest>`` stack into one leaf of the
    reference's tree (:func:`repro_torch.models.convert.layout_of`), so
    every spec is computed on the leaf's stacked shape, as the reference
    computes it."""
    return {path: (shape, spec)
            for path, _, shape, spec in _stacked(mesh, tree)[0]}


def param_shardings(mesh: Mesh, tree, replicate: bool = False):
    """A sharding for every tensor of a parameter tree, in its structure
    (a module gives a mapping by parameter name).

    A tensor that is a whole leaf of the reference's tree gets that
    leaf's :class:`NamedSharding` (:func:`leaf_specs`); a layer of a
    stacked leaf gets its slice of the leaf's (:class:`LayerSharding`).
    ``replicate`` gives every tensor ``P()``."""
    stacked, tree = _stacked(mesh, tree)
    out = {}
    for _, grid, shape, spec in stacked:
        leaf = NamedSharding(mesh, P() if replicate else spec)
        for ix in np.ndindex(grid.shape):
            out[grid[ix]] = (leaf if not ix or replicate
                             else LayerSharding(leaf, shape, ix))
    return _unflatten_like(tree, out)


def batch_spec(mesh: Mesh, ndim: int) -> P:
    """Batch tensors shard dim 0 over the data axes, rest replicated."""
    da = data_axes(mesh)
    first = da if len(da) > 1 else (da[0] if da else None)
    return P(*([first] + [None] * (ndim - 1)))


def batch_shardings(mesh: Mesh, tree):
    return tree_map(lambda leaf: NamedSharding(mesh, sanitize_spec(
        batch_spec(mesh, leaf.ndim), tuple(leaf.shape), mesh)), tree)


def cache_shardings(mesh: Mesh, cache):
    """Decode caches: dim 0 over data, the head/state dim (−2 for rank
    ≥ 3) over model."""
    def one(leaf):
        entries = [None] * leaf.ndim
        if leaf.ndim >= 1:
            da = data_axes(mesh)
            entries[0] = da if len(da) > 1 else (da[0] if da else None)
        if leaf.ndim >= 3:
            entries[-2] = MODEL_AXIS
        return NamedSharding(mesh, sanitize_spec(P(*entries),
                                                 tuple(leaf.shape), mesh))

    return tree_map(one, cache)
