"""Roofline terms from the torch ops a step dispatches (the dry-run
"profiler").

The reference (``repro.launch.hlo_analysis``) parses XLA's compiled HLO.
The port compiles no HLO: its counterpart of the compiled program is the
sequence of aten ops that a step dispatches in eager PyTorch.
:class:`OpCounter`, a ``TorchDispatchMode``, sees them one by one on any
device, ``meta`` included, and counts:

* **flops** of aten's matrix products and convolutions (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, ``convolution`` and its backward, and
  what ``einsum``, ``matmul`` and ``linear`` decompose into), with the
  formulas of ``torch.utils.flop_counter``, kept by dtype; plus the work
  that the hand-written kernels report
  (:func:`repro_torch.kernels._build.report_work`), since a launch
  through ``ctypes`` never reaches a dispatch mode;
* **HBM bytes**: eager PyTorch fuses nothing, so every non-view op is a
  kernel that reads its tensor inputs and writes its outputs once. Views,
  reshapes, aliases and bare allocations count 0. This replaces the
  reference's model of TPU fusion (``_COUNT_BYTES_OPS``, ``_line_bytes``)
  on purpose;
* **peak live bytes**: every output storage that no input of its op
  shares counts once, from that op until the storage dies (a finalizer
  on its untyped storage). The storages of the step's arguments are the
  baseline.

A kernel's own aten ops run inside :meth:`OpCounter.kernel_scope`: its
output allocation before a launch (``<kernel>/outputs``), or its whole
plain twin on CPU tensors (``<kernel>/twin``). They are recorded apart,
in :attr:`HloStats.apart`, and left out of the totals; the kernel's
outputs count as allocated when the scope hands them over. So a CPU
count, a ``meta`` count and a card's count of one program agree exactly.

Collective bytes are the copies a step makes between distinct cards. One
process computes on whole tensors on one card, so they are 0: the port
partitions nothing, and the reference's GSPMD collectives have nothing
here to count. The HLO-text parser is not ported: the port makes no HLO.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types
import weakref
from collections.abc import Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.dist.sharding import Placed
from repro_torch.kernels import _build

_aten = torch.ops.aten
#: Ops that move no data although the schema does not call them views:
#: allocations that write nothing, and aliases.
_NO_TRAFFIC = {_aten.empty, _aten.empty_strided, _aten.empty_like,
               _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
               _aten.alias, _aten.detach, _aten.lift_fresh}


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _tensors(xs) -> list[torch.Tensor]:
    """The tensors among an op's arguments or results (tensors and lists
    or tuples of tensors; aten nests no deeper)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):   # no storage (sparse)
        return None


def _arg_tensors(tree, out: list) -> list:
    """Every tensor a step's arguments hold: module parameters, their
    ``.grad`` and buffers, nested mappings, lists and tuples, and the
    blocks of placed tensors (``dist.sharding.Placed``)."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        if tree.grad is not None:
            out.append(tree.grad)
    elif isinstance(tree, torch.nn.Module):
        for t in (*tree.parameters(), *tree.buffers()):
            _arg_tensors(t, out)
    elif isinstance(tree, Mapping):
        for v in tree.values():
            _arg_tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _arg_tensors(v, out)
    elif isinstance(tree, Placed):
        _arg_tensors([tree.whole, *tree.blocks.values()], out)
    return out


def _add(table: dict, key: str, flops: float, nbytes: float) -> None:
    row = table.setdefault(key, {"flops": 0.0, "bytes": 0.0, "calls": 0})
    row["flops"] += flops
    row["bytes"] += nbytes
    row["calls"] += 1


@dataclasses.dataclass
class HloStats:
    """What one step did: the reference's fields (``flops``, ``hbm_bytes``
    and the collectives, here always empty), the flops by dtype, the
    totals by op or kernel name (``by_op``: flops, bytes and calls), the
    kernels' own aten ops kept out of the totals (``apart``), each
    kernel's calls by problem size (``kernel_calls``: ``"b,sq,sk,h,kv,d"``
    for K5), and the
    memory: bytes of the arguments' storages (``arg_bytes``), the peak of
    live bytes above them (``temp_bytes``), the outputs' bytes and those
    of the outputs that share an argument's storage (``alias_bytes``)."""

    flops: float
    hbm_bytes: float
    coll_op_bytes: dict[str, float]
    link_traffic: float
    coll_count: int
    flops_by_dtype: dict[str, float] = dataclasses.field(default_factory=dict)
    by_op: dict[str, dict] = dataclasses.field(default_factory=dict)
    apart: dict[str, dict] = dataclasses.field(default_factory=dict)
    kernel_calls: dict[str, dict[str, int]] = dataclasses.field(
        default_factory=dict)
    arg_bytes: int = 0
    temp_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0

    @property
    def peak_live_bytes(self) -> int:
        return self.arg_bytes + self.temp_bytes

    def op_calls(self) -> dict[str, int]:
        return {k: v["calls"] for k, v in self.by_op.items()}

    def per_device(self, n_chips: int) -> "HloStats":
        """The global one-process program's work and memory over
        ``n_chips``: what each position would carry if the program were
        partitioned evenly (``by_op`` and ``apart`` stay global)."""
        n = max(n_chips, 1)
        return dataclasses.replace(
            self, flops=self.flops / n, hbm_bytes=self.hbm_bytes / n,
            flops_by_dtype={k: v / n for k, v in self.flops_by_dtype.items()},
            arg_bytes=self.arg_bytes // n, temp_bytes=self.temp_bytes // n,
            output_bytes=self.output_bytes // n,
            alias_bytes=self.alias_bytes // n)


class _Scope:
    def __init__(self, counter: "OpCounter"):
        self._counter = counter

    def outputs(self, *tensors) -> None:
        for t in tensors:
            self._counter._allocate(_storage(t))


class OpCounter(TorchDispatchMode):
    """Counts flops, HBM bytes and live storage of every aten op dispatched
    inside it, and the work kernels report (module docstring).
    ``baseline`` is the step's arguments: their storages are alive at
    entry and count as ``arg_bytes``, not as allocations."""

    def __init__(self, baseline=()):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.flops_by_dtype: dict[str, float] = {}
        self.by_op: dict[str, dict] = {}
        self.apart: dict[str, dict] = {}
        self.kernel_calls: dict[str, dict[str, int]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._scope = None
        self._live: dict[int, int] = {}
        self._base: dict[int, int] = {}
        self.arg_bytes = 0
        for t in _arg_tensors(baseline, []):
            st = _storage(t)
            if st is not None and id(st) not in self._base:
                self._base[id(st)] = st.nbytes()
                weakref.finalize(st, self._base.pop, id(st), None)
                self.arg_bytes += st.nbytes()

    # -- the installed counter, for the kernels' reports ------------------
    def __enter__(self):
        _build.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.COUNTERS.remove(self)
        return super().__exit__(*exc)

    def kernel_work(self, name: str, flops: float, nbytes: float,
                    dtype, shape=None) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes
        key = _dtype_name(dtype)
        self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0.0) + flops
        _add(self.by_op, name, flops, nbytes)
        if shape is not None:
            calls = self.kernel_calls.setdefault(name, {})
            key = ",".join(map(str, shape))
            calls[key] = calls.get(key, 0) + 1

    @contextlib.contextmanager
    def kernel_scope(self, name: str, *, twin: bool):
        prev = self._scope
        self._scope = f"{name}/{'twin' if twin else 'outputs'}"
        try:
            yield _Scope(self)
        finally:
            self._scope = prev

    # -- live storage ------------------------------------------------------
    def _allocate(self, st) -> None:
        if st is None or id(st) in self._live or id(st) in self._base:
            return
        n = st.nbytes()
        self._live[id(st)] = n
        weakref.finalize(st, self._free, id(st))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key)

    def knows(self, storage) -> bool:
        """Whether ``storage`` is an argument's or a counted allocation."""
        return id(storage) in self._live or id(storage) in self._base

    # -- the ops -----------------------------------------------------------
    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        ins = _tensors((*args, *kwargs.values()))
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        moved = 0 if func.is_view or packet in _NO_TRAFFIC else (
            _nbytes(ins) + _nbytes(outs))
        if self._scope is not None:
            _add(self.apart, self._scope, flops, moved)
            return out
        self.hbm_bytes += moved
        if flops:
            self.flops += flops
            key = _dtype_name(ins[0].dtype)
            self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0.0) + flops
        _add(self.by_op, str(packet), flops, moved)
        if outs:
            shared = {id(s) for s in map(_storage, ins) if s is not None}
            for t in outs:
                st = _storage(t)
                if st is not None and id(st) not in shared:
                    self._allocate(st)
        return out

    def stats(self, outputs=()) -> HloStats:
        """The counts so far; ``outputs`` are the step's results."""
        outs = _arg_tensors(outputs, [])
        alias = [t for t in outs if (s := _storage(t)) is not None
                 and id(s) in self._base]
        return HloStats(
            flops=self.flops, hbm_bytes=self.hbm_bytes, coll_op_bytes={},
            link_traffic=0.0, coll_count=0,
            flops_by_dtype=dict(self.flops_by_dtype),
            by_op={k: dict(v) for k, v in self.by_op.items()},
            apart={k: dict(v) for k, v in self.apart.items()},
            kernel_calls={k: dict(v) for k, v in self.kernel_calls.items()},
            arg_bytes=self.arg_bytes, temp_bytes=self.peak_bytes,
            output_bytes=_nbytes(outs), alias_bytes=_nbytes(alias))


def analyze_step(fn, *args, **kwargs) -> HloStats:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter` whose
    baseline is the arguments; the port's ``analyze_hlo``. On ``meta``
    tensors nothing runs but the shapes."""
    with OpCounter(baseline=(args, kwargs)) as counter:
        out = fn(*args, **kwargs)
    return counter.stats(out)


# ------------------------------------------------------------- roofline ---
@dataclasses.dataclass(frozen=True)
class Hardware:
    """NVIDIA H100 80GB HBM3, 700 W, data sheet (SXM, dense): bf16/fp16
    and TF32 Tensor Core, fp32 and fp64 peaks, HBM bandwidth, and NVLink
    bandwidth in one direction. ``peak_flops`` is the rate of flops that
    carry no dtype (the reference's single peak)."""

    peak_flops: float = 989e12     # bf16 per card
    hbm_bw: float = 3.35e12        # bytes/s per card
    link_bw: float = 450e9         # bytes/s per card, one direction
    peak_by_dtype: Mapping = dataclasses.field(
        default_factory=lambda: types.MappingProxyType({
            "bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
            "float32": 67e12, "float64": 67e12}))

    def peak_for(self, dtype: str) -> float:
        return self.peak_by_dtype.get(dtype, self.peak_flops)


@dataclasses.dataclass
class Roofline:
    flops_per_dev: float
    hbm_bytes_per_dev: float
    coll_bytes_per_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_from_stats(st: HloStats, hw: Hardware = Hardware(),
                        model_flops_global: float = 0.0,
                        n_chips: int = 1) -> Roofline:
    """The reference's formula; compute time is each dtype's flops over
    its own peak when the stats keep them by dtype (fp32 products run on
    the CUDA cores at 67 TFLOP/s: the port leaves TF32 off), else the
    flops over ``peak_flops``."""
    if st.flops_by_dtype:
        c_s = sum(f / hw.peak_for(dt) for dt, f in st.flops_by_dtype.items())
    else:
        c_s = st.flops / hw.peak_flops
    m_s = st.hbm_bytes / hw.hbm_bw
    l_s = st.link_traffic / hw.link_bw
    terms = {"compute": c_s, "memory": m_s, "collective": l_s}
    bott = max(terms, key=terms.get)
    mf_dev = model_flops_global / max(n_chips, 1)
    return Roofline(
        flops_per_dev=st.flops,
        hbm_bytes_per_dev=st.hbm_bytes,
        coll_bytes_per_dev=st.link_traffic,
        compute_s=c_s,
        memory_s=m_s,
        collective_s=l_s,
        bottleneck=bott,
        model_flops=mf_dev,
        useful_ratio=(mf_dev / st.flops) if st.flops else 0.0,
    )


def roofline_from_step(fn, *args, hw: Hardware = Hardware(),
                       model_flops_global: float = 0.0, n_chips: int = 1,
                       **kwargs) -> Roofline:
    """:func:`analyze_step` of ``fn``, over ``n_chips``, as a roofline; the
    port's ``roofline_from_compiled``."""
    st = analyze_step(fn, *args, **kwargs).per_device(n_chips)
    return roofline_from_stats(st, hw, model_flops_global, n_chips)
