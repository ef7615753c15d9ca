"""Build and load the hand-written Hopper kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together), linked into one shared library with
a plain C interface, and loaded with :mod:`ctypes`. The library lands in
``build/repro_torch/`` at the repository root, named by a hash of the
sources and flags, so an unchanged tree reuses it and a changed one
rebuilds. Nothing builds on import: :func:`library` runs at the first
kernel launch.

A kernel launched through :mod:`ctypes` is invisible to a
``TorchDispatchMode``, so each wrapper reports its own work to the
installed op counter (``repro_torch.launch.hlo_analysis.OpCounter``)
through :func:`report_work`, and runs its output allocation (or, on CPU
tensors, its plain twin) inside :func:`kernel_scope`. Both do nothing
unless a counter is installed.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: C entry point → argument types. Pointers and the stream are
#: ``c_void_p`` (a bare Python int would be cut to 32 bits).
SIGNATURES = {
    # vals, cols, seg_len, rank, b, out, nb, bk, n, atomic_out, vec4, stream
    "spmm_mxu_launch": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P),
    # vals, cols, row_len, b, out, ntiles, ts, n, slice_cols, vec4, stream
    "spmm_vpu_launch": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P),
    # cols, bitmap, window, x, y, out, nb, bk, kf, mrows, slice_feats,
    # vec4, stream
    "sddmm_mxu_launch": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _L, _I, _I,
                         _P),
    # rows, cols, x, y, out, nel, kf, slice_feats, vec4, stream
    "sddmm_vpu_launch": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _P),
    # q, k, v, o, lse (or null), b, sq, sk, h, kv, d, q/k/v strides over
    # (B, S, H), scale, softcap, causal, window, q_offset, dtype, stream
    "flash_attention_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _L, _L, _L, _L, _L, _L, _L, _L, _L,
                               _F, _F, _I, _L, _L, _I, _P),
}


class ApplyError(RuntimeError):
    """Classified failure on the apply path.

    ``stage`` says where it died — ``"compile"`` (the kernel library did
    not build) or ``"execute"`` (a launch was refused) — ``key`` names
    what failed and ``cause`` is the original exception.
    """

    def __init__(self, stage: str, key, cause: BaseException):
        super().__init__(f"{stage} failed for apply key {key!r}: {cause}")
        self.stage = stage
        self.key = key
        self.cause = cause


#: Seconds the last :func:`library` call spent compiling (0.0 on reuse).
last_build_seconds = 0.0
#: ``ptxas -v`` report of the last build (registers, shared memory, spills).
last_build_log = ""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise ApplyError("compile", "nvcc", RuntimeError(
        "nvcc not found: the CUDA kernels need the CUDA toolkit (set "
        "CUDA_HOME or put nvcc on PATH)"))


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the kernels if the hashed library is missing; return it."""
    global last_build_seconds, last_build_log
    lib = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    if lib.exists():
        last_build_seconds = 0.0
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        last_build_log = "\n".join(logs)
        if failed:
            raise ApplyError("compile", tuple(failed), RuntimeError(
                f"nvcc failed:\n{last_build_log}"))
        tmp_lib = pathlib.Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp_lib),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise ApplyError("compile", lib.name, RuntimeError(
                f"nvcc link failed:\n{link.stdout}"))
        os.replace(tmp_lib, lib)
    last_build_seconds = time.perf_counter() - t0
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_torch_error_string.argtypes = (ctypes.c_int,)
    lib.repro_torch_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = library().repro_torch_error_string(err).decode()
        raise ApplyError("execute", name,
                         RuntimeError(f"cudaError {err} ({msg})"))


def on_cpu(*tensors) -> bool:
    """True when every operand lies on the CPU (the plain-twin case)."""
    return all(t.device.type == "cpu" for t in tensors)


def check_operands(name: str, *specs):
    """Validate kernel operands before their pointers reach C.

    ``specs`` are ``(arg, tensor, dtype, ndim)``; every tensor must be a
    contiguous CUDA tensor of that dtype and rank, all on one device.
    Returns that device.
    """
    dev = specs[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: operands must all be CUDA tensors (or "
                         f"all CPU tensors for the plain version), got {dev}")
    for arg, t, dtype, ndim in specs:
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name}: {arg} must have {ndim} dims, "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return dev


#: Bytes of a gathered operand's column slice that K2, K3 and K4 keep in
#: L2 while the slice runs: most of the H100's 50 MB.
#: On the GNN graph 43 MB slices beat 22 MB ones (fewer passes over the
#: tables) and 87 MB ones (L2 misses): tools/ab_vpu_kernels.py.
L2_SLICE_BYTES = 44 << 20


def pow2_slice(k: int, width: int, narrowest: int, widest: int) -> int:
    """Width of one slice of a gathered operand's ``width`` columns: the
    widest power-of-two multiple of ``narrowest``, at most ``widest``,
    whose ``k`` rows fit :data:`L2_SLICE_BYTES`, narrowed to the fewest
    that cover ``width`` in as many slices."""
    top = widest
    while top > narrowest and k * top * 4 > L2_SLICE_BYTES:
        top //= 2
    nslices = -(-width // top)
    need = -(-width // nslices)
    out = narrowest
    while out < need:
        out *= 2
    return out


def aligned16(*tensors) -> bool:
    """True when every tensor's data pointer allows float4 access."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def stream_handle(dev):
    """PyTorch's current stream on ``dev`` as a C pointer value.

    Kernels launch on this stream and return before they finish. That is
    safe for temporaries the caller drops at once (revalued tables, say):
    the caching allocator reuses freed memory only for work queued later
    on the same stream.
    """
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


#: Installed op counters, innermost last (``OpCounter`` pushes itself on
#: entry and pops itself on exit).
COUNTERS: list = []


def report_work(name: str, flops: float, nbytes: float, dtype,
                shape=None) -> None:
    """Count one call of kernel ``name``: ``flops`` operations in ``dtype``
    and ``nbytes`` of device memory moved; ``shape`` (a tuple of ints)
    names the call's problem size. Nothing unless a counter is
    installed."""
    if COUNTERS:
        COUNTERS[-1].kernel_work(name, flops, nbytes, dtype, shape)


class _NoScope:
    def outputs(self, *tensors) -> None:
        pass


def kernel_scope(name: str, *, twin: bool):
    """Context for the part of a kernel call that runs aten ops: the
    output allocation before a launch, or the whole plain twin on CPU
    tensors (``twin=True``). An installed counter records those ops apart,
    under ``name + "/twin"`` or ``name + "/outputs"``, and leaves them out
    of its totals; the scope's ``outputs(*tensors)`` hands it the
    kernel's outputs, whose storages it then counts as allocated."""
    if not COUNTERS:
        return contextlib.nullcontext(_NoScope())
    return COUNTERS[-1].kernel_scope(name, twin=twin)
