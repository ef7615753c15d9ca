"""Reading a profiled slice of the window: device busy time, device time
by group, and idle gaps named by what the host was doing.

A frozen copy of the port's smoke script's kernel-interval reading
(busy time as the union of the device intervals, the raw kineto events
read directly, kernels grouped by name), extended to name the idle
gaps. ``import torch`` happens inside the functions that need it.
"""
from __future__ import annotations

import bisect
import time

#: Kernel name fragment → group; the first match wins.
GROUPS = (("spmm_mxu", "K1 spmm_mxu"),
          ("spmm_vpu", "K2 spmm_vpu"),
          ("sddmm_mxu", "K3 sddmm_mxu"),
          ("sddmm_vpu", "K4 sddmm_vpu"),
          ("indexfunc", "combines (index_add_)"),
          ("scatter_gather", "scatter_reduce (softmax max)"))
GATHERS = ("index_elementwise", "indexselect", "gather")
GEMMS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")


def classify(kernel: str) -> str:
    """The group of a device operation of a GNN step or flush."""
    k = kernel.lower()
    for frag, group in GROUPS:
        if frag in k:
            return group
    if any(w in k for w in GATHERS):
        return "gathers (revaluation, permutes, softmax)"
    if any(w in k for w in GEMMS):
        return "dense products"
    if "memcpy" in k or "memset" in k:
        return "copies and fills"
    return "rest (elementwise, reductions)"


def union(spans: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The union of (start, end) intervals, sorted and merged."""
    out: list[list[int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Slice:
    """``torch.profiler`` over a stretch of the window.

    ``start()`` synchronises and starts the profiler, ``stop()``
    synchronises and stops it. :meth:`summary` reads the trace; the
    traced window runs from the trace's first event to its last, host
    and device alike, on the trace's one clock."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.start_s = 0.0

    def prime(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        in a process takes seconds, which would otherwise stall the
        window where the slice begins."""
        self.start()
        self.stop()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        t = time.perf_counter()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.start_s = time.perf_counter() - t

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def summary(self, top: int = 10) -> dict | None:
        """``busy_s``, ``window_s``, ``device_ops`` (device seconds by
        group, largest first) and ``idle_gaps`` (idle device seconds by
        the innermost host operation running at each gap's middle,
        largest first); None when the trace holds no device time."""
        from torch.autograd import DeviceType

        device, by_group, ops = [], {}, {}
        first, last = None, None
        for e in self.prof.profiler.kineto_results.events():
            if first is None or e.start_ns() < first:
                first = e.start_ns()
            if last is None or e.end_ns() > last:
                last = e.end_ns()
            kind = e.device_type()
            if kind == DeviceType.CUDA:
                if (e.is_user_annotation()
                        or e.name().startswith("ProfilerStep")):
                    continue
                s, t = e.start_ns(), e.end_ns()
                device.append((s, t))
                g = classify(e.name())
                by_group[g] = by_group.get(g, 0.0) + (t - s) / 1e9
            elif (kind == DeviceType.CPU and not e.is_async()
                  and e.start_thread_id() == e.end_thread_id()):
                ops.setdefault(e.start_thread_id(), []).append(
                    (e.start_ns(), e.end_ns(), e.name()))
        if not device:
            return None
        busy = union(device)
        busy_s = sum(e - s for s, e in busy) / 1e9
        # The harness's thread launches the work: the one whose operations
        # cover the most time.
        host = max(ops.values(), key=lambda v: sum(e - s for s, e, _ in v),
                   default=[])
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
                if busy[i + 1][0] > busy[i][1]]
        idle = _name_gaps(gaps, host)
        return {
            "busy_s": busy_s,
            "window_s": (last - first) / 1e9,
            "device_ops": sorted(([k, v] for k, v in by_group.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:top],
        }


def _name_gaps(gaps, host) -> dict[str, float]:
    """Idle seconds by the innermost host operation that encloses each
    gap's middle ("host outside any operation" when none does)."""
    host = sorted(host, key=lambda o: (o[0], -o[1]))
    starts = [o[0] for o in host]
    out: dict[str, float] = {}
    stack: list[tuple[int, int, str]] = []
    i = 0
    for s, e in sorted(gaps):
        mid = (s + e) // 2
        j = bisect.bisect_right(starts, mid)
        while i < j:
            op = host[i]
            while stack and stack[-1][1] <= op[0]:
                stack.pop()
            stack.append(op)
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        # Innermost: the deepest op still open at ``mid``.
        name = next((op[2] for op in reversed(stack) if op[1] > mid),
                    "host outside any operation")
        out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out
