"""Device time of one operator call, for the roofline readers."""
from __future__ import annotations

#: Device cycles of the sleep the timed calls queue behind (tens of ms).
SLEEP_CYCLES = 50_000_000


def device_seconds(fn, runs: int = 20, warm: int = 3) -> float:
    """Mean seconds of ``fn()`` over ``runs`` calls back to back between
    two CUDA events, after ``warm`` calls, with autograd off. The calls
    are queued behind a device sleep, so the time is the device's and
    not the host's launches."""
    import torch

    with torch.no_grad():
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / runs
