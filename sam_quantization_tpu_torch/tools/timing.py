"""Per-call times of a device function, for the probe drivers."""

from __future__ import annotations

import time

import torch


def timed_ms(fn, iters: int, device: torch.device, repeats: int = 3) -> float:
    """The least, over ``repeats`` runs, of the mean ms per call of ``iters``
    back-to-back calls of ``fn`` after one warm-up call: CUDA events around
    the calls on the card (the device's time), the host clock on the CPU."""
    fn()
    best = float("inf")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / iters)
        return best
    for _ in range(repeats):
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t) * 1e3 / iters)
    return best


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (host clock)"
