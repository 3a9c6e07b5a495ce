"""Per-call times of a device function, for the probe drivers."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

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


# The JAX probes' carry mixes, with their bfloat16 constants as exact floats
# (bf16(0.82) = 0.8203125, bf16(0.9) = 0.8984375, bf16(0.1) = 0.10009765625):
# a product by one rounds as JAX's product by the bf16 scalar does.
def scale_mix(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``tools/block_anatomy.py``'s ``f(x) * bf16(0.82)``."""
    return (y * 0.8203125).to(x.dtype)


def blend_mix(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``tools/{attn_stage,mlp_serving,rel}_probe.py``'s
    ``f(x) * bf16(0.9) + x * bf16(0.1)``."""
    return (y * 0.8984375 + x * 0.10009765625).to(x.dtype)


def launch_counts() -> Dict[str, int]:
    """Every kernel launch counter of the port (flash attention and its int8
    epilogue, the packed products, the fused MLP, the probe kernels) and the
    int8 products of ``IntLinear`` (cuBLAS), by name."""
    from sam_quantization_tpu_torch.ops import flash_attention as fa
    from sam_quantization_tpu_torch.ops import fused_mlp as fm
    from sam_quantization_tpu_torch.ops import probes as ps
    from sam_quantization_tpu_torch.ops import quant_matmul as qm

    return {**fa.LAUNCHES, **qm.LAUNCHES, **fm.LAUNCHES, **ps.LAUNCHES, **qm.INT8_MATMULS,
            **{f"{k} int8-out": c for k, c in fa.INT8_OUT.items()}}


def launch_delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    """The counters of :func:`launch_counts` that moved from ``before`` to ``after``."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@dataclasses.dataclass
class Carried:
    """What :func:`timed_carry` measured.

    ``ms``: per application, one replay of the captured graph over ``iters``
    on the card (device time, CUDA events), the plain loop on the host clock
    on the CPU. ``eager_ms``: the same loop launched op by op from Python,
    timed by the same events (None on the CPU); ``eager_ms - ms`` is the
    launch overhead of the stage. ``carry`` / ``eager_carry``: the final
    carry of the graph and of the eager loop (one tensor on the CPU).
    ``launches``: the kernel launches counted while the graph was captured,
    ``iters`` applications' worth; ``replay_launches``: those counted over
    the replays, which launch from the graph and count none. ``capture_s``: the
    capture and instantiation's wall seconds; ``graph_bytes``: the peak
    device memory the capture took above what was allocated before it.
    """

    ms: float
    eager_ms: Optional[float]
    carry: torch.Tensor
    eager_carry: torch.Tensor
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    replay_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    capture_s: float = 0.0
    graph_bytes: int = 0


def eager_columns(t: Carried, floor: Optional[Carried] = None) -> str:
    """The eager loop's ms beside a graph figure (both less ``floor``'s, when
    given) and their difference, the stage's launch overhead; empty on the
    CPU, which has no graph."""
    if t.eager_ms is None:
        return ""
    e = t.eager_ms - (floor.eager_ms if floor else 0.0)
    g = t.ms - (floor.ms if floor else 0.0)
    return f"  eager {e:7.3f} ms  eager-graph {e - g:7.3f} ms"


def _loop(f, mix, x, iters):
    for _ in range(iters):
        x = mix(f(x), x)
    return x


def timed_carry(f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, iters: int,
                mix: Callable = blend_mix, outer: int = 5, name: str = "stage") -> Carried:
    """Time ``iters`` sequential applications ``x <- mix(f(x), x)`` of a
    shape-preserving stage ``f``: the counterpart of the JAX tools'
    ``timed_carry`` (a carried ``lax.scan`` in one dispatch).

    On the card: ``f`` runs once eagerly first (it builds and loads its
    kernels: nothing may build while a graph is captured); then the eager
    loop is timed ``outer`` times between CUDA events; then the ``iters``
    applications are captured in one ``torch.cuda.CUDAGraph`` on a static
    copy of ``x`` and the graph is replayed ``outer`` times between the same
    events. Each time is the least over ``outer``, divided by ``iters``. A
    stage that cannot be captured (a host sync such as ``.item()`` or
    ``.cpu()``, a data-dependent shape) raises ``RuntimeError`` naming
    ``name``; nothing falls back to the eager time. On the CPU the plain loop
    runs under the host clock.
    """
    with torch.no_grad():
        if x.device.type != "cuda":
            best, carry = float("inf"), x
            for _ in range(outer):
                t = time.perf_counter()
                carry = _loop(f, mix, x, iters)
                best = min(best, (time.perf_counter() - t) * 1e3 / iters)
            return Carried(best, None, carry, carry)
        return _timed_carry_cuda(f, x, iters, mix, outer, name)


def _timed_carry_cuda(f, x, iters, mix, outer, name) -> Carried:
    def events_ms(run) -> float:
        best = float("inf")
        for _ in range(outer):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / iters)
        return best

    mix(f(x), x)  # builds and loads the kernels, sizes cuBLAS's workspace
    torch.cuda.synchronize()
    eager = []
    eager_ms = events_ms(lambda: eager.append(_loop(f, mix, x, iters)))
    eager_carry = eager[-1]
    del eager[:-1]

    static_x = x.clone()
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    before_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    t = time.perf_counter()
    try:
        with torch.cuda.graph(graph):
            carry = _loop(f, mix, static_x, iters)
    except Exception as e:  # the capture's own CUDA error names no stage
        raise RuntimeError(f"timed_carry: stage {name!r} cannot be captured in a CUDA graph "
                           f"({type(e).__name__}: {e})") from e
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    captured = launch_counts()
    graph_bytes = torch.cuda.max_memory_allocated() - before_bytes
    graph.replay()  # the first replay uploads the graph
    torch.cuda.synchronize()
    ms = events_ms(graph.replay)
    carry = carry.clone()  # out of the graph's private pool
    return Carried(ms, eager_ms, carry, eager_carry, launch_delta(before, captured),
                   launch_delta(captured, launch_counts()), capture_s, graph_bytes)
