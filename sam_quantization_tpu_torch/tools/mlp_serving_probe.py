"""Serving-MLP headroom probe: where the cached-int8 MLP's time goes.

Counterpart of the JAX package's ``tools/mlp_serving_probe.py``, at its
shapes (M tokens of width C through a hidden width H) and with its weights:
int8 grids of normal(0, 0.02) weights at one max-abs scale, column scales
1e-3, zero biases, an identity LayerNorm, static activation scales 0.05.
Three chains are timed, each as ``iters`` carried applications
(``tools/timing.timed_carry``, carry mix ``0.9 f(x) + 0.1 x`` in bfloat16;
on the card one CUDA graph replay, beside the same loop launched eagerly):

* ``dots``: the two int8 products alone (``ops/quant_matmul._int_mm``, the
  cuBLASLt route of ``IntLinear``) on x * 64 saturated to int8, the first
  product's int32 requantized by ``>> 7``: the floor any fusion must beat;
* ``chain``: the serving MLP as the cached-int8 block runs it: LayerNorm
  (``nn/functional.layer_norm``), static quantize, int8 product, column
  scale and bias, the bfloat16 tanh GELU (``nn/functional.gelu``), static
  quantize, int8 product, column scale and bias;
* ``bf16``: the dense chain: LayerNorm in float32, bfloat16 products, erf
  GELU in float32 on bfloat16-rounded inputs.

``chain - dots`` is what a fused kernel could recover. The products count
2 * 2 * M * C * H operations.

Run: python -m sam_quantization_tpu_torch.tools.mlp_serving_probe \
         [--dim 1280] [--hidden 5120] [--m 4096] [--iters 64]
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as TF

from sam_quantization_tpu_torch.cli import add_platform_arg, device_of
from sam_quantization_tpu_torch.models.sam import resolve_device
from sam_quantization_tpu_torch.nn import functional as F
from sam_quantization_tpu_torch.ops.quant_matmul import _int_mm, quantize_static
from sam_quantization_tpu_torch.tools.timing import (blend_mix, device_name, eager_columns,
                                                     timed_carry)


def int8_grid(w: torch.Tensor) -> torch.Tensor:
    """``clip(round(w / max|w| * 127), +-127)`` as int8 (one scale)."""
    return torch.clamp(torch.round(w / w.abs().max() * 127), -127, 127).to(torch.int8)


def chains(w1: torch.Tensor, w2: torch.Tensor):
    """{name: f(x)} of the three chains for float32 weights w1 (H, C) and
    w2 (C, H) and bfloat16 x (M, C)."""
    H, C = w1.shape
    dev = w1.device
    f32 = dict(dtype=torch.float32, device=dev)
    w1_8, w2_8 = int8_grid(w1), int8_grid(w2)
    s1, s2 = torch.full((H,), 1e-3, **f32), torch.full((C,), 1e-3, **f32)
    b1, b2 = torch.zeros(H, **f32), torch.zeros(C, **f32)
    g, bln = torch.ones(C, **f32), torch.zeros(C, **f32)
    in_s1 = in_s2 = torch.tensor(0.05, **f32)
    # (K, N) column-major views of the (N, K) grids: what cuBLASLt takes
    k1, k2 = w1_8.t(), w2_8.t()

    def dots(x):
        # x * 64 saturated to int8, as JAX's float -> int8 conversion
        xq = torch.clamp(x * 64, -128, 127).to(torch.int8)
        a = _int_mm(xq, k1)
        aq = torch.clamp(a >> 7, -127, 127).to(torch.int8)  # cheap stand-in requant
        y = _int_mm(aq, k2)
        return (y.float() * 1e-6).to(torch.bfloat16)[:, :C]

    def chain(x):
        hln = F.layer_norm(x, g, bln, 1e-6)
        acc = _int_mm(quantize_static(hln, in_s1), k1).float()
        h = (acc * (s1 * in_s1)[None, :] + b1[None, :]).to(torch.bfloat16)
        h = F.gelu(h)
        acc2 = _int_mm(quantize_static(h, in_s2), k2).float()
        return (acc2 * (s2 * in_s2)[None, :] + b2[None, :]).to(torch.bfloat16)

    w1b, w2b = w1.to(torch.bfloat16).t(), w2.to(torch.bfloat16).t()

    def chain_bf16(x):
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        hln = ((xf - mu) * torch.rsqrt(var + 1e-6) * g + bln).to(torch.bfloat16)
        # bf16 products accumulate in float32 and round once to bfloat16;
        # with JAX's float32 product output the bias is added before that
        # rounding, here after it (the biases are zero)
        h = torch.matmul(hln, w1b).float() + b1[None, :]
        h = TF.gelu(h.to(torch.bfloat16).float())
        y = torch.matmul(h.to(torch.bfloat16), w2b).float() + b2[None, :]
        return y.to(torch.bfloat16)

    return {"dots": dots, "chain": chain, "bf16": chain_bf16}


def main(argv=None) -> int:
    measure(argv)
    return 0


def measure(argv=None):
    """Run the probe; returns {"dots" | "chain" | "bf16" | "floor": Carried}."""
    ap = argparse.ArgumentParser("mlp_serving_probe")
    ap.add_argument("--dim", type=int, default=1280)
    ap.add_argument("--hidden", type=int, default=5120)
    ap.add_argument("--m", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=64)
    add_platform_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(device_of(args))
    C, H, M = args.dim, args.hidden, args.m

    gen = torch.Generator(device=device).manual_seed(0)
    w1 = torch.randn((H, C), generator=gen, device=device) * 0.02  # nk layout
    w2 = torch.randn((C, H), generator=gen, device=device) * 0.02
    x = torch.randn((M, C), generator=gen, device=device).to(torch.bfloat16)
    fns = chains(w1, w2)

    t = {name: timed_carry(f, x, args.iters, blend_mix, name=name) for name, f in fns.items()}
    t_floor = timed_carry(lambda z: z, x, args.iters, blend_mix, name="carry floor")
    t_dots, t_chain, t_bf16 = t["dots"], t["chain"], t["bf16"]

    flops = 2 * 2 * M * C * H
    print(f"shapes M={M} C={C} H={H}  ({flops / 1e9:.1f} GFLOP/chain) on {device_name(device)}")
    print(f"  carry floor    : {t_floor.ms:.3f} ms (subtract for "
          f"absolute stage cost; cancels in chain-dots)" + eager_columns(t_floor))
    print(f"  int8 dots only : {t_dots.ms:.3f} ms  "
          f"({flops / t_dots.ms / 1e9:.1f} TOP/s)" + eager_columns(t_dots))
    print(f"  serving chain  : {t_chain.ms:.3f} ms  "
          f"({flops / t_chain.ms / 1e9:.1f} TOP/s)" + eager_columns(t_chain))
    print(f"  bf16 chain     : {t_bf16.ms:.3f} ms  "
          f"({flops / t_bf16.ms / 1e9:.1f} TFLOP/s)" + eager_columns(t_bf16))
    head = t_chain.ms - t_dots.ms
    print(f"  fusion headroom (chain - dots): {head:.3f} ms "
          f"({100 * head / t_chain.ms:.1f}% of chain)", flush=True)
    return {**t, "floor": t_floor}


if __name__ == "__main__":
    sys.exit(main())
