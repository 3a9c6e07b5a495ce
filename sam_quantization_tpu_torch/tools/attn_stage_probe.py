"""Time each part of a windowed attention stage in the cached-int8 serving mode.

Counterpart of the JAX package's ``tools/attn_stage_probe.py``, case for
case, on one windowed block of the model in bfloat16, quantized as JAX
quantizes it (RTN symmetric 4-bit, groups of 128, then ``cache_int8`` with
static activation scales of 8.0 on all four linears and no dense routing):

* the qkv ``IntLinear`` at M = NW * L (windows) and M = G * G (flat), and
  a bf16 dense qkv at the windowed M; every output column folded back into
  the carry (``consume``), so none can be dropped;
* proj, static and int8-pre (its input quantized outside);
* lin1 at both Ms;
* the rel-pos tile einsums alone;
* the window partition round trip on the (1, G, G, C) grid;
* the whole attention stage through ``Attention.forward``'s kernel branch:
  qkv, the rel tiles, ``flash_windowed`` with its int8-out epilogue, proj
  int8-pre.

Each case runs ``iters`` carried applications (``tools/timing.timed_carry``,
carry mix ``0.9 f(x) + 0.1 x`` in bfloat16; on the card one CUDA graph
replay, beside the same loop launched eagerly) and is printed less the
floor of ``x * 1.01`` on the windowed tokens, as JAX prints it (the flat
cases too); the round trip less its own floor. JAX reshapes the flat cases'
input to (64, 64, C), so it runs only where G = 64; here it is (G, G, C).

Run: python -m sam_quantization_tpu_torch.tools.attn_stage_probe [--model vit_h] [--iters 256]
"""

from __future__ import annotations

import argparse
import sys
import types

import torch

from sam_quantization_tpu_torch.cli import add_platform_arg, device_of
from sam_quantization_tpu_torch.models import image_encoder as ie
from sam_quantization_tpu_torch.models.configs import CONFIGS
from sam_quantization_tpu_torch.models.sam import resolve_device
from sam_quantization_tpu_torch.nn.packed import cache_int8
from sam_quantization_tpu_torch.quant import sequential
from sam_quantization_tpu_torch.tools.timing import (blend_mix, device_name, eager_columns,
                                                     timed_carry)

ACT_SCALES = {"attn.qkv": 8.0, "attn.proj": 8.0, "mlp.lin1": 8.0, "mlp.lin2": 8.0}


def dense_block(ecfg, gen: torch.Generator, device) -> ie.Block:
    """The model's first block (windowed), seeded, in bfloat16."""
    return ie.Block(ecfg, 0, gen=gen, device=device).to(torch.bfloat16).eval()


def rtn_w4(block: ie.Block) -> ie.Block:
    """The block's four linears RTN symmetric 4-bit, groups of 128, in place."""
    sequential.rtn_quantize_encoder(types.SimpleNamespace(blocks=[block]),
                                    sequential.GPTQConfig(bits=4, groupsize=128, sym=True))
    return block


def serving_block(block: ie.Block) -> ie.Block:
    """:func:`rtn_w4`, then cached int8 with static scales on all four
    linears and proj kept int8 (``skip=()``), in place."""
    return cache_int8(rtn_w4(block), act_scales=ACT_SCALES, skip=())


def consume(y: torch.Tensor, C: int) -> torch.Tensor:
    """Fold every C-wide output slice back into the carry's shape, so every
    output column of a product is computed."""
    acc = y[:, :C]
    for i in range(1, y.shape[1] // C):
        acc = acc + y[:, i * C:(i + 1) * C]
    return acc


def cases(block: ie.Block, ecfg, wqkv: torch.Tensor, xw: torch.Tensor, x_grid: torch.Tensor):
    """[(label, f, x)] of the windowed-token cases in JAX's order, the
    partition round trip last but one. ``block``: the serving block;
    ``wqkv`` (C, 3C) the dense qkv weight; ``xw`` (NW, ws, ws, C) tokens;
    ``x_grid`` (1, G, G, C)."""
    C, ws, G = ecfg.embed_dim, ecfg.window_size, ecfg.grid_size
    nh, hd = ecfg.num_heads, ecfg.head_dim
    NW = xw.shape[0]
    Mw, Mf = NW * ws * ws, G * G
    qkv_p, proj_p, mlp1 = block.attn.qkv, block.attn.proj, block.mlp.lin1
    xflat = xw.reshape(Mw, C)[:Mf].reshape(G, G, C)
    Rh = ie.get_rel_pos(ws, ws, block.attn.rel_pos_h).to(torch.bfloat16)
    Rw = ie.get_rel_pos(ws, ws, block.attn.rel_pos_w).to(torch.bfloat16)

    def windows(y):
        return y.reshape(NW, ws, ws, C)

    def proj_pre(x):
        xi = torch.clamp(torch.round(x.float() * 16.0), -127, 127).to(torch.int8)
        return windows(proj_p(xi.reshape(Mw, C))).to(torch.bfloat16)

    def rel_only(x):
        qg = x.reshape(NW, ws, ws, nh, hd)
        rel_h = torch.einsum("bhwnc,hkc->bnhwk", qg, Rh)
        rel_w = torch.einsum("bhwnc,wkc->bnhwk", qg, Rw)
        rel = torch.cat([rel_h, rel_w], -1)
        return x + rel.mean().to(x.dtype)

    def part_roundtrip(x):
        yw, pad_hw = ie.window_partition(x, ws)
        return ie.window_unpartition(yw, ws, pad_hw, (G, G))

    return [
        (f"qkv int8-static M={Mw}", lambda x: windows(consume(qkv_p(x.reshape(Mw, C)), C)), xw),
        (f"qkv int8-static M={Mf}",
         lambda x: consume(qkv_p(x.reshape(-1, C)), C).reshape(x.shape), xflat),
        (f"qkv bf16 dense M={Mw}",
         lambda x: windows(consume(torch.matmul(x.reshape(Mw, C), wqkv), C)), xw),
        (f"proj int8-static M={Mw}", lambda x: windows(proj_p(x.reshape(Mw, C))), xw),
        (f"proj int8-PRE M={Mw} (+quant outside)", proj_pre, xw),
        (f"lin1 int8-static M={Mf}",
         lambda x: consume(mlp1(x.reshape(-1, C)), C).reshape(x.shape), xflat),
        (f"lin1 int8-static M={Mw}", lambda x: windows(consume(mlp1(x.reshape(Mw, C)), C)), xw),
        ("rel einsums (on x as q)", rel_only, xw),
        ("partition round trip bf16", part_roundtrip, x_grid),
        ("FULL attn (qkv+rel+flash+proj)",
         lambda x: block.attn(x, windowed=True, attn_impl="kernel"), xw),
    ]


def main(argv=None) -> int:
    measure(argv)
    return 0


def measure(argv=None):
    """Run the probe; returns [(label, Carried, its floor's Carried)]."""
    ap = argparse.ArgumentParser("attn_stage_probe")
    ap.add_argument("--model", default="vit_h", choices=sorted(CONFIGS))
    ap.add_argument("--iters", type=int, default=256)
    add_platform_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(device_of(args))

    ecfg = CONFIGS[args.model].image_encoder
    C, ws, G = ecfg.embed_dim, ecfg.window_size, ecfg.grid_size
    NW = ((G + ws - 1) // ws) ** 2
    L = ws * ws
    gen = torch.Generator(device=device).manual_seed(0)

    def mk(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    block = serving_block(dense_block(ecfg, gen, device))
    xw = mk(NW, ws, ws, C)
    wqkv = mk(C, 3 * C) * 0.02
    x_grid = mk(1, G, G, C)

    def floor_of(x):
        return timed_carry(lambda z: z * 1.0078125, x, args.iters, blend_mix, name="scan floor")

    t0 = floor_of(xw)
    print(f"[{args.model} attn-stage probe] NW={NW} L={L} C={C} on {device_name(device)}")
    print(f"  scan floor               {t0.ms:7.3f} ms" + eager_columns(t0), flush=True)
    rows = []
    for name, f, x in cases(block, ecfg, wqkv, xw, x_grid):
        floor = floor_of(x) if name.startswith("partition") else t0
        t = timed_carry(f, x, args.iters, blend_mix, name=name)
        print(f"  {name:28s} {t.ms - floor.ms:7.3f} ms" + eager_columns(t, floor), flush=True)
        rows.append((name, t, floor))
    return rows


if __name__ == "__main__":
    sys.exit(main())
