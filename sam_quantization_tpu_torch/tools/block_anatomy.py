"""Windowed-block cost anatomy: where a windowed block's time goes, stage
by stage, and how much of each stage is launch overhead.

Counterpart of the JAX package's ``tools/block_anatomy.py``, stage for
stage, on the model's first block (windowed) in bfloat16: dense
(``bf16``), with ``--int4`` RTN symmetric W4 g128 (``int4-w``: the packed
``quant_matmul`` and, where ``fused_mlp_supported`` holds, ``fused_mlp``),
with ``--a8`` that block cached as int8 with static activation scales of 8.0
on qkv, lin1 and lin2 and proj dense (``a8-static``). Every stage keeps the
(1, G, G, C) token grid's shape:

  noop                carried scale only, the floor
  ln                  LayerNorm
  partition           window partition + unpartition (data movement)
  part+qkv+mix        partition -> qkv -> a nonlinear mix of q, k, v -> unpartition
  part+attn(eager)    partition -> the eager attention -> unpartition
  part+attn(flash)    the same through the kernel branch (on the card only,
                      where JAX inserts it on a TPU)
  ln2+mlp             ln2 -> lin1 -> GELU -> lin2 (the fused kernel where
                      the block fuses)
  full block          the block on the kernel branch
  full block (eager)  the block on the eager branch

Each stage runs ``iters`` carried applications (``tools/timing.timed_carry``
with JAX's mix ``f(x) * 0.82`` in bfloat16): on the card one CUDA graph
replay, the counterpart of JAX's one dispatch, and beside it the same loop
launched op by op from Python. Both are printed less the noop floor, as JAX
prints them, with their difference: the stage's launch overhead.

Run: python -m sam_quantization_tpu_torch.tools.block_anatomy \
         [--model vit_b] [--iters 256] [--int4] [--a8]
"""

from __future__ import annotations

import argparse
import copy
import sys

import torch

from sam_quantization_tpu_torch.cli import add_platform_arg, device_of
from sam_quantization_tpu_torch.models import image_encoder as ie
from sam_quantization_tpu_torch.models.configs import CONFIGS
from sam_quantization_tpu_torch.models.sam import resolve_device
from sam_quantization_tpu_torch.nn.packed import cache_int8
from sam_quantization_tpu_torch.ops import fused_mlp
from sam_quantization_tpu_torch.tools.attn_stage_probe import dense_block, rtn_w4
from sam_quantization_tpu_torch.tools.timing import (device_name, eager_columns, scale_mix,
                                                     timed_carry)

A8_SCALES = {"attn.qkv": 8.0, "mlp.lin1": 8.0, "mlp.lin2": 8.0}


def param_sets(block: ie.Block, int4: bool, a8: bool):
    """{tag: block} in JAX's order: ``block`` (bf16), its RTN symmetric W4
    g128 copy, and that copy cached as int8 (proj dense)."""
    sets = {"bf16": block}
    qblock = rtn_w4(copy.deepcopy(block))
    if int4:
        sets["int4-w"] = qblock
    if a8:
        sets["a8-static"] = cache_int8(copy.deepcopy(qblock), act_scales=A8_SCALES)
    return sets


def stages(p: ie.Block, ecfg, on_card: bool):
    """[(name, f)] of the block's stages in JAX's order; ``part+attn(flash)``
    only ``on_card``."""
    C, ws, G = ecfg.embed_dim, ecfg.window_size, ecfg.grid_size

    def noop(x):
        return x

    def partition(x):
        yw, pad_hw = ie.window_partition(x, ws)
        return ie.window_unpartition(yw, ws, pad_hw, (G, G))

    def qkv(x):
        yw, pad_hw = ie.window_partition(x, ws)
        nw = yw.shape[0]
        y3 = p.attn.qkv(yw.reshape(nw, ws * ws, C)).reshape(nw, ws * ws, 3, C)
        # a nonlinear mix of q, k and v: none of the 3C columns can be dropped
        y = y3[:, :, 0] * torch.tanh(y3[:, :, 1]) + y3[:, :, 2]
        return ie.window_unpartition(y.reshape(nw, ws, ws, C), ws, pad_hw, (G, G))

    def attn(x, impl):
        yw, pad_hw = ie.window_partition(x, ws)
        yw = p.attn(yw, windowed=True, attn_impl=impl)
        return ie.window_unpartition(yw, ws, pad_hw, (G, G))

    def mlp(x):
        h = p.norm2(x)
        lin1, lin2 = p.mlp.lin1, p.mlp.lin2
        if fused_mlp.fused_mlp_supported(lin1, lin2):
            return fused_mlp.fused_mlp(h, lin1, lin2)
        return lin2(p.mlp.act(lin1(h)))

    out = [
        ("noop", noop),
        ("ln", p.norm1),
        ("partition", partition),
        ("part+qkv+mix", qkv),
        ("part+attn(eager)", lambda x: attn(x, "eager")),
        ("ln2+mlp", mlp),
        ("full block", lambda x: p(x, attn_impl="kernel")),
        ("full block (eager)", lambda x: p(x, attn_impl="eager")),
    ]
    if on_card:
        out.insert(5, ("part+attn(flash)", lambda x: attn(x, "kernel")))
    return out


def main(argv=None) -> int:
    measure(argv)
    return 0


def measure(argv=None):
    """Run the probe; returns {tag: [(stage, Carried)]}, the noop first."""
    ap = argparse.ArgumentParser("block_anatomy")
    ap.add_argument("--model", default="vit_b", choices=sorted(CONFIGS))
    ap.add_argument("--iters", type=int, default=256)
    ap.add_argument("--a8", action="store_true",
                    help="also time the int8-serving (IntLinear static) block")
    ap.add_argument("--int4", action="store_true",
                    help="also time the packed-int4 weight-only block")
    add_platform_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(device_of(args))

    ecfg = CONFIGS[args.model].image_encoder
    G, C = ecfg.grid_size, ecfg.embed_dim
    gen = torch.Generator(device=device).manual_seed(0)
    block = dense_block(ecfg, gen, device)
    x = torch.randn((1, G, G, C), generator=gen, device=device).to(torch.bfloat16)

    results = {}
    for tag, p in param_sets(block, args.int4, args.a8).items():
        print(f"[{args.model} windowed block, {tag}] on {device_name(device)}", flush=True)
        rows = results[tag] = []
        for name, f in stages(p, ecfg, device.type == "cuda"):
            t = timed_carry(f, x, args.iters, scale_mix, name=f"{tag} {name}")
            rows.append((name, t))
            if name == "noop":
                floor = t
                print(f"  {name:24s} {t.ms:7.3f} ms (floor)" + eager_columns(t), flush=True)
            else:
                print(f"  {name:24s} {t.ms - floor.ms:7.3f} ms" + eager_columns(t, floor),
                      flush=True)
        if device.type == "cuda":
            full = dict(rows)["full block"]
            print(f"  graph of 'full block': {args.iters} applications, launches "
                  f"{full.launches}, capture + instantiate {full.capture_s:.3f} s, "
                  f"peak {full.graph_bytes / 2**20:.1f} MiB", flush=True)
    return results


if __name__ == "__main__":
    sys.exit(main())
