"""Time each part of a global attention block in the cached-int8 serving mode.

Counterpart of the JAX package's ``tools/global_stage_probe.py``, case for
case, on one global block of the model (RTN symmetric 4-bit, groups of 128,
``cache_int8`` with static activation scales of 8.0 on all four linears and
no dense routing), in bfloat16:

* the qkv head-split and head-merge transposes, and the rel-pos tiles;
* the bias3d global kernel with a bf16 and with an int8 output; the same
  problem on the head-split kernel with its rel tiles (``bias3d=False``,
  JAX's augmented kernel); the head-split kernel without a bias (the floor);
* the pair kernel (``ops.probes.probe_pair``) with the row-max and with the
  clamp-40 softmax, on heads prescaled by hd**-0.5 * log2(e) and padded to
  128 lanes;
* the production kernels on the same padded operands: the head-split kernel
  without a bias and the bias3d kernel;
* the pair kernel with the bias (``probe_pair_bias``), both softmaxes;
* proj (``IntLinear``, static scale) at M = L, and the whole global
  attention stage of the block (qkv, rel tiles, the bias3d kernel's int8
  epilogue, the int8-pre proj).

JAX sweeps ``block_q``, ``halves`` and a ``cost_estimate`` for the TPU's
scheduler; rows differ only in those, which change no number, so each
(clamp, bias) case is one row here. Timing is ``tools/packed_probe.py``'s:
``iters`` calls back to back after a warm-up, CUDA events, the least of
three repeats; each case's time is printed less the floor of one
elementwise pass over its input, beside its raw time.

Run: python -m sam_quantization_tpu_torch.tools.global_stage_probe [--model vit_h] [--iters 64]
"""

from __future__ import annotations

import argparse
import sys
import types

import torch
import torch.nn.functional as TF

from sam_quantization_tpu_torch.cli import add_platform_arg, device_of
from sam_quantization_tpu_torch.models import image_encoder as ie
from sam_quantization_tpu_torch.models.configs import CONFIGS
from sam_quantization_tpu_torch.models.sam import resolve_device
from sam_quantization_tpu_torch.nn.packed import cache_int8
from sam_quantization_tpu_torch.ops import flash_attention as fa
from sam_quantization_tpu_torch.ops import probes
from sam_quantization_tpu_torch.quant import sequential
from sam_quantization_tpu_torch.tools.timing import device_name, timed_ms

HEAD_PAD = 128


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("global_stage_probe")
    ap.add_argument("--model", default="vit_h", choices=sorted(CONFIGS))
    ap.add_argument("--iters", type=int, default=64)
    add_platform_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(device_of(args))

    ecfg = CONFIGS[args.model].image_encoder
    C, G, nh, hd = ecfg.embed_dim, ecfg.grid_size, ecfg.num_heads, ecfg.head_dim
    B, L, BH = 1, G * G, nh
    scale = hd**-0.5
    gen = torch.Generator(device=device).manual_seed(0)

    def mk(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    # One global block (its rel tables are (2G - 1, hd)), bf16, then RTN and
    # cached int8 as in the JAX probe.
    block = ie.Block(ecfg, ecfg.global_attn_indexes[0], gen=gen, device=device)
    block.to(torch.bfloat16)
    with torch.no_grad():
        block.attn.rel_pos_h.copy_(mk(2 * G - 1, hd) * 0.05)
        block.attn.rel_pos_w.copy_(mk(2 * G - 1, hd) * 0.05)
    sequential.rtn_quantize_encoder(types.SimpleNamespace(blocks=[block]),
                                    sequential.GPTQConfig(bits=4, groupsize=128, sym=True))
    cache_int8(block, act_scales={"attn.qkv": 8.0, "attn.proj": 8.0, "mlp.lin1": 8.0,
                                  "mlp.lin2": 8.0}, skip=())

    xg = mk(B, G, G, C)
    qkv_out = mk(B, L, 3 * C)
    q = mk(B, nh, L, hd)
    rh, rw = mk(B, nh, L, G) * 0.05, mk(B, nh, L, G) * 0.05
    print(f"[{args.model} global-stage probe] B={B} L={L} nh={nh} hd={hd} "
          f"on {device_name(device)}", flush=True)

    floors = {}

    def floor(x):
        key = tuple(x.shape)
        if key not in floors:
            floors[key] = timed_ms(lambda: x * 1.01, args.iters, device)
        return floors[key]

    def case(name, f, x):
        t = timed_ms(lambda: f(x), args.iters, device)
        print(f"  {name:32s} {t - floor(x):8.4f} ms  (raw {t:.4f})", flush=True)

    def pad(t):  # (..., hd) -> (BH, L, HEAD_PAD), zeros after hd
        return TF.pad(t.reshape(BH, L, hd), (0, HEAD_PAD - hd)).contiguous()

    def prepadded(x):
        """q prescaled by hd**-0.5 * log2(e), k = v = q, all padded to 128."""
        return pad(x * (scale * fa.LOG2E)), pad(q), pad(q)

    def unpad(o):
        return o[..., :hd].reshape(B, nh, L, hd)

    def headsplit(x):
        q5 = x.reshape(B, L, 3, nh, hd).permute(2, 0, 3, 1, 4)
        merged = (q5[0].transpose(1, 2).reshape(B, L, C) + q5[1].transpose(1, 2).reshape(B, L, C))
        return torch.cat([x[:, :, :C] + merged * 1e-3, x[:, :, C:]], -1)

    def rel_tiles(x):
        q2 = x.reshape(B, L, 3, nh, hd).permute(2, 0, 3, 1, 4)[0].reshape(B * nh, L, hd)
        rel_h, rel_w = ie.decomposed_rel_pos_tiles(
            q2, block.attn.rel_pos_h, block.attn.rel_pos_w, (G, G), (G, G))
        r = rel_h.sum(-1) + rel_w.sum(-1)
        return x + r.reshape(B, nh, L).mean(1)[:, :, None] * 1e-3

    def attend(x, rel=(rh, rw), **kw):
        return fa.flash_attention_relpos(x, q, q, *rel, scale, **kw)

    def pair(clamp):
        return lambda x: unpad(probes.probe_pair(*prepadded(x), clamp=clamp))

    def pair_bias(clamp):
        bias = rh.reshape(BH, L, G).contiguous(), rw.reshape(BH, L, G).contiguous()
        return lambda x: unpad(probes.probe_pair_bias(*prepadded(x), *bias, clamp=clamp))

    def production_prepadded(x, rel=(None, None)):
        # q is prescaled already: the kernel's own scale * log2(e) is 1.
        qp, kp, vp = (t.reshape(B, nh, L, HEAD_PAD) for t in prepadded(x))
        return unpad(fa.flash_attention_relpos(qp, kp, vp, *rel, 1 / fa.LOG2E))

    def proj_flat(x):
        return block.attn.proj(x.reshape(L, C)).reshape(B, G, G, C)

    print("  (JAX's block_q / halves / cost_estimate variants are one row per case: "
          "they schedule TPU work and change no number)", flush=True)
    with torch.inference_mode():
        print(f"  {'scan floor (x)':32s} {floor(xg):8.4f} ms")
        print(f"  {'scan floor (qkv)':32s} {floor(qkv_out):8.4f} ms", flush=True)
        case("head split+merge transposes", headsplit, qkv_out)
        case("headsplit + rel tiles", rel_tiles, qkv_out)
        case("bias3d kernel (bf16 out)", attend, q)
        case("bias3d kernel (int8 out)",
             lambda x: attend(x, out_inv_scale=16.0).to(torch.bfloat16) * (1 / 16), q)
        case("augmented kernel (bias3d=False)", lambda x: attend(x, bias3d=False), q)
        case("no-rel kernel (floor)", lambda x: attend(x, rel=(None, None)), q)
        for clamp in (False, True):
            case(f"pair clamp={int(clamp)}", pair(clamp), q)
        case("prod head-split prepad", production_prepadded, q)
        case("bias3d kernel PADDED inputs", lambda x: production_prepadded(x, (rh, rw)), q)
        for clamp in (False, True):
            case(f"pair+bias clamp={int(clamp)}", pair_bias(clamp), q)
        case(f"proj int8-static M={L}", proj_flat, xg)
        case("FULL global attn stage",
             lambda x: block.attn(x, windowed=False, attn_impl="kernel"), xg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
