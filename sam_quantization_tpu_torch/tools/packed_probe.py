"""Decompose the windowed attention kernel's time at serving shapes.

Counterpart of the JAX package's ``tools/packed_probe.py``. It times the
windowed kernel (``flash_attention_qkv_packed``) next to stripped variants,
at the encoder's shape:

  full (int8-out)   the serving kernel: rel bias, softmax, int8 epilogue
  no-quant          the same with a bf16 output (the epilogue's cost)
  no-rel            zero rel tiles (the bias's cost)
  no-softmax        the dots only, heads read from the packed layout
                    (``ops.probes.probe_no_softmax``)
  dots-floor        two products on pre-split heads padded to (Lp, 128)
                    (``probe_dots_floor``)
  softmax           row-max softmax on the same pre-split heads
                    (``probe_presplit``)

Each case runs ``iters`` calls back to back after a warm-up, timed with CUDA
events on the card (the host clock with ``--platform cpu``), the least of
three repeats. Each case ends by putting its result back into the shape of
the input, as the JAX probe's carried scan does; "scan floor" is one
elementwise pass over that input (``x * 1.01``), and each case prints its
time less that floor beside its raw time.

Run: python -m sam_quantization_tpu_torch.tools.packed_probe [--model vit_h] [--iters 64]
"""

from __future__ import annotations

import argparse
import sys

import torch

from sam_quantization_tpu_torch.cli import add_platform_arg, device_of
from sam_quantization_tpu_torch.models.configs import CONFIGS
from sam_quantization_tpu_torch.models.sam import resolve_device
from sam_quantization_tpu_torch.ops import flash_attention as fa
from sam_quantization_tpu_torch.ops import probes
from sam_quantization_tpu_torch.tools.timing import device_name, timed_ms

HEAD_PAD = 128  # the pre-split heads' padded width, as in the JAX probe


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("packed_probe")
    ap.add_argument("--model", default="vit_h", choices=sorted(CONFIGS))
    ap.add_argument("--iters", type=int, default=64)
    add_platform_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(device_of(args))

    ecfg = CONFIGS[args.model].image_encoder
    nh, hd, ws, G = ecfg.num_heads, ecfg.head_dim, ecfg.window_size, ecfg.grid_size
    NW = ((G + ws - 1) // ws) ** 2
    L = ws * ws
    Lp = -(-L // 128) * 128
    CH = nh * hd
    scale = hd**-0.5
    gen = torch.Generator(device=device).manual_seed(0)

    def mk(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    qkv = mk(NW, L, 3 * CH)
    rel = mk(NW, nh, L, 2 * ws) * 0.05
    kw = dict(nh=nh, hd=hd, kh=ws, kw=ws)
    print(f"[packed probe] {args.model}: NW={NW} L={L} Lp={Lp} nh={nh} hd={hd} "
          f"on {device_name(device)}", flush=True)

    def time_of(f):
        return timed_ms(lambda: f(qkv), args.iters, device)

    t0 = time_of(lambda x: x * 1.01)
    print(f"  {'scan floor':24s} {t0:8.4f} ms", flush=True)

    def show(name, f):
        t = time_of(f)
        print(f"  {name:24s} {t - t0:8.4f} ms  (raw {t:.4f})", flush=True)

    def full(x):
        o = fa.flash_attention_qkv_packed(x, rel, scale, out_inv_scale=8.0, **kw)
        return torch.cat([o.to(torch.bfloat16) * (1 / 127), x[:, :, CH:]], -1)

    def noquant(x):
        return torch.cat([fa.flash_attention_qkv_packed(x, rel, scale, **kw), x[:, :, CH:]], -1)

    def norel(x):
        return torch.cat([fa.flash_attention_qkv_packed(x, None, scale, **kw), x[:, :, CH:]], -1)

    def no_softmax(x):
        q, k, v = x[:, :, :CH], x[:, :, CH:2 * CH], x[:, :, 2 * CH:]
        return torch.cat([probes.probe_no_softmax(q, k, v, rel, scale, nh=nh, hd=hd),
                          x[:, :, CH:]], -1)

    def presplit(x):
        def split(a):  # (NW, L, CH) -> (NW, nh, Lp, HEAD_PAD), zero-padded
            a = a.reshape(NW, L, nh, hd).transpose(1, 2)
            return torch.nn.functional.pad(a, (0, HEAD_PAD - hd, 0, Lp - L)).contiguous()

        return split(x[:, :, :CH]), split(x[:, :, CH:2 * CH]), split(x[:, :, 2 * CH:])

    def merge(o, x):
        return torch.cat([o[:, :, :L, :hd].transpose(1, 2).reshape(NW, L, CH), x[:, :, CH:]], -1)

    def dots_floor(x):
        return merge(probes.probe_dots_floor(*presplit(x)), x)

    def softmax_presplit(x):
        return merge(probes.probe_presplit(*presplit(x), exp2=True), x)

    with torch.inference_mode():
        for name, f in (("full (int8-out)", full), ("no-quant", noquant), ("no-rel", norel),
                        ("no-softmax (packed in)", no_softmax),
                        ("dots-floor (presplit)", dots_floor),
                        ("softmax (presplit)", softmax_presplit)):
            show(name, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
