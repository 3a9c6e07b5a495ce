"""Device times of the W-A8 kernels at ViT-H's block linears.

    python -m sam_quantization_tpu_torch.tools.a8_timing [--iters 20]

Times ``quant_matmul_a8_sym`` and ``quant_matmul_a8`` (4-bit RTN weights,
groups of 128, bf16 out) on the int8 input of qkv and proj (25 windows x 196
tokens) and lin1 and lin2 (4096 global tokens), with ``torch._int_mm`` on the
same int8 input beside each as the yardstick, on random inputs made from
``--seed``, and prints one JSON line with the card's name, its power limit
and the ms per call (:func:`sam_quantization_tpu_torch.tools.timing.timed_ms`).
Run it from two checkouts on one card, in turns, to compare two versions of
the kernels.
"""

from __future__ import annotations

import argparse
import json

import torch

from sam_quantization_tpu_torch.nn import packed as packed_lib
from sam_quantization_tpu_torch.ops import quant_matmul as qm
from sam_quantization_tpu_torch.tools.attention_timing import card_line
from sam_quantization_tpu_torch.tools.timing import timed_ms

SHAPES = {"qkv": (4900, 1280, 3840), "proj": (4900, 1280, 1280), "lin1": (4096, 1280, 5120),
          "lin2": (4096, 5120, 1280)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    line = {"gpu": card_line()}
    for shape, (M, K, N) in SHAPES.items():
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        xq, xs = qm.quantize_activations_int8(x)
        for sym in (True, False):
            w = torch.randn(K, N, generator=gen, device=dev) * K**-0.5 + (0.0 if sym else K**-0.5)
            p = packed_lib.with_act_bits(packed_lib.quantize_rtn(w, 4, 128, sym), 8)
            name = "quant_matmul_a8_sym" if sym else "quant_matmul_a8"
            line[f"{name} {shape}_ms"] = timed_ms(
                lambda: qm.a8_matmul(xq, xs, p, torch.bfloat16, sym), args.iters, dev,
                args.repeats)
        w8 = (packed_lib.unpack_to_int(p) - qm.a8_offset(4, False)).to(torch.int8)
        w8 = w8.t().contiguous().t()  # column-major: cuBLAS's preferred int8 layout
        line[f"_int_mm {shape}_ms"] = timed_ms(lambda: torch._int_mm(xq, w8), args.iters, dev,
                                               args.repeats)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
