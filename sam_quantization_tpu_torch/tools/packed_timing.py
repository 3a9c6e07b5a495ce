"""Device times of the packed-weight kernels at ViT-H's shapes, and of a W4
ViT-H ``set_image``.

    python -m sam_quantization_tpu_torch.tools.packed_timing [--dtype float32]
        [--iters 20] [--set-image]

Times ``quant_matmul`` at qkv and proj (25 windows x 196 tokens),
``quant_matmul3`` at qkv and ``fused_mlp`` at the MLP (4096 global tokens),
RTN weights with groups of 128 (4-bit; 3-bit for ``quant_matmul3``), on
random inputs made from ``--seed`` in ``--dtype``, each beside its library
yardstick (``torch.matmul`` on the dequantized weight; dense lin1 -> tanh
GELU -> lin2), the shapes and yardsticks of ``chip_smoke.py``'s kernel
phase. With ``--set-image`` it also builds ViT-H from seeded weights,
RTN-quantizes its encoder to W4 g128, casts the encoder to ``--dtype`` and
times ``SamPredictor.set_image`` on a 1200x1600 uint8 image: the median of 3
after a warm-up, host clock, synchronized. Prints one JSON line with the
card's name, its power limit and the ms per call
(:func:`sam_quantization_tpu_torch.tools.timing.timed_ms`). Run it from two
checkouts on one card, in turns, to compare two versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from sam_quantization_tpu_torch.nn import packed as packed_lib
from sam_quantization_tpu_torch.ops import _build
from sam_quantization_tpu_torch.ops import fused_mlp as fm
from sam_quantization_tpu_torch.ops import quant_matmul as qm
from sam_quantization_tpu_torch.tools.attention_timing import card_line
from sam_quantization_tpu_torch.tools.timing import timed_ms

C, MW, MG = 1280, 25 * 196, 4096  # ViT-H width, windowed and global tokens


def set_image_ms(dtype: torch.dtype, seed: int) -> list:
    """Three timed ``set_image`` calls of a W4 g128 ViT-H after a warm-up."""
    from sam_quantization_tpu_torch.models import build_sam
    from sam_quantization_tpu_torch.predictor import SamPredictor
    from sam_quantization_tpu_torch.quant import sequential as seq

    model = build_sam.sam_model_registry["vit_h"](device="cuda", seed=seed)
    seq.rtn_quantize_encoder(model.image_encoder, seq.GPTQConfig(bits=4, groupsize=128))
    model.image_encoder.to(dtype)
    image = np.random.default_rng(seed).integers(0, 256, (1200, 1600, 3), dtype=np.uint8)
    predictor = SamPredictor(model)
    ms = []
    with torch.no_grad():
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            predictor.set_image(image)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
    return sorted(ms[1:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set-image", action="store_true")
    args = ap.parse_args(argv)
    dev, dtype = torch.device("cuda"), getattr(torch, args.dtype)
    torch.backends.cuda.matmul.allow_tf32 = False  # the yardsticks in full float32
    _build.build(("quant_matmul", "fused_mlp", "flash_windowed", "flash_global"))
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    def rtn(K, N, bits, bias=True):
        return packed_lib.quantize_rtn(randn(K, N, std=K**-0.5), bits, 128,
                                       bias=randn(N, std=0.02) if bias else None)

    def ms(fn):
        return timed_ms(fn, args.iters, dev, args.repeats)

    line = {"gpu": card_line(), "dtype": args.dtype}
    for name, shape, p in (("quant_matmul", "qkv", rtn(C, 3 * C, 4)),
                           ("quant_matmul", "proj", rtn(C, C, 4)),
                           ("quant_matmul3", "qkv", rtn(C, 3 * C, 3))):
        x, wd = randn(MW, C).to(dtype), packed_lib.dequantize(p).to(dtype)
        line[f"{name} {shape}_ms"] = ms(lambda: qm.quant_matmul(x, p))
        line[f"torch.matmul {name} {shape}_ms"] = ms(lambda: torch.matmul(x, wd))
    lin1, lin2 = rtn(C, 4 * C, 4), rtn(4 * C, C, 4, bias=False)
    x = randn(MG, C).to(dtype)
    w1d, w2d = packed_lib.dequantize(lin1).to(dtype), packed_lib.dequantize(lin2).to(dtype)
    b1d = lin1.bias.to(dtype)
    line["fused_mlp mlp_ms"] = ms(lambda: fm.fused_mlp(x, lin1, lin2))
    line["dense mlp_ms"] = ms(
        lambda: torch.matmul(F.gelu(torch.addmm(b1d, x, w1d), approximate="tanh"), w2d))
    if args.set_image:
        got = set_image_ms(dtype, args.seed)
        line["W4 set_image_ms"] = got[1]
        line["W4 set_image_min_max_ms"] = [got[0], got[-1]]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
