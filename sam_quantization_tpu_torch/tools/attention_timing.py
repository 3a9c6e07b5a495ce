"""Device times of the bfloat16 serving attention kernels at ViT-H.

    python -m sam_quantization_tpu_torch.tools.attention_timing [--iters 50]

Times ``flash_windowed`` (25 windows of 14 x 14, 16 heads, hd 80) and
``flash_global`` (a 64 x 64 grid, 16 heads, hd 80) at one image's shapes,
bf16 out and int8 out, on random inputs made from ``--seed``, and prints one
JSON line with the card's name, its power limit and the ms per call
(:func:`sam_quantization_tpu_torch.tools.timing.timed_ms`). Run it from two
checkouts in one session to compare two versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from sam_quantization_tpu_torch.ops import flash_attention as fa
from sam_quantization_tpu_torch.tools.timing import timed_ms


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    nh, hd, ws, g, nw = 16, 80, 14, 64, 25
    C, Lw, Lg, scale = nh * hd, ws * ws, g * g, hd**-0.5
    qkv, rel = randn(nw, Lw, 3 * C), randn(nw, nh, Lw, 2 * ws)
    q, k, v = (randn(1, nh, Lg, hd) for _ in range(3))
    rh, rw = randn(1, nh, Lg, g), randn(1, nh, Lg, g)
    win = dict(nh=nh, hd=hd, kh=ws, kw=ws)
    ois = 127.0 / 4.0
    cases = {
        "flash_windowed": lambda: fa.flash_attention_qkv_packed(qkv, rel, scale, **win),
        "flash_windowed_int8": lambda: fa.flash_attention_qkv_packed(
            qkv, rel, scale, out_inv_scale=ois, **win),
        "flash_global": lambda: fa.flash_attention_relpos(q, k, v, rh, rw, scale),
        "flash_global_int8": lambda: fa.flash_attention_relpos(
            q, k, v, rh, rw, scale, out_inv_scale=ois),
    }
    line = {"gpu": card_line()}
    for name, fn in cases.items():
        line[f"{name}_ms"] = timed_ms(fn, args.iters, dev, args.repeats)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
