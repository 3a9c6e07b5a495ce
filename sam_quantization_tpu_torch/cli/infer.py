"""Quantized-inference CLI: load a packed encoder artifact, time the encoder.

Counterpart of ``sam_quantization_tpu/cli/infer.py`` (the ``--load``,
``--serve-int8`` and ``--benchmark`` parts). Serve an artifact written by
the JAX package's ``cli/quantize``::

    python -m sam_quantization_tpu_torch.cli.infer vit_h --load DIR --benchmark

An artifact whose layers store ``act_bits: 8`` (written from
``with_act_bits(params, 8)``) serves through the W-A8 kernels; weight-only
ones through the dequant-matmul kernels. ``--serve-int8`` serves a
symmetric ``gptq``/``rtn`` artifact in the cached-int8 mode: its layers
become ``IntLinear`` (``cache_int8`` with ``default_serve_skip``), with the
static activation scales of its ``quant_config.json`` (``cli/quantize
--sym --act-scales``) where it has them. The encoder is timed in bfloat16
on a zero image, like the JAX CLI's
benchmark, with ``torch.cuda.synchronize()`` around the timed loop; the
result is one JSON line with ``encoder_s_per_image`` and
``encoder_images_per_s``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser("samq-infer")
    p.add_argument("model", choices=["vit_b", "vit_l", "vit_h", "vit_tiny"])
    p.add_argument("--checkpoint", default=None, help="FP .pth checkpoint")
    p.add_argument("--load", default=None, help="quantized artifact dir")
    p.add_argument(
        "--serve-int8", action="store_true",
        help="serve a symmetric gptq/rtn artifact from cached int8 weights with the "
        "artifact's static activation scales and the per-op dense routing",
    )
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--bench-iters", type=int, default=100)
    p.add_argument("--bench-warmup", type=int, default=25)
    p.add_argument("--seed", type=int, default=42,
                   help="seed of the random weights when no --checkpoint is given")
    from sam_quantization_tpu_torch.cli import add_platform_arg, device_of

    add_platform_arg(p)
    args = p.parse_args(argv)

    import torch

    from sam_quantization_tpu_torch.models import build_sam
    from sam_quantization_tpu_torch.models import sam as sam_lib
    from sam_quantization_tpu_torch.quant import artifacts

    device = device_of(args)
    model = build_sam.sam_model_registry[args.model](
        checkpoint=args.checkpoint, device=device, seed=args.seed
    )
    if args.load:
        enc, qcfg = artifacts.load_quantized(args.load)
        build_sam.load_jax_encoder(model, enc)
        print(f"loaded quantized encoder: {qcfg.get('method')}", file=sys.stderr)
        if args.serve_int8:
            if qcfg.get("method") not in ("gptq", "rtn") or not qcfg.get("sym"):
                print("--serve-int8 needs a symmetric gptq/rtn artifact "
                      "(quantize with --sym); ignoring", file=sys.stderr)
            else:
                from sam_quantization_tpu_torch.nn.packed import cache_int8, default_serve_skip

                scales = qcfg.get("act_scales")
                cache_int8(model.image_encoder, act_scales=scales,
                           skip=default_serve_skip(model.config.image_encoder.embed_dim))
                print("serving mode: cached int8 weights"
                      + (", static act scales" if scales else
                         ", dynamic act scales (artifact has none — quantize with --act-scales)"),
                      file=sys.stderr)

    out = {}
    if args.benchmark:
        size = model.config.image_encoder.img_size
        model.image_encoder.to(torch.bfloat16)  # packed scales stay float32
        x = torch.zeros((1, size, size, 3), dtype=torch.bfloat16, device=device)
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        with torch.inference_mode():
            for _ in range(args.bench_warmup):
                sam_lib.encode_image(model, x)
            sync()
            t0 = time.perf_counter()
            for _ in range(args.bench_iters):
                sam_lib.encode_image(model, x)
            sync()
        dt = (time.perf_counter() - t0) / args.bench_iters
        out["encoder_s_per_image"] = round(dt, 5)
        out["encoder_images_per_s"] = round(1.0 / dt, 3)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
