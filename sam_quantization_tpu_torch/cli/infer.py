"""Quantized-inference CLI: load a packed encoder artifact, time the encoder,
run the click-loop evaluation.

Counterpart of ``sam_quantization_tpu/cli/infer.py`` (the ``--load``,
``--serve-int8``, ``--benchmark`` and ``--eval`` parts). Serve an artifact
written by the JAX package's ``cli/quantize``::

    python -m sam_quantization_tpu_torch.cli.infer vit_h --load DIR --benchmark
    python -m sam_quantization_tpu_torch.cli.infer vit_tiny \
        --checkpoint checkpoints/vit_tiny_synth --eval --num-samples 24

An artifact whose layers store ``act_bits: 8`` (written from
``with_act_bits(params, 8)``) serves through the W-A8 kernels; weight-only
ones through the dequant-matmul kernels. ``--serve-int8`` serves a
symmetric ``gptq``/``rtn`` artifact in the cached-int8 mode: its layers
become ``IntLinear`` (``cache_int8`` with ``default_serve_skip``), with the
static activation scales of its ``quant_config.json`` (``cli/quantize
--sym --act-scales``) where it has them.

An FQ-ViT artifact (``cli/quantize --method fq``, of either package) loads
as its dense fake-quantized encoder, and its ``fq_qparams.npz`` becomes an
``FQCtx("quant", ...)`` through which ``--eval`` and ``--benchmark`` encode:
float32, TF32 off, on the eager branch (the context has observation points
no kernel has), as the JAX CLI serves it with ``attn_impl="xla"``.

``--eval`` runs the 5-click random-click loop (``click_loop_eval``) on
``--num-samples`` seeded synthetic scenes, or on the SBD val split at
``--sbd-dir``, with the encoder in the dtype of its weights (float32), and
adds ``mean_iou_per_click``, ``click@1`` and ``click@N`` to the JSON line.
``--benchmark`` then times the encoder in bfloat16 (an FQ artifact: float32)
on a zero image, like the JAX CLI's benchmark, with
``torch.cuda.synchronize()`` around the timed loop, and adds
``encoder_s_per_image`` and ``encoder_images_per_s``.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser("samq-infer")
    p.add_argument("model", choices=["vit_b", "vit_l", "vit_h", "vit_tiny"])
    p.add_argument(
        "--serve-int8", action="store_true",
        help="serve a symmetric gptq/rtn artifact from cached int8 weights with the "
        "artifact's static activation scales and the per-op dense routing",
    )
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--bench-iters", type=int, default=100)
    p.add_argument("--bench-warmup", type=int, default=25)
    p.add_argument("--eval", action="store_true", help="run the click-loop evaluation")
    p.add_argument("--num-clicks", type=int, default=5)
    p.add_argument("--num-samples", type=int, default=20)
    p.add_argument("--sbd-dir", default=None, help="SBD root; synthetic scenes without it")
    p.add_argument("--seed", type=int, default=42,
                   help="seed of the random weights when no --checkpoint is given, of the "
                   "synthetic scenes and of the clicks")
    from sam_quantization_tpu_torch.cli import (
        add_model_args, add_platform_arg, build_model, device_of,
    )

    add_model_args(p)
    add_platform_arg(p)
    args = p.parse_args(argv)

    from sam_quantization_tpu_torch.quant.sequential import full_float32

    device = device_of(args)
    model, qcfg = build_model(args, device, seed=args.seed)
    ctx = None
    if args.load:
        print(f"loaded quantized encoder: {qcfg.get('method')}", file=sys.stderr)
        if qcfg.get("method") == "fq":
            ctx = _fq_ctx(args.load, qcfg, device)
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
    with full_float32() if ctx is not None else contextlib.nullcontext():
        if args.eval:
            out.update(_click_eval(args, model, ctx))
        if args.benchmark:
            out.update(_benchmark(args, model, ctx, device))
    print(json.dumps(out))
    return 0


def _fq_ctx(directory: str, qcfg: dict, device):
    """``FQCtx("quant")`` of an FQ artifact's ``fq_qparams.npz`` (None
    without one), with the artifact's PTF / LIS / observer settings."""
    from sam_quantization_tpu_torch.quant import artifacts
    from sam_quantization_tpu_torch.quant.fq.pipeline import FQConfig, FQCtx, qparams_to

    qparams = artifacts.load_fq_qparams(directory)
    if not qparams:
        return None
    fqcfg = FQConfig(int_softmax=qcfg.get("lis", True), int_norm=qcfg.get("ptf", True),
                     observer_a=qcfg.get("quant_method", "minmax"))
    print("loaded FQ activation qparams", file=sys.stderr)
    return FQCtx("quant", fqcfg, qparams=qparams_to(qparams, device))


def _benchmark(args, model, ctx, device) -> dict:
    """Encoder seconds per zero image: bfloat16, or float32 through an FQ
    context."""
    import torch

    from sam_quantization_tpu_torch.models import sam as sam_lib
    from sam_quantization_tpu_torch.quant.context import NULL_CTX

    size = model.config.image_encoder.img_size
    dtype = torch.float32
    if ctx is None:
        dtype = torch.bfloat16
        model.image_encoder.to(dtype)  # packed scales stay float32
    ctx = ctx or NULL_CTX
    x = torch.zeros((1, size, size, 3), dtype=dtype, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    with torch.inference_mode():
        for _ in range(args.bench_warmup):
            sam_lib.encode_image(model, x, ctx=ctx)
        sync()
        t0 = time.perf_counter()
        for _ in range(args.bench_iters):
            sam_lib.encode_image(model, x, ctx=ctx)
        sync()
    dt = (time.perf_counter() - t0) / args.bench_iters
    return {"encoder_s_per_image": round(dt, 5), "encoder_images_per_s": round(1.0 / dt, 3)}


def _click_eval(args, model, ctx) -> dict:
    """The click loop on synthetic scenes or the SBD val split (images fed
    to the encoder as the JAX CLI feeds them)."""
    from sam_quantization_tpu_torch.data.datasets import SBDDataset, preprocess_for_eval
    from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
    from sam_quantization_tpu_torch.evaluation import click_eval

    size = model.config.image_encoder.img_size
    if args.sbd_dir:
        ds = SBDDataset(args.sbd_dir, split="val", max_samples=args.num_samples)
        items = itertools.islice(ds.eval_items(), args.num_samples)
        samples = (preprocess_for_eval(img, gt, size) for img, gt, _ in items)
    else:
        samples = synthetic_samples(args.num_samples, size, args.seed)
    encode, decode = click_eval.make_sam_backend(model, ctx)
    res = click_eval.click_loop_eval(encode, decode, samples, num_clicks=args.num_clicks,
                                     img_size=size, seed=args.seed)
    return {
        "mean_iou_per_click": [round(float(v), 4) for v in res.mean_ious],
        "click@1": round(float(res.click1), 4),
        f"click@{args.num_clicks}": round(float(res.final), 4),
        "s_per_image": round(res.seconds_per_image, 3),
    }


if __name__ == "__main__":
    sys.exit(main())
