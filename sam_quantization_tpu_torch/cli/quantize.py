"""Quantization CLI: GPTQ or RTN calibration and packing of the image encoder.

Counterpart of ``sam_quantization_tpu/cli/quantize.py``, with its flags
(after gptq4sam.py:500-585) and its JSON last line. It writes an artifact
that the JAX package's ``quant.artifacts.load_quantized`` and the port's
``cli.infer --load`` both serve::

    python -m sam_quantization_tpu_torch.cli.quantize vit_tiny --platform cpu \
        --wbits 4 --groupsize 32 --nsamples 2 --save /tmp/q4
    python -m sam_quantization_tpu_torch.cli.infer vit_tiny --platform cpu --load /tmp/q4

Calibration images come from an SBD directory (``--sbd-dir``, train split)
or else from seeded synthetic scenes (``--seed``). Random weights are drawn
from seed 0 unless ``--checkpoint`` gives a SAM ``.pth``. ``--bump-worst K``
ranks the block linears by layerwise SNR at the global config (RTN) and
re-quantizes the worst K at ``--bump-bits``; ``--sym --act-scales`` stores
the static activation scales that ``cli.infer --serve-int8`` reads.
Calibration runs in float32 with TF32 off. ``--method fq`` (FQ-ViT) is not
ported (ROADMAP, Queue 1, item 4).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser("samq-quantize")
    p.add_argument("model", choices=["vit_b", "vit_l", "vit_h", "vit_tiny"])
    p.add_argument("--checkpoint", default=None, help="SAM .pth checkpoint")
    p.add_argument("--save", default=None, help="output artifact directory")
    p.add_argument("--method", default="gptq", choices=["gptq", "rtn", "fq"])
    # GPTQ flags (gptq4sam.py:504-585)
    p.add_argument("--wbits", type=int, default=4, choices=[2, 3, 4, 8, 16])
    p.add_argument("--groupsize", type=int, default=128)
    p.add_argument("--sym", action="store_true")
    p.add_argument("--act-order", action="store_true")
    p.add_argument("--true-sequential", action="store_true", default=True)
    p.add_argument("--no-true-sequential", dest="true_sequential", action="store_false")
    p.add_argument("--percdamp", type=float, default=0.01)
    p.add_argument("--nsamples", type=int, default=16)
    p.add_argument("--nearest", action="store_true", help="RTN instead of GPTQ")
    # FQ flags (fq_vit/test_quant.py:24-53), kept for the JAX CLI's command lines
    p.add_argument("--ptf", action="store_true", default=True)
    p.add_argument("--no-ptf", dest="ptf", action="store_false")
    p.add_argument("--lis", action="store_true", default=True)
    p.add_argument("--no-lis", dest="lis", action="store_false")
    p.add_argument(
        "--quant-method", default="minmax",
        choices=["minmax", "ema", "omse", "percentile"],
    )
    p.add_argument("--calib-iter", type=int, default=10)
    # mixed precision (PPQ per-op overrides analog, custimized_quant.py:56-147)
    p.add_argument(
        "--overrides", default=None,
        help="JSON file of per-op override rules "
        '([{"pattern": "blocks.7.mlp.*", "bits": 8}, ...])',
    )
    p.add_argument(
        "--bump-worst", type=int, default=0, metavar="K",
        help="diagnose worst-K SNR layers (layerwise analysis at the global "
        "config) and re-quantize them at --bump-bits",
    )
    p.add_argument("--bump-bits", type=int, default=8)
    # cached-int8 serving (cli.infer --serve-int8)
    p.add_argument(
        "--act-scales", action="store_true",
        help="calibrate static per-layer activation scales and store them "
        "in the artifact, enabling `infer --serve-int8` (the cached-int8 "
        "+ static-act serving mode; requires --sym)",
    )
    p.add_argument("--act-margin", type=float, default=1.1)
    # data
    p.add_argument("--sbd-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    return p


def iter_calib_images(args, img_size: int):
    """(1, img, img, 3) float32 [0, 255] numpy images: SBD train items
    resized and padded, or seeded synthetic scenes."""
    if args.sbd_dir:
        from sam_quantization_tpu_torch.data.datasets import SBDDataset, preprocess_for_eval

        ds = SBDDataset(args.sbd_dir, split="train", max_samples=args.nsamples)
        for n, (img, gt, _i) in enumerate(ds.eval_items()):
            if n >= args.nsamples:
                return
            yield preprocess_for_eval(img, gt, img_size)[0]
    else:
        from sam_quantization_tpu_torch.data.synthetic import synthetic_samples

        for img, _gt in synthetic_samples(args.nsamples, img_size, args.seed):
            yield img


def main(argv=None):
    from sam_quantization_tpu_torch.cli import add_platform_arg, device_of

    p = build_parser()
    add_platform_arg(p)
    args = p.parse_args(argv)
    if args.method == "fq":
        raise NotImplementedError(
            "--method fq (FQ-ViT calibration) is not ported yet (ROADMAP, Queue 1, "
            "item 4, 'FQ-ViT'); use the JAX package's cli.quantize for it"
        )

    import torch

    from sam_quantization_tpu_torch.models import build_sam
    from sam_quantization_tpu_torch.models import sam as sam_lib
    from sam_quantization_tpu_torch.quant import artifacts, gptq, sequential
    from sam_quantization_tpu_torch.quant.overrides import QuantOverrides

    device = device_of(args)
    model = build_sam.sam_model_registry[args.model](
        checkpoint=args.checkpoint, device=device, seed=0)
    encoder = model.image_encoder
    img_size = model.config.image_encoder.img_size

    def calib_batches():
        return [sam_lib.preprocess(model, torch.from_numpy(img).to(device))
                for img in iter_calib_images(args, img_size)]

    overrides = None
    if args.overrides:
        with open(args.overrides) as f:
            overrides = QuantOverrides.from_json(f.read())

    t0 = time.time()
    qcfg = gptq.GPTQConfig(
        bits=args.wbits,
        groupsize=args.groupsize,
        sym=args.sym,
        actorder=args.act_order,
        percdamp=args.percdamp,
    )
    rtn = args.method == "rtn" or args.nearest
    quant_config = {
        "method": "rtn" if rtn else "gptq",
        "wbits": args.wbits,
        "groupsize": args.groupsize,
        "sym": args.sym,
        "act_order": args.act_order,
    }
    with sequential.full_float32():
        act_scales = None
        if args.act_scales:
            if not args.sym:
                print("--act-scales requires --sym (symmetric int8 grid); "
                      "skipping", file=sys.stderr)
            else:
                from sam_quantization_tpu_torch.quant.act_scales import calibrate_act_scales

                # On the dense encoder, before it is quantized in place.
                act_scales = calibrate_act_scales(encoder, calib_batches(),
                                                  margin=args.act_margin)
        if rtn:
            enc = sequential.rtn_quantize_encoder(encoder, qcfg, overrides=overrides)
            losses = {}
        else:
            batches = calib_batches()
            if args.bump_worst > 0:
                # diagnose -> act: rank ops by layerwise SNR at the global
                # config, bump the worst K
                from sam_quantization_tpu_torch.quant.analysis import layerwise_error_analyse

                probe = sequential.rtn_quantize_encoder(copy.deepcopy(encoder), qcfg)
                snrs = layerwise_error_analyse(encoder, probe, batches[:2])
                del probe
                bump = QuantOverrides.bump_worst_snr(snrs, args.bump_worst, bits=args.bump_bits)
                overrides = QuantOverrides((overrides.rules if overrides else []) + bump.rules)
                print(f"bumping worst-{args.bump_worst} SNR ops to "
                      f"{args.bump_bits}-bit: {[p for p, _ in bump.rules]}")
            enc, losses = sequential.gptq_quantize_encoder(
                encoder, batches, qcfg, true_sequential=args.true_sequential, verbose=True,
                overrides=overrides,
            )
    quant_config["overrides"] = overrides.to_json() if overrides else None
    quant_config["losses"] = {k: float(v) for k, v in losses.items()}
    if act_scales is not None:
        quant_config["act_scales"] = act_scales
    if args.save:
        artifacts.save_quantized(args.save, build_sam.to_jax_encoder(enc), quant_config)
    print(
        json.dumps(
            {
                "status": "ok",
                "method": quant_config["method"],
                "elapsed_s": round(time.time() - t0, 2),
                "save": args.save,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
