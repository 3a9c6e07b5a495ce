"""Model-export CLI: ONNX, ``torch.export`` and AOTInductor artifacts.

Counterpart of ``sam_quantization_tpu/cli/export.py`` (ref
``scripts/export_onnx_model.py:97-200``, decoder -> ONNX for browsers and
ORT, and ``script/export_onnx.py:45-60``, the encoder export feeding the
PPQ/TRT pipelines), with the same flags. ``--format export`` (a ``.pt2``
ExportedProgram) stands for JAX's ``stablehlo`` and ``--format aoti`` (an
AOTInductor package directory that ``csrc/aoti_runner.cpp`` runs with no
Python) for its ``savedmodel``::

    python -m sam_quantization_tpu_torch.cli.export vit_tiny --format onnx \\
        --output decoder.onnx --num-points 8 --platform cpu
    python -m sam_quantization_tpu_torch.cli.export vit_b --format aoti \\
        --part encoder --output enc_aoti/

Prints one JSON line: ``format``, ``part``, ``output`` and ``bytes`` (with
``opset`` for ONNX) or ``manifest``. Runs on the CUDA card unless
``--platform cpu`` is given; an ONNX artifact is the same either way.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# The JAX CLI's format names, and the port's counterpart of each.
JAX_FORMATS = {"stablehlo": "export", "savedmodel": "aoti"}


def main(argv=None):
    p = argparse.ArgumentParser("samq-export")
    p.add_argument("model", choices=["vit_b", "vit_l", "vit_h", "vit_tiny"])
    p.add_argument("--output", required=True)
    p.add_argument("--format", default="onnx", choices=["onnx", "export", "aoti", *JAX_FORMATS],
                   help="onnx | export (a .pt2 ExportedProgram, JAX's stablehlo) | aoti (an "
                   "AOTInductor package directory for csrc/aoti_runner.cpp, JAX's savedmodel)")
    p.add_argument("--part", choices=["decoder", "encoder"], default="decoder")
    p.add_argument("--num-points", type=int, default=8)
    p.add_argument(
        "--return-single-mask", action="store_true", default=True,
        help="emit only the best mask (ref export_onnx_model.py flag)",
    )
    p.add_argument(
        "--return-all-masks", dest="return_single_mask", action="store_false",
        help="emit all multimask outputs instead of the argmax selection",
    )
    p.add_argument("--use-stability-score", action="store_true")
    p.add_argument("--stability-score-offset", type=float, default=1.0)
    from sam_quantization_tpu_torch.cli import add_model_args, add_platform_arg, build_model, device_of

    add_model_args(p)
    add_platform_arg(p)
    args = p.parse_args(argv)
    if args.format in JAX_FORMATS:
        p.error(f"--format {args.format} is the JAX package's; the port's counterpart is "
                f"--format {JAX_FORMATS[args.format]}")

    model, _ = build_model(args, device_of(args))
    out = {"format": args.format, "part": args.part, "output": args.output}
    if args.format == "onnx":
        from sam_quantization_tpu_torch import export_onnx

        if args.part == "decoder":
            blob = export_onnx.export_decoder_onnx(
                model, args.output,
                num_points=args.num_points,
                return_single_mask=args.return_single_mask,
                use_stability_score=args.use_stability_score,
                stability_score_offset=args.stability_score_offset,
            )
        else:
            blob = export_onnx.export_encoder_onnx(model, args.output)
        out["bytes"] = len(blob)
        out["opset"] = export_onnx.OPSET
    elif args.format == "export":
        from sam_quantization_tpu_torch import export as ex

        if args.part == "decoder":
            ex.export_decoder(model, args.output, num_points=args.num_points,
                              return_single_mask=args.return_single_mask)
        else:
            ex.export_encoder(model, args.output)
        out["bytes"] = os.path.getsize(args.output)
    else:
        from sam_quantization_tpu_torch import export as ex

        out["manifest"] = (
            ex.export_decoder_aoti(model, args.output, num_points=args.num_points,
                                   return_single_mask=args.return_single_mask)
            if args.part == "decoder" else ex.export_encoder_aoti(model, args.output))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
