"""Automatic-mask-generation CLI: images in, masks out.

Counterpart of ``sam_quantization_tpu/cli/amg.py`` (ref scripts/amg.py),
with the same flags and outputs: ``<output>/<name>/metadata.csv`` and one
``.npy`` per mask, or ``<output>/<name>.json`` with ``--convert-to-rle``::

    python -m sam_quantization_tpu_torch.cli.amg --input scene.npy --output out \\
        --model-type vit_tiny --points-per-side 4 --points-per-batch 16 \\
        --pred-iou-thresh=-1e9 --stability-score-thresh 0.0 --platform cpu

``--checkpoint`` takes an upstream-named ``.pth`` or a trainer checkpoint
directory (``--ckpt-name``, default ``best``); ``--load-quantized`` a
quantized encoder artifact. Runs on the CUDA card unless ``--platform cpu``
is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser():
    p = argparse.ArgumentParser("samq-amg")
    p.add_argument("--input", required=True, help="image file or directory")
    p.add_argument("--output", required=True)
    p.add_argument("--model-type", default="vit_h")
    p.add_argument("--checkpoint", default=None,
                   help="upstream-named .pth state dict, or a trainer checkpoint directory")
    p.add_argument("--ckpt-name", default="best",
                   help="name of the checkpoint in a --checkpoint directory")
    p.add_argument("--load-quantized", default=None, help="quantized encoder artifact dir")
    p.add_argument("--convert-to-rle", action="store_true")
    # AMG knobs (scripts/amg.py:66-153)
    p.add_argument("--points-per-side", type=int, default=32)
    p.add_argument("--points-per-batch", type=int, default=64)
    p.add_argument("--pred-iou-thresh", type=float, default=0.88)
    p.add_argument("--stability-score-thresh", type=float, default=0.95)
    p.add_argument("--stability-score-offset", type=float, default=1.0)
    p.add_argument("--box-nms-thresh", type=float, default=0.7)
    p.add_argument("--crop-n-layers", type=int, default=0)
    p.add_argument("--crop-nms-thresh", type=float, default=0.7)
    p.add_argument("--crop-overlap-ratio", type=float, default=512 / 1500)
    p.add_argument("--crop-n-points-downscale-factor", type=int, default=1)
    p.add_argument("--min-mask-region-area", type=int, default=0)
    return p


def write_masks_to_folder(masks, path: str):
    """One .npy per mask plus metadata.csv (ref write_masks_to_folder,
    scripts/amg.py:156-186)."""
    import numpy as np

    header = (
        "id,area,bbox_x0,bbox_y0,bbox_w,bbox_h,point_input_x,point_input_y,"
        "predicted_iou,stability_score,crop_box_x0,crop_box_y0,crop_box_w,crop_box_h"
    )
    metadata = [header]
    for i, mask_data in enumerate(masks):
        np.save(os.path.join(path, f"{i}.npy"), mask_data["segmentation"])
        md = [
            str(i),
            str(mask_data["area"]),
            *[str(x) for x in mask_data["bbox"]],
            *[str(x) for x in mask_data["point_coords"][0]],
            str(mask_data["predicted_iou"]),
            str(mask_data["stability_score"]),
            *[str(x) for x in mask_data["crop_box"]],
        ]
        metadata.append(",".join(md))
    with open(os.path.join(path, "metadata.csv"), "w") as f:
        f.write("\n".join(metadata))


def main(argv=None):
    from sam_quantization_tpu_torch.cli import add_platform_arg, build_model, device_of

    p = build_parser()
    add_platform_arg(p)
    args = p.parse_args(argv)
    import numpy as np

    from sam_quantization_tpu_torch.automatic_mask_generator import SamAutomaticMaskGenerator
    from sam_quantization_tpu_torch.data.datasets import _imread

    args.model, args.load = args.model_type, args.load_quantized
    model, _ = build_model(args, device_of(args))
    output_mode = "uncompressed_rle" if args.convert_to_rle else "binary_mask"
    generator = SamAutomaticMaskGenerator(
        model,
        points_per_side=args.points_per_side,
        points_per_batch=args.points_per_batch,
        pred_iou_thresh=args.pred_iou_thresh,
        stability_score_thresh=args.stability_score_thresh,
        stability_score_offset=args.stability_score_offset,
        box_nms_thresh=args.box_nms_thresh,
        crop_n_layers=args.crop_n_layers,
        crop_nms_thresh=args.crop_nms_thresh,
        crop_overlap_ratio=args.crop_overlap_ratio,
        crop_n_points_downscale_factor=args.crop_n_points_downscale_factor,
        min_mask_region_area=args.min_mask_region_area,
        output_mode=output_mode,
    )

    if not os.path.isdir(args.input):
        targets = [args.input]
    else:
        targets = [os.path.join(args.input, f) for f in sorted(os.listdir(args.input))
                   if not os.path.isdir(os.path.join(args.input, f))]
    os.makedirs(args.output, exist_ok=True)
    for t in targets:
        print(f"Processing '{t}'...", file=sys.stderr)
        image = np.load(t) if t.endswith(".npy") else _imread(t)
        masks = generator.generate(image)
        base = os.path.splitext(os.path.basename(t))[0]
        if output_mode == "binary_mask":
            save_base = os.path.join(args.output, base)
            os.makedirs(save_base, exist_ok=True)
            write_masks_to_folder(masks, save_base)
        else:
            with open(os.path.join(args.output, base + ".json"), "w") as f:
                json.dump(masks, f)
    print("Done!", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
