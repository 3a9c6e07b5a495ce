"""NoC evaluation CLI: counterpart of ``sam_quantization_tpu/cli/evaluate.py``
(the reference's scripts/evaluate_model.py:24-486).

Prints the NoC@80/85/90 table of each dataset, with distance-transform
clicks, optionally through the flip, zoom-in and crops test-time
augmentations::

    python -m sam_quantization_tpu_torch.cli.evaluate vit_tiny \\
        --checkpoint checkpoints/vit_tiny_synth --datasets synthetic,synthetic_hard
    python -m sam_quantization_tpu_torch.cli.evaluate vit_tiny --datasets synthetic \\
        --num-samples 2 --n-clicks 3 --with-flip --platform cpu

Datasets: ``synthetic`` and ``synthetic_hard`` (seeded scenes), the named
benchmarks GrabCut/Berkeley/DAVIS/COCO_MVal/PascalVOC/SBD (path from
``config.yml`` unless ``--dataset-path`` is given), or any images/ + masks/
folder at ``--dataset-path``. Runs on the CUDA card unless ``--platform
cpu`` is given. ``--mode InputBRS`` and ``--mode f-BRS`` refine every click
by L-BFGS over the mask prompt or the embedding's per-channel scale and
bias (``evaluation/predictors.py``)::

    python -m sam_quantization_tpu_torch.cli.evaluate vit_tiny --datasets synthetic \
        --num-samples 2 --n-clicks 3 --mode InputBRS --platform cpu
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser("samq-evaluate")
    p.add_argument("model", choices=["vit_b", "vit_l", "vit_h", "vit_tiny"])
    p.add_argument("--datasets", default="synthetic",
                   help="comma list: synthetic,synthetic_hard,GrabCut,Berkeley,DAVIS,"
                        "COCO_MVal,PascalVOC,SBD,<folder-name> (named benchmarks resolve "
                        "their path from config.yml unless --dataset-path overrides)")
    p.add_argument("--dataset-path", default=None)
    p.add_argument("--n-clicks", type=int, default=20)
    p.add_argument("--thresh", type=float, default=0.5)
    p.add_argument("--num-samples", type=int, default=20)
    p.add_argument("--mode", default="NoBRS", choices=["NoBRS", "f-BRS", "InputBRS"])
    p.add_argument("--with-flip", action="store_true")
    p.add_argument("--zoom-in", action="store_true")
    p.add_argument("--crops", default=None, metavar="HxW",
                   help="tiled-crop TTA, e.g. 320x480 (ref eval-mode 'fixed<crop>')")
    from sam_quantization_tpu_torch.cli import (
        add_model_args, add_platform_arg, build_model, device_of,
    )

    add_model_args(p)
    add_platform_arg(p)
    args = p.parse_args(argv)

    from sam_quantization_tpu_torch.data.datasets import (
        ImageMaskDataset, get_dataset, preprocess_for_eval,
    )
    from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
    from sam_quantization_tpu_torch.evaluation import click_eval, metrics
    from sam_quantization_tpu_torch.evaluation.predictors import (
        Crops, FeatureBRSPredictor, InputBRSPredictor, SamEvalPredictor, ZoomIn,
    )
    from sam_quantization_tpu_torch.predictor import SamPredictor

    model, _ = build_model(args, device_of(args))
    size = model.config.image_encoder.img_size
    use_predictor = args.mode != "NoBRS" or args.with_flip or args.zoom_in or args.crops
    if use_predictor:
        crops = None
        if args.crops:
            ch, cw = (int(v) for v in args.crops.lower().split("x"))
            crops = Crops(crop_size=(ch, cw))
        cls = {"InputBRS": InputBRSPredictor, "f-BRS": FeatureBRSPredictor}.get(
            args.mode, SamEvalPredictor)
        eval_pred = cls(SamPredictor(model), with_flip=args.with_flip,
                        zoom_in=ZoomIn(target_size=size) if args.zoom_in else None,
                        crops=crops)
    else:
        encode, decode = click_eval.make_sam_backend(model)

    for name in args.datasets.split(","):
        if name in ("synthetic", "synthetic_hard"):
            style = "hard" if name.endswith("_hard") else "easy"
            samples = synthetic_samples(args.num_samples, size, 0, style=style)
        else:
            # a named benchmark, else a generic images/ + masks/ folder
            ds = get_dataset(name, args.dataset_path)
            if ds is None:
                ds = ImageMaskDataset(args.dataset_path)
            items = itertools.islice(ds.eval_items(), args.num_samples)
            samples = (preprocess_for_eval(img, gt, size) for img, gt, _ in items)

        t0 = time.time()
        if use_predictor:
            noc, over, spc = click_eval.noc_eval_predictor(
                eval_pred, samples, max_clicks=args.n_clicks, pred_thr=args.thresh)
        else:
            noc, over, spc = click_eval.noc_eval(
                encode, decode, samples, max_clicks=args.n_clicks, img_size=size)
        print(metrics.results_table(noc, over, name, spc, time.time() - t0, args.num_samples,
                                    max_clicks=args.n_clicks))
    return 0


if __name__ == "__main__":
    sys.exit(main())
