"""FQ-ViT classifier quantization CLI: counterpart of
``sam_quantization_tpu/cli/test_quant.py`` (the reference's
fq_vit/test_quant.py), with the same flags, defaults and JSON keys.

Calibrates a ViT / DeiT / Swin classifier with the selected observer,
quantizes it (int8 weights, uint8 activations, PTF integer LayerNorm, LIS
log-softmax) and reports the float-vs-quantized top-1 / top-5 agreement on
seeded inputs, the quantization-quality signal available without ImageNet::

    python -m sam_quantization_tpu_torch.cli.test_quant deit_tiny --calib-iter 2 \\
        --val-batches 1 --platform cpu

The weights are random, drawn from a ``torch.Generator`` seeded by
``--seed``; the calibration and validation batches come from
``np.random.default_rng(seed)`` in the JAX CLI's order. Runs on the CUDA
card unless ``--platform cpu`` is given; the forwards are eager (the JAX CLI
jits them) and launch no kernel.
"""

from __future__ import annotations

import argparse
import json
import sys

MODELS = ["vit_base", "vit_large", "deit_tiny", "deit_small", "deit_base",
          "swin_tiny", "swin_small", "swin_base"]


def main(argv=None):
    p = argparse.ArgumentParser("samq-test-quant")
    p.add_argument("model", choices=MODELS)
    p.add_argument("--quant", action="store_true", default=True)
    p.add_argument("--ptf", action="store_true", default=True)
    p.add_argument("--no-ptf", dest="ptf", action="store_false")
    p.add_argument("--lis", action="store_true", default=True)
    p.add_argument("--no-lis", dest="lis", action="store_false")
    p.add_argument("--quant-method", default="minmax",
                   choices=["minmax", "ema", "omse", "percentile"])
    p.add_argument("--calib-iter", type=int, default=10)
    p.add_argument("--calib-batchsize", type=int, default=8)
    p.add_argument("--val-batches", type=int, default=4)
    p.add_argument("--data", default=None, help="ImageNet val directory")
    p.add_argument("--seed", type=int, default=0)
    from sam_quantization_tpu_torch.cli import add_platform_arg, device_of

    add_platform_arg(p)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from sam_quantization_tpu_torch.quant.fq.pipeline import (
        FQConfig, FQCtx, calibrate, fq_quantize_weights,
    )
    from sam_quantization_tpu_torch.quant.sequential import full_float32

    if args.model.startswith("swin"):
        from sam_quantization_tpu_torch.models import swin_classifier as m

        cfg = m.SWIN_CONFIGS[args.model]
    else:
        from sam_quantization_tpu_torch.models import vit_classifier as m

        cfg = m.CLASSIFIER_CONFIGS[args.model]
    dev = torch.device(device_of(args))
    model = m.init(cfg, seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)

    def batches(n):
        for _ in range(n):
            x = rng.normal(size=(args.calib_batchsize, cfg.img_size, cfg.img_size, 3))
            yield torch.from_numpy(x.astype(np.float32)).to(dev)

    fqcfg = FQConfig(int_softmax=args.lis, int_norm=args.ptf, observer_a=args.quant_method)
    qp = calibrate(lambda x, ctx: model(x, ctx), list(batches(args.calib_iter)), fqcfg)
    wq = fq_quantize_weights(model, fqcfg)

    agree1 = agree5 = total = 0
    with torch.no_grad(), full_float32():
        for x in batches(args.val_batches):
            fp = model(x).cpu().numpy()
            q = wq(x, FQCtx("quant", fqcfg, qparams=qp)).cpu().numpy()
            top1 = fp.argmax(-1)
            q_rank = np.argsort(-q, axis=-1)
            agree1 += int((q_rank[:, 0] == top1).sum())
            agree5 += int((q_rank[:, :5] == top1[:, None]).any(-1).sum())
            total += len(top1)
    out = {
        "model": args.model,
        "ptf": args.ptf,
        "lis": args.lis,
        "quant_method": args.quant_method,
        "fp_agreement_top1": round(agree1 / total, 4),
        "fp_agreement_top5": round(agree5 / total, 4),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
