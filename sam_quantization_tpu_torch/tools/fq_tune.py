"""Diagnose -> act on the fully-integer FQ path: the FQ override search.

    python -m sam_quantization_tpu_torch.tools.fq_tune --configs base s8 omse diag8 \
        --platform cpu

Counterpart of the JAX package's ``tools/fq_tune.py``, with its arguments,
its 13 variants and its output: one ``name {row}`` line a configuration and
a JSON line of every row last. It (a) ablates the candidate damage sources
(LIS output bits, the activation observer, int-LN), (b) runs the pointwise
SNR diagnosis (``quant/fq/pipeline.fq_pointwise_snr``, the FQ analog of the
reference's graphwise_error_analyse, script/analysis.py:596-625) and (c)
evaluates override sets built from it: ``diagK`` calibrates again with the
K worst points given another observer (omse or percentile) or left float
(``_skip``). ``fq_int8_tuned`` of ``tools/quality_table.py`` is
``diag8_skip``, built by :func:`build`. ``--snr-report`` prints every
observation point's SNR, worst first, and exits.

The model is a trainer checkpoint (``tools/train_synthetic.py``) read by
``tools/quality_table.load_model``; each row is 5-click mIoU (click seed
123) and NoC@85/90 from a loop to ``--noc-clicks`` (seed 321), by
``tools/quality_table.evaluate`` on the eager attention branch (JAX's
``"xla"``): under an FQ context the encoder launches no kernel. The rows run
with TF32 off. ``--platform cpu`` runs on the CPU; the default is the card.
"""

from __future__ import annotations

import argparse
import json
import sys

from sam_quantization_tpu_torch.cli import add_platform_arg, device_of


def build(model, calib_sam, fqcfg, overrides=None, diag: int = 0, diag_action=None):
    """(quantized model, ctx factory, the ``diag`` worst (point, SNR dB)):
    calibrate and quantize under ``overrides``; with ``diag``, rank the
    observation points by SNR on the first two calibration scenes, give the
    ``diag`` worst the observer ``diag_action`` (omse by default) or leave
    them float (``"skip"``), and calibrate and quantize again."""
    from sam_quantization_tpu_torch.quant.fq import pipeline as fq
    from sam_quantization_tpu_torch.quant.overrides import QuantOverrides

    qparams = fq.calibrate_sam(model, calib_sam, fqcfg, overrides=overrides)
    qmodel, make_ctx = fq.quantize_sam(model, fqcfg, qparams, overrides=overrides)
    worst = []
    if diag:
        snr = fq.fq_pointwise_snr(qmodel, calib_sam[:2], fqcfg, qparams)
        worst = list(snr.items())[:diag]
        ov = QuantOverrides(overrides.rules if overrides else [])
        for path, _db in worst:
            if diag_action == "skip":
                ov.add(path, skip=True)
            else:
                ov.add(path, observer=diag_action or "omse")
        qparams = fq.calibrate_sam(model, calib_sam, fqcfg, overrides=ov)
        qmodel, make_ctx = fq.quantize_sam(model, fqcfg, qparams, overrides=ov)
    return qmodel, make_ctx, worst


def variants():
    """{name: (FQConfig keyword arguments, diag, diag_action)}, JAX's 13."""
    s8 = {"bit_s": "uint8"}
    return {
        "base": ({}, 0, None),
        "s8": (s8, 0, None),
        "omse": ({"observer_a": "omse"}, 0, None),
        "pct": ({"observer_a": "percentile"}, 0, None),
        "noLIS": ({"int_softmax": False}, 0, None),
        "noIntNorm": ({"int_norm": False}, 0, None),
        "diag8": ({}, 8, "omse"),
        "diag8_pct": ({}, 8, "percentile"),
        "diag4_skip": ({}, 4, "skip"),
        "diag8_skip": ({}, 8, "skip"),
        "diag12_skip": ({}, 12, "skip"),
        "s8_diag8": (s8, 8, "omse"),
        "s8_omse": ({**s8, "observer_a": "omse"}, 0, None),
    }


def fq_config(kwargs: dict):
    from sam_quantization_tpu_torch.quant.bit_type import BIT_TYPE_DICT
    from sam_quantization_tpu_torch.quant.fq.pipeline import FQConfig

    if "bit_s" in kwargs:
        kwargs = {**kwargs, "bit_s": BIT_TYPE_DICT[kwargs["bit_s"]]}
    return FQConfig(**kwargs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("fq-tune")
    ap.add_argument("--ckpt", default="checkpoints/vit_tiny_synth")
    ap.add_argument("--model", default="vit_tiny")
    ap.add_argument("--eval-samples", type=int, default=24)
    ap.add_argument("--calib-samples", type=int, default=8)
    ap.add_argument("--noc-clicks", type=int, default=12)
    ap.add_argument("--configs", nargs="*", default=["base", "s8", "diag8"],
                    choices=list(variants()))
    ap.add_argument("--snr-report", action="store_true",
                    help="print the worst-SNR observation points and exit")
    add_platform_arg(ap)
    args = ap.parse_args(argv)

    from sam_quantization_tpu_torch.quant.sequential import full_float32

    with full_float32():
        return _main(args)


def _main(args) -> int:
    from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
    from sam_quantization_tpu_torch.quant.fq import pipeline as fq
    from sam_quantization_tpu_torch.tools import quality_table

    model, _step = quality_table.load_model(args.ckpt, args.model, "best", device_of(args))
    size = model.config.image_encoder.img_size
    eval_samples = list(synthetic_samples(args.eval_samples, size, seed=9999))
    calib_sam = list(synthetic_samples(args.calib_samples, size, seed=777))

    if args.snr_report:
        fqcfg = fq.FQConfig()
        qparams = fq.calibrate_sam(model, calib_sam, fqcfg)
        qmodel, _ = fq.quantize_sam(model, fqcfg, qparams)
        snr = fq.fq_pointwise_snr(qmodel, calib_sam[:4], fqcfg, qparams)
        for k, v in snr.items():
            print(f"  {v:7.2f} dB  {k}")
        return 0

    table = variants()
    rows = {}
    for name in args.configs:
        kwargs, diag, action = table[name]
        qmodel, make_ctx, worst = build(model, calib_sam, fq_config(kwargs), diag=diag,
                                        diag_action=action)
        if diag:
            print(f"  worst-{diag} SNR points:", [(k, round(v, 1)) for k, v in worst])
        res, noc, _ci = quality_table.evaluate(qmodel, make_ctx, eval_samples, 5,
                                               args.noc_clicks, "eager")
        rows[name] = {
            "click1": round(res.click1, 4), "click5": round(res.final, 4),
            **{k: round(noc[k], 2) for k in ("noc@85", "noc@90")},
        }
        print(name, rows[name], flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
