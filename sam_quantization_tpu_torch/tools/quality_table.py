"""Quantization-quality table on a model that segments.

    python -m sam_quantization_tpu_torch.tools.quality_table \
        --ckpt checkpoints/vit_tiny_synth --platform cpu
    python -m sam_quantization_tpu_torch.tools.quality_table --merge \
        --attn-impl auto --configs bf16_kernels a8_serving_kernels a8_serving_kernels_epi

Counterpart of the JAX package's ``tools/quality_table.py``, with its
arguments, configuration names and JSON schema; its table goes to
``build/quality/QUALITY.json`` unless ``--out`` says otherwise, so the
committed ``QUALITY*.json`` stay the JAX tool's. It loads a trainer
checkpoint (``tools/train_synthetic.py``), quantizes the encoder under each
pipeline and records held-out 5-click mIoU and NoC@80/85/90 with
scene-bootstrap CI95s: the reference's acceptance gate
(script/evaluation2.py:225-334, inference/utils.py:79-96) on a model that
segments.

Configurations: ``fp32``; ``gptq_int4``, ``gptq_int3`` (groups of 32);
``rtn_int4``, ``rtn_int2u`` (ungrouped 2-bit) and ``rtn_int2u_mixed`` (its
worst-SNR quarter of layers at 8 bits); ``fq_int8`` and ``fq_int8_tuned``
(FQ-ViT, the tuned one with its 8 worst-SNR points left float);
``a8_serving`` (GPTQ symmetric 4-bit cached as int8 with static activation
scales); and the kernel-path rows ``bf16_kernels``, ``a8_serving_kernels``
and ``a8_serving_kernels_epi`` (bf16 encoders; the ``_epi`` one routes
attn.proj to int8, so the attention kernels write its int8 input). Each
kernel-path row is held inside its base row's CI95 (``BASE_OF``); the exit
code is 1 when one leaves it.

``--attn-impl``: ``xla`` runs the encoder's eager attention (the base rows'
default, as in JAX); ``auto`` and ``flash`` run ``attn_impl="kernel"``, the
CUDA kernels on the card. On the CPU every kernel runs its plain version.
``--platform cpu`` runs on the CPU; the default is the CUDA card.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

from sam_quantization_tpu_torch.cli import add_platform_arg, device_of

DEFAULT_CONFIGS = ["fp32", "gptq_int4", "gptq_int3", "rtn_int4", "fq_int8", "fq_int8_tuned",
                   "a8_serving"]
# JAX's --attn-impl values -> the port's encoder branches
ATTN_IMPLS = {"xla": "eager", "auto": "kernel", "flash": "kernel"}
# kernel-path rows and the CPU-eager base row each is held to: the click-k
# mIoU and NoC@90 must land inside the base row's scene-bootstrap CI95.
# Kernel numeric drift (clamp/exp2/int8 epilogue) is orders below the
# scene-sampling CI, so a violation means a real semantic change.
BASE_OF = {
    "bf16_kernels": "fp32",
    "a8_serving_kernels": "a8_serving",
    "a8_serving_kernels_epi": "a8_serving",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser("quality-table")
    p.add_argument("--ckpt", default="checkpoints/vit_tiny_synth")
    p.add_argument("--model", default="vit_tiny")
    p.add_argument("--name", default="best", choices=["best", "latest"])
    p.add_argument("--eval-samples", type=int, default=128)
    p.add_argument("--calib-samples", type=int, default=8)
    p.add_argument("--num-clicks", type=int, default=5)
    p.add_argument("--noc-clicks", type=int, default=12)
    add_platform_arg(p)
    p.add_argument("--scenes", default="easy", choices=["easy", "hard"],
                   help="synthetic scene style; must match the checkpoint's training "
                        "distribution (tools/train_synthetic --scenes)")
    p.add_argument("--out", default="build/quality/QUALITY.json")
    p.add_argument("--configs", nargs="*", default=list(DEFAULT_CONFIGS))
    p.add_argument(
        "--attn-impl", default="xla", choices=sorted(ATTN_IMPLS),
        help="attention for evaluation: 'xla' = the eager branch (the base rows); "
             "'auto' / 'flash' = the kernel branch (the CUDA kernels on the card, "
             "with the int8-out epilogue where configured)",
    )
    p.add_argument("--merge", action="store_true",
                   help="merge rows into an existing --out file instead of replacing it")
    return p.parse_args(argv)


def load_model(ckpt: str, model_name: str, name: str, device):
    """The checkpoint's model on ``device`` and its stored step. The reader
    takes an AdamW template (``train.checkpoint.load_checkpoint`` restores
    the whole file, moments included); only the weights are kept."""
    from sam_quantization_tpu_torch.models import sam as sam_lib
    from sam_quantization_tpu_torch.models.configs import CONFIGS
    from sam_quantization_tpu_torch.train import checkpoint as ckpt_lib
    from sam_quantization_tpu_torch.train import trainer

    model = sam_lib.Sam(CONFIGS[model_name], device=device).eval()
    template = trainer.make_optimizer(trainer.TrainConfig(), model)
    step = ckpt_lib.load_checkpoint(ckpt, model, template, name)
    del template
    for p in model.parameters():
        p.requires_grad_(False)
    return model, step


def calibration_data(model, n: int, style: str):
    """(raw (image, gt) pairs, preprocessed images on the model's device)
    of the ``n`` calibration scenes (seed 777)."""
    import torch

    from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
    from sam_quantization_tpu_torch.models import sam as sam_lib

    size = model.config.image_encoder.img_size
    calib_sam = list(synthetic_samples(n, size, seed=777, style=style))
    calib_imgs = [sam_lib.preprocess(model, torch.as_tensor(img, device=model.device))
                  for img, _ in calib_sam]
    return calib_sam, calib_imgs


def _with_encoder(model, encoder):
    """A ``Sam`` around ``encoder`` sharing ``model``'s prompt encoder and
    mask decoder."""
    out = copy.copy(model)
    out._modules = {**model._modules, "image_encoder": encoder}
    return out


def encoder_variant(name: str, model, calib_sam, calib_imgs):
    """(model with the configuration's encoder, quant ctx factory or None).
    ``model`` is left as it is: the port quantizes a copy of its encoder in
    place. The bf16 rows' encoders hold bf16 weights, and the backend
    encodes in its weights' dtype: the bf16 image cast JAX's serving rows
    make."""
    import torch

    from sam_quantization_tpu_torch.nn.packed import cache_int8, default_serve_skip
    from sam_quantization_tpu_torch.quant import sequential
    from sam_quantization_tpu_torch.quant.gptq import GPTQConfig

    def dense():
        return copy.deepcopy(model.image_encoder)

    if name == "fp32":
        return model, None
    if name == "bf16_kernels":
        # the serving dtype through the kernel path: the flash kernels'
        # clamp/exp2 numerics apart from any quantization
        return _with_encoder(model, dense().to(torch.bfloat16)), None
    if name in ("a8_serving_kernels", "a8_serving_kernels_epi"):
        # the `infer --serve-int8` configuration: bf16 encoder, GPTQ
        # INT4-sym -> cached per-channel int8 weights, calibrated static
        # activation scales, per-op routing; `_epi` also routes attn.proj to
        # int8 (skip=()), which engages the attention kernels' int8-out
        # epilogue
        from sam_quantization_tpu_torch.quant.act_scales import calibrate_act_scales

        enc = dense().to(torch.bfloat16)
        calib_bf16 = [c.to(torch.bfloat16) for c in calib_imgs]
        scales = calibrate_act_scales(enc, calib_bf16, margin=1.1)
        enc, _losses = sequential.gptq_quantize_encoder(
            enc, calib_bf16, GPTQConfig(bits=4, groupsize=32, sym=True))
        skip = () if name.endswith("_epi") else default_serve_skip(
            model.config.image_encoder.embed_dim)
        return _with_encoder(model, cache_int8(enc, act_scales=scales, skip=skip)), None
    if name.startswith("gptq_int") and not name.endswith("_mixed"):
        enc, _losses = sequential.gptq_quantize_encoder(
            dense(), calib_imgs, GPTQConfig(bits=int(name[-1]), groupsize=32))
        return _with_encoder(model, enc), None
    if name in ("rtn_int2u", "rtn_int2u_mixed"):
        # diagnose -> act (script/analysis.py:596-625 -> custimized_quant.py):
        # ungrouped RTN INT2, and with _mixed the worst-SNR quarter of the
        # layers bumped to 8 bits
        from sam_quantization_tpu_torch.quant.analysis import layerwise_error_analyse
        from sam_quantization_tpu_torch.quant.overrides import QuantOverrides

        qcfg = GPTQConfig(bits=2, groupsize=0)
        ov = None
        if name.endswith("_mixed"):
            q2 = sequential.rtn_quantize_encoder(dense(), qcfg)
            lw = layerwise_error_analyse(model.image_encoder, q2, calib_imgs[:2])
            n_bump = max(1, len(lw) // 4)
            ov = QuantOverrides.bump_worst_snr(lw, k=n_bump, bits=8)
            print(f"  bumped {n_bump} worst-SNR ops to 8-bit:", [r[0] for r in ov.rules])
        return _with_encoder(model, sequential.rtn_quantize_encoder(dense(), qcfg,
                                                                    overrides=ov)), None
    if name.startswith("rtn_int"):
        enc = sequential.rtn_quantize_encoder(dense(), GPTQConfig(bits=int(name[-1]),
                                                                  groupsize=32))
        return _with_encoder(model, enc), None
    if name == "a8_serving":
        # GPTQ INT4-sym weights requantized to cached per-channel int8,
        # calibrated static activation scales, per-op routing (cache_int8's
        # default skip)
        from sam_quantization_tpu_torch.quant.act_scales import calibrate_act_scales

        scales = calibrate_act_scales(model.image_encoder, calib_imgs, margin=1.1)
        enc, _losses = sequential.gptq_quantize_encoder(
            dense(), calib_imgs, GPTQConfig(bits=4, groupsize=32, sym=True))
        return _with_encoder(model, cache_int8(enc, act_scales=scales)), None
    if name in ("fq_int8", "fq_int8_tuned"):
        # fq_int8_tuned: the pointwise-SNR diagnosis flags the residual
        # stream's LN-input points; the 8 worst stay float, every other LN /
        # softmax integer (tools/fq_tune.py's diag8_skip)
        from sam_quantization_tpu_torch.quant.fq.pipeline import FQConfig
        from sam_quantization_tpu_torch.tools import fq_tune

        diag = 8 if name == "fq_int8_tuned" else 0  # int8 W, uint8 A, PTF int-LN + LIS
        qmodel, make_ctx, worst = fq_tune.build(model, calib_sam, FQConfig(), diag=diag,
                                                diag_action="skip")
        if diag:
            print(f"  fq_int8_tuned: skipping worst-SNR points {[p for p, _ in worst]}")
        return qmodel, make_ctx
    raise ValueError(name)


def evaluate(qmodel, make_ctx, samples, num_clicks: int, noc_clicks: int,
             attn_impl: str = "eager"):
    """(5-click result at click seed 123, NoC@80/85/90 and their CI95s from
    the loop to ``noc_clicks`` at seed 321, the click-1 / click-k CI95s).
    CI95s: 1000 scene-bootstrap draws from ``default_rng(0)``."""
    import numpy as np
    import torch

    from sam_quantization_tpu_torch.evaluation import click_eval
    from sam_quantization_tpu_torch.models import sam as sam_lib

    ctx = make_ctx() if make_ctx else None
    encode_raw, decode = click_eval.make_sam_backend(qmodel, ctx=ctx, attn_impl=attn_impl)

    def encode(x):
        return encode_raw(sam_lib.preprocess(qmodel, torch.from_numpy(x)).numpy())

    size = qmodel.config.image_encoder.img_size
    res = click_eval.click_loop_eval(encode, decode, samples, num_clicks=num_clicks,
                                     img_size=size, seed=123)
    # NoC@85/90: random-click loop to noc_clicks, clicks to reach the
    # threshold (inference/utils.py:79-96 on the same backend)
    noc_res = click_eval.click_loop_eval(encode, decode, samples, num_clicks=noc_clicks,
                                         img_size=size, seed=321)
    arr = np.asarray(noc_res.per_sample_ious)  # (n, clicks)
    noc = {}
    boot = np.random.default_rng(0)
    n = arr.shape[0]
    bidx = boot.integers(0, n, size=(1000, n))
    for thr in (0.80, 0.85, 0.90):
        reach = arr >= thr
        first = np.where(reach.any(axis=1), reach.argmax(axis=1) + 1, noc_clicks)
        noc[f"noc@{int(thr * 100)}"] = float(first.mean())
        bs = first[bidx].mean(axis=1)
        noc[f"noc@{int(thr * 100)}_ci95"] = [
            round(float(np.percentile(bs, 2.5)), 2),
            round(float(np.percentile(bs, 97.5)), 2),
        ]
    # bootstrap CI for the click-k mIoUs (resample scenes, 1000 draws)
    ious = np.asarray(res.per_sample_ious)  # (n, clicks)
    ci = {}
    for col, key in ((0, "click1"), (ious.shape[1] - 1, f"click{num_clicks}")):
        bs = ious[bidx, col].mean(axis=1)
        ci[f"{key}_ci95"] = [
            round(float(np.percentile(bs, 2.5)), 4),
            round(float(np.percentile(bs, 97.5)), 4),
        ]
    return res, noc, ci


def check_against_base(name: str, row: dict, base_name, base, num_clicks: int) -> bool:
    """Hold a kernel-path ``row`` to its ``base`` row in place (adding
    ``vs_base_row``, the deltas and ``within_base_ci95``); True when it is
    inside, or when there is nothing to hold it to."""
    ck = f"click{num_clicks}_miou"
    need = (ck, f"click{num_clicks}_ci95", "noc@90", "noc@90_ci95")
    missing = [k for k in need if base_name and base and k not in base]
    if missing:
        # a --merge base row from another --num-clicks or an older schema:
        # skip the check rather than fail after the evaluation ran
        print(f"  {name}: base row {base_name} lacks {missing} (different --num-clicks or "
              f"older file) — CI check skipped", flush=True)
        base = None
    if not (base_name and base):
        return True
    checks = {}
    for key, ci_key in ((ck, f"click{num_clicks}_ci95"), ("noc@90", "noc@90_ci95")):
        lo, hi = base[ci_key]
        rlo, rhi = row[ci_key]
        # inside the base CI, or the two CIs overlap (both are scene-bootstrap
        # estimates; NoC is integer per scene, so its CI can collapse to a point)
        checks[key] = bool(lo <= row[key] <= hi or (rlo <= hi and lo <= rhi))
    row["vs_base_row"] = base_name
    row["delta_click_miou"] = round(row[ck] - base[ck], 4)
    row["delta_noc@90"] = round(row["noc@90"] - base["noc@90"], 2)
    row["within_base_ci95"] = checks
    ok = all(checks.values())
    print(f"  {name} vs {base_name}: d_miou={row['delta_click_miou']:+.4f} "
          f"d_noc@90={row['delta_noc@90']:+.2f} within CI95 -> {'PASS' if ok else 'FAIL'}",
          flush=True)
    return ok


def main(argv=None) -> int:
    from sam_quantization_tpu_torch.quant.sequential import full_float32

    # float32 rows without TF32 in cuBLAS and cuDNN (the convolutions' default)
    with full_float32():
        return _main(parse_args(argv))


def _main(args) -> int:
    from sam_quantization_tpu_torch.data.synthetic import synthetic_samples

    model, step = load_model(args.ckpt, args.model, args.name, device_of(args))
    print(f"loaded {args.ckpt}/{args.name} (step {step})")
    size = model.config.image_encoder.img_size
    eval_samples = list(synthetic_samples(args.eval_samples, size, seed=9999,
                                          style=args.scenes))
    calib_sam, calib_imgs = calibration_data(model, args.calib_samples, args.scenes)

    prev_rows = {}
    if args.merge and os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f)
        prev_rows = prev.get("rows", {})
        prev_scenes = prev.get("scenes", "easy")
        if prev_scenes != args.scenes:
            # a kernel row held to a base row of another scene style means
            # nothing, and the file's 'scenes' would misdescribe half its rows
            raise SystemExit(
                f"--merge: {args.out} was produced with scenes={prev_scenes!r} but this run "
                f"uses scenes={args.scenes!r}; use a separate --out per scene style")

    rows = {}
    all_within = True
    for name in args.configs:
        qmodel, make_ctx = encoder_variant(name, model, calib_sam, calib_imgs)
        res, noc, ci = evaluate(qmodel, make_ctx, eval_samples, args.num_clicks,
                                args.noc_clicks, ATTN_IMPLS[args.attn_impl])
        del qmodel
        row = {
            "click1_miou": round(res.click1, 4),
            f"click{args.num_clicks}_miou": round(res.final, 4),
            **{k: (round(v, 2) if not isinstance(v, list) else v) for k, v in noc.items()},
            **ci,
        }
        if args.attn_impl != "xla":
            row["attn_impl"] = args.attn_impl
        base_name = BASE_OF.get(name)
        base = prev_rows.get(base_name) or rows.get(base_name)
        all_within &= check_against_base(name, row, base_name, base, args.num_clicks)
        rows[name] = row
        print(name, rows[name], flush=True)

    out = {
        "model": args.model,
        "checkpoint_step": step,
        "eval_samples": args.eval_samples,
        "scenes": args.scenes,
        "rows": rows,
    }
    if args.merge and prev_rows:
        merged = dict(prev_rows)
        merged.update(rows)
        with open(args.out) as f:
            out = json.load(f)
        out["rows"] = merged
        out["scenes"] = args.scenes
    # ci_ok covers every row of the written file: a merge must not overwrite
    # a failure recorded before with this run's pass
    out["ci_ok"] = bool(all_within) and all(
        all(r["within_base_ci95"].values())
        for r in out["rows"].values() if "within_base_ci95" in r
    )
    if not out["ci_ok"]:
        print("WARNING: a kernel-path row left its base row's CI95", flush=True)
    all_within = out["ci_ok"]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    # the status line and exit code carry the CI gate
    print(json.dumps({"status": "ok" if all_within else "ci_fail", "out": args.out}))
    return 0 if all_within else 1


if __name__ == "__main__":
    sys.exit(main())
