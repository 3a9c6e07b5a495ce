"""Train a small SAM on synthetic blob scenes until it segments.

    python -m sam_quantization_tpu_torch.tools.train_synthetic --platform cpu \
        --steps 3000

Counterpart of the JAX package's ``tools/train_synthetic.py``, with its
arguments, status lines and checkpoint format: it fits ``vit_tiny`` on
seeded synthetic scenes (``data/synthetic.py``) with the click-loop trainer
(``train/trainer.py``) until the held-out 5-click IoU clears
``--target-iou``, evaluating every ``--eval-every`` steps with the eager
encoder and writing ``latest`` (and ``best`` on a new best) as the JAX
trainer's flat-leaf npz with extras ``click1`` / ``click5`` into ``--out``
(``build/vit_tiny_synth`` by default, so the committed
``checkpoints/vit_tiny_synth`` stays the JAX trainer's); the
quantization-quality table (``tools/quality_table.py``) reads them.

On the card the train step runs the trainable attention path
(``attn_impl="flash_train"``), as ``cli/train`` does. A fresh run's
initial weights come from the port's seeded generator, so they differ from
``jax.random.PRNGKey(seed)``'s; ``--resume`` goes on from a checkpoint of
either package, and the scene pool (seed + 1), held-out scenes (seed 9999)
and batch draws (numpy's ``default_rng(seed + 2)``) are the JAX tool's. The
training clicks draw from a torch generator seeded ``seed + 3``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from sam_quantization_tpu_torch.cli import add_platform_arg, device_of


def parse_args(argv=None):
    p = argparse.ArgumentParser("train-synthetic")
    p.add_argument("--model", default="vit_tiny")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--num-clicks", type=int, default=5)
    p.add_argument("--eval-every", type=int, default=200)
    p.add_argument("--eval-samples", type=int, default=16)
    p.add_argument("--target-iou", type=float, default=0.8)
    p.add_argument("--out", default="build/vit_tiny_synth")
    p.add_argument("--seed", type=int, default=0)
    add_platform_arg(p)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--pool", type=int, default=512,
                   help="training-scene pool size (bigger = less memorization)")
    p.add_argument("--scenes", default="easy", choices=["easy", "hard"],
                   help="synthetic scene style (data/synthetic.py): 'hard' = multi-object "
                        "distractor scenes that do not saturate the click metrics")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch

    from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
    from sam_quantization_tpu_torch.evaluation import click_eval
    from sam_quantization_tpu_torch.models import sam as sam_lib
    from sam_quantization_tpu_torch.models.configs import CONFIGS
    from sam_quantization_tpu_torch.train import checkpoint as ckpt_lib
    from sam_quantization_tpu_torch.train import trainer

    device = device_of(args)
    cfg = CONFIGS[args.model]
    size = cfg.image_encoder.img_size
    model = sam_lib.init(cfg, args.seed, device)

    tcfg = trainer.TrainConfig(learning_rate=args.lr, num_clicks=args.num_clicks)
    optimizer = trainer.make_optimizer(tcfg, model)
    step_fn = trainer.make_train_step(tcfg, optimizer)

    start = 0
    if args.resume and os.path.exists(os.path.join(args.out, "sam_model_latest.npz")):
        start = ckpt_lib.load_checkpoint(args.out, model, optimizer, "latest")
        print(f"resumed at step {start}")

    # a fixed pool of training scenes (seeded), held-out scenes from a
    # disjoint seed
    pool = [(img[0], gt) for img, gt in synthetic_samples(args.pool, size, seed=args.seed + 1,
                                                          style=args.scenes)]
    eval_samples = list(synthetic_samples(args.eval_samples, size, seed=9999, style=args.scenes))
    rng = np.random.default_rng(args.seed + 2)

    def eval_iou():
        encode_raw, decode = click_eval.make_sam_backend(model, attn_impl="eager")

        def encode(x):
            return encode_raw(sam_lib.preprocess(model, torch.from_numpy(x)).numpy())

        return click_eval.click_loop_eval(encode, decode, eval_samples, num_clicks=5,
                                          img_size=size, seed=123)

    gen = torch.Generator(device=model.device).manual_seed(args.seed + 3)
    best = 0.0
    t0 = time.time()
    for step in range(start, args.steps):
        idx = rng.integers(0, len(pool), size=args.batch)
        images = torch.from_numpy(np.stack([pool[i][0] for i in idx])).to(model.device)
        gts = torch.from_numpy(np.stack([pool[i][1] for i in idx]).astype(np.float32))
        aux = step_fn(model, images, gts.to(model.device), gen)
        if step % 50 == 0:
            print(f"step {step}: loss={float(aux['loss']):.4f} train_iou={float(aux['iou']):.3f} "
                  f"({(time.time() - t0):.0f}s)", flush=True)
        if (step + 1) % args.eval_every == 0 or step == args.steps - 1:
            res = eval_iou()
            print(f"eval@{step + 1}: click1={res.click1:.3f} click5={res.final:.3f}", flush=True)
            extras = {"click1": res.click1, "click5": res.final}
            ckpt_lib.save_checkpoint(args.out, model, optimizer, step + 1, "latest",
                                     extras=extras)
            if res.final > best:
                best = res.final
                ckpt_lib.save_checkpoint(args.out, model, optimizer, step + 1, "best",
                                         extras=extras)
            if res.final >= args.target_iou:
                print(json.dumps({"status": "target_reached", "step": step + 1,
                                  "click5": res.final}))
                return 0
    print(json.dumps({"status": "done", "best_click5": best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
