"""Fine-tuning CLI on one card: the counterpart of ``sam_quantization_tpu/cli/train.py``.

Interactive click training on seeded synthetic scenes, checkpoint save and
resume (in the JAX trainer's format, so either package resumes the other's
runs), scalar logging::

    python -m sam_quantization_tpu_torch.cli.train vit_h --steps-per-epoch 2 --num-clicks 2
    python -m sam_quantization_tpu_torch.cli.train vit_tiny --platform cpu --exp-dir runs

Runs on the CUDA card unless ``--platform cpu`` is given. ``--tp`` other
than 1 raises: data- and tensor-parallel training are not ported.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser("samq-train")
    p.add_argument("model", choices=["vit_b", "vit_l", "vit_h", "vit_tiny"])
    p.add_argument("--checkpoint", default=None, help="upstream-named .pth state dict")
    p.add_argument("--exp-dir", default="runs")
    p.add_argument("--exp-name", default="finetune")
    p.add_argument("--resume", default=None, help="experiment prefix to resume")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps-per-epoch", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--num-clicks", type=int, default=11)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    from sam_quantization_tpu_torch.cli import add_platform_arg, device_of

    add_platform_arg(p)
    args = p.parse_args(argv)
    if args.tp != 1:
        raise NotImplementedError("--tp: tensor- and data-parallel training are not ported")

    import numpy as np
    import torch

    from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
    from sam_quantization_tpu_torch.models import build_sam
    from sam_quantization_tpu_torch.train import checkpoint, trainer
    from sam_quantization_tpu_torch.utils import experiment

    device = device_of(args)
    exp_dir = experiment.init_experiment(args.exp_dir, args.exp_name, args.resume)
    logger = experiment.setup_logger(str(exp_dir / "logs"))
    writer = experiment.ScalarWriterAvg(str(exp_dir / "logs"))

    model = build_sam.sam_model_registry[args.model](
        checkpoint=args.checkpoint, device=device, seed=args.seed
    ).train()
    tcfg = trainer.TrainConfig(learning_rate=args.lr, num_clicks=args.num_clicks)
    optimizer = trainer.make_optimizer(tcfg, model)
    start_epoch = 0
    if args.resume:
        t0 = time.time()
        start_epoch = checkpoint.load_checkpoint(str(exp_dir / "checkpoints"), model, optimizer)
        logger.info(f"resumed at epoch {start_epoch} (checkpoint loaded in {time.time() - t0:.1f}s)")

    step_fn = trainer.make_train_step(tcfg, optimizer)
    size = model.config.image_encoder.img_size
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def batches(epoch):
        samples = synthetic_samples(
            args.steps_per_epoch * args.batch_size, size, args.seed + epoch
        )
        for _ in range(args.steps_per_epoch):
            imgs, gts = [], []
            for _ in range(args.batch_size):
                im, gt = next(samples)
                imgs.append(im[0])
                gts.append(gt)
            yield (torch.from_numpy(np.stack(imgs)).to(device),
                   torch.from_numpy(np.stack(gts).astype(np.float32)).to(device))

    gstep = start_epoch * args.steps_per_epoch
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        for images, gts in batches(epoch):
            aux = step_fn(model, images, gts, gen)
            gstep += 1
            writer.add_scalar("loss", float(aux["loss"]), gstep)
            writer.add_scalar("iou", float(aux["iou"]), gstep)
        logger.info(
            f"epoch {epoch}: loss={float(aux['loss']):.4f} "
            f"iou={float(aux['iou']):.4f} ({time.time() - t0:.1f}s)"
        )
        t0 = time.time()
        checkpoint.save_checkpoint(str(exp_dir / "checkpoints"), model, optimizer, epoch + 1)
        nbytes = sum(f.stat().st_size for f in (exp_dir / "checkpoints").iterdir())
        logger.info(f"checkpoint saved: {nbytes / 1e9:.2f} GB in {time.time() - t0:.1f}s")
    writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
