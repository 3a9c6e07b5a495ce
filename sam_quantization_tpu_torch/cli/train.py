"""Fine-tuning CLI: the counterpart of ``sam_quantization_tpu/cli/train.py``.

Interactive click training on seeded synthetic scenes, checkpoint save and
resume (in the JAX trainer's format, so either package resumes the other's
runs), scalar logging::

    python -m sam_quantization_tpu_torch.cli.train vit_h --steps-per-epoch 2 --num-clicks 2
    python -m sam_quantization_tpu_torch.cli.train vit_tiny --platform cpu --exp-dir runs

Runs on the CUDA card unless ``--platform cpu`` is given. Under torchrun it
trains on a dp x tp mesh of the world, one process per card (NCCL; gloo on
the CPU with ``--platform cpu``)::

    torchrun --nproc_per_node 4 -m sam_quantization_tpu_torch.cli.train vit_h --tp 2

``--tp`` must divide the world (a world of one takes only ``--tp 1``). Each
dp rank takes its rows of the ``--batch-size`` batch, so the batch must
divide over dp; the ranks of a tp group share rows and draw their clicks
from one generator seeded ``--seed + dp rank``. Rank 0 makes the run's
directory, logs the world's mean loss and IoU, and writes the checkpoint,
gathered from the tp shards, in the one-process format.
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
    p.add_argument("--sbd-dir", default=None,
                   help="accepted so that a JAX command line parses; not read (nor by the "
                   "JAX trainer): training runs on seeded synthetic scenes")
    p.add_argument("--seed", type=int, default=0)
    from sam_quantization_tpu_torch.cli import add_platform_arg, device_of

    add_platform_arg(p)
    args = p.parse_args(argv)

    from sam_quantization_tpu_torch.parallel import distributed
    from sam_quantization_tpu_torch.parallel import mesh as mesh_lib

    world = distributed.env_world_size()
    mesh_lib.check_tp(world, args.tp)
    if world == 1:
        return _train(args, device_of(args), None)
    import torch.distributed as dist

    joined = not dist.is_initialized()
    cpu = device_of(args) == "cpu"
    device = distributed.initialize("gloo" if cpu else "nccl", device="cpu" if cpu else None)
    try:
        return _train(args, device, mesh_lib.make_mesh(tp=args.tp))
    finally:
        if joined:
            distributed.destroy()


def _train(args, device, mesh):
    import numpy as np
    import torch
    import torch.distributed as dist

    from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
    from sam_quantization_tpu_torch.models import build_sam
    from sam_quantization_tpu_torch.parallel import distributed
    from sam_quantization_tpu_torch.train import checkpoint, trainer
    from sam_quantization_tpu_torch.utils import experiment

    main_rank = distributed.is_main_process()
    dp_rank = 0 if mesh is None else mesh.get_local_rank("dp")
    exp_dir = [experiment.init_experiment(args.exp_dir, args.exp_name, args.resume)
               if main_rank else None]
    if mesh is not None:
        dist.broadcast_object_list(exp_dir, src=0)
    exp_dir = exp_dir[0]
    logger = experiment.setup_logger(str(exp_dir / "logs"), distributed.get_rank())
    writer = experiment.ScalarWriterAvg(str(exp_dir / "logs")) if main_rank else None

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
    if args.tp > 1:
        optimizer = trainer.shard_for_training(model, optimizer, tcfg, mesh)
    if mesh is not None:
        logger.info(f"world {distributed.get_world_size()}: dp {mesh['dp'].size()} x tp "
                    f"{args.tp}")

    step_fn = trainer.make_train_step(tcfg, optimizer, mesh)
    size = model.config.image_encoder.img_size
    gen = torch.Generator(device=device).manual_seed(args.seed + dp_rank)

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
            imgs, gts = np.stack(imgs), np.stack(gts).astype(np.float32)
            if mesh is not None:
                imgs, gts = distributed.local_batch(imgs, mesh), distributed.local_batch(gts, mesh)
            yield torch.from_numpy(imgs).to(device), torch.from_numpy(gts).to(device)

    gstep = start_epoch * args.steps_per_epoch
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        for images, gts in batches(epoch):
            aux = step_fn(model, images, gts, gen)
            aux = distributed.reduce_loss_dict({k: float(aux[k]) for k in ("loss", "iou")})
            gstep += 1
            if writer is not None:
                writer.add_scalar("loss", aux["loss"], gstep)
                writer.add_scalar("iou", aux["iou"], gstep)
        logger.info(
            f"epoch {epoch}: loss={aux['loss']:.4f} "
            f"iou={aux['iou']:.4f} ({time.time() - t0:.1f}s)"
        )
        t0 = time.time()
        checkpoint.save_checkpoint(str(exp_dir / "checkpoints"), model, optimizer, epoch + 1,
                                   mesh=mesh)
        distributed.barrier()
        nbytes = sum(f.stat().st_size for f in (exp_dir / "checkpoints").iterdir())
        logger.info(f"checkpoint saved: {nbytes / 1e9:.2f} GB in {time.time() - t0:.1f}s")
    if writer is not None:
        writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
