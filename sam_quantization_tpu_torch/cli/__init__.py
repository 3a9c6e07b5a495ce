"""CLI entry points of the port (counterparts of ``sam_quantization_tpu/cli``).

Shared flag: ``--platform {cpu,gpu}`` picks the device. The default is the
CUDA card, and an entry point raises when there is none.
"""

from __future__ import annotations

import os


def add_platform_arg(parser) -> None:
    parser.add_argument(
        "--platform", default=None, choices=["cpu", "gpu"],
        help="device to run on (default: the CUDA card; raises without one); "
        "use --platform cpu for correctness drives off the card",
    )


def device_of(args) -> str:
    return "cpu" if getattr(args, "platform", None) == "cpu" else "cuda"


def add_model_args(parser) -> None:
    """``--checkpoint`` (an upstream-named ``.pth`` state dict, or a trainer
    checkpoint directory of ``sam_model_<name>.npz`` files, e.g.
    ``checkpoints/vit_tiny_synth``), ``--ckpt-name`` and ``--load`` (a
    quantized encoder artifact written by ``cli/quantize``)."""
    parser.add_argument(
        "--checkpoint", default=None,
        help="upstream-named .pth state dict, or a trainer checkpoint directory "
        "(sam_model_<name>.npz, e.g. checkpoints/vit_tiny_synth)",
    )
    parser.add_argument("--ckpt-name", default="best",
                        help="name of the checkpoint in a --checkpoint directory")
    parser.add_argument("--load", default=None, help="quantized artifact dir")


def build_model(args, device: str, seed: int = 0):
    """The model of ``add_model_args``' flags on ``device``: random weights
    from ``seed`` unless ``--checkpoint`` gives them; with ``--load``, the
    artifact's packed encoder. Returns (model, the artifact's quant config
    or None)."""
    from sam_quantization_tpu_torch.models import build_sam
    from sam_quantization_tpu_torch.quant import artifacts
    from sam_quantization_tpu_torch.train import checkpoint as ckpt_lib

    ckpt = args.checkpoint
    from_dir = ckpt is not None and os.path.isdir(ckpt)
    model = build_sam.sam_model_registry[args.model](
        checkpoint=None if from_dir else ckpt, device=device, seed=seed)
    if from_dir:
        ckpt_lib.load_weights(ckpt, model, args.ckpt_name)
    qcfg = None
    if args.load:
        enc, qcfg = artifacts.load_quantized(args.load)
        build_sam.load_jax_encoder(model, enc)
    return model, qcfg
