"""CLI entry points of the port (counterparts of ``sam_quantization_tpu/cli``).

Shared flag: ``--platform {cpu,gpu}`` picks the device. The default is the
CUDA card, and an entry point raises when there is none.
"""

from __future__ import annotations


def add_platform_arg(parser) -> None:
    parser.add_argument(
        "--platform", default=None, choices=["cpu", "gpu"],
        help="device to run on (default: the CUDA card; raises without one); "
        "use --platform cpu for correctness drives off the card",
    )


def device_of(args) -> str:
    return "cpu" if getattr(args, "platform", None) == "cpu" else "cuda"
