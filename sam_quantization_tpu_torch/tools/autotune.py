"""Run the on-card tile tuner of the packed-weight kernels and persist the table.

    python -m sam_quantization_tpu_torch.tools.autotune [--model vit_h]
        [--m 4900 4096] [--bits 4] [--groupsize 128] [--dtype bf16] [--table PATH]

Counterpart of the JAX package's ``tools/autotune.py``: for each M and bits
it times every candidate tile of the four encoder linear shapes
(``ops.autotune.tune_model_shapes``) and writes the fastest to the table,
``.samq_autotune_torch.json`` at the repository root unless ``--table``
names another; ``ops.quant_matmul.pick_blocks`` reads it at the next start,
and so does ``pick_blocks_a8`` for the W-A8 kernels (a bfloat16 entry; the
tuner times the weight-only kernel, as JAX's does). Needs a CUDA card. No table is committed: without one every launch takes
the default tile.
"""

from __future__ import annotations

import argparse

from sam_quantization_tpu_torch.ops import autotune


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="vit_h")
    ap.add_argument("--m", type=int, nargs="+", default=[4096],
                    help="M values to tune (ViT-H runs 4900 windowed-padded "
                         "and 4096 global)")
    ap.add_argument("--bits", type=int, nargs="+", default=[4])
    ap.add_argument("--groupsize", type=int, default=128)
    ap.add_argument("--dtype", choices=sorted(autotune.DTYPES), default="bf16",
                    help="the activations' type: bf16 (JAX's keys) or f32 (keys + 'f32')")
    ap.add_argument("--table", default=autotune._TABLE_PATH, help="the table file to update")
    args = ap.parse_args(argv)
    for m in args.m:
        for bits in args.bits:
            table = autotune.tune_model_shapes(
                args.model, M=m, bits=bits, groupsize=args.groupsize,
                dtype=autotune.DTYPES[args.dtype], path=args.table,
            )
    print(f"saved {len(table)} entries")


if __name__ == "__main__":
    main()
