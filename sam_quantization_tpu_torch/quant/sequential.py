"""Round-to-nearest quantization of the image encoder's block linears.

Counterpart of ``rtn_quantize_encoder`` in
``sam_quantization_tpu/quant/sequential.py`` (:230-249) and of the
``GPTQConfig`` fields it reads. The GPTQ solver, its calibration loop and the
per-layer overrides are not ported yet (ROADMAP, Queue 1, "GPTQ pipeline").
"""

from __future__ import annotations

import dataclasses

from sam_quantization_tpu_torch.models.image_encoder import BLOCK_LINEARS
from sam_quantization_tpu_torch.nn.packed import quantize_rtn


@dataclasses.dataclass(frozen=True)
class GPTQConfig:
    """The quantization grid: ``bits``, ``groupsize`` (-1 or 0: one group over
    all of K) and ``sym`` (symmetric grid, mid-point zero)."""

    bits: int = 4
    groupsize: int = -1
    sym: bool = False


def rtn_quantize_encoder(encoder, qcfg: GPTQConfig):
    """Swap ``attn.qkv``, ``attn.proj``, ``mlp.lin1`` and ``mlp.lin2`` of every
    block of ``encoder`` (an ``ImageEncoderViT``) for RTN-quantized
    ``PackedLinear`` layers, in place on the weights' device; returns it."""
    for block in encoder.blocks:
        for owner_name, name in BLOCK_LINEARS:
            owner = getattr(block, owner_name)
            lin = getattr(owner, name)
            # The port's Linear is (out, in); the packed layout is (in, out).
            setattr(owner, name, quantize_rtn(
                lin.weight.detach().float().t(), qcfg.bits, max(qcfg.groupsize, 0),
                qcfg.sym, bias=None if lin.bias is None else lin.bias.detach(),
            ))
    return encoder
