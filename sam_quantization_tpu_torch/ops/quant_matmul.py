"""Weight-only dequant-matmul on packed low-bit weights: CUDA kernel and its
plain PyTorch version.

Counterpart of ``sam_quantization_tpu/ops/quant_matmul.py`` (weight-only
parts). :func:`quant_matmul` computes ``x (M, K) @ dequant(p) (K, N)`` in
x's dtype: the packed words are unpacked with shift and mask, dequantized as
``(q - z_g) * s_g`` in float32, rounded to x's dtype, and multiplied with
float32 accumulation. Two kernels of ``csrc/quant_matmul.cu`` carry it:

* ``quant_matmul`` - bits 2, 4, 8 (replaces ``_qmm_kernel``);
* ``quant_matmul3`` - split-plane 3-bit, ``low2 | (hi1 << 2)`` (replaces
  ``_qmm_kernel3``).

The kernels take every shape: ragged M and N are masked in the kernel, and
scales are indexed by ``k // groupsize`` directly. ``kernel_supported`` and
the M padding and scale broadcasting of ``quant_matmul_pallas`` are TPU
tiling rules with no counterpart here.

The wrapper launches a kernel for a CUDA tensor and uses the plain version
only for a CPU tensor. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Dict

import torch

from sam_quantization_tpu_torch.nn.packed import PackedLinear, dequantize
from sam_quantization_tpu_torch.ops import _build

LAUNCHES: Dict[str, int] = {"quant_matmul": 0, "quant_matmul3": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_weight_only(p: PackedLinear, what: str) -> None:
    if p.act_bits == 8:
        raise NotImplementedError(
            f"{what}: int8-activation (W-A8) layers are not ported yet; they come "
            "with the W-A8 slice (ROADMAP Queue 2 items 6-7)"
        )


def check_cuda_operands(name: str, x: torch.Tensor, *packed: PackedLinear) -> None:
    """What the kernels take: float32/bfloat16 x, contiguous, on one device."""
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32 or bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    for p in packed:
        for t in (p.qweight, p.qweight_hi, p.scales, p.zeros):
            if t is None:
                continue
            if t.device != x.device:
                raise ValueError(f"{name}: weights on {t.device}, x on {x.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: packed buffers must be contiguous")


def quant_matmul_plain(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """Plain PyTorch version: dequantize in float32, round to x's dtype,
    multiply with float32 accumulation, cast (``quant_matmul_xla``)."""
    w = dequantize(p, torch.float32).to(x.dtype)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def quant_matmul(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """``x (M, K) @ dequant(p) (K, N) -> (M, N)`` in x's dtype."""
    check_weight_only(p, "quant_matmul")
    M, K = x.shape
    if K != p.in_features:
        raise ValueError(f"quant_matmul: x has K={K}, the layer {p.in_features}")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: no kernel for {x.device}")
    name = "quant_matmul3" if p.bits == 3 else "quant_matmul"
    check_cuda_operands(name, x, p)
    N = p.out_features
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    hi = p.qweight_hi.data_ptr() if p.bits == 3 else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "quant_matmul", _build.DTYPE_CODE[x.dtype], p.bits, x.data_ptr(),
            p.qweight.data_ptr(), hi, p.scales.data_ptr(), p.zeros.data_ptr(), out.data_ptr(),
            M, K, N, p.groupsize, p.pack_block, stream,
        )
    LAUNCHES[name] += 1
    return out
