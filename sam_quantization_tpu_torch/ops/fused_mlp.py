"""Fused quantized MLP: dequant-lin1 -> tanh GELU -> dequant-lin2 in one kernel
call, and its plain PyTorch version.

Counterpart of ``sam_quantization_tpu/ops/fused_mlp.py`` (replaces
``_fused_mlp_kernel``). The C function runs two launches of one body, the
tensor-core body in bfloat16 (``csrc/qmm_tc.cuh``) and the register-tiled
FFMA body in float32 (``csrc/qmm_f32.cuh``), the first with the GELU
epilogue into an (M, H) scratch tensor in x's dtype that the wrapper
allocates, the second from it. The numerics are
the TPU kernel's, in its order:
``h = gelu_tanh(x @ W1 + b1)`` in float32, rounded to x's dtype, then
``h @ W2`` with float32 accumulation, rounded to x's dtype; ``b2`` is added
outside the kernel in x's dtype. The GELU is always the tanh form, where
the unfused path uses erf in float32, so whether an MLP fuses changes its
numbers: :func:`fused_mlp_supported` is the JAX package's rule, unchanged,
and the encoder fuses exactly where JAX on a TPU does. A pair that does not
meet it (3-bit, int8 activations, other widths) runs the unfused sequence
of layers, as JAX's ``fused_mlp`` does.

The wrapper launches the kernel for a CUDA tensor and uses the plain version
only for a CPU tensor. ``LAUNCHES`` counts calls of the kernel's C function
(one per wrapper call, whatever the launches inside it).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from sam_quantization_tpu_torch.nn import functional as F
from sam_quantization_tpu_torch.nn.packed import PackedLinear, dequantize
from sam_quantization_tpu_torch.ops import _build
from sam_quantization_tpu_torch.ops import quant_matmul as qm

LAUNCHES: Dict[str, int] = {"fused_mlp": 0}
_SQRT_2_OVER_PI = math.sqrt(2 / math.pi)


def reset_launch_counts() -> None:
    LAUNCHES["fused_mlp"] = 0


def fused_mlp_supported(p1, p2) -> bool:
    """The JAX package's eligibility rule (``fused_mlp.py:94-107``)."""
    if not (isinstance(p1, PackedLinear) and isinstance(p2, PackedLinear)):
        return False
    if p1.bits != p2.bits or p1.bits == 3 or p1.act_bits or p2.act_bits:
        return False
    H = p1.out_features
    return (
        H == p2.in_features
        and H % 512 == 0
        and p1.in_features % p1.pack_block == 0
        and p2.out_features % 128 == 0
    )


def gelu_tanh(a: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(a, approximate=True)`` in its order of operations."""
    return a * (0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (a + 0.044715 * (a * a * a)))))


def fused_mlp_plain(x: torch.Tensor, p1: PackedLinear, p2: PackedLinear) -> torch.Tensor:
    """Plain PyTorch version of the kernel on x (M, K), without b2."""
    w1 = dequantize(p1).to(x.dtype).float()
    w2 = dequantize(p2).to(x.dtype).float()
    a = torch.matmul(x.float(), w1)
    if p1.bias is not None:
        a = a + p1.bias
    h = gelu_tanh(a).to(x.dtype)
    return torch.matmul(h.float(), w2).to(x.dtype)


def fused_mlp(x: torch.Tensor, p1: PackedLinear, p2: PackedLinear) -> torch.Tensor:
    """``lin2(gelu(lin1(x)))`` with both linears packed. x: (..., K).

    A pair that meets :func:`fused_mlp_supported` runs the fused kernel
    (tanh GELU); any other pair runs the JAX package's unfused sequence:
    ``quant_matmul`` (the W-A8 kernels for int8-activation layers), bias,
    :func:`~sam_quantization_tpu_torch.nn.functional.gelu` (erf in float32,
    tanh in bfloat16), ``quant_matmul``, bias."""
    if not (isinstance(p1, PackedLinear) and isinstance(p2, PackedLinear)):
        raise TypeError("fused_mlp: both layers must be PackedLinear")
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    M, H, N = x2.shape[0], p1.out_features, p2.out_features
    if not fused_mlp_supported(p1, p2):
        h = qm.quant_matmul(x2, p1)
        if p1.bias is not None:
            h = h + p1.bias.to(h.dtype)
        y = qm.quant_matmul(F.gelu(h), p2)
        if p2.bias is not None:
            y = y + p2.bias.to(y.dtype)
        return y.reshape(*lead, N)
    if x.device.type == "cpu":
        out = fused_mlp_plain(x2, p1, p2)
    elif x.device.type != "cuda":
        raise ValueError(f"fused_mlp: no kernel for {x.device}")
    else:
        x2 = x2.contiguous()
        qm.check_cuda_operands("fused_mlp", x2, p1, p2)
        b1 = p1.bias if p1.bias is not None else torch.zeros(H, device=x.device)
        out = torch.empty((M, N), dtype=x.dtype, device=x.device)
        if M:
            hidden = torch.empty((M, H), dtype=x.dtype, device=x.device)  # h between launches
            with torch.cuda.device(x.device):
                stream = torch.cuda.current_stream().cuda_stream
                _build.launch(
                    "fused_mlp", _build.DTYPE_CODE[x.dtype], p1.bits, x2.data_ptr(),
                    p1.qweight.data_ptr(), p1.scales.data_ptr(), p1.zeros.data_ptr(),
                    b1.data_ptr(), p2.qweight.data_ptr(), p2.scales.data_ptr(),
                    p2.zeros.data_ptr(), out.data_ptr(), hidden.data_ptr(), M, K, H, N,
                    p1.groupsize, p1.pack_block, p2.groupsize, p2.pack_block, stream,
                )
            LAUNCHES["fused_mlp"] += 1
    if p2.bias is not None:
        out = out + p2.bias.to(out.dtype)
    return out.reshape(*lead, N)
