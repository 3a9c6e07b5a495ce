"""Integer LayerNorm (PTF) and Log-Int-Softmax on tensors.

Counterpart of ``sam_quantization_tpu/quant/fq/int_ops.py``: the math of
fq_vit layers.py:259-303 (QIntLayerNorm) and :337-398 (QIntSoftmax, i-exp
from I-BERT with FQ-ViT's log2 output quantizer), with the integer paths
enabled. Integers are simulated in float32 in the JAX package's op order,
because ``floor``, ``round`` and ``log2`` decide bits. Constants are divided
by as float32 tensors on the input's device, never as Python numbers: a
Python divisor is a reciprocal product on CUDA and a true division on the
CPU, while the JAX package divides (eagerly) in float32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sam_quantization_tpu_torch.quant.bit_type import BitType
from sam_quantization_tpu_torch.quant.quantizers import _exp2, _log2, log_round


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a float32 tensor on ``like``'s device."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def get_mn(x: torch.Tensor, bit: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decompose positive x ~= M / 2^N with M < 2^bit (layers.py:251-255)."""
    n = torch.clamp(bit - 1 - torch.floor(_log2(x)), 0, 31)
    m = torch.clamp(torch.floor(x * _exp2(n)), 0, 2**bit - 1)
    return m, n


def int_layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    in_scale,
    out_scale,
    in_scale_expand: int = 1,
) -> torch.Tensor:
    """Integer LayerNorm with PTF channel re-scaling (layers.py:259-303).

    ``in_scale``: the per-channel PTF scales of the input quantizer (power-of-
    two multiples of their minimum); ``out_scale``: the output quantizer's
    scale (scalar or per channel)."""
    xf = x.float()
    C = xf.shape[-1]
    in_scale = torch.broadcast_to(_f32(in_scale, xf), (C,))
    if in_scale_expand != 1:
        in_scale = torch.repeat_interleave(in_scale[: C // in_scale_expand], in_scale_expand)
    out_scale = _f32(out_scale, xf)
    weight, bias = weight.float(), bias.float()

    x_q = torch.round(xf / in_scale)
    in_scale1 = in_scale.min()
    in_scale_mask = torch.round(in_scale / in_scale1)  # 2^alpha per channel
    x_q = x_q * in_scale_mask

    c = _f32(C, xf)
    # jnp.mean is the sum times float32(1 / C), as XLA folds the division
    mean_x_q = x_q.sum(dim=-1) * _f32(1.0 / C, xf) * in_scale1
    sum_sq = torch.sum(x_q.square(), dim=-1)
    sum_x = torch.sum(x_q, dim=-1)
    std_x_q = (in_scale1 / c) * torch.sqrt(torch.clamp(c * sum_sq - sum_x.square(), min=1e-12))

    a = (in_scale1 / std_x_q)[..., None] * weight / out_scale
    m, n = get_mn(torch.abs(a))
    scale_n = _exp2(n)
    b = torch.round((bias - (mean_x_q / std_x_q)[..., None] * weight) / out_scale * scale_n)
    x_q = torch.round((torch.sign(a) * m * x_q + b) / scale_n)
    return (x_q * out_scale).to(x.dtype)


# i-exp constants (layers.py:348-375)
_A, _B, _C = 0.35815147, 0.96963238, 1.0
_X0 = -0.6931  # -ln 2
_N = 30


def int_softmax_core(x: torch.Tensor, scaling_factor) -> Tuple[torch.Tensor, torch.Tensor]:
    """i-exp integer softmax numerator and denominator (layers.py:348-375):
    polynomial i-exp with coefficients 0.35815147 / 0.96963238 / 1.0,
    x0 = -ln 2, n = 30."""
    sf = _f32(scaling_factor, x)
    b_int = torch.floor(_f32(_B / _A, x) / sf)
    c_int = torch.floor(_f32(_C / _A, x) / sf.square())
    x0_int = torch.floor(_f32(_X0, x) / sf)

    x_int = x.float() / sf
    x_int = x_int - torch.amax(x_int, dim=-1, keepdim=True)
    x_int = torch.maximum(x_int, _N * x0_int)
    q = torch.floor(x_int / x0_int)
    r = x_int - x0_int * q
    z = r * (r + b_int) + c_int
    del x_int, r
    exp_int = torch.floor(z.mul_(_exp2(_N - q))).clamp_(min=0.0)
    return exp_int, torch.sum(exp_int, dim=-1, keepdim=True)


def log_int_softmax(x: torch.Tensor, scaling_factor, bt: BitType) -> torch.Tensor:
    """The whole LIS: i-exp softmax and log2 output quantization
    (layers.py:377-390): ``softmax ~= 2^-round(log2(sum / exp))`` in
    ``bt.bits`` bits, a ratio past the grid flushed to exactly 0."""
    exp_int, exp_int_sum = int_softmax_core(x, scaling_factor)
    ratio = torch.round(exp_int_sum / exp_int.clamp_(min=1.0))
    del exp_int
    rounds = log_round(ratio)
    out = _exp2(rounds.clamp(0, 2**bt.bits - 1).neg_())
    return out.masked_fill_(rounds >= 2**bt.bits, 0.0).to(x.dtype)
