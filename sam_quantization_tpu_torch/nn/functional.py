"""NN primitives on tensors, NHWC like the JAX package.

Counterpart of ``sam_quantization_tpu/nn/functional.py`` (dense parts and
the quantized linear, :func:`quant_linear`).
Parameters keep the upstream ``segment_anything`` torch layout: linear
weights are ``(out, in)``, convolutions ``OIHW``, transposed convolutions
``(I, O, kh, kw)``. Activations stay NHWC at every function, so each result
can be held against its JAX counterpart element for element.

Compute dtype follows the input: weights are cast to ``x.dtype`` at use,
LayerNorm statistics are always float32, and GELU is the erf form in float32
and the tanh form in bfloat16 (the JAX package's rule, which parity needs).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as TF

Pair = Union[int, Tuple[int, int]]


def _pair(v: Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
    """``x @ weight.T + bias`` with the weight cast to ``x.dtype``."""
    y = torch.matmul(x, weight.to(x.dtype).t())
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def quant_linear(x: torch.Tensor, p) -> torch.Tensor:
    """Quantized linear: a :class:`~sam_quantization_tpu_torch.nn.packed.PackedLinear`
    runs the dequant-matmul on x's rows, an
    :class:`~sam_quantization_tpu_torch.nn.packed.IntLinear` the cached int8
    product; then the float32 bias cast to the output dtype (the JAX
    ``quant_linear``)."""
    y = linear_product(x, p)
    if p.bias is not None:
        y = y + p.bias.to(y.dtype)
    return y


def linear_product(x: torch.Tensor, layer) -> torch.Tensor:
    """``x @ W`` of a ``Linear``, ``PackedLinear`` or ``IntLinear``, without
    its bias: the partial product a row-parallel shard sums over its ranks
    before the bias is added once (``parallel/mesh.row_parallel``)."""
    from sam_quantization_tpu_torch.nn.packed import IntLinear, PackedLinear
    from sam_quantization_tpu_torch.ops import quant_matmul

    if not isinstance(layer, (PackedLinear, IntLinear)):
        return torch.matmul(x, layer.weight.to(x.dtype).t())
    lead = x.shape[:-1]
    mm = quant_matmul.int8_matmul if isinstance(layer, IntLinear) else quant_matmul.quant_matmul
    return mm(x.reshape(-1, x.shape[-1]), layer).reshape(*lead, layer.out_features)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_2d(x, weight, bias, eps: float = 1e-6) -> torch.Tensor:
    """Channel LayerNorm on NHWC tensors: channels are last, so this is
    :func:`layer_norm`."""
    return layer_norm(x, weight, bias, eps)


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: Pair = 1,
    padding: Pair = 0,
) -> torch.Tensor:
    """NHWC convolution with an OIHW weight.

    A non-overlapping patch convolution (kernel == stride, no padding: SAM's
    16x16 patch embed, the 2x2 mask downscalers and every 1x1 conv) is
    space-to-depth followed by one matrix product, as in the JAX package.
    """
    stride, padding = _pair(stride), _pair(padding)
    O, I, kh, kw = weight.shape
    B, H, W, C = x.shape
    w = weight.to(x.dtype)
    if (kh, kw) == stride and padding == (0, 0) and H % kh == 0 and W % kw == 0:
        xp = x.reshape(B, H // kh, kh, W // kw, kw, C)
        xp = xp.permute(0, 1, 3, 2, 4, 5).reshape(B, H // kh, W // kw, kh * kw * C)
        y = torch.matmul(xp, w.permute(2, 3, 1, 0).reshape(kh * kw * I, O))
    else:
        y = TF.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding)
        y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def conv_transpose2d(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
    stride: int = 2,
) -> torch.Tensor:
    """NHWC transposed convolution with kernel == stride, as a block-wise
    linear expansion. ``weight`` is torch's ``(I, O, kh, kw)``."""
    cin, cout, kh, kw = weight.shape
    if kh != stride or kw != stride:
        raise ValueError(f"only kernel == stride is supported, got {kh}x{kw}/{stride}")
    B, H, W, _ = x.shape
    w = weight.to(x.dtype).permute(2, 3, 0, 1)  # (kh, kw, I, O)
    y = torch.einsum("bhwi,pqio->bhpwqo", x, w).reshape(B, H * kh, W * kw, cout)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def gelu(x: torch.Tensor) -> torch.Tensor:
    """erf GELU in float32, tanh GELU in bfloat16 (the JAX package's rule)."""
    if x.dtype == torch.bfloat16:
        return TF.gelu(x, approximate="tanh")
    return TF.gelu(x)


def mlp_block(x, lin1, lin2, act=gelu) -> torch.Tensor:
    """lin1 -> act -> lin2 (ref segment_anything/modeling/common.py:13-27);
    ``lin1`` / ``lin2`` are ``Linear`` or ``PackedLinear`` modules."""
    return lin2(act(lin1(x)))


# ---------------------------------------------------------------------------
# Initializers: torch-compatible bounds, seeded by a torch.Generator on the
# parameter's device (so full-width random models build on the card).
# ---------------------------------------------------------------------------


def _uniform(shape: Sequence[int], bound: float, gen: torch.Generator, device):
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return out.uniform_(-bound, bound, generator=gen)


def init_linear(gen, in_features: int, out_features: int, bias: bool = True, device="cpu"):
    """``(weight (out, in), bias (out,) or None)``, U(-1/sqrt(in), 1/sqrt(in))."""
    bound = 1.0 / math.sqrt(in_features)
    w = _uniform((out_features, in_features), bound, gen, device)
    b = _uniform((out_features,), bound, gen, device) if bias else None
    return w, b


def init_conv2d(gen, kh: int, kw: int, cin: int, cout: int, bias: bool = True, device="cpu"):
    """``(weight OIHW, bias or None)``, U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(kh * kw * cin)
    w = _uniform((cout, cin, kh, kw), bound, gen, device)
    b = _uniform((cout,), bound, gen, device) if bias else None
    return w, b


def init_layer_norm(dim: int, device="cpu"):
    return (
        torch.ones(dim, dtype=torch.float32, device=device),
        torch.zeros(dim, dtype=torch.float32, device=device),
    )


def init_embedding(gen, num: int, dim: int, device="cpu") -> torch.Tensor:
    out = torch.empty((num, dim), dtype=torch.float32, device=device)
    return out.normal_(generator=gen)
