"""Dequant-matmul on packed low-bit weights: CUDA kernels and their plain
PyTorch versions.

Counterpart of ``sam_quantization_tpu/ops/quant_matmul.py`` (the
``PackedLinear`` parts; ``int8_matmul`` of the cached-int8 mode is not
ported yet). :func:`quant_matmul` computes ``x (M, K) @ dequant(p) (K, N)``
in x's dtype and picks the path by the layer's fields, as JAX does.

Weight-only layers (``act_bits == 0``): the packed words are unpacked with
shift and mask, dequantized as ``(q - z_g) * s_g`` in float32, rounded to
x's dtype, and multiplied with float32 accumulation. Two kernels of
``csrc/quant_matmul.cu`` carry it:

* ``quant_matmul`` - bits 2, 4, 8 (replaces ``_qmm_kernel``);
* ``quant_matmul3`` - split-plane 3-bit, ``low2 | (hi1 << 2)`` (replaces
  ``_qmm_kernel3``).

Int8-activation layers (``act_bits == 8``, W-A8): x is quantized per token
(:func:`quantize_activations_int8`, plain torch ops as XLA ops in JAX), and
the integer product runs on the int8 tensor cores, one int32 sum per
segment (a scale group cut at the kernel's 128-row K tiles), scaled in
float32 and summed in K order; the token scale multiplies last. Two kernels
of ``csrc/quant_matmul_a8.cu`` carry it, for bits 2, 4, 8:

* ``quant_matmul_a8_sym`` - symmetric grids, ``d * s_g`` with the weights
  less ``mid = 2**(bits - 1)`` (replaces ``_qmm_a8_sym_kernel``);
* ``quant_matmul_a8`` - any grid, ``(d - (z_g - off) * rowsum_g(xq)) * s_g``
  with the weights less ``off`` (128 at 8 bits, else 0) (replaces
  ``_qmm_a8_kernel``).

Split-plane 3-bit W-A8 layers take :func:`quant_matmul_a8_sym_native` (sym)
or :func:`quant_matmul_a8_xla` (asym), plain torch ops as the XLA paths
they are in JAX. JAX on a TPU also sends symmetric layers with at most 4
groups to XLA's native int8 dot, because Mosaic's in-kernel int8 dot misses
the TPU's double-rate mode; that is a TPU finding with no Hopper meaning,
so here every symmetric 2/4/8-bit layer runs its kernel.

The kernels take every shape: ragged M and N are masked in the kernel, and
scales are indexed by ``k // groupsize`` directly. ``kernel_supported`` and
the M padding and scale broadcasting of the Pallas wrappers are TPU tiling
rules with no counterpart here. The W-A8 kernels also need a group to be a
whole number of their 32-deep k steps: ``groupsize % 32 == 0``, or one
group over all of K.

The wrappers launch a kernel for a CUDA tensor and use the plain version
only for a CPU tensor. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from sam_quantization_tpu_torch.nn.packed import PackedLinear, dequantize, unpack_to_int
from sam_quantization_tpu_torch.ops import _build

LAUNCHES: Dict[str, int] = {
    "quant_matmul": 0, "quant_matmul3": 0, "quant_matmul_a8_sym": 0, "quant_matmul_a8": 0,
}
A8_TILE_K = 128  # K rows per tile of the W-A8 kernels (KT in csrc/quant_common.cuh)
A8_STEP_K = 32  # k of one int8 mma.m16n8k32


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_packed_on(name: str, device: torch.device, *packed: PackedLinear) -> None:
    """The packed buffers must be contiguous and on ``device``."""
    for p in packed:
        for t in (p.qweight, p.qweight_hi, p.scales, p.zeros):
            if t is None:
                continue
            if t.device != device:
                raise ValueError(f"{name}: weights on {t.device}, x on {device}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: packed buffers must be contiguous")


def check_cuda_operands(name: str, x: torch.Tensor, *packed: PackedLinear) -> None:
    """What the kernels take: float32/bfloat16 x, contiguous, on one device."""
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32 or bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    check_packed_on(name, x.device, *packed)


def quant_matmul_plain(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """Plain PyTorch version: dequantize in float32, round to x's dtype,
    multiply with float32 accumulation, cast (``quant_matmul_xla``)."""
    w = dequantize(p, torch.float32).to(x.dtype)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def quant_matmul(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """``x (M, K) @ dequant(p) (K, N) -> (M, N)`` in x's dtype, by the path
    the layer's ``act_bits``, ``bits`` and ``sym`` select."""
    M, K = x.shape
    if K != p.in_features:
        raise ValueError(f"quant_matmul: x has K={K}, the layer {p.in_features}")
    if p.act_bits == 8:
        if p.bits == 3:
            return quant_matmul_a8_sym_native(x, p) if p.sym else quant_matmul_a8_xla(x, p)
        return quant_matmul_a8_sym(x, p) if p.sym else quant_matmul_a8(x, p)
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


# ---------------------------------------------------------------------------
# Int8 activations (W-A8)
# ---------------------------------------------------------------------------


def quantize_activations_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-token int8 quantization: ``(xq int8 (M, K),
    scale float32 (M, 1))``, bit for bit the JAX function: float32 first,
    the amax clamped at 1e-8, a multiply by the reciprocal (a divide would
    round some half-way points the other way), round half to even."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    xq = torch.clamp(torch.round(xf * (1.0 / scale)), -127, 127).to(torch.int8)
    return xq, scale


def a8_offset(bits: int, sym: bool) -> int:
    """What the W-A8 kernels subtract from a grid value before it is narrowed
    to int8: ``mid`` for the symmetric kernel, ``off`` for the other."""
    if sym:
        return 1 << (bits - 1)
    return 128 if bits == 8 else 0


def a8_segments(K: int, groupsize: int) -> List[Tuple[int, int]]:
    """The ``[start, end)`` K ranges whose int32 sums the W-A8 kernels turn
    into float32 one at a time: the scale groups cut at the 128-row K tiles."""
    cuts = sorted({*range(0, K, groupsize), *range(0, K, A8_TILE_K), K})
    return list(zip(cuts[:-1], cuts[1:]))


def a8_matmul_plain(xq: torch.Tensor, xs: torch.Tensor, p: PackedLinear,
                    dtype: torch.dtype, sym: bool) -> torch.Tensor:
    """Plain PyTorch version of both W-A8 kernels, in their order: per
    segment the exact integer dot (float64 holds it; it is below 2**24, so
    float32 holds it too), ``d * s_g`` (sym) or ``(d - (z_g - off) *
    rowsum) * s_g`` added to a float32 sum, then the token scale, then the
    cast to ``dtype``."""
    sub = a8_offset(p.bits, sym)
    w = (unpack_to_int(p) - sub).to(torch.float64)
    xd = xq.to(torch.float64)
    acc = torch.zeros((xq.shape[0], p.out_features), dtype=torch.float32, device=xq.device)
    for a, b in a8_segments(p.in_features, p.groupsize):
        g = a // p.groupsize
        d = torch.matmul(xd[:, a:b], w[a:b]).to(torch.float32)
        if sym:
            term = d * p.scales[g]
        else:
            rs = xq[:, a:b].sum(dim=1, keepdim=True, dtype=torch.int32).to(torch.float32)
            term = (d - (p.zeros[g] - sub) * rs) * p.scales[g]
        acc = acc + term
    return (acc * xs).to(dtype)


def a8_matmul(xq: torch.Tensor, xs: torch.Tensor, p: PackedLinear, dtype: torch.dtype,
              sym: bool) -> torch.Tensor:
    """A W-A8 kernel on activations already quantized (``xq`` int8 (M, K),
    ``xs`` float32 (M, 1)): the symmetric one if ``sym``, else the other;
    the output (M, N) is in ``dtype``, float32 or bfloat16."""
    name = "quant_matmul_a8_sym" if sym else "quant_matmul_a8"
    M, K = xq.shape
    if K != p.in_features:
        raise ValueError(f"{name}: xq has K={K}, the layer {p.in_features}")
    if p.bits == 3:
        raise ValueError(f"{name}: split-plane 3-bit layers have no W-A8 kernel "
                         "(quant_matmul runs quant_matmul_a8_sym_native or quant_matmul_a8_xla)")
    if sym and not p.sym:
        raise ValueError(f"{name}: the layer's grid is not symmetric")
    if xq.device.type == "cpu":
        return a8_matmul_plain(xq, xs, p, dtype, sym)
    if xq.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {xq.device}")
    if dtype not in _build.DTYPE_CODE:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32 or bfloat16)")
    if xq.dtype != torch.int8 or xs.dtype != torch.float32 or xs.numel() != M:
        raise TypeError(f"{name}: xq must be int8 (M, K) and xs float32 (M, 1)")
    if not (xq.is_contiguous() and xs.is_contiguous()):
        raise ValueError(f"{name}: xq and xs must be contiguous")
    if xs.device != xq.device:
        raise ValueError(f"{name}: xs on {xs.device}, xq on {xq.device}")
    if p.groupsize % A8_STEP_K and p.groupsize != K:
        raise ValueError(f"{name}: groupsize {p.groupsize} is not a multiple of "
                         f"{A8_STEP_K} (the kernel's k step) nor all of K={K}")
    check_packed_on(name, xq.device, p)
    N = p.out_features
    out = torch.empty((M, N), dtype=dtype, device=xq.device)
    if M == 0:
        return out
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "quant_matmul_a8", _build.DTYPE_CODE[dtype], p.bits, int(sym), xq.data_ptr(),
            xs.data_ptr(), p.qweight.data_ptr(), p.scales.data_ptr(),
            None if sym else p.zeros.data_ptr(), out.data_ptr(), M, K, N, p.groupsize,
            p.pack_block, stream,
        )
    LAUNCHES[name] += 1
    return out


def quant_matmul_a8_sym(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """Symmetric W-A8 (``_quant_matmul_a8_sym``): quantize x per token, then
    the symmetric kernel; output in x's dtype."""
    xq, xs = quantize_activations_int8(x)
    return a8_matmul(xq, xs, p, x.dtype, sym=True)


def quant_matmul_a8(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """Asymmetric W-A8 (``_quant_matmul_a8_asym``): quantize x per token,
    then the zero-point kernel; output in x's dtype."""
    xq, xs = quantize_activations_int8(x)
    return a8_matmul(xq, xs, p, x.dtype, sym=False)


def quant_matmul_a8_xla(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """The JAX package's float32 simulation of W-A8: the quantized
    activations times the dequantized float32 weight, times the token scale."""
    xq, xs = quantize_activations_int8(x)
    y = torch.matmul(xq.float(), dequantize(p, torch.float32))
    return (y * xs).to(x.dtype)


def quant_matmul_a8_sym_native(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """Symmetric W-A8 as JAX's native int8 dot: one exact integer dot per
    scale group (in float64, which holds it), each rounded to float32 as
    JAX's int32 result is, scaled per group and summed, times the token
    scale."""
    if not p.sym:
        raise ValueError("quant_matmul_a8_sym_native: the layer's grid is not symmetric")
    xq, xs = quantize_activations_int8(x)
    w = (unpack_to_int(p) - (1 << (p.bits - 1))).to(torch.float64)
    K, N = w.shape
    G = p.num_groups
    xd = xq.to(torch.float64)
    if G == 1:
        y = torch.matmul(xd, w).to(torch.float32) * p.scales[0]
    else:
        acc = torch.matmul(xd.reshape(-1, G, K // G).transpose(0, 1), w.reshape(G, K // G, N))
        y = torch.einsum("gmn,gn->mn", acc.to(torch.float32), p.scales)
    return (y * xs).to(x.dtype)
