"""Dequant-matmul on packed low-bit weights: CUDA kernels and their plain
PyTorch versions.

Counterpart of ``sam_quantization_tpu/ops/quant_matmul.py``.
:func:`quant_matmul` computes ``x (M, K) @ dequant(p) (K, N)`` in x's dtype
for a ``PackedLinear`` and picks the path by the layer's fields, as JAX
does; :func:`int8_matmul` is the cached-int8 mode's product on an
``IntLinear``.

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
segment (a scale group cut at the kernels' K tiles, :func:`tile_rows`), scaled in
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

The kernels take every shape and every layout ``pack_int_weights`` writes:
ragged M and N are masked in the kernel, scales are indexed by ``k //
groupsize`` directly, and K is walked in tiles of whole pack blocks
(:func:`tile_rows`: 128 rows at pack block 128, 96 at 48, 120 at 12).
``kernel_supported`` and the M padding and scale broadcasting of the Pallas
wrappers are TPU tiling rules with no counterpart here. A group that ends
inside one of the W-A8 kernels' 32-deep k steps (``groupsize % 32 != 0``)
splits that step at the boundary, and so does a K tile of other than 128
rows (``csrc/quant_matmul_a8.cu``, its FINE build).

Cached-int8 layers (``IntLinear``) multiply int8 activations by the stored
int8 weights with ``torch._int_mm`` on either device: JAX leaves this
product to XLA's ``dot_general`` (no Pallas kernel), and the port leaves it
to PyTorch's int8 GEMM. ``INT8_MATMULS`` counts those calls, the ones on an
int8 input (int8-pre) apart.

Tiles: a weight-only launch takes the output tile a tuned table names for
its shape (:func:`pick_blocks`, JAX's, reading ``ops/autotune.py``'s
table); with no entry it takes the default tile, as with no table at all.
An entry that names no candidate tile of the shape raises ``ValueError``.
A W-A8 launch reads the same table (:func:`pick_blocks_a8`, under JAX's
bare key whatever its output dtype, as JAX's W-A8 wrappers call
``pick_blocks``), among the W-A8 tiles (``autotune.TILES_A8``); a layout
that takes the W-A8 kernels' FINE build (:func:`a8_main_build` false)
runs its one tile and ignores the table.

The wrappers launch a kernel for a CUDA tensor and use the plain version
only for a CPU tensor. ``LAUNCHES`` counts kernel launches, whatever the
tile; ``TILE_LAUNCHES`` counts the same launches by ``(name, dtype,
tile)``, the W-A8 ones by their output dtype. ``torch.export``
cannot trace a launch through ``ctypes``, so while it traces a CUDA tensor
the wrappers call the custom ops ``sam_quantization_tpu_torch::quant_matmul``
and ``::a8_matmul`` (:data:`KERNEL_OPS`) instead: the exported program
records the op, whose CUDA implementation is the same launch, so a program
exported on the card launches the kernel, as JAX's export on a TPU holds
``_qmm_kernel``. Outside an export the wrappers launch directly: a call
through a Python custom op costs far more host time than the launch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from sam_quantization_tpu_torch.nn.packed import (
    IntLinear, PackedLinear, dequantize, unpack_to_int,
)
from sam_quantization_tpu_torch.ops import _build, autotune

LAUNCHES: Dict[str, int] = {
    "quant_matmul": 0, "quant_matmul3": 0, "quant_matmul_a8_sym": 0, "quant_matmul_a8": 0,
}
# int8_matmul calls: on activations it quantizes, and on int8 input (int8-pre)
INT8_MATMULS: Dict[str, int] = {"int8_matmul": 0, "int8_matmul_pre": 0}
# packed-weight launches by tile: (name, dtype, (bm, bn, bk)) -> count (the
# W-A8 kernels by their output dtype)
TILE_LAUNCHES: Dict[Tuple[str, torch.dtype, Tuple[int, int, int]], int] = {}
MAX_TILE_K = 128  # most K rows of a tile of the packed-weight kernels (KT in csrc/quant_common.cuh)


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, INT8_MATMULS):
        for name in counts:
            counts[name] = 0
    TILE_LAUNCHES.clear()


def tile_rows(pack_block: int) -> int:
    """K rows of a tile of the packed-weight kernels (``tile_rows`` in
    ``csrc/quant_common.cuh``): the most whole pack blocks that fit in 128
    rows, an even number of them where the pack block is not a multiple of
    8, so that a tile starts on a 16-byte boundary of an x row."""
    n = MAX_TILE_K // pack_block
    if n > 1 and pack_block * n % 8:
        n -= 1
    return pack_block * n


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
    check_cuda_operands("quant_matmul3" if p.bits == 3 else "quant_matmul", x, p)
    args = (x, p.qweight, p.qweight_hi if p.bits == 3 else None, p.scales, p.zeros, p.bits,
            p.groupsize, p.pack_block, p.out_features)
    if torch.compiler.is_exporting():
        return quant_matmul_op(*args)
    return _launch_quant_matmul(*args)


def pick_blocks(M: int, N: int, K: int, groupsize: int, pack_block: int, bits: int = 4,
                dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int, int]:
    """(bm, bn, bk) of a weight-only launch: the tuned table's entry first
    (``ops/autotune.py``, looked up with ``groupsize if groupsize < K else
    0``, as JAX's ``pick_blocks`` does), else the default tile. Raises
    ``ValueError`` if the entry names no candidate tile."""
    gk = groupsize if groupsize < K else 0
    cands = autotune.candidate_blocks(M, N, K, groupsize, pack_block, dtype)
    hit = autotune.lookup(M, K, N, gk, bits, dtype)
    if hit is not None and hit not in cands:
        raise ValueError(f"autotune table entry {autotune._key(M, K, N, gk, bits, dtype)}: "
                         f"{hit} is not a candidate tile {cands}")
    return hit if hit is not None else cands[0]


def _launch_quant_matmul(x: torch.Tensor, qweight: torch.Tensor,
                         qweight_hi: Optional[torch.Tensor], scales: torch.Tensor,
                         zeros: torch.Tensor, bits: int, groupsize: int, pack_block: int,
                         out_features: int) -> torch.Tensor:
    """Launch ``quant_matmul`` (``quant_matmul3`` at 3 bits) on checked CUDA
    operands, at :func:`pick_blocks`'s tile."""
    M, K = x.shape
    tile = pick_blocks(M, out_features, K, groupsize, pack_block, bits, x.dtype)
    return _launch(x, qweight, qweight_hi, scales, zeros, bits, groupsize, pack_block,
                   out_features, tile)


def _launch(x, qweight, qweight_hi, scales, zeros, bits, groupsize, pack_block, out_features,
            tile: Tuple[int, int, int]) -> torch.Tensor:
    """``samq_quant_matmul`` at ``tile``, counted in ``LAUNCHES`` and
    ``TILE_LAUNCHES``."""
    M, K = x.shape
    out = torch.empty((M, out_features), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    hi = qweight_hi.data_ptr() if bits == 3 else None
    with torch.cuda.device(x.device):
        _build.launch(
            "quant_matmul", _build.DTYPE_CODE[x.dtype], bits, x.data_ptr(), qweight.data_ptr(),
            hi, scales.data_ptr(), zeros.data_ptr(), out.data_ptr(), M, K, out_features,
            groupsize, pack_block, *tile, torch.cuda.current_stream().cuda_stream,
        )
    name = "quant_matmul3" if bits == 3 else "quant_matmul"
    LAUNCHES[name] += 1
    key = (name, x.dtype, tuple(tile))
    TILE_LAUNCHES[key] = TILE_LAUNCHES.get(key, 0) + 1
    return out


def quant_matmul_tiled(x: torch.Tensor, p: PackedLinear,
                       tile: Tuple[int, int, int]) -> torch.Tensor:
    """A weight-only layer's product at a given tile ``(bm, bn, bk)`` (the
    tuner's launch): on a CUDA tensor the kernel, which refuses a tile it
    was not built for (``RuntimeError``); on a CPU tensor the plain
    version, which has no tiles."""
    if p.act_bits:
        raise ValueError("quant_matmul_tiled: tiles are the weight-only kernels'")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, p)
    check_cuda_operands("quant_matmul3" if p.bits == 3 else "quant_matmul", x, p)
    return _launch(x, p.qweight, p.qweight_hi, p.scales, p.zeros, p.bits, p.groupsize,
                   p.pack_block, p.out_features, tuple(tile))


quant_matmul_op = torch.library.custom_op(
    "sam_quantization_tpu_torch::quant_matmul", _launch_quant_matmul, mutates_args=(),
    device_types="cuda")


@quant_matmul_op.register_fake
def _(x, qweight, qweight_hi, scales, zeros, bits, groupsize, pack_block, out_features):
    return x.new_empty((x.shape[0], out_features))


# ---------------------------------------------------------------------------
# Int8 activations (W-A8)
# ---------------------------------------------------------------------------


def true_divide(a: torch.Tensor, d: float) -> torch.Tensor:
    """``a / d`` rounded as one IEEE division on every device. PyTorch's CUDA
    kernels divide by a Python scalar as a multiply by its reciprocal, which
    may land one ulp away from the CPU's (and JAX's) quotient."""
    return a / torch.full((), d, dtype=a.dtype, device=a.device)


def quantize_activations_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-token int8 quantization: ``(xq int8 (M, K),
    scale float32 (M, 1))``, bit for bit the JAX function: float32 first,
    the amax clamped at 1e-8, a multiply by the reciprocal (a divide would
    round some half-way points the other way), round half to even, on
    either device (:func:`true_divide`). ``amax`` (float32 (M, 1)): the
    token abs-max to quantize at where the token is wider than ``x`` (a
    row-parallel shard's slice, its amax reduced over the group); by
    default x's own."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = true_divide(torch.clamp_min(amax, 1e-8), 127.0)
    xq = torch.clamp(torch.round(xf * (1.0 / scale)), -127, 127).to(torch.int8)
    return xq, scale


def a8_offset(bits: int, sym: bool) -> int:
    """What the W-A8 kernels subtract from a grid value before it is narrowed
    to int8: ``mid`` for the symmetric kernel, ``off`` for the other."""
    if sym:
        return 1 << (bits - 1)
    return 128 if bits == 8 else 0


def a8_segments(K: int, groupsize: int, pack_block: int) -> List[Tuple[int, int]]:
    """The ``[start, end)`` K ranges whose int32 sums the W-A8 kernels turn
    into float32 one at a time: the scale groups cut at the K tiles of
    ``tile_rows(pack_block)`` rows."""
    cuts = sorted({*range(0, K, groupsize), *range(0, K, tile_rows(pack_block)), K})
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
    for a, b in a8_segments(p.in_features, p.groupsize, p.pack_block):
        g = a // p.groupsize
        d = torch.matmul(xd[:, a:b], w[a:b]).to(torch.float32)
        if sym:
            term = d * p.scales[g]
        else:
            rs = xq[:, a:b].sum(dim=1, keepdim=True, dtype=torch.int32).to(torch.float32)
            term = (d - (p.zeros[g] - sub) * rs) * p.scales[g]
        acc = acc + term
    return (acc * xs).to(dtype)


def _a8_checked(name: str, xq: torch.Tensor, xs: torch.Tensor, p: PackedLinear,
                dtype: torch.dtype, sym: bool) -> bool:
    """Check a W-A8 call; True where its operands lie on the CPU (the plain
    version runs), False for checked CUDA operands."""
    M, K = xq.shape
    if K != p.in_features:
        raise ValueError(f"{name}: xq has K={K}, the layer {p.in_features}")
    if p.bits == 3:
        raise ValueError(f"{name}: split-plane 3-bit layers have no W-A8 kernel "
                         "(quant_matmul runs quant_matmul_a8_sym_native or quant_matmul_a8_xla)")
    if sym and not p.sym:
        raise ValueError(f"{name}: the layer's grid is not symmetric")
    if xq.device.type == "cpu":
        return True
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
    check_packed_on(name, xq.device, p)
    return False


def a8_matmul(xq: torch.Tensor, xs: torch.Tensor, p: PackedLinear, dtype: torch.dtype,
              sym: bool) -> torch.Tensor:
    """A W-A8 kernel on activations already quantized (``xq`` int8 (M, K),
    ``xs`` float32 (M, 1)): the symmetric one if ``sym``, else the other;
    the output (M, N) is in ``dtype``, float32 or bfloat16. The launch takes
    :func:`pick_blocks_a8`'s tile; a FINE layout runs its one tile."""
    name = "quant_matmul_a8_sym" if sym else "quant_matmul_a8"
    if _a8_checked(name, xq, xs, p, dtype, sym):
        return a8_matmul_plain(xq, xs, p, dtype, sym)
    args = (xq, xs, p.qweight, p.scales, None if sym else p.zeros, p.bits, p.groupsize,
            p.pack_block, p.out_features, sym, dtype)
    if torch.compiler.is_exporting():
        return a8_matmul_op(*args)
    return _launch_a8_matmul(*args)


def a8_main_build(K: int, groupsize: int, pack_block: int, bits: int) -> bool:
    """Whether the W-A8 kernels run their main build (the tiled int8
    ``wgmma`` body) on this layout, as ``run_a8_bits`` decides: groups of 32
    or 64 rows, of whole 128-row K tiles or all of K; K tiles of 128 rows;
    pack blocks of at least four word rows a plane; K a multiple of 16 (x
    by TMA, which also wants xq on 16 bytes: the launch checks that).
    Otherwise the FINE build runs, at its one 128 x 128 tile."""
    g = groupsize
    return ((g == K or g in (32, 64) or g % MAX_TILE_K == 0)
            and tile_rows(pack_block) == MAX_TILE_K and (pack_block // (32 // bits)) % 4 == 0
            and K % 16 == 0)


def pick_blocks_a8(M: int, N: int, K: int, groupsize: int, pack_block: int,
                   bits: int = 4) -> Tuple[int, int, int]:
    """(bm, bn, bk) of a W-A8 main-build launch: the tuned table's entry
    under JAX's bare key (``groupsize if groupsize < K else 0``, no dtype
    suffix), as JAX's W-A8 wrappers call ``pick_blocks``, else the default
    128 x 128. Raises ``ValueError`` if the entry names no W-A8 candidate
    tile (``autotune.candidate_blocks_a8``)."""
    gk = groupsize if groupsize < K else 0
    cands = autotune.candidate_blocks_a8(M, N, K, groupsize, pack_block)
    hit = autotune.lookup(M, K, N, gk, bits)
    if hit is not None and hit not in cands:
        raise ValueError(f"autotune table entry {autotune._key(M, K, N, gk, bits)}: "
                         f"{hit} is not a W-A8 candidate tile {cands}")
    return hit if hit is not None else cands[0]


def _launch_a8_matmul(xq: torch.Tensor, xs: torch.Tensor, qweight: torch.Tensor,
                      scales: torch.Tensor, zeros: Optional[torch.Tensor], bits: int,
                      groupsize: int, pack_block: int, out_features: int, sym: bool,
                      dtype: torch.dtype) -> torch.Tensor:
    """Launch ``quant_matmul_a8_sym`` (``sym``) or ``quant_matmul_a8`` on
    checked CUDA operands, at :func:`pick_blocks_a8`'s tile, or at the
    default tile where the FINE build runs (which ignores the table)."""
    M, K = xq.shape
    if a8_main_build(K, groupsize, pack_block, bits) and xq.data_ptr() % 16 == 0:
        tile = pick_blocks_a8(M, out_features, K, groupsize, pack_block, bits)
    else:
        tile = (*autotune.TILES_A8[0], tile_rows(pack_block))
    return _launch_a8(xq, xs, qweight, scales, zeros, bits, groupsize, pack_block,
                      out_features, sym, dtype, tile)


def _launch_a8(xq, xs, qweight, scales, zeros, bits, groupsize, pack_block, out_features, sym,
               dtype, tile: Tuple[int, int, int]) -> torch.Tensor:
    """``samq_quant_matmul_a8`` at ``tile``, counted in ``LAUNCHES`` and
    ``TILE_LAUNCHES``."""
    M, K = xq.shape
    out = torch.empty((M, out_features), dtype=dtype, device=xq.device)
    if M == 0:
        return out
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "quant_matmul_a8", _build.DTYPE_CODE[dtype], bits, int(sym), xq.data_ptr(),
            xs.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
            None if sym else zeros.data_ptr(), out.data_ptr(), M, K, out_features, groupsize,
            pack_block, *tile, stream,
        )
    name = "quant_matmul_a8_sym" if sym else "quant_matmul_a8"
    LAUNCHES[name] += 1
    key = (name, dtype, tuple(tile))
    TILE_LAUNCHES[key] = TILE_LAUNCHES.get(key, 0) + 1
    return out


def a8_matmul_tiled(xq: torch.Tensor, xs: torch.Tensor, p: PackedLinear,
                    tile: Tuple[int, int, int], dtype: torch.dtype, sym: bool) -> torch.Tensor:
    """A W-A8 kernel at a given tile ``(bm, bn, bk)``: on a CUDA tensor the
    kernel, which refuses a tile it was not built for (``RuntimeError``) and
    whose FINE build runs its one tile whatever ``tile`` names; on a CPU
    tensor the plain version, which has no tiles."""
    name = "quant_matmul_a8_sym" if sym else "quant_matmul_a8"
    if _a8_checked(name, xq, xs, p, dtype, sym):
        return a8_matmul_plain(xq, xs, p, dtype, sym)
    return _launch_a8(xq, xs, p.qweight, p.scales, None if sym else p.zeros, p.bits,
                      p.groupsize, p.pack_block, p.out_features, sym, dtype, tuple(tile))


a8_matmul_op = torch.library.custom_op(
    "sam_quantization_tpu_torch::a8_matmul", _launch_a8_matmul, mutates_args=(),
    device_types="cuda")


@a8_matmul_op.register_fake
def _(xq, xs, qweight, scales, zeros, bits, groupsize, pack_block, out_features, sym, dtype):
    return xq.new_empty((xq.shape[0], out_features), dtype=dtype)


# The custom ops an exported program may hold (op overload packet names).
KERNEL_OPS = ("sam_quantization_tpu_torch::quant_matmul", "sam_quantization_tpu_torch::a8_matmul")


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
    return _a8_xla(*quantize_activations_int8(x), p, x.dtype)


def _a8_xla(xq: torch.Tensor, xs: torch.Tensor, p: PackedLinear,
            dtype: torch.dtype) -> torch.Tensor:
    y = torch.matmul(xq.float(), dequantize(p, torch.float32))
    return (y * xs).to(dtype)


def quant_matmul_a8_sym_native(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """Symmetric W-A8 as JAX's native int8 dot: one exact integer dot per
    scale group (in float64, which holds it), each rounded to float32 as
    JAX's int32 result is, scaled per group and summed, times the token
    scale."""
    return _a8_sym_native(*quantize_activations_int8(x), p, x.dtype)


def _a8_sym_native(xq: torch.Tensor, xs: torch.Tensor, p: PackedLinear,
                   dtype: torch.dtype) -> torch.Tensor:
    if not p.sym:
        raise ValueError("quant_matmul_a8_sym_native: the layer's grid is not symmetric")
    w = (unpack_to_int(p) - (1 << (p.bits - 1))).to(torch.float64)
    K, N = w.shape
    G = p.num_groups
    xd = xq.to(torch.float64)
    if G == 1:
        y = torch.matmul(xd, w).to(torch.float32) * p.scales[0]
    else:
        acc = torch.matmul(xd.reshape(-1, G, K // G).transpose(0, 1), w.reshape(G, K // G, N))
        y = torch.einsum("gmn,gn->mn", acc.to(torch.float32), p.scales)
    return (y * xs).to(dtype)


# ---------------------------------------------------------------------------
# Cached int8 weights (IntLinear)
# ---------------------------------------------------------------------------


def _int_mm(xq: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``xq (M, K) @ w8 (K, N)``. cuBLASLt's int8 product wants
    more than 16 rows and a column-major ``w8`` (it refuses some row-major
    shapes), so on the card a shorter ``xq`` is padded with zero rows and a
    row-major ``w8`` (the ``"kn"`` layout) is copied to column-major."""
    M = xq.shape[0]
    if xq.is_cuda:
        if M <= 16:
            xq = torch.cat([xq, xq.new_zeros((17 - M, xq.shape[1]))])
        if w8.stride(0) != 1:
            w8 = w8.t().contiguous().t()
    return torch._int_mm(xq.contiguous(), w8)[:M]


def quantize_static(x: torch.Tensor, in_scale: torch.Tensor) -> torch.Tensor:
    """int8 ``clip(round(x * (1 / in_scale)), +-127)`` at a fixed scale, in
    float32 (the reciprocal multiply of the JAX package), round half to even."""
    return torch.clamp(torch.round(x.float() * (1.0 / in_scale)), -127, 127).to(torch.int8)


def int8_matmul(x: torch.Tensor, p: IntLinear) -> torch.Tensor:
    """``x (M, K)`` times the cached int8 weights of ``p`` -> ``(M, N)`` (the
    JAX ``int8_matmul``, quant_matmul.py:121-179, branch for branch):

    * int8 ``x`` (int8-pre): taken as already quantized at ``p.in_scale``
      (the attention kernels' int8-out epilogue); ``acc * (scales[0] *
      in_scale)``, returned in bfloat16;
    * ``p.in_scale`` set (static): ``clip(round(x * (1 / in_scale)), +-127)``,
      then ``acc * (scales[0] * in_scale)`` in x's dtype;
    * otherwise per-token dynamic quantization
      (:func:`quantize_activations_int8`), ``acc * scales[0]``, or for
      grouped ``"kn"`` weights one int32 product per group, each scaled and
      added in group order (a fused multiply-add), then times the token
      scale.
    """
    M, K = x.shape
    if K != p.in_features:
        raise ValueError(f"int8_matmul: x has K={K}, the layer {p.in_features}")
    if x.device != p.w8.device:
        raise ValueError(f"int8_matmul: weights on {p.w8.device}, x on {x.device}")
    w8 = p.w8.t() if p.layout == "nk" else p.w8  # (K, N)
    G = p.num_groups
    if x.dtype == torch.int8:
        if p.in_scale is None:
            raise ValueError("int8_matmul: an int8 input needs the layer's in_scale")
        if G != 1:
            raise ValueError("int8_matmul: the int8-pre path takes one scale group")
        INT8_MATMULS["int8_matmul_pre"] += 1
        acc = _int_mm(x, w8).float()
        return (acc * (p.scales[0] * p.in_scale)[None, :]).to(torch.bfloat16)
    if p.in_scale is None:
        return int8_token_product(*quantize_activations_int8(x), p, x.dtype)
    xq = quantize_static(x, p.in_scale)
    if G != 1:
        return _int8_scaled(xq, p.in_scale, p, x.dtype)
    INT8_MATMULS["int8_matmul"] += 1
    acc = _int_mm(xq, w8).float()
    return (acc * (p.scales[0] * p.in_scale)[None, :]).to(x.dtype)


def _int8_scaled(xq: torch.Tensor, xs: torch.Tensor, p: IntLinear,
                 dtype: torch.dtype) -> torch.Tensor:
    """int8_matmul on activations already quantized at scales ``xs`` (per
    token (M, 1), or a static scalar for grouped weights)."""
    INT8_MATMULS["int8_matmul"] += 1
    M, K = xq.shape
    w8 = p.w8.t() if p.layout == "nk" else p.w8  # (K, N)
    G = p.num_groups
    if G == 1:
        y = _int_mm(xq, w8).float() * p.scales[0][None, :]
    else:
        if p.layout != "kn":
            raise ValueError("int8_matmul: grouped weights need the kn layout")
        # y = fma(acc_g, s_g, y) in group order, as XLA's CPU dot contracts
        # JAX's (G, M, N) einsum: the product of two float32 values is exact
        # in float64, so the float64 multiply-add rounded to float32 is the
        # fused one (but for a tie of the double rounding) on either device.
        g = K // G
        y = torch.zeros((M, p.out_features), dtype=torch.float64, device=xq.device)
        for i in range(G):
            acc = _int_mm(xq[:, i * g:(i + 1) * g], w8[i * g:(i + 1) * g]).float()
            y = (acc.double() * p.scales[i].double() + y).float().double()
        y = y.float()
    return (y * xs).to(dtype)


def int8_token_product(xq: torch.Tensor, xs: torch.Tensor, layer,
                       dtype: torch.dtype) -> torch.Tensor:
    """``xq (M, K) int8`` at token scales ``xs (M, 1)`` (as
    :func:`quantize_activations_int8` gives them) times a layer that takes
    per-token int8 activations -> ``(M, N)`` in ``dtype``: a ``PackedLinear``
    with ``act_bits`` 8 by the W-A8 route :func:`quant_matmul` takes (its
    kernels, or the split-plane 3-bit paths), an ``IntLinear`` without
    ``in_scale`` by :func:`int8_matmul`'s dynamic branch. A row-parallel
    shard passes its slice of the tokens quantized at the whole token's
    amax (``parallel/mesh.row_parallel``)."""
    if isinstance(layer, IntLinear):
        if layer.in_scale is not None:
            raise ValueError("int8_token_product: the layer quantizes at a static in_scale")
        return _int8_scaled(xq, xs, layer, dtype)
    if layer.act_bits != 8:
        raise ValueError("int8_token_product: the layer takes no int8 activations")
    if layer.bits == 3:
        return (_a8_sym_native if layer.sym else _a8_xla)(xq, xs, layer, dtype)
    return a8_matmul(xq, xs, layer, dtype, sym=layer.sym)
