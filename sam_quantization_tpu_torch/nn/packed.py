"""Packed low-bit linear layers in the JAX package's block-planar layout.

Counterpart of ``sam_quantization_tpu/nn/packed.py``: ``PackedLinear`` and
its helpers, and the cached-int8 serving mode (:class:`IntLinear`,
:func:`cache_int8`, :func:`default_serve_skip`, :func:`expand_act_scales`).
The layout is kept word for word, so an artifact written by the JAX package
loads unchanged:

* ``qweight`` is int32 ``(K // per, N)``, K-major, ``per = 32 // bits``. K is
  split into pack blocks of ``pack_block`` rows; within a block, the ``per``
  values of one word hold rows ``pack_block // per`` apart (plane ``s`` sits
  at bit ``s * bits``).
* 3-bit weights are two planes with the same pack block: the low 2 bits in
  ``qweight`` (16 per word, ``(K // 16, N)``) and the high bit in
  ``qweight_hi`` (32 per word, ``(K // 32, N)``).
* ``scales`` / ``zeros`` are float32 ``(K // groupsize, N)``:
  ``w[k, n] = (q[k, n] - zeros[k // g, n]) * scales[k // g, n]``.

Packing runs in int64 and wraps to int32 explicitly (torch's uint32
arithmetic is thin); unpacking shifts, then masks below ``2**bits``, which
makes the arithmetic ``>>`` of a negative int32 safe.

:class:`PackedLinear` and :class:`IntLinear` keep their scales, zeros,
bias and activation scale as they are, float32 values unrounded, whatever
``module.to(dtype)`` asks: the kernels dequantize with float32 scales, as the
JAX kernels do, so a bfloat16 encoder keeps the numbers.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, Optional

import torch
from torch import nn


class _Float32Buffers(nn.Module):
    """A module whose ``FLOAT_BUFFERS`` stay float32 under ``.to(dtype)``."""

    FLOAT_BUFFERS: tuple = ()

    def _apply(self, fn, recurse=True):
        # fn may change a buffer's dtype (module.to(torch.bfloat16)). Where it
        # does, the float32 buffer is put back, moved only to fn's device:
        # casting fn's result back would keep its rounding.
        before = {name: getattr(self, name) for name in self.FLOAT_BUFFERS}
        super()._apply(fn, recurse)
        for name, t in before.items():
            new = getattr(self, name)
            if t is not None and new.dtype != t.dtype:
                setattr(self, name, t.to(new.device))
        return self


def default_pack_block(in_features: int, bits: int) -> int:
    # bits=3 packs as a 2-bit plane + a 1-bit plane; the 1-bit plane's 32
    # values per word is the binding alignment constraint.
    per = 32 if bits == 3 else 32 // bits
    pb = min(128, in_features)
    while in_features % pb != 0 or pb % per != 0:
        pb //= 2
        if pb < per:
            raise ValueError(f"cannot find pack block for K={in_features}, bits={bits}")
    return pb


class PackedLinear(_Float32Buffers):
    """Quantized linear layer: ``y = x @ dequant(qweight) + bias``.

    Built from its static fields with buffers of the right shapes (filled by
    a state dict or by :func:`pack_int_weights`), like ``Linear``.
    ``act_bits`` 8 quantizes the activations per token to int8 and runs the
    integer W-A8 kernels (:func:`with_act_bits`); 0 is weight-only.
    """

    FLOAT_BUFFERS = ("scales", "zeros", "bias")

    def __init__(self, in_features: int, out_features: int, *, bits: int = 4,
                 groupsize: int = 0, pack_block: int = 128, bias: bool = True,
                 act_bits: int = 0, sym: bool = False, device="cpu"):
        super().__init__()
        if bits not in (2, 3, 4, 8):
            raise ValueError(f"PackedLinear supports bits in (2, 3, 4, 8); got {bits}")
        g = groupsize if groupsize > 0 else in_features
        if in_features % g or g % pack_block:
            raise ValueError(
                f"groupsize {g} must divide K={in_features} and be a multiple of "
                f"pack_block {pack_block}"
            )
        self.bits, self.in_features, self.out_features = bits, in_features, out_features
        self.groupsize, self.pack_block = g, pack_block
        self.act_bits, self.sym = act_bits, sym
        K, N, G = in_features, out_features, in_features // g
        i32 = dict(dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.register_buffer("qweight", torch.zeros(K // self.values_per_word, N, **i32))
        self.register_buffer(
            "qweight_hi", torch.zeros(K // 32, N, **i32) if bits == 3 else None
        )
        self.register_buffer("scales", torch.zeros(G, N, **f32))
        self.register_buffer("zeros", torch.zeros(G, N, **f32))
        self.register_buffer("bias", torch.zeros(N, **f32) if bias else None)

    @property
    def values_per_word(self) -> int:
        # bits=3: the low (2-bit) plane's word count defines qweight's shape.
        return 16 if self.bits == 3 else 32 // self.bits

    @property
    def num_groups(self) -> int:
        return self.in_features // self.groupsize

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from sam_quantization_tpu_torch.nn import functional as F

        return F.quant_linear(x, self)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bits={self.bits}, groupsize={self.groupsize}, "
                f"pack_block={self.pack_block}, act_bits={self.act_bits}, sym={self.sym}")


def pack_int_weights(
    int_weight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
    bias: Optional[torch.Tensor], bits: int, groupsize: int = 0, sym: bool = False,
) -> PackedLinear:
    """Pack integer grid weights (K, N), values in [0, 2^bits - 1], on their device.

    ``w[k, n] = (int_weight[k, n] - zeros[k // groupsize, n]) * scales[k // groupsize, n]``.
    """
    K, N = int_weight.shape
    g = groupsize if groupsize > 0 else K
    pb = default_pack_block(K, bits)
    if g % pb != 0:
        pb = default_pack_block(g, bits)
    p = PackedLinear(K, N, bits=bits, groupsize=g, pack_block=pb, bias=bias is not None,
                     sym=sym, device=int_weight.device)
    q = int_weight.to(torch.int64)
    if bits == 3:
        p.qweight.copy_(_pack_planar(q & 3, 2, pb))
        p.qweight_hi.copy_(_pack_planar(q >> 2, 1, pb))
    else:
        p.qweight.copy_(_pack_planar(q, bits, pb))
    p.scales.copy_(scales.reshape(-1, N))
    p.zeros.copy_(zeros.reshape(-1, N))
    if bias is not None:
        p.bias.copy_(bias)
    return p


def _pack_planar(int_vals: torch.Tensor, bits: int, pb: int) -> torch.Tensor:
    """Block-planar bit-pack (K, N) grid values in [0, 2^bits) into (K//per, N)
    int32 words: within each pack block, word row r of plane s holds original
    in-block row s * rows_per_plane + r."""
    K, N = int_vals.shape
    per = 32 // bits
    w = int_vals.to(torch.int64).reshape(K // pb, per, pb // per, N)
    shifts = (torch.arange(per, dtype=torch.int64, device=w.device) * bits).reshape(1, per, 1, 1)
    words = (w << shifts).sum(dim=1)  # disjoint bit fields: the sum is the OR, < 2^32
    words = torch.where(words >= 2**31, words - 2**32, words)  # wrap to int32
    return words.to(torch.int32).reshape(K // per, N)


def unpack_words(qwords: torch.Tensor, bits: int, pack_block: int) -> torch.Tensor:
    """Unpack block-planar int32 words (R, N) into int32 grid values (R * per, N).

    ``qwords`` must cover whole pack blocks (R divisible by pack_block/per).
    """
    per = 32 // bits
    R, N = qwords.shape
    rows_per_plane = pack_block // per
    mask = (1 << bits) - 1
    qb = qwords.reshape(R // rows_per_plane, rows_per_plane, N)
    planes = [(qb >> (s * bits)) & mask for s in range(per)]
    return torch.cat(planes, dim=1).reshape(R * per, N)


def unpack_to_int(p: PackedLinear) -> torch.Tensor:
    """Full int32 grid values of shape (K, N)."""
    if p.bits == 3:
        low = unpack_words(p.qweight, 2, p.pack_block)
        hi = unpack_words(p.qweight_hi, 1, p.pack_block)
        return low | (hi << 2)
    return unpack_words(p.qweight, p.bits, p.pack_block)


def dequantize(p: PackedLinear, dtype=torch.float32) -> torch.Tensor:
    """Dequantized (K, N) weight: ``(q - zero) * scale`` per group in float32,
    then cast to ``dtype``."""
    q = unpack_to_int(p).float()
    K, N = q.shape
    g = p.groupsize
    w = (q.reshape(K // g, g, N) - p.zeros[:, None, :]) * p.scales[:, None, :]
    return w.reshape(K, N).to(dtype)


def quantize_rtn(
    w: torch.Tensor, bits: int, groupsize: int = 0, sym: bool = False,
    bias: Optional[torch.Tensor] = None,
) -> PackedLinear:
    """Round-to-nearest per-group quantization of a (K, N) weight matrix
    (the JAX package's ``quantize_rtn``, operation for operation)."""
    K, N = w.shape
    g = groupsize if groupsize > 0 else K
    g = min(g, K)  # tiny layers: a group never exceeds the K axis
    maxq = (1 << bits) - 1
    wg = w.reshape(K // g, g, N).float()
    wmax = wg.amax(dim=1)
    wmin = wg.amin(dim=1)
    if sym:
        m = torch.maximum(wmax.abs(), wmin.abs())
        wmax, wmin = m, -m
    wmax = torch.where(wmax == wmin, wmax + 1e-8, wmax)
    scale = (wmax - wmin) / maxq
    if sym:
        zero = torch.full_like(scale, (maxq + 1) / 2)
    else:
        zero = torch.round(-wmin / scale)
    q = torch.clamp(torch.round(wg / scale[:, None, :]) + zero[:, None, :], 0, maxq)
    return pack_int_weights(
        q.reshape(K, N).to(torch.int32), scale, zero,
        None if bias is None else bias.float(), bits, g, sym=sym,
    )


def with_act_bits(module: nn.Module, act_bits: int) -> nn.Module:
    """A copy of ``module`` with ``act_bits`` set on every :class:`PackedLinear`
    (0 = weight-only, 8 = int8 activations, the W-A8 kernels), the JAX
    ``with_act_bits``. The copy shares its tensors with ``module``, as JAX's
    ``dataclasses.replace`` shares arrays; ``module`` is left as it was."""
    memo = {id(t): t for t in (*module.parameters(), *module.buffers())}
    out = copy.deepcopy(module, memo)
    for m in out.modules():
        if isinstance(m, PackedLinear):
            m.act_bits = act_bits
    return out


def dense_copy(module: nn.Module) -> nn.Module:
    """A deep copy of ``module`` with every :class:`PackedLinear` replaced by
    a float32 ``Linear`` holding its dequantized weight: the dense model the
    packed one stands for."""
    from sam_quantization_tpu_torch.nn.layers import Linear

    def dense(p: PackedLinear) -> Linear:
        lin = Linear(p.in_features, p.out_features, bias=p.bias is not None,
                     device=p.qweight.device)
        lin.weight.data.copy_(dequantize(p).t())
        if p.bias is not None:
            lin.bias.data.copy_(p.bias)
        return lin

    if isinstance(module, PackedLinear):
        return dense(module)
    out = copy.deepcopy(module)
    for name, child in list(out.named_modules()):
        for attr, sub in list(child.named_children()):
            if isinstance(sub, PackedLinear):
                setattr(child, attr, dense(sub))
    return out


# ---------------------------------------------------------------------------
# Cached-int8 serving (the JAX ``IntLinear`` / ``cache_int8``, packed.py:232-441)
# ---------------------------------------------------------------------------


class IntLinear(_Float32Buffers):
    """Linear layer on cached int8 weights: ``y = (xq @ w8) * scale + bias``.

    ``w8`` holds a symmetric grid with the zero already removed: int8
    ``(K, N)`` for layout ``"kn"``, ``(N, K)`` for ``"nk"``, whose ``w8.t()``
    is the column-major operand of the int8 product. ``scales`` is float32
    ``(G, N)``: one row (``"nk"``, or ``groupsize`` 0) or one per group of
    ``groupsize`` input rows. ``in_scale``, a float32 0-d tensor, is the
    static activation scale: with it the input is quantized at that fixed
    scale (or arrives as int8 already), without it per token;
    ``in_scale_value`` is its value on the host, for kernel arguments that
    must not wait on the device.
    """

    FLOAT_BUFFERS = ("scales", "bias", "in_scale")

    def __init__(self, w8: torch.Tensor, scales: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 in_scale: Optional[torch.Tensor] = None, *, groupsize: int = 0,
                 layout: str = "kn"):
        super().__init__()
        if w8.dtype != torch.int8 or w8.dim() != 2:
            raise TypeError(f"IntLinear: w8 must be a 2-D int8 tensor, got {w8.dtype} {w8.dim()}-D")
        if layout not in ("kn", "nk"):
            raise ValueError(f"IntLinear: layout must be 'kn' or 'nk', got {layout!r}")
        if layout == "nk" and scales.shape[0] != 1:
            raise ValueError("IntLinear: the nk layout takes one scale group")
        self.groupsize, self.layout = groupsize, layout
        self.register_buffer("w8", w8.contiguous())
        self.register_buffer("scales", scales.float().contiguous())
        self.register_buffer("bias", None if bias is None else bias.float())
        self.register_buffer(
            "in_scale", None if in_scale is None else in_scale.float().reshape(()))
        self.in_scale_value = None if in_scale is None else float(self.in_scale)

    @property
    def in_features(self) -> int:
        return self.w8.shape[1] if self.layout == "nk" else self.w8.shape[0]

    @property
    def out_features(self) -> int:
        return self.w8.shape[0] if self.layout == "nk" else self.w8.shape[1]

    @property
    def num_groups(self) -> int:
        return self.scales.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from sam_quantization_tpu_torch.nn import functional as F

        return F.quant_linear(x, self)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"groups={self.num_groups}, layout={self.layout}, "
                f"static={self.in_scale is not None}")


def _int_linear(p: PackedLinear, in_scale: Optional[torch.Tensor], per_channel: bool,
                transpose: bool) -> IntLinear:
    """The JAX ``cache_int8`` conversion of one symmetric ``PackedLinear``."""
    if per_channel and p.num_groups > 1:
        # one symmetric int8 grid per output column over the exact float32 weight
        w = dequantize(p, torch.float32)
        # a / 127 as one IEEE division on any device (a CUDA divide by a
        # Python scalar multiplies by its reciprocal)
        s_col = torch.clamp_min(w.abs().amax(dim=0) / torch.full_like(w[0], 127.0), 1e-12)
        w8 = torch.clamp(torch.round(w / s_col[None, :]), -127, 127).to(torch.int8)
        return IntLinear(w8.t() if transpose else w8, s_col[None, :], p.bias, in_scale,
                         groupsize=0, layout="nk" if transpose else "kn")
    w8 = (unpack_to_int(p) - (1 << (p.bits - 1))).to(torch.int8)
    nk = transpose and p.num_groups == 1
    return IntLinear(w8.t() if nk else w8, p.scales, p.bias, in_scale,
                     groupsize=p.groupsize, layout="nk" if nk else "kn")


def cache_int8(module: nn.Module, act_scales: Optional[Dict[str, float]] = None,
               per_channel: bool = True, skip: Optional[Iterable[str]] = ("attn.proj",),
               keep_packed: Iterable[str] = (), transpose: bool = True) -> nn.Module:
    """Convert every symmetric :class:`PackedLinear` under ``module`` to an
    :class:`IntLinear`, in place; returns ``module`` (the JAX ``cache_int8``,
    on the same paths: ``blocks.N.attn.qkv`` and the like).

    ``act_scales``: {layer path: abs-max} of calibrated activations
    (:func:`~sam_quantization_tpu_torch.quant.act_scales.calibrate_act_scales`);
    a layer with one quantizes its input at ``float32(amax) / 127``. A key
    that names no linear layer raises ``ValueError``: the static path would
    silently not engage (:func:`expand_act_scales` broadcasts suffixes).
    ``per_channel``: requantize grouped weights onto one int8 grid per output
    column, ``s = max(max|w| / 127, 1e-12)``, ``clip(round(w / s), +-127)``.
    ``skip``: path substrings served by a dense ``Linear`` holding the
    bfloat16-rounded dequantized weight instead. ``keep_packed``: path
    substrings left as ``PackedLinear``. ``transpose``: store one-group
    weights in the ``"nk"`` layout.
    """
    from sam_quantization_tpu_torch.nn.layers import Linear

    skip = None if skip is None else tuple(skip)
    keep_packed = tuple(keep_packed)
    matched = set()
    for parent_path, parent in list(module.named_modules()):
        for attr, child in list(parent.named_children()):
            path = f"{parent_path}.{attr}" if parent_path else attr
            if act_scales and path in act_scales and isinstance(child, (PackedLinear, Linear)):
                matched.add(path)
            if not isinstance(child, PackedLinear) or not child.sym:
                continue
            if any(s in path for s in keep_packed):
                continue
            if skip is not None and any(s in path for s in skip):
                new = Linear(child.in_features, child.out_features, bias=child.bias is not None,
                             device=child.qweight.device)
                new.weight.data = dequantize(child, torch.bfloat16).t().contiguous()
                if child.bias is not None:
                    new.bias.data = child.bias.clone()
            else:
                in_scale = None
                if act_scales is not None and path in act_scales:
                    in_scale = torch.tensor(float(act_scales[path]), dtype=torch.float32) / 127.0
                    in_scale = in_scale.to(child.qweight.device)  # divided on the host
                new = _int_linear(child, in_scale, per_channel, transpose)
            setattr(parent, attr, new)
    unmatched = set(act_scales or ()) - matched
    if unmatched:
        raise ValueError(f"act_scales keys matched no quantized linear: {sorted(unmatched)}")
    return module


def default_serve_skip(embed_dim: int) -> tuple:
    """The JAX package's per-op routing of the int8 serving mode: attn.proj
    runs int8 at ViT-H's 1280 width (which also engages the attention
    kernels' int8-out epilogue) and dense below it."""
    return () if embed_dim >= 1280 else ("attn.proj",)


def expand_act_scales(module: nn.Module, suffix_scales: Dict[str, float]) -> Dict[str, float]:
    """Broadcast ``{path suffix: amax}`` over the :class:`PackedLinear` layers
    of ``module``: ``{"attn.qkv": 8.0}`` becomes ``{"blocks.0.attn.qkv": 8.0,
    ...}`` (the JAX ``expand_act_scales``)."""
    out = {}
    for path, m in module.named_modules():
        if isinstance(m, PackedLinear):
            for suffix, amax in suffix_scales.items():
                if path == suffix or path.endswith("." + suffix):
                    out[path] = amax
    return out
