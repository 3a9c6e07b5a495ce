"""Attention with decomposed relative-position bias: CUDA kernels and their
plain PyTorch versions.

Counterpart of ``sam_quantization_tpu/ops/flash_attention.py``. The image
encoder's attention runs through three CUDA kernels, behind these functions:

* :func:`flash_attention_qkv_packed` - windowed attention read straight from
  the qkv projection output (``flash_windowed``, replaces
  ``_attn_kernel_qkv_packed``);
* :func:`flash_attention_relpos` - attention on head-split q/k/v, routed as
  JAX routes it: the bias3d global kernel (``flash_global``, replaces
  ``_attn_kernel_rowblock_bias3d``) where that shape rule holds, otherwise
  one kernel, ``csrc/flash_attn.cu``, with or without the rel-pos bias,
  counted as ``flash_whole`` for L <= 512 (replaces ``_attn_kernel``) and as
  ``flash_rowblock`` above (replaces ``_attn_kernel_rowblock``);
* :func:`flash_attention_relpos_trainable` - the same forward with an exact
  backward: autograd of :func:`attention_reference` on recomputed inputs.

All compute the JAX package's default numerics: logits pre-scaled by
log2(e) so the softmax is a raw ``exp2``, a static clamp shift
``exp2(clip(s, -60, 64) - 64)`` instead of a row max, normalisation deferred
past the p.v product, and (windowed and bias3d global only) an optional int8
epilogue ``clip(round(o * (1/sum p) * out_inv_scale), -127, 127)``.

In bfloat16 every kernel runs both products on Hopper's tensor cores
(wgmma): the windowed and bias3d global kernels on ``csrc/flash_tc.cuh``'s
body, ``flash_whole`` and ``flash_rowblock`` on ``csrc/probe_tc.cuh``'s (K
and V by TMA from a producer warp). In float32 all four counters run one
register-tiled body on the CUDA cores, ``csrc/flash_f32.cuh`` (FFMA, K and V
by cp.async): ``flash_windowed`` reads its heads in place from the qkv rows
(16-byte copies where hd % 4 == 0, else 4-byte ones), ``flash_global`` holds
rel_w in registers where kw divides 64. For the head-split routes of the TMA
and register-tiled bodies the wrapper pads hd to whole 16-byte rows and
copies operands that do not start on 16 bytes. :func:`body` names the body
of each route and dtype.

One difference is by design: the port does not pad L, so keys n >= L do not
exist. A row whose logits all lie below the floor therefore averages its L
real keys, where the JAX kernels' padded columns take a share of the sum and
shrink the output by L/Lp.

Each wrapper launches its CUDA kernel for a CUDA tensor and uses the plain
version only for a CPU tensor. ``LAUNCHES`` counts kernel launches, and
``INT8_OUT`` those of them that ran the int8 epilogue.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sam_quantization_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
CLAMP_CAP, CLAMP_FLOOR = 64.0, -60.0
MAX_HEAD_DIM = 128  # the kernels' register tile

LAUNCHES: Dict[str, int] = {
    "flash_windowed": 0, "flash_global": 0, "flash_whole": 0, "flash_rowblock": 0,
}
INT8_OUT: Dict[str, int] = {"flash_windowed": 0, "flash_global": 0}
WHOLE_MAX_L = 512  # JAX's whole-problem (``_attn_kernel``) range


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, INT8_OUT):
        for name in counts:
            counts[name] = 0


def _softmax_pv(s: torch.Tensor, v: torch.Tensor, dtype, out_inv_scale):
    """Clamped exp2 softmax numerator, p.v in float32, deferred normalisation
    (the JAX ``_psoft`` + epilogue, in the same order)."""
    p = torch.exp2(torch.clamp(s, CLAMP_FLOOR, CLAMP_CAP) - CLAMP_CAP)
    r = 1.0 / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(dtype).float(), v.float())
    if out_inv_scale is None:
        return (o * r).to(dtype)
    return torch.clamp(torch.round(o * (r * out_inv_scale)), -127, 127).to(torch.int8)


def _check_cuda(name: str, dtype, *tensors: torch.Tensor) -> None:
    if dtype not in _build.DTYPE_CODE:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32 or bfloat16)")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


# ---------------------------------------------------------------------------
# Windowed: (NW, L, 3*nh*hd) packed qkv -> (NW, L, nh*hd)
# ---------------------------------------------------------------------------


def flash_windowed_plain(
    qkv: torch.Tensor, rel: torch.Tensor, scale: float, *, nh: int, hd: int,
    kh: int, kw: int, out_inv_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the windowed kernel (same math, same order)."""
    NW, L, _ = qkv.shape
    C = nh * hd
    dt = qkv.dtype
    q, k, v = (
        qkv[..., i * C : (i + 1) * C].reshape(NW, L, nh, hd).transpose(1, 2)
        for i in range(3)
    )
    qs = (q.float() * (scale * LOG2E)).to(dt)
    relp = (rel.float() * LOG2E).to(dt).float()
    n = torch.arange(L, device=qkv.device)
    bias = relp[..., kh + n % kw] + relp[..., n // kw]  # (NW, nh, L, L)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2)) + bias
    o = _softmax_pv(s, v, dt, out_inv_scale)
    return o.transpose(1, 2).reshape(NW, L, C)


def flash_attention_qkv_packed(
    qkv: torch.Tensor, rel: Optional[torch.Tensor], scale: float, *, nh: int, hd: int,
    kh: int, kw: int, out_inv_scale: Optional[float] = None,
) -> torch.Tensor:
    """Windowed attention on the packed qkv projection output.

    Args:
      qkv: (NW, L, 3*nh*hd), the qkv linear's output with heads not split.
      rel: (NW, nh, L, kh + kw), the rel_h | rel_w tiles of each query, or
        None for zero tiles (no bias, through the same kernel, as in JAX).
      scale: softmax scale of q.
      out_inv_scale: if given, the output is int8 at scale 1/out_inv_scale.

    Returns (NW, L, nh*hd), in qkv's dtype or int8.
    """
    NW, L, C3 = qkv.shape
    if rel is None:
        rel = qkv.new_zeros((NW, nh, L, kh + kw))
    if C3 != 3 * nh * hd or kh * kw != L or tuple(rel.shape) != (NW, nh, L, kh + kw):
        raise ValueError(
            f"flash_attention_qkv_packed: qkv {tuple(qkv.shape)}, rel {tuple(rel.shape)} "
            f"do not fit nh={nh} hd={hd} window={kh}x{kw}"
        )
    if qkv.device.type == "cpu":
        return flash_windowed_plain(
            qkv, rel, scale, nh=nh, hd=hd, kh=kh, kw=kw, out_inv_scale=out_inv_scale
        )
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_qkv_packed: no kernel for {qkv.device}")
    _check_cuda("flash_windowed", qkv.dtype, qkv, rel)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_windowed: head dim {hd} > {MAX_HEAD_DIM}")
    quant = out_inv_scale is not None
    out = torch.empty(
        (NW, L, nh * hd), dtype=torch.int8 if quant else qkv.dtype, device=qkv.device
    )
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "flash_windowed", _build.DTYPE_CODE[qkv.dtype], int(quant), qkv.data_ptr(),
            rel.data_ptr(), out.data_ptr(), NW, L, nh, hd, kh, kw,
            float(scale * LOG2E), float(out_inv_scale) if quant else 0.0, stream,
        )
    LAUNCHES["flash_windowed"] += 1
    INT8_OUT["flash_windowed"] += int(quant)
    return out


# ---------------------------------------------------------------------------
# Head-split: q, k, v (B, nh, L, hd) with optional rel_h (B, nh, L, kh),
# rel_w (B, nh, L, kw)
# ---------------------------------------------------------------------------


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_h: Optional[torch.Tensor],
    rel_w: Optional[torch.Tensor], scale: float, *, out_inv_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the head-split kernels, ``flash_global`` and
    ``flash_attn`` (same math, same order); ``rel_h = rel_w = None`` drops
    the bias."""
    L = q.shape[-2]
    dt = q.dtype
    qs = (q.float() * (scale * LOG2E)).to(dt)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if rel_h is not None:
        kh, kw = rel_h.shape[-1], rel_w.shape[-1]
        rh = (rel_h.float() * LOG2E).to(rel_h.dtype).float()
        rw = (rel_w.float() * LOG2E).to(rel_w.dtype).float()
        n = torch.arange(L, device=q.device)
        s = s + (rw[..., n % kw] + rh[..., n // kw])
    return _softmax_pv(s, v, dt, out_inv_scale)


def route(L: int, kv_size: Optional[Tuple[int, int]], bias3d: Optional[bool] = None) -> str:
    """The kernel :func:`flash_attention_relpos` launches: JAX's dispatch
    (``flash_attention.py:826-835``, ``:895-904``). ``kv_size`` is the rel
    tiles' (kh, kw), or None without rel-pos; ``bias3d=False`` keeps a
    problem off the bias3d global kernel, as JAX's ``bias3d=False`` does."""
    if kv_size is not None and bias3d is not False:
        kh, kw = kv_size
        if L > WHOLE_MAX_L and kh * kw == L and L % 128 == 0 and kw <= 128 and 128 % kw == 0:
            return "flash_global"
    return "flash_whole" if L <= WHOLE_MAX_L else "flash_rowblock"


# The bodies of the attention kernels; TMA_BODY and TILED_F32 are
# csrc/flash_attn.cu's `body` argument.
TMA_BODY = 1  # probe_tc.cuh: q, K and V by TMA, both products on wgmma
TC_BODY = 2  # flash_tc.cuh's attend_rows_tc: K and V by cp.async, both products on wgmma
TILED_F32 = 3  # flash_f32.cuh's register-tiled float32 body: cp.async ring, CUDA cores


def body(name: str, dtype: torch.dtype) -> int:
    """The body that runs a head-split problem :func:`route` sends to
    ``name``, in ``dtype``. float32 keeps the CUDA cores (tensor cores would
    mean TF32): every route runs csrc/flash_f32.cuh's register-tiled body
    (4 x 4 logits and 4 rows of the output a thread, K and V in a two-stage
    cp.async ring, row and key groups past L skipped; ``flash_global`` holds
    rel_w in registers where kw divides 64), as ``flash_windowed`` does. In
    bfloat16 ``flash_global`` runs flash_tc.cuh's body, and both counters of
    csrc/flash_attn.cu the TMA body: at flash_whole's ViT-H shape it took as
    long as flash_tc.cuh's with rel tiles and less time without (PERF.md)."""
    if dtype != torch.bfloat16:
        return TILED_F32
    return TC_BODY if name == "flash_global" else TMA_BODY


def flash_attention_relpos(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_h: Optional[torch.Tensor],
    rel_w: Optional[torch.Tensor], scale: float, *, out_inv_scale: Optional[float] = None,
    bias3d: Optional[bool] = None,
) -> torch.Tensor:
    """Self-attention with an optional decomposed rel-pos bias.

    Args:
      q, k, v: (B, nh, L, hd).
      rel_h: (B, nh, L, kh) and rel_w: (B, nh, L, kw) bias tiles, kh*kw == L;
        both None for no bias.
      scale: softmax scale of q.
      out_inv_scale: if given and the problem takes the bias3d global kernel,
        the output is int8 at scale 1/out_inv_scale; the other routes ignore
        it and return q's dtype, as in JAX.
      bias3d: False sends a problem the bias3d global kernel would take to
        the head-split kernel with its rel tiles (JAX's augmented kernel).

    Returns (B, nh, L, hd), in q's dtype or int8.
    """
    B, nh, L, hd = q.shape
    if (rel_h is None) != (rel_w is None):
        raise ValueError("flash_attention_relpos: give both rel_h and rel_w, or neither")
    kv_size = None if rel_h is None else (rel_h.shape[-1], rel_w.shape[-1])
    if (
        tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape)
        or (kv_size is not None and (
            tuple(rel_h.shape) != (B, nh, L, kv_size[0])
            or tuple(rel_w.shape) != (B, nh, L, kv_size[1])
            or kv_size[0] * kv_size[1] != L))
    ):
        raise ValueError(
            f"flash_attention_relpos: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, rel tiles {kv_size} do not fit a kh x kw == L grid"
        )
    name = route(L, kv_size, bias3d)
    if name != "flash_global":
        out_inv_scale = None
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, rel_h, rel_w, scale, out_inv_scale=out_inv_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_relpos: no kernel for {q.device}")
    rel = () if kv_size is None else (rel_h, rel_w)
    _check_cuda(name, q.dtype, q, k, v, *rel)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {hd} > {MAX_HEAD_DIM}")
    quant = out_inv_scale is not None
    kernel_body = body(name, q.dtype)
    if kernel_body in (TMA_BODY, TILED_F32):  # their 16-byte copies take tma_operands' rows
        q, k, v = _build.tma_operands(q, k, v)
    out = torch.empty(q.shape, dtype=torch.int8 if quant else q.dtype, device=q.device)
    kh, kw = kv_size or (0, 0)
    rh, rw = (None, None) if kv_size is None else (rel_h.data_ptr(), rel_w.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if name == "flash_global":
            _build.launch(
                "flash_global", _build.DTYPE_CODE[q.dtype], int(quant), q.data_ptr(),
                k.data_ptr(), v.data_ptr(), rh, rw, out.data_ptr(), B * nh, L, q.shape[-1], kh,
                kw, float(scale * LOG2E), float(out_inv_scale) if quant else 0.0, stream,
            )
        else:
            _build.launch(
                "flash_attn", _build.DTYPE_CODE[q.dtype], int(kv_size is not None), kernel_body,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), rh, rw, out.data_ptr(), B * nh, L,
                q.shape[-1], kh, kw, float(scale * LOG2E), stream,
            )
    if out.shape[-1] != hd:
        out = out[..., :hd].contiguous()
    LAUNCHES[name] += 1
    if quant:  # only flash_global has the epilogue
        INT8_OUT[name] += 1
    return out


def attention_reference(q, k, v, rel_h, rel_w, scale):
    """Unclamped, max-subtracted softmax attention with the full (L, L) bias:
    the JAX ``attention_reference`` (``flash_attention.py:982-992``), whose
    autograd is the backward of :func:`flash_attention_relpos_trainable`."""
    B, nh, L, hd = q.shape
    s = torch.einsum("bnqc,bnkc->bnqk", q * scale, k).float()
    if rel_h is not None:
        bias = rel_h[..., :, None] + rel_w[..., None, :]
        s = s + bias.reshape(B, nh, L, L).float()
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bnkc->bnqc", p, v)


class _FlashTrainable(torch.autograd.Function):
    """Kernel forward; the backward recomputes :func:`attention_reference`
    on the saved inputs and returns its exact vjp (JAX ``_trainable_flash``,
    ``flash_attention.py:917-969``). There is no backward kernel, as in JAX."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, rel_h, rel_w)
        return flash_attention_relpos(q, k, v, rel_h, rel_w, scale)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_()
                      for t in ctx.saved_tensors]
            out = attention_reference(*leaves, ctx.scale)
            grads = iter(torch.autograd.grad(out, [t for t in leaves if t is not None], g))
        return (*(None if t is None else next(grads) for t in leaves), None)


def flash_attention_relpos_trainable(q, k, v, rel_h, rel_w, scale) -> torch.Tensor:
    """Differentiable :func:`flash_attention_relpos` (rel tiles optional):
    the kernel forward, the eager-recompute backward."""
    return _FlashTrainable.apply(q, k, v, rel_h, rel_w, float(scale))
