"""ViTDet-style SAM image encoder in PyTorch, NHWC.

Counterpart of ``sam_quantization_tpu/models/image_encoder.py``: 16x16 patch
embed, absolute position embedding, ``depth`` blocks (windowed attention
except at ``global_attn_indexes``), decomposed relative-position bias, and a
two-conv neck to ``out_chans`` channels. Parameter names follow upstream
``segment_anything``, so an official state dict loads unchanged.

Attention has four branches:

* ``attn_impl="kernel"`` (default), windowed block with rel-pos: the rel-pos
  tiles are computed from the packed qkv output and
  :func:`flash_attention_qkv_packed` runs the windowed CUDA kernel;
* ``attn_impl="kernel"``, any other block (global, or a config without
  rel-pos): head-split q/k/v and the rel tiles (none without rel-pos) go to
  :func:`flash_attention_relpos`, which routes as JAX does: the bias3d
  global kernel for ViT-H's 64x64 global blocks, the head-split kernel for
  the rest (vit_tiny's 64-token global blocks, rel-less blocks);
* ``attn_impl="flash_train"``: a block with rel-pos and L <= 512 runs
  :func:`flash_attention_relpos_trainable` (kernel forward, eager-recompute
  backward; the JAX ``flash_train`` branch); every other block runs eager,
  whose backward materialises the (L, L) logits either way;
* ``attn_impl="eager"``: the JAX package's eager branch, matmul + softmax with
  the full (L, L) logits - the plain reference for the kernel branches.

On a CPU tensor the kernel wrappers run their plain versions.

Any of a block's four linears may be a ``PackedLinear`` (a quantized
encoder): qkv and proj then run the dequant-matmul kernel (the W-A8 kernels
for ``act_bits == 8``), and under ``attn_impl="kernel"`` an MLP whose two
linears pass ``fused_mlp_supported`` runs the fused quantized-MLP kernel
(the JAX ``_use_fused_mlp``, which the eager branch, like JAX's ``"xla"``,
turns off). Other MLPs, int8-activation ones among them, call their layers.

Cached-int8 blocks (``nn.packed.cache_int8``) hold ``IntLinear`` layers.
When proj is one with a static activation scale and the activations are
bfloat16, both kernel branches pass ``out_inv_scale = 1 / proj.in_scale`` to
the attention kernel, whose int8 epilogue then writes proj's int8 input
(int8-pre proj); the eager branch quantizes proj's input from bfloat16.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from sam_quantization_tpu_torch.models.configs import ImageEncoderConfig
from sam_quantization_tpu_torch.nn import functional as F
from sam_quantization_tpu_torch.nn.layers import Conv2d, LayerNorm, Linear, MLPBlock
from sam_quantization_tpu_torch.nn.packed import IntLinear
from sam_quantization_tpu_torch.ops import flash_attention, fused_mlp

ATTN_IMPLS = ("kernel", "flash_train", "eager")
# The linears of a Block, as (child, attribute): the layers a quantized
# encoder packs.
BLOCK_LINEARS = (("attn", "qkv"), ("attn", "proj"), ("mlp", "lin1"), ("mlp", "lin2"))


# ---------------------------------------------------------------------------
# Window partition (ref image_encoder.py:282-333)
# ---------------------------------------------------------------------------


def window_partition(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B * nw, ws, ws, C), zero-padded to multiples of ws."""
    B, H, W, C = x.shape
    pad_h, pad_w = (-H) % ws, (-W) % ws
    if pad_h or pad_w:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)
    return x, (Hp, Wp)


def window_unpartition(
    windows: torch.Tensor, ws: int, pad_hw: Tuple[int, int], hw: Tuple[int, int]
) -> torch.Tensor:
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // ((Hp // ws) * (Wp // ws))
    x = windows.reshape(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


# ---------------------------------------------------------------------------
# Decomposed relative position bias (ref image_encoder.py:336-408)
# ---------------------------------------------------------------------------


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Select the (q_size, k_size, head_dim) rel-pos rows.

    The table must already have ``2 * max(q_size, k_size) - 1`` rows, which
    holds at the image size a model was built for. Resizing the table for
    another size (the JAX package's antialiased ``jax.image.resize``) is not
    ported yet.
    """
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        raise NotImplementedError(
            f"rel-pos table has {rel_pos.shape[0]} rows, {max_rel_dist} needed: "
            "resizing the table for another image size is not ported"
        )
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def decomposed_rel_pos_tiles(
    q: torch.Tensor, rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
    q_size: Tuple[int, int], k_size: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rel_h (B, qh, qw, kh)`` and ``rel_w (B, qh, qw, kw)`` for
    ``q (B, qh*qw, d)``; the full bias is ``rel_h[..., :, None] + rel_w[..., None, :]``."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h).to(q.dtype)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w).to(q.dtype)
    r_q = q.reshape(q.shape[0], q_h, q_w, q.shape[-1])
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    return rel_h, rel_w


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    q_h, q_w = q_size
    k_h, k_w = k_size
    rel_h, rel_w = decomposed_rel_pos_tiles(q, rel_pos_h, rel_pos_w, q_size, k_size)
    B = attn.shape[0]
    attn = attn.reshape(B, q_h, q_w, k_h, k_w)
    attn = attn + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
    return attn.reshape(B, q_h * q_w, k_h * k_w)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    # Called with the eager branch's pre-softmax logits (after the rel-pos
    # bias) when set; calibration's clamp-window canary sets it.
    logit_observer = None

    def __init__(self, cfg: ImageEncoderConfig, input_size: Tuple[int, int], *,
                 gen=None, device="cpu"):
        super().__init__()
        self.cfg = cfg
        C = cfg.embed_dim
        self.qkv = Linear(C, 3 * C, bias=cfg.qkv_bias, gen=gen, device=device)
        self.proj = Linear(C, C, gen=gen, device=device)
        if cfg.use_rel_pos:
            h, w = input_size
            # zero like the JAX init (image_encoder.py:81-83)
            self.rel_pos_h = nn.Parameter(
                torch.zeros(2 * h - 1, cfg.head_dim, device=device), requires_grad=False
            )
            self.rel_pos_w = nn.Parameter(
                torch.zeros(2 * w - 1, cfg.head_dim, device=device), requires_grad=False
            )

    def _packed_rel_and_flash(self, qkv, kh: int, kw: int) -> torch.Tensor:
        """Rel-pos tiles from the packed qkv output + the windowed kernel.
        ``qkv``: (NW, kh*kw, 3*nh*hd); returns (NW, kh*kw, nh*hd)."""
        nh, hd = self.cfg.num_heads, self.cfg.head_dim
        NW = qkv.shape[0]
        Rh = get_rel_pos(kh, kh, self.rel_pos_h).to(qkv.dtype)
        Rw = get_rel_pos(kw, kw, self.rel_pos_w).to(qkv.dtype)
        qg = qkv[:, :, : nh * hd].reshape(NW, kh, kw, nh, hd)
        rel_h = torch.einsum("bhwnc,hkc->bnhwk", qg, Rh)
        rel_w = torch.einsum("bhwnc,wkc->bnhwk", qg, Rw)
        rel = torch.cat([rel_h, rel_w], -1).reshape(NW, nh, kh * kw, kh + kw)
        return flash_attention.flash_attention_qkv_packed(
            qkv.contiguous(), rel.contiguous(), hd**-0.5, nh=nh, hd=hd, kh=kh, kw=kw,
            out_inv_scale=self._proj_inv_scale(qkv.dtype),
        )

    def _proj_inv_scale(self, dtype) -> Optional[float]:
        """``1 / proj.in_scale``, divided in float32, when the attention kernel
        should emit proj's int8 input: proj is an ``IntLinear`` with a static
        scale and the activations are bfloat16 (the int8-pre product returns
        bfloat16, so a float32 pipeline keeps its own quantize pass)."""
        proj = self.proj
        if isinstance(proj, IntLinear) and proj.in_scale is not None and dtype == torch.bfloat16:
            return float(1.0 / torch.tensor(proj.in_scale_value, dtype=torch.float32))
        return None

    def forward(self, x: torch.Tensor, windowed: bool, attn_impl: str = "kernel"):
        """(B, H, W, C) tokens -> (B, H, W, C); ``windowed`` selects the
        packed windowed kernel for the kernel branch (with rel-pos)."""
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
        cfg = self.cfg
        B, H, W, C = x.shape
        nh, hd = cfg.num_heads, cfg.head_dim
        L = H * W
        qkv = self.qkv(x.reshape(B, L, C))

        if attn_impl == "kernel" and windowed and cfg.use_rel_pos:
            out = self._packed_rel_and_flash(qkv, H, W)
            return self.proj(out.reshape(B, H, W, C))

        qkv = qkv.reshape(B, L, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, nh, L, hd)
        q2 = q.reshape(B * nh, L, hd)
        train = (attn_impl == "flash_train" and cfg.use_rel_pos
                 and L <= flash_attention.WHOLE_MAX_L)
        if attn_impl == "kernel" or train:
            rel_h = rel_w = None
            if cfg.use_rel_pos:
                rel_h, rel_w = decomposed_rel_pos_tiles(
                    q2, self.rel_pos_h, self.rel_pos_w, (H, W), (H, W)
                )
                rel_h = rel_h.reshape(B, nh, L, H).contiguous()
                rel_w = rel_w.reshape(B, nh, L, W).contiguous()
            qkv_rel = (q.contiguous(), k.contiguous(), v.contiguous(), rel_h, rel_w, hd**-0.5)
            if train:
                out = flash_attention.flash_attention_relpos_trainable(*qkv_rel)
            else:  # routes other than the bias3d kernel ignore out_inv_scale
                out = flash_attention.flash_attention_relpos(
                    *qkv_rel, out_inv_scale=self._proj_inv_scale(x.dtype))
        else:
            k2 = k.reshape(B * nh, L, hd)
            v2 = v.reshape(B * nh, L, hd)
            attn = torch.matmul((q2 * hd**-0.5).float(), k2.float().transpose(-1, -2))
            attn = attn.to(x.dtype)
            if cfg.use_rel_pos:
                attn = add_decomposed_rel_pos(
                    attn, q2, self.rel_pos_h, self.rel_pos_w, (H, W), (H, W)
                )
            if self.logit_observer is not None:
                self.logit_observer(attn)
            attn = torch.softmax(attn.float(), dim=-1).to(attn.dtype)
            out = torch.matmul(attn.float(), v2.float()).to(x.dtype)
        out = out.reshape(B, nh, H, W, hd).permute(0, 2, 3, 1, 4).reshape(B, H, W, C)
        return self.proj(out)


class Block(nn.Module):
    """One transformer block (ref Block.forward, image_encoder.py:189-207)."""

    def __init__(self, cfg: ImageEncoderConfig, idx: int, *, gen=None, device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.window_size = cfg.block_window(idx)
        C = cfg.embed_dim
        self.norm1 = LayerNorm(C, cfg.ln_eps, device=device)
        self.attn = Attention(cfg, cfg.block_input_size(idx), gen=gen, device=device)
        self.norm2 = LayerNorm(C, cfg.ln_eps, device=device)
        self.mlp = MLPBlock(C, cfg.mlp_dim, gen=gen, device=device)

    def forward(self, x: torch.Tensor, attn_impl: str = "kernel") -> torch.Tensor:
        ws = self.window_size
        shortcut = x
        x = self.norm1(x)
        H, W = x.shape[1], x.shape[2]
        if ws > 0:
            x, pad_hw = window_partition(x, ws)
        x = self.attn(x, windowed=ws > 0, attn_impl=attn_impl)
        if ws > 0:
            x = window_unpartition(x, ws, pad_hw, (H, W))
        x = shortcut + x
        h = self.norm2(x)
        lin1, lin2 = self.mlp.lin1, self.mlp.lin2
        if attn_impl == "kernel" and fused_mlp.fused_mlp_supported(lin1, lin2):
            h = fused_mlp.fused_mlp(h, lin1, lin2)
        else:
            h = self.mlp(h)
        return x + h


class ImageEncoderViT(nn.Module):
    """(B, H, W, 3) preprocessed image -> (B, h, w, out_chans) embedding."""

    def __init__(self, cfg: ImageEncoderConfig, *, gen: Optional[torch.Generator] = None,
                 device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv2d(
            cfg.in_chans, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size,
            gen=gen, device=device,
        )
        if cfg.use_abs_pos:
            g = cfg.grid_size
            self.pos_embed = nn.Parameter(
                torch.zeros(1, g, g, cfg.embed_dim, device=device), requires_grad=False
            )
        self.blocks = nn.ModuleList(
            Block(cfg, i, gen=gen, device=device) for i in range(cfg.depth)
        )
        self.neck = nn.Sequential(
            Conv2d(cfg.embed_dim, cfg.out_chans, 1, bias=False, gen=gen, device=device),
            LayerNorm(cfg.out_chans, cfg.ln_eps, device=device),
            Conv2d(cfg.out_chans, cfg.out_chans, 3, padding=1, bias=False, gen=gen,
                   device=device),
            LayerNorm(cfg.out_chans, cfg.ln_eps, device=device),
        )

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed.proj(x)
        if self.cfg.use_abs_pos:
            x = x + self.pos_embed.to(x.dtype)
        return x

    def forward(self, x: torch.Tensor, attn_impl: str = "kernel") -> torch.Tensor:
        x = self.embed(x)
        for blk in self.blocks:
            x = blk(x, attn_impl)
        return self.neck(x)
