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

Every forward takes a quantization context (``quant.context``), called at
the JAX package's observation points under its path strings (``blocks.3.
attn.qact_attn1``, ``blocks.3.norm2``, ``neck.ln1``, ...). The kernel,
``flash_train`` and fused-MLP branches run only under ``NullCtx`` itself,
as JAX guards them with ``type(ctx) is type(NULL_CTX)``: any other context
(FQ-ViT's ``FQCtx``) runs the eager branch, whose hooks it needs, whatever
``attn_impl`` says. Under ``NULL_CTX`` the hooks call the modules or return
their inputs, so the float, GPTQ and packed paths run the ops they ran.

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
from sam_quantization_tpu_torch.quant.context import NULL_CTX, NullCtx

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

    def forward(self, x: torch.Tensor, windowed: bool, attn_impl: str = "kernel",
                ctx=NULL_CTX, path: str = "attn"):
        """(B, H, W, C) tokens -> (B, H, W, C); ``windowed`` selects the
        packed windowed kernel for the kernel branch (with rel-pos).
        Observation points: fq_vit/models/sam/image_encoder.py:446-478."""
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
        cfg = self.cfg
        B, H, W, C = x.shape
        nh, hd = cfg.num_heads, cfg.head_dim
        L = H * W
        qkv = ctx.linear(f"{path}.qkv", self.qkv, x.reshape(B, L, C))
        qkv = ctx.act(f"{path}.qact1", qkv)
        hookless = type(ctx) is NullCtx  # the kernels have no observation points

        if hookless and attn_impl == "kernel" and windowed and cfg.use_rel_pos:
            out = self._packed_rel_and_flash(qkv, H, W).reshape(B, H, W, C)
            return self._project(out, ctx, path)

        qkv = qkv.reshape(B, L, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, nh, L, hd)
        q2 = q.reshape(B * nh, L, hd)
        train = (hookless and attn_impl == "flash_train" and cfg.use_rel_pos
                 and L <= flash_attention.WHOLE_MAX_L)
        if (hookless and attn_impl == "kernel") or train:
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
            attn = ctx.act(f"{path}.qact_attn1", attn.to(x.dtype))
            scale_path = f"{path}.qact_attn1"
            if cfg.use_rel_pos:
                attn = add_decomposed_rel_pos(
                    attn, q2, self.rel_pos_h, self.rel_pos_w, (H, W), (H, W)
                )
                attn = ctx.act(f"{path}.rel_pos_qact", attn)
                scale_path = f"{path}.rel_pos_qact"
            if self.logit_observer is not None:
                self.logit_observer(attn)
            attn = ctx.softmax(f"{path}.softmax", attn, scale_path=scale_path)
            out = torch.matmul(attn.float(), v2.float()).to(x.dtype)
            del attn
        out = out.reshape(B, nh, H, W, hd).permute(0, 2, 3, 1, 4).reshape(B, H, W, C)
        return self._project(out, ctx, path)

    def _project(self, out: torch.Tensor, ctx, path: str) -> torch.Tensor:
        out = ctx.act(f"{path}.qact2", out)
        out = ctx.linear(f"{path}.proj", self.proj, out)
        return ctx.act(f"{path}.qact3", out)


class Block(nn.Module):
    """One transformer block (ref Block.forward, image_encoder.py:189-207;
    observation points fq_vit image_encoder.py:313-331), at the JAX path
    ``blocks.{idx}``."""

    def __init__(self, cfg: ImageEncoderConfig, idx: int, *, gen=None, device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.window_size = cfg.block_window(idx)
        self.path = f"blocks.{idx}"
        # the previous residual's quantizer feeds norm1's integer LN
        self.in_path = f"blocks.{idx - 1}.qact4" if idx > 0 else "qact_embed"
        C = cfg.embed_dim
        self.norm1 = LayerNorm(C, cfg.ln_eps, device=device)
        self.attn = Attention(cfg, cfg.block_input_size(idx), gen=gen, device=device)
        self.norm2 = LayerNorm(C, cfg.ln_eps, device=device)
        self.mlp = MLPBlock(C, cfg.mlp_dim, gen=gen, device=device)

    def forward(self, x: torch.Tensor, attn_impl: str = "kernel", ctx=NULL_CTX) -> torch.Tensor:
        ws, path = self.window_size, self.path
        shortcut = x
        x = ctx.layer_norm(f"{path}.norm1", self.norm1, x, in_path=self.in_path,
                           out_path=f"{path}.qact1")
        x = ctx.act(f"{path}.qact1", x)
        H, W = x.shape[1], x.shape[2]
        if ws > 0:
            x, pad_hw = window_partition(x, ws)
        x = self.attn(x, windowed=ws > 0, attn_impl=attn_impl, ctx=ctx, path=f"{path}.attn")
        if ws > 0:
            x = window_unpartition(x, ws, pad_hw, (H, W))
        x = ctx.act(f"{path}.qact2", shortcut + x, ln_input=True)
        h = ctx.layer_norm(f"{path}.norm2", self.norm2, x, in_path=f"{path}.qact2",
                           out_path=f"{path}.qact3")
        h = ctx.act(f"{path}.qact3", h)
        mlp = self.mlp
        if (type(ctx) is NullCtx and attn_impl == "kernel"
                and fused_mlp.fused_mlp_supported(mlp.lin1, mlp.lin2)):
            h = fused_mlp.fused_mlp(h, mlp.lin1, mlp.lin2)
        else:
            h = mlp.act(ctx.linear(f"{path}.mlp.lin1", mlp.lin1, h))
            h = ctx.act(f"{path}.mlp.qact1", h)
            h = ctx.linear(f"{path}.mlp.lin2", mlp.lin2, h)
            h = ctx.act(f"{path}.mlp.qact2", h)
        return ctx.act(f"{path}.qact4", x + h, ln_input=True)


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

    def embed(self, x: torch.Tensor, ctx=NULL_CTX) -> torch.Tensor:
        """Patch embed + abs pos embed: (B, H, W, 3) -> (B, h, w, C)."""
        x = ctx.conv2d("patch_embed", self.patch_embed.proj, x)
        if self.cfg.use_abs_pos:
            x = x + self.pos_embed.to(x.dtype)
        return ctx.act("qact_embed", x, ln_input=True)

    def neck_forward(self, x: torch.Tensor, ctx=NULL_CTX) -> torch.Tensor:
        """1x1 conv -> LN2d -> 3x3 conv -> LN2d (ref image_encoder.py:88-104)
        through ``self.neck``'s modules, at JAX's ``neck.*`` points: both
        channel LNs can run as integer LNs (QIntLayerNorm2D, fq_vit
        models/sam/common.py:91-148), a last-axis LN in NHWC."""
        conv1, ln1, conv2, ln2 = self.neck
        x = ctx.conv2d("neck.conv1", conv1, x)
        x = ctx.act("neck.qact_ln1_in", x, ln_input=True)
        x = ctx.layer_norm("neck.ln1", ln1, x, in_path="neck.qact_ln1_in", out_path="neck.qact1")
        x = ctx.act("neck.qact1", x)
        x = ctx.conv2d("neck.conv2", conv2, x)
        x = ctx.act("neck.qact_ln2_in", x, ln_input=True)
        x = ctx.layer_norm("neck.ln2", ln2, x, in_path="neck.qact_ln2_in", out_path="neck.qact2")
        return ctx.act("neck.qact2", x)

    def forward(self, x: torch.Tensor, attn_impl: str = "kernel", ctx=NULL_CTX) -> torch.Tensor:
        x = self.embed(x, ctx)
        for blk in self.blocks:
            x = blk(x, attn_impl, ctx)
        return self.neck_forward(x, ctx)
