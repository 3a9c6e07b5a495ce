"""FQ-quantizable Swin Transformer classifier, in PyTorch.

Counterpart of ``sam_quantization_tpu/models/swin_classifier.py`` (the
reference's fq_vit Swin models, fq_vit/models/swin_quant.py:19-901): four
stages with patch merging, shifted-window attention with learned
relative-position-bias tables, and the FQ observation points of the other
models, under the JAX package's path strings (``stages.{s}.blocks.{i}.qact0``,
``...attn.qact_attn1``, ``stages.{s}.downsample``, ...). Modules carry the
upstream Swin names (``patch_embed.proj`` / ``.norm``,
``layers.{s}.blocks.{i}.attn.relative_position_bias_table``,
``layers.{s}.downsample.reduction``, ``head``) with their buffers
(``relative_position_index``, ``attn_mask``), so a published state dict
loads as it is.

Two points follow JAX where it departs from upstream Swin: the bias table
always holds ``(2 * window_size - 1)**2`` rows, indexed for the stage's
window ``min(window_size, resolution)``; and patch merging concatenates the
2x2 neighbours at (row, col) offsets (0, 0), (0, 1), (1, 0), (1, 1), where
upstream takes (0, 0), (1, 0), (0, 1), (1, 1).

LayerNorms go through the context where JAX's do (``norm1`` and the final
norm without an ``in_path``, so they stay float; ``norm2`` with its
quantizers), and the patch and downsample norms are plain, so the qparams
keys are JAX's. Attention is eager (``vit_classifier.attention``), as JAX's
``jnp.einsum``; no kernel runs here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sam_quantization_tpu_torch.models.sam import resolve_device
from sam_quantization_tpu_torch.models.vit_classifier import (
    Mlp, PatchEmbed, attention, jax_conv, jax_linear, jax_norm,
)
from sam_quantization_tpu_torch.nn.layers import LayerNorm, Linear
from sam_quantization_tpu_torch.quant.context import NULL_CTX


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    img_size: int = 224
    patch_size: int = 4
    in_chans: int = 3
    num_classes: int = 1000
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-5

    def stage_dim(self, s: int) -> int:
        return self.embed_dim * (2**s)

    def stage_resolution(self, s: int) -> int:
        return self.img_size // self.patch_size // (2**s)


SWIN_T = SwinConfig()
SWIN_S = SwinConfig(depths=(2, 2, 18, 2))
SWIN_B = SwinConfig(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32))

SWIN_CONFIGS = {"swin_tiny": SWIN_T, "swin_small": SWIN_S, "swin_base": SWIN_B}


def _rel_bias_index(ws: int) -> np.ndarray:
    """Relative-position index for a ws x ws window (swin reference math)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)  # (ws*ws, ws*ws)


def _shift_attn_mask(res: int, ws: int, shift: int) -> np.ndarray:
    """Attention mask for shifted windows (-100 at cross-region pairs)."""
    img_mask = np.zeros((1, res, res, 1))
    cnt = 0
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for h in slices:
        for w in slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    nw = res // ws
    m = img_mask.reshape(1, nw, ws, nw, ws, 1).transpose(0, 1, 3, 2, 4, 5)
    m = m.reshape(-1, ws * ws)
    attn_mask = m[:, None, :] - m[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, ws: int, *, gen=None,
                 device="cpu"):
        super().__init__()
        self.num_heads, self.ws = num_heads, ws
        self.qkv = Linear(dim, 3 * dim, gen=gen, device=device)
        self.proj = Linear(dim, dim, gen=gen, device=device)
        table = torch.empty((2 * window_size - 1) ** 2, num_heads, device=device)
        if gen is not None:
            table = torch.randn(table.shape, generator=gen, device=device) * 0.02
        self.relative_position_bias_table = nn.Parameter(table, requires_grad=False)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_rel_bias_index(ws)).to(device))

    def forward(self, xw: torch.Tensor, mask: Optional[torch.Tensor], ctx,
                path: str) -> torch.Tensor:
        """Windows ``(B * nW, L, C)`` -> ``(B * nW, L, C)``; the rel bias is
        added to the float32 logits before ``qact_attn1``, then the mask."""
        L = self.ws * self.ws
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        bias = bias.reshape(L, L, self.num_heads).permute(2, 0, 1).float()
        qkv = ctx.act(f"{path}.qact1", ctx.linear(f"{path}.qkv", self.qkv, xw))
        out = attention(qkv, self.num_heads, ctx, path, bias=bias, mask=mask)
        out = ctx.act(f"{path}.qact2", out)
        return ctx.act(f"{path}.qact3", ctx.linear(f"{path}.proj", self.proj, out))


class SwinTransformerBlock(nn.Module):
    def __init__(self, cfg: SwinConfig, s: int, i: int, *, gen=None, device="cpu"):
        super().__init__()
        dim, res = cfg.stage_dim(s), cfg.stage_resolution(s)
        self.res = res
        self.ws = min(cfg.window_size, res)
        self.shift = 0 if (i % 2 == 0 or self.ws == res) else self.ws // 2
        self.norm1 = LayerNorm(dim, cfg.ln_eps, device=device)
        self.attn = WindowAttention(dim, cfg.num_heads[s], cfg.window_size, self.ws, gen=gen,
                                    device=device)
        self.norm2 = LayerNorm(dim, cfg.ln_eps, device=device)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio), gen=gen, device=device)
        mask = None
        if self.shift > 0:
            mask = torch.from_numpy(_shift_attn_mask(res, self.ws, self.shift)).to(device)
        self.register_buffer("attn_mask", mask)

    def _window_attention(self, x: torch.Tensor, ctx, path: str) -> torch.Tensor:
        """(B, res, res, C): roll by -shift, windows, attention, back."""
        B, H, W, C = x.shape
        ws, shift = self.ws, self.shift
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        nw = H // ws
        xw = x.reshape(B, nw, ws, nw, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)
        out = self.attn(xw, self.attn_mask, ctx, path)
        x = out.reshape(B, nw, nw, ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        return x

    def forward(self, x: torch.Tensor, ctx, path: str) -> torch.Tensor:
        h = ctx.layer_norm(f"{path}.norm1", self.norm1, x)
        h = self._window_attention(ctx.act(f"{path}.qact0", h), ctx, f"{path}.attn")
        x = ctx.act(f"{path}.qact_res1", x + h, ln_input=True)
        h = ctx.layer_norm(f"{path}.norm2", self.norm2, x, in_path=f"{path}.qact_res1",
                           out_path=f"{path}.qact_mlp_in")
        h = self.mlp(ctx.act(f"{path}.qact_mlp_in", h), ctx, f"{path}.mlp")
        return ctx.act(f"{path}.qact_res2", x + h, ln_input=True)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, eps: float, *, gen=None, device="cpu"):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps, device=device)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, gen=gen, device=device)

    def forward(self, x: torch.Tensor, ctx, path: str) -> torch.Tensor:
        """2x2 neighbourhood concat (JAX's order) -> plain LN -> linear / 2."""
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
        x = x.reshape(B, H // 2, W // 2, 4 * C)
        x = torch.cat([x[..., 0:C], x[..., 2 * C:3 * C], x[..., C:2 * C], x[..., 3 * C:]],
                      dim=-1)
        return ctx.linear(path, self.reduction, self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, cfg: SwinConfig, s: int, *, gen=None, device="cpu"):
        super().__init__()
        self.blocks = nn.ModuleList(SwinTransformerBlock(cfg, s, i, gen=gen, device=device)
                                    for i in range(cfg.depths[s]))
        self.downsample = None
        if s < len(cfg.depths) - 1:
            self.downsample = PatchMerging(cfg.stage_dim(s), cfg.ln_eps, gen=gen, device=device)


class SwinTransformer(nn.Module):
    """Swin on NHWC images: ``(B, H, W, 3) -> (B, num_classes)`` logits. On
    ``device`` (CUDA unless the caller asks for the CPU); ``gen=None``
    leaves the weights for a state dict to fill."""

    def __init__(self, cfg: SwinConfig, *, gen: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg, cfg.embed_dim, gen=gen, device=device)
        self.patch_embed.norm = LayerNorm(cfg.embed_dim, cfg.ln_eps, device=device)
        self.layers = nn.ModuleList(BasicLayer(cfg, s, gen=gen, device=device)
                                    for s in range(len(cfg.depths)))
        last = cfg.stage_dim(len(cfg.depths) - 1)
        self.norm = LayerNorm(last, cfg.ln_eps, device=device)
        self.head = Linear(last, cfg.num_classes, gen=gen, device=device)

    def forward(self, x: torch.Tensor, ctx=NULL_CTX) -> torch.Tensor:
        B = x.shape[0]
        x = self.patch_embed.norm(ctx.conv2d("patch_embed", self.patch_embed.proj, x))
        x = ctx.act("qact_embed", x, ln_input=True)
        for s, layer in enumerate(self.layers):
            for i, blk in enumerate(layer.blocks):
                x = blk(x, ctx, f"stages.{s}.blocks.{i}")
            if layer.downsample is not None:
                x = layer.downsample(x, ctx, f"stages.{s}.downsample")
        x = ctx.act("qact_out", ctx.layer_norm("norm", self.norm, x))
        x = x.reshape(B, -1, x.shape[-1]).mean(dim=1)  # global average pool
        return ctx.linear("head", self.head, x)


def init(cfg: SwinConfig, seed: int = 0, device="cuda") -> SwinTransformer:
    """A Swin classifier with random weights drawn from ``seed`` on ``device``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return SwinTransformer(cfg, gen=gen, device=device).eval()


def from_jax_params(params: dict, cfg: SwinConfig) -> Dict[str, torch.Tensor]:
    """The JAX Swin parameter tree (numpy leaves) as the port's parameters
    (no buffers; load with ``strict=False`` or into a built model), under
    the upstream names: conv HWIO -> OIHW, linear ``(K, N)`` -> ``(N, K)``."""
    sd = {**jax_conv("patch_embed.proj", params["patch_embed"]),
          **jax_norm("patch_embed.norm", params["patch_norm"]),
          **jax_norm("norm", params["norm"]), **jax_linear("head", params["head"])}
    for s, stage in enumerate(params["stages"]):
        for i, blk in enumerate(stage["blocks"]):
            pre = f"layers.{s}.blocks.{i}"
            sd.update(jax_norm(f"{pre}.norm1", blk["norm1"]))
            sd.update(jax_norm(f"{pre}.norm2", blk["norm2"]))
            sd.update(jax_linear(f"{pre}.attn.qkv", blk["attn"]["qkv"]))
            sd.update(jax_linear(f"{pre}.attn.proj", blk["attn"]["proj"]))
            sd[f"{pre}.attn.relative_position_bias_table"] = torch.from_numpy(
                np.array(blk["attn"]["rel_bias_table"]))
            sd.update(jax_linear(f"{pre}.mlp.fc1", blk["mlp"]["lin1"]))
            sd.update(jax_linear(f"{pre}.mlp.fc2", blk["mlp"]["lin2"]))
        if "downsample" in stage:
            ds = stage["downsample"]
            sd.update(jax_norm(f"layers.{s}.downsample.norm", ds["norm"]))
            sd.update(jax_linear(f"layers.{s}.downsample.reduction", ds["reduction"]))
    return sd
