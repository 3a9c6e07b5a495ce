"""FQ-quantizable ViT / DeiT image classifiers, in PyTorch.

Counterpart of ``sam_quantization_tpu/models/vit_classifier.py`` (the
reference's FQ-ViT ImageNet models, fq_vit/models/vit_quant.py:25-548).
Modules carry timm's names (``patch_embed.proj``, ``blocks.{i}.attn.qkv``,
``blocks.{i}.mlp.fc1``, ``head_dist``, ...), so a published DeiT state dict
loads as it is; the quantization context is called at the JAX package's
observation points under its path strings (``qact_embed``,
``blocks.{i}.qact1`` .. ``qact4``, ``blocks.{i}.attn.qact_attn1``,
``blocks.{i}.mlp.lin1``, ``head_dist``, ...), so qparams dicts cross between
the packages. The layers are the port's ``Linear`` / ``Conv2d`` /
``LayerNorm``, so ``quant.fq.pipeline.fq_quantize_weights`` finds every
weight JAX's walk quantizes, the heads included.

Attention is two ``torch.matmul`` with float32 logits, as JAX computes it
with ``jnp.einsum`` outside any Pallas kernel; no kernel runs here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from sam_quantization_tpu_torch.models.sam import resolve_device
from sam_quantization_tpu_torch.nn import functional as F
from sam_quantization_tpu_torch.nn.layers import Conv2d, LayerNorm, Linear
from sam_quantization_tpu_torch.quant.context import NULL_CTX


@dataclasses.dataclass(frozen=True)
class ViTClassifierConfig:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    num_classes: int = 1000
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6
    distilled: bool = False  # DeiT distillation token

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def num_prefix_tokens(self) -> int:
        return 2 if self.distilled else 1

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)


VIT_B_224 = ViTClassifierConfig()
VIT_L_224 = ViTClassifierConfig(embed_dim=1024, depth=24, num_heads=16)
DEIT_T_224 = ViTClassifierConfig(embed_dim=192, depth=12, num_heads=3, distilled=True)
DEIT_S_224 = ViTClassifierConfig(embed_dim=384, depth=12, num_heads=6, distilled=True)
DEIT_B_224 = ViTClassifierConfig(embed_dim=768, depth=12, num_heads=12, distilled=True)

CLASSIFIER_CONFIGS = {
    "vit_base": VIT_B_224,
    "vit_large": VIT_L_224,
    "deit_tiny": DEIT_T_224,
    "deit_small": DEIT_S_224,
    "deit_base": DEIT_B_224,
}


def _token(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def attention(qkv_out: torch.Tensor, num_heads: int, ctx, path: str,
              bias: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention on the observed qkv output ``(Bw, L, 3C)``: float32
    logits of ``q * hd**-0.5`` against k, plus ``bias`` (float32 ``(nh, L,
    L)``) and then ``mask`` (``(nW, L, L)`` for the ``nW`` windows of each
    image) when given, in x's dtype through ``qact_attn1`` and the context's
    softmax, then p.v -> ``(Bw, L, C)`` before ``qact2``."""
    Bw, L, C3 = qkv_out.shape
    hd = C3 // (3 * num_heads)
    qkv = qkv_out.reshape(Bw, L, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = torch.matmul((q * hd**-0.5).float(), k.float().transpose(-1, -2))
    if bias is not None:
        attn = attn + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(-1, nw, num_heads, L, L) + mask[None, :, None]).reshape(
            Bw, num_heads, L, L)
    attn = ctx.act(f"{path}.qact_attn1", attn.to(qkv_out.dtype))
    attn = ctx.softmax(f"{path}.softmax", attn, scale_path=f"{path}.qact_attn1")
    out = torch.matmul(attn.float(), v.float()).to(qkv_out.dtype)
    return out.transpose(1, 2).reshape(Bw, L, C3 // 3)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, *, gen=None, device="cpu"):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, gen=gen, device=device)
        self.proj = Linear(dim, dim, gen=gen, device=device)

    def forward(self, x: torch.Tensor, ctx, path: str) -> torch.Tensor:
        """Observation points of fq_vit vit_quant.py Attention: after qkv,
        the logits, LIS, after attn.v and after proj."""
        qkv = ctx.act(f"{path}.qact1", ctx.linear(f"{path}.qkv", self.qkv, x))
        out = ctx.act(f"{path}.qact2", attention(qkv, self.num_heads, ctx, path))
        return ctx.act(f"{path}.qact3", ctx.linear(f"{path}.proj", self.proj, out))


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 (timm's names; JAX's paths ``mlp.lin1`` / ``lin2``)."""

    def __init__(self, dim: int, hidden: int, *, gen=None, device="cpu"):
        super().__init__()
        self.fc1 = Linear(dim, hidden, gen=gen, device=device)
        self.fc2 = Linear(hidden, dim, gen=gen, device=device)

    def forward(self, x: torch.Tensor, ctx, path: str) -> torch.Tensor:
        h = F.gelu(ctx.linear(f"{path}.lin1", self.fc1, x))
        h = ctx.act(f"{path}.qact1", h)
        return ctx.act(f"{path}.qact2", ctx.linear(f"{path}.lin2", self.fc2, h))


class Block(nn.Module):
    def __init__(self, cfg: ViTClassifierConfig, *, gen=None, device="cpu"):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = LayerNorm(d, cfg.ln_eps, device=device)
        self.attn = Attention(d, cfg.num_heads, gen=gen, device=device)
        self.norm2 = LayerNorm(d, cfg.ln_eps, device=device)
        self.mlp = Mlp(d, cfg.mlp_dim, gen=gen, device=device)

    def forward(self, x: torch.Tensor, ctx, path: str, in_path: str) -> torch.Tensor:
        h = ctx.layer_norm(f"{path}.norm1", self.norm1, x, in_path=in_path,
                           out_path=f"{path}.qact1")
        h = ctx.act(f"{path}.qact1", h)
        x = ctx.act(f"{path}.qact2", x + self.attn(h, ctx, f"{path}.attn"), ln_input=True)
        h = ctx.layer_norm(f"{path}.norm2", self.norm2, x, in_path=f"{path}.qact2",
                           out_path=f"{path}.qact3")
        h = self.mlp(ctx.act(f"{path}.qact3", h), ctx, f"{path}.mlp")
        return ctx.act(f"{path}.qact4", x + h, ln_input=True)


class PatchEmbed(nn.Module):
    def __init__(self, cfg, embed_dim: int, *, gen=None, device="cpu"):
        super().__init__()
        self.proj = Conv2d(cfg.in_chans, embed_dim, cfg.patch_size, stride=cfg.patch_size,
                           gen=gen, device=device)


class VisionTransformer(nn.Module):
    """ViT / DeiT on NHWC images: ``(B, H, W, 3) -> (B, num_classes)``
    logits, the mean of the two heads for DeiT. On ``device`` (CUDA unless
    the caller asks for the CPU); ``gen=None`` leaves the weights for a
    state dict to fill."""

    def __init__(self, cfg: ViTClassifierConfig, *, gen: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg, d, gen=gen, device=device)
        self.cls_token = _token(torch.zeros(1, 1, d, device=device))
        if cfg.distilled:
            self.dist_token = _token(torch.zeros(1, 1, d, device=device))
        n = cfg.num_patches + cfg.num_prefix_tokens
        pos = torch.empty(1, n, d, device=device)
        if gen is not None:
            pos = torch.randn(1, n, d, generator=gen, device=device) * 0.02
        self.pos_embed = _token(pos)
        self.blocks = nn.ModuleList(Block(cfg, gen=gen, device=device) for _ in range(cfg.depth))
        self.norm = LayerNorm(d, cfg.ln_eps, device=device)
        self.head = Linear(d, cfg.num_classes, gen=gen, device=device)
        if cfg.distilled:
            self.head_dist = Linear(d, cfg.num_classes, gen=gen, device=device)

    def forward(self, x: torch.Tensor, ctx=NULL_CTX) -> torch.Tensor:
        cfg = self.cfg
        B = x.shape[0]
        x = ctx.conv2d("patch_embed", self.patch_embed.proj, x).reshape(B, -1, cfg.embed_dim)
        tokens = [self.cls_token.expand(B, -1, -1)]
        if cfg.distilled:
            tokens.append(self.dist_token.expand(B, -1, -1))
        x = torch.cat(tokens + [x], dim=1) + self.pos_embed.to(x.dtype)
        x = ctx.act("qact_embed", x, ln_input=True)
        for i, blk in enumerate(self.blocks):
            x = blk(x, ctx, f"blocks.{i}", f"blocks.{i - 1}.qact4" if i > 0 else "qact_embed")
        x = ctx.layer_norm("norm", self.norm, x, in_path=f"blocks.{cfg.depth - 1}.qact4",
                           out_path="qact_out")
        x = ctx.act("qact_out", x)
        logits = ctx.linear("head", self.head, x[:, 0])
        if cfg.distilled:
            return (logits + ctx.linear("head_dist", self.head_dist, x[:, 1])) / 2.0
        return logits


def init(cfg: ViTClassifierConfig, seed: int = 0, device="cuda") -> VisionTransformer:
    """A classifier with random weights drawn from ``seed`` on ``device``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return VisionTransformer(cfg, gen=gen, device=device).eval()


def calibrate_classifier(model: nn.Module, fqcfg, batches):
    """FQ calibration of a classifier (fq_vit/test_quant.py's loop): the
    batches stream through ``model`` under ``calib`` contexts, the last
    under ``last_calib``; returns the qparams ``{path: (scale, zero)}``."""
    from sam_quantization_tpu_torch.quant.fq import pipeline

    return pipeline.calibrate(lambda x, ctx: model(x, ctx), list(batches), fqcfg)


# ---------------------------------------------------------------------------
# JAX parameters
# ---------------------------------------------------------------------------


def jax_linear(prefix: str, p: dict) -> Dict[str, torch.Tensor]:
    """A JAX linear ``{"w": (K, N), "b": (N,)?}`` as ``prefix.weight (N, K)``
    (and ``prefix.bias``)."""
    out = {f"{prefix}.weight": torch.from_numpy(np.ascontiguousarray(np.asarray(p["w"]).T))}
    if p.get("b") is not None:
        out[f"{prefix}.bias"] = torch.from_numpy(np.array(p["b"]))
    return out


def jax_conv(prefix: str, p: dict) -> Dict[str, torch.Tensor]:
    """A JAX conv ``{"w": HWIO, "b"}`` as ``prefix.weight`` OIHW and bias."""
    w = np.ascontiguousarray(np.asarray(p["w"]).transpose(3, 2, 0, 1))
    return {f"{prefix}.weight": torch.from_numpy(w),
            f"{prefix}.bias": torch.from_numpy(np.array(p["b"]))}


def jax_norm(prefix: str, p: dict) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": torch.from_numpy(np.array(p["w"])),
            f"{prefix}.bias": torch.from_numpy(np.array(p["b"]))}


def from_jax_params(params: dict, cfg: ViTClassifierConfig) -> Dict[str, torch.Tensor]:
    """The JAX classifier's parameter tree (numpy leaves) as the port's state
    dict, under timm's names: conv HWIO -> OIHW, linear ``(K, N)`` ->
    ``(N, K)``."""
    sd = {**jax_conv("patch_embed.proj", params["patch_embed"]),
          **jax_norm("norm", params["norm"]), **jax_linear("head", params["head"])}
    for name in ("cls_token", "pos_embed") + (("dist_token",) if cfg.distilled else ()):
        sd[name] = torch.from_numpy(np.array(params[name]))
    if cfg.distilled:
        sd.update(jax_linear("head_dist", params["head_dist"]))
    for i, blk in enumerate(params["blocks"]):
        pre = f"blocks.{i}"
        sd.update(jax_norm(f"{pre}.norm1", blk["norm1"]))
        sd.update(jax_norm(f"{pre}.norm2", blk["norm2"]))
        sd.update(jax_linear(f"{pre}.attn.qkv", blk["attn"]["qkv"]))
        sd.update(jax_linear(f"{pre}.attn.proj", blk["attn"]["proj"]))
        sd.update(jax_linear(f"{pre}.mlp.fc1", blk["mlp"]["lin1"]))
        sd.update(jax_linear(f"{pre}.mlp.fc2", blk["mlp"]["lin2"]))
    return sd
