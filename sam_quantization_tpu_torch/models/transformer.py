"""TwoWayTransformer (mask-decoder core) in PyTorch.

Counterpart of ``sam_quantization_tpu/models/transformer.py``: ``depth``
blocks of (token self-attention, token->image cross-attention, MLP,
image->token cross-attention) with channel-downsampled attention, then a
final token->image attention and LayerNorm. Attention is a plain matmul +
softmax in the JAX package's order (logits in float32, divided by sqrt(hd),
cast to the working dtype, float32 softmax) rather than a fused library call,
so the two packages agree to rounding. A quantization context is called at
the JAX package's observation points (``transformer.layers.0.qact_res1``,
``transformer.final_attn.softmax``, ...), under JAX's paths, whose names
differ from the modules' (``cross_attn_t2i`` for
``cross_attn_token_to_image``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from sam_quantization_tpu_torch.models.configs import TwoWayTransformerConfig
from sam_quantization_tpu_torch.nn.layers import LayerNorm, Linear, MLPBlock
from sam_quantization_tpu_torch.quant.context import NULL_CTX


class Attention(nn.Module):
    """Projected multi-head attention (ref transformer.py:185-240)."""

    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1, *,
                 gen=None, device="cpu"):
        super().__init__()
        internal = dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = Linear(dim, internal, gen=gen, device=device)
        self.k_proj = Linear(dim, internal, gen=gen, device=device)
        self.v_proj = Linear(dim, internal, gen=gen, device=device)
        self.out_proj = Linear(internal, dim, gen=gen, device=device)

    def forward(self, q, k, v, ctx=NULL_CTX, path: str = "attn"):
        q = ctx.linear(f"{path}.q_proj", self.q_proj, q)
        k = ctx.linear(f"{path}.k_proj", self.k_proj, k)
        v = ctx.linear(f"{path}.v_proj", self.v_proj, v)
        B, Nq, C = q.shape
        Nk = k.shape[1]
        nh = self.num_heads
        hd = C // nh
        qh = q.reshape(B, Nq, nh, hd).transpose(1, 2)
        kh = k.reshape(B, Nk, nh, hd).transpose(1, 2)
        vh = v.reshape(B, Nk, nh, hd).transpose(1, 2)
        attn = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(hd)
        attn = ctx.act(f"{path}.qact_attn", attn.to(q.dtype))
        attn = ctx.softmax(f"{path}.softmax", attn, scale_path=f"{path}.qact_attn")
        out = torch.matmul(attn.float(), vh.float()).to(q.dtype)
        out = out.transpose(1, 2).reshape(B, Nq, C)
        return ctx.linear(f"{path}.out_proj", self.out_proj, out)


class TwoWayAttentionBlock(nn.Module):
    """ref TwoWayAttentionBlock (transformer.py:109-182)."""

    def __init__(self, cfg: TwoWayTransformerConfig, skip_first_layer_pe: bool, *,
                 gen=None, device="cpu"):
        super().__init__()
        d, nh, r = cfg.embedding_dim, cfg.num_heads, cfg.attention_downsample_rate
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = Attention(d, nh, gen=gen, device=device)
        self.norm1 = LayerNorm(d, cfg.ln_eps, device=device)
        self.cross_attn_token_to_image = Attention(d, nh, r, gen=gen, device=device)
        self.norm2 = LayerNorm(d, cfg.ln_eps, device=device)
        self.mlp = MLPBlock(d, cfg.mlp_dim, torch.relu, gen=gen, device=device)
        self.norm3 = LayerNorm(d, cfg.ln_eps, device=device)
        self.norm4 = LayerNorm(d, cfg.ln_eps, device=device)
        self.cross_attn_image_to_token = Attention(d, nh, r, gen=gen, device=device)

    def forward(self, queries, keys, query_pe, key_pe, ctx=NULL_CTX,
                path: str = "layer") -> Tuple[torch.Tensor, torch.Tensor]:
        """The residual-stream points feed each integer LN (PTF), as the
        encoder's qact2 / qact4 do (fq_vit transformer.py's 14 QActs)."""

        def norm(i, module, x):
            x = ctx.act(f"{path}.qact_res{i}", x, ln_input=True)
            x = ctx.layer_norm(f"{path}.norm{i}", module, x, in_path=f"{path}.qact_res{i}",
                               out_path=f"{path}.qact_ln{i}")
            return ctx.act(f"{path}.qact_ln{i}", x)

        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries, ctx, f"{path}.self_attn")
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries, ctx, f"{path}.self_attn")
        queries = norm(1, self.norm1, queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = queries + self.cross_attn_token_to_image(q, k, keys, ctx,
                                                           f"{path}.cross_attn_t2i")
        queries = norm(2, self.norm2, queries)

        mlp = self.mlp
        h = ctx.linear(f"{path}.mlp.lin2", mlp.lin2,
                       mlp.act(ctx.linear(f"{path}.mlp.lin1", mlp.lin1, queries)))
        queries = norm(3, self.norm3, queries + h)

        q = queries + query_pe
        k = keys + key_pe
        keys = keys + self.cross_attn_image_to_token(k, q, queries, ctx,
                                                     f"{path}.cross_attn_i2t")
        keys = norm(4, self.norm4, keys)
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: TwoWayTransformerConfig, *, gen=None, device="cpu"):
        super().__init__()
        d = cfg.embedding_dim
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(cfg, i == 0, gen=gen, device=device)
            for i in range(cfg.depth)
        )
        self.final_attn_token_to_image = Attention(
            d, cfg.num_heads, cfg.attention_downsample_rate, gen=gen, device=device
        )
        self.norm_final_attn = LayerNorm(d, cfg.ln_eps, device=device)

    def forward(self, image_embedding, image_pe, point_embedding, ctx=NULL_CTX,
                path: str = "transformer"):
        """image_embedding / image_pe: (B, h, w, C) NHWC. Returns (queries,
        keys) with keys as (B, h*w, C) tokens (ref transformer.py:62-106)."""
        B, h, w, C = image_embedding.shape
        keys = image_embedding.reshape(B, h * w, C)
        key_pe = image_pe.reshape(image_pe.shape[0], h * w, C).expand_as(keys)
        queries = point_embedding
        for i, layer in enumerate(self.layers):
            queries, keys = layer(queries, keys, point_embedding, key_pe, ctx,
                                  f"{path}.layers.{i}")
        q = queries + point_embedding
        k = keys + key_pe
        attn_out = self.final_attn_token_to_image(q, k, keys, ctx, f"{path}.final_attn")
        queries = ctx.act(f"{path}.qact_res_final", queries + attn_out, ln_input=True)
        queries = ctx.layer_norm(f"{path}.norm_final", self.norm_final_attn, queries,
                                 in_path=f"{path}.qact_res_final",
                                 out_path=f"{path}.qact_ln_final")
        queries = ctx.act(f"{path}.qact_ln_final", queries)
        return queries, keys
