"""SAM mask decoder in PyTorch.

Counterpart of ``sam_quantization_tpu/models/mask_decoder.py``: iou / mask
tokens + TwoWayTransformer, 2x transposed-conv upscaling (NHWC), one
hypernetwork MLP per mask token, and the IoU prediction head. A
quantization context is called at JAX's points: the upscaling's
``mask_decoder.*`` (its LN2d as ``mask_decoder.up_ln``), the hypernetworks'
linears as ``mask_decoder.hyper.{i}.layers.{j}`` and the IoU head's as
``mask_decoder.iou_head.layers.{j}``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from sam_quantization_tpu_torch.models.configs import MaskDecoderConfig
from sam_quantization_tpu_torch.models.transformer import TwoWayTransformer
from sam_quantization_tpu_torch.nn import functional as F
from sam_quantization_tpu_torch.nn.layers import ConvTranspose2d, Embedding, LayerNorm, Linear
from sam_quantization_tpu_torch.quant.context import NULL_CTX


class MLP(nn.Module):
    """``num_layers`` linears with ReLU between (ref mask_decoder.py:154-176)."""

    def __init__(self, in_dim, hidden, out_dim, num_layers, *, gen=None, device="cpu"):
        super().__init__()
        dims = [in_dim] + [hidden] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], gen=gen, device=device) for i in range(num_layers)
        )

    def forward(self, x, ctx=NULL_CTX, path: str = ""):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = ctx.linear(f"{path}.layers.{i}", layer, x)
            if i < n - 1:
                x = torch.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: MaskDecoderConfig, *, gen=None, device="cpu"):
        super().__init__()
        self.cfg = cfg
        d = cfg.transformer_dim
        self.transformer = TwoWayTransformer(cfg.transformer, gen=gen, device=device)
        self.iou_token = Embedding(1, d, gen=gen, device=device)
        self.mask_tokens = Embedding(cfg.num_mask_tokens, d, gen=gen, device=device)
        # upstream indices: 0 convT, 1 LayerNorm2d, 2 GELU, 3 convT, 4 GELU
        self.output_upscaling = nn.ModuleDict({
            "0": ConvTranspose2d(d, d // 4, 2, gen=gen, device=device),
            "1": LayerNorm(d // 4, cfg.ln_eps, device=device),
            "3": ConvTranspose2d(d // 4, d // 8, 2, gen=gen, device=device),
        })
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, 3, gen=gen, device=device) for _ in range(cfg.num_mask_tokens)
        )
        self.iou_prediction_head = MLP(
            d, cfg.iou_head_hidden_dim, cfg.num_mask_tokens, cfg.iou_head_depth,
            gen=gen, device=device,
        )

    def predict_masks(self, image_embeddings, image_pe, sparse, dense, ctx=NULL_CTX):
        """image_embeddings (1 or B, h, w, C), dense (B, h, w, C), sparse
        (B, N, C) -> masks (B, num_mask_tokens, 4h, 4w), iou (B, num_mask_tokens)."""
        cfg = self.cfg
        B = sparse.shape[0]
        output_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        output_tokens = output_tokens[None].expand(B, -1, -1)
        tokens = torch.cat([output_tokens, sparse.to(output_tokens.dtype)], dim=1)

        src = image_embeddings.expand(B, -1, -1, -1) + dense.to(image_embeddings.dtype)
        _, h, w, c = src.shape
        hs, src = self.transformer(src, image_pe, tokens, ctx)
        iou_token_out = hs[:, 0, :]
        mask_tokens_out = hs[:, 1 : 1 + cfg.num_mask_tokens, :]

        up = self.output_upscaling
        x = ctx.conv_transpose2d("mask_decoder.convt1", up["0"], src.reshape(B, h, w, c))
        x = ctx.act("mask_decoder.qact_up_ln_in", x, ln_input=True)
        x = ctx.layer_norm("mask_decoder.up_ln", up["1"], x,
                           in_path="mask_decoder.qact_up_ln_in", out_path="mask_decoder.qact_up_ln")
        x = F.gelu(ctx.act("mask_decoder.qact_up_ln", x))
        x = ctx.act("mask_decoder.qact_up1", x)
        x = ctx.conv_transpose2d("mask_decoder.convt2", up["3"], x)
        upscaled = ctx.act("mask_decoder.qact_up2", F.gelu(x))  # (B, 4h, 4w, d // 8)

        hyper_in = torch.stack(
            [mlp(mask_tokens_out[:, i, :], ctx, f"mask_decoder.hyper.{i}")
             for i, mlp in enumerate(self.output_hypernetworks_mlps)],
            dim=1,
        )  # (B, num_mask_tokens, d // 8)
        masks = torch.einsum("bnc,bhwc->bnhw", hyper_in.float(), upscaled.float())
        masks = masks.to(upscaled.dtype)
        return masks, self.iou_prediction_head(iou_token_out, ctx, "mask_decoder.iou_head")

    def forward(self, image_embeddings, image_pe, sparse, dense, multimask_output: bool,
                ctx=NULL_CTX):
        masks, iou_pred = self.predict_masks(image_embeddings, image_pe, sparse, dense, ctx)
        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:]
        return masks[:, :1], iou_pred[:, :1]
