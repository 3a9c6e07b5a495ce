"""SAM prompt encoder in PyTorch.

Counterpart of ``sam_quantization_tpu/models/prompt_encoder.py``: random
Fourier positional encoding, point / box / mask prompt embedding, and the
``no_mask_embed`` fallback. Prompts are fixed-shape padded tensors: a point
label of ``-1`` marks a padding slot, and ``mask_valid`` selects per batch
row between the mask embedding and ``no_mask_embed``. Dense outputs are NHWC.
The mask downscaling calls its modules through a quantization context at
JAX's ``prompt_encoder.*`` points, so FQ-ViT reaches its two LN2ds.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from sam_quantization_tpu_torch.models.configs import PromptEncoderConfig
from sam_quantization_tpu_torch.nn import functional as F
from sam_quantization_tpu_torch.nn.layers import Conv2d, Embedding, LayerNorm
from sam_quantization_tpu_torch.quant.context import NULL_CTX


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, embed_dim: int, *, gen=None, device="cpu"):
        super().__init__()
        g = torch.empty(2, embed_dim // 2, device=device)
        if gen is not None:
            g.normal_(generator=gen)
        # A parameter, not upstream's buffer: the JAX pytree leaf
        # ``pe_gaussian`` is trained (optax updates and decays it), so the
        # trainer optimises it too. The state-dict key is upstream's.
        self.positional_encoding_gaussian_matrix = nn.Parameter(g, requires_grad=False)

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        """[0, 1]-normalised (..., 2) coords -> (..., embed_dim)."""
        coords = 2.0 * coords - 1.0
        coords = coords.float() @ self.positional_encoding_gaussian_matrix
        coords = 2.0 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: PromptEncoderConfig, *, gen=None, device="cpu"):
        super().__init__()
        self.cfg = cfg
        d, mc = cfg.embed_dim, cfg.mask_in_chans
        self.pe_layer = PositionEmbeddingRandom(d, gen=gen, device=device)
        # neg, pos, box top-left, box bottom-right
        self.point_embeddings = nn.ModuleList(
            Embedding(1, d, gen=gen, device=device) for _ in range(4)
        )
        self.not_a_point_embed = Embedding(1, d, gen=gen, device=device)
        self.no_mask_embed = Embedding(1, d, gen=gen, device=device)
        # upstream indices 0..6 with GELUs at 2 and 5 (no parameters)
        self.mask_downscaling = nn.ModuleDict({
            "0": Conv2d(1, mc // 4, 2, stride=2, gen=gen, device=device),
            "1": LayerNorm(mc // 4, cfg.ln_eps, device=device),
            "3": Conv2d(mc // 4, mc, 2, stride=2, gen=gen, device=device),
            "4": LayerNorm(mc, cfg.ln_eps, device=device),
            "6": Conv2d(mc, d, 1, gen=gen, device=device),
        })

    def get_dense_pe(self) -> torch.Tensor:
        """Dense PE grid, (1, h, w, embed_dim) NHWC."""
        h, w = self.cfg.image_embedding_size
        dev = self.pe_layer.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)  # (h, w, [x, y])
        return self.pe_layer(grid)[None]

    def _pe_at(self, coords: torch.Tensor) -> torch.Tensor:
        h, w = self.cfg.input_image_size
        return self.pe_layer(coords / torch.tensor([w, h], dtype=torch.float32,
                                                   device=coords.device))

    def embed_points(self, coords, labels, pad: bool = True) -> torch.Tensor:
        """(B, N, 2) pixel coords + (B, N) labels -> (B, N(+1), d).
        Labels: 1 positive, 0 negative, 2/3 box corners, -1 padding."""
        coords = coords + 0.5
        if pad:
            B = coords.shape[0]
            coords = torch.cat([coords, coords.new_zeros(B, 1, 2)], dim=1)
            labels = torch.cat([labels, -labels.new_ones(B, 1)], dim=1)
        pe = self._pe_at(coords)
        lab = labels[..., None]
        zero = pe.new_zeros(())
        pe = torch.where(lab == -1, zero, pe)
        pe = pe + torch.where(lab == -1, self.not_a_point_embed.weight[0], zero)
        for i in range(4):
            pe = pe + torch.where(lab == i, self.point_embeddings[i].weight[0], zero)
        return pe

    def embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """(B, 4) boxes -> (B, 2, d) corner embeddings."""
        corners = (boxes + 0.5).reshape(-1, 2, 2)
        pe = self._pe_at(corners)
        corner_embed = torch.stack(
            [self.point_embeddings[2].weight[0], self.point_embeddings[3].weight[0]]
        )
        return pe + corner_embed

    def embed_masks(self, masks: torch.Tensor, ctx=NULL_CTX) -> torch.Tensor:
        """(B, 4h, 4w, 1) NHWC mask logits -> (B, h, w, d) (JAX
        prompt_encoder.py:108-133)."""
        md = self.mask_downscaling
        x = ctx.conv2d("prompt_encoder.mask_conv1", md["0"], masks)
        x = ctx.act("prompt_encoder.qact_mln1_in", x, ln_input=True)
        x = ctx.layer_norm("prompt_encoder.mask_ln1", md["1"], x,
                           in_path="prompt_encoder.qact_mln1_in",
                           out_path="prompt_encoder.qact_mln1")
        x = F.gelu(ctx.act("prompt_encoder.qact_mln1", x))
        x = ctx.conv2d("prompt_encoder.mask_conv2", md["3"], x)
        x = ctx.act("prompt_encoder.qact_mln2_in", x, ln_input=True)
        x = ctx.layer_norm("prompt_encoder.mask_ln2", md["4"], x,
                           in_path="prompt_encoder.qact_mln2_in",
                           out_path="prompt_encoder.qact_mln2")
        x = F.gelu(ctx.act("prompt_encoder.qact_mln2", x))
        return ctx.conv2d("prompt_encoder.mask_conv3", md["6"], x)

    def no_mask_dense(self, batch: int) -> torch.Tensor:
        h, w = self.cfg.image_embedding_size
        return self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(batch, h, w, -1)

    def forward(
        self,
        points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        boxes: Optional[torch.Tensor] = None,
        masks: Optional[torch.Tensor] = None,
        mask_valid: Optional[torch.Tensor] = None,
        ctx=NULL_CTX,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sparse (B, N, d) and dense (B, h, w, d) prompt embeddings."""
        parts = []
        bs = 1
        if points is not None:
            coords, labels = points
            bs = coords.shape[0]
            parts.append(self.embed_points(coords, labels, pad=boxes is None))
        if boxes is not None:
            bs = boxes.shape[0]
            parts.append(self.embed_boxes(boxes))
        dev = self.no_mask_embed.weight.device
        sparse = (
            torch.cat(parts, dim=1) if parts
            else torch.zeros(bs, 0, self.cfg.embed_dim, device=dev)
        )
        if masks is not None:
            dense = self.embed_masks(masks, ctx)
            if mask_valid is not None:
                dense = torch.where(
                    mask_valid.reshape(-1, 1, 1, 1), dense, self.no_mask_dense(bs)
                )
        else:
            dense = self.no_mask_dense(bs)
        return sparse, dense
