"""Top-level SAM model: preprocess -> encoder -> prompts -> decoder -> postprocess.

Counterpart of ``sam_quantization_tpu/models/sam.py``. :class:`Sam` holds the
three sub-modules under the upstream names (``image_encoder``,
``prompt_encoder``, ``mask_decoder``); the functions below mirror the JAX
package's, with every image tensor NHWC and masks (B, N, H, W).
``postprocess_masks`` reproduces ``jax.image.resize``: bilinear with
half-pixel centres, antialiased where it shrinks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as TF
from torch import nn

from sam_quantization_tpu_torch.models.configs import SamConfig
from sam_quantization_tpu_torch.models.image_encoder import ImageEncoderViT
from sam_quantization_tpu_torch.models.mask_decoder import MaskDecoder
from sam_quantization_tpu_torch.models.prompt_encoder import PromptEncoder
from sam_quantization_tpu_torch.quant.context import NULL_CTX


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


class Sam(nn.Module):
    """The three sub-modules on ``device`` (CUDA unless the caller asks for
    the CPU); ``gen=None`` leaves the weights for a state dict to fill."""

    def __init__(self, cfg: SamConfig, *, gen: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg
        self.image_encoder = ImageEncoderViT(cfg.image_encoder, gen=gen, device=device)
        self.prompt_encoder = PromptEncoder(cfg.prompt_encoder, gen=gen, device=device)
        self.mask_decoder = MaskDecoder(cfg.mask_decoder, gen=gen, device=device)

    @property
    def mask_threshold(self) -> float:
        return self.config.mask_threshold

    @property
    def device(self) -> torch.device:
        return self.mask_decoder.iou_token.weight.device


def init(cfg: SamConfig, seed: int = 0, device="cuda") -> Sam:
    """A model with random weights drawn from ``seed`` on ``device``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return Sam(cfg, gen=gen, device=device).eval()


def preprocess(model: Sam, x: torch.Tensor) -> torch.Tensor:
    """Normalise pixels and pad bottom/right to the square input
    (ref sam.py:160-174). x: (B, H, W, 3) NHWC RGB, H/W <= img_size."""
    cfg = model.config
    mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(cfg.pixel_std, dtype=torch.float32, device=x.device)
    x = (x.float() - mean) / std
    _, H, W, _ = x.shape
    size = cfg.image_encoder.img_size
    return TF.pad(x, (0, 0, 0, size - W, 0, size - H))


def encode_image(model: Sam, x: torch.Tensor, attn_impl: str = "kernel",
                 ctx=NULL_CTX) -> torch.Tensor:
    """(B, img, img, 3) preprocessed image -> (B, h, w, 256) embedding, in x's
    dtype, through the quantization context ``ctx`` (JAX sam.py:65-71; a
    context other than ``NULL_CTX`` runs the eager branch)."""
    return model.image_encoder(x, attn_impl, ctx)


def get_dense_pe(model: Sam) -> torch.Tensor:
    return model.prompt_encoder.get_dense_pe()


def decode_masks(
    model: Sam,
    image_embeddings: torch.Tensor,
    points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    boxes: Optional[torch.Tensor] = None,
    mask_inputs: Optional[torch.Tensor] = None,
    mask_valid: Optional[torch.Tensor] = None,
    multimask_output: bool = True,
    ctx=NULL_CTX,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prompt-encode + decode through ``ctx``. Returns (low_res_masks
    (B, N, 4h, 4w), iou_pred)."""
    sparse, dense = model.prompt_encoder(
        points=points, boxes=boxes, masks=mask_inputs, mask_valid=mask_valid, ctx=ctx
    )
    return model.mask_decoder(
        image_embeddings, get_dense_pe(model), sparse, dense, multimask_output, ctx
    )


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize the last two axes of (B, C, H, W) like ``jax.image.resize``
    'bilinear': half-pixel centres, and a triangle filter widened by the
    scale (antialiasing) on an axis that shrinks."""
    shrink = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return TF.interpolate(
        x, size=tuple(size), mode="bilinear", align_corners=False, antialias=shrink
    )


def postprocess_masks(
    model: Sam, masks: torch.Tensor, input_size: Tuple[int, int],
    original_size: Tuple[int, int],
) -> torch.Tensor:
    """(B, N, 4h, 4w) low-res logits -> (B, N, *original_size) (ref sam.py:126-158)."""
    size = model.config.image_encoder.img_size
    m = resize_bilinear(masks, (size, size))
    m = m[..., : input_size[0], : input_size[1]]
    return resize_bilinear(m, tuple(original_size))
