"""SAM fine-tuning: interactive-click training on one card.

Counterpart of ``sam_quantization_tpu/train/trainer.py`` (the reference's DDP
trainer, train_sm.py:176-545): a click loop (clicks sampled from the
prediction error, the mask prompt fed back), normalized focal + BCE loss on
the last click, AdamW over every leaf of the JAX ``Sam`` pytree.

The encoder runs ``attn_impl="flash_train"``: the windowed blocks' attention
is the head-split kernel forward with an exact eager-recompute backward
(``ops/flash_attention.flash_attention_relpos_trainable``), the global
blocks run eager. Training runs in float32, like the JAX trainer's
parameters. Data parallel and tensor parallel training are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch
import torch.nn.functional as TF

from sam_quantization_tpu_torch.models import sam as sam_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 1e-4
    num_clicks: int = 11  # reference's interaction loop length (train_sm.py:300)
    max_points: int = 24
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    bce_weight: float = 1.0
    focal_weight: float = 20.0


def trainable_parameters(model: sam_lib.Sam) -> List[torch.nn.Parameter]:
    """Every parameter of the model, set to require grad: the leaves of the
    JAX ``Sam`` pytree (``pe_gaussian`` included; the four point embeddings
    are one leaf there and four tensors here, which AdamW, elementwise,
    updates alike)."""
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    return params


def make_optimizer(cfg: TrainConfig, model: sam_lib.Sam) -> torch.optim.AdamW:
    """One AdamW group over all leaves: ``optax.adamw``'s decoupled update
    (b1 0.9, b2 0.999, eps 1e-8, weight decay on every leaf)."""
    return torch.optim.AdamW(
        trainable_parameters(model), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg.weight_decay,
    )


def normalized_focal_loss(logits, targets, gamma=2.0, alpha=0.25):
    """NFL (RITM lineage; the reference's missing ``Losses`` module provided
    NFL+BCE, train_sm.py:18, 95-100)."""
    p = torch.sigmoid(logits)
    pos = targets > 0.5
    pt = torch.where(pos, p, 1.0 - p)
    at = torch.where(pos, alpha, 1.0 - alpha)
    beta = (1.0 - pt) ** gamma
    # normalize so sum(beta) matches sum(1 - pt) (the "normalized" in NFL)
    norm = torch.sum(1.0 - pt, dim=(-2, -1), keepdim=True) / (
        torch.sum(beta, dim=(-2, -1), keepdim=True) + 1e-6
    )
    ce = -torch.log(torch.clamp(pt, min=1e-8))
    return torch.mean(at * norm * beta * ce)


def bce_loss(logits, targets):
    """Mean sigmoid binary cross-entropy in its stable form
    (``optax.sigmoid_binary_cross_entropy``)."""
    return TF.binary_cross_entropy_with_logits(logits, targets)


def _sample_error_click(
    pred_logit: torch.Tensor, gt: torch.Tensor, gen: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One click for one image: a pixel drawn uniformly from the false
    negatives, else from the false positives, else from the whole image.
    Returns ((x, y) float32, label: 1 for a false-negative click, else 0)."""
    pred = pred_logit > 0
    gt_b = gt > 0.5
    fn = gt_b & ~pred
    fp = ~gt_b & pred
    use_fn = fn.any()
    region = torch.where(use_fn, fn, fp).reshape(-1).float()
    if not bool(region.any()):
        region = torch.ones_like(region)
    idx = torch.multinomial(region, 1, generator=gen)[0]
    W = gt.shape[-1]
    xy = torch.stack([idx % W, idx // W]).float()
    return xy, use_fn.float()


def _resize_nearest(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W) -> (B, size, size) like ``jax.image.resize(..., "nearest")``:
    half-pixel centres, which is ``nearest-exact`` (plain ``nearest`` picks
    pixel 4i, not 4i + 2, at 1024 -> 256)."""
    return TF.interpolate(x[:, None], size=(size, size), mode="nearest-exact")[:, 0]


def click_train_loss(
    model: sam_lib.Sam,
    images: torch.Tensor,  # (B, S, S, 3) raw
    gt_masks: torch.Tensor,  # (B, S, S) float 0/1
    gen: torch.Generator,
    tcfg: TrainConfig,
    attn_impl: str = "flash_train",
) -> Tuple[torch.Tensor, dict]:
    """Forward with the interactive click loop; the loss on the last click's
    prediction (reference interaction + losses, train_sm.py:298-405).

    The intermediate clicks run under ``torch.no_grad()`` on a detached
    embedding, and only the last one carries grad (the JAX loop's
    ``stop_gradient``). ``gen`` draws the clicks, on the images' device.
    ``attn_impl="eager"`` runs every block's attention eager, the reference
    ``flash_train`` is held against.
    """
    cfg = model.config
    B = images.shape[0]
    dev = images.device
    x = sam_lib.preprocess(model, images)
    emb = sam_lib.encode_image(model, x, attn_impl)

    S = cfg.image_encoder.img_size
    h4 = S // 4
    coords = torch.zeros((B, tcfg.max_points, 2), device=dev)
    labels = -torch.ones((B, tcfg.max_points), device=dev)
    mask_input = torch.zeros((B, h4, h4, 1), device=dev)
    mask_valid = torch.zeros((B,), dtype=torch.bool, device=dev)
    pred_full = torch.full((B, S, S), -10.0, device=dev)
    gt4 = _resize_nearest(gt_masks, S)

    for click in range(tcfg.num_clicks):
        for b in range(B):
            coords[b, click], labels[b, click] = _sample_error_click(pred_full[b], gt4[b], gen)
        grad_on = click == tcfg.num_clicks - 1
        with torch.set_grad_enabled(grad_on and torch.is_grad_enabled()):
            low_res, _ = sam_lib.decode_masks(
                model, emb if grad_on else emb.detach(), points=(coords, labels),
                mask_inputs=mask_input, mask_valid=mask_valid, multimask_output=False,
            )
        mask_input = low_res.detach().permute(0, 2, 3, 1)
        mask_valid = torch.ones((B,), dtype=torch.bool, device=dev)
        pred_full = sam_lib.resize_bilinear(low_res.detach(), (S, S))[:, 0]

    gt_low = _resize_nearest(gt_masks, h4)
    logits = low_res[:, 0]
    loss = tcfg.focal_weight * normalized_focal_loss(
        logits, gt_low, tcfg.focal_gamma, tcfg.focal_alpha
    ) + tcfg.bce_weight * bce_loss(logits, gt_low)
    return loss, {"iou": _soft_iou(logits.detach(), gt_low), "loss": loss.detach()}


def _soft_iou(logits, gt):
    pred = (logits > 0).float()
    inter = (pred * gt).sum(dim=(-2, -1))
    union = torch.clamp((pred + gt - pred * gt).sum(dim=(-2, -1)), min=1.0)
    return (inter / union).mean()


def make_train_step(tcfg: TrainConfig, optimizer: torch.optim.Optimizer) -> Callable:
    """Returns ``step(model, images, gt_masks, gen) -> aux``: one click-loop
    loss, its gradients, and one optimizer update of the model in place."""

    def step(model, images, gt_masks, gen):
        optimizer.zero_grad(set_to_none=True)
        loss, aux = click_train_loss(model, images, gt_masks, gen, tcfg)
        loss.backward()
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:  # unused by the loss (the iou head): optax
                    p.grad = torch.zeros_like(p)  # still decays it, so AdamW must too
        optimizer.step()
        return aux

    return step
