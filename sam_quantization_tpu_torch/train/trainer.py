"""SAM fine-tuning: interactive-click training, on one card or a dp x tp mesh.

Counterpart of ``sam_quantization_tpu/train/trainer.py`` (the reference's DDP
trainer, train_sm.py:176-545): a click loop (clicks sampled from the
prediction error, the mask prompt fed back), normalized focal + BCE loss on
the last click, AdamW over every leaf of the JAX ``Sam`` pytree.

The encoder runs ``attn_impl="flash_train"``: the windowed blocks' attention
is the head-split kernel forward with an exact eager-recompute backward
(``ops/flash_attention.flash_attention_relpos_trainable``), the global
blocks run eager. Training runs in float32, like the JAX trainer's
parameters.

On a dp x tp mesh (``parallel.mesh.make_mesh``) each dp rank takes its
rows of the batch, and :func:`make_train_step` averages the gradients over
the dp group with one explicit all-reduce (JAX's GSPMD inserts the same
reduction). With tp > 1 the encoder holds this rank's Megatron shard
(:func:`shard_for_training`) and runs under ``tensor_parallel``: every
block takes the eager tensor-parallel branch, since JAX guards
``flash_train`` with ``tp_active is None``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as TF

from sam_quantization_tpu_torch.models import sam as sam_lib
from sam_quantization_tpu_torch.parallel import distributed
from sam_quantization_tpu_torch.parallel import mesh as mesh_lib


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
    clicks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, dict]:
    """Forward with the interactive click loop; the loss on the last click's
    prediction (reference interaction + losses, train_sm.py:298-405).

    The intermediate clicks run under ``torch.no_grad()`` on a detached
    embedding, and only the last one carries grad (the JAX loop's
    ``stop_gradient``). ``gen`` draws the clicks, on the images' device.
    ``attn_impl="eager"`` runs every block's attention eager, the reference
    ``flash_train`` is held against. ``clicks``, (coords (B, num_clicks, 2),
    labels (B, num_clicks)), places those clicks in turn instead of drawing
    them, so two runs can be held to the same prompts.
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
        if clicks is not None:
            coords[:, click], labels[:, click] = clicks[0][:, click], clicks[1][:, click]
        else:
            for b in range(B):
                coords[b, click], labels[b, click] = _sample_error_click(
                    pred_full[b], gt4[b], gen)
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


def make_train_step(tcfg: TrainConfig, optimizer: torch.optim.Optimizer,
                    mesh=None) -> Callable:
    """Returns ``step(model, images, gt_masks, gen, clicks=None) -> aux``: one
    click-loop loss, its gradients, and one optimizer update of the model in
    place. With a ``mesh``, ``images`` are this rank's rows, the gradients
    are averaged over its dp group before the update, and with tp > 1 the
    forward runs under ``tensor_parallel`` on the model's shards; ``aux`` is
    this rank's (``distributed.reduce_loss_dict`` averages it)."""
    tp = 1 if mesh is None else mesh_lib.group_of(mesh, "tp").size()

    def step(model, images, gt_masks, gen, clicks=None):
        optimizer.zero_grad(set_to_none=True)
        ctx = mesh_lib.tensor_parallel(mesh) if tp > 1 else contextlib.nullcontext()
        with ctx:
            loss, aux = click_train_loss(model, images, gt_masks, gen, tcfg, clicks=clicks)
        loss.backward()
        params = [p for group in optimizer.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:  # unused by the loss (the iou head): optax
                p.grad = torch.zeros_like(p)  # still decays it, so AdamW must too
        if mesh is not None:
            distributed.average_gradients(params, mesh_lib.group_of(mesh, "dp"))
        optimizer.step()
        return aux

    return step


def shard_for_training(model: sam_lib.Sam, optimizer: torch.optim.Optimizer, tcfg: TrainConfig,
                       mesh) -> torch.optim.AdamW:
    """Cut this rank's tensor-parallel shard of a full model in place (stock
    qkv layout) and return a new AdamW over the shards that carries the
    full optimizer's state, each moment cut as its parameter (a resumed
    run's state goes on where it stopped)."""
    nh = model.config.image_encoder.num_heads
    states = {n: optimizer.state.get(p) for n, p in model.named_parameters()}
    mesh_lib.shard_params(model, mesh, packed_qkv=False)
    sharded = make_optimizer(tcfg, model)
    for n, p in model.named_parameters():
        st = states.get(n)
        if st:
            sharded.state[p] = {
                "step": st["step"],
                **{k: mesh_lib.shard_tensor(n, st[k], mesh, nh)
                   for k in ("exp_avg", "exp_avg_sq")}}
    return sharded
