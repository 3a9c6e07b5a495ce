"""Interactive click-loop evaluation — the quality north star.

Counterpart of ``sam_quantization_tpu/evaluation/click_eval.py``: the
5-click random-error-pixel loop reporting mean IoU / Click@k
(``script/evaluation2.py:225-334`` of the reference) and the NoC evaluation
to 20 clicks with distance-transform click placement
(``inference/evaluation.py:16-56`` + ``inference/utils.py:79-96``).

The model interface is a pair of callables, so any backend plugs in:

  encode(image_nhwc_float) -> embedding
  decode(embedding, coords, labels, mask_input, mask_valid)
      -> (masks (1, 1, S, S), low_res (1, 1, S/4, S/4), iou)

The loops hand the backend numpy prompts and read numpy masks back, at the
same seams as the JAX loops. :func:`make_sam_backend` gives torch closures
on the model's device; the embedding and the fed-back mask prompt stay
there between clicks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from sam_quantization_tpu_torch.evaluation import metrics
from sam_quantization_tpu_torch.evaluation.clicker import Clicker, next_random_click
from sam_quantization_tpu_torch.models import sam as sam_lib
from sam_quantization_tpu_torch.quant.context import NULL_CTX


@dataclasses.dataclass
class ClickEvalResult:
    mean_ious: List[float]  # mean IoU after click k (len = num_clicks)
    per_sample_ious: List[List[float]]
    seconds_per_image: float
    # per-sample click sequences [(y, x, label), ...], so another harness
    # can replay the identical clicks
    clicks: Optional[List[List[Tuple[int, int, float]]]] = None
    # per-sample per-click low-res mask logits (NCHW numpy), recorded with
    # ``record_low_res=True``
    low_res: Optional[List[List[np.ndarray]]] = None

    @property
    def click1(self) -> float:
        return self.mean_ious[0]

    @property
    def final(self) -> float:
        return self.mean_ious[-1]


def make_sam_backend(model: sam_lib.Sam, ctx=None, attn_impl: str = "kernel"):
    """(encode, decode) closures over a ``Sam`` on its device.

    ``encode`` runs the encoder in the dtype of its weights, through the
    quantization context ``ctx`` when given (an FQ-ViT ``FQCtx("quant")``:
    the eager branch); ``decode`` runs the prompt encoder and decoder in
    float32 with one mask output, without the context (as JAX's does), and
    upsamples the low-res logits to the input frame (bilinear, half-pixel
    centres, as ``jax.image.resize`` does)."""
    ctx = ctx or NULL_CTX
    dev = model.device
    dtype = model.image_encoder.patch_embed.proj.weight.dtype
    size = model.config.image_encoder.img_size

    @torch.inference_mode()
    def encode(x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x, np.float32), device=dev).to(dtype)
        return sam_lib.encode_image(model, x, attn_impl, ctx)

    @torch.inference_mode()
    def decode(emb, coords, labels, mask_input, mask_valid):
        low_res, iou = sam_lib.decode_masks(
            model,
            emb.float(),
            points=(torch.as_tensor(coords, device=dev), torch.as_tensor(labels, device=dev)),
            mask_inputs=torch.as_tensor(mask_input, device=dev),
            mask_valid=torch.as_tensor(mask_valid, device=dev),
            multimask_output=False,
        )
        masks = sam_lib.resize_bilinear(low_res, (size, size))
        return masks, low_res, iou

    return encode, decode


def click_loop_eval(
    encode: Callable,
    decode: Callable,
    samples: Iterable[Tuple[np.ndarray, np.ndarray]],
    num_clicks: int = 5,
    max_points: int = 24,
    seed: int = 42,
    img_size: int = 1024,
    verbose: bool = False,
    clicks_override: Optional[List[List[Tuple[int, int, float]]]] = None,
    point_layout: str = "literal",
    record_low_res: bool = False,
) -> ClickEvalResult:
    """The 5-click random-click loop (ref evaluation2.py:225-334).

    ``samples`` yields (preprocessed image NHWC float (1, S, S, 3), gt mask
    (S, S) binary). The mask prompt (the last low-res logits, NHWC) is fed
    back from click 2 onward (evaluation2.py:301-306).

    ``clicks_override``: per-sample pinned click sequences [(y, x, label)...]
    replayed instead of the random-error-pixel rule. The clicks actually
    used are always recorded in ``result.clicks``.

    ``point_layout``: "literal" (default) feeds the decoder exactly the k
    clicks made so far, as the reference's growing click list does (the
    prompt encoder appends its own pad point); "slots" feeds the fixed
    ``max_points`` padded tensor, the serving layout.
    """
    if point_layout not in ("literal", "slots"):
        raise ValueError(f"point_layout must be 'literal' or 'slots', got {point_layout!r}")
    rng = np.random.default_rng(seed)
    all_ious: List[List[float]] = []
    all_clicks: List[List[Tuple[int, int, float]]] = []
    all_low_res: List[List[np.ndarray]] = []
    t0 = time.perf_counter()
    n = 0
    for image, gt in samples:
        n += 1
        emb = encode(image)
        coords = np.zeros((1, max_points, 2), np.float32)
        labels = -np.ones((1, max_points), np.float32)
        h4 = img_size // 4
        mask_input = np.zeros((1, h4, h4, 1), np.float32)
        mask_valid = np.zeros((1,), bool)
        prev_mask = np.zeros_like(gt, dtype=bool)
        ious: List[float] = []
        sample_clicks: List[Tuple[int, int, float]] = []
        sample_low_res: List[np.ndarray] = []
        for click in range(num_clicks):
            if clicks_override is not None:
                cy, cx, lab = clicks_override[n - 1][click]
            else:
                (cy, cx), lab = next_random_click(prev_mask, gt, rng)
            sample_clicks.append((int(cy), int(cx), float(lab)))
            coords[0, click] = (cx, cy)  # model frame is (x, y)
            labels[0, click] = lab
            if point_layout == "literal":
                ck, lk = coords[:, : click + 1], labels[:, : click + 1]
            else:
                ck, lk = coords, labels
            masks, low_res, _iou = decode(emb, ck, lk, mask_input, mask_valid)
            mask_input = low_res.permute(0, 2, 3, 1)
            mask_valid = np.ones((1,), bool)
            if record_low_res:
                sample_low_res.append(low_res.float().cpu().numpy())
            pred = (masks[0, 0] > 0).cpu().numpy()
            prev_mask = pred[: gt.shape[0], : gt.shape[1]]
            ious.append(metrics.get_iou(gt, prev_mask))
        all_ious.append(ious)
        all_clicks.append(sample_clicks)
        if record_low_res:
            all_low_res.append(sample_low_res)
        if verbose:
            print(f"sample {n}: " + " ".join(f"{i:.3f}" for i in ious))
    elapsed = time.perf_counter() - t0
    arr = np.asarray(all_ious)
    return ClickEvalResult(
        mean_ious=list(arr.mean(axis=0)),
        per_sample_ious=all_ious,
        seconds_per_image=elapsed / max(n, 1),
        clicks=all_clicks,
        low_res=all_low_res if record_low_res else None,
    )


def noc_eval_predictor(
    eval_predictor,
    samples: Iterable[Tuple[np.ndarray, np.ndarray]],
    max_clicks: int = 20,
    iou_thrs=(0.80, 0.85, 0.90),
    pred_thr: float = 0.5,
):
    """NoC evaluation through a TTA predictor
    (``evaluation.predictors.SamEvalPredictor``) — the reference's
    evaluate_sample loop with predictor indirection
    (inference/evaluation.py:35-56). ``samples`` yields raw [0, 255] images;
    a click's mask is the probability map above ``pred_thr``."""
    all_ious = []
    t0 = time.perf_counter()
    n = 0
    for image, gt in samples:
        n += 1
        img = np.asarray(image)
        if img.ndim == 4:
            img = img[0]
        eval_predictor.set_input_image(img.astype(np.uint8))
        clicker = Clicker(gt_mask=gt)
        pred = np.zeros_like(gt, dtype=bool)
        ious = []
        for _ in range(max_clicks):
            clicker.make_next_click(pred)
            prob = eval_predictor.get_prediction(clicker)
            pred = prob[: gt.shape[0], : gt.shape[1]] > pred_thr
            iou = metrics.get_iou(gt, pred)
            ious.append(iou)
            if iou >= max(iou_thrs):
                break
        all_ious.append(np.asarray(ious))
    elapsed = time.perf_counter() - t0
    noc, over = metrics.compute_noc_metric(all_ious, iou_thrs, max_clicks)
    return noc, over, elapsed / max(n, 1)


def noc_eval(
    encode: Callable,
    decode: Callable,
    samples: Iterable[Tuple[np.ndarray, np.ndarray]],
    max_clicks: int = 20,
    iou_thrs=(0.80, 0.85, 0.90),
    max_points: int = 24,
    img_size: int = 1024,
    pred_thr: float = 0.0,
    point_layout: str = "literal",
):
    """NoC@τ evaluation with distance-transform clicks
    (ref inference/evaluation.py:16-56 evaluate_sample + utils.py:79-96).
    ``point_layout``: see :func:`click_loop_eval`. Returns (NoC per
    threshold, samples over ``max_clicks`` per threshold, seconds per
    image)."""
    if point_layout not in ("literal", "slots"):
        raise ValueError(f"point_layout must be 'literal' or 'slots', got {point_layout!r}")
    all_ious = []
    t0 = time.perf_counter()
    n = 0
    for image, gt in samples:
        n += 1
        emb = encode(image)
        clicker = Clicker(gt_mask=gt)
        coords = np.zeros((1, max_points, 2), np.float32)
        labels = -np.ones((1, max_points), np.float32)
        h4 = img_size // 4
        mask_input = np.zeros((1, h4, h4, 1), np.float32)
        mask_valid = np.zeros((1,), bool)
        pred = np.zeros_like(gt, dtype=bool)
        ious = []
        for _ in range(max_clicks):
            clicker.make_next_click(pred)
            nk = 0
            for i, c in enumerate(clicker.get_clicks()[:max_points]):
                coords[0, i] = (c.coords[1], c.coords[0])
                labels[0, i] = 1.0 if c.is_positive else 0.0
                nk = i + 1
            if point_layout == "literal":
                ck, lk = coords[:, :nk], labels[:, :nk]
            else:
                ck, lk = coords, labels
            masks, low_res, _ = decode(emb, ck, lk, mask_input, mask_valid)
            mask_input = low_res.permute(0, 2, 3, 1)
            mask_valid = np.ones((1,), bool)
            pred = (masks[0, 0] > pred_thr).cpu().numpy()[: gt.shape[0], : gt.shape[1]]
            iou = metrics.get_iou(gt, pred)
            ious.append(iou)
            if iou >= max(iou_thrs):
                break
        all_ious.append(np.asarray(ious))
    elapsed = time.perf_counter() - t0
    noc, over = metrics.compute_noc_metric(all_ious, iou_thrs, max_clicks)
    return noc, over, elapsed / max(n, 1)
