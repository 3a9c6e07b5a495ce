"""Evaluation-side predictors with test-time augmentation.

Counterpart of ``sam_quantization_tpu/evaluation/predictors.py`` (the TTA
part) and of the reference's ``inference/predictors`` +
``inference/transforms`` (BasePredictor with flip / zoom-in / crops TTA;
predictors/base.py:7-172, transforms/zoom_in.py:9-175, flip.py, crops.py),
on the port's :class:`~sam_quantization_tpu_torch.predictor.SamPredictor`.

Interface: ``set_input_image(image)`` once, then ``get_prediction(clicker)``
returns a probability map in the original frame — the contract the NoC
evaluator consumes (ref inference/evaluation.py:35-56).

The BRS refinements (the reference's inference/predictors/brs.py:9-307, as
the JAX package adapts them to SAM): :class:`InputBRSPredictor` optimizes an
additive low-res mask prompt, :class:`FeatureBRSPredictor` a per-channel
scale and bias on the cached image embedding, each so that the decoded
low-res logits agree with every click, by L-BFGS with optax's zoom line
search (``evaluation/lbfgs.py``). The encoder runs once per image (its
kernels); the mask decoder runs eagerly under autograd, which takes the
gradient of the optimized variables only.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from sam_quantization_tpu_torch.evaluation.clicker import Click
from sam_quantization_tpu_torch.evaluation.lbfgs import StepInfo, lbfgs_minimize
from sam_quantization_tpu_torch.models import sam as sam_lib
from sam_quantization_tpu_torch.predictor import MAX_POINTS, SamPredictor


class SamEvalPredictor:
    """SamPredictor adapter with optional flip TTA and zoom-in.

    ``net_clicks_limit`` matches the reference's cap on clicks fed to the
    network (predictors/base.py:20).
    """

    def __init__(
        self,
        predictor: SamPredictor,
        with_flip: bool = False,
        zoom_in: Optional["ZoomIn"] = None,
        crops: Optional["Crops"] = None,
        net_clicks_limit: Optional[int] = None,
    ):
        self.predictor = predictor
        self.with_flip = with_flip
        self.zoom_in = zoom_in
        self.crops = crops
        self.net_clicks_limit = net_clicks_limit or 24
        self.original_image: Optional[np.ndarray] = None
        self.prev_prediction: Optional[np.ndarray] = None
        self._crop_preds: List[SamPredictor] = []

    def set_input_image(self, image: np.ndarray):
        """Cache the image embedding once per image (the reference caches at
        predictors/base.py:139-142)."""
        self.original_image = image
        self.predictor.set_image(image)
        self.prev_prediction = np.zeros(image.shape[:2], np.float32)
        if self.zoom_in is not None:
            self.zoom_in.reset()
        self._crop_preds = []
        if self.crops is not None:
            self._crop_offsets = self.crops.offsets(*image.shape[:2])
            for dy, dx in self._crop_offsets or []:
                ch, cw = self.crops.crop_size
                sub = SamPredictor(
                    self.predictor.model, attn_impl=self.predictor.attn_impl
                )
                sub.set_image(image[dy : dy + ch, dx : dx + cw])
                self._crop_preds.append(sub)

    def _predict_once(self, predictor, clicks: List[Click], mask_input=None):
        coords = np.array(
            [(c.coords[1], c.coords[0]) for c in clicks[: self.net_clicks_limit]],
            np.float32,
        )
        labels = np.array(
            [1.0 if c.is_positive else 0.0 for c in clicks[: self.net_clicks_limit]],
            np.float32,
        )
        masks, _, low_res = predictor.predict(
            point_coords=coords,
            point_labels=labels,
            mask_input=mask_input,
            multimask_output=False,
            return_logits=True,
        )
        return masks[0], low_res

    def get_prediction(self, clicker, prev_mask=None) -> np.ndarray:
        clicks = clicker.get_clicks()
        if self._crop_preds:
            prob = self._predict_crops(clicks)
            self.prev_prediction = prob
            return prob
        logits, low_res = self._predict_once(self.predictor, clicks, prev_mask)
        prob = _sigmoid(logits)

        if self.with_flip:
            flipped = self.original_image[:, ::-1]
            w = self.original_image.shape[1]
            flip_pred = SamPredictor(
                self.predictor.model, attn_impl=self.predictor.attn_impl
            )
            flip_pred.set_image(flipped)
            fclicks = [
                Click(is_positive=c.is_positive, coords=(c.coords[0], w - 1 - c.coords[1]))
                for c in clicks
            ]
            flogits, _ = self._predict_once(flip_pred, fclicks)
            prob = 0.5 * (prob + _sigmoid(flogits)[:, ::-1])

        if self.zoom_in is not None:
            prob = self.zoom_in.refine(self, clicks, prob)

        self.prev_prediction = prob
        self.last_low_res = low_res
        return prob

    def _predict_crops(self, clicks: List[Click]) -> np.ndarray:
        """Tiled prediction: every overlapping crop is predicted from the
        clicks that fall inside it; overlaps are averaged by coverage count
        (ref inference/transforms/crops.py transform/inv_transform). Crops
        with no positive click contribute background — a SAM adaptation,
        since point prompts (unlike RITM click maps) can't express clicks
        outside the crop frame."""
        H, W = self.original_image.shape[:2]
        ch, cw = self.crops.crop_size
        acc = np.zeros((H, W), np.float32)
        counts = np.zeros((H, W), np.float32)
        for (dy, dx), sub in zip(self._crop_offsets, self._crop_preds):
            counts[dy : dy + ch, dx : dx + cw] += 1.0
            sub_clicks = [
                Click(
                    is_positive=c.is_positive,
                    coords=(c.coords[0] - dy, c.coords[1] - dx),
                )
                for c in clicks
                if dy <= c.coords[0] < dy + ch and dx <= c.coords[1] < dx + cw
            ]
            if not any(c.is_positive for c in sub_clicks):
                continue
            logits, _ = self._predict_once(sub, sub_clicks)
            acc[dy : dy + ch, dx : dx + cw] += _sigmoid(logits)
        return acc / np.maximum(counts, 1.0)


class Crops:
    """Overlapping-tile TTA (ref inference/transforms/crops.py:11-103): cover
    the image with crops of fixed size at ≥``min_overlap`` overlap, predict
    each, average the overlaps. Inactive for images smaller than the crop."""

    def __init__(self, crop_size=(320, 480), min_overlap: float = 0.2):
        self.crop_size = tuple(crop_size)
        self.min_overlap = min_overlap

    def offsets(self, H: int, W: int):
        """[(dy, dx)] row-major, or None when the image is smaller than the
        crop (ref crops.py:26-27)."""
        ch, cw = self.crop_size
        if H < ch or W < cw:
            return None
        return [
            (dy, dx)
            for dy in _axis_offsets(H, ch, self.min_overlap)
            for dx in _axis_offsets(W, cw, self.min_overlap)
        ]


def _axis_offsets(length: int, crop: int, min_overlap: float):
    """Evenly spread start offsets so consecutive crops overlap by at least
    ``min_overlap`` of the crop (ref crops.py get_offsets:81-103)."""
    if length == crop:
        return [0]
    n = math.ceil((length / crop - min_overlap) / (1.0 - min_overlap))
    if n <= 1:
        return [0]
    overlap_px = int(crop * (n - length / crop) / (n - 1))
    offs = [0]
    for _ in range(1, n):
        nxt = min(offs[-1] + crop - overlap_px, length - crop)
        offs.append(nxt)
    return offs


class ZoomIn:
    """Crop-and-refine around the current object (ref transforms/zoom_in.py).

    After ``skip_clicks`` clicks, crop an expanded bbox of (prediction ∪
    clicks), re-encode the crop, re-predict, and paste back.
    """

    def __init__(
        self,
        target_size: int = 1024,
        skip_clicks: int = 1,
        expansion_ratio: float = 1.4,
        prob_thresh: float = 0.5,
    ):
        self.target_size = target_size
        self.skip_clicks = skip_clicks
        self.expansion_ratio = expansion_ratio
        self.prob_thresh = prob_thresh
        self.reset()

    def reset(self):
        self._object_roi = None

    def refine(self, eval_pred: SamEvalPredictor, clicks, prob: np.ndarray):
        if len(clicks) <= self.skip_clicks:
            return prob
        mask = prob > self.prob_thresh
        roi = _get_roi(mask, clicks, self.expansion_ratio, prob.shape)
        if roi is None:
            return prob
        y0, y1, x0, x1 = roi
        if (y1 - y0) < 32 or (x1 - x0) < 32:
            return prob
        crop = eval_pred.original_image[y0:y1, x0:x1]
        sub = SamPredictor(
            eval_pred.predictor.model, attn_impl=eval_pred.predictor.attn_impl
        )
        sub.set_image(crop)
        sub_clicks = [
            Click(is_positive=c.is_positive, coords=(c.coords[0] - y0, c.coords[1] - x0))
            for c in clicks
            if y0 <= c.coords[0] < y1 and x0 <= c.coords[1] < x1
        ]
        if not sub_clicks:
            return prob
        logits, _ = eval_pred._predict_once(sub, sub_clicks)
        out = prob.copy()
        out[y0:y1, x0:x1] = _sigmoid(logits)
        return out


class _BRSPredictor(SamEvalPredictor):
    """What both BRS predictors share: the padded point prompt of every
    click, the click-consistency hinge on the low-res logits, the L-BFGS
    loop, and the map in the original frame. ``last_steps`` holds the
    :class:`~sam_quantization_tpu_torch.evaluation.lbfgs.StepInfo` of each
    optimizer step of the last prediction."""

    def __init__(self, predictor, opt_steps: int, reg_weight: float = 1e-3, **kw):
        super().__init__(predictor, **kw)
        self.opt_steps = opt_steps
        self.reg_weight = reg_weight
        self.last_steps: List[StepInfo] = []

    def _prompts(self, clicks: List[Click]):
        """(coords, labels) in the model frame, padded to ``MAX_POINTS``
        slots, and (row / 4, col / 4, positive) of each click on the low-res
        grid, as JAX's predictors build them."""
        pred = self.predictor
        coords = np.zeros((1, MAX_POINTS, 2), np.float32)
        labels = -np.ones((1, MAX_POINTS), np.float32)
        click_px = []
        for i, c in enumerate(clicks[:MAX_POINTS]):
            pc = pred.transform.apply_coords(
                np.array([[c.coords[1], c.coords[0]]], np.float32), pred.original_size
            )[0]
            coords[0, i] = pc
            labels[0, i] = 1.0 if c.is_positive else 0.0
            click_px.append((pc[1] / 4.0, pc[0] / 4.0, labels[0, i]))
        dev = pred.device
        points = (torch.from_numpy(coords).to(dev), torch.from_numpy(labels).to(dev))
        return points, torch.from_numpy(np.asarray(click_px, np.float32)).to(dev)

    @staticmethod
    def _hinge(low: torch.Tensor, click_px: torch.Tensor) -> torch.Tensor:
        """Sum of squared violations: positive clicks need a logit > 0,
        negative ones < 0, on the (4h, 4w) low-res logits."""
        ys = torch.clamp(click_px[:, 0].to(torch.int32), 0, low.shape[0] - 1).long()
        xs = torch.clamp(click_px[:, 1].to(torch.int32), 0, low.shape[1] - 1).long()
        vals = low[ys, xs]
        viol = torch.where(click_px[:, 2] > 0.5, torch.clamp_min(-vals, 0.0),
                           torch.clamp_min(vals, 0.0))
        return torch.sum(viol**2)

    def _refine(self, clicker, make_loss, decode, init) -> np.ndarray:
        """Minimize ``make_loss(features, points, click_px)`` over ``init``,
        then ``decode(features, points, variables)`` the low-res logits and
        map them to the original frame. Runs outside inference mode on a
        float32 copy of the cached embedding (an inference tensor)."""
        pred = self.predictor
        with torch.inference_mode(False):
            features = pred.features.float().clone()
            points, click_px = self._prompts(clicker.get_clicks())
            loss = make_loss(features, points, click_px)
            self.last_steps = []
            best = lbfgs_minimize(loss, init, self.opt_steps, on_step=self.last_steps.append)
            with torch.no_grad():
                low_res = decode(features, points, best)
                masks = sam_lib.postprocess_masks(pred.model, low_res, pred.input_size,
                                                  pred.original_size)
        prob = _sigmoid(masks[0, 0].cpu().numpy())
        self.prev_prediction = prob
        return prob


class InputBRSPredictor(_BRSPredictor):
    """Backpropagating refinement (input-BRS): optimize an additive low-res
    mask-input map so the prediction agrees with every click (the JAX
    ``InputBRSPredictor``, counterpart of inference/predictors/brs.py
    InputBRS, with L-BFGS over the mask prompt instead of the raw image)."""

    def __init__(self, predictor, opt_steps: int = 10, reg_weight: float = 1e-3, **kw):
        super().__init__(predictor, opt_steps, reg_weight, **kw)

    def get_prediction(self, clicker, prev_mask=None) -> np.ndarray:
        model = self.predictor.model
        h, w = model.config.prompt_encoder.image_embedding_size

        def decode(features, points, variables):
            (mask_in,) = variables
            valid = torch.ones((1,), dtype=torch.bool, device=mask_in.device)
            low_res, _ = sam_lib.decode_masks(model, features, points=points,
                                              mask_inputs=mask_in, mask_valid=valid,
                                              multimask_output=False)
            return low_res  # (1, 1, 4h, 4w)

        def make_loss(features, points, click_px):
            def loss(variables):
                low = decode(features, points, variables)[0, 0]
                return (self._hinge(low, click_px)
                        + self.reg_weight * torch.sum(variables[0] ** 2))
            return loss

        init = (torch.zeros((1, 4 * h, 4 * w, 1), dtype=torch.float32,
                            device=self.predictor.device),)
        return self._refine(clicker, make_loss, decode, init)


class FeatureBRSPredictor(_BRSPredictor):
    """f-BRS: optimize a per-channel scale and bias on the cached image
    embedding so the decoded mask agrees with every click (the JAX
    ``FeatureBRSPredictor``, counterpart of the reference's f-BRS-B mode,
    inference/predictors/brs.py: auxiliary variables on backbone features;
    JAX's unread ``lr`` is not taken: the line search sets the steps)."""

    def __init__(self, predictor, opt_steps: int = 15, reg_weight: float = 1e-3, **kw):
        super().__init__(predictor, opt_steps, reg_weight, **kw)

    def get_prediction(self, clicker, prev_mask=None) -> np.ndarray:
        model = self.predictor.model

        def decode(features, points, variables):
            scale, bias = variables
            C = features.shape[-1]
            feats = features * (1.0 + scale.reshape(1, 1, 1, C)) + bias.reshape(1, 1, 1, C)
            low_res, _ = sam_lib.decode_masks(model, feats, points=points,
                                              multimask_output=False)
            return low_res

        def make_loss(features, points, click_px):
            def loss(variables):
                low = decode(features, points, variables)[0, 0]
                reg = self.reg_weight * (torch.sum(variables[0] ** 2)
                                         + torch.sum(variables[1] ** 2))
                return self._hinge(low, click_px) + reg
            return loss

        C = self.predictor.features.shape[-1]
        dev = self.predictor.device
        init = (torch.zeros((C,), dtype=torch.float32, device=dev),
                torch.zeros((C,), dtype=torch.float32, device=dev))
        return self._refine(clicker, make_loss, decode, init)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.clip(x, -30, 30)))


def _get_roi(mask, clicks, expansion_ratio, shape):
    ys, xs = np.nonzero(mask)
    cy = [c.coords[0] for c in clicks]
    cx = [c.coords[1] for c in clicks]
    ys = np.concatenate([ys, np.asarray(cy, np.int64)])
    xs = np.concatenate([xs, np.asarray(cx, np.int64)])
    if len(ys) == 0:
        return None
    y0, y1 = ys.min(), ys.max() + 1
    x0, x1 = xs.min(), xs.max() + 1
    hh, ww = y1 - y0, x1 - x0
    ey = int(hh * (expansion_ratio - 1) / 2)
    ex = int(ww * (expansion_ratio - 1) / 2)
    return (
        max(0, y0 - ey), min(shape[0], y1 + ey),
        max(0, x0 - ex), min(shape[1], x1 + ex),
    )
