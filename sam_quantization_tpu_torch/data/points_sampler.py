"""Training-time click synthesis for interactive segmentation.

Counterpart of ``sam_quantization_tpu/data/points_sampler.py``, line for
line: it draws from Python's ``random`` and numpy's global generator in the
JAX module's order, so a seed gives the same clicks. It is the reference's
``MultiPointSampler`` (data/points_sampler.py:32-307): decaying click-count probabilities
(gamma 0.7), positive-mask erosion, three negative strategies
(background / other-objects / dilated border), optional object merging, and
center-biased first clicks via the distance transform.

cv2 erode/dilate are replaced by scipy binary morphology; the EDT uses the
port's native C++ kernel (``native.py``). Output contract matches the reference: a list of
``max_num_points * 2`` (row, col, index) triples — positives first, then
negatives, padded with (-1, -1, -1) — which the trainer converts to SAM
(x, y)/label prompts.
"""

from __future__ import annotations

import math
import random
from functools import lru_cache
from typing import List, Sequence

import numpy as np
from scipy import ndimage

from sam_quantization_tpu_torch import native


@lru_cache(maxsize=None)
def generate_probs(max_num_points: int, gamma: float) -> np.ndarray:
    probs = np.array([gamma**i for i in range(max_num_points)])
    return probs / probs.sum()


def get_point_candidates(obj_mask: np.ndarray, k: float = 1.7, full_prob: float = 0.0):
    """Center-biased candidate set via distance transform (ref :294-307)."""
    if full_prob > 0 and random.random() < full_prob:
        return np.argwhere(obj_mask)
    padded = np.pad(obj_mask, 1, "constant")
    dt = native.distance_transform_edt(padded)[1:-1, 1:-1]
    if k > 0:
        return np.argwhere(dt > dt.max() / k)
    prob = dt.flatten()
    prob = prob / max(prob.sum(), 1e-6)
    idx = np.random.choice(len(prob), p=prob)
    return np.array([np.unravel_index(idx, dt.shape)])


class MultiPointSampler:
    def __init__(
        self,
        max_num_points: int = 12,
        prob_gamma: float = 0.7,
        expand_ratio: float = 0.1,
        positive_erode_prob: float = 0.9,
        positive_erode_iters: int = 3,
        negative_bg_prob: float = 0.1,
        negative_other_prob: float = 0.4,
        negative_border_prob: float = 0.5,
        merge_objects_prob: float = 0.0,
        max_num_merged_objects: int = 2,
        first_click_center: bool = False,
        sfc_inner_k: float = 1.7,
    ):
        self.max_num_points = max_num_points
        self.expand_ratio = expand_ratio
        self.positive_erode_prob = positive_erode_prob
        self.positive_erode_iters = positive_erode_iters
        self.merge_objects_prob = merge_objects_prob
        self.max_num_merged_objects = (
            max_num_points if max_num_merged_objects == -1 else max_num_merged_objects
        )
        self.first_click_center = first_click_center
        self.sfc_inner_k = sfc_inner_k
        self.neg_strategies = ["bg", "other", "border"]
        self.neg_strategies_prob = [
            negative_bg_prob, negative_other_prob, negative_border_prob,
        ]
        assert math.isclose(sum(self.neg_strategies_prob), 1.0)
        self._pos_probs = generate_probs(max_num_points, prob_gamma)
        self._neg_probs = generate_probs(max_num_points + 1, prob_gamma)
        self.selected_mask = None
        self._selected_masks = None
        self._neg_masks = None

    # -- object selection (ref sample_object, :66-95) ----------------------

    def sample_object(self, instances_mask: np.ndarray, objects_ids: Sequence[int]):
        """Choose the target object(s) and prepare positive/negative masks."""
        if not objects_ids:
            bg = instances_mask == 0
            self.selected_mask = np.zeros_like(instances_mask, np.float32)
            self._selected_masks = [[]]
            self._neg_masks = {s: bg for s in self.neg_strategies}
            self._neg_masks["required"] = []
            return

        if len(objects_ids) > 1 and random.random() < self.merge_objects_prob:
            n_sel = np.random.randint(
                2, min(len(objects_ids), self.max_num_merged_objects) + 1
            )
            chosen = random.sample(list(objects_ids), n_sel)
        else:
            chosen = [random.choice(list(objects_ids))]

        gt_mask = np.zeros_like(instances_mask, bool)
        pos_masks: List[np.ndarray] = []
        for obj_id in chosen:
            m = instances_mask == obj_id
            gt_mask |= m
            pos_masks.append(self._positive_erode(m))

        self.selected_mask = gt_mask.astype(np.float32)
        self._selected_masks = pos_masks
        bg = ~gt_mask
        border = self._get_border_mask(gt_mask)
        others = (instances_mask > 0) & ~gt_mask
        self._neg_masks = {
            "bg": bg,
            "other": others if others.any() else bg,
            "border": border,
            "required": [],
        }

    # -- point synthesis (ref sample_points, :170-256) ---------------------

    def sample_points(self) -> np.ndarray:
        assert self.selected_mask is not None
        pos = self._multi_mask_sample(
            self._selected_masks, negative=False,
            with_first_click=self.first_click_center,
        )
        neg_strategy = [
            (self._neg_masks[k], p)
            for k, p in zip(self.neg_strategies, self.neg_strategies_prob)
        ]
        neg = self._multi_mask_sample(
            self._neg_masks["required"] + [neg_strategy], negative=True
        )
        return np.array(pos + neg, np.float32)

    def _multi_mask_sample(self, masks, negative, with_first_click=False):
        masks = masks[: self.max_num_points]
        per_obj = [
            self._sample_from(m, negative, with_first_click and i == 0)
            for i, m in enumerate(masks)
        ]
        per_obj = [x for x in per_obj if x]
        if len(per_obj) == 1:
            points = per_obj[0]
        elif len(per_obj) > 1:
            points = [obj[0] for obj in per_obj]
        else:
            points = []
        points = points[: self.max_num_points]
        points += [(-1, -1, -1)] * (self.max_num_points - len(points))
        return points

    def _sample_from(self, mask, negative, first_click_center):
        if negative:
            num = np.random.choice(
                np.arange(self.max_num_points + 1), p=self._neg_probs
            )
        else:
            num = 1 + np.random.choice(
                np.arange(self.max_num_points), p=self._pos_probs
            )
        if isinstance(mask, list):  # strategy list [(mask, prob), ...]
            strat_masks = [m for m, _ in mask]
            strat_probs = [p for _, p in mask]
            points = []
            for _ in range(num):
                m = strat_masks[np.random.choice(len(strat_masks), p=strat_probs)]
                idx = np.argwhere(m)
                if len(idx):
                    y, x = idx[np.random.randint(len(idx))]
                    points.append((int(y), int(x), 100))
            return points
        points = []
        for j in range(int(num)):
            if first_click_center and j == 0:
                cand = get_point_candidates(mask, k=self.sfc_inner_k)
                indx = 0
            else:
                cand = np.argwhere(mask)
                indx = 100
            if len(cand):
                y, x = cand[np.random.randint(len(cand))]
                points.append((int(y), int(x), indx))
        return points

    # -- morphology (ref :258-276) ----------------------------------------

    def _positive_erode(self, mask: np.ndarray) -> np.ndarray:
        if random.random() > self.positive_erode_prob:
            return mask
        eroded = ndimage.binary_erosion(
            mask, np.ones((3, 3), bool), iterations=self.positive_erode_iters
        )
        return eroded if eroded.sum() > 10 else mask

    def _get_border_mask(self, mask: np.ndarray) -> np.ndarray:
        expand_r = int(np.ceil(self.expand_ratio * np.sqrt(max(mask.sum(), 1))))
        expanded = ndimage.binary_dilation(
            mask, np.ones((3, 3), bool), iterations=max(expand_r, 1)
        )
        out = expanded.copy()
        out[mask.astype(bool)] = 0
        return out


def points_to_sam_prompts(points: np.ndarray, max_points: int):
    """(2N, 3) sampler triples → SAM (coords (M, 2) xy, labels (M,)).

    First half are positives, second half negatives; (-1, -1, -1) pads drop
    out (label -1), matching how train_sm feeds SAM (train_sm.py:298-346).
    """
    n = points.shape[0] // 2
    coords = np.zeros((max_points, 2), np.float32)
    labels = -np.ones((max_points,), np.float32)
    k = 0
    for i, (y, x, _) in enumerate(points):
        if y < 0 or k >= max_points:
            continue
        coords[k] = (x, y)
        labels[k] = 1.0 if i < n else 0.0
        k += 1
    return coords, labels
