"""Click synthesis for interactive segmentation evaluation.

Two strategies, matching the reference's two harnesses:
  * :func:`next_random_click` — uniform-random error pixel, FN → positive
    click / FP → negative (script/evaluation2.py:170-200); used by the
    5-click SBD loop.
  * :class:`Clicker` — RITM-style: click at the maximum of the distance
    transform of the largest error region (inference/clicker.py:6-118); used
    by the NoC evaluator. The distance transform is the port's native exact
    EDT (float32; scipy's where the library cannot be built); the reference
    uses cv2.distanceTransform, identical for an exact EDT.

The port's copy of ``sam_quantization_tpu/evaluation/clicker.py``: numpy on
the host, and the click RNG is numpy's (``rng.integers`` over
``np.nonzero`` order), so the same seed gives the JAX loop's clicks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from sam_quantization_tpu_torch import native


def next_random_click(
    pred_mask: np.ndarray, gt_mask: np.ndarray, rng: np.random.Generator
) -> Tuple[Tuple[int, int], int]:
    """((y, x), label) with label 1 for FN click, 0 for FP
    (ref get_next_click_torch, evaluation2.py:170-200)."""
    gt = gt_mask > 0
    pred = pred_mask > 0
    fn = gt & ~pred
    fp = ~gt & pred
    if fn.sum() > 0:
        region, label = fn, 1
    elif fp.sum() > 0:
        region, label = fp, 0
    else:  # perfect mask: click inside the object (or anywhere)
        region, label = (gt if gt.sum() else np.ones_like(gt)), 1
    ys, xs = np.nonzero(region)
    i = rng.integers(0, len(ys))
    return (int(ys[i]), int(xs[i])), label


@dataclasses.dataclass
class Click:
    is_positive: bool
    coords: Tuple[int, int]  # (y, x)

    @property
    def coords_and_indx(self):
        return (*self.coords, 0)


class Clicker:
    """Distance-transform click placement (ref inference/clicker.py:6-118)."""

    def __init__(
        self,
        gt_mask: Optional[np.ndarray] = None,
        init_clicks: Optional[List[Click]] = None,
        ignore_label: int = -1,
        click_indx_offset: int = 0,
    ):
        self.click_indx_offset = click_indx_offset
        if gt_mask is not None:
            self.gt_mask = gt_mask == 1
            self.not_ignore_mask = gt_mask != ignore_label
        else:
            self.gt_mask = None
        self.reset_clicks()
        if init_clicks is not None:
            for click in init_clicks:
                self.add_click(click)

    def make_next_click(self, pred_mask: np.ndarray):
        assert self.gt_mask is not None
        self.add_click(self._get_next_click(pred_mask > 0))

    def get_clicks(self, clicks_limit: Optional[int] = None) -> List[Click]:
        return self.clicks_list[:clicks_limit]

    def _get_next_click(self, pred_mask: np.ndarray, padding: bool = True) -> Click:
        fn_mask = self.gt_mask & ~pred_mask & self.not_ignore_mask
        fp_mask = ~self.gt_mask & pred_mask & self.not_ignore_mask
        if padding:
            fn_mask = np.pad(fn_mask, 1, mode="constant")
            fp_mask = np.pad(fp_mask, 1, mode="constant")
        fn_mask_dt = native.distance_transform_edt(fn_mask)
        fp_mask_dt = native.distance_transform_edt(fp_mask)
        if padding:
            fn_mask_dt = fn_mask_dt[1:-1, 1:-1]
            fp_mask_dt = fp_mask_dt[1:-1, 1:-1]
        fn_mask_dt = fn_mask_dt * self.not_clicked_map
        fp_mask_dt = fp_mask_dt * self.not_clicked_map

        fn_max_dist = float(fn_mask_dt.max())
        fp_max_dist = float(fp_mask_dt.max())
        is_positive = fn_max_dist > fp_max_dist
        dt = fn_mask_dt if is_positive else fp_mask_dt
        coords_y, coords_x = np.where(dt == dt.max())
        return Click(
            is_positive=is_positive, coords=(int(coords_y[0]), int(coords_x[0]))
        )

    def add_click(self, click: Click):
        coords = click.coords
        click.indx = self.click_indx_offset + len(self.clicks_list)
        if click.is_positive:
            self.num_pos_clicks += 1
        else:
            self.num_neg_clicks += 1
        self.clicks_list.append(click)
        if self.gt_mask is not None:
            self.not_clicked_map[coords[0], coords[1]] = False

    def reset_clicks(self):
        if self.gt_mask is not None:
            self.not_clicked_map = np.ones_like(self.gt_mask, dtype=bool)
        self.num_pos_clicks = 0
        self.num_neg_clicks = 0
        self.clicks_list: List[Click] = []

    def __len__(self):
        return len(self.clicks_list)
