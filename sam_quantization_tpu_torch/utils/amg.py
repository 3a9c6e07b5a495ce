"""AMG support utilities: MaskData, RLE, stability score, grids, crops, NMS.

Counterpart of ``sam_quantization_tpu/utils/amg.py``. The filtering is host
numpy, as in the JAX package: it is dynamic-shape work between device calls.
RLE and NMS go through the port's ``native.py`` (``csrc/host_runtime.cpp``);
:func:`packbits_masks` is the one device function, a torch op on the masks'
device.
"""

from __future__ import annotations

import math
from itertools import product
from typing import Any, Dict, Generator, List, Tuple

import numpy as np
import torch

from sam_quantization_tpu_torch import native


class MaskData:
    """Dict of batched mask-related numpy arrays / lists with a joint
    ``filter`` and ``cat`` (ref amg.py:16-75)."""

    def __init__(self, **kwargs):
        for v in kwargs.values():
            assert isinstance(v, (list, np.ndarray)), type(v)
        self._stats: Dict[str, Any] = dict(**kwargs)

    def __setitem__(self, key, item):
        assert isinstance(item, (list, np.ndarray))
        self._stats[key] = item

    def __delitem__(self, key):
        del self._stats[key]

    def __getitem__(self, key):
        return self._stats[key]

    def items(self):
        return self._stats.items()

    def filter(self, keep: np.ndarray):
        """Keep the rows of a boolean mask or of integer indices."""
        for k, v in self._stats.items():
            if isinstance(v, np.ndarray):
                self._stats[k] = v[keep]
            elif keep.dtype == bool:
                self._stats[k] = [a for a, kept in zip(v, keep) if kept]
            else:
                self._stats[k] = [v[i] for i in keep]

    def cat(self, new_stats: "MaskData"):
        """Append ``new_stats``' rows. Its items are taken over without a
        deep copy (the JAX package deep-copies them): a list row, an RLE
        dict, is then shared, and a deep copy of RLEs of ~10^5 counts was
        most of a ViT-H generate's host time."""
        for k, v in new_stats.items():
            if k not in self._stats:
                self._stats[k] = v.copy()
            elif isinstance(v, np.ndarray):
                self._stats[k] = np.concatenate([self._stats[k], v], axis=0)
            else:
                self._stats[k] = self._stats[k] + v


def is_box_near_crop_edge(
    boxes: np.ndarray, crop_box: List[int], orig_box: List[int], atol: float = 20.0
) -> np.ndarray:
    """Boxes within ``atol`` of the crop's edge and not of the image's (ref amg.py:78-94)."""
    crop = np.asarray(crop_box, np.float32)
    orig = np.asarray(orig_box, np.float32)
    boxes = uncrop_boxes_xyxy(boxes, crop_box).astype(np.float32)
    near_crop = np.isclose(boxes, crop[None], atol=atol, rtol=0)
    near_orig = np.isclose(boxes, orig[None], atol=atol, rtol=0)
    return (near_crop & ~near_orig).any(axis=1)


def box_xyxy_to_xywh(box: np.ndarray) -> np.ndarray:
    out = np.array(box, copy=True)
    out[2] = out[2] - out[0]
    out[3] = out[3] - out[1]
    return out


def batch_iterator(batch_size: int, *args) -> Generator[List[Any], None, None]:
    """ref amg.py:107-113."""
    assert len(args) > 0 and all(len(a) == len(args[0]) for a in args)
    n_batches = len(args[0]) // batch_size + int(len(args[0]) % batch_size != 0)
    for b in range(n_batches):
        yield [arg[b * batch_size: (b + 1) * batch_size] for arg in args]


# ---------------------------------------------------------------------------
# RLE (COCO uncompressed format; ref amg.py:116-158)
# ---------------------------------------------------------------------------


def mask_to_rle(mask: np.ndarray) -> Dict[str, Any]:
    """(H, W) binary mask -> uncompressed RLE (column-major runs, starting
    with the count of 0s)."""
    h, w = mask.shape
    return {"size": [h, w], "counts": native.rle_encode(mask)}


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    h, w = rle["size"]
    return native.rle_decode(rle["counts"], h, w)


def area_from_rle(rle: Dict[str, Any]) -> int:
    return sum(rle["counts"][1::2])


def packbits_masks(binm: torch.Tensor) -> torch.Tensor:
    """Column-major bit-pack on the masks' device: (N, H, W) bool ->
    (N, W, ceil(H/8)) uint8, bit j of byte b = row b*8+j (little bit
    order), padded rows 0. This is the COCO column-major bit stream that
    ``native.rle_encode_batch_packed`` scans without unpacking."""
    n, h, w = binm.shape
    t = binm.transpose(1, 2).to(torch.uint8)  # (N, W, H)
    t = torch.nn.functional.pad(t, (0, -h % 8))
    weights = torch.tensor([1 << j for j in range(8)], dtype=torch.uint8, device=binm.device)
    return (t.reshape(n, w, -1, 8) * weights).sum(-1, dtype=torch.uint8)


# ---------------------------------------------------------------------------
# Stability score, grids, crops (ref amg.py:161-234)
# ---------------------------------------------------------------------------


def calculate_stability_score(
    masks: np.ndarray, mask_threshold: float, threshold_offset: float
) -> np.ndarray:
    """IoU between the high and low thresholded logits (ref amg.py:161-174):
    int64 counts, a float64 quotient."""
    hi = (masks > (mask_threshold + threshold_offset)).sum(axis=(-2, -1), dtype=np.int64)
    lo = (masks > (mask_threshold - threshold_offset)).sum(axis=(-2, -1), dtype=np.int64)
    return hi / np.maximum(lo, 1)


def build_point_grid(n_per_side: int) -> np.ndarray:
    """ref amg.py:177-184."""
    offset = 1 / (2 * n_per_side)
    points_one_side = np.linspace(offset, 1 - offset, n_per_side)
    points_x = np.tile(points_one_side[None, :], (n_per_side, 1))
    points_y = np.tile(points_one_side[:, None], (1, n_per_side))
    return np.stack([points_x, points_y], axis=-1).reshape(-1, 2)


def build_all_layer_point_grids(
    n_per_side: int, n_layers: int, scale_per_layer: int
) -> List[np.ndarray]:
    return [build_point_grid(int(n_per_side / (scale_per_layer**i)))
            for i in range(n_layers + 1)]


def generate_crop_boxes(
    im_size: Tuple[int, ...], n_layers: int, overlap_ratio: float
) -> Tuple[List[List[int]], List[int]]:
    """The full image, then 2^(i+1) x 2^(i+1) overlapping crops per layer i
    (ref amg.py:201-234)."""
    crop_boxes, layer_idxs = [], []
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes.append([0, 0, im_w, im_h])
    layer_idxs.append(0)

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_crops_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_crops_per_side))
        crop_w = crop_len(im_w, n_crops_per_side, overlap)
        crop_h = crop_len(im_h, n_crops_per_side, overlap)
        crop_box_x0 = [int((crop_w - overlap) * i) for i in range(n_crops_per_side)]
        crop_box_y0 = [int((crop_h - overlap) * i) for i in range(n_crops_per_side)]
        for x0, y0 in product(crop_box_x0, crop_box_y0):
            crop_boxes.append([x0, y0, min(x0 + crop_w, im_w), min(y0 + crop_h, im_h)])
            layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def uncrop_boxes_xyxy(boxes: np.ndarray, crop_box: List[int]) -> np.ndarray:
    x0, y0, _, _ = crop_box
    return boxes + np.array([[x0, y0, x0, y0]], dtype=boxes.dtype)


def uncrop_points(points: np.ndarray, crop_box: List[int]) -> np.ndarray:
    x0, y0, _, _ = crop_box
    return points + np.array([[x0, y0]], dtype=points.dtype)


def uncrop_masks(masks: np.ndarray, crop_box: List[int], orig_h: int, orig_w: int) -> np.ndarray:
    x0, y0, x1, y1 = crop_box
    if x0 == 0 and y0 == 0 and x1 == orig_w and y1 == orig_h:
        return masks
    return np.pad(masks, ((0, 0), (y0, orig_h - y1), (x0, orig_w - x1)))


def remove_small_regions(
    mask: np.ndarray, area_thresh: float, mode: str
) -> Tuple[np.ndarray, bool]:
    """Remove disconnected regions ("islands") or holes smaller than
    ``area_thresh`` (ref amg.py:267-287, scipy labelling as in JAX)."""
    from scipy import ndimage

    assert mode in ("holes", "islands")
    correct_holes = mode == "holes"
    working_mask = (correct_holes ^ mask).astype(np.uint8)
    labels, n_labels = ndimage.label(working_mask)
    if n_labels == 0:
        return mask, False
    sizes = ndimage.sum_labels(np.ones_like(labels), labels, index=np.arange(1, n_labels + 1))
    small_regions = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small_regions:
        return mask, False
    fill_labels = [0] + small_regions
    if not correct_holes:
        fill_labels = [i for i in range(n_labels + 1) if i not in fill_labels]
        if not fill_labels:
            fill_labels = [int(np.argmax(sizes)) + 1]
    return np.isin(labels, fill_labels), True


def batched_mask_to_box(masks: np.ndarray) -> np.ndarray:
    """XYXY float32 boxes around (..., H, W) masks; zeros for empty masks
    (ref amg.py:303-346)."""
    if masks.size == 0:
        return np.zeros((*masks.shape[:-2], 4), dtype=np.float32)
    shape = masks.shape
    masks = masks.reshape(-1, *shape[-2:]).astype(bool)
    h, w = masks.shape[-2:]
    in_height = masks.max(axis=-1)
    in_width = masks.max(axis=-2)
    ys = np.arange(h)[None, :]
    xs = np.arange(w)[None, :]
    bottom = (in_height * ys).max(axis=-1)
    top = np.where(in_height, ys, h).min(axis=-1)
    right = (in_width * xs).max(axis=-1)
    left = np.where(in_width, xs, w).min(axis=-1)
    empty = (top > bottom) | (left > right)
    out = np.stack([left, top, right, bottom], axis=-1).astype(np.float32)
    out[empty] = 0
    return out.reshape(*shape[:-2], 4)


def box_nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy IoU NMS -> kept indices, score-descending (``native.box_nms``)."""
    return native.box_nms(np.asarray(boxes, np.float32), np.asarray(scores, np.float32),
                          iou_threshold)


def batched_nms(
    boxes: np.ndarray, scores: np.ndarray, idxs: np.ndarray, iou_threshold: float
) -> np.ndarray:
    """Category-aware NMS through the coordinate-offset trick."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    max_coord = boxes.max() + 1
    offsets = idxs.astype(np.float32) * max_coord
    return box_nms(boxes + offsets[:, None], scores, iou_threshold)


# ---------------------------------------------------------------------------
# Comparing two generators' annotations
# ---------------------------------------------------------------------------


def annotation_mask(ann: Dict[str, Any]) -> np.ndarray:
    """The (H, W) bool mask of an annotation in either output mode."""
    seg = ann["segmentation"]
    return rle_to_mask(seg) if isinstance(seg, dict) else np.asarray(seg, bool)


def _prompt_key(ann: Dict[str, Any]) -> tuple:
    return tuple(np.round(ann["point_coords"][0], 6)), tuple(ann["crop_box"])


def match_annotations(ref: List[Dict[str, Any]], got: List[Dict[str, Any]]) -> List[tuple]:
    """Index pairs (i, j) of ``ref`` and ``got`` annotations of the same
    point and crop box, each ``ref`` one taking the free ``got`` one of
    nearest predicted IoU: the three masks of a point differ there, and
    IoUs a rounding step apart may swap places in the NMS order."""
    free: Dict[tuple, List[int]] = {}
    for j, ann in enumerate(got):
        free.setdefault(_prompt_key(ann), []).append(j)
    pairs = []
    for i, ann in enumerate(ref):
        cands = free.get(_prompt_key(ann), [])
        if cands:
            j = min(cands, key=lambda j: abs(got[j]["predicted_iou"] - ann["predicted_iou"]))
            cands.remove(j)
            pairs.append((i, j))
    return pairs


def annotation_gaps(ref: List[Dict[str, Any]], got: List[Dict[str, Any]]) -> Dict[str, float]:
    """The largest differences over matched annotations: ``pixels`` (share
    of differing mask pixels), ``bbox`` (px), ``iou``, ``stability``,
    ``area`` (|area - mask sum| of ``got``'s), beside ``ref`` / ``got`` /
    ``matched`` counts."""
    gaps = {"ref": len(ref), "got": len(got), "matched": 0, "pixels": 0.0, "bbox": 0.0,
            "iou": 0.0, "stability": 0.0, "area": 0}
    for i, j in match_annotations(ref, got):
        a, b = ref[i], got[j]
        ma, mb = annotation_mask(a), annotation_mask(b)
        gaps["matched"] += 1
        gaps["pixels"] = max(gaps["pixels"], float((ma != mb).mean()))
        gaps["bbox"] = max(gaps["bbox"], max(abs(x - y) for x, y in zip(a["bbox"], b["bbox"])))
        gaps["iou"] = max(gaps["iou"], abs(a["predicted_iou"] - b["predicted_iou"]))
        gaps["stability"] = max(gaps["stability"],
                                abs(a["stability_score"] - b["stability_score"]))
        gaps["area"] = max(gaps["area"], abs(int(mb.sum()) - b["area"]))
    return gaps
