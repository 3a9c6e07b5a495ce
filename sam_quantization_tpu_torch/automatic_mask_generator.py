"""SamAutomaticMaskGenerator: grid-prompted whole-image segmentation.

Counterpart of ``sam_quantization_tpu/automatic_mask_generator.py`` (ref
``segment_anything/automatic_mask_generator.py:35-372``): a point grid,
batched single-point prompts, IoU and stability filters, box NMS, crop
layers, RLE or binary output, small-region removal.

Each batch of ``points_per_batch`` prompts is one decode on the device. On
a full-image crop the mask postprocess runs there too (upsample, stability,
threshold, boxes, column-major bit-pack), and only the packed bits, IoUs,
stabilities and boxes of the masks that pass the filters reach the host,
where ``native.rle_encode_batch_packed`` reads runs off the packed bytes.
Other crops take the general path: float logits to the host, numpy
postprocess, as in the JAX package. The encoder runs through the attention
kernels (and the packed-weight kernels for a quantized encoder) under
``attn_impl="kernel"``; ``"eager"`` runs the plain path.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sam_quantization_tpu_torch import native
from sam_quantization_tpu_torch.models import sam as sam_lib
from sam_quantization_tpu_torch.predictor import SamPredictor
from sam_quantization_tpu_torch.utils import amg as amg_utils


class SamAutomaticMaskGenerator:
    """Same arguments and defaults as the JAX generator, with the port
    predictor's ``attn_impl``. ``mesh`` is refused: the data-parallel
    decode is not ported (ROADMAP, Queue 1, item 7).

    The JAX generator's ``SAMQ_AMG_PACKED`` switch is the class attribute
    :attr:`packed_fast_path`; both paths give the same annotations. Its
    ``_packed_size_cap`` bounds the jit recompiles of the packed program per
    image size; torch compiles nothing per shape, so there is no cap.
    """

    packed_fast_path = True

    def __init__(
        self,
        model: sam_lib.Sam,
        points_per_side: Optional[int] = 32,
        points_per_batch: int = 64,
        pred_iou_thresh: float = 0.88,
        stability_score_thresh: float = 0.95,
        stability_score_offset: float = 1.0,
        box_nms_thresh: float = 0.7,
        crop_n_layers: int = 0,
        crop_nms_thresh: float = 0.7,
        crop_overlap_ratio: float = 512 / 1500,
        crop_n_points_downscale_factor: int = 1,
        point_grids: Optional[List[np.ndarray]] = None,
        min_mask_region_area: int = 0,
        output_mode: str = "binary_mask",
        attn_impl: str = "kernel",
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh: the data-parallel AMG decode is not ported (ROADMAP, Queue 1, "
                "item 7, 'Parallel')")
        assert (points_per_side is None) != (point_grids is None), (
            "Exactly one of points_per_side or point_grids must be provided."
        )
        if points_per_side is not None:
            self.point_grids = amg_utils.build_all_layer_point_grids(
                points_per_side, crop_n_layers, crop_n_points_downscale_factor)
        else:
            self.point_grids = point_grids
        assert output_mode in ("binary_mask", "uncompressed_rle")
        self.predictor = SamPredictor(model, attn_impl=attn_impl)
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode

    def generate(self, image: np.ndarray) -> List[Dict[str, Any]]:
        """(H, W, 3) uint8 RGB -> list of mask records (ref generate,
        automatic_mask_generator.py:131-198)."""
        mask_data = self._generate_masks(image)
        if self.min_mask_region_area > 0:
            mask_data = self.postprocess_small_regions(
                mask_data, self.min_mask_region_area,
                max(self.box_nms_thresh, self.crop_nms_thresh))
        if self.output_mode == "binary_mask":
            segmentations = [amg_utils.rle_to_mask(r) for r in mask_data["rles"]]
        else:
            segmentations = mask_data["rles"]
        return [
            {
                "segmentation": seg,
                "area": amg_utils.area_from_rle(rle),
                "bbox": amg_utils.box_xyxy_to_xywh(box).tolist(),
                "predicted_iou": float(iou),
                "point_coords": [point.tolist()],
                "stability_score": float(stability),
                "crop_box": amg_utils.box_xyxy_to_xywh(np.asarray(crop_box, np.float32)).tolist(),
            }
            for seg, rle, box, iou, point, stability, crop_box in zip(
                segmentations, mask_data["rles"], mask_data["boxes"], mask_data["iou_preds"],
                mask_data["points"], mask_data["stability_score"], mask_data["crop_boxes"])
        ]

    def _generate_masks(self, image: np.ndarray) -> amg_utils.MaskData:
        orig_size = image.shape[:2]
        crop_boxes, layer_idxs = amg_utils.generate_crop_boxes(
            orig_size, self.crop_n_layers, self.crop_overlap_ratio)
        data = amg_utils.MaskData()
        for crop_box, layer_idx in zip(crop_boxes, layer_idxs):
            data.cat(self._process_crop(image, crop_box, layer_idx, orig_size))
        if len(crop_boxes) > 1 and len(data["rles"]):
            # Prefer masks from smaller crops (ref :173-179). With no mask
            # left the JAX generator raises here (a 1-D empty crop-box array);
            # the port returns no annotation.
            scores = 1.0 / _box_area(np.asarray(data["crop_boxes"], np.float32))
            keep = native.box_nms(data["boxes"].astype(np.float32),
                                  scores.astype(np.float32), self.crop_nms_thresh)
            data.filter(keep)
        return data

    def _process_crop(self, image, crop_box: List[int], crop_layer_idx: int,
                      orig_size) -> amg_utils.MaskData:
        x0, y0, x1, y1 = crop_box
        cropped_im = image[y0:y1, x0:x1, :]
        cropped_im_size = cropped_im.shape[:2]
        self.predictor.set_image(cropped_im)
        points_scale = np.array(cropped_im_size)[None, ::-1]
        points_for_image = self.point_grids[crop_layer_idx] * points_scale

        data = amg_utils.MaskData()
        for (points,) in amg_utils.batch_iterator(self.points_per_batch, points_for_image):
            data.cat(self._process_batch(points, cropped_im_size, crop_box, orig_size))
        self.predictor.reset_image()

        keep = native.box_nms(data["boxes"].astype(np.float32),
                              data["iou_preds"].astype(np.float32), self.box_nms_thresh)
        data.filter(keep)
        data["boxes"] = amg_utils.uncrop_boxes_xyxy(data["boxes"], crop_box)
        data["points"] = amg_utils.uncrop_points(data["points"], crop_box)
        data["crop_boxes"] = [crop_box for _ in range(len(data["rles"]))]
        return data

    def _prompts(self, points: np.ndarray, im_size):
        """Each point as the prompt [point, pad] with labels [1, -1], in
        ``points_per_batch`` rows, all-pad rows after the last point
        (ref :172-176)."""
        in_points = self.predictor.transform.apply_coords(points, im_size)
        coords = np.zeros((self.points_per_batch, 2, 2), np.float32)
        labels = -np.ones((self.points_per_batch, 2), np.float32)
        coords[: len(points), 0] = in_points
        labels[: len(points), 0] = 1.0
        dev = self.predictor.device
        return torch.from_numpy(coords).to(dev), torch.from_numpy(labels).to(dev)

    def _process_batch(self, points: np.ndarray, im_size, crop_box,
                       orig_size) -> amg_utils.MaskData:
        """One decode over a batch of single-point prompts (ref
        _process_batch, automatic_mask_generator.py:277-320)."""
        orig_h, orig_w = orig_size
        n = len(points)
        coords, labels = self._prompts(points, im_size)
        pred = self.predictor
        thr = float(pred.model.mask_threshold)
        points3 = np.repeat(points, 3, axis=0)
        full_crop = (list(crop_box) == [0, 0, orig_w, orig_h]
                     and tuple(im_size) == tuple(orig_size))
        if full_crop and self.packed_fast_path:
            packed, iou_p, stab, boxes = _batched_decode_packed(
                pred.model, pred.features, coords, labels, n, pred.input_size,
                tuple(im_size), thr, float(self.stability_score_offset))
            data = amg_utils.MaskData(
                iou_preds=iou_p.cpu().numpy(), stability_score=stab.cpu().numpy(),
                boxes=boxes.cpu().numpy(), points=points3,
                index=np.arange(len(points3)))
            if self.pred_iou_thresh > 0.0:
                data.filter(data["iou_preds"] > self.pred_iou_thresh)
            if self.stability_score_thresh > 0.0:
                data.filter(data["stability_score"] >= self.stability_score_thresh)
            keep = ~amg_utils.is_box_near_crop_edge(data["boxes"], crop_box,
                                                    [0, 0, orig_w, orig_h])
            if not keep.all():
                data.filter(keep)
            # only the packed bits of the kept masks cross to the host
            kept = torch.from_numpy(data["index"]).to(packed.device)
            counts = native.rle_encode_batch_packed(packed[kept].cpu().numpy(), orig_h, orig_w)
            del data["index"]
            data["rles"] = [{"size": [orig_h, orig_w], "counts": c} for c in counts]
            return data

        masks, iou_preds = _batched_decode(pred.model, pred.features, coords, labels, n,
                                           pred.input_size, tuple(im_size))
        masks = masks.cpu().numpy()
        data = amg_utils.MaskData(masks=masks, iou_preds=iou_preds.cpu().numpy(),
                                  points=points3)
        if self.pred_iou_thresh > 0.0:
            data.filter(data["iou_preds"] > self.pred_iou_thresh)
        data["stability_score"] = amg_utils.calculate_stability_score(
            data["masks"], thr, self.stability_score_offset)
        if self.stability_score_thresh > 0.0:
            data.filter(data["stability_score"] >= self.stability_score_thresh)

        data["masks"] = data["masks"] > thr
        data["boxes"] = amg_utils.batched_mask_to_box(data["masks"])
        keep = ~amg_utils.is_box_near_crop_edge(data["boxes"], crop_box, [0, 0, orig_w, orig_h])
        if not keep.all():
            data.filter(keep)
        data["masks"] = amg_utils.uncrop_masks(data["masks"], crop_box, orig_h, orig_w)
        counts = native.rle_encode_batch(np.asarray(data["masks"], np.uint8))
        data["rles"] = [{"size": [orig_h, orig_w], "counts": c} for c in counts]
        del data["masks"]
        return data

    @staticmethod
    def postprocess_small_regions(mask_data: amg_utils.MaskData, min_area: int,
                                  nms_thresh: float) -> amg_utils.MaskData:
        """Remove small islands and holes, then NMS that prefers the masks it
        left unchanged (ref postprocess_small_regions, :322-372)."""
        if len(mask_data["rles"]) == 0:
            return mask_data
        new_masks, scores = [], []
        for rle in mask_data["rles"]:
            mask = amg_utils.rle_to_mask(rle)
            mask, changed = amg_utils.remove_small_regions(mask, min_area, "holes")
            unchanged = not changed
            mask, changed = amg_utils.remove_small_regions(mask, min_area, "islands")
            unchanged = unchanged and not changed
            new_masks.append(mask)
            scores.append(float(unchanged))
        masks = np.stack(new_masks, axis=0)
        boxes = amg_utils.batched_mask_to_box(masks)
        keep = native.box_nms(boxes.astype(np.float32), np.asarray(scores, np.float32),
                              nms_thresh)
        for i in keep:
            if scores[i] == 0.0:
                mask_data["rles"][i] = amg_utils.mask_to_rle(masks[i])
                mask_data["boxes"][i] = boxes[i]
        mask_data.filter(keep)
        return mask_data


def _box_area(boxes: np.ndarray) -> np.ndarray:
    return np.maximum(boxes[:, 2] - boxes[:, 0], 1e-6) * np.maximum(
        boxes[:, 3] - boxes[:, 1], 1e-6)


@torch.inference_mode()
def _batched_decode(model, features, coords, labels, n, input_size, im_size):
    """The batch's prompts -> 3 multimask logit maps each at ``im_size``
    ((3n, H, W) float32) and their predicted IoUs (3n,). The decoder runs
    in float32 on all ``points_per_batch`` rows, pad rows included, as the
    JAX program does; only the first ``n`` rows are upsampled."""
    low_res, iou = sam_lib.decode_masks(model, features.float(), points=(coords, labels),
                                        multimask_output=True)
    masks = sam_lib.postprocess_masks(model, low_res[:n], input_size, im_size)
    return masks.reshape(-1, *im_size), iou[:n].reshape(-1)


@torch.inference_mode()
def _batched_decode_packed(model, features, coords, labels, n, input_size, im_size, thr, off):
    """A full-crop batch on the device, postprocess included: decode ->
    upsample -> stability (int32 counts, a float32 quotient) -> threshold
    -> boxes -> column-major bit-pack. Returns (packed (3n, W, ceil(H/8))
    uint8, iou (3n,), stability (3n,), boxes (3n, 4) float32), all on the
    device."""
    masks, iou = _batched_decode(model, features, coords, labels, n, input_size, im_size)
    H, W = im_size
    hi = (masks > thr + off).sum((1, 2), dtype=torch.int32)
    lo = (masks > thr - off).sum((1, 2), dtype=torch.int32)
    stability = hi.float() / lo.clamp(min=1).float()
    binm = masks > thr
    del masks
    # boxes as utils/amg.batched_mask_to_box, empty masks -> zeros
    in_h, in_w = binm.any(2), binm.any(1)  # (M, H), (M, W)
    ys = torch.arange(H, device=binm.device)
    xs = torch.arange(W, device=binm.device)
    bottom = (in_h * ys).amax(-1)
    top = torch.where(in_h, ys, H).amin(-1)
    right = (in_w * xs).amax(-1)
    left = torch.where(in_w, xs, W).amin(-1)
    empty = (left > right) | (top > bottom)
    boxes = torch.stack([left, top, right, bottom], -1).masked_fill(empty[:, None], 0).float()
    return amg_utils.packbits_masks(binm), iou, stability, boxes
