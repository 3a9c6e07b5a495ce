"""Interactive-segmentation datasets: base, SBD, COCO-style, GrabCut-style.

Counterpart of ``sam_quantization_tpu/data/datasets.py`` and of the
reference's ``data/`` package (base.py ISDataset, datasets/sbd.py) and
``utils/datautils.py`` (SA-1B loaders). Samples stream as numpy, sharded
per host by slicing (the ``DistributedSampler`` counterpart is
:func:`shard_indices`); :func:`preprocess_for_eval` gives the NHWC image and
gt in the padded frame that the click evaluators take.

Image decoding uses imageio if present, else PIL; the datasets themselves
are optional at run time (the tests use ``data/synthetic.py`` and small
files they write).
"""

from __future__ import annotations

import glob
import json
import random
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from sam_quantization_tpu_torch import native
from sam_quantization_tpu_torch.utils import config as config_lib
from sam_quantization_tpu_torch.utils.transforms import ResizeLongestSide


def _imread(path: str) -> np.ndarray:
    try:
        import imageio.v2 as imageio

        return np.asarray(imageio.imread(path))
    except ImportError:
        from PIL import Image  # type: ignore

        return np.asarray(Image.open(path).convert("RGB"))


def get_labels_with_sizes(mask: np.ndarray):
    """(ids, sizes) of nonzero instance labels (ref utils/misc.py)."""
    labels, sizes = np.unique(mask, return_counts=True)
    keep = labels > 0
    return labels[keep].tolist(), sizes[keep].tolist()


def get_bbox_from_mask(mask: np.ndarray):
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return rmin, rmax, cmin, cmax


class DSample:
    """Image + instance masks + object ids (ref data/sample.py)."""

    def __init__(self, image, instances_mask, objects_ids=None, sample_id=None):
        self.image = image
        self.instances_mask = instances_mask
        self.objects_ids = objects_ids or []
        self.sample_id = sample_id

    def object_mask(self, obj_id) -> np.ndarray:
        return (self.instances_mask == obj_id).astype(np.int32)


class ISDataset:
    """Base dataset: index → DSample; eval iteration yields per-instance
    (image, gt_mask) pairs (ref data/base.py:10-95)."""

    def __init__(self, epoch_len: int = -1, min_object_area: int = 0):
        self.epoch_len = epoch_len
        self.min_object_area = min_object_area
        self.dataset_samples: List = []

    def __len__(self):
        return self.epoch_len if self.epoch_len > 0 else len(self.dataset_samples)

    def get_sample(self, index: int) -> DSample:
        raise NotImplementedError

    def eval_items(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        """Yield (image, binary gt mask, sample_id) for each instance."""
        for i in range(len(self.dataset_samples)):
            s = self.get_sample(i)
            for obj_id in s.objects_ids:
                m = s.object_mask(obj_id)
                if m.sum() < self.min_object_area:
                    continue
                yield s.image, m, i


class SBDDataset(ISDataset):
    """SBD .mat instance masks with the buggy-mask filter
    (ref data/datasets/sbd.py:15-121; train list truncated to 500 at :28)."""

    def __init__(
        self,
        dataset_path: str,
        split: str = "val",
        buggy_mask_thresh: float = 0.08,
        max_samples: int = 500,
        **kw,
    ):
        super().__init__(**kw)
        assert split in ("train", "val")
        self.dataset_path = Path(dataset_path)
        self.split = split
        self._images_path = self.dataset_path / "img"
        self._insts_path = self.dataset_path / "inst"
        self._buggy_mask_thresh = buggy_mask_thresh
        self._buggy_objects: dict = {}
        with open(self.dataset_path / f"{split}.txt") as f:
            self.dataset_samples = [x.strip() for x in f.readlines()][:max_samples]

    def get_sample(self, index: int) -> DSample:
        from scipy.io import loadmat

        name = self.dataset_samples[index]
        image = _imread(str(self._images_path / f"{name}.jpg"))
        mat = loadmat(str(self._insts_path / f"{name}.mat"))
        instances_mask = mat["GTinst"][0][0][0].astype(np.int32)
        instances_mask = self._remove_buggy_masks(index, instances_mask)
        ids, _ = get_labels_with_sizes(instances_mask)
        return DSample(image, instances_mask, objects_ids=ids, sample_id=index)

    def _remove_buggy_masks(self, index, instances_mask):
        """Drop instances whose area/bbox ratio < thresh (ref sbd.py:47-68)."""
        if self._buggy_mask_thresh <= 0.0:
            return instances_mask
        buggy = self._buggy_objects.get(index)
        if buggy is None:
            buggy = []
            ids, _ = get_labels_with_sizes(instances_mask)
            for obj_id in ids:
                obj_mask = instances_mask == obj_id
                rmin, rmax, cmin, cmax = get_bbox_from_mask(obj_mask)
                bbox_area = (rmax - rmin + 1) * (cmax - cmin + 1)
                if obj_mask.sum() / bbox_area < self._buggy_mask_thresh:
                    buggy.append(obj_id)
            self._buggy_objects[index] = buggy
        for obj_id in buggy:
            instances_mask[instances_mask == obj_id] = 0
        return instances_mask


class ImageMaskDataset(ISDataset):
    """GrabCut/Berkeley/DAVIS-style folder pairs: images/ + masks/
    (ref inference-utils dataset family used by scripts/evaluate_model.py)."""

    def __init__(
        self,
        dataset_path: str,
        images_dir="images",
        masks_dir="masks",
        mask_thresh: int = 127,
        **kw,
    ):
        super().__init__(**kw)
        root = Path(dataset_path)
        self._images = sorted((root / images_dir).glob("*.*"))
        self._masks_dir = root / masks_dir
        self._mask_thresh = mask_thresh
        self.dataset_samples = [p.stem for p in self._images]

    def get_sample(self, index: int) -> DSample:
        img_path = self._images[index]
        image = _imread(str(img_path))
        mask_candidates = list(self._masks_dir.glob(img_path.stem + ".*"))
        mask = _imread(str(mask_candidates[0]))
        if mask.ndim == 3:
            mask = mask[..., 0]
        inst = (mask > self._mask_thresh).astype(np.int32)
        return DSample(image, inst, objects_ids=[1], sample_id=index)


class GrabCutDataset(ImageMaskDataset):
    """GrabCut benchmark: ``data_GT/`` images + ``boundary_GT/`` trimaps
    (0 = bg, 128 = uncertain boundary ring, 255 = fg). Counterpart of the
    RITM-lineage ``GrabCutDataset`` the reference's eval driver names
    (inference/utils.py:49-50) but does not ship in-tree. The uncertain ring
    maps to background — the click evaluators use a binary gt
    (script/evaluation2.py:316-326), so only the 255 region counts as
    object."""

    def __init__(self, dataset_path: str, **kw):
        kw.setdefault("images_dir", "data_GT")
        kw.setdefault("masks_dir", "boundary_GT")
        kw.setdefault("mask_thresh", 200)
        super().__init__(dataset_path, **kw)


class BerkeleyDataset(ImageMaskDataset):
    """Berkeley benchmark: ``images/`` + ``masks/`` binary pairs
    (ref inference/utils.py:51-52)."""

    def __init__(self, dataset_path: str, **kw):
        super().__init__(dataset_path, **kw)


class DavisDataset(ImageMaskDataset):
    """DAVIS-345 benchmark frames: ``img/`` + ``gt/`` binary pairs
    (ref inference/utils.py:53-54)."""

    def __init__(self, dataset_path: str, **kw):
        kw.setdefault("images_dir", "img")
        kw.setdefault("masks_dir", "gt")
        super().__init__(dataset_path, **kw)


class CocoMvalDataset(DavisDataset):
    """COCO_MVal benchmark — the reference evaluates it through the DAVIS
    folder layout (``img``/``gt``; inference/utils.py:61-62)."""


class PascalVocDataset(ISDataset):
    """PascalVOC instance-segmentation eval split: VOC2012 layout
    (``JPEGImages/`` + ``SegmentationObject/`` + ``ImageSets/Segmentation``)
    with per-instance ids; 255 is the VOC ignore boundary, dropped to
    background (ref inference/utils.py:59-60 names PascalVocDataset)."""

    def __init__(self, dataset_path: str, split: str = "val", **kw):
        super().__init__(**kw)
        root = Path(dataset_path)
        self._images_path = root / "JPEGImages"
        self._insts_path = root / "SegmentationObject"
        list_file = root / "ImageSets" / "Segmentation" / f"{split}.txt"
        if list_file.is_file():
            names = [x.strip() for x in list_file.read_text().splitlines() if x.strip()]
        else:  # fall back to whatever masks exist
            names = sorted(p.stem for p in self._insts_path.glob("*.png"))
        self.dataset_samples = names

    def get_sample(self, index: int) -> DSample:
        name = self.dataset_samples[index]
        image = _imread(str(self._images_path / f"{name}.jpg"))
        mask = _read_index_mask(str(self._insts_path / f"{name}.png"))
        mask = mask.astype(np.int32)
        mask[mask == 255] = 0  # VOC ignore boundary
        ids, _ = get_labels_with_sizes(mask)
        return DSample(image, mask, objects_ids=ids, sample_id=index)


def _read_index_mask(path: str) -> np.ndarray:
    """Palette-indexed PNG → label ids (no RGB conversion)."""
    try:
        from PIL import Image  # type: ignore

        return np.asarray(Image.open(path))
    except ImportError:
        m = _imread(path)
        return m[..., 0] if m.ndim == 3 else m


def get_dataset(name: str, dataset_path: Optional[str] = None, cfg=None):
    """Named benchmark registry — flag parity with the reference's
    ``utils.get_dataset`` (inference/utils.py:48-66) + config.yml paths.

    ``dataset_path`` overrides the registry; otherwise the path comes from
    ``utils.config`` (GRABCUT_PATH/BERKELEY_PATH/DAVIS_PATH/...).
    """
    if cfg is None:
        cfg = config_lib.load_config()
    key = name.upper()
    factories = {
        "GRABCUT": GrabCutDataset,
        "BERKELEY": BerkeleyDataset,
        "DAVIS": DavisDataset,
        "COCO_MVAL": CocoMvalDataset,
        "PASCALVOC": lambda p: PascalVocDataset(p, split="val"),
        "SBD": lambda p: SBDDataset(p, split="val"),
        "SBD_TRAIN": lambda p: SBDDataset(p, split="train"),
        "SA1B": SA1BDataset,
    }
    if key not in factories:
        return None
    # SBD train/val splits share one dataset root (SBD_PATH)
    path_name = "SBD" if key == "SBD_TRAIN" else name
    path = dataset_path or config_lib.dataset_path(cfg, path_name)
    return factories[key](path)


class SA1BDataset(ISDataset):
    """SA-1B-style dataset: image folder + per-image json with COCO
    *uncompressed* RLE annotations (ref utils/datautils.py:76-129
    SA1B_Dataset; we read the json sidecars directly instead of wrapping
    torchvision.ImageFolder)."""

    def __init__(self, dataset_path: str, max_masks_per_image: int = 16, **kw):
        super().__init__(**kw)
        self.root = Path(dataset_path)
        self._images = sorted(
            p for p in glob.glob(str(self.root / "**" / "*.jpg"), recursive=True)
        )
        self.dataset_samples = [Path(p).stem for p in self._images]
        self.max_masks = max_masks_per_image

    def get_sample(self, index: int) -> DSample:
        img_path = self._images[index]
        image = _imread(img_path)
        ann_path = str(Path(img_path).with_suffix(".json"))
        with open(ann_path) as f:
            anns = json.load(f)["annotations"]
        inst = np.zeros(image.shape[:2], np.int32)
        for i, ann in enumerate(anns[: self.max_masks]):
            rle = ann["segmentation"]
            m = native.rle_decode(rle["counts"], rle["size"][0], rle["size"][1])
            inst[m] = i + 1
        ids, _ = get_labels_with_sizes(inst)
        return DSample(image, inst, objects_ids=ids, sample_id=index)

    def bbox_prompts(self, index: int):
        """(image, boxes xyxy, masks) for box-prompt fine-tuning (ref
        SAMDataset.__getitem__, utils/datautils.py:33-75)."""
        s = self.get_sample(index)
        boxes, masks = [], []
        for obj_id in s.objects_ids:
            m = s.object_mask(obj_id)
            rmin, rmax, cmin, cmax = get_bbox_from_mask(m)
            boxes.append([cmin, rmin, cmax, rmax])
            masks.append(m)
        return s.image, np.asarray(boxes, np.float32), np.asarray(masks)


def shard_indices(n: int, num_shards: int, shard: int, seed: int = 0, shuffle=True):
    """Per-host index shard (DistributedSampler counterpart,
    utils/distributed.py:50-57): pad to a multiple and stride."""
    idx = list(range(n))
    if shuffle:
        random.Random(seed).shuffle(idx)
    per = (n + num_shards - 1) // num_shards
    idx = (idx * 2)[: per * num_shards]  # wrap-around padding
    return idx[shard::num_shards]


def resize_nearest(mask: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize of a 2-D array with half-pixel centres, the
    indices computed as ``jax.image.resize(..., "nearest")`` computes them
    once XLA has folded its ``(i + 0.5) * in / out``: floor((i + 0.5) * c)
    in float32, c = float32(in) * float32(1 / out) rounded to float32."""
    t = torch.as_tensor(np.ascontiguousarray(mask))
    for axis, n in enumerate(size):
        m = t.shape[axis]
        c = float(np.float32(m) * (np.float32(1) / np.float32(n)))
        idx = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5) * c).long()
        t = t.index_select(axis, idx)
    return t.numpy()


def preprocess_for_eval(
    image: np.ndarray, gt: np.ndarray, img_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Resize longest side to img_size and zero-pad, returning the NHWC
    image batch + gt in the padded frame (what the click evaluators expect).
    The image resizes bilinearly (antialiased when it shrinks), the gt by
    :func:`resize_nearest`."""
    resized = ResizeLongestSide(img_size).apply_image(image).numpy()
    h, w = resized.shape[:2]
    img = np.zeros((img_size, img_size, 3), np.float32)
    img[:h, :w] = resized
    gt_r = resize_nearest(np.asarray(gt, np.float32), (h, w))
    gt_full = np.zeros((img_size, img_size), np.int32)
    gt_full[:h, :w] = (gt_r > 0.5).astype(np.int32)
    return img[None], gt_full
