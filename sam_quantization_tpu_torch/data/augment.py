"""Training augmentations (albumentations counterparts, host-side numpy).

Counterpart of ``sam_quantization_tpu/data/augment.py`` (the reference
composes albumentations transforms, data/transforms.py:13-37
``UniformRandomResize``, plus the flips and crops configured in
train_sm.py). Each transform draws from Python's ``random`` in the JAX
module's order, so a seed gives the same resizes, flips, crops and colour
changes. The resize is the JAX module's ``jax.image.resize``: bilinear with
half-pixel centres, antialiased where it shrinks (``models.sam.
resize_bilinear``), and the mask's nearest neighbour
(``data.datasets.resize_nearest``).
"""

from __future__ import annotations

import random
from typing import Sequence, Tuple

import numpy as np
import torch

from sam_quantization_tpu_torch.data.datasets import resize_nearest
from sam_quantization_tpu_torch.models.sam import resize_bilinear


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, image: np.ndarray, mask: np.ndarray):
        for t in self.transforms:
            image, mask = t(image, mask)
        return image, mask


class UniformRandomResize:
    """Scale both image and mask by a uniform random factor
    (ref data/transforms.py:13-37)."""

    def __init__(self, scale_range: Tuple[float, float] = (0.9, 1.1)):
        self.scale_range = scale_range

    def __call__(self, image, mask):
        scale = random.uniform(*self.scale_range)
        h = int(round(image.shape[0] * scale))
        w = int(round(image.shape[1] * scale))
        x = torch.as_tensor(np.asarray(image, np.float32)).permute(2, 0, 1)[None]
        img = resize_bilinear(x, (h, w))[0].permute(1, 2, 0).numpy()
        m = resize_nearest(np.asarray(mask, np.float32), (h, w)).astype(mask.dtype)
        return img, m


class HorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, image, mask):
        if random.random() < self.p:
            return image[:, ::-1].copy(), mask[:, ::-1].copy()
        return image, mask


class RandomCrop:
    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, image, mask):
        th, tw = self.size
        h, w = image.shape[:2]
        if h <= th or w <= tw:
            pad_h, pad_w = max(0, th - h), max(0, tw - w)
            image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)))
            mask = np.pad(mask, ((0, pad_h), (0, pad_w)))
            h, w = image.shape[:2]
        y0 = random.randint(0, h - th)
        x0 = random.randint(0, w - tw)
        return image[y0 : y0 + th, x0 : x0 + tw], mask[y0 : y0 + th, x0 : x0 + tw]


class RandomBrightnessContrast:
    def __init__(self, brightness: float = 0.25, contrast: float = 0.25, p=0.75):
        self.brightness, self.contrast, self.p = brightness, contrast, p

    def __call__(self, image, mask):
        if random.random() >= self.p:
            return image, mask
        b = 1.0 + random.uniform(-self.brightness, self.brightness)
        c = 1.0 + random.uniform(-self.contrast, self.contrast)
        mean = image.mean()
        out = np.clip((image - mean) * c + mean * b, 0, 255)
        return out.astype(image.dtype), mask


def default_train_augmentor(crop_size: Tuple[int, int] = (1024, 1024)) -> Compose:
    """The reference trainer's augmentation stack shape (train_sm.py cfg)."""
    return Compose([
        UniformRandomResize((0.75, 1.25)),
        HorizontalFlip(),
        RandomCrop(crop_size),
        RandomBrightnessContrast(),
    ])
