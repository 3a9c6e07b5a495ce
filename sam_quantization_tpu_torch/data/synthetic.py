"""Synthetic segmentation samples for tests, training and benchmarks.

The port's own copy of ``sam_quantization_tpu/data/synthetic.py`` (numpy
only): the same seed gives the same scenes, bit for bit. The reference
calibrates/evaluates on SBD (data/datasets/sbd.py); datasets aren't shipped
with either repo, so tests and standalone benchmarks use seeded random blob
scenes with exactly the (image, instance-mask) contract of the SBD loaders.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def random_blob_mask(rng: np.random.Generator, size: int, n_ellipses: int = 3):
    """Union of random ellipses — a plausibly-shaped object mask."""
    yy, xx = _int_grid(size)
    mask = np.zeros((size, size), bool)
    cx0, cy0 = rng.uniform(0.3 * size, 0.7 * size, 2)
    for _ in range(n_ellipses):
        cx = cx0 + rng.uniform(-0.12, 0.12) * size
        cy = cy0 + rng.uniform(-0.12, 0.12) * size
        a = rng.uniform(0.08, 0.22) * size
        b = rng.uniform(0.08, 0.22) * size
        th = rng.uniform(0, np.pi)
        x, y = xx - cx, yy - cy
        xr = x * np.cos(th) + y * np.sin(th)
        yr = -x * np.sin(th) + y * np.cos(th)
        mask |= (xr / a) ** 2 + (yr / b) ** 2 <= 1.0
    return mask


def synthetic_samples(
    n: int, size: int = 1024, seed: int = 0, style: str = "easy"
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (image (1, size, size, 3) float32 RGB [0,255], gt mask (size, size)).

    ``style``:
      - "easy" (default): one solid-color blob on a solid background —
        saturates a trained model's 5-click mIoU near 0.94, so the quality
        table's quant deltas compress to ~0.001 there.
      - "hard": 2–4 distinctly-colored objects with the GT being ONE
        target instance among distractors (later objects occlude it), on a
        low-frequency textured gradient background with per-object
        texture. Discriminates quant configs where "easy" cannot (a model
        trained on these lands mid-range, leaving headroom in BOTH
        directions for quantization to move).
    """
    rng = np.random.default_rng(seed)
    for _ in range(n):
        if style == "easy":
            mask = random_blob_mask(rng, size)
            bg = rng.uniform(40, 200, size=3)
            fg = rng.uniform(40, 200, size=3)
            img = np.empty((size, size, 3), np.float32)
            img[:] = bg
            img[mask] = fg
            img += rng.normal(0, 12, img.shape)
        elif style == "hard":
            img, mask = _hard_scene(rng, size)
        else:
            raise ValueError(f"unknown synthetic style {style!r}")
        img = np.clip(img, 0, 255).astype(np.float32)
        yield img[None], mask.astype(np.int32)


def _int_grid(size: int):
    """Cached integer ``np.mgrid[0:size, 0:size]`` — one hard scene
    otherwise rebuilds ~10 size² mgrids (16 MB each at 1024 px) across its
    noise/blob calls. Kept integer so downstream float math is bit-identical
    to the uncached form (the committed checkpoints/tables depend on the
    seeded scene stream)."""
    global _GRID_CACHE
    cached = globals().get("_GRID_CACHE")
    if cached is None or cached[0] != size:
        g = np.mgrid[0:size, 0:size]
        _GRID_CACHE = (size, g[0], g[1])
    return _GRID_CACHE[1], _GRID_CACHE[2]


def _smooth_noise(rng: np.random.Generator, size: int, periods=(2, 5, 9)):
    """Low-frequency texture in [-1, 1]: a few random-phase sinusoid products
    (cheap, seeded, no scipy)."""
    iy, ix = _int_grid(size)
    yy, xx = iy / size, ix / size
    out = np.zeros((size, size), np.float32)
    for p in periods:
        ax, ay = rng.uniform(0, 2 * np.pi, 2)
        fx, fy = rng.uniform(0.6, 1.4, 2) * p
        out += np.sin(2 * np.pi * fx * xx + ax) * np.sin(2 * np.pi * fy * yy + ay)
    return out / len(periods)


def _blob_at(rng: np.random.Generator, size: int, cx0, cy0, scale=1.0,
             n_ellipses: int = 3):
    """Union of ellipses centered near (cx0, cy0)."""
    yy, xx = _int_grid(size)
    mask = np.zeros((size, size), bool)
    for _ in range(n_ellipses):
        cx = cx0 + rng.uniform(-0.10, 0.10) * size
        cy = cy0 + rng.uniform(-0.10, 0.10) * size
        a = rng.uniform(0.05, 0.16) * size * scale
        b = rng.uniform(0.05, 0.16) * size * scale
        th = rng.uniform(0, np.pi)
        x, y = xx - cx, yy - cy
        xr = x * np.cos(th) + y * np.sin(th)
        yr = -x * np.sin(th) + y * np.cos(th)
        mask |= (xr / max(a, 1e-6)) ** 2 + (yr / max(b, 1e-6)) ** 2 <= 1.0
    return mask


def _hard_scene(rng: np.random.Generator, size: int, _tries: int = 8):
    """Target instance + 1–3 distinctly-colored distractors on a textured
    gradient background; later objects occlude earlier ones (the GT excludes
    occluded target pixels, like overlapping SBD instances)."""
    # background: gradient + low-frequency texture. Amplitudes tuned so a
    # trained vit_tiny lands MID-RANGE (neither the easy scenes' 0.944
    # saturation nor an underfit floor — a first cut with 22/14-amplitude
    # texture and 3-6 objects left vit_tiny at 0.4 click5 / 0.07 click1,
    # which saturates NoC the other way).
    g0 = rng.uniform(60, 180, size=3)
    g1 = rng.uniform(60, 180, size=3)
    t = (_int_grid(size)[int(rng.integers(2))] / size)[..., None]
    img = (g0[None, None] * (1 - t) + g1[None, None] * t).astype(np.float32)
    for c in range(3):
        img[..., c] += 14.0 * _smooth_noise(rng, size)

    # objects: target first, then distractors drawn ON TOP (occluders).
    # Each object gets its OWN color with guaranteed contrast vs the mean
    # background — boundaries must be VISIBLE (an earlier same-color-family
    # variant made occluder boundaries undeterminable and the task partly
    # ill-posed: models memorized the train pool at 0.92 IoU while held-out
    # click IoU stalled at 0.21). Difficulty comes from clutter, texture,
    # the gradient background, and occlusion — not from invisibility.
    n_obj = int(rng.integers(2, 5))
    bg_mean = (g0 + g1) / 2
    target = None
    for i in range(n_obj):
        cx0, cy0 = rng.uniform(0.2 * size, 0.8 * size, 2)
        m = _blob_at(rng, size, cx0, cy0,
                     scale=1.0 if i == 0 else rng.uniform(0.5, 1.0))
        for _ in range(16):
            col = rng.uniform(25, 230, size=3)
            if np.linalg.norm(col - bg_mean) >= 75:
                break
        tex = 10.0 * _smooth_noise(rng, size, periods=(7, 13))
        for c in range(3):
            img[..., c] = np.where(m, col[c] + tex, img[..., c])
        if i == 0:
            target = m
        else:
            target = target & ~m  # occlusion: later objects cover the target
    img += rng.normal(0, 8, img.shape)
    # keep the target a real object: if occluders erased it, retry the scene
    # (bounded — seeded rng advances each try, so retries differ)
    if target.sum() < 0.003 * size * size and _tries > 0:
        return _hard_scene(rng, size, _tries - 1)
    return img, target
