"""Visualization overlays (masks, points, boxes).

The port's copy of ``sam_quantization_tpu/utils/vis.py`` (ref
utils/utils.py:5-130 and the notebooks' matplotlib helpers). Two tiers:
numpy blending that returns arrays, and matplotlib axis helpers mirroring
the reference's ``show_*`` API (matplotlib is imported only by them). Every
function also takes CPU or CUDA tensors, which it copies to host numpy.
"""

from __future__ import annotations

import numpy as np


def _host(x):
    """A torch tensor (on any device) as a numpy array; anything else as it is."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return x


def blend_mask(image, mask, color=(30, 144, 255), alpha: float = 0.6) -> np.ndarray:
    """Alpha-blend a binary mask onto an (H, W, 3) uint8 image."""
    out = _host(image).astype(np.float32).copy()
    m = _host(mask).astype(bool)
    out[m] = (1 - alpha) * out[m] + alpha * np.asarray(color, np.float32)
    return out.astype(np.uint8)


def draw_points(image, coords, labels, radius: int = 5) -> np.ndarray:
    """Draw positive (green) / negative (red) click markers. coords: (N, 2) xy."""
    out = _host(image).copy()
    h, w = out.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    for (x, y), lab in zip(_host(coords), _host(labels)):
        if lab < 0:
            continue
        color = (0, 200, 0) if lab >= 1 else (220, 0, 0)
        circ = (yy - y) ** 2 + (xx - x) ** 2 <= radius**2
        out[circ] = color
    return out


def draw_box(image, box, color=(255, 200, 0), thickness: int = 2) -> np.ndarray:
    out = _host(image).copy()
    x0, y0, x1, y1 = [int(v) for v in _host(box)]
    out[y0 : y0 + thickness, x0:x1] = color
    out[y1 - thickness : y1, x0:x1] = color
    out[y0:y1, x0 : x0 + thickness] = color
    out[y0:y1, x1 - thickness : x1] = color
    return out


# -- matplotlib tier (API parity with the reference notebooks) --------------


def show_mask(mask, ax, random_color=False):
    if random_color:
        color = np.concatenate([np.random.random(3), np.array([0.6])], axis=0)
    else:
        color = np.array([30 / 255, 144 / 255, 255 / 255, 0.6])
    mask = _host(mask)
    h, w = mask.shape[-2:]
    mask_image = mask.reshape(h, w, 1) * color.reshape(1, 1, -1)
    ax.imshow(mask_image)


def show_points(coords, labels, ax, marker_size=375):
    coords, labels = _host(coords), _host(labels)
    pos = coords[labels == 1]
    neg = coords[labels == 0]
    ax.scatter(pos[:, 0], pos[:, 1], color="green", marker="*", s=marker_size,
               edgecolor="white", linewidth=1.25)
    ax.scatter(neg[:, 0], neg[:, 1], color="red", marker="*", s=marker_size,
               edgecolor="white", linewidth=1.25)


def show_box(box, ax):
    import matplotlib.patches as patches

    x0, y0, x1, y1 = _host(box)[:4]
    ax.add_patch(
        patches.Rectangle((x0, y0), x1 - x0, y1 - y0, edgecolor="green",
                          facecolor=(0, 0, 0, 0), lw=2)
    )


def show_anns(anns, ax):
    """AMG annotation overlay (ref notebook helper)."""
    if len(anns) == 0:
        return
    sorted_anns = sorted(anns, key=lambda a: a["area"], reverse=True)
    ax.set_autoscale_on(False)
    for ann in sorted_anns:
        m = _host(ann["segmentation"])
        color_mask = np.concatenate([np.random.random(3), [0.35]])
        img = np.ones((*m.shape, 4))
        img[..., :4] = color_mask
        img[~m] = 0
        ax.imshow(img)
