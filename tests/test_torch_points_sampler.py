"""Port parity of the training-data helpers, on the CPU: ``data/points_sampler``
(``MultiPointSampler``, ``points_to_sam_prompts``, the EDT through each
package's ``native``) and ``data/augment``, against the JAX package.

Both draw from Python's ``random`` and numpy's global generator; each side
runs from the same seeds, so the clicks, resizes, flips and crops must be
the same. Sampled points, SAM prompts, masks, shapes and crop windows are
compared for equality; augmented images within atol 1e-3 on the [0, 255]
scale (the two bilinear resizes sum their taps in other float32 orders:
measured 2.2e-4). ``data.datasets.resize_nearest`` is held to
``jax.image.resize(..., "nearest")`` index for index.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sam_quantization_tpu.data import augment as jaug
from sam_quantization_tpu.data import points_sampler as jps
from sam_quantization_tpu_torch.data import augment as taug
from sam_quantization_tpu_torch.data import points_sampler as tps
from sam_quantization_tpu_torch.data.datasets import resize_nearest

IMAGE_ATOL = 1e-3


def _instances():
    inst = np.zeros((64, 80), np.int32)
    inst[10:30, 10:34] = 1
    inst[40:60, 40:70] = 2
    inst[5:15, 50:75] = 3
    return inst


def _seeded(seed, fn):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


SAMPLERS = {
    "default": dict(max_num_points=6),
    "first_click_center": dict(max_num_points=6, first_click_center=True),
    "merge": dict(max_num_points=8, merge_objects_prob=1.0, max_num_merged_objects=3),
    "no_erode_border_only": dict(max_num_points=4, positive_erode_prob=0.0,
                                 negative_bg_prob=0.0, negative_other_prob=0.0,
                                 negative_border_prob=1.0),
}


@pytest.mark.parametrize("kind", sorted(SAMPLERS))
@pytest.mark.parametrize("ids", [[1, 2, 3], [2]])
def test_multi_point_sampler_matches_jax(kind, ids):
    """Eight seeds: the selected mask, the sampled (row, col, index) triples
    and their SAM prompts equal JAX's."""
    inst = _instances()
    for seed in range(8):
        out = []
        for mod in (jps, tps):
            def run(mod=mod):
                s = mod.MultiPointSampler(**SAMPLERS[kind])
                s.sample_object(inst, ids)
                pts = s.sample_points()
                return s.selected_mask, pts, mod.points_to_sam_prompts(pts, 12)
            out.append(_seeded(seed, run))
        (jm, jpts, (jc, jl)), (tm, tpts, (tc, tl)) = out
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(tpts, jpts)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tl, jl)
        assert tpts.shape == (2 * SAMPLERS[kind]["max_num_points"], 3)


def test_sampler_without_objects_fails_as_jax():
    """With no object ids both packages fail alike in ``sample_points``: the
    positive side samples from an empty strategy list (numpy's ``choice``
    of nothing), a fault of the JAX module the port keeps."""
    for mod in (jps, tps):
        s = mod.MultiPointSampler(max_num_points=4)
        s.sample_object(_instances(), [])
        assert not s.selected_mask.any()
        with pytest.raises(ValueError, match="greater than 0"):
            _seeded(0, s.sample_points)


@pytest.mark.parametrize("k", [1.7, 0.0])
def test_point_candidates_match_jax(k):
    """The centre-biased candidates: the EDT threshold (k > 0) and the
    EDT-weighted draw (k = 0)."""
    mask = _instances() == 2
    for seed in range(4):
        want = _seeded(seed, lambda: jps.get_point_candidates(mask, k=k))
        got = _seeded(seed, lambda: tps.get_point_candidates(mask, k=k))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("crop", [(40, 40), (90, 90)])
def test_augment_matches_jax(crop):
    """The default stack's transforms (resize, flip, crop with padding when
    the image is smaller, brightness / contrast) from eight seeds."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (50, 70, 3)).astype(np.float32)
    mask = (rng.random((50, 70)) > 0.5).astype(np.int32)
    for seed in range(8):
        out = []
        for mod in (jaug, taug):
            aug = mod.Compose([mod.UniformRandomResize((0.75, 1.25)), mod.HorizontalFlip(),
                               mod.RandomCrop(crop), mod.RandomBrightnessContrast()])
            out.append(_seeded(seed, lambda aug=aug: aug(img, mask)))
        (ji, jm), (ti, tm) = out
        assert ti.shape == ji.shape and ti.dtype == ji.dtype and tm.dtype == jm.dtype
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_allclose(ti, ji, atol=IMAGE_ATOL, rtol=0)
    assert len(taug.default_train_augmentor((32, 32)).transforms) == 4


def test_resize_nearest_matches_jax():
    """Indices of ``jax.image.resize(..., "nearest")`` at sizes where the
    float32 product-first form rounds the other way (30 -> 25 among them)."""
    for m, n in [(30, 25), (30, 29), (50, 61), (64, 48), (37, 100), (128, 96), (75, 113)]:
        a = np.arange(m, dtype=np.float32)[:, None] * np.ones((1, 2), np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(a), (n, 2), "nearest"))
        np.testing.assert_array_equal(resize_nearest(a, (n, 2)), want, err_msg=f"{m}->{n}")
