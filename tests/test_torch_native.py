"""The port's native host ops (``sam_quantization_tpu_torch/native.py``)
against scipy, the JAX package's binding of the same C++ and its numpy
versions, on seeded masks and boxes."""

import shutil

import numpy as np
import pytest
from scipy import ndimage

from sam_quantization_tpu import native as jnative
from sam_quantization_tpu.utils import amg as jamg
from sam_quantization_tpu_torch import native


@pytest.fixture
def no_lib(monkeypatch):
    """The port's entry points on their numpy / scipy versions."""
    monkeypatch.setattr(native, "get_lib", lambda: None)


def _masks(seed, n=5, h=61, w=47):
    """Blobs, an empty and a full mask, and one of noise."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    blobs = [((yy - r.integers(h)) ** 2 + (xx - r.integers(w)) ** 2
              < r.integers(3, max(h, w) // 2) ** 2) for _ in range(n)]
    return np.stack(blobs + [np.zeros((h, w), bool), np.ones((h, w), bool),
                             r.random((h, w)) > 0.5])


def test_library_builds_and_loads():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the port runs its numpy versions")
    lib = native.get_lib()
    assert lib is not None and native.library_path().exists()
    assert native.library_path().name.startswith("libsamq_host_runtime-")


@pytest.mark.parametrize("shape", [(64, 80), (33, 17), (1, 9), (128, 128)])
def test_edt_matches_scipy_and_jax_binding(shape):
    """float32 from the library, equal to the JAX binding's bit for bit and
    to scipy's float64 within float32 rounding. A mask with no zero (which
    the Clicker's zero border rules out) has no distance to one: the
    library reads 1e10 there, as the JAX binding does."""
    r = np.random.default_rng(sum(shape))
    for mask in (r.random(shape) > 0.3, np.pad(r.random(shape) > 0.05, 1),
                 np.zeros(shape, bool), np.ones(shape, bool)):
        got = native.distance_transform_edt(mask)
        assert got.dtype == np.float32 and got.shape == mask.shape
        np.testing.assert_array_equal(got, jnative.distance_transform_edt(mask))
        if mask.all():
            assert (got == np.float32(1e10)).all()
        else:
            want = ndimage.distance_transform_edt(mask)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_edt_fallback_is_scipy(no_lib):
    mask = np.random.default_rng(3).random((40, 30)) > 0.4
    got = native.distance_transform_edt(mask)
    np.testing.assert_array_equal(got, ndimage.distance_transform_edt(mask))


@pytest.mark.parametrize("fallback", [False, True], ids=["library", "numpy"])
def test_rle_roundtrip_matches_jax(fallback, monkeypatch):
    if fallback:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    for mask in _masks(1):
        counts = native.rle_encode(mask)
        assert counts == jnative.rle_encode(mask) == jamg.mask_to_rle(mask)["counts"]
        back = native.rle_decode(counts, *mask.shape)
        assert back.dtype == np.bool_
        np.testing.assert_array_equal(back, mask)
        np.testing.assert_array_equal(back, jnative.rle_decode(counts, *mask.shape))
        assert native.rle_area(counts) == int(mask.sum()) == jamg.area_from_rle(
            {"counts": counts})


@pytest.mark.parametrize("fallback", [False, True], ids=["library", "numpy"])
def test_rle_batch_and_packed_match_jax(fallback, monkeypatch):
    """Batched and column-bit-packed encodes equal the single-mask encode
    and the JAX binding's, also for values other than 0/1."""
    if fallback:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    for h, w in ((61, 47), (8, 8), (100, 37)):
        masks = _masks(h * w, h=h, w=w)
        got = native.rle_encode_batch(masks.astype(np.uint8) * 7)
        assert got == jnative.rle_encode_batch(masks.astype(np.uint8))
        assert got == [native.rle_encode(m) for m in masks]
        packed = np.packbits(masks.transpose(0, 2, 1), axis=-1, bitorder="little")
        assert packed.shape == (len(masks), w, (h + 7) // 8)
        assert native.rle_encode_batch_packed(packed, h, w) == got
        assert jnative.rle_encode_batch_packed(packed, h, w) == got


def test_rle_batch_overflow_reencodes():
    """A mask of more runs than the batched capacity is encoded again alone."""
    r = np.random.RandomState(7)
    masks = np.zeros((3, 300, 200), np.uint8)
    masks[1] = (r.rand(300, 200) > 0.5) * 3
    masks[2, 100:200, 50:80] = 1
    got = native.rle_encode_batch(masks)
    assert len(got[1]) > native.RLE_CAP
    assert got == jnative.rle_encode_batch(masks)
    packed = np.packbits(masks.transpose(0, 2, 1) != 0, axis=-1, bitorder="little")
    assert native.rle_encode_batch_packed(packed, 300, 200) == got


def test_rle_rejects_bad_input():
    with pytest.raises(ValueError):
        native.rle_encode_batch(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        native.rle_encode_batch_packed(np.zeros((1, 4, 3), np.uint8), 8, 4)


@pytest.mark.parametrize("fallback", [False, True], ids=["library", "numpy"])
def test_box_nms_matches_jax(fallback, monkeypatch):
    if fallback:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    r = np.random.default_rng(5)
    n = 200
    boxes = r.uniform(0, 100, size=(n, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + r.uniform(5, 40, size=(n, 2))
    scores = r.random(n).astype(np.float32)
    for thr in (0.3, 0.5, 0.9):
        keep = native.box_nms(boxes, scores, thr)
        np.testing.assert_array_equal(keep, jnative.box_nms(boxes, scores, thr))
        np.testing.assert_array_equal(np.sort(keep), np.sort(jamg.box_nms(boxes, scores, thr)))
    assert len(native.box_nms(boxes[:0], scores[:0], 0.5)) == 0
