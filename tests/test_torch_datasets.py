"""The port's eval datasets (``data/datasets.py``) and dataset-path config
(``utils/config.py``) against the JAX package's, on tiny copies of each
benchmark's folder layout written to ``tmp_path``: the same samples, masks
and ids from both."""

import json

import numpy as np
import pytest
from scipy.io import savemat

from sam_quantization_tpu import native as jnative
from sam_quantization_tpu.data import datasets as jds
from sam_quantization_tpu.utils import config as jconfig
from sam_quantization_tpu_torch.data import datasets as tds
from sam_quantization_tpu_torch.utils import config as tconfig

PIL = pytest.importorskip("PIL.Image")


def _write_img(path, arr, mode=None):
    img = PIL.fromarray(arr.astype(np.uint8), mode=mode)
    if mode == "P":
        img.putpalette([c for i in range(256) for c in (i, i, i)])
    img.save(str(path))


def _rgb(h=24, w=32, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)


def _circle(h=24, w=32, fg=255, ring=None, r2=36):
    yy, xx = np.mgrid[:h, :w]
    d = (yy - h // 2) ** 2 + (xx - w // 2) ** 2
    m = np.zeros((h, w), np.uint8)
    m[d < r2] = fg
    if ring is not None:
        m[(d >= r2) & (d < 2 * r2)] = ring
    return m


def _same_items(t, j, n):
    titems, jitems = list(t.eval_items()), list(j.eval_items())
    assert len(titems) == len(jitems) == n
    for (ti, tg, ts), (ji, jg, js) in zip(titems, jitems):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tg, jg)
        assert ts == js and tg.dtype == jg.dtype
    return titems


def _folder(root, images, masks, names, mask_fn):
    (root / images).mkdir()
    (root / masks).mkdir()
    for i, n in enumerate(names):
        _write_img(root / images / f"{n}.png", _rgb(seed=i))
        _write_img(root / masks / f"{n}.png", mask_fn(i))


@pytest.mark.parametrize("name,images,masks,n", [
    ("GrabCutDataset", "data_GT", "boundary_GT", 1),
    ("BerkeleyDataset", "images", "masks", 2),
    ("DavisDataset", "img", "gt", 2),
    ("CocoMvalDataset", "img", "gt", 2),
    ("ImageMaskDataset", "images", "masks", 3),
])
def test_folder_layouts_match_jax(tmp_path, name, images, masks, n):
    """GrabCut's 128 ring maps to background; the others threshold at 127."""
    _folder(tmp_path, images, masks, [f"s{i}" for i in range(n)],
            lambda i: _circle(ring=128, r2=20 + 10 * i))
    items = _same_items(getattr(tds, name)(str(tmp_path)),
                        getattr(jds, name)(str(tmp_path)), n)
    assert items[0][0].shape == (24, 32, 3) and items[0][1].max() == 1


def test_pascal_voc_layout_matches_jax(tmp_path):
    (tmp_path / "JPEGImages").mkdir()
    (tmp_path / "SegmentationObject").mkdir()
    sets = tmp_path / "ImageSets" / "Segmentation"
    sets.mkdir(parents=True)
    _write_img(tmp_path / "JPEGImages" / "v.jpg", _rgb(seed=3))
    inst = np.zeros((24, 32), np.uint8)
    inst[2:8, 2:8] = 1
    inst[10:20, 10:20] = 2
    inst[0, :] = 255  # VOC ignore boundary
    _write_img(tmp_path / "SegmentationObject" / "v.png", inst, mode="P")
    (sets / "val.txt").write_text("v\n")
    items = _same_items(tds.PascalVocDataset(str(tmp_path)), jds.PascalVocDataset(str(tmp_path)), 2)
    assert sorted(int(gt.sum()) for _, gt, _ in items) == [36, 100]


def test_sbd_layout_and_buggy_mask_filter_match_jax(tmp_path):
    """SBD .mat instances: an instance whose area / bbox area falls below
    the threshold (a thin diagonal) is dropped by both."""
    (tmp_path / "img").mkdir()
    (tmp_path / "inst").mkdir()
    for i, n in enumerate(("a", "b")):
        _write_img(tmp_path / "img" / f"{n}.jpg", _rgb(seed=i))
        inst = np.zeros((24, 32), np.uint8)
        inst[2:9, 3:12] = 1
        inst[12:22, 14:30] = 2
        np.fill_diagonal(inst[:, 5:], 3)
        struct = np.empty((1, 1), dtype=[("Segmentation", "O")])
        struct[0, 0]["Segmentation"] = inst
        savemat(str(tmp_path / "inst" / f"{n}.mat"), {"GTinst": struct})
    (tmp_path / "val.txt").write_text("a\nb\n")
    t, j = tds.SBDDataset(str(tmp_path)), jds.SBDDataset(str(tmp_path))
    _same_items(t, j, 4)
    assert t.get_sample(0).objects_ids == [1, 2]


def test_sa1b_layout_matches_jax(tmp_path):
    """SA-1B json sidecars with COCO uncompressed RLE, decoded by each
    package's native binding."""
    masks = [_circle(fg=1, r2=30), np.zeros((24, 32), np.uint8)]
    masks[1][1:5, 20:30] = 1
    _write_img(tmp_path / "sa_1.jpg", _rgb(seed=5))
    anns = [{"segmentation": {"size": [24, 32], "counts": jnative.rle_encode(m)}}
            for m in masks]
    (tmp_path / "sa_1.json").write_text(json.dumps({"annotations": anns}))
    t, j = tds.SA1BDataset(str(tmp_path)), jds.SA1BDataset(str(tmp_path))
    _same_items(t, j, 2)
    for a, b in zip(t.bbox_prompts(0), j.bbox_prompts(0)):
        np.testing.assert_array_equal(a, b)


def test_get_dataset_and_config_match_jax(tmp_path, monkeypatch):
    """Named datasets resolve from config.yml (environment variables
    expanded) or the explicit path; unknown names return None."""
    _folder(tmp_path, "img", "gt", ["x"], lambda i: _circle())
    (tmp_path / "train.txt").write_text("")
    (tmp_path / "val.txt").write_text("")
    monkeypatch.setenv("SAMQ_DATA", str(tmp_path))
    cfg_file = tmp_path / "config.yml"
    cfg_file.write_text("DAVIS_PATH: $SAMQ_DATA\nSBD_PATH: '$SAMQ_DATA'  # comment\n")
    tcfg, jcfg = tconfig.load_config(str(cfg_file)), jconfig.load_config(str(cfg_file))
    assert tcfg == jcfg and tcfg["DAVIS_PATH"] == str(tmp_path)
    assert tconfig.dataset_path(tcfg, "davis") == str(tmp_path)
    with pytest.raises(KeyError):
        tconfig.dataset_path(tcfg, "nope")
    assert isinstance(tds.get_dataset("DAVIS", cfg=tcfg), tds.DavisDataset)
    assert tds.get_dataset("SBD_train", cfg=tcfg).split == "train"
    assert isinstance(tds.get_dataset("COCO_MVal", str(tmp_path)), tds.CocoMvalDataset)
    assert tds.get_dataset("NotABenchmark", str(tmp_path)) is None
    _same_items(tds.get_dataset("DAVIS", cfg=tcfg), jds.get_dataset("DAVIS", cfg=jcfg), 1)


@pytest.mark.parametrize("n,shards", [(10, 3), (7, 7), (5, 8)])
def test_shard_indices_match_jax(n, shards):
    for shuffle in (True, False):
        got = [tds.shard_indices(n, shards, s, seed=3, shuffle=shuffle) for s in range(shards)]
        assert got == [jds.shard_indices(n, shards, s, seed=3, shuffle=shuffle)
                       for s in range(shards)]
        assert len({len(g) for g in got}) == 1
