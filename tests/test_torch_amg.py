"""Port parity of automatic mask generation (``utils/amg.py``,
``automatic_mask_generator.py``, ``cli/amg.py``) against the JAX package, on
the CPU.

The same seeded numpy inputs and the same weights (random vit_tiny from JAX's
PRNGKey(0) carried over by ``from_jax_params``, or the committed
``checkpoints/vit_tiny_synth``) go through both packages; the JAX generator
runs as its own tests run it (``attn_impl="xla"``). Annotations are matched by
point and crop box, then by nearest predicted IoU, and held to: the same
count, at most 0.1% of a matched mask's pixels different, bbox within 1 px,
predicted IoU within 1e-4, stability within 1e-3, and area equal to the
mask's sum (``AMG_TOL``). ``cli.amg --load-quantized`` of a JAX-written
GPTQ W4 g32 artifact is held to the same in both packages.

``tests/data/amg_crossval.json`` is the AMG golden that ``chip_smoke.py``
holds the card to: the JAX generator's annotations of ``vit_tiny_synth`` on
a seeded image in two configurations. Rewrite it with
``PYTHONPATH=. python tests/test_torch_amg.py --write`` (from the repository
root);
``test_golden_file_is_jax_output`` fails when it goes stale.
"""

import base64
import csv
import io
import json
import os
import pathlib
import sys
from contextlib import redirect_stderr, redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_quantization_tpu import native as jnative
from sam_quantization_tpu.automatic_mask_generator import (
    SamAutomaticMaskGenerator as JGenerator,
)
from sam_quantization_tpu.cli import amg as jcli
from sam_quantization_tpu.cli import quantize as jquantize
from sam_quantization_tpu.data.synthetic import synthetic_samples as jsynthetic
from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.models.configs import CONFIGS as JCONFIGS
from sam_quantization_tpu.train import checkpoint as jckpt
from sam_quantization_tpu.train import trainer as jtrainer
from sam_quantization_tpu.utils import amg as jamg
from sam_quantization_tpu_torch.automatic_mask_generator import (
    SamAutomaticMaskGenerator as TGenerator,
)
from sam_quantization_tpu_torch.cli import amg as tcli
from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.train import checkpoint as tckpt
from sam_quantization_tpu_torch.utils import amg as tamg

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "data" / "amg_crossval.json"
CKPT = REPO / "checkpoints" / "vit_tiny_synth"
# Two float32 stacks of the same math: a logit within rounding of the
# threshold may flip a pixel (one of a 96 x 128 mask is 8e-5 of it), and one
# flipped pixel moves a small mask's stability by a step of 1/lo.
AMG_TOL = {"pixels": 1e-3, "bbox": 1.0, "iou": 1e-4, "stability": 1e-3, "area": 0}
OFF = {"pred_iou_thresh": -1e9, "stability_score_thresh": 0.0}  # random weights: keep all
# The golden's two configurations (the JAX generator's arguments).
GOLDEN_CONFIGS = {
    "A_packed": {"points_per_side": 6, "points_per_batch": 16, **OFF,
                 "stability_score_offset": 0.05, "box_nms_thresh": 1.0},
    "B_crops": {"points_per_side": 4, "crop_n_layers": 1, "crop_nms_thresh": 1.0,
                "box_nms_thresh": 1.0, "min_mask_region_area": 20, **OFF},
}
GOLDEN_SEED, GOLDEN_SIZE, GOLDEN_HW = 5, 128, (96, 128)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def random_models():
    """vit_tiny from JAX's PRNGKey(0), the same weights in the port."""
    cfg = JCONFIGS["vit_tiny"]
    jm = jsam.init(jax.random.PRNGKey(0), cfg)
    sd = tbuild.from_jax_params(_to_np(jm.image_encoder), _to_np(jm.prompt_encoder),
                                _to_np(jm.mask_decoder), TCONFIGS["vit_tiny"])
    return jm, tbuild.load_state_dict(tsam.Sam(TCONFIGS["vit_tiny"], device="cpu"), sd)


def _jax_synth():
    cfg = JCONFIGS["vit_tiny"]
    template = jsam.init(jax.random.PRNGKey(0), cfg)
    opt = jtrainer.make_optimizer(jtrainer.TrainConfig()).init(template)
    jm, _, _ = jckpt.load_checkpoint(str(CKPT), template, opt, "best")
    return jax.tree_util.tree_map(jnp.asarray, jm)


def _port_synth():
    tm = tbuild.sam_model_registry["vit_tiny"](device="cpu")
    tckpt.load_weights(str(CKPT), tm, "best")
    return tm


def _image(seed=0, hw=(96, 80)):
    return (np.random.default_rng(seed).random((*hw, 3)) * 255).astype(np.uint8)


def _golden_image(synthetic=jsynthetic):
    img, _ = next(synthetic(1, GOLDEN_SIZE, seed=GOLDEN_SEED))
    return img[0, : GOLDEN_HW[0], : GOLDEN_HW[1]].astype(np.uint8)


def _assert_close(ref, got):
    gaps = tamg.annotation_gaps(ref, got)
    assert gaps["ref"] == gaps["got"] == gaps["matched"] > 0, gaps
    for key, tol in AMG_TOL.items():
        assert gaps[key] <= tol, (key, gaps)
    for ann in ref:
        assert tamg.annotation_mask(ann).sum() == ann["area"]
    return gaps


# ---------------------------------------------------------------------------
# utils/amg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,layers,scale", [(1, 0, 1), (4, 1, 1), (32, 2, 2), (7, 1, 2)])
def test_point_grids_match_jax(n, layers, scale):
    got = tamg.build_all_layer_point_grids(n, layers, scale)
    want = jamg.build_all_layer_point_grids(n, layers, scale)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("size,layers,ratio", [((96, 128), 1, 512 / 1500),
                                               ((1200, 1600), 2, 512 / 1500),
                                               ((37, 23), 1, 0.5), ((64, 64), 0, 0.3)])
def test_crop_boxes_match_jax(size, layers, ratio):
    assert tamg.generate_crop_boxes(size, layers, ratio) == \
        jamg.generate_crop_boxes(size, layers, ratio)


def test_uncrop_edge_and_xywh_match_jax():
    r = np.random.default_rng(1)
    boxes = r.integers(0, 60, (9, 4)).astype(np.float32)
    points = r.random((9, 2)) * 50
    masks = r.random((3, 20, 30)) > 0.5
    for crop in ([0, 0, 30, 20], [10, 5, 40, 25], [3, 0, 33, 20]):
        np.testing.assert_array_equal(tamg.uncrop_boxes_xyxy(boxes, crop),
                                      jamg.uncrop_boxes_xyxy(boxes, crop))
        np.testing.assert_array_equal(tamg.uncrop_points(points, crop),
                                      jamg.uncrop_points(points, crop))
        np.testing.assert_array_equal(tamg.uncrop_masks(masks, crop, 25, 40),
                                      jamg.uncrop_masks(masks, crop, 25, 40))
        np.testing.assert_array_equal(tamg.is_box_near_crop_edge(boxes, crop, [0, 0, 64, 64]),
                                      jamg.is_box_near_crop_edge(boxes, crop, [0, 0, 64, 64]))
    for box in boxes:
        np.testing.assert_array_equal(tamg.box_xyxy_to_xywh(box), jamg.box_xyxy_to_xywh(box))
    assert [b for b in tamg.batch_iterator(4, np.arange(10))][-1][0].tolist() == [8, 9]
    assert [b[0].tolist() for b in tamg.batch_iterator(4, np.arange(10))] == \
        [b[0].tolist() for b in jamg.batch_iterator(4, np.arange(10))]


@pytest.mark.parametrize("offset", [1.0, 0.05])
def test_stability_score_matches_jax(offset):
    logits = np.random.default_rng(2).normal(0, 2, (6, 33, 17)).astype(np.float32)
    logits[0] = -5  # empty at both thresholds
    got = tamg.calculate_stability_score(logits, 0.0, offset)
    want = jamg.calculate_stability_score(logits, 0.0, offset)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_batched_mask_to_box_matches_jax():
    r = np.random.default_rng(3)
    masks = r.random((2, 4, 21, 13)) > 0.97
    masks[0, 0] = False  # empty -> zeros
    masks[1, 1] = True
    got = tamg.batched_mask_to_box(masks)
    assert got.shape == (2, 4, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jamg.batched_mask_to_box(masks))
    np.testing.assert_array_equal(got[0, 0], 0)
    np.testing.assert_array_equal(tamg.batched_mask_to_box(np.zeros((0, 5, 5), bool)),
                                  jamg.batched_mask_to_box(np.zeros((0, 5, 5), bool)))


@pytest.mark.parametrize("mode", ["holes", "islands"])
@pytest.mark.parametrize("area", [1, 5, 30, 10_000])
def test_remove_small_regions_matches_jax(mode, area):
    r = np.random.default_rng(4)
    mask = r.random((40, 50)) > 0.6
    mask[5:25, 5:30] = True
    mask[10:12, 10:12] = False
    got, changed = tamg.remove_small_regions(mask, area, mode)
    want, jchanged = jamg.remove_small_regions(mask, area, mode)
    assert changed == jchanged
    np.testing.assert_array_equal(got, want)


def test_mask_data_filter_and_cat_match_jax():
    def build(mod):
        d = mod.MaskData(a=np.arange(6), b=[f"r{i}" for i in range(6)])
        d.cat(mod.MaskData(a=np.arange(6, 9), b=["x", "y", "z"]))
        d.filter(np.array([True, False, True, True, False, True, True, False, True]))
        d.filter(np.array([4, 0, 2]))
        return d["a"].tolist(), d["b"]

    assert build(tamg) == build(jamg) == ([6, 0, 3], ["x", "r0", "r3"])


def test_rle_and_nms_match_jax():
    r = np.random.default_rng(5)
    for h, w in ((1, 1), (7, 3), (37, 64)):
        for mask in (r.random((h, w)) > 0.5, np.ones((h, w), bool), np.zeros((h, w), bool)):
            rle = tamg.mask_to_rle(mask)
            assert rle == jamg.mask_to_rle(mask)
            np.testing.assert_array_equal(tamg.rle_to_mask(rle), mask)
            assert tamg.area_from_rle(rle) == jamg.area_from_rle(rle) == mask.sum()
    xy = r.random((40, 2)) * 80
    boxes = np.concatenate([xy, xy + r.random((40, 2)) * 40], 1).astype(np.float32)
    scores = r.random(40).astype(np.float32)
    for thr in (0.0, 0.3, 0.7, 1.0):
        np.testing.assert_array_equal(tamg.box_nms(boxes, scores, thr),
                                      jamg.box_nms(boxes, scores, thr))
    idxs = r.integers(0, 3, 40)
    np.testing.assert_array_equal(tamg.batched_nms(boxes, scores, idxs, 0.5),
                                  jamg.batched_nms(boxes, scores, idxs, 0.5))


@pytest.mark.parametrize("hw", [(13, 9), (96, 128), (1, 5), (16, 3)])
def test_packbits_masks_bit_exact_with_jax(hw):
    binm = np.random.default_rng(6).random((5, *hw)) > 0.5
    got = tamg.packbits_masks(torch.from_numpy(binm)).numpy()
    want = np.asarray(jamg.packbits_masks(jnp.asarray(binm)))
    assert got.shape == want.shape == (5, hw[1], (hw[0] + 7) // 8) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert [c for c in jnative.rle_encode_batch_packed(got, *hw)] == \
        [tamg.mask_to_rle(m)["counts"] for m in binm]


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

GENERATOR_CASES = {
    "packed": {"points_per_side": 4, "points_per_batch": 16, **OFF, "box_nms_thresh": 1.0},
    "crops_general": {"points_per_side": 4, "points_per_batch": 16, **OFF,
                      "crop_n_layers": 1, "crop_nms_thresh": 1.0, "box_nms_thresh": 1.0},
    "small_regions": {"points_per_side": 4, "points_per_batch": 16, **OFF,
                      "min_mask_region_area": 20},
    "rle": {"points_per_side": 4, "points_per_batch": 16, **OFF,
            "output_mode": "uncompressed_rle"},
}


@pytest.mark.parametrize("case", list(GENERATOR_CASES))
def test_generator_matches_jax(random_models, case):
    """As the JAX package's test_amg_generate_tiny: 96x80 image, 4x4 grid,
    batches of 16, thresholds off."""
    jm, tm = random_models
    kw = GENERATOR_CASES[case]
    img = _image()
    want = JGenerator(jm, attn_impl="xla", **kw).generate(img)
    got = TGenerator(tm, **kw).generate(img)
    _assert_close(want, got)
    for ann in got:
        seg = ann["segmentation"]
        if kw.get("output_mode") == "uncompressed_rle":
            assert isinstance(seg, dict) and seg["size"] == [96, 80]
        else:
            assert seg.shape == (96, 80) and seg.dtype == np.bool_


def test_packed_path_matches_general(random_models):
    """Mirrors test_amg_packed_fast_path_matches_general: byte-equal
    segmentations, equal bbox and area, stability within 1e-6 (float32
    quotient on the device, float64 on the host)."""
    _, tm = random_models
    img = _image()
    kw = GENERATOR_CASES["packed"]
    fast_gen = TGenerator(tm, **kw)
    general_gen = TGenerator(tm, **kw)
    general_gen.packed_fast_path = False
    fast, general = fast_gen.generate(img), general_gen.generate(img)
    assert len(general) == len(fast) == 48
    for g, f in zip(general, fast):
        assert (g["segmentation"] == f["segmentation"]).all()
        assert g["bbox"] == f["bbox"] and g["area"] == f["area"]
        assert g["predicted_iou"] == f["predicted_iou"]
        np.testing.assert_allclose(g["stability_score"], f["stability_score"], atol=1e-6)


def test_crop_layers_with_no_survivor_return_nothing():
    """JAX raises IndexError here (automatic_mask_generator.py:126, _box_area
    :319 on a 1-D empty array); the port returns no annotation. Input:
    vit_tiny_synth on the golden image at the default thresholds."""
    kw = {"crop_n_layers": 1, "min_mask_region_area": 20}
    img = _golden_image()
    with pytest.raises(IndexError):
        JGenerator(_jax_synth(), attn_impl="xla", **kw).generate(img)
    assert TGenerator(_port_synth(), **kw).generate(img) == []


def test_mesh_is_refused(random_models):
    with pytest.raises(NotImplementedError, match="Queue 1, item 7"):
        TGenerator(random_models[1], mesh=object())


# ---------------------------------------------------------------------------
# cli.amg
# ---------------------------------------------------------------------------

def _cli_flags(tmp_path, rle):
    return ["--model-type", "vit_tiny", "--points-per-side", "4", "--points-per-batch", "16",
            "--pred-iou-thresh=-1e9", "--stability-score-thresh", "0.0",
            "--box-nms-thresh", "1.0", "--platform", "cpu",
            *(["--convert-to-rle"] if rle else [])]


@pytest.mark.parametrize("rle", [False, True])
def test_cli_matches_jax(random_models, tmp_path, rle):
    """Both CLIs on the same .npy image and the same upstream-named .pth
    (the port's state dict): metadata.csv rows and .npy masks, or the
    --convert-to-rle JSON."""
    _, tm = random_models
    pth = tmp_path / "vit_tiny.pth"
    torch.save(tm.state_dict(), pth)
    np.save(tmp_path / "scene.npy", _image())
    outs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        out = tmp_path / name
        with redirect_stderr(io.StringIO()):
            assert main(["--input", str(tmp_path / "scene.npy"), "--output", str(out),
                         "--checkpoint", str(pth), *_cli_flags(tmp_path, rle)]) == 0
        outs[name] = out
    if rle:
        want, got = (json.loads((outs[k] / "scene.json").read_text()) for k in ("jax", "port"))
        _assert_close(want, got)
        return
    rows = {}
    for k in ("jax", "port"):
        with open(outs[k] / "scene" / "metadata.csv") as f:
            rows[k] = list(csv.DictReader(f))
    assert len(rows["jax"]) == len(rows["port"]) == 48

    def anns(k):
        return [{"segmentation": np.load(outs[k] / "scene" / f"{r['id']}.npy"),
                 "area": int(r["area"]),
                 "bbox": [float(r[f"bbox_{c}"]) for c in ("x0", "y0", "w", "h")],
                 "point_coords": [[float(r["point_input_x"]), float(r["point_input_y"])]],
                 "predicted_iou": float(r["predicted_iou"]),
                 "stability_score": float(r["stability_score"]),
                 "crop_box": [float(r[f"crop_box_{c}"]) for c in ("x0", "y0", "w", "h")]}
                for r in rows[k]]

    _assert_close(anns("jax"), anns("port"))


def test_cli_load_quantized_matches_jax(random_models, tmp_path):
    """``--load-quantized`` of a JAX ``cli.quantize`` GPTQ W4 g32 artifact of
    the random vit_tiny, ``--convert-to-rle``, thresholds off: both CLIs
    return the same annotations (48), within the golden's tolerances."""
    _, tm = random_models
    pth = tmp_path / "vit_tiny.pth"
    torch.save(tm.state_dict(), pth)
    np.save(tmp_path / "scene.npy", _image())
    art = tmp_path / "w4"
    with redirect_stdout(io.StringIO()), redirect_stderr(io.StringIO()):
        assert jquantize.main(["vit_tiny", "--checkpoint", str(pth), "--nsamples", "2",
                               "--wbits", "4", "--groupsize", "32", "--platform", "cpu",
                               "--save", str(art)]) == 0
    outs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        with redirect_stderr(io.StringIO()):
            assert main(["--input", str(tmp_path / "scene.npy"), "--output", str(tmp_path / name),
                         "--checkpoint", str(pth), "--load-quantized", str(art),
                         *_cli_flags(tmp_path, True)]) == 0
        outs[name] = json.loads((tmp_path / name / "scene.json").read_text())
    assert len(outs["jax"]) == len(outs["port"]) == 48
    _assert_close(outs["jax"], outs["port"])


# ---------------------------------------------------------------------------
# the golden
# ---------------------------------------------------------------------------

def _margins(ann, cfg):
    """Each kept value's distance from the threshold it passed; the edge
    margin is the box's least distance to a crop side inside the image, less
    the 20 px ``is_box_near_crop_edge`` tolerance (None for the full image)."""
    x, y, w, h = ann["bbox"]
    cx, cy, cw, ch = ann["crop_box"]
    H, W = GOLDEN_HW
    inner = [abs(v - e) for v, e, edge in ((x, cx, cx), (y, cy, cy), (x + w, cx + cw, W - cx - cw),
                                           (y + h, cy + ch, H - cy - ch)) if edge > 0]
    return {"predicted_iou": ann["predicted_iou"] - cfg.get("pred_iou_thresh", 0.88),
            "stability_score": ann["stability_score"] - cfg.get("stability_score_thresh", 0.95),
            "crop_edge": min(inner) - 20.0 if inner else None}


def golden() -> dict:
    """The JAX generator's annotations of vit_tiny_synth (best) on the golden
    image in both configurations, as the golden file holds them."""
    jm = _jax_synth()
    img = _golden_image()
    out = {"model": "vit_tiny checkpoints/vit_tiny_synth (best)",
           "image": {"source": f"synthetic_samples(1, {GOLDEN_SIZE}, seed={GOLDEN_SEED}), "
                               f"rows :{GOLDEN_HW[0]}, columns :{GOLDEN_HW[1]}, uint8",
                     "shape": list(img.shape),
                     "uint8_base64": base64.b64encode(img.tobytes()).decode()},
           "tolerances": AMG_TOL, "configs": GOLDEN_CONFIGS, "annotations": {}}
    for name, cfg in GOLDEN_CONFIGS.items():
        anns = JGenerator(jm, attn_impl="xla", output_mode="uncompressed_rle", **cfg).generate(img)
        out["annotations"][name] = [{**a, "margins": _margins(a, cfg)} for a in anns]
    return json.loads(json.dumps(out))


@pytest.fixture(scope="module")
def golden_file():
    return json.loads(GOLDEN.read_text())


def test_golden_file_is_jax_output(golden_file):
    assert golden() == golden_file
    assert {k: len(v) for k, v in golden_file["annotations"].items()} == \
        {"A_packed": 108, "B_crops": 48}


@pytest.mark.parametrize("name", list(GOLDEN_CONFIGS))
def test_port_matches_golden(golden_file, name):
    img = np.frombuffer(base64.b64decode(golden_file["image"]["uint8_base64"]),
                        np.uint8).reshape(golden_file["image"]["shape"]).copy()
    np.testing.assert_array_equal(img, _golden_image(synthetic_samples))
    got = TGenerator(_port_synth(), output_mode="uncompressed_rle",
                     **golden_file["configs"][name]).generate(img)
    _assert_close(golden_file["annotations"][name], got)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_amg.py --write")
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(GOLDEN.parent, exist_ok=True)
    GOLDEN.write_text(json.dumps(golden()) + "\n")
    print(f"wrote {GOLDEN}")
