"""Port parity of the click-loop evaluation path, on the CPU: metrics,
clicker, ``preprocess_for_eval``, ``click_loop_eval`` / ``noc_eval``, the
main-path gate against CROSSVAL.json, and the ``cli.evaluate`` /
``cli.infer --eval`` entry points.

The same numpy inputs (seeded masks, the committed
``checkpoints/vit_tiny_synth`` weights, seeded synthetic scenes) go through
the JAX package and the port. Tolerances are stated where they are used.
"""

import copy
import io
import json
import pathlib
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_quantization_tpu.cli import evaluate as jevaluate
from sam_quantization_tpu.cli import infer as jinfer
from sam_quantization_tpu.data import datasets as jdatasets
from sam_quantization_tpu.evaluation import click_eval as jce
from sam_quantization_tpu.evaluation import clicker as jclicker
from sam_quantization_tpu.evaluation import metrics as jmetrics
from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.models.configs import CONFIGS as JCONFIGS
from sam_quantization_tpu.train import checkpoint as jckpt
from sam_quantization_tpu.train import trainer as jtrainer
from sam_quantization_tpu_torch.cli import evaluate as tevaluate
from sam_quantization_tpu_torch.cli import infer as tinfer
from sam_quantization_tpu_torch.data import datasets as tdatasets
from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
from sam_quantization_tpu_torch.evaluation import click_eval as tce
from sam_quantization_tpu_torch.evaluation import clicker as tclicker
from sam_quantization_tpu_torch.evaluation import metrics as tmetrics
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.quant import artifacts as tart
from sam_quantization_tpu_torch.quant import sequential as tseq
from sam_quantization_tpu_torch.train import checkpoint as tckpt

REPO = pathlib.Path(__file__).resolve().parents[1]
CKPT = REPO / "checkpoints" / "vit_tiny_synth"
# The per-click IoU of two float32 stacks: a pixel whose logit is within
# float32 noise of 0 may flip; one flipped pixel of a 128 x 128 scene moves
# an IoU by about 1e-4.
IOU_TOL = 1e-3


@pytest.fixture(scope="module")
def models():
    """vit_tiny_synth (best) in both packages, each loaded by its own code."""
    cfg = JCONFIGS["vit_tiny"]
    template = jsam.init(jax.random.PRNGKey(0), cfg)
    opt_t = jtrainer.make_optimizer(jtrainer.TrainConfig()).init(template)
    jmodel, _, _ = jckpt.load_checkpoint(str(CKPT), template, opt_t, "best")
    jmodel = jax.tree_util.tree_map(jnp.asarray, jmodel)
    tmodel = tbuild.sam_model_registry["vit_tiny"](device="cpu")
    assert tckpt.load_weights(str(CKPT), tmodel, "best") == 11000
    return jmodel, tmodel


def _scenes(n, seed=9999):
    """Seeded scenes at 128, normalised once in numpy (as
    tools/cross_validate_harness.py builds CROSSVAL.json's)."""
    cfg = JCONFIGS["vit_tiny"]
    mean = np.asarray(cfg.pixel_mean, np.float32)
    std = np.asarray(cfg.pixel_std, np.float32)
    return [(((img - mean) / std).astype(np.float32), gt)
            for img, gt in synthetic_samples(n, 128, seed=seed)]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_get_iou_matches_jax():
    r = np.random.default_rng(0)
    for i in range(20):
        gt = r.integers(-1 if i % 2 else 0, 2, (37, 29))
        pred = r.random((37, 29)) > r.random()
        for ignore in (-1, 0, 5):
            assert tmetrics.get_iou(gt, pred, ignore) == jmetrics.get_iou(gt, pred, ignore)
    empty = np.zeros((4, 4), np.int32)
    assert tmetrics.get_iou(empty, empty.astype(bool)) == jmetrics.get_iou(empty, empty) == 1.0


def test_noc_metric_table_and_meter_match_jax():
    r = np.random.default_rng(1)
    for max_clicks in (3, 20):
        all_ious = [np.sort(r.random(r.integers(1, max_clicks + 1))) for _ in range(9)]
        for thrs in ((0.8, 0.85, 0.9), (0.5,)):
            got = tmetrics.compute_noc_metric(all_ious, thrs, max_clicks)
            assert got == jmetrics.compute_noc_metric(all_ious, thrs, max_clicks)
        noc, over = got
        table = tmetrics.results_table(noc, over, "synthetic", 0.25, 3.5, 9, thrs, max_clicks)
        assert table == jmetrics.results_table(noc, over, "synthetic", 0.25, 3.5, 9, thrs,
                                               max_clicks)
    tm, jm = tmetrics.AverageMeter("iou"), jmetrics.AverageMeter("iou")
    for v, n in ((0.5, 1), (0.25, 3)):
        tm.update(v, n)
        jm.update(v, n)
    assert (tm.avg, str(tm)) == (jm.avg, str(jm))


# ---------------------------------------------------------------------------
# clicker
# ---------------------------------------------------------------------------

def _blob_scenes(n, size=64, seed=2):
    return [gt for _, gt in synthetic_samples(n, size, seed=seed)]


def test_next_random_click_matches_jax():
    """The same seed gives the same click sequence: FN, FP, and perfect
    masks, the RNG stepping as JAX's does."""
    r = np.random.default_rng(3)
    trng, jrng = np.random.default_rng(42), np.random.default_rng(42)
    for gt in _blob_scenes(4):
        for pred in (np.zeros_like(gt), gt.copy(), np.roll(gt, 5, axis=1),
                     gt | (r.random(gt.shape) > 0.9)):
            assert tclicker.next_random_click(pred, gt, trng) == \
                jclicker.next_random_click(pred, gt, jrng)
    empty = np.zeros((8, 8), np.int32)
    assert tclicker.next_random_click(empty, empty, trng) == \
        jclicker.next_random_click(empty, empty, jrng)


@pytest.mark.parametrize("case", ["plain", "ignore", "no_padding", "init_clicks"])
def test_clicker_sequence_matches_jax(case):
    """Distance-transform clicks over a loop whose prediction grows from the
    clicks: the same sequence as JAX's Clicker, with an ignore region, with
    padding off, and from initial clicks (which fill the not-clicked map)."""
    for gt in _blob_scenes(3, seed=4):
        gt = gt.astype(np.int32)
        if case == "ignore":
            gt[:, :9] = -1
        init = None
        if case == "init_clicks":
            ys, xs = np.nonzero(gt == 1)
            init = [(True, (int(ys[0]), int(xs[0]))), (False, (0, 0))]
        clickers = []
        for mod in (tclicker, jclicker):
            ic = None if init is None else [mod.Click(is_positive=p, coords=c) for p, c in init]
            clickers.append(mod.Clicker(gt_mask=gt, init_clicks=ic))
        pred = np.zeros(gt.shape, bool)
        yy, xx = np.mgrid[: gt.shape[0], : gt.shape[1]]
        for _ in range(6):
            if case == "no_padding":
                clicks = [c._get_next_click(pred, padding=False) for c in clickers]
                for c, k in zip(clickers, clicks):
                    c.add_click(k)
            else:
                for c in clickers:
                    c.make_next_click(pred)
            t, j = (c.get_clicks()[-1] for c in clickers)
            assert (t.is_positive, t.coords, t.indx) == (j.is_positive, j.coords, j.indx)
            disc = (yy - t.coords[0]) ** 2 + (xx - t.coords[1]) ** 2 < 49
            pred = pred | disc if t.is_positive else pred & ~disc
        tc, jc = clickers
        assert (tc.num_pos_clicks, tc.num_neg_clicks, len(tc)) == \
            (jc.num_pos_clicks, jc.num_neg_clicks, len(jc))
        np.testing.assert_array_equal(tc.not_clicked_map, jc.not_clicked_map)
        assert [c.coords for c in tc.get_clicks(2)] == [c.coords for c in jc.get_clicks(2)]


# ---------------------------------------------------------------------------
# preprocess_for_eval
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,size", [((375, 500), 1024), ((333, 517), 128), ((500, 375), 1024),
                                     ((1000, 600), 128), ((90, 61), 128), ((128, 128), 128),
                                     ((600, 900), 1024)])
def test_preprocess_for_eval_matches_jax(hw, size):
    """The gt bit for bit (nearest with half-pixel centres, at sizes that do
    not divide); the image within bilinear rounding (float32, values in
    [0, 255]: 1e-3)."""
    r = np.random.default_rng(hw[0] * hw[1])
    image = r.integers(0, 256, (*hw, 3), dtype=np.uint8)
    yy, xx = np.mgrid[: hw[0], : hw[1]]
    gt = (((yy - hw[0] / 2) ** 2 + (xx - hw[1] / 3) ** 2 < (min(hw) / 3) ** 2)
          | (r.random(hw) > 0.97)).astype(np.int32)
    timg, tgt = tdatasets.preprocess_for_eval(image, gt, size)
    jimg, jgt = jdatasets.preprocess_for_eval(image, gt, size)
    assert tgt.dtype == jgt.dtype == np.int32 and tgt.shape == (size, size)
    np.testing.assert_array_equal(tgt, jgt)
    assert timg.shape == jimg.shape == (1, size, size, 3) and timg.dtype == np.float32
    np.testing.assert_allclose(timg, jimg, atol=1e-3, rtol=0)


def test_resize_nearest_index_math_matches_jax():
    """Sizes where (i + 0.5) * in / out lands on an integer: the product is
    taken first, as JAX takes it, so no index moves by the rounding of in / out."""
    for m, n in ((900, 600), (600, 900), (7, 3), (3, 7), (1000, 1024), (517, 333)):
        x = np.arange(m, dtype=np.float32)[:, None] * np.ones((1, 2), np.float32)
        got = tdatasets.resize_nearest(x, (n, 2))
        want = np.asarray(jax.image.resize(jnp.asarray(x), (n, 2), "nearest"))
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# click loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["literal", "slots"])
def test_click_loop_and_noc_match_jax(models, layout):
    """3 scenes x 3 clicks: the same clicks as JAX's loop, per-click IoU
    within IOU_TOL, and the same NoC."""
    jmodel, tmodel = models
    scenes = _scenes(3)
    kw = dict(num_clicks=3, img_size=128, seed=123, point_layout=layout)
    ref = jce.click_loop_eval(*jce.make_sam_backend(jmodel), scenes, **kw)
    got = tce.click_loop_eval(*tce.make_sam_backend(tmodel), scenes, record_low_res=True, **kw)
    assert got.clicks == ref.clicks
    np.testing.assert_allclose(got.per_sample_ious, ref.per_sample_ious, atol=IOU_TOL, rtol=0)
    assert len(got.low_res) == 3 and got.low_res[0][0].shape == (1, 1, 32, 32)
    assert 0 <= got.click1 <= 1 and got.final == got.mean_ious[-1]
    # replaying the recorded clicks gives the same result
    again = tce.click_loop_eval(*tce.make_sam_backend(tmodel), scenes,
                                clicks_override=got.clicks, **kw)
    assert again.per_sample_ious == got.per_sample_ious
    kw = dict(max_clicks=3, img_size=128, point_layout=layout)
    jnoc = jce.noc_eval(*jce.make_sam_backend(jmodel), scenes, **kw)
    tnoc = tce.noc_eval(*tce.make_sam_backend(tmodel), scenes, **kw)
    assert tnoc[:2] == jnoc[:2]


def test_click_loop_rejects_unknown_layout(models):
    with pytest.raises(ValueError, match="point_layout"):
        tce.click_loop_eval(*tce.make_sam_backend(models[1]), _scenes(1), img_size=128,
                            point_layout="padded")


def test_main_path_gate_matches_crossval(models):
    """The North star's main-path gate on the CPU: 24 scenes x 5 clicks,
    click seed 123, literal layout, per-click mean IoU within 1e-3 of the
    committed CROSSVAL.json ``jax_mean_ious``."""
    want = json.loads((REPO / "CROSSVAL.json").read_text())
    assert want["samples"] == 24 and want["num_clicks"] == 5
    res = tce.click_loop_eval(*tce.make_sam_backend(models[1]), _scenes(24), num_clicks=5,
                              img_size=128, seed=123)
    np.testing.assert_allclose(res.mean_ious, want["jax_mean_ious"], atol=1e-3, rtol=0)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pth(models, tmp_path_factory):
    """vit_tiny_synth as an upstream-named .pth, which both packages' CLIs load."""
    path = tmp_path_factory.mktemp("pth") / "vit_tiny_synth.pth"
    torch.save(models[1].state_dict(), path)
    return str(path)


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0
    return buf.getvalue()


def _noc_rows(table):
    """The NoC columns of each row of a results table (times dropped)."""
    rows = [line.split("|")[1:-3] for line in table.splitlines() if line.startswith("|")]
    return [[c.strip() for c in r] for r in rows]


@pytest.mark.parametrize("extra", [[], ["--with-flip"], ["--crops", "64x96"]],
                         ids=["plain", "flip", "crops"])
def test_cli_evaluate_matches_jax(pth, extra):
    """``cli.evaluate`` on two synthetic scenes, 3 clicks: the same NoC
    table as the JAX CLI's on the same weights."""
    argv = ["vit_tiny", "--checkpoint", pth, "--datasets", "synthetic", "--num-samples", "2",
            "--n-clicks", "3", "--platform", "cpu", *extra]
    got = _run(tevaluate.main, argv)
    assert "synthetic" in got and "NoC@90%" in got
    assert _noc_rows(got) == _noc_rows(_run(jevaluate.main, argv))


def test_cli_evaluate_names_a_checkpoint_directory():
    out = _run(tevaluate.main, ["vit_tiny", "--checkpoint", str(CKPT), "--ckpt-name", "best",
                                "--datasets", "synthetic,synthetic_hard", "--num-samples", "2",
                                "--n-clicks", "2", "--platform", "cpu"])
    assert [r[0] for r in _noc_rows(out)[1::2]] == ["synthetic", "synthetic_hard"]


@pytest.mark.parametrize("mode", ["InputBRS", "f-BRS"])
def test_cli_evaluate_brs_raises(mode, capsys):
    """The BRS modes, which raised before they were ported, now run: one
    scene, one click, the NoC table printed. One torch thread: hundreds of
    tiny decoder steps, which more threads only slow on a shared CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert tevaluate.main(["vit_tiny", "--mode", mode, "--platform", "cpu",
                               "--num-samples", "1", "--n-clicks", "1"]) == 0
    finally:
        torch.set_num_threads(threads)
    assert "NoC@90%" in capsys.readouterr().out


def test_cli_infer_eval_matches_jax(pth):
    """``cli.infer --eval`` on three synthetic scenes, 3 clicks: the JAX
    CLI's per-click means (both rounded to 4 places) within IOU_TOL."""
    argv = ["vit_tiny", "--checkpoint", pth, "--eval", "--num-samples", "3", "--num-clicks",
            "3", "--platform", "cpu"]
    got = json.loads(_run(tinfer.main, argv).strip().splitlines()[-1])
    ref = json.loads(_run(jinfer.main, argv).strip().splitlines()[-1])
    assert {"mean_iou_per_click", "click@1", "click@3", "s_per_image"} <= set(got)
    np.testing.assert_allclose(got["mean_iou_per_click"], ref["mean_iou_per_click"],
                               atol=IOU_TOL, rtol=0)
    assert got["click@1"] == got["mean_iou_per_click"][0]
    assert got["click@3"] == got["mean_iou_per_click"][-1]


@pytest.fixture(scope="module")
def sym_artifact(models, tmp_path_factory):
    """vit_tiny_synth's encoder, RTN symmetric 4-bit g32, written by the port."""
    enc = copy.deepcopy(models[1].image_encoder)
    tseq.rtn_quantize_encoder(enc, tseq.GPTQConfig(4, 32, sym=True))
    d = str(tmp_path_factory.mktemp("w4") / "w4")
    tart.save_quantized(d, tbuild.to_jax_encoder(enc),
                        {"method": "rtn", "wbits": 4, "groupsize": 32, "sym": True})
    return d


@pytest.mark.parametrize("extra", [[], ["--serve-int8"]], ids=["w4", "cached_int8"])
def test_cli_infer_eval_serves_quantized(sym_artifact, extra):
    """``--eval`` with ``--load`` (W4) and ``--serve-int8`` on the trained
    decoder: a full JSON line of per-click IoUs in [0, 1]."""
    out = json.loads(_run(tinfer.main, [
        "vit_tiny", "--checkpoint", str(CKPT), "--load", sym_artifact, *extra, "--eval",
        "--num-samples", "2", "--num-clicks", "2", "--platform", "cpu"]).splitlines()[-1])
    ious = out["mean_iou_per_click"]
    assert len(ious) == 2 and all(0.0 <= v <= 1.0 for v in ious)
    assert re.fullmatch(r"click@\d", [k for k in out if k.startswith("click@")][-1])
