"""Port parity of the test-time-augmentation predictors
(``evaluation/predictors.py``: plain, flip, zoom-in, crops) and of
``noc_eval_predictor``, on the CPU, against the JAX package's on the
committed ``checkpoints/vit_tiny_synth`` weights (float32).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sam_quantization_tpu.evaluation import click_eval as jce
from sam_quantization_tpu.evaluation import predictors as jpred
from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.models.configs import CONFIGS as JCONFIGS
from sam_quantization_tpu.predictor import SamPredictor as JPredictor
from sam_quantization_tpu.train import checkpoint as jckpt
from sam_quantization_tpu.train import trainer as jtrainer
from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
from sam_quantization_tpu_torch.evaluation import click_eval as tce
from sam_quantization_tpu_torch.evaluation import predictors as tpred
from sam_quantization_tpu_torch.evaluation.clicker import Clicker
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.predictor import SamPredictor as TPredictor
from sam_quantization_tpu_torch.train import checkpoint as tckpt

CKPT = pathlib.Path(__file__).resolve().parents[1] / "checkpoints" / "vit_tiny_synth"
# Probabilities of two float32 stacks: sigmoid of logits that agree to
# about 1e-4 (the bilinear upsample and the encoder's sum order).
PROB_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    cfg = JCONFIGS["vit_tiny"]
    template = jsam.init(jax.random.PRNGKey(0), cfg)
    opt_t = jtrainer.make_optimizer(jtrainer.TrainConfig()).init(template)
    jmodel, _, _ = jckpt.load_checkpoint(str(CKPT), template, opt_t, "best")
    tmodel = tbuild.sam_model_registry["vit_tiny"](device="cpu")
    tckpt.load_weights(str(CKPT), tmodel, "best")
    return jax.tree_util.tree_map(jnp.asarray, jmodel), tmodel


def _scenes(n):
    """Raw uint8-valued scenes, 150 x 200 (non-square, larger than the
    model's 128 input, so every TTA resizes)."""
    return [(img[0, :150], gt[:150]) for img, gt in synthetic_samples(n, 200, seed=5)]


VARIANTS = {
    "plain": {},
    "flip": {"with_flip": True},
    "zoom_in": {"zoom_in": "ZoomIn"},
    "crops": {"crops": "Crops"},
}


def _eval_predictor(mod, predictor, variant):
    kw = dict(VARIANTS[variant])
    if "zoom_in" in kw:
        kw["zoom_in"] = mod.ZoomIn(target_size=128)
    if "crops" in kw:
        kw["crops"] = mod.Crops(crop_size=(64, 96))
    return mod.SamEvalPredictor(predictor, **kw)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_eval_predictor_matches_jax(models, variant, monkeypatch):
    """One clicker drives both predictors through 4 clicks on each of two
    scenes; each click's probability map agrees within PROB_TOL. Zoom-in
    must refine at least one click (an ROI smaller than the image)."""
    jmodel, tmodel = models
    refined = []
    refine = tpred.ZoomIn.refine

    def counting_refine(self, eval_pred, clicks, prob):
        out = refine(self, eval_pred, clicks, prob)
        refined.append(not np.array_equal(out, prob))
        return out

    monkeypatch.setattr(tpred.ZoomIn, "refine", counting_refine)
    for image, gt in _scenes(2):
        image = image.astype(np.uint8)
        tp = _eval_predictor(tpred, TPredictor(tmodel), variant)
        jp = _eval_predictor(jpred, JPredictor(jmodel), variant)
        tp.set_input_image(image)
        jp.set_input_image(image)
        if variant == "crops":
            assert tp._crop_offsets == jp._crop_offsets and len(tp._crop_offsets) > 1
        clicker = Clicker(gt_mask=gt)
        pred = np.zeros(gt.shape, bool)
        for _ in range(4):
            clicker.make_next_click(pred)
            got, want = tp.get_prediction(clicker), jp.get_prediction(clicker)
            assert got.shape == want.shape == gt.shape and got.dtype == np.float32
            np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)
            pred = want > 0.5
    assert any(refined) == (variant == "zoom_in")


def test_crops_offsets_and_roi_match_jax():
    for H, W, crop in ((150, 200, (64, 96)), (480, 640, (320, 480)), (100, 100, (100, 100)),
                       (60, 200, (64, 96))):
        assert tpred.Crops(crop).offsets(H, W) == jpred.Crops(crop).offsets(H, W)
    r = np.random.default_rng(0)
    mask = r.random((50, 70)) > 0.97
    clicks = [tpred.Click(True, (3, 60)), tpred.Click(False, (45, 2))]
    for ratio in (1.0, 1.4, 2.0):
        assert tpred._get_roi(mask, clicks, ratio, mask.shape) == \
            jpred._get_roi(mask, clicks, ratio, mask.shape)
    x = r.standard_normal((9, 9)).astype(np.float32) * 40
    np.testing.assert_array_equal(tpred._sigmoid(x), jpred._sigmoid(x))


@pytest.mark.parametrize("variant", ["plain", "flip", "zoom_in", "crops"])
def test_noc_eval_predictor_matches_jax(models, variant):
    """NoC through each TTA predictor over 2 scenes and 3 clicks: the
    same NoC and failures as JAX's."""
    jmodel, tmodel = models
    scenes = _scenes(2)
    kw = dict(max_clicks=3)
    got = tce.noc_eval_predictor(_eval_predictor(tpred, TPredictor(tmodel), variant),
                                 scenes, **kw)
    want = jce.noc_eval_predictor(_eval_predictor(jpred, JPredictor(jmodel), variant),
                                  scenes, **kw)
    assert got[:2] == want[:2]
