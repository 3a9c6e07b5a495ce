"""Port parity: the click-loop trainer, its checkpoints, data and CLI
against the JAX package, on the CPU.

The trainer runs on the committed ``checkpoints/vit_tiny_synth`` weights and
Adam state, carried into both packages, with B = 2 synthetic scenes and 3
clicks. The random click placement of the two packages draws from different
generators, so the tests replace ``_sample_error_click`` on both sides by one
deterministic rule: the first error pixel in raster order. JAX's trainer runs
eager attention on the CPU; the port runs ``flash_train`` (the head-split
kernel's plain version forward, eager-recompute backward), so the two differ
by float32 rounding. Tolerances are stated where they are used.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_quantization_tpu.data import synthetic as jsynth
from sam_quantization_tpu.models import build_sam as jbuild
from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.models.configs import CONFIGS as JCONFIGS
from sam_quantization_tpu.train import checkpoint as jckpt
from sam_quantization_tpu.train import trainer as jtrainer
from sam_quantization_tpu_torch.cli import train as tcli
from sam_quantization_tpu_torch.data import synthetic as tsynth
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.train import checkpoint as tckpt
from sam_quantization_tpu_torch.train import trainer as ttrainer

REPO = pathlib.Path(__file__).resolve().parents[1]
CKPTS = {name: REPO / "checkpoints" / name for name in ("vit_tiny_synth", "vit_tiny_hard")}
TCFG = {"num_clicks": 3}


def _jax_first_error(pred_logit, gt, key):
    pred = pred_logit > 0
    gt_b = gt > 0.5
    fn = jnp.logical_and(gt_b, jnp.logical_not(pred))
    fp = jnp.logical_and(jnp.logical_not(gt_b), pred)
    use_fn = fn.sum() > 0
    region = jnp.where(use_fn, fn, fp).reshape(-1)
    region = jnp.where(region.sum() > 0, region, jnp.ones_like(region))
    idx = jnp.argmax(region)
    W = gt.shape[1]
    return jnp.stack([idx % W, idx // W]).astype(jnp.float32), jnp.where(use_fn, 1.0, 0.0)


def _torch_first_error(pred_logit, gt, gen):
    pred = pred_logit > 0
    gt_b = gt > 0.5
    fn = gt_b & ~pred
    fp = ~gt_b & pred
    use_fn = bool(fn.any())
    region = (fn if use_fn else fp).reshape(-1)
    if not bool(region.any()):
        region = torch.ones_like(region)
    idx = int(torch.argmax(region.int()))
    W = gt.shape[1]
    return torch.tensor([idx % W, idx // W], dtype=torch.float32), torch.tensor(float(use_fn))


@pytest.fixture
def first_error_clicks(monkeypatch):
    monkeypatch.setattr(jtrainer, "_sample_error_click", _jax_first_error)
    monkeypatch.setattr(ttrainer, "_sample_error_click", _torch_first_error)


def _jax_templates():
    """The JAX reader's model and optax templates; it reads only their
    structure, so abstract shapes (no init run) suffice."""
    template = jax.eval_shape(lambda: jsam.init(jax.random.PRNGKey(0), JCONFIGS["vit_tiny"]))
    opt = jtrainer.make_optimizer(jtrainer.TrainConfig())
    return template, jax.eval_shape(opt.init, template)


def _jax_load(name, directory=None, ckpt="latest"):
    model, opt_state, epoch = jckpt.load_checkpoint(
        str(directory or CKPTS[name]), *_jax_templates(), ckpt)
    model = jax.tree_util.tree_map(jnp.asarray, model)
    return model, jax.tree_util.tree_map(jnp.asarray, opt_state), epoch


def _torch_load(name, tcfg=ttrainer.TrainConfig()):
    model = tsam.Sam(TCONFIGS["vit_tiny"], device="cpu")
    optimizer = ttrainer.make_optimizer(tcfg, model)
    epoch = tckpt.load_checkpoint(str(CKPTS[name]), model, optimizer, "latest")
    return model, optimizer, epoch


def _batch(seed=11, n=2):
    samples = list(tsynth.synthetic_samples(n, 128, seed))
    images = np.concatenate([im for im, _ in samples])
    gts = np.stack([gt for _, gt in samples]).astype(np.float32)
    return images, gts


def _by_name(tree_model):
    """Upstream-named numpy dict of a JAX ``Sam`` pytree (model or moment)."""
    return jbuild.to_torch_state_dict(tree_model)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("style", ["easy", "hard"])
def test_synthetic_samples_bit_identical(style):
    ours = list(tsynth.synthetic_samples(3, 96, 5, style))
    ref = list(jsynth.synthetic_samples(3, 96, 5, style))
    for (im, gt), (jim, jgt) in zip(ours, ref):
        assert im.dtype == jim.dtype and gt.dtype == jgt.dtype
        np.testing.assert_array_equal(im, jim)
        np.testing.assert_array_equal(gt, jgt)


@pytest.mark.parametrize("size,out", [(1024, 256), (128, 32), (128, 128)])
def test_resize_nearest_matches_jax(size, out):
    """``nearest-exact`` is ``jax.image.resize``'s nearest (half-pixel
    centres): equal bit for bit, 1024 -> 256 included."""
    m = (np.random.default_rng(2).random((2, size, size)) > 0.5).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(m), (2, out, out), "nearest")
    np.testing.assert_array_equal(ttrainer._resize_nearest(torch.from_numpy(m), out).numpy(),
                                  np.asarray(ref))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CKPTS))
def test_checkpoint_reader_matches_jax(name):
    """The port's reader gives the JAX reader's parameters, Adam moments and
    count, bit for bit, for both committed checkpoints."""
    jmodel, jopt, jepoch = _jax_load(name)
    model, optimizer, epoch = _torch_load(name)
    assert epoch == jepoch
    sd = model.state_dict()
    ref = _by_name(jmodel)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    adam = jopt[0]
    mu, nu = _by_name(adam.mu), _by_name(adam.nu)
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(optimizer.state[p]["exp_avg"].numpy(), mu[n], err_msg=n)
        np.testing.assert_array_equal(optimizer.state[p]["exp_avg_sq"].numpy(), nu[n],
                                      err_msg=n)
        assert float(optimizer.state[p]["step"]) == int(adam.count)
    assert int(adam.count) > 0


def test_port_checkpoint_loads_in_jax(tmp_path, first_error_clicks):
    """A checkpoint the port writes after one training step loads in the JAX
    reader with the port's parameters, moments and count, bit for bit; and
    the port reads it back bit for bit."""
    model, optimizer, _ = _torch_load("vit_tiny_synth")
    images, gts = _batch()
    step = ttrainer.make_train_step(ttrainer.TrainConfig(**TCFG), optimizer)
    step(model, torch.from_numpy(images), torch.from_numpy(gts), torch.Generator())
    tckpt.save_checkpoint(str(tmp_path), model, optimizer, 7, extras={"note": 1})
    jmodel, jopt, epoch = _jax_load(None, tmp_path)
    assert epoch == 7
    assert json.loads((tmp_path / "sam_model_latest.json").read_text())["note"] == 1
    ref, mu, nu = _by_name(jmodel), _by_name(jopt[0].mu), _by_name(jopt[0].nu)
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), ref[n], err_msg=n)
        np.testing.assert_array_equal(optimizer.state[p]["exp_avg"].numpy(), mu[n], err_msg=n)
        np.testing.assert_array_equal(optimizer.state[p]["exp_avg_sq"].numpy(), nu[n],
                                      err_msg=n)
    assert int(jopt[0].count) == int(optimizer.state[p]["step"])

    back = tsam.Sam(TCONFIGS["vit_tiny"], device="cpu")
    back_opt = ttrainer.make_optimizer(ttrainer.TrainConfig(), back)
    assert tckpt.load_checkpoint(str(tmp_path), back, back_opt) == 7
    for (n, p), q in zip(model.named_parameters(), back.parameters()):
        assert torch.equal(p, q), n
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(optimizer.state[p][key], back_opt.state[q][key]), (n, key)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


def test_click_train_loss_matches_jax(first_error_clicks):
    """Loss, iou and every leaf's gradient (``pe_gaussian`` included) against
    ``jax.value_and_grad`` of the JAX loss: loss rtol 1e-5, iou equal,
    gradients |d| <= 1e-4 max|g| + 1e-7 per leaf (float32 sums in another
    order, and the clamped exp2 softmax of the port's forward against JAX's
    eager softmax on the CPU). A leaf the loss does not reach (the iou head)
    has no gradient in the port and a zero one in JAX."""
    jmodel, _, _ = _jax_load("vit_tiny_synth")
    model, _, _ = _torch_load("vit_tiny_synth")
    images, gts = _batch()
    tcfg = TCFG
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda m: jtrainer.click_train_loss(m, jnp.asarray(images), jnp.asarray(gts),
                                            jax.random.PRNGKey(0),
                                            jtrainer.TrainConfig(**tcfg)),
        has_aux=True))(jmodel)
    loss, aux = ttrainer.click_train_loss(model, torch.from_numpy(images), torch.from_numpy(gts),
                                          torch.Generator(), ttrainer.TrainConfig(**tcfg))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(aux["iou"]) == pytest.approx(float(jaux["iou"]), abs=1e-6)
    ref = _by_name(jgrads)
    names = dict(model.named_parameters())
    assert set(names) == set(ref)
    assert "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix" in ref
    for n, g in ref.items():
        ours = names[n].grad
        if ours is None:
            assert not np.any(g) and n.startswith("mask_decoder.iou_prediction_head"), n
            continue
        tol = 1e-4 * float(np.abs(g).max()) + 1e-7
        np.testing.assert_allclose(ours.numpy(), g, atol=tol, rtol=0, err_msg=n)


def test_train_step_from_carried_adam_state_matches_jax(first_error_clicks):
    """One ``make_train_step`` from the checkpoint's own parameters and Adam
    state, carried into both packages, moves every parameter as JAX's
    ``optax.adamw`` step does: |d(update)| <= 1e-3 max|update| plus two
    float32 steps of the largest weight (the update is read as the
    difference of two rounded weights)."""
    jmodel, jopt, _ = _jax_load("vit_tiny_synth")
    model, optimizer, _ = _torch_load("vit_tiny_synth")
    images, gts = _batch(seed=12)
    tcfg = TCFG
    jopt_fn = jtrainer.make_optimizer(jtrainer.TrainConfig(**tcfg))
    jnew, _, jaux = jax.jit(jtrainer.make_train_step(jtrainer.TrainConfig(**tcfg), jopt_fn))(
        jmodel, jopt, jnp.asarray(images), jnp.asarray(gts), jax.random.PRNGKey(1))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = ttrainer.make_train_step(ttrainer.TrainConfig(**tcfg), optimizer)
    aux = step(model, torch.from_numpy(images), torch.from_numpy(gts), torch.Generator())
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    ref_old, ref_new = _by_name(jmodel), _by_name(jnew)
    moved = 0
    for n, p in model.named_parameters():
        want = ref_new[n] - ref_old[n]
        got = (p.detach() - before[n]).numpy()
        moved += bool(np.any(want))
        ulp = np.spacing(np.abs(ref_old[n]).max())
        np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max() + 2 * ulp, rtol=0,
                                   err_msg=n)
    assert moved > 0.8 * len(ref_new), moved


def test_train_cli_runs_and_resumes(tmp_path):
    """``cli.train vit_tiny --platform cpu``: two steps, a checkpoint and the
    scalar log; then ``--resume`` continues from it for a second epoch."""
    base = ["vit_tiny", "--platform", "cpu", "--exp-dir", str(tmp_path), "--steps-per-epoch",
            "2", "--num-clicks", "2", "--seed", "3"]
    assert tcli.main(base) == 0
    exp = tmp_path / "000-finetune"
    assert json.loads((exp / "checkpoints" / "sam_model_latest.json").read_text())["epoch"] == 1
    first = dict(np.load(exp / "checkpoints" / "sam_model_latest.npz"))
    assert int(first["o0"]) == 2
    assert tcli.main(base + ["--resume", "000", "--epochs", "2"]) == 0
    assert json.loads((exp / "checkpoints" / "sam_model_latest.json").read_text())["epoch"] == 2
    second = dict(np.load(exp / "checkpoints" / "sam_model_latest.npz"))
    assert int(second["o0"]) == 4 and list(second) == list(first)
    assert not np.array_equal(second["m0"], first["m0"])
    with pytest.raises(ValueError, match="tp"):  # --tp 2 does not divide a world of one
        tcli.main(base + ["--tp", "2"])
