"""FQ-ViT artifacts across the two packages' CLIs, on the CPU, on
``checkpoints/vit_tiny_synth`` saved as a ``.pth`` that both CLIs load.

* A: the JAX package's ``cli.quantize --method fq``, read by the port's
  ``artifacts.load_quantized`` and ``load_fq_qparams`` and served by the
  port's ``cli.infer --load A --benchmark``;
* B: the port's ``cli.quantize --method fq --platform cpu``, whose
  ``quant_config.json``, weights and ``fq_qparams.npz`` the JAX package's
  ``load_quantized`` and ``cli.infer --load B`` read.

Each artifact encodes one seeded image in quant mode in both packages (JAX
jitted with the qparams as arguments) within rel L2 1e-2. A and B come from
the same weights and calibration images, so they hold the same points,
bit-equal weights, and scales within rel 1e-6 (``test_torch_fq_encoder.py``'s
calibration tolerance).

``cli.infer --eval --num-samples 4`` on A (the CLIs' click loops feed
unnormalised pixels, as both do, ROADMAP Queue 3): the first click's mean
IoU within 1e-3 between the two CLIs. Later clicks are placed at random in
the previous mask's error region, so a click moves wherever one pixel of a
mask flips, and the quantized encoders differ by rounding flips: on two of
the four scenes 1% of the embedding (a cascade from one flip, as
``test_torch_fq_encoder.py`` traces), and the JAX CLI closes over its
qparams (XLA folds ``x / scale`` into a reciprocal product: 1.4% of its own
embedding). Free running, the CLIs read 2.5e-3 apart at click 3 (measured),
held within 1e-2; with JAX's clicks replayed (its ``click_loop_eval`` on the
same artifact, qparams as arguments) every click's mean IoU is within 1e-3
(1.2e-4 measured).
"""

import io
import json
import pathlib
from contextlib import redirect_stderr, redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_quantization_tpu.cli import infer as jinfer
from sam_quantization_tpu.cli import quantize as jquantize
from sam_quantization_tpu.data.synthetic import synthetic_samples as jsynthetic
from sam_quantization_tpu.evaluation import click_eval as jce
from sam_quantization_tpu.models import build_sam as jbuild
from sam_quantization_tpu.models import image_encoder as jie
from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.models.configs import CONFIGS as JCONFIGS
from sam_quantization_tpu.quant import artifacts as jart
from sam_quantization_tpu.quant.fq import pipeline as jp
from sam_quantization_tpu_torch.cli import infer as tinfer
from sam_quantization_tpu_torch.cli import quantize as tquantize
from sam_quantization_tpu_torch.data.synthetic import synthetic_samples as tsynthetic
from sam_quantization_tpu_torch.evaluation import click_eval as tce
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.quant import artifacts as tart
from sam_quantization_tpu_torch.quant.fq import pipeline as tp
from sam_quantization_tpu_torch.train import checkpoint as tckpt

CKPT = pathlib.Path(__file__).resolve().parents[1] / "checkpoints" / "vit_tiny_synth"
ECFG = JCONFIGS["vit_tiny"].image_encoder
QUANT_TOL = 1e-2
IOU_TOL = 1e-3
FREE_IOU_TOL = 1e-2


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        assert main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(pth, A, B): vit_tiny_synth as a .pth, and its FQ artifacts written by
    the JAX CLI (A) and the port's (B), PTF + LIS + minmax on 2 scenes."""
    d = tmp_path_factory.mktemp("fq")
    model = tbuild.sam_model_registry["vit_tiny"](device="cpu")
    tckpt.load_weights(str(CKPT), model, "best")
    pth = str(d / "vit_tiny_synth.pth")
    torch.save(model.state_dict(), pth)
    argv = ["vit_tiny", "--checkpoint", pth, "--method", "fq", "--nsamples", "2",
            "--platform", "cpu"]
    _run(jquantize.main, [*argv, "--save", str(d / "A")])
    last, _ = _run(tquantize.main, [*argv, "--save", str(d / "B")])
    assert last["status"] == "ok" and last["method"] == "fq" and last["save"] == str(d / "B")
    return pth, str(d / "A"), str(d / "B")


def _encodes_alike(art):
    """One seeded image through the artifact in quant mode, in each package."""
    tree, cfg = jart.load_quantized(art)
    fqcfg = jp.FQConfig(int_softmax=cfg["lis"], int_norm=cfg["ptf"], observer_a=cfg["quant_method"])
    qp = tart.load_fq_qparams(art)
    x = np.random.default_rng(5).standard_normal((1, 128, 128, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, q, x: jie.apply(
        p, x, ECFG, jp.FQCtx("quant", fqcfg, qparams=q), attn_impl="xla"))(
        tree, {k: tuple(jnp.asarray(v) for v in sz) for k, sz in qp.items()}, jnp.asarray(x)))
    model = tbuild.load_jax_encoder(tsam.Sam(tbuild.CONFIGS["vit_tiny"], device="cpu"),
                                    tart.load_quantized(art)[0])
    ctx = tp.FQCtx("quant", tp.FQConfig(int_softmax=cfg["lis"], int_norm=cfg["ptf"],
                                        observer_a=cfg["quant_method"]),
                   qparams=tp.qparams_to(qp, "cpu"))
    with torch.no_grad():
        got = tsam.encode_image(model, torch.from_numpy(x), ctx=ctx).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= QUANT_TOL
    assert set(ctx.ln_modes.values()) == {"int"}


def _serves(main, art, pth, warmup):
    out, err = _run(main, ["vit_tiny", "--checkpoint", pth, "--load", art, "--benchmark",
                           "--bench-iters", "1", "--bench-warmup", warmup, "--platform", "cpu"])
    assert out["encoder_s_per_image"] > 0
    assert "loaded quantized encoder: fq" in err and "loaded FQ activation qparams" in err


def test_jax_fq_artifact_serves_in_port(artifacts):
    pth, a, _ = artifacts
    tree, cfg = tart.load_quantized(a)
    assert cfg["method"] == "fq" and cfg["ptf"] and cfg["lis"] and cfg["quant_method"] == "minmax"
    assert "w" in tree["blocks"][0]["attn"]["qkv"]  # dense, fake-quantized
    _encodes_alike(a)
    _serves(tinfer.main, a, pth, "0")


def test_port_fq_artifact_serves_in_jax(artifacts):
    """B is written as the JAX CLI writes A: the same files, config keys and
    qparams keys, bit-equal weights, scales rel 1e-6; JAX loads and serves it."""
    pth, a, b = artifacts
    assert sorted(p.name for p in pathlib.Path(b).iterdir()) == \
        sorted(p.name for p in pathlib.Path(a).iterdir())
    (ta, ca), (tb, cb) = jart.load_quantized(a), jart.load_quantized(b)
    assert ca == cb
    flat = jax.tree_util.tree_leaves_with_path
    la, lb = dict(flat(ta)), dict(flat(tb))
    assert sorted(la, key=str) == sorted(lb, key=str)
    assert all(np.array_equal(np.asarray(la[k]), np.asarray(lb[k])) for k in la)
    qa, qb = tart.load_fq_qparams(a), tart.load_fq_qparams(b)
    assert sorted(qa) == sorted(qb) and len(qa) == 49
    for k in qa:
        np.testing.assert_allclose(qb[k][0], qa[k][0], rtol=1e-6, atol=0, err_msg=k)
        np.testing.assert_array_equal(qb[k][1], qa[k][1], err_msg=k)
    _encodes_alike(b)
    _serves(jinfer.main, b, pth, "1")


def test_fq_eval_matches_jax(artifacts):
    pth, a, _ = artifacts
    argv = ["vit_tiny", "--checkpoint", pth, "--load", a, "--eval", "--num-samples", "4",
            "--platform", "cpu"]
    got, _ = _run(tinfer.main, argv)
    want, _ = _run(jinfer.main, argv)
    assert len(got["mean_iou_per_click"]) == len(want["mean_iou_per_click"]) == 5
    assert abs(got["click@1"] - want["click@1"]) <= IOU_TOL
    np.testing.assert_allclose(got["mean_iou_per_click"], want["mean_iou_per_click"],
                               atol=FREE_IOU_TOL, rtol=0)

    # JAX's click loop on the same artifact, then the port's on its clicks.
    jm = jbuild.sam_model_registry["vit_tiny"](checkpoint=pth)
    jm = jsam.Sam(image_encoder=jart.load_quantized(a)[0], prompt_encoder=jm.prompt_encoder,
                  mask_decoder=jm.mask_decoder, config=jm.config)
    qp = tart.load_fq_qparams(a)
    jqp = {k: tuple(jnp.asarray(v) for v in sz) for k, sz in qp.items()}
    encode = jax.jit(lambda x, q: jsam.encode_image(
        jm, x, jp.FQCtx("quant", jp.FQConfig(), qparams=q), attn_impl="xla"))
    kw = dict(num_clicks=5, img_size=128, seed=42)
    ref = jce.click_loop_eval(lambda x: encode(x, jqp), jce.make_sam_backend(jm)[1],
                              jsynthetic(4, 128, 42), **kw)
    tm = tbuild.sam_model_registry["vit_tiny"](checkpoint=pth, device="cpu")
    tbuild.load_jax_encoder(tm, tart.load_quantized(a)[0])
    ctx = tp.FQCtx("quant", tp.FQConfig(), qparams=tp.qparams_to(qp, "cpu"))
    replay = tce.click_loop_eval(*tce.make_sam_backend(tm, ctx), tsynthetic(4, 128, 42),
                                 clicks_override=ref.clicks, **kw)
    assert replay.clicks == ref.clicks
    np.testing.assert_allclose(replay.mean_ious, ref.mean_ious, atol=IOU_TOL, rtol=0)
