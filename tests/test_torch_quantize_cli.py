"""The port's ``cli.quantize`` on the CPU (``--platform cpu``), on vit_tiny.

Each artifact the port writes loads in the JAX package's
``artifacts.load_quantized`` and encodes there as the port encodes it
(float32, atol 1e-4), and serves through the port's ``cli.infer --load``.
The static activation scales of ``--sym --act-scales`` equal JAX's
``calibrate_act_scales`` on the same dense weights and images (rel 1e-5).
"""

import argparse
import io
import json
from contextlib import redirect_stderr, redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_quantization_tpu.models import image_encoder as jie
from sam_quantization_tpu.models.configs import CONFIGS as JCONFIGS
from sam_quantization_tpu.nn import packed as jpacked
from sam_quantization_tpu.quant import act_scales as jact
from sam_quantization_tpu.cli import quantize as jquantize
from sam_quantization_tpu.quant import artifacts as jart
from sam_quantization_tpu_torch.cli import infer as tinfer
from sam_quantization_tpu_torch.cli import quantize as tquantize
from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.quant import artifacts as tart

ECFG = JCONFIGS["vit_tiny"].image_encoder


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        assert main(argv) == 0
    return out.getvalue(), err.getvalue()


def _quantize(d, *extra):
    out, _ = _run(tquantize.main, ["vit_tiny", "--platform", "cpu", "--nsamples", "2",
                                   "--save", str(d), *extra])
    last = json.loads(out.strip().splitlines()[-1])
    assert last["status"] == "ok" and last["save"] == str(d) and last["elapsed_s"] >= 0
    return out, last


def _encodes_as_jax(d, seed):
    """The artifact's encoder in JAX and in the port (``cli.infer``'s
    loader) on one image: atol 1e-4."""
    enc, cfg = jart.load_quantized(str(d))
    model = tbuild.load_jax_encoder(tsam.init(TCONFIGS["vit_tiny"], 0, "cpu"),
                                    tart.load_quantized(str(d))[0])
    x = np.random.default_rng(seed).standard_normal((1, 128, 128, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jie.apply(p, x, ECFG))(enc, jnp.asarray(x)))
    with torch.no_grad():
        out = tsam.encode_image(model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    return enc, cfg


def _serves(d, *extra):
    out, err = _run(tinfer.main, ["vit_tiny", "--load", str(d), "--benchmark", "--bench-iters",
                                  "1", "--bench-warmup", "0", "--platform", "cpu", *extra])
    assert json.loads(out.strip().splitlines()[-1])["encoder_s_per_image"] > 0
    return err


@pytest.mark.parametrize("method", ["gptq", "rtn"])
def test_quantize_cli_artifact_loads_in_jax_and_serves(tmp_path, method):
    """W4 g32 by GPTQ (per-layer losses in the artifact, one printed per
    layer) and W3 g32 by RTN (``--nearest``)."""
    d = tmp_path / method
    extra = ["--wbits", "4", "--groupsize", "32"] if method == "gptq" else \
        ["--wbits", "3", "--groupsize", "32", "--nearest"]
    out, last = _quantize(d, *extra)
    assert last["method"] == method
    enc, cfg = _encodes_as_jax(d, 1)
    assert cfg["method"] == method and cfg["groupsize"] == 32 and cfg["overrides"] is None
    lin2 = enc["blocks"][3]["mlp"]["lin2"]
    assert isinstance(lin2, jpacked.PackedLinear) and lin2.bits == cfg["wbits"]
    if method == "gptq":
        assert len(cfg["losses"]) == 16 and all(np.isfinite(v) for v in cfg["losses"].values())
        assert "blocks.3.mlp.lin2: loss=" in out
    else:
        assert cfg["losses"] == {}
    assert "loaded quantized encoder: " + method in _serves(d)


def test_quantize_cli_bump_worst(tmp_path):
    """``--bump-worst 2``: the two worst layers by layerwise SNR (RTN at the
    global config) are solved at 8 bits, and the rules ship in the artifact."""
    d = tmp_path / "bump"
    out, _ = _quantize(d, "--wbits", "2", "--groupsize", "32", "--bump-worst", "2")
    assert "bumping worst-2 SNR ops to 8-bit" in out
    enc, cfg = _encodes_as_jax(d, 2)
    rules = json.loads(cfg["overrides"])
    assert len(rules) == 2 and all(r["bits"] == 8 for r in rules)
    for r in rules:
        i, owner, name = r["pattern"].split(".")[1:]
        assert enc["blocks"][int(i)][owner][name].bits == 8
    bits = [blk[o][n].bits for blk in enc["blocks"] for o, n in
            (("attn", "qkv"), ("attn", "proj"), ("mlp", "lin1"), ("mlp", "lin2"))]
    assert sorted(bits) == [2] * 14 + [8] * 2


def test_quantize_cli_sym_act_scales_serve_int8(tmp_path):
    """``--sym --act-scales``: the artifact's static scales are JAX's on the
    same dense weights and calibration images, and it serves
    ``--serve-int8`` with them."""
    d = tmp_path / "sym"
    _quantize(d, "--wbits", "4", "--groupsize", "32", "--sym", "--act-scales")
    _, cfg = _encodes_as_jax(d, 3)
    dense = tbuild.sam_model_registry["vit_tiny"](device="cpu", seed=0)
    batches = [tsam.preprocess(dense, torch.from_numpy(img)).numpy()
               for img, _ in synthetic_samples(2, 128, 0)]
    want = jact.calibrate_act_scales(tbuild.to_jax_encoder(dense.image_encoder), ECFG,
                                     [jnp.asarray(x) for x in batches], margin=1.1)
    assert sorted(cfg["act_scales"]) == sorted(want) and len(want) == 16
    for k, v in want.items():
        np.testing.assert_allclose(cfg["act_scales"][k], v, rtol=1e-5, err_msg=k)
    assert "static act scales" in _serves(d, "--serve-int8")


def test_quantize_cli_fq_and_card_default(tmp_path):
    """``--method fq --platform cpu`` calibrates FQ-ViT and saves its
    artifact with ``fq_qparams.npz`` (the round trip with JAX is
    ``tests/test_torch_fq_cli.py``); without ``--platform cpu`` the CLI asks
    for the card."""
    _, last = _quantize(tmp_path / "fq", "--method", "fq")
    assert last["method"] == "fq"
    assert jart.load_quantized(str(tmp_path / "fq"))[1]["quant_method"] == "minmax"
    assert "blocks.0.qact2.scale" in np.load(tmp_path / "fq" / "fq_qparams.npz").files
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tquantize.main(["vit_tiny", "--nsamples", "1"])


def test_calibration_images_match_jax(tmp_path):
    """``iter_calib_images``: seeded synthetic scenes bit for bit, and SBD
    train items (a three-image ``.mat`` layout, two taken) resized and
    padded within bilinear rounding (float32 in [0, 255]: atol 1e-3), as
    the JAX CLI reads them."""
    PIL = pytest.importorskip("PIL.Image")
    savemat = pytest.importorskip("scipy.io").savemat
    (tmp_path / "img").mkdir()
    (tmp_path / "inst").mkdir()
    r = np.random.default_rng(4)
    for n in ("a", "b", "c"):
        PIL.fromarray(r.integers(0, 256, (60, 90, 3), dtype=np.uint8)).save(tmp_path / "img" / f"{n}.jpg")
        inst = np.zeros((60, 90), np.uint8)
        inst[10:40, 20:70] = 1
        struct = np.empty((1, 1), dtype=[("Segmentation", "O")])
        struct[0, 0]["Segmentation"] = inst
        savemat(str(tmp_path / "inst" / f"{n}.mat"), {"GTinst": struct})
    (tmp_path / "train.txt").write_text("a\nb\nc\n")
    for sbd, tol in ((None, 0.0), (str(tmp_path), 1e-3)):
        args = argparse.Namespace(sbd_dir=sbd, nsamples=2, seed=5)
        got = list(tquantize.iter_calib_images(args, 128))
        want = [np.asarray(x) for x in jquantize.iter_calib_images(args, 128)]
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.shape == w.shape == (1, 128, 128, 3) and g.dtype == np.float32
            np.testing.assert_allclose(g, w, atol=tol, rtol=0)
