"""AOTInductor packages and the C++ runner on the CPU, held against the JAX
package.

The counterpart of JAX's SavedModel tests (``tests/test_export_and_amg.py``
``test_savedmodel_export_cpp_runner`` and
``test_savedmodel_quantized_encoder_cpp_runner``): a vit_tiny decoder
package written by ``cli.export --format aoti`` and a cached-int8 vit_tiny
encoder package (RTN symmetric W4 g32, static activation scales) written by
``export.export_encoder_aoti``, each loaded from Python and run by
``csrc/aoti_runner.cpp`` (built with ``g++`` at first use; a failed build
fails the test), against the module and the JAX package at JAX's tolerance
(rtol = atol = 2e-3). Each package is compiled once per module (a compile
takes tens of seconds on the CPU), which is why these cases are a file of
their own.
"""

import io
import json
import os
import subprocess
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_quantization_tpu import export as jexport
from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.models.configs import CONFIGS as JCONFIGS
from sam_quantization_tpu.nn import packed as jpacked
from sam_quantization_tpu.quant import artifacts as jart
from sam_quantization_tpu.quant import gptq as jgptq
from sam_quantization_tpu.quant import sequential as jseq
from sam_quantization_tpu_torch import export as texport
from sam_quantization_tpu_torch.cli import export as export_cli
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.nn import packed as tpacked
from sam_quantization_tpu_torch.ops import _build
from sam_quantization_tpu_torch.ops import quant_matmul as tqm
from sam_quantization_tpu_torch.quant import artifacts as tart

TOL = 2e-3  # JAX's SavedModel runner tests' rtol and atol
ACT_SCALES = {"attn.qkv": 8.0, "mlp.lin1": 8.0, "mlp.lin2": 8.0}


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run_runner(package, feeds, tmp_path):
    """Drive the built runner with the manifest / .bin tensor protocol."""
    in_dir, out_dir = tmp_path / "in", tmp_path / "out"
    in_dir.mkdir()
    out_dir.mkdir()
    for k, v in feeds.items():
        np.ascontiguousarray(v, np.float32).tofile(in_dir / f"{k}.bin")
        (in_dir / f"{k}.shape").write_text(" ".join(map(str, v.shape)))
    proc = subprocess.run([str(_build.aoti_runner()), str(package), str(in_dir), str(out_dir)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = {}
    for f in sorted(os.listdir(out_dir)):
        if f.endswith(".bin"):
            key = f[:-4]
            shape = tuple(int(x) for x in (out_dir / f"{key}.shape").read_text().split())
            got[key] = np.fromfile(out_dir / f, np.float32).reshape(shape)
    return got


@pytest.fixture(scope="module")
def decoder_package(tmp_path_factory):
    """vit_tiny (seed 0) decoder, 4 points, by ``cli.export --format aoti``."""
    directory = tmp_path_factory.mktemp("aoti") / "decoder"
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = export_cli.main(["vit_tiny", "--format", "aoti", "--output", str(directory),
                              "--num-points", "4", "--platform", "cpu"])
    assert rc == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line["manifest"] == {
        "inputs": {k: str(i) for i, k in enumerate(texport.DECODER_INPUTS)},
        "outputs": {k: str(i) for i, k in enumerate(texport.DECODER_OUTPUTS)}}
    return directory


def test_aoti_decoder_python_and_runner(decoder_package, tmp_path):
    """The package from Python and from the C++ runner against the module
    it was compiled from and JAX's SamDecoderModule on the same weights."""
    assert (decoder_package / "manifest.txt").read_text().splitlines() == [
        *(f"in {k} {i}" for i, k in enumerate(texport.DECODER_INPUTS)),
        *(f"out {k} {i}" for i, k in enumerate(texport.DECODER_OUTPUTS))]
    model = tbuild.sam_model_registry["vit_tiny"](device="cpu", seed=0)
    cfg = TCONFIGS["vit_tiny"].prompt_encoder
    h, w = cfg.image_embedding_size
    r = np.random.default_rng(0)
    feeds = {
        "image_embeddings": r.normal(size=(1, h, w, cfg.embed_dim)).astype(np.float32),
        "point_coords": np.array([[[40.0, 50.0], [90.0, 20.0], [0, 0], [0, 0]]], np.float32),
        "point_labels": np.array([[1.0, 0.0, -1, -1]], np.float32),
        "mask_input": (r.normal(size=(1, 4 * h, 4 * w, 1)) * 2).astype(np.float32),
        "has_mask_input": np.ones((1,), np.float32),
    }
    args = [torch.from_numpy(feeds[k]) for k in texport.DECODER_INPUTS]
    with torch.no_grad():
        want = texport.SamDecoderModule(model)(*args)
        from_python = texport.load_aoti(str(decoder_package))(*args)
    got = _run_runner(decoder_package, feeds, tmp_path)
    assert sorted(got) == sorted(texport.DECODER_OUTPUTS)

    pe, md = tbuild.to_jax_decoder_params(model.state_dict(), model.config)
    jm = jsam.Sam({}, jax.tree_util.tree_map(jnp.asarray, pe),
                  jax.tree_util.tree_map(jnp.asarray, md), JCONFIGS["vit_tiny"])
    jout = jexport.SamDecoderModule(jm)(*[jnp.asarray(feeds[k]) for k in texport.DECODER_INPUTS])
    for k, w_t, p_t, j in zip(texport.DECODER_OUTPUTS, want, from_python, jout):
        np.testing.assert_allclose(p_t.numpy(), w_t.numpy(), rtol=TOL, atol=TOL, err_msg=k)
        np.testing.assert_allclose(got[k], w_t.numpy(), rtol=TOL, atol=TOL, err_msg=k)
        np.testing.assert_allclose(got[k], np.asarray(j), rtol=TOL, atol=TOL, err_msg=k)


def test_aoti_quantized_encoder_runner(tmp_path):
    """The cached-int8 serving encoder through the C++ runner: JAX's
    RTN-int4-sym artifact (the test_export_and_amg.py:264-310 model), loaded
    by the port and cached int8 with the same static scales, compiled with
    AOTInductor (``IntLinear``'s ``torch._int_mm`` traces), against JAX's
    ``encode_image(attn_impl="xla")`` and the port's eager encoder."""
    jm = jsam.init(jax.random.PRNGKey(2), JCONFIGS["vit_tiny"])
    qenc = jseq.rtn_quantize_encoder(jm.image_encoder,
                                     jgptq.GPTQConfig(bits=4, groupsize=32, sym=True))
    art = str(tmp_path / "w4")
    jart.save_quantized(art, qenc, {"method": "rtn", "wbits": 4, "groupsize": 32, "sym": True})
    jenc = jpacked.cache_int8(qenc, act_scales=jpacked.expand_act_scales(qenc, ACT_SCALES))
    assert jenc["blocks"][0]["attn"]["qkv"].in_scale is not None
    jq = jsam.Sam(jenc, jm.prompt_encoder, jm.mask_decoder, JCONFIGS["vit_tiny"])

    sd = tbuild.from_jax_params(_to_np(jm.image_encoder), _to_np(jm.prompt_encoder),
                                _to_np(jm.mask_decoder), TCONFIGS["vit_tiny"])
    model = tbuild.load_state_dict(tsam.Sam(TCONFIGS["vit_tiny"], device="cpu"), sd)
    tbuild.load_jax_encoder(model, tart.load_quantized(art)[0])
    enc = model.image_encoder
    tpacked.cache_int8(enc, act_scales=tpacked.expand_act_scales(enc, ACT_SCALES))
    assert enc.blocks[0].attn.qkv.in_scale is not None

    package = tmp_path / "encoder"
    manifest = texport.export_encoder_aoti(model, str(package))
    assert manifest == {"inputs": {"image": "0"}, "outputs": {"image_embeddings": "0"}}
    size = TCONFIGS["vit_tiny"].image_encoder.img_size
    x = np.random.default_rng(4).normal(size=(1, size, size, 3)).astype(np.float32)
    got = _run_runner(package, {"image": x}, tmp_path)["image_embeddings"]

    tqm.reset_launch_counts()
    with torch.no_grad():
        eager = tsam.encode_image(model, torch.from_numpy(x), "eager").numpy()
    assert tqm.INT8_MATMULS["int8_matmul"] > 0
    want = np.asarray(jsam.encode_image(jq, jnp.asarray(x), attn_impl="xla"))
    assert got.shape == want.shape == (1, 8, 8, 32)
    np.testing.assert_allclose(got, eager, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
