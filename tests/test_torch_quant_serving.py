"""Port parity for W4A16 packed-weight serving, on the CPU.

Artifacts written by the JAX package into ``tmp_path`` are loaded by the
port and served against the JAX package on the same artifact: the vit_tiny
predictor, an encoder whose MLP fuses, mixed per-layer artifacts, the RTN
quantizer, and the ``cli.infer`` entry point. Tolerances are stated where
they are used.
"""

import dataclasses
import io
import json
import pathlib
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_quantization_tpu.models import image_encoder as jie
from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.models.configs import CONFIGS as JCONFIGS
from sam_quantization_tpu.nn import packed as jpacked
from sam_quantization_tpu.predictor import SamPredictor as JPredictor
from sam_quantization_tpu.quant import artifacts as jart
from sam_quantization_tpu.quant import gptq as jgptq
from sam_quantization_tpu.quant import sequential as jseq
from sam_quantization_tpu.train import checkpoint as ckpt_lib
from sam_quantization_tpu.train import trainer
from sam_quantization_tpu_torch.cli import infer as tinfer
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.models.image_encoder import BLOCK_LINEARS
from sam_quantization_tpu_torch.nn import packed as tpacked
from sam_quantization_tpu_torch.ops import fused_mlp as tfused
from sam_quantization_tpu_torch.predictor import SamPredictor as TPredictor
from sam_quantization_tpu_torch.quant import artifacts as tart
from sam_quantization_tpu_torch.quant import sequential as tseq

REPO = pathlib.Path(__file__).resolve().parents[1]
CKPT = REPO / "checkpoints" / "vit_tiny_synth"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _fields(p):
    """A JAX PackedLinear as the dict of its fields, arrays in numpy."""
    return {f.name: np.asarray(v) if isinstance(v, jax.Array) else v
            for f in dataclasses.fields(p) for v in [getattr(p, f.name)]}


def _rtn(params, bits, groupsize):
    """The JAX RTN quantizer, jitted (op by op it takes seconds; jitted, its
    scales may differ from the eager ones by an ulp, the same for both sides)."""
    qcfg = jgptq.GPTQConfig(bits=bits, groupsize=groupsize)
    return jax.jit(lambda p: jseq.rtn_quantize_encoder(p, qcfg))(params)


def _apply(params, x, ecfg):
    return _np(jax.jit(lambda p, x: jie.apply(p, x, ecfg))(params, x))


@pytest.fixture(scope="module")
def jmodel():
    """The committed vit_tiny checkpoint (non-zero rel-pos tables) in JAX."""
    cfg = JCONFIGS["vit_tiny"]
    template = jsam.init(jax.random.PRNGKey(0), cfg)
    opt_t = trainer.make_optimizer(trainer.TrainConfig()).init(template)
    model, _, _ = ckpt_lib.load_checkpoint(str(CKPT), template, opt_t, "best")
    return jax.tree_util.tree_map(jnp.asarray, model)


def _port_model(jm, cfg_name="vit_tiny"):
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    sd = tbuild.from_jax_params(to_np(jm.image_encoder), to_np(jm.prompt_encoder),
                                to_np(jm.mask_decoder), JCONFIGS[cfg_name])
    return tbuild.load_state_dict(tsam.Sam(TCONFIGS[cfg_name], device="cpu"), sd)


def test_w4_predictor_matches_jax_on_jax_artifact(jmodel, tmp_path):
    """vit_tiny, RTN W4 g32, written by the JAX package and loaded by the
    port: the port's predictor (kernel path, plain kernel versions; the MLP
    does not fuse at H = 256 on either side) against the JAX predictor on the
    same artifact, float32. low_res and iou atol 1e-4 (float32 sums in
    another order)."""
    d = str(tmp_path / "w4")
    qp = _rtn(jmodel.image_encoder, 4, 32)
    jart.save_quantized(d, qp, {"method": "rtn", "wbits": 4, "groupsize": 32})
    enc, qcfg = jart.load_quantized(d)
    jq = jsam.Sam(image_encoder=enc, prompt_encoder=jmodel.prompt_encoder,
                  mask_decoder=jmodel.mask_decoder, config=jmodel.config)

    tenc, tcfg = tart.load_quantized(d)
    assert tcfg == qcfg
    tmodel = tbuild.load_jax_encoder(_port_model(jmodel), tenc)
    blk = tmodel.image_encoder.blocks[0]
    assert isinstance(blk.attn.qkv, tpacked.PackedLinear) and blk.mlp.lin1.bits == 4
    assert not tfused.fused_mlp_supported(blk.mlp.lin1, blk.mlp.lin2)

    image = np.random.default_rng(11).integers(0, 256, (150, 200, 3), dtype=np.uint8)
    jp, tp = JPredictor(jq), TPredictor(tmodel)
    np.testing.assert_allclose(_np(tp.set_image(image)), _np(jp.set_image(image)), atol=1e-4)
    pts, labels = np.array([[100.0, 60.0], [40.0, 120.0]], np.float32), np.array([1.0, 0.0])
    jm, ji, jl = jp.predict(pts, labels, return_logits=True)
    tm, ti, tl = tp.predict(pts, labels, return_logits=True)
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    np.testing.assert_allclose(ti, ji, atol=1e-4)


def _fusable_cfg():
    """2 blocks, 128 wide, MLP 512: the smallest encoder whose MLP fuses."""
    base = JCONFIGS["vit_tiny"].image_encoder
    return dataclasses.replace(base, embed_dim=128, depth=2, num_heads=4,
                               global_attn_indexes=(1,))


def test_fused_encoder_matches_jax_bf16(tmp_path):
    """A JAX-written W4 g32 encoder on which the fused MLP engages in the
    port (attn_impl="kernel"). JAX on the CPU never fuses, and both sides
    round to bfloat16 at different points, so the check is bfloat16-sized:
    rel. L2 of the embeddings <= 3e-2 and the port's fused and unfused
    (eager) runs within the same distance of each other."""
    ecfg = _fusable_cfg()
    params = jax.jit(lambda k: jie.init(k, ecfg))(jax.random.PRNGKey(5))
    r = np.random.default_rng(12)
    for blk in params["blocks"]:
        for k in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][k] = jnp.asarray(r.normal(size=blk["attn"][k].shape) * 0.2, jnp.float32)
    qp = _rtn(params, 4, 32)
    d = str(tmp_path / "fused")
    jart.save_quantized(d, qp, {"method": "rtn", "wbits": 4, "groupsize": 32})
    enc, _ = jart.load_quantized(d)
    x = r.normal(size=(1, ecfg.img_size, ecfg.img_size, 3)).astype(np.float32)
    ref = _apply(enc, jnp.asarray(x, jnp.bfloat16), ecfg)

    tcfg = dataclasses.replace(TCONFIGS["vit_tiny"], image_encoder=ecfg)
    model = tbuild.load_jax_encoder(tsam.init(tcfg, 0, "cpu"), tart.load_quantized(d)[0])
    mlp = model.image_encoder.blocks[0].mlp
    assert tfused.fused_mlp_supported(mlp.lin1, mlp.lin2)
    model.image_encoder.to(torch.bfloat16)
    with torch.no_grad():
        xb = torch.from_numpy(x).bfloat16()
        fused = _np(tsam.encode_image(model, xb, "kernel"))
        eager = _np(tsam.encode_image(model, xb, "eager"))
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    assert rel(fused, ref) <= 3e-2, rel(fused, ref)
    assert rel(eager, ref) <= 3e-2, rel(eager, ref)
    assert fused.shape == (1, 8, 8, 32) and np.isfinite(fused).all()


def test_rtn_and_port_artifact_match_jax(jmodel, tmp_path):
    """The port's rtn_quantize_encoder packs the same words as the JAX one
    from the same dense weights, and an artifact the port writes loads in
    the JAX package and encodes as the port does (float32, atol 1e-4)."""
    model = _port_model(jmodel)
    qcfg = tseq.GPTQConfig(bits=3, groupsize=32)
    tseq.rtn_quantize_encoder(model.image_encoder, qcfg)
    # Op by op, as cli/quantize runs it: under jit XLA turns the division by
    # maxq into a multiplication by its reciprocal, one ulp off in the scales.
    jq = jseq.rtn_quantize_encoder(jmodel.image_encoder, jgptq.GPTQConfig(bits=3, groupsize=32))
    tree = tbuild.to_jax_encoder(model.image_encoder)
    for i, blk in enumerate(jq["blocks"]):
        for owner, name in BLOCK_LINEARS:
            want, got = _fields(blk[owner][name]), tree["blocks"][i][owner][name]
            for k in ("qweight", "qweight_hi", "scales", "zeros", "bias"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{i} {name} {k}")
    d = str(tmp_path / "port")
    tart.save_quantized(d, tree, {"method": "rtn", "wbits": 3, "groupsize": 32})
    enc, cfg = jart.load_quantized(d)
    assert isinstance(enc["blocks"][1]["mlp"]["lin2"], jpacked.PackedLinear) and cfg["wbits"] == 3
    x = np.random.default_rng(13).standard_normal((1, 128, 128, 3)).astype(np.float32)
    ref = _apply(enc, jnp.asarray(x), JCONFIGS["vit_tiny"].image_encoder)
    with torch.no_grad():
        out = tsam.encode_image(model, torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-4)


def test_mixed_artifact_keeps_dense_layers(jmodel, tmp_path):
    """An artifact with per-layer bits and a layer left dense (what
    --overrides / --bump-worst write) loads as it is: the dense layer stays a
    Linear, the others keep their own bit widths; encode atol 1e-4 vs JAX."""
    qp = _rtn(jmodel.image_encoder, 4, 32)
    qp["blocks"][0]["attn"]["proj"] = jmodel.image_encoder["blocks"][0]["attn"]["proj"]
    qp["blocks"][1]["mlp"]["lin1"] = jpacked.quantize_rtn(
        jmodel.image_encoder["blocks"][1]["mlp"]["lin1"]["w"], 8, 32,
        bias=jmodel.image_encoder["blocks"][1]["mlp"]["lin1"]["b"])
    d = str(tmp_path / "mixed")
    jart.save_quantized(d, qp, {"method": "gptq", "wbits": 4, "groupsize": 32})
    model = tbuild.load_jax_encoder(_port_model(jmodel), tart.load_quantized(d)[0])
    blocks = model.image_encoder.blocks
    assert not isinstance(blocks[0].attn.proj, tpacked.PackedLinear)
    assert blocks[1].mlp.lin1.bits == 8 and blocks[1].mlp.lin2.bits == 4
    x = np.random.default_rng(14).standard_normal((1, 128, 128, 3)).astype(np.float32)
    ref = _apply(jart.load_quantized(d)[0], jnp.asarray(x), JCONFIGS["vit_tiny"].image_encoder)
    with torch.no_grad():
        out = tsam.encode_image(model, torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-4)


def test_cli_infer_serves_jax_artifact_on_cpu(tmp_path):
    """``cli.infer --load DIR --benchmark --platform cpu`` loads a JAX-written
    artifact and prints the encoder's time as JSON; without --platform it
    asks for the card, and raises where there is none."""
    qp = _rtn(jax.jit(lambda k: jie.init(k, JCONFIGS["vit_tiny"].image_encoder))(
        jax.random.PRNGKey(0)), 4, 32)
    d = str(tmp_path / "cli")
    jart.save_quantized(d, qp, {"method": "rtn", "wbits": 4, "groupsize": 32})
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = tinfer.main(["vit_tiny", "--load", d, "--benchmark", "--bench-iters", "2",
                          "--bench-warmup", "1", "--platform", "cpu"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and out["encoder_s_per_image"] > 0 and out["encoder_images_per_s"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tinfer.main(["vit_tiny", "--load", d])
