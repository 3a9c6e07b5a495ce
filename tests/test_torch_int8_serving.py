"""Port parity for the cached-int8 serving mode, on the CPU.

``cache_int8`` and its helpers, ``int8_matmul`` on every branch, the static
activation-scale calibration, a cached-int8 encoder with the int8-pre proj,
and ``cli.infer --serve-int8`` on a JAX-written artifact: the same weights
and inputs, drawn with numpy from a seed or taken from the committed
``checkpoints/vit_tiny_synth``, go through the JAX package and the port.
Tolerances are stated where they are used.
"""

import dataclasses
import io
import json
import pathlib
import warnings
from contextlib import redirect_stderr, redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from sam_quantization_tpu.models import image_encoder as jie
from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.models.configs import CONFIGS as JCONFIGS
from sam_quantization_tpu.nn import packed as jpacked
from sam_quantization_tpu.ops import flash_attention as jfa
from sam_quantization_tpu.ops import quant_matmul as jqm
from sam_quantization_tpu.quant import act_scales as jact
from sam_quantization_tpu.quant import artifacts as jart
from sam_quantization_tpu.quant import gptq as jgptq
from sam_quantization_tpu.quant import sequential as jseq
from sam_quantization_tpu.train import checkpoint as ckpt_lib
from sam_quantization_tpu.train import trainer
from sam_quantization_tpu_torch.cli import infer as tinfer
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.nn import packed as tpacked
from sam_quantization_tpu_torch.nn.layers import Linear
from sam_quantization_tpu_torch.ops import quant_matmul as tqm
from sam_quantization_tpu_torch.quant import act_scales as tact
from sam_quantization_tpu_torch.quant import artifacts as tart

CKPT = pathlib.Path(__file__).resolve().parents[1] / "checkpoints" / "vit_tiny_synth"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _port_packed(jp) -> tpacked.PackedLinear:
    """The port's PackedLinear holding a JAX PackedLinear's words and fields."""
    f = {fl.name: getattr(jp, fl.name) for fl in dataclasses.fields(jp)}
    p = tpacked.PackedLinear(f["in_features"], f["out_features"], bits=f["bits"],
                             groupsize=f["groupsize"], pack_block=f["pack_block"],
                             bias=f["bias"] is not None, act_bits=f["act_bits"], sym=f["sym"])
    for k in ("qweight", "qweight_hi", "scales", "zeros", "bias"):
        if f[k] is not None:
            getattr(p, k).copy_(torch.from_numpy(np.array(f[k])))
    return p


def _block_pair(seed, K=128, groupsize=32, sym=True):
    """One block's four linears, RTN 4-bit, as a JAX pytree and a port module
    tree with the same paths (``blocks.0.attn.qkv`` ...)."""
    r = np.random.default_rng(seed)
    shapes = {"attn.qkv": (K, 3 * K), "attn.proj": (K, K), "mlp.lin1": (K, 2 * K),
              "mlp.lin2": (2 * K, K)}
    jtree = {"attn": {}, "mlp": {}}
    block = nn.Module()
    block.attn, block.mlp = nn.Module(), nn.Module()
    for path, (k, n) in shapes.items():
        w = (r.standard_normal((k, n)) * k**-0.5).astype(np.float32)
        b = (r.standard_normal(n) * 0.02).astype(np.float32)
        jp = jpacked.quantize_rtn(jnp.asarray(w), 4, groupsize, sym, bias=jnp.asarray(b))
        owner, name = path.split(".")
        jtree[owner][name] = jp
        setattr(getattr(block, owner), name, _port_packed(jp))
    port = nn.Module()
    port.blocks = nn.ModuleList([block])
    return {"blocks": [jtree]}, port


def _jnode(jtree, path):
    node = jtree
    for part in path.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


# ---------------------------------------------------------------------------
# cache_int8, expand_act_scales, default_serve_skip
# ---------------------------------------------------------------------------

SCALES = {"blocks.0.attn.qkv": 5.25, "blocks.0.attn.proj": 0.3, "blocks.0.mlp.lin1": 7.0,
          "blocks.0.mlp.lin2": 3.1}


@pytest.mark.parametrize("groupsize", [32, 0])
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("transpose", [True, False])
def test_cache_int8_matches_jax(groupsize, per_channel, transpose):
    """w8, scales, in_scale and the layout bit for bit: per-channel
    requantization of grouped weights, grouped weights kept (kn), one-group
    weights (nk with ``transpose``); ``attn.proj`` skipped to a dense layer
    whose weight is the bf16-rounded dequantized weight."""
    jtree, port = _block_pair(1, groupsize=groupsize)
    jout = jpacked.cache_int8(jtree, act_scales=SCALES, per_channel=per_channel,
                              transpose=transpose)
    assert tpacked.cache_int8(port, act_scales=SCALES, per_channel=per_channel,
                              transpose=transpose) is port
    for path in SCALES:
        jn = _jnode(jout, path)
        tn = port.get_submodule(path)
        if path.endswith("attn.proj"):  # the default skip
            assert isinstance(jn, dict) and isinstance(tn, Linear)
            assert jn["w"].dtype == jnp.bfloat16 and tn.weight.dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(tn.weight.t()), _np(jn["w"]))
            np.testing.assert_array_equal(_np(tn.bias), _np(jn["b"]))
            continue
        assert isinstance(jn, jpacked.IntLinear) and isinstance(tn, tpacked.IntLinear)
        assert (tn.layout, tn.groupsize, tn.num_groups) == (jn.layout, jn.groupsize, jn.num_groups)
        assert (tn.in_features, tn.out_features) == (jn.in_features, jn.out_features)
        assert tn.w8.dtype == torch.int8
        np.testing.assert_array_equal(tn.w8.numpy(), np.asarray(jn.w8))
        np.testing.assert_array_equal(tn.scales.numpy(), np.asarray(jn.scales))
        np.testing.assert_array_equal(tn.bias.numpy(), np.asarray(jn.bias))
        assert tn.in_scale.dtype == torch.float32 and tn.in_scale.dim() == 0
        assert tn.in_scale.numpy().tobytes() == np.asarray(jn.in_scale, np.float32).tobytes()
        assert tn.in_scale_value == float(tn.in_scale)


def test_cache_int8_keep_packed_skip_and_errors():
    """``keep_packed`` leaves a layer packed, ``skip=()`` converts proj too,
    an asymmetric layer stays packed on both sides, a key on a skipped
    (dense) layer is well-formed, and a key that names no linear raises the
    same ValueError on both sides."""
    jtree, port = _block_pair(2)
    jout = jpacked.cache_int8(jtree, keep_packed=("mlp.",), skip=())
    tpacked.cache_int8(port, keep_packed=("mlp.",), skip=())
    for path in SCALES:
        packed = path.startswith("blocks.0.mlp")
        assert isinstance(_jnode(jout, path), jpacked.PackedLinear) == packed
        assert isinstance(port.get_submodule(path), tpacked.PackedLinear) == packed
    assert port.get_submodule("blocks.0.attn.proj").in_scale is None  # dynamic

    jtree, port = _block_pair(3, sym=False)
    jout = jpacked.cache_int8(jtree)
    tpacked.cache_int8(port)
    assert isinstance(_jnode(jout, "blocks.0.attn.qkv"), jpacked.PackedLinear)
    assert isinstance(port.get_submodule("blocks.0.attn.qkv"), tpacked.PackedLinear)

    jtree, port = _block_pair(4)
    jpacked.cache_int8(jtree, act_scales={"blocks.0.attn.proj": 1.0})
    tpacked.cache_int8(port, act_scales={"blocks.0.attn.proj": 1.0})
    bad = {"attn.qkv": 1.0, "blocks.0.attn.qkv": 2.0}
    for fn, tree in ((jpacked.cache_int8, _block_pair(5)[0]), (tpacked.cache_int8, _block_pair(5)[1])):
        with pytest.raises(ValueError, match=r"matched no quantized linear: \['attn.qkv'\]"):
            fn(tree, act_scales=bad)


def test_expand_act_scales_and_default_serve_skip_match_jax():
    jtree, port = _block_pair(6)
    suffixes = {"attn.qkv": 8.0, "lin2": 3.0, "mlp.lin1": 5.0, "nothing": 1.0}
    assert tpacked.expand_act_scales(port, suffixes) == jpacked.expand_act_scales(jtree, suffixes)
    assert tpacked.expand_act_scales(port, {"attn.qkv": 8.0}) == {"blocks.0.attn.qkv": 8.0}
    for dim in (64, 768, 1024, 1280, 1536):
        assert tpacked.default_serve_skip(dim) == jpacked.default_serve_skip(dim)


def test_int_linear_keeps_float32_buffers():
    _, port = _block_pair(7)
    tpacked.cache_int8(port, act_scales=SCALES, skip=())
    lin = port.get_submodule("blocks.0.attn.proj")
    before = {k: getattr(lin, k).clone() for k in ("scales", "bias", "in_scale")}
    port.to(torch.bfloat16)
    for k, t in before.items():
        assert getattr(lin, k).dtype == torch.float32 and torch.equal(getattr(lin, k), t), k
    assert lin.w8.dtype == torch.int8


# ---------------------------------------------------------------------------
# int8_matmul, every branch
# ---------------------------------------------------------------------------


def _int_layers(seed, groupsize, static, per_channel=True, transpose=True):
    jtree, port = _block_pair(seed, groupsize=groupsize)
    scales = SCALES if static else None
    jout = jpacked.cache_int8(jtree, act_scales=scales, per_channel=per_channel, skip=(),
                              transpose=transpose)
    tpacked.cache_int8(port, act_scales=scales, per_channel=per_channel, skip=(),
                       transpose=transpose)
    return [(_jnode(jout, p), port.get_submodule(p)) for p in SCALES]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("branch", ["static_nk", "static_kn", "dynamic_nk", "dynamic_grouped",
                                    "static_grouped"])
def test_int8_matmul_matches_jax(dtype, branch):
    """Static (reciprocal multiply, round half to even, ``acc * (scales[0] *
    in_scale)``), dynamic per token, and grouped weights (kn, one int32
    product per group): the int32 accumulator and the output bit for bit.
    x has ragged M = 37 and half-way points of the static grid."""
    jdt, tdt = DTYPES[dtype]
    static = branch.startswith("static")
    grouped = branch.endswith("grouped")
    layers = _int_layers(8, 32, static, per_channel=not grouped, transpose=branch.endswith("nk"))
    r = np.random.default_rng(9)
    for jl, tl in layers:
        assert (tl.num_groups > 1) == grouped and tl.layout == ("kn" if grouped or
                                                                branch.endswith("kn") else "nk")
        x = (r.standard_normal((37, tl.in_features)) * 2).astype(np.float32)
        if static:  # values on the grid's half-way points
            x[0, :8] = (np.arange(8) + 0.5) * float(tl.in_scale)
        jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
        ref = jqm.int8_matmul(jx, jl)
        out = tqm.int8_matmul(tx, tl)
        assert out.dtype == tdt and tuple(out.shape) == tuple(ref.shape)
        np.testing.assert_array_equal(_np(out), _np(ref))
        xq = jnp.clip(jnp.round(jx.astype(jnp.float32) * 0.5), -127, 127).astype(jnp.int8)
        w = jl.w8.T if jl.layout == "nk" else jl.w8
        acc = jax.lax.dot_general(xq, w, (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
        tw = tl.w8.t() if tl.layout == "nk" else tl.w8
        np.testing.assert_array_equal(tqm._int_mm(torch.from_numpy(np.array(xq)), tw).numpy(),
                                      np.asarray(acc))


def test_int8_pre_matmul_matches_jax():
    """An int8 input is taken as quantized at in_scale already and the
    output is bfloat16, bit for bit; counted apart from the other calls."""
    r = np.random.default_rng(10)
    tqm.reset_launch_counts()
    for jl, tl in _int_layers(11, 32, static=True):
        xq = r.integers(-127, 128, (37, tl.in_features)).astype(np.int8)
        ref = jqm.int8_matmul(jnp.asarray(xq), jl)
        out = tqm.int8_matmul(torch.from_numpy(xq), tl)
        assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_np(out), _np(ref))
    assert tqm.INT8_MATMULS == {"int8_matmul": 0, "int8_matmul_pre": 4}
    _, dyn = _int_layers(12, 32, static=False)[0]
    with pytest.raises(ValueError, match="in_scale"):
        tqm.int8_matmul(torch.zeros((4, dyn.in_features), dtype=torch.int8), dyn)


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jmodel():
    """The committed vit_tiny checkpoint (non-zero rel-pos tables) in JAX."""
    cfg = JCONFIGS["vit_tiny"]
    template = jsam.init(jax.random.PRNGKey(0), cfg)
    opt_t = trainer.make_optimizer(trainer.TrainConfig()).init(template)
    model, _, _ = ckpt_lib.load_checkpoint(str(CKPT), template, opt_t, "best")
    return jax.tree_util.tree_map(jnp.asarray, model)


def _port_model(jm):
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    sd = tbuild.from_jax_params(to_np(jm.image_encoder), to_np(jm.prompt_encoder),
                                to_np(jm.mask_decoder), JCONFIGS["vit_tiny"])
    return tbuild.load_state_dict(tsam.Sam(TCONFIGS["vit_tiny"], device="cpu"), sd)


def _image(seed):
    return np.random.default_rng(seed).standard_normal((1, 128, 128, 3)).astype(np.float32) * 2


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_calibrate_act_scales_matches_jax(jmodel, dtype):
    """The same 16 paths; float32 rtol 1e-5 (the eager branches agree to
    float32 sums in another order; 2.8e-7 measured). In bfloat16 every
    activation is rounded, and the two eager branches round at different
    points (the softmax's float32 round trip), so by the third block an
    amax may sit two bf16 steps away: rtol 2**-6 (8.7e-3 measured)."""
    jdt, tdt = DTYPES[dtype]
    xs = [_image(20), _image(21)]
    ref = jact.calibrate_act_scales(jmodel.image_encoder, JCONFIGS["vit_tiny"].image_encoder,
                                    [jnp.asarray(x, jdt) for x in xs], margin=1.1)
    model = _port_model(jmodel)
    model.image_encoder.to(tdt)
    out = tact.calibrate_act_scales(model.image_encoder, [torch.from_numpy(x).to(tdt) for x in xs],
                                    margin=1.1)
    assert sorted(out) == sorted(ref) and len(out) == 4 * 4
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-5 if dtype == "f32" else 2.0**-6,
                                   err_msg=k)
    assert all(getattr(b.attn, "logit_observer") is None for b in model.image_encoder.blocks)


def test_check_clamp_window_warns_outside_the_window(jmodel):
    """The window is [-60, 64] / log2(e) in raw logits, as in JAX; inside it
    nothing is said, outside it both warn and return False. Calibration
    warns on a model whose rel-pos bias pushes the logits past the cap."""
    for lo, hi, ok in ((-10.0, 10.0, True), (-45.0, 10.0, False), (-10.0, 50.0, False)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert tact.check_clamp_window(lo, hi) is ok
            assert jact.check_clamp_window(lo, hi, warn=False) is ok
        assert len(caught) == (0 if ok else 1)
        if not ok:
            text = str(caught[0].message)
            assert "Recalibrate" in text and "SAMQ_" not in text
    np.testing.assert_allclose((tact.CLAMP_FLOOR_RAW, tact.CLAMP_CAP_RAW),
                               (jfa._CLAMP_FLOORE, jfa._CLAMP_CAPE), rtol=1e-12)
    model = _port_model(jmodel)
    with torch.no_grad():
        for blk in model.image_encoder.blocks:
            blk.attn.rel_pos_h.mul_(400.0)
    with pytest.warns(UserWarning, match="exceeds the clamped-softmax cap"):
        tact.calibrate_act_scales(model.image_encoder, [torch.from_numpy(_image(22))])


# ---------------------------------------------------------------------------
# A cached-int8 encoder, and cli.infer --serve-int8
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_artifact(jmodel, tmp_path_factory):
    """RTN symmetric W4 g32 of the committed checkpoint with static
    activation scales calibrated by JAX on one image (margin 1.1), written
    by the JAX package as ``cli/quantize --sym --act-scales`` writes it."""
    ecfg = JCONFIGS["vit_tiny"].image_encoder
    qcfg = jgptq.GPTQConfig(bits=4, groupsize=32, sym=True)
    qp = jax.jit(lambda p: jseq.rtn_quantize_encoder(p, qcfg))(jmodel.image_encoder)
    x = jsam.preprocess(jmodel, jnp.asarray(np.random.default_rng(23).integers(
        0, 256, (1, 128, 128, 3)).astype(np.float32)))
    scales = jact.calibrate_act_scales(jmodel.image_encoder, ecfg, [x], margin=1.1)
    d = str(tmp_path_factory.mktemp("int8") / "int8")
    jart.save_quantized(d, qp, {"method": "rtn", "wbits": 4, "groupsize": 32, "sym": True,
                                "act_scales": scales})
    return d


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cached_int8_encoder_matches_jax_flash(jmodel, int8_artifact, monkeypatch, dtype):
    """vit_tiny with every linear cached int8 (``skip=()``) against JAX's
    flash branch with its kernels in interpret mode. In bfloat16 the
    windowed blocks' proj runs int8-pre on the attention output's int8
    epilogue; float32 keeps a quantize pass before proj, as JAX does.

    Both sides take the same int8 weights, scales and integer products, but
    an activation within float rounding of a point between two int8 values
    may round to either, which moves its product by one activation step,
    and the flips cascade: in float32 the first (one value at block 2's qkv,
    from a 1.7e-6 input difference) leaves the embeddings 1.3e-3 apart
    (limit 3e-3). In bfloat16, which rounds at different points on the two
    sides, measured rel. L2 1.05e-2 against JAX and 9.0e-3 between the
    port's kernel and eager branches (the eager one quantizes proj's input
    from bf16); limit 2e-2 for both."""
    jdt, tdt = DTYPES[dtype]
    enc, qcfg = jart.load_quantized(int8_artifact)
    ecfg = JCONFIGS["vit_tiny"].image_encoder
    jenc = jpacked.cache_int8(enc, act_scales=qcfg["act_scales"], skip=())
    for name in ("flash_attention_qkv_packed", "flash_attention_relpos"):
        fn = getattr(jfa, name)
        monkeypatch.setattr(jfa, name, lambda *a, fn=fn, **kw: fn(*a, **kw, interpret=True))
    x = _image(24)
    ref = _np(jie.apply(jenc, jnp.asarray(x, jdt), ecfg, attn_impl="flash"))

    model = tbuild.load_jax_encoder(_port_model(jmodel), tart.load_quantized(int8_artifact)[0])
    tpacked.cache_int8(model.image_encoder, act_scales=qcfg["act_scales"], skip=())
    model.image_encoder.to(tdt)
    tqm.reset_launch_counts()
    with torch.no_grad():
        xt = torch.from_numpy(x).to(tdt)
        out = _np(tsam.encode_image(model, xt, "kernel"))
        counts = dict(tqm.INT8_MATMULS)
        eager = _np(tsam.encode_image(model, xt, "eager"))
    # bf16: the 2 windowed blocks take the int8-pre proj; the 64-token global
    # blocks' head-split route has no epilogue, so their proj quantizes.
    pre = 2 if dtype == "bf16" else 0
    assert counts == {"int8_matmul": 16 - pre, "int8_matmul_pre": pre}
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    tol = 2e-2 if dtype == "bf16" else 3e-3
    assert out.shape == (1, 8, 8, 32) and np.isfinite(out).all()
    assert rel(out, ref) <= tol, rel(out, ref)
    assert rel(eager, out) <= tol, rel(eager, out)


def _serve(args):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = tinfer.main(args)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def test_cli_serve_int8_on_jax_artifact(int8_artifact):
    """``--serve-int8`` converts the artifact with the static scales and the
    default routing (proj dense below 1280 wide): 3 int8 products a block,
    no int8-pre, and reports the serving mode as the JAX CLI does."""
    tqm.reset_launch_counts()
    rc, out, err = _serve(["vit_tiny", "--load", int8_artifact, "--serve-int8", "--benchmark",
                           "--bench-iters", "1", "--bench-warmup", "0", "--platform", "cpu"])
    assert rc == 0 and out["encoder_s_per_image"] > 0
    assert "serving mode: cached int8 weights, static act scales" in err
    depth = TCONFIGS["vit_tiny"].image_encoder.depth
    assert tqm.INT8_MATMULS == {"int8_matmul": 3 * depth, "int8_matmul_pre": 0}


def test_cli_serve_int8_ignores_asymmetric_artifact(jmodel, tmp_path):
    qcfg = jgptq.GPTQConfig(bits=4, groupsize=32, sym=False)
    qp = jax.jit(lambda p: jseq.rtn_quantize_encoder(p, qcfg))(jmodel.image_encoder)
    d = str(tmp_path / "asym")
    jart.save_quantized(d, qp, {"method": "rtn", "wbits": 4, "groupsize": 32, "sym": False})
    tqm.reset_launch_counts()
    rc, _, err = _serve(["vit_tiny", "--load", d, "--serve-int8", "--benchmark",
                         "--bench-iters", "1", "--bench-warmup", "0", "--platform", "cpu"])
    assert rc == 0 and "needs a symmetric gptq/rtn artifact" in err
    assert tqm.INT8_MATMULS == {"int8_matmul": 0, "int8_matmul_pre": 0}
