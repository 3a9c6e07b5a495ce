"""Port parity: the PyTorch models against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed (or come from the committed
``checkpoints/vit_tiny_synth`` weights, whose rel-pos tables are non-zero)
and go through both packages. Float32 throughout unless a test says
otherwise; the tolerances are stated where they are used.
"""

import copy
import dataclasses
import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_quantization_tpu.models import build_sam as jbuild
from sam_quantization_tpu.models import image_encoder as jie
from sam_quantization_tpu.models import prompt_encoder as jpe
from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.models.configs import CONFIGS as JCONFIGS
from sam_quantization_tpu.nn import functional as JF
from sam_quantization_tpu.predictor import SamPredictor as JPredictor
from sam_quantization_tpu.train import checkpoint as ckpt_lib
from sam_quantization_tpu.train import trainer
from sam_quantization_tpu.utils.transforms import ResizeLongestSide as JResize
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.models import image_encoder as tie
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.nn import functional as TFn
from sam_quantization_tpu_torch.predictor import SamPredictor as TPredictor
from sam_quantization_tpu_torch.utils.transforms import ResizeLongestSide as TResize

REPO = pathlib.Path(__file__).resolve().parents[1]
CKPT = REPO / "checkpoints" / "vit_tiny_synth"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def models():
    """The committed vit_tiny checkpoint in both packages."""
    cfg = JCONFIGS["vit_tiny"]
    template = jsam.init(jax.random.PRNGKey(0), cfg)
    opt_t = trainer.make_optimizer(trainer.TrainConfig()).init(template)
    jmodel, _, _ = ckpt_lib.load_checkpoint(str(CKPT), template, opt_t, "best")
    jmodel = jax.tree_util.tree_map(jnp.asarray, jmodel)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in jbuild.to_torch_state_dict(jmodel).items()}
    tmodel = tbuild.load_state_dict(tsam.Sam(TCONFIGS["vit_tiny"], device="cpu"), sd)
    return jmodel, tmodel


# ---------------------------------------------------------------------------
# nn/functional
# ---------------------------------------------------------------------------

# float32: same arithmetic in another order; bfloat16: one bf16 step.
TOL = {"f32": (torch.float32, jnp.float32, 1e-5, 0.0), "bf16": (torch.bfloat16, jnp.bfloat16, 1e-2, 1e-2)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm_and_gelu_match_jax(dtype):
    tdt, jdt, atol, rtol = TOL[dtype]
    r = np.random.default_rng(0)
    x = (r.standard_normal((2, 5, 7, 16)) * 3).astype(np.float32)
    w, b = r.standard_normal(16).astype(np.float32), r.standard_normal(16).astype(np.float32)
    out = TFn.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w), torch.from_numpy(b))
    ref = JF.layer_norm({"w": w, "b": b}, jnp.asarray(x, jdt))
    assert out.dtype == tdt
    np.testing.assert_allclose(_np(out), _np(ref), atol=atol, rtol=rtol)
    out2d = TFn.layer_norm_2d(torch.from_numpy(x).to(tdt), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_array_equal(_np(out2d), _np(out))
    out = TFn.gelu(torch.from_numpy(x).to(tdt))
    ref = JF.gelu(jnp.asarray(x, jdt))
    np.testing.assert_allclose(_np(out), _np(ref), atol=max(atol, 1e-6), rtol=rtol)


def test_gelu_form_follows_dtype():
    """erf GELU in float32, tanh GELU in bfloat16 (the forms differ by up to
    4.7e-4 near |x| = 2.7, so float32 parity needs the erf form)."""
    x = torch.linspace(-4, 4, 801)
    exact = torch.nn.functional.gelu(x)
    assert float((exact - torch.nn.functional.gelu(x, approximate="tanh")).abs().max()) > 4e-4
    np.testing.assert_array_equal(TFn.gelu(x).numpy(), exact.numpy())
    xb = x.bfloat16()
    tanh = torch.nn.functional.gelu(xb, approximate="tanh")
    np.testing.assert_array_equal(TFn.gelu(xb).float().numpy(), tanh.float().numpy())


@pytest.mark.parametrize(
    "shape,kernel,stride,padding",
    [((1, 32, 32, 3), 16, 16, 0),  # patch embed: space-to-depth + matmul
     ((2, 8, 8, 16), 1, 1, 0),  # 1x1 conv
     ((1, 8, 8, 16), 3, 1, 1)],  # neck 3x3 conv: a real convolution
)
def test_conv2d_matches_jax(shape, kernel, stride, padding):
    r = np.random.default_rng(1)
    x = r.standard_normal(shape).astype(np.float32)
    w = r.standard_normal((8, shape[-1], kernel, kernel)).astype(np.float32)  # OIHW
    b = r.standard_normal(8).astype(np.float32)
    out = TFn.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                     stride, padding)
    ref = JF.conv2d({"w": w.transpose(2, 3, 1, 0), "b": b}, jnp.asarray(x), stride, padding)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-4)


def test_conv_transpose2d_matches_jax():
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 4, 4, 16)).astype(np.float32)
    w = r.standard_normal((16, 8, 2, 2)).astype(np.float32)  # (I, O, kh, kw)
    b = r.standard_normal(8).astype(np.float32)
    out = TFn.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    ref = JF.conv_transpose2d({"w": w.transpose(2, 3, 0, 1), "b": b}, jnp.asarray(x))
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn_impl", ["kernel", "eager"])
def test_encoder_matches_jax(models, attn_impl):
    """vit_tiny encoder vs JAX ``image_encoder.apply`` (CPU, eager attention),
    atol 1e-4. The kernel path runs the two kernels' plain versions here."""
    jmodel, tmodel = models
    x = np.random.default_rng(3).standard_normal((1, 128, 128, 3)).astype(np.float32)
    ref = jie.apply(jmodel.image_encoder, jnp.asarray(x), JCONFIGS["vit_tiny"].image_encoder)
    out = tsam.encode_image(tmodel, torch.from_numpy(x), attn_impl)
    assert tuple(out.shape) == (1, 8, 8, 32)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-4)


def test_golden_pins_through_port():
    """tests/test_golden.py's frozen values, reproduced by the port on the
    JAX PRNGKey(7) weights carried over by ``from_jax_params``."""
    jmodel = jsam.init(jax.random.PRNGKey(7), JCONFIGS["vit_tiny"])
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    sd = tbuild.from_jax_params(to_np(jmodel.image_encoder), to_np(jmodel.prompt_encoder),
                                to_np(jmodel.mask_decoder), JCONFIGS["vit_tiny"])
    model = tbuild.load_state_dict(tsam.Sam(TCONFIGS["vit_tiny"], device="cpu"), sd)
    x = torch.from_numpy(
        np.linspace(0, 255, 1 * 128 * 128 * 3, dtype=np.float32).reshape(1, 128, 128, 3)
    )
    with torch.no_grad():
        emb = tsam.encode_image(model, tsam.preprocess(model, x))
        low, iou = tsam.decode_masks(
            model, emb, points=(torch.tensor([[[64.0, 64.0]]]), torch.tensor([[1.0]])),
            multimask_output=False,
        )
    e, lo = emb.numpy(), low.numpy()
    np.testing.assert_allclose(e.mean(), 5.588e-09, atol=1e-6)
    np.testing.assert_allclose(e.std(), 0.99999756, rtol=1e-4)
    np.testing.assert_allclose(e[0, 3, 5, 7], -0.68819928, rtol=1e-3)
    np.testing.assert_allclose(lo.mean(), 0.02208020, rtol=1e-3)
    np.testing.assert_allclose(lo.std(), 0.02981719, rtol=1e-3)
    np.testing.assert_allclose(lo[0, 0, 20, 20], -0.01579731, rtol=2e-3)
    np.testing.assert_allclose(float(iou[0, 0]), -0.25990996, rtol=1e-3)


def test_prompt_encoder_matches_jax(models):
    """Padded -1 labels, box corners and per-row ``mask_valid``, atol 1e-5."""
    jmodel, tmodel = models
    r = np.random.default_rng(4)
    coords = (r.random((2, 5, 2)) * 128).astype(np.float32)
    labels = np.array([[1, 0, -1, -1, -1], [1, 1, 0, 1, -1]], np.float32)
    boxes = np.array([[10, 20, 90, 100], [0, 0, 127, 127]], np.float32)
    masks = r.standard_normal((2, 32, 32, 1)).astype(np.float32)
    valid = np.array([True, False])
    pcfg = JCONFIGS["vit_tiny"].prompt_encoder
    for kw in ({"boxes": None}, {"boxes": boxes}):
        jb = None if kw["boxes"] is None else jnp.asarray(boxes)
        tb = None if kw["boxes"] is None else torch.from_numpy(boxes)
        js, jd = jpe.apply(jmodel.prompt_encoder, pcfg, (jnp.asarray(coords), jnp.asarray(labels)),
                           jb, jnp.asarray(masks), jnp.asarray(valid))
        ts, td = tmodel.prompt_encoder((torch.from_numpy(coords), torch.from_numpy(labels)),
                                       tb, torch.from_numpy(masks), torch.from_numpy(valid))
        np.testing.assert_allclose(_np(ts), _np(js), atol=1e-5)
        np.testing.assert_allclose(_np(td), _np(jd), atol=1e-5)


@pytest.mark.parametrize("hw", [(150, 200), (100, 60)])
def test_predictor_matches_jax(models, hw):
    """SamPredictor vs the JAX SamPredictor: set_image, then predict with
    points, with a box, and with the previous low-res mask. (150, 200) shrinks
    the image into the model frame (antialiased); (100, 60) grows it, and its
    masks shrink back in postprocessing. low_res / iou atol 1e-4; masks equal
    except where |logit| < 1e-4."""
    jmodel, tmodel = models
    image = np.random.default_rng(5).integers(0, 256, (*hw, 3), dtype=np.uint8)
    jp, tp = JPredictor(jmodel), TPredictor(tmodel)
    jemb = jp.set_image(image)
    temb = tp.set_image(image)
    assert tp.input_size == tuple(jp.input_size)
    np.testing.assert_allclose(_np(temb), _np(jemb), atol=1e-4)

    h, w = hw
    pts = np.array([[w * 0.5, h * 0.4], [w * 0.2, h * 0.8]], np.float32)
    labels = np.array([1, 0], np.float32)
    prompts = [
        dict(point_coords=pts, point_labels=labels),
        dict(box=np.array([w * 0.1, h * 0.1, w * 0.7, h * 0.9], np.float32)),
    ]
    jres = jp.predict(**prompts[0], return_logits=True)
    prompts.append(dict(point_coords=pts[:1], point_labels=labels[:1],
                        mask_input=jres[2][int(np.argmax(jres[1]))][None],
                        multimask_output=False))
    for prompt in prompts:
        jm, ji, jl = jp.predict(**prompt, return_logits=True)
        tm, ti, tl = tp.predict(**prompt, return_logits=True)
        assert tm.shape == jm.shape and tm.shape[-2:] == hw
        np.testing.assert_allclose(tl, jl, atol=1e-4)
        np.testing.assert_allclose(ti, ji, atol=1e-4)
        sure = np.abs(jm) >= 1e-4
        np.testing.assert_array_equal((tm > 0)[sure], (jm > 0)[sure])
    masks, _, _ = tp.predict(**prompts[0])
    assert masks.dtype == np.bool_


def test_resize_matches_jax_antialias():
    """Shrinking resizes (ResizeLongestSide.apply_image, the second resize of
    postprocess_masks) match jax.image.resize's antialiased triangle filter:
    the gap is float32 rounding, far below 0.5 grey level / 1e-4 logit."""
    r = np.random.default_rng(6)
    image = r.integers(0, 256, (301, 451, 3), dtype=np.uint8)
    ref = JResize(128).apply_image(image)
    out = TResize(128).apply_image(image)
    assert tuple(out.shape) == ref.shape
    assert float(np.abs(_np(out) - ref).max()) < 1e-3
    masks = r.standard_normal((1, 3, 32, 32)).astype(np.float32)

    class _M:  # the JAX function reads only the config
        config = JCONFIGS["vit_tiny"]

    ref = jsam.postprocess_masks(_M, jnp.asarray(masks), (128, 77), (100, 60))
    out = tsam.postprocess_masks(_M, torch.from_numpy(masks), (128, 77), (100, 60))
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)


def test_from_jax_params_matches_to_torch_state_dict(models):
    jmodel, tmodel = models
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    ours = tbuild.from_jax_params(
        to_np(jmodel.image_encoder), to_np(jmodel.prompt_encoder),
        to_np(jmodel.mask_decoder), JCONFIGS["vit_tiny"],
    )
    ref = jbuild.to_torch_state_dict(jmodel)
    assert list(ours) == list(ref)
    assert set(ours) == set(tmodel.state_dict())
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)


def test_registry_loads_upstream_checkpoint(models, tmp_path):
    """A ``.pth`` of the upstream-named state dict loads through the
    registry unchanged (the path of an official SAM checkpoint)."""
    _, tmodel = models
    path = tmp_path / "sam_vit_tiny.pth"
    torch.save(tmodel.state_dict(), path)
    loaded = tbuild.sam_model_registry["vit_tiny"](checkpoint=str(path), device="cpu")
    for k, v in tmodel.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


@pytest.mark.parametrize("entry", ["registry", "init", "Sam"])
def test_entry_points_default_to_cuda(entry):
    cfg = TCONFIGS["vit_tiny"]
    build = {"registry": tbuild.sam_model_registry["vit_tiny"],
             "init": lambda **kw: tsam.init(cfg, **kw),
             "Sam": lambda **kw: tsam.Sam(cfg, **kw)}[entry]
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert build(device="cpu").device.type == "cpu"


def test_kernel_path_refuses_config_without_rel_pos(monkeypatch):
    """A config without rel-pos is not refused on the kernel path: it runs
    JAX's kernel branch (head-split q/k/v, no rel tiles, to
    ``flash_attention_relpos``) for windowed and global blocks alike. Held
    against JAX's ``attn_impl="flash"`` encoder with its kernels in
    interpret mode, vit_tiny from PRNGKey(8), atol 1e-4; the eager branch
    agrees with the kernel branch to the same tolerance."""
    import sam_quantization_tpu.ops.flash_attention as jfa

    jcfg = JCONFIGS["vit_tiny"]
    jcfg = dataclasses.replace(
        jcfg, image_encoder=dataclasses.replace(jcfg.image_encoder, use_rel_pos=False))
    cfg = TCONFIGS["vit_tiny"]
    cfg = dataclasses.replace(
        cfg, image_encoder=dataclasses.replace(cfg.image_encoder, use_rel_pos=False))
    jmodel = jsam.init(jax.random.PRNGKey(8), jcfg)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    sd = tbuild.from_jax_params(to_np(jmodel.image_encoder), to_np(jmodel.prompt_encoder),
                                to_np(jmodel.mask_decoder), cfg)
    model = tbuild.load_state_dict(tsam.Sam(cfg, device="cpu"), sd)
    x = np.random.default_rng(8).standard_normal((1, 128, 128, 3)).astype(np.float32)
    orig = jfa._fused_attention
    monkeypatch.setattr(jfa, "_fused_attention",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    ref = jie.apply(jmodel.image_encoder, jnp.asarray(x), jcfg.image_encoder,
                    attn_impl="flash")
    with torch.no_grad():
        out = tsam.encode_image(model, torch.from_numpy(x), "kernel")
        eager = tsam.encode_image(model, torch.from_numpy(x), "eager")
    assert tuple(out.shape) == (1, 8, 8, 32) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-4)
    np.testing.assert_allclose(_np(eager), _np(out), atol=1e-4)


def test_predictor_runs_encoder_in_weight_dtype(models):
    """The encoder weights own the compute dtype: a bfloat16 encoder gives a
    bfloat16 embedding within bf16 rounding (rel. L2 <= 5e-2) of the float32
    one, and the masks come back in float32 as before."""
    _, tmodel = models
    image = np.random.default_rng(9).integers(0, 256, (150, 200, 3), dtype=np.uint8)
    bf16 = copy.deepcopy(tmodel)
    bf16.image_encoder.to(torch.bfloat16)
    p32, p16 = TPredictor(tmodel), TPredictor(bf16)
    e32, e16 = p32.set_image(image), p16.set_image(image)
    assert e32.dtype == torch.float32 and e16.dtype == torch.bfloat16
    rel = float((e16.float() - e32).norm() / e32.norm())
    assert rel <= 5e-2, rel
    _, iou, low = p16.predict(np.array([[100.0, 75.0]]), np.array([1.0]))
    assert low.dtype == np.float32 and np.isfinite(low).all() and np.isfinite(iou).all()


def test_rel_pos_resize_is_refused():
    table = torch.zeros(9, 16)
    assert tuple(tie.get_rel_pos(5, 5, table).shape) == (5, 5, 16)
    with pytest.raises(NotImplementedError):
        tie.get_rel_pos(7, 7, table)


def test_port_imports_no_jax():
    """No file of the port, nor chip_smoke.py, imports JAX or the JAX package."""
    files = sorted((REPO / "sam_quantization_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    # \b after the name: "sam_quantization_tpu_torch" does not match
    bad = re.compile(r"^\s*(?:import|from)\s+(?:jax|sam_quantization_tpu)\b", re.M)
    offenders = [str(f) for f in files if bad.search(f.read_text())]
    assert not offenders, offenders
    assert len(files) > 10
    for module in ("nn/packed.py", "ops/quant_matmul.py", "ops/fused_mlp.py",
                   "quant/artifacts.py", "quant/sequential.py", "cli/infer.py",
                   "train/trainer.py", "train/checkpoint.py", "cli/train.py",
                   "data/synthetic.py", "utils/experiment.py", "quant/act_scales.py",
                   "ops/probes.py", "tools/packed_probe.py", "tools/global_stage_probe.py",
                   "native.py", "evaluation/metrics.py", "evaluation/clicker.py",
                   "evaluation/click_eval.py", "evaluation/predictors.py", "data/datasets.py",
                   "utils/config.py", "cli/evaluate.py"):
        assert REPO / "sam_quantization_tpu_torch" / module in files, module
    for src in ("flash_windowed.cu", "flash_attn.cu", "quant_matmul.cu", "fused_mlp.cu",
                "probe_packed.cu", "probe_heads.cu", "host_runtime.cpp"):
        assert os.path.exists(REPO / "sam_quantization_tpu_torch" / "csrc" / src), src
