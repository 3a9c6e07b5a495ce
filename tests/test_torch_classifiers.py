"""Port parity of the FQ-ViT image classifiers (``models/vit_classifier``,
``models/swin_classifier``) and ``cli.test_quant`` against the JAX package,
on the CPU.

The configurations are ``tests/test_quant_pipelines.py``'s small ones (a
distilled ViT of 2 blocks at 32x32; Swin with 2-2 blocks so that a shifted
window, the cross-region mask and a stage whose window is its whole
resolution all run), plus a plain ViT for the float logits. JAX's parameters come from its own
``init`` and cross to the port through ``from_jax_params``; inputs are
seeded numpy arrays. JAX's calibrations run jitted, as its
``calibrate_classifier`` runs them; its quant-mode forward runs jitted with
the qparams as arguments (as ``tests/test_torch_fq_encoder.py``: closed over
as constants, XLA turns ``x / scale`` into a reciprocal product, which its
``cli/test_quant.py`` does). Tolerances:

* float32 logits: rel. L2 1e-5 (the two sum in other orders);
* calibration: the same points, scales rel 1e-6 (``SCALE_RTOL``), zeros
  equal;
* fake-quantized weights: equal (the same per-channel minmax grid);
* quant-mode logits on JAX's qparams: rel. L2 ``QUANT_TOL`` 1e-2.
"""

import functools
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_quantization_tpu.models import swin_classifier as jswin
from sam_quantization_tpu.models import vit_classifier as jvit
from sam_quantization_tpu.quant.fq import pipeline as jp
from sam_quantization_tpu_torch.cli import test_quant as tcli
from sam_quantization_tpu_torch.models import swin_classifier as tswin
from sam_quantization_tpu_torch.models import vit_classifier as tvit
from sam_quantization_tpu_torch.quant.fq import pipeline as tp

FLOAT_TOL = 1e-5
SCALE_RTOL = 1e-6
QUANT_TOL = 1e-2

CASES = {
    "deit": (jvit, tvit, jvit.ViTClassifierConfig(
        img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2, num_classes=10,
        distilled=True)),
    "vit": (jvit, tvit, jvit.ViTClassifierConfig(
        img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2, num_classes=10)),
    "swin": (jswin, tswin, jswin.SwinConfig(
        img_size=32, patch_size=4, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
        window_size=4, num_classes=10)),
}
FQ_CASES = ["deit", "swin"]  # the plain ViT's points are a subset of DeiT's


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port_cfg(tmod, cfg):
    """The port's own config dataclass with the JAX config's fields."""
    cls = tmod.SwinConfig if tmod is tswin else tmod.ViTClassifierConfig
    return cls(**{f: getattr(cfg, f) for f in cls.__dataclass_fields__})


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small models: more torch threads only slow them on a CPU shared with
    other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case(request):
    """(name, JAX module, JAX config, JAX params, port model, batches)."""
    jmod, tmod, cfg = CASES[request.param]
    params = jax.jit(lambda key: jmod.init(key, cfg))(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = _port_cfg(tmod, cfg)
    model = tmod.init(tcfg, seed=0, device="cpu")
    sd = tmod.from_jax_params(np_params, tcfg)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    # only buffers stay (the rel-pos index and shift masks the model builds)
    assert not unexpected and all("relative_position_index" in k or "attn_mask" in k
                                  for k in missing), (missing, unexpected)
    rng = np.random.default_rng(7)
    batches = [rng.normal(size=(2, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
               for _ in range(2)]
    return request.param, jmod, cfg, params, model, batches


@pytest.fixture(scope="module")
def calibrated(case):
    """JAX's qparams (its jitted calibration) and the port's, minmax + PTF + LIS."""
    name, jmod, cfg, params, model, batches = case
    fqcfg = jp.FQConfig()
    jqp = jmod.calibrate_classifier(params, cfg, fqcfg, map(jnp.asarray, batches)) \
        if jmod is jvit else _jax_calibrate_swin(params, cfg, fqcfg, batches)
    tqp = tvit.calibrate_classifier(model, tp.FQConfig(), map(torch.from_numpy, batches))
    return jqp, tqp


@pytest.fixture(scope="module")
def jax_wq(case):
    """JAX's fake-quantized weights, computed eagerly as its CLI does (under
    jit XLA rounds some of them otherwise)."""
    return jp.fq_quantize_weights(case[3], jp.FQConfig())


def _jax_calibrate_swin(params, cfg, fqcfg, batches):
    """``tests/test_quant_pipelines.py``'s jitted Swin calibration step."""

    @functools.partial(jax.jit, static_argnames=("mode",))
    def step(params, x, state, mode):
        ctx = jp.FQCtx(mode, fqcfg, state)
        jswin.apply(params, x, cfg, ctx)
        return {**state, **ctx.updates}, ctx.new_qparams

    state, qp = {}, {}
    for i, x in enumerate(batches):
        state, qp = step(params, jnp.asarray(x), state,
                         "last_calib" if i == len(batches) - 1 else "calib")
    return qp


@pytest.mark.parametrize("case", list(CASES), indirect=True)
def test_float_logits_match_jax(case):
    name, jmod, cfg, params, model, batches = case
    want = np.asarray(jax.jit(lambda p, x: jmod.apply(p, x, cfg))(params,
                                                                  jnp.asarray(batches[0])))
    with torch.no_grad():
        got = model(torch.from_numpy(batches[0])).numpy()
    assert got.shape == (2, 10) and np.isfinite(got).all()
    assert _rel(got, want) <= FLOAT_TOL, _rel(got, want)


@pytest.mark.parametrize("case", FQ_CASES, indirect=True)
def test_fq_calibration_matches_jax(calibrated):
    """The same observation points (JAX's path strings), scales within
    SCALE_RTOL, zero points equal."""
    jqp, tqp = calibrated
    assert set(tqp) == set(jqp)
    for k, (js, jz) in jqp.items():
        ts, tz = (v.numpy() for v in tqp[k])
        np.testing.assert_allclose(ts, np.asarray(js), rtol=SCALE_RTOL, atol=0, err_msg=k)
        np.testing.assert_array_equal(tz, np.asarray(jz), err_msg=k)


@pytest.mark.parametrize("case", FQ_CASES, indirect=True)
def test_fq_weights_match_jax(case, jax_wq):
    """fq_quantize_weights takes every weight JAX's walk quantizes (convs
    and linears, heads included; not the Swin bias tables) onto the same
    grid."""
    name, jmod, cfg, params, model, batches = case
    want = _port_state(jmod, cfg, jax_wq)
    got = tp.fq_quantize_weights(model, tp.FQConfig()).state_dict()
    changed = 0
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w.numpy(), err_msg=k)
        changed += not torch.equal(model.state_dict()[k], w)
    n_weights = sum(k.endswith("weight") and w.ndim in (2, 4) for k, w in want.items())
    assert changed == n_weights, (changed, n_weights)


def _port_state(jmod, cfg, params):
    tmod = tswin if jmod is jswin else tvit
    return tmod.from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                _port_cfg(tmod, cfg))


@pytest.mark.parametrize("case", FQ_CASES, indirect=True)
def test_fq_quant_logits_match_jax(case, calibrated, jax_wq):
    """The quant-mode logits of the weight-quantized port model on JAX's
    qparams against JAX's, within QUANT_TOL; every LayerNorm JAX runs as
    the integer LN runs so in the port."""
    name, jmod, cfg, params, model, batches = case
    jqp, _ = calibrated
    fqcfg = jp.FQConfig()
    traced = {}

    @jax.jit
    def q_fn(p, x, qp):
        traced["ctx"] = jp.FQCtx("quant", fqcfg, qparams=qp)
        return jmod.apply(p, x, cfg, traced["ctx"])

    want = np.asarray(q_fn(jax_wq, jnp.asarray(batches[0]), jqp))
    tq = tp.fq_quantize_weights(model, tp.FQConfig())
    ctx = tp.FQCtx("quant", tp.FQConfig(), qparams=tp.qparams_to(
        jax.tree_util.tree_map(np.asarray, jqp), "cpu"))
    with torch.no_grad():
        got = tq(torch.from_numpy(batches[0]), ctx).numpy()
    assert ctx.ln_modes == traced["ctx"].ln_modes  # as the trace left them
    assert np.isfinite(got).all() and _rel(got, want) <= QUANT_TOL, _rel(got, want)


def test_every_config_builds():
    """Every published configuration builds (on the meta device) with JAX's
    parameter count, and its JAX tree's names cover the port's parameters."""
    for name, cfg in {**tvit.CLASSIFIER_CONFIGS, **tswin.SWIN_CONFIGS}.items():
        jmod, tmod = (jswin, tswin) if name.startswith("swin") else (jvit, tvit)
        jcfg = (jmod.SWIN_CONFIGS if jmod is jswin else jmod.CLASSIFIER_CONFIGS)[name]
        assert _port_cfg(tmod, jcfg) == cfg, name
        shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jcfg))
        n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
        cls = tswin.SwinTransformer if tmod is tswin else tvit.VisionTransformer
        model = cls(cfg, device="meta")
        n_port = sum(p.numel() for p in model.parameters())
        assert n_port == n_jax, (name, n_port, n_jax)


@pytest.mark.parametrize("model", ["deit_tiny", "swin_tiny"])
def test_cli_test_quant(model):
    """``cli.test_quant`` at full width on the CPU, with few small batches:
    JAX's JSON keys and flags; agreements are shares. Its random weights are
    the port's own (a torch.Generator), so its figures are not JAX's."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = tcli.main([model, "--calib-iter", "2", "--calib-batchsize", "1",
                        "--val-batches", "1", "--platform", "cpu", "--quant-method", "minmax"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0
    assert list(out) == ["model", "ptf", "lis", "quant_method", "fp_agreement_top1",
                         "fp_agreement_top5"]
    assert out["model"] == model and out["ptf"] and out["lis"]
    assert 0.0 <= out["fp_agreement_top1"] <= out["fp_agreement_top5"] <= 1.0
