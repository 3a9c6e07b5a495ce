"""Port parity of the FQ-ViT encoder pipeline on vit_tiny, on the CPU:
calibration in the configurations ``tests/test_quant_pipelines.py`` runs,
the quant-mode encoder, the routing of a quantization context away from the
kernels, and graphwise analysis through an FQ context (the full SAM is
``test_torch_fq_sam.py``).

The JAX package's calibrations run jitted, as its pipeline runs them. Its
quant-mode forwards run jitted with the qparams as arguments (the same
numbers as its eager forward, measured; with the qparams closed over as
constants XLA turns ``x / scale`` into a reciprocal product, which moves a
SAM embedding by 2%, as the JAX CLI serves it). Tolerances:

* calibration: the same points; scales rel 1e-6 (the float forwards differ
  in float32 sum order: 4e-7 measured), zeros equal, PTF factors equal on
  every channel;
* quant-mode encoder: rel L2 1e-2 (measured 0: bit-equal), and
  point by point: fed JAX's input at each point, the port's point outputs
  are bit-equal, and its inputs between two points differ from JAX's by
  float rounding only (rel 1e-5);
* the float-LN configuration runs past 1e-2 (3.7e-2), traced and asserted
  as such: a cascade that starts at ``qact_embed``, whose input differs by
  the patch embed's float32 sum order (3.4e-7) and moves one of its 4,096
  values across a rounding boundary; each later block adds such flips.
  With the integer LN (PTF re-grids each LN input) the same forward is
  bit-equal;
* graphwise SNRs: 0.05 dB against JAX's analysis with the qparams as
  arguments; JAX's own ``graphwise_error_analyse`` closes over them (0.19 dB
  apart, measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_quantization_tpu.models import image_encoder as jie
from sam_quantization_tpu.models.configs import VIT_TINY
from sam_quantization_tpu.quant import analysis as janalysis
from sam_quantization_tpu.quant.fq import pipeline as jp
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.ops import flash_attention as tfa
from sam_quantization_tpu_torch.ops import fused_mlp as tfm
from sam_quantization_tpu_torch.quant import analysis as tanalysis
from sam_quantization_tpu_torch.quant.context import NULL_CTX
from sam_quantization_tpu_torch.quant.fq import pipeline as tp

ECFG = VIT_TINY.image_encoder
SCALE_RTOL = 1e-6
QUANT_TOL = 1e-2
GAP_TOL = 1e-5
SNR_TOL = 0.05
CONFIGS = {
    "ptf_lis_minmax": {},
    "ema_no_int_ops": dict(int_softmax=False, int_norm=False, observer_a="ema"),
    "ema": dict(observer_a="ema"),
    "percentile": dict(observer_a="percentile"),
    "omse": dict(observer_a="omse"),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port_encoder(params):
    return tbuild.load_jax_encoder(tsam.Sam(TCONFIGS["vit_tiny"], device="cpu"),
                                   _np_tree(params)).image_encoder


@pytest.fixture(scope="module")
def setup():
    """``tests/test_quant_pipelines.py``'s vit_tiny and three calibration
    batches, with the rel-pos tables filled too (so that the rel-pos
    quantizer sees its own range), in both packages."""
    rng = np.random.default_rng(0)
    params = jax.jit(lambda k: jie.init(k, ECFG))(jax.random.PRNGKey(0))
    params["pos_embed"] = jnp.asarray(
        rng.normal(size=params["pos_embed"].shape).astype(np.float32) * 0.02)
    xs = [rng.normal(size=(1, ECFG.img_size, ECFG.img_size, 3)).astype(np.float32)
          for _ in range(3)]
    for blk in params["blocks"]:
        for k in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][k] = jnp.asarray(rng.normal(size=blk["attn"][k].shape).astype(np.float32) * 0.2)
    return params, _port_encoder(params), xs


@pytest.fixture(scope="module")
def calibrated(setup):
    """One calibration per configuration in each package, made on first use."""
    params, enc, xs = setup
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, tcfg = jp.FQConfig(**CONFIGS[name]), tp.FQConfig(**CONFIGS[name])
            qj = jp.calibrate_encoder(params, ECFG, jcfg, [jnp.asarray(x) for x in xs])
            qt = tp.calibrate_encoder(enc, tcfg, [torch.from_numpy(x) for x in xs])
            cache[name] = (jcfg, tcfg, qj, qt)
        return cache[name]

    return get


def _assert_qparams_match(qt, qj):
    assert sorted(qt) == sorted(qj)
    for k, (sj, zj) in qj.items():
        st, zt = (v.numpy() for v in qt[k])
        sj, zj = np.asarray(sj), np.asarray(zj)
        assert st.shape == sj.shape, k
        np.testing.assert_allclose(st, sj, rtol=SCALE_RTOL, atol=0, err_msg=k)
        np.testing.assert_array_equal(zt, zj, err_msg=k)
        if sj.ndim == 1:  # PTF: power-of-two factors over the smallest scale
            np.testing.assert_array_equal(np.round(st / st.min()), np.round(sj / sj.min()),
                                          err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_calibrate_encoder_matches_jax(calibrated, name):
    jcfg, _, qj, qt = calibrated(name)
    _assert_qparams_match(qt, qj)
    ln_point = qt["blocks.0.qact2"][0]
    assert ln_point.shape == ((ECFG.embed_dim,) if jcfg.int_norm else ())
    if jcfg.int_norm:
        ratios = (ln_point / ln_point.min()).numpy()
        np.testing.assert_allclose(ratios, 2 ** np.round(np.log2(ratios)), rtol=1e-6)
    assert ("blocks.0.attn.softmax" in qt) == (not jcfg.int_softmax)


class _JaxRecorder(jp.FQCtx):
    """JAX quant mode that keeps every point's input and output."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.rec = {}

    def act(self, path, x, ln_input=False):
        y = super().act(path, x, ln_input=ln_input)
        self.rec[path] = (x, y)
        return y

    def softmax(self, path, attn, scale_path=None, axis=-1):
        y = super().softmax(path, attn, scale_path=scale_path, axis=axis)
        self.rec[path] = (attn, y)
        return y


class _Forced(tp.FQCtx):
    """Port quant mode that records each point's input and output; given
    JAX's record, it also runs each point on JAX's input instead of its own
    and keeps the gap between the two."""

    def __init__(self, rec, *a, **k):
        super().__init__(*a, **k)
        self.rec, self.gaps, self.inputs, self.outputs = rec, {}, {}, {}

    def _force(self, path, x):
        self.inputs[path] = x.numpy().copy()
        if self.rec is None:
            return x
        want = self.rec[path][0]
        self.gaps[path] = _rel(x.numpy(), want) if np.any(want) else 0.0
        return torch.from_numpy(want.copy())

    def act(self, path, x, ln_input=False):
        y = super().act(path, self._force(path, x), ln_input=ln_input)
        self.outputs[path] = y.numpy().copy()
        return y

    def softmax(self, path, attn, scale_path=None, dim=-1):
        y = super().softmax(path, self._force(path, attn), scale_path=scale_path, dim=dim)
        self.outputs[path] = y.numpy().copy()
        return y


@pytest.mark.parametrize("name,cascade", [("ptf_lis_minmax", False), ("ema_no_int_ops", True)])
def test_quant_encoder_matches_jax(setup, calibrated, name, cascade):
    """Both packages take JAX's qparams and ``fq_quantize_weights`` of the
    same weights (equal in both); the port's encoder runs under
    ``FQCtx("quant")`` (``attn_impl="kernel"``: it runs eager). Every LN
    runs as ``ln_modes`` says, the same in both."""
    params, enc, xs = setup
    jcfg, tcfg, qj, _ = calibrated(name)
    wq = jp.fq_quantize_weights(params, jcfg)
    tw = tp.fq_quantize_weights(enc, tcfg)
    want_sd = _port_encoder(wq).state_dict()
    assert all(torch.equal(v, want_sd[k]) for k, v in tw.state_dict().items())

    holder = {}

    def run(p, qp, x):
        holder["ctx"] = ctx = _JaxRecorder("quant", jcfg, qparams=qp)
        return jie.apply(p, x, ECFG, ctx, attn_impl="xla"), ctx.rec

    oj, rec = jax.jit(run)(wq, qj, jnp.asarray(xs[0]))
    oj, rec = np.asarray(oj), {k: tuple(np.asarray(v) for v in xy) for k, xy in rec.items()}
    free = _Forced(None, "quant", tcfg, qparams=tp.qparams_to(qj, "cpu"))
    with torch.no_grad():
        ot = tw(torch.from_numpy(xs[0]), "kernel", free).numpy()
    assert free.ln_modes == holder["ctx"].ln_modes
    assert len(free.ln_modes) == 2 * ECFG.depth + 2
    assert set(free.ln_modes.values()) == {"int" if jcfg.int_norm else "fp"}

    forced = _Forced(rec, "quant", tcfg, qparams=tp.qparams_to(qj, "cpu"))
    with torch.no_grad():
        tw(torch.from_numpy(xs[0]), "eager", forced)
    assert sorted(forced.outputs) == sorted(rec)  # (JAX's record comes back key-sorted)
    for path, (_, y) in rec.items():
        np.testing.assert_array_equal(forced.outputs[path], y, err_msg=path)
    assert max(forced.gaps.values()) <= GAP_TOL, max(forced.gaps.items(), key=lambda kv: kv[1])

    if not cascade:
        assert _rel(ot, oj) <= QUANT_TOL
        return
    # The traced cascade: the first point that differs free running is
    # qact_embed, on an input within float32 rounding, one grid step apart.
    first = next(p for p in free.outputs if not np.array_equal(free.outputs[p], rec[p][1]))
    assert first == "qact_embed" and _rel(free.inputs[first], rec[first][0]) <= 1e-6
    steps = np.abs(free.outputs[first] - rec[first][1])
    np.testing.assert_allclose(steps[steps > 0], float(qj[first][0]), rtol=1e-5)
    assert (steps > 0).sum() <= steps.size // 1000
    assert np.isfinite(ot).all() and QUANT_TOL < _rel(ot, oj) < 0.1


def test_fq_context_runs_the_eager_branch(setup, calibrated, monkeypatch):
    """Under an FQ context the encoder reaches none of the kernel wrappers
    whatever ``attn_impl`` says (its softmax hook runs once per block);
    under ``NULL_CTX`` the same encoder takes them as before."""
    _, enc, xs = setup
    _, tcfg, qj, _ = calibrated("ptf_lis_minmax")
    calls = []
    for mod, name in ((tfa, "flash_attention_qkv_packed"), (tfa, "flash_attention_relpos"),
                      (tfa, "flash_attention_relpos_trainable"), (tfm, "fused_mlp")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)

    class Counting(tp.FQCtx):
        softmaxes = 0

        def softmax(self, *a, **k):
            Counting.softmaxes += 1
            return super().softmax(*a, **k)

    x = torch.from_numpy(xs[0])
    with torch.no_grad():
        for impl in ("kernel", "flash_train", "eager"):
            Counting.softmaxes = 0
            enc(x, impl, Counting("quant", tcfg, qparams=tp.qparams_to(qj, "cpu")))
            assert calls == [] and Counting.softmaxes == ECFG.depth, impl
        enc(x, "kernel", NULL_CTX)
    assert calls == ["flash_attention_qkv_packed", "flash_attention_relpos"] * (ECFG.depth // 2)


def test_graphwise_analysis_through_fq_context_matches_jax(setup, calibrated):
    """``graphwise_error_analyse(..., q_ctx=FQCtx("quant"))``: the same ops
    (every linear and conv) as JAX's, and SNRs within 0.05 dB of JAX's
    analysis (its capture context and ``snr_db``) with the qparams as
    arguments."""
    params, enc, xs = setup
    jcfg, tcfg, qj, _ = calibrated("ptf_lis_minmax")
    wq = jp.fq_quantize_weights(params, jcfg)
    gj = janalysis.graphwise_error_analyse(params, wq, ECFG, [jnp.asarray(xs[0])],
                                           q_ctx=jp.FQCtx("quant", jcfg, qparams=qj))

    def run_pair(x, qp):
        cf = janalysis.OutputCaptureCtx()
        jie.apply(params, x, ECFG, cf, attn_impl="xla")
        cq = janalysis.OutputCaptureCtx(jp.FQCtx("quant", jcfg, qparams=qp))
        jie.apply(wq, x, ECFG, cq, attn_impl="xla")
        return {k: janalysis.snr_db(cf.outputs[k], cq.outputs[k]) for k in cf.outputs}

    want = {k: float(v) for k, v in jax.jit(run_pair)(jnp.asarray(xs[0]), qj).items()}
    gt = tanalysis.graphwise_error_analyse(enc, tp.fq_quantize_weights(enc, tcfg),
                                           [torch.from_numpy(xs[0])],
                                           q_ctx=tp.FQCtx("quant", tcfg, qparams=tp.qparams_to(qj, "cpu")))
    assert sorted(gt) == sorted(gj) == sorted(want) and len(gt) == 4 * ECFG.depth + 3
    for k in want:
        assert abs(gt[k] - want[k]) <= SNR_TOL, (k, gt[k], want[k])
