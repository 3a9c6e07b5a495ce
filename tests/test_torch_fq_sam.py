"""Port parity of FQ-ViT on the whole vit_tiny SAM, on the CPU: one-click
calibration (``calibrate_sam``), the quantized model's encode and decode
(``quantize_sam``), the pointwise-SNR diagnosis and a skip override, against
the JAX package on its seeded weights carried across.

JAX's calibrations run jitted, as its pipeline runs them; its quant-mode
forward runs jitted with the qparams as arguments (``test_torch_fq_encoder.py``
says why). Tolerances: scales rel 1e-6, zeros equal; embedding, low-res
logits and IoU rel L2 1e-2 (measured bit-equal embedding); pointwise SNRs:
the same points and the same five worst in order (JAX's diagnosis closes
over its qparams, which moves single points by up to 3 dB).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.models.configs import VIT_TINY
from sam_quantization_tpu.quant.fq import pipeline as jp
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.quant import overrides as toverrides
from sam_quantization_tpu_torch.quant.fq import pipeline as tp

QUANT_TOL = 1e-2
SCALE_RTOL = 1e-6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


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


def _samples(rng, n=2):
    size = VIT_TINY.image_encoder.img_size
    out = []
    for _ in range(n):
        img = rng.normal(size=(1, size, size, 3)).astype(np.float32) * 30 + 100
        gt = np.zeros((size, size), np.int32)
        gt[40:90, 30:80] = 1
        out.append((img, gt))
    return out


@pytest.fixture(scope="module")
def sam_pair():
    """JAX's seeded vit_tiny SAM and the port's holding its weights, two
    calibration samples (tests/test_quant_pipelines.py), and both packages'
    ``calibrate_sam`` under the default FQ config."""
    jm = jax.jit(lambda k: jsam.init(k, VIT_TINY))(jax.random.PRNGKey(0))
    sd = tbuild.from_jax_params(_np_tree(jm.image_encoder), _np_tree(jm.prompt_encoder),
                                _np_tree(jm.mask_decoder), TCONFIGS["vit_tiny"])
    tm = tbuild.load_state_dict(tsam.Sam(TCONFIGS["vit_tiny"], device="cpu"), sd)
    samples = _samples(np.random.default_rng(0))
    qj = jp.calibrate_sam(jm, samples, jp.FQConfig())
    qt = tp.calibrate_sam(tm, samples, tp.FQConfig())
    return jm, tm, samples, qj, qt


def test_full_sam_calibration_and_decode_match_jax(sam_pair):
    """The decoder-side, transformer and mask-prompt points calibrate as in
    JAX; the quantized model encodes and decodes one click with a zero mask
    prompt as JAX's does; no LayerNorm anywhere runs float."""
    jm, tm, samples, qj, qt = sam_pair
    _assert_qparams_match(qt, qj)
    assert any(k.startswith("mask_decoder.") for k in qt)
    assert any(k.startswith("transformer.") for k in qt)
    assert "prompt_encoder.qact_mln1_in" in qt
    jq, _ = jp.quantize_sam(jm, jp.FQConfig(), qj)
    tq, make_ctx = tp.quantize_sam(tm, tp.FQConfig(), tp.qparams_to(qj, "cpu"))
    size = VIT_TINY.image_encoder.img_size
    h, w = VIT_TINY.prompt_encoder.image_embedding_size
    coords = np.zeros((1, 4, 2), np.float32)
    coords[0, 0] = (50.0, 60.0)
    labels = -np.ones((1, 4), np.float32)
    labels[0, 0] = 1.0
    zero_mask = np.zeros((1, 4 * h, 4 * w, 1), np.float32)
    holder = {}

    def run(model, qp, x):
        holder["ctx"] = ctx = jp.FQCtx("quant", jp.FQConfig(), qparams=qp)
        emb = jsam.encode_image(model, jsam.preprocess(model, x), ctx, attn_impl="xla")
        low, iou = jsam.decode_masks(model, emb, points=(jnp.asarray(coords), jnp.asarray(labels)),
                                     mask_inputs=jnp.asarray(zero_mask), multimask_output=False,
                                     ctx=ctx)
        return emb, low, iou

    ej, lj, ij = jax.jit(run)(jq, qj, jnp.asarray(samples[0][0]))
    ctx = make_ctx()
    with torch.no_grad():
        et = tsam.encode_image(tq, tsam.preprocess(tq, torch.from_numpy(samples[0][0])), ctx=ctx)
        lt, it = tsam.decode_masks(tq, et, points=(torch.from_numpy(coords), torch.from_numpy(labels)),
                                   mask_inputs=torch.from_numpy(zero_mask), multimask_output=False,
                                   ctx=ctx)
    assert lt.shape == (1, 1, 4 * h, 4 * w) and size == 4 * 4 * h
    for got, want in ((et, ej), (lt, lj), (it, ij)):
        assert _rel(got.numpy(), want) <= QUANT_TOL
    assert ctx.ln_modes == holder["ctx"].ln_modes
    assert ctx.ln_modes and not [k for k, v in ctx.ln_modes.items() if v != "int"]
    for part in ("neck.", "norm_final", "mask_decoder.up_ln", "prompt_encoder.mask_ln"):
        assert any(part in k for k in ctx.ln_modes), part


def test_pointwise_snr_and_skip_override_match_jax(sam_pair):
    """``fq_pointwise_snr``: the same points, worst first, the same five
    worst; a skip override on ``blocks.1.qact2`` leaves exactly that point
    out of the qparams and sends exactly ``blocks.1.norm2`` to float (JAX's
    ``tests/test_quant_pipelines.py:270-300``, on the port)."""
    jm, tm, samples, qj, _ = sam_pair
    jq, _ = jp.quantize_sam(jm, jp.FQConfig(), qj)
    tq, _ = tp.quantize_sam(tm, tp.FQConfig(), tp.qparams_to(qj, "cpu"))
    sj = jp.fq_pointwise_snr(jq, samples[:1], jp.FQConfig(), qj)
    st = tp.fq_pointwise_snr(tq, samples[:1], tp.FQConfig(), tp.qparams_to(qj, "cpu"))
    assert sorted(st) == sorted(sj) and len(st) > 30
    assert list(st.values()) == sorted(st.values()) and all(np.isfinite(list(st.values())))
    assert list(st)[:5] == list(sj)[:5]

    target = "blocks.1.qact2"
    assert target in st
    ov = toverrides.QuantOverrides().add(target, skip=True)
    q2t = tp.calibrate_sam(tm, samples, tp.FQConfig(), overrides=ov)
    assert sorted(q2t) == sorted(k for k in qj if k != target)
    tq2, make_ctx = tp.quantize_sam(tm, tp.FQConfig(), q2t, overrides=ov)
    ctx = make_ctx()
    with torch.no_grad():
        tsam.encode_image(tq2, tsam.preprocess(tq2, torch.from_numpy(samples[0][0])), ctx=ctx)
    assert ctx.ln_modes["blocks.1.norm2"] == "fp"
    others = {k: v for k, v in ctx.ln_modes.items() if k != "blocks.1.norm2"}
    assert others and all(v == "int" for v in others.values()), others


