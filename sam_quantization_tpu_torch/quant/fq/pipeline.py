"""FQ-ViT full post-training quantization of SAM, in PyTorch.

Counterpart of ``sam_quantization_tpu/quant/fq/pipeline.py`` (the
reference's ``fq_vit`` package): int8 weights (channel-wise, symmetric
minmax), uint8 activations (layer-wise; minmax, ema, percentile or omse),
PTF (power-of-two-factor) channel-wise observers feeding an enabled integer
LayerNorm, and Log-Int-Softmax with uint4 log2 outputs (both short-circuited
to float in the reference, fq_vit layers.py:258, 379, and enabled here as in
JAX).

The model runs with an :class:`FQCtx` as its quantization context:

* ``calib`` mode updates the observer of every point it passes and records
  the new states in ``ctx.updates``; the calibration loop merges them into
  the state it hands the next batch's context (JAX's jitted step returns
  them);
* ``last_calib`` (the last batch) also finalizes ``(scale, zero)`` per point
  into ``ctx.new_qparams``, with OMSE's and PTF's searches on that batch;
* ``quant`` fake-quantizes activations at every calibrated point and runs the
  integer LayerNorm and LIS; weights are fake-quantized once, offline, by
  :func:`fq_quantize_weights`.

Any context but ``NULL_CTX`` sends the encoder down its eager branch, so
calibration and FQ serving launch none of the port's kernels, as JAX's FQ
path reaches no Pallas kernel. Calibration runs in float32 without TF32.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from sam_quantization_tpu_torch.models import sam as sam_lib
from sam_quantization_tpu_torch.nn.layers import Conv2d, ConvTranspose2d, Linear
from sam_quantization_tpu_torch.quant import observers, quantizers
from sam_quantization_tpu_torch.quant.bit_type import BIT_TYPE_DICT, BitType
from sam_quantization_tpu_torch.quant.context import NullCtx
from sam_quantization_tpu_torch.quant.fq import int_ops
from sam_quantization_tpu_torch.quant.sequential import full_float32


@dataclasses.dataclass(frozen=True)
class FQConfig:
    """Counterpart of fq_vit/config.py:4-43."""

    bit_w: BitType = BIT_TYPE_DICT["int8"]
    bit_a: BitType = BIT_TYPE_DICT["uint8"]
    observer_w: str = "minmax"
    observer_a: str = "minmax"  # minmax | ema | percentile | omse
    int_softmax: bool = True  # LIS -> uint4 log2 softmax
    int_norm: bool = True  # PTF -> channel-wise ptf observer on LN inputs
    bit_s: BitType = BIT_TYPE_DICT["uint4"]

    @property
    def observer_a_ln(self) -> str:
        return "ptf" if self.int_norm else self.observer_a

    @property
    def a_ln_channel_wise(self) -> bool:
        return self.int_norm


QParams = Dict[str, Tuple[torch.Tensor, torch.Tensor]]
ObserverStates = Dict[str, observers.ObserverState]


class FQCtx(NullCtx):
    """The quantization context of FQ-ViT (JAX ``FQCtx``, same fall-through
    order at every hook)."""

    def __init__(
        self,
        mode: str,  # "calib" | "last_calib" | "quant"
        cfg: FQConfig,
        state: Optional[ObserverStates] = None,
        qparams: Optional[QParams] = None,
        overrides=None,  # quant.overrides.QuantOverrides: observer / bits / skip per point
    ):
        if mode not in ("calib", "last_calib", "quant"):
            raise ValueError(f"mode must be calib, last_calib or quant, got {mode!r}")
        self.mode = mode
        self.cfg = cfg
        self.state = state or {}
        self.qparams = qparams or {}
        self.overrides = overrides
        self.updates: ObserverStates = {}
        self.new_qparams: QParams = {}
        # quant mode: each LN's path ("int" | "fp"), so that a test can
        # assert that no LayerNorm falls back to float under int_norm
        self.ln_modes: Dict[str, str] = {}

    def _observe(self, path: str, x, method: str, bt: BitType, channel_wise: bool) -> None:
        st = self.state.get(path)
        if st is None:
            st = observers.init_state(x.shape[-1] if channel_wise else None, x.device)
        st = observers.update(st, x, method, channel_wise)
        self.updates[path] = st
        if self.mode == "last_calib":
            self.new_qparams[path] = observers.get_quantization_params(
                st, method, bt, channel_wise, inputs=x)

    def act(self, path: str, x, ln_input: bool = False):
        cfg = self.cfg
        ov = self.overrides.match(path) if self.overrides else None
        if ov is not None and ov.skip:
            return x  # an excluded point stays float end to end
        if ln_input and cfg.int_norm:
            method, channel_wise = cfg.observer_a_ln, True
        else:
            method, channel_wise = cfg.observer_a, False
        if ov is not None and ov.observer and not (ln_input and cfg.int_norm):
            method = ov.observer
        bt = cfg.bit_a
        if ov is not None and ov.bits is not None:
            bt = BIT_TYPE_DICT[f"uint{ov.bits}" if not bt.signed else f"int{ov.bits}"]
        if self.mode != "quant":
            self._observe(path, x, method, bt, channel_wise)
            return x
        if path not in self.qparams:
            # a point calibration never reached (the mask-prompt path under
            # encoder-only calibration) stays float
            return x
        scale, zero = self.qparams[path]
        return quantizers.uniform_fake_quant(x, scale, zero, bt)

    def softmax(self, path: str, attn, scale_path: Optional[str] = None, dim: int = -1):
        cfg = self.cfg
        if self.mode == "quant" and cfg.int_softmax and scale_path in self.qparams:
            return int_ops.log_int_softmax(attn, self.qparams[scale_path][0], cfg.bit_s)
        out = torch.softmax(attn.float(), dim=dim).to(attn.dtype)
        if self.mode != "quant":
            if not cfg.int_softmax:
                # the uniform path observes the softmax output (layers.py:391-398)
                self._observe(path, out, cfg.observer_a, cfg.bit_s, False)
            return out
        if cfg.int_softmax:
            # no calibrated input scale (float logits): log2 quantization only
            return quantizers.log2_fake_quant(out, cfg.bit_s)
        scale, zero = self.qparams[path]  # KeyError for an uncalibrated point, as in JAX
        return quantizers.uniform_fake_quant(out, scale, zero, cfg.bit_s)

    def layer_norm(self, path: str, module, x, in_path: Optional[str] = None,
                   out_path: Optional[str] = None, in_scale_expand: int = 1):
        if (self.mode == "quant" and self.cfg.int_norm and in_path in self.qparams
                and out_path in self.qparams):
            self.ln_modes[path] = "int"
            return int_ops.int_layer_norm(
                x, module.weight, module.bias, in_scale=self.qparams[in_path][0],
                out_scale=self.qparams[out_path][0], in_scale_expand=in_scale_expand)
        if self.mode == "quant":
            self.ln_modes[path] = "fp"
        return module(x)


# ---------------------------------------------------------------------------
# Weights, state and qparams
# ---------------------------------------------------------------------------


@torch.no_grad()
def fq_quantize_weights(module: torch.nn.Module, cfg: FQConfig, inplace: bool = False):
    """Fake-quantize the weight of every ``Linear``, ``Conv2d`` and
    ``ConvTranspose2d`` under ``module`` (int8 channel-wise symmetric minmax,
    the reference's QLinear / QConv2d weights, fq_vit layers.py:96-140,
    180-242), per output channel: dim 0 of a Linear ``(N, K)`` and a Conv2d
    ``OIHW``, dim 1 of a ConvTranspose2d ``(I, O, k, k)`` (JAX quantizes
    each over its last, output, axis). Embeddings, LayerNorms and packed
    linears are left as they are. Works on a deep copy unless ``inplace``."""
    if not inplace:
        module = copy.deepcopy(module)
    for m in module.modules():
        if isinstance(m, (Linear, Conv2d, ConvTranspose2d)):
            axis = 1 if isinstance(m, ConvTranspose2d) else 0
            scale, zero = observers.weight_params(m.weight, cfg.bit_w, channel_axis=axis)
            shape = [1] * m.weight.ndim
            shape[axis] = -1
            m.weight.copy_(quantizers.uniform_fake_quant(
                m.weight, scale.reshape(shape), zero.reshape(shape), cfg.bit_w))
    return module


def qparams_to(qparams, device) -> QParams:
    """``{path: (scale, zero)}`` of arrays (numpy, as
    ``artifacts.load_fq_qparams`` reads them, or the JAX package's) as
    float32 tensors on ``device``."""
    return {k: tuple(torch.tensor(np.asarray(v, np.float32), device=device) for v in sz)
            for k, sz in qparams.items()}


def states_to(states, device) -> ObserverStates:
    """Observer states with ``min_val`` / ``max_val`` / ``initialized``
    arrays (the JAX package's ``ObserverState`` among them) as the port's, on
    ``device``: both packages can then continue one calibration."""
    return {k: observers.ObserverState(
        min_val=torch.tensor(np.asarray(st.min_val, np.float32), device=device),
        max_val=torch.tensor(np.asarray(st.max_val, np.float32), device=device),
        initialized=torch.tensor(bool(np.asarray(st.initialized)), device=device))
        for k, st in states.items()}


# ---------------------------------------------------------------------------
# Calibration (encoder scope)
# ---------------------------------------------------------------------------


def calibrate(run, items: list, fqcfg: FQConfig, overrides=None) -> QParams:
    """Stream ``items`` through ``run(item, ctx)``, the last in
    ``last_calib`` mode; the states carry from batch to batch. Returns the
    qparams of the last batch's context."""
    state: ObserverStates = {}
    qparams: QParams = {}
    with torch.no_grad(), full_float32():
        for i, item in enumerate(items):
            ctx = FQCtx("last_calib" if i == len(items) - 1 else "calib", fqcfg, state,
                        overrides=overrides)
            run(item, ctx)
            state, qparams = {**state, **ctx.updates}, ctx.new_qparams
    return qparams


def calibrate_encoder(encoder, fqcfg: FQConfig, batches: Iterable[torch.Tensor],
                      overrides=None) -> QParams:
    """Stream calibration batches (preprocessed NHWC images) through the
    encoder's eager branch; the last batch finalizes the quantization
    params (fq_vit/test_quant.py:276-292 and model_open_last_calibrate).
    ``overrides``: per-point observer / bits / skip rules
    (``quant.overrides.QuantOverrides``)."""
    return calibrate(lambda x, ctx: encoder(x, "eager", ctx), list(batches), fqcfg, overrides)


def quantize_encoder(encoder, fqcfg: FQConfig, qparams: QParams, overrides=None):
    """(a weight-quantized copy of the encoder, a factory of its quant ctx)."""
    qenc = fq_quantize_weights(encoder, fqcfg)

    def make_ctx():
        return FQCtx("quant", fqcfg, qparams=qparams, overrides=overrides)

    return qenc, make_ctx


# ---------------------------------------------------------------------------
# Full SAM: the reference calibrates through a one-click SAM forward
# (fq_vit/test_quant.py:141-204 calibrate_forward), so the decoder's points
# see click-conditioned activations.
# ---------------------------------------------------------------------------


def _one_click(gt: np.ndarray, max_points: int) -> Tuple[np.ndarray, np.ndarray]:
    """One positive click at the gt's centre of mass in ``max_points`` slots."""
    ys, xs = np.nonzero(gt)
    cy, cx = (int(ys.mean()), int(xs.mean())) if len(ys) else (0, 0)
    coords = np.zeros((1, max_points, 2), np.float32)
    labels = -np.ones((1, max_points), np.float32)
    coords[0, 0] = (cx, cy)
    labels[0, 0] = 1.0
    return coords, labels


def _sam_forward(model: sam_lib.Sam, img: np.ndarray, gt: np.ndarray, max_points: int, ctx):
    """Encode ``img`` (raw pixels, NHWC) and decode one click with a zero
    mask prompt, all through ``ctx`` (the reference calibrates with
    masks=low_res_masks, zeros before the first click,
    fq_vit/test_quant.py:182-187)."""
    dev = model.device
    coords, labels = _one_click(gt, max_points)
    x = torch.as_tensor(np.asarray(img, np.float32), device=dev)
    emb = sam_lib.encode_image(model, sam_lib.preprocess(model, x), "eager", ctx)
    h, w = model.config.prompt_encoder.image_embedding_size
    zero_mask = torch.zeros((x.shape[0], 4 * h, 4 * w, 1), device=dev)
    sam_lib.decode_masks(model, emb, points=(torch.from_numpy(coords).to(dev),
                                             torch.from_numpy(labels).to(dev)),
                         mask_inputs=zero_mask, multimask_output=False, ctx=ctx)


def calibrate_sam(model: sam_lib.Sam, samples, fqcfg: FQConfig, max_points: int = 24,
                  overrides=None) -> QParams:
    """Calibrate the encoder's and the decoder's points with a one-click
    forward per sample. ``samples``: (image (1, S, S, 3) float, gt mask
    (S, S)) pairs; the click lands at the gt's centre of mass. ``overrides``:
    per-point rules (quant.overrides), the reference's per-op
    init_quantize_config overrides (script/custimized_quant.py:56-147)."""
    return calibrate(lambda s, ctx: _sam_forward(model, s[0], s[1], max_points, ctx),
                      list(samples), fqcfg, overrides)


def quantize_sam(model: sam_lib.Sam, fqcfg: FQConfig, qparams: QParams, overrides=None):
    """(a copy of the model with every weight fake-quantized, a factory of
    its quant ctx)."""
    qmodel = fq_quantize_weights(model, fqcfg)

    def make_ctx():
        return FQCtx("quant", fqcfg, qparams=qparams, overrides=overrides)

    return qmodel, make_ctx


class _SnrCtx(FQCtx):
    """Quant mode that sums, per point, the squared input and the squared
    quantization error of what the point sees."""

    def __init__(self, fqcfg: FQConfig, qparams: QParams):
        super().__init__("quant", fqcfg, qparams=qparams)
        self.err: Dict[str, torch.Tensor] = {}
        self.pw: Dict[str, torch.Tensor] = {}

    def act(self, path, x, ln_input=False):
        y = super().act(path, x, ln_input=ln_input)
        xf = x.float()
        self.err[path] = self.err.get(path, 0.0) + torch.sum((xf - y.float()).square())
        self.pw[path] = self.pw.get(path, 0.0) + torch.sum(xf.square())
        return y


def fq_pointwise_snr(model: sam_lib.Sam, samples, fqcfg: FQConfig, qparams: QParams,
                     max_points: int = 24) -> Dict[str, float]:
    """Diagnose: each observation point's local quantization SNR under the
    ``quant`` ctx, 10 log10(|x|^2 / |x - q(x)|^2) of the activation it sees
    (downstream of all upstream quantization); the FQ analog of
    layerwise_error_analyse (ref script/analysis.py:596-625). Feed the worst
    points to ``quant.overrides.QuantOverrides`` and recalibrate.

    Returns {path: snr_db} sorted ascending (worst first)."""
    err: Dict[str, float] = {}
    pw: Dict[str, float] = {}
    with torch.no_grad(), full_float32():
        for img, gt in samples:
            ctx = _SnrCtx(fqcfg, qparams)
            _sam_forward(model, img, gt, max_points, ctx)
            for k in ctx.err:
                err[k] = err.get(k, 0.0) + float(ctx.err[k])
                pw[k] = pw.get(k, 0.0) + float(ctx.pw[k])
    snr = {k: 10.0 * np.log10(max(pw[k], 1e-30) / max(err[k], 1e-30)) for k in err}
    return dict(sorted(snr.items(), key=lambda kv: kv[1]))
