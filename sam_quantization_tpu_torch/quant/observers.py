"""Range observers as streaming reductions on tensors.

Counterpart of ``sam_quantization_tpu/quant/observers.py`` (after
fq_vit/models/ptq/observer/{minmax,ema,percentile,omse,ptf}.py). An
:class:`ObserverState` holds a running min / max (scalars layer-wise,
``(C,)`` channel-wise) and is replaced, not mutated, by :func:`update`.
Activations are channels-last, so channel-wise reduces over every leading
axis. :func:`weight_params` takes the channel axis of a torch-layout weight.

The JAX package runs :func:`update` and :func:`get_quantization_params`
inside its jitted calibration step, and the port computes what XLA
compiles there: a division by a constant grid width is the product by its
float32 reciprocal, and the running blend ``a + sigma * (b - a)`` of ema
and percentile is one fused multiply-add (taken in float64, rounded once).
:func:`weight_params` runs eagerly in JAX and divides.

OMSE's 90 range shrinks and PTF's 4 factors, vmapped in JAX, are a loop
here: a ViT-H global block's logits are 1.07 GB in float32, so one
candidate's error is held at a time. ``argmin`` keeps the first minimum.
Percentile uses :func:`quantile`, JAX's interpolation with a float32
position (``torch.quantile`` refuses more than 2^24 elements and
interpolates at a float64 one).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from sam_quantization_tpu_torch.quant.bit_type import BitType

EPS = float(np.finfo(np.float32).eps)
OMSE_STEPS = 90  # shrinks 1.00, 0.99, ..., 0.11 (omse.py:32-56)
PTF_FACTORS = (8.0, 4.0, 2.0, 1.0)  # candidate scales scale8 / f (ptf.py:31-74)


@dataclasses.dataclass
class ObserverState:
    """Running min / max (scalars layer-wise, (C,) channel-wise)."""

    min_val: torch.Tensor
    max_val: torch.Tensor
    initialized: torch.Tensor  # bool scalar


def init_state(channels: Optional[int], device="cpu") -> ObserverState:
    shape = () if channels is None else (channels,)
    return ObserverState(
        min_val=torch.zeros(shape, dtype=torch.float32, device=device),
        max_val=torch.zeros(shape, dtype=torch.float32, device=device),
        initialized=torch.tensor(False, device=device),
    )


def _reduce(x: torch.Tensor, channel_wise: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    if channel_wise:
        flat = xf.reshape(-1, xf.shape[-1])
        return flat.amin(dim=0), flat.amax(dim=0)
    return xf.amin(), xf.amax()


def quantile(flat: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(flat, q)`` ("linear") of a 1-D float32 tensor, as JAX
    computes it: sort, the position ``q * (n - 1)`` in float32, its floor
    and ceil, and ``lo * (1 - w) + hi * w`` with the first product fused
    into the sum (XLA's contraction). A NaN anywhere gives NaN. Any size:
    the values are sorted on their device."""
    s = torch.sort(flat).values
    n = np.float32(flat.numel())
    pos = np.float32(np.float32(q) * np.float32(n - np.float32(1.0)))
    low, high = np.floor(pos), np.ceil(pos)
    hw = np.float32(pos - low)
    lw = np.float32(np.float32(1.0) - hw)
    last = int(n) - 1
    lo = s[min(max(int(low), 0), last)]
    hi = s[min(max(int(high), 0), last)]
    out = _fma(lo, lw, hi * hw)
    return torch.where(torch.isnan(s[-1]), s[-1], out)


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, on any device."""
    return (a.double() * float(b) + c.double()).float()


def _blend(old: torch.Tensor, cur: torch.Tensor, sigma: float) -> torch.Tensor:
    """``old + sigma * (cur - old)``, the fused form XLA compiles."""
    return _fma(cur - old, np.float32(sigma), old)


def update(
    state: ObserverState,
    x: torch.Tensor,
    method: str,
    channel_wise: bool,
    ema_sigma: float = 0.01,
    percentile_alpha: float = 0.99999,
    percentile_sigma: float = 0.01,
) -> ObserverState:
    """One calibration batch (the reference's ``observer.update``)."""
    if method == "percentile":
        # layer-wise only, like the reference (percentile.py:26)
        flat = x.float().reshape(-1)
        cur_max = quantile(flat, percentile_alpha)
        cur_min = quantile(flat, 1.0 - percentile_alpha)
        new_min = _blend(state.min_val, cur_min, percentile_sigma)
        new_max = _blend(state.max_val, cur_max, percentile_sigma)
    else:
        cur_min, cur_max = _reduce(x, channel_wise)
        if method == "ema":
            new_min = _blend(state.min_val, cur_min, ema_sigma)
            new_max = _blend(state.max_val, cur_max, ema_sigma)
        else:  # minmax, omse and ptf all track the running min / max
            new_min = torch.minimum(state.min_val, cur_min)
            new_max = torch.maximum(state.max_val, cur_max)
    first = ~state.initialized
    return ObserverState(
        min_val=torch.where(first, cur_min, new_min),
        max_val=torch.where(first, cur_max, new_max),
        initialized=torch.ones_like(state.initialized),
    )


def _uniform_params(min_val, max_val, bt: BitType, symmetric: bool, divide: bool = False):
    """(scale, zero) of the grid over [min_val, max_val]. The grid width is
    a constant: ``divide`` divides by it (eager JAX), otherwise the range is
    multiplied by its float32 reciprocal (jitted JAX)."""
    qmax, qmin = bt.upper_bound, bt.lower_bound
    width = float(qmax - qmin) / 2 if symmetric else float(qmax - qmin)
    span = torch.maximum(-min_val, max_val) if symmetric else max_val - min_val
    if divide:
        span = span / torch.tensor(width, dtype=torch.float32, device=span.device)
    else:
        span = span * float(np.float32(1.0 / np.float32(width)))
    scale = torch.clamp(span, min=EPS)
    if symmetric:
        return scale, torch.zeros_like(scale)
    zero = torch.clamp(qmin - torch.round(min_val / scale), qmin, qmax)
    return scale, zero


def _fake_quant(x, scale, zero, bt: BitType):
    q = torch.clamp(torch.round(x / scale + zero), bt.lower_bound, bt.upper_bound)
    return (q - zero) * scale


def get_quantization_params(
    state: ObserverState,
    method: str,
    bt: BitType,
    channel_wise: bool,
    inputs: Optional[torch.Tensor] = None,
    symmetric: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final (scale, zero_point). ``inputs`` is the last calibration
    batch, which omse and ptf search on (last_calibrate, fq_vit
    layers.py:56-60)."""
    if symmetric is None:
        symmetric = bt.signed
    min_val, max_val = state.min_val, state.max_val
    qmax, qmin = bt.upper_bound, bt.lower_bound

    if method in ("minmax", "ema", "percentile"):
        return _uniform_params(min_val, max_val, bt, symmetric)

    if method == "omse":
        if inputs is None:
            raise ValueError("omse needs the last calibration batch (inputs)")
        xf = inputs.float()
        shrink = 1.0 - torch.arange(OMSE_STEPS, dtype=torch.float32, device=xf.device) * 0.01
        scores, scales, zeros = [], [], []
        for s in shrink:
            scale, zero = _uniform_params(min_val * s, max_val * s, bt, False)
            err = (_fake_quant(xf, scale, zero, bt) - xf).square_()
            scores.append(err.reshape(-1, err.shape[-1]).sum(dim=0) if channel_wise else err.sum())
            scales.append(scale)
            zeros.append(zero)
        best = torch.argmin(torch.stack(scores), dim=0)
        if channel_wise:
            c = torch.arange(best.numel(), device=best.device)
            return torch.stack(scales)[best, c], torch.stack(zeros)[best, c]
        return torch.stack(scales)[best], torch.stack(zeros)[best]

    if method == "ptf":
        # Power-of-Two Factor (FQ-ViT): one layer-wise 8-bit base scale, then
        # a per-channel factor in {1, 2, 4, 8} chosen by L2 loss.
        if inputs is None:
            raise ValueError("ptf needs the last calibration batch (inputs)")
        xf = inputs.float().reshape(-1, inputs.shape[-1])  # (M, C)
        scale8, zero = _uniform_params(min_val.min(), max_val.max(), bt, False)
        scores = torch.stack([
            (_fake_quant(xf, scale8 / f, zero, bt) - xf).square_().sum(dim=0)
            for f in PTF_FACTORS
        ])  # (4, C)
        best = torch.argmin(scores, dim=0)  # 0 -> factor 1 on the scale1 grid
        scale = (scale8 / 8.0) * torch.exp2(best.float())
        return scale, torch.broadcast_to(zero, scale.shape)

    raise NotImplementedError(method)


def weight_params(w: torch.Tensor, bt: BitType, channel_wise: bool = True,
                  channel_axis: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric or asymmetric (by ``bt.signed``) min-max params of a weight,
    one per output channel, the tensor's ``channel_axis``: 0 for a Linear
    ``(N, K)`` and a Conv2d ``OIHW``, 1 for a ConvTranspose2d ``(I, O, k,
    k)`` (the reference's channel-wise weight observer, minmax.py:15-29).
    Divides, as the JAX package's eager call does."""
    wf = w.float()
    if channel_wise:
        flat = wf.movedim(channel_axis, 0).reshape(wf.shape[channel_axis], -1)
        mn, mx = flat.amin(dim=1), flat.amax(dim=1)
    else:
        mn, mx = wf.amin(), wf.amax()
    return _uniform_params(mn, mx, bt, bt.signed, divide=True)
