"""Static activation scales for the cached-int8 serving mode.

Counterpart of ``sam_quantization_tpu/quant/act_scales.py`` (:24-126).
:func:`calibrate_act_scales` records the abs-max of every block linear's
input over calibration batches; the ``{path: amax}`` table feeds
``nn.packed.cache_int8(encoder, act_scales=...)``, so that each of those
layers quantizes its input at a fixed scale instead of per token. It also
records the range of the attention logits, which :func:`check_clamp_window`
holds against the serving kernels' clamp window.

Calibration runs the encoder's eager branch, as JAX calibrates with
``attn_impl="xla"``: forward pre-hooks read the linears' inputs, and the
attention modules' ``logit_observer`` reads the logits after the rel-pos
bias (before it, in a model without rel-pos). Neither changes a number.
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterable

import torch

from sam_quantization_tpu_torch.models.image_encoder import BLOCK_LINEARS

# The kernels' softmax is exp2(clip(s, -60, 64) - 64) on logits pre-scaled by
# log2(e) (ops/flash_attention.py), so in raw logit units the window is:
LOG2E = 1.4426950408889634
CLAMP_CAP_RAW = 64.0 / LOG2E  # ~44.4
CLAMP_FLOOR_RAW = -60.0 / LOG2E  # ~-41.6


def check_clamp_window(min_rowmax: float, max_logit: float, warn: bool = True) -> bool:
    """Whether calibrated logits stay inside the serving kernels' clamp
    window, where their static-shift softmax is exact. A row whose largest
    logit lies below the floor flattens toward uniform; a logit above the
    cap loses the row's true maximum. Warns for each (with ``warn``) and
    returns False if either happens."""
    ok = True
    if min_rowmax < CLAMP_FLOOR_RAW:
        ok = False
        if warn:
            warnings.warn(
                f"attention logits: a row's max logit {min_rowmax:.1f} is below the "
                f"clamped-softmax floor {CLAMP_FLOOR_RAW:.1f}; that row would flatten "
                "toward uniform under the serving kernels. Recalibrate on data the "
                "model serves, or serve this model without the attention kernels.",
                stacklevel=2,
            )
    if max_logit > CLAMP_CAP_RAW:
        ok = False
        if warn:
            warnings.warn(
                f"attention logit max {max_logit:.1f} exceeds the clamped-softmax cap "
                f"{CLAMP_CAP_RAW:.1f}; out-of-range rows squash toward uniform under the "
                "serving kernels. Recalibrate on data the model serves, or serve this "
                "model without the attention kernels.",
                stacklevel=2,
            )
    return ok


def calibrate_act_scales(encoder, batches: Iterable[torch.Tensor], margin: float = 1.0,
                         clamp_canary: bool = True) -> Dict[str, float]:
    """``{block linear path: amax * margin}`` over the calibration batches
    (preprocessed images, (B, H, W, 3), in the encoder's dtype).

    ``encoder`` is an ``ImageEncoderViT``; its paths are
    ``blocks.N.attn.qkv`` and the like, as ``cache_int8`` walks them.
    ``clamp_canary``: also run :func:`check_clamp_window` on the logit range.
    """
    amax: Dict[str, float] = {}
    seen: Dict[str, torch.Tensor] = {}
    logits = []  # per attention call: (min over rows of the row max, max)
    hooks = []

    def record(path):
        def hook(module, args):
            a = args[0].detach().float().abs().amax()
            seen[path] = a if path not in seen else torch.maximum(seen[path], a)
        return hook

    def observe(s: torch.Tensor) -> None:
        s = s.detach().float()
        logits.append(torch.stack([s.amax(dim=-1).amin(), s.amax()]))

    for i, blk in enumerate(encoder.blocks):
        for owner, name in BLOCK_LINEARS:
            path = f"blocks.{i}.{owner}.{name}"
            hooks.append(getattr(getattr(blk, owner), name).register_forward_pre_hook(record(path)))
        blk.attn.logit_observer = observe
    try:
        with torch.no_grad():
            for x in batches:
                seen.clear()
                encoder(x, "eager")
                for path, a in seen.items():
                    amax[path] = max(amax.get(path, 0.0), float(a))
    finally:
        for h in hooks:
            h.remove()
        for blk in encoder.blocks:
            del blk.attn.logit_observer
    if clamp_canary and logits:
        stats = torch.stack(logits)
        check_clamp_window(float(stats[:, 0].min()), float(stats[:, 1].max()))
    return {k: v * margin for k, v in amax.items()}
