"""Uniform and log2 fake-quantizers on tensors.

Counterpart of ``sam_quantization_tpu/quant/quantizers.py`` (after
fq_vit/models/ptq/quantizer/{uniform,log2}.py), in the same op order:
``torch.round`` rounds half to even as ``jnp.round`` does, and the ``1e-30``
floors stay. Arithmetic is float32; ``scale`` and ``zero`` are tensors (or
numbers) that broadcast against the input's last axis. The fake-quantizer
works in place on its one float32 temporary, which keeps the memory of a
ViT-H global block's (16, 4096, 4096) logits to one extra copy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sam_quantization_tpu_torch.quant.bit_type import BitType


def uniform_quant(x: torch.Tensor, scale, zero, bt: BitType) -> torch.Tensor:
    """``round(x / s + z).clamp(qmin, qmax)`` in float32 (uniform.py:23-34)."""
    q = x.float() / scale
    return q.add_(zero).round_().clamp_(bt.lower_bound, bt.upper_bound)


def uniform_dequant(q: torch.Tensor, scale, zero) -> torch.Tensor:
    return (q - zero) * scale


def uniform_fake_quant(x: torch.Tensor, scale, zero, bt: BitType) -> torch.Tensor:
    """The quant -> dequant round trip, returned in x's dtype."""
    return uniform_quant(x, scale, zero, bt).sub_(zero).mul_(scale).to(x.dtype)


# float32(1 / float32(ln 2)): ``jnp.log2`` is ``log(x) / log(2)`` compiled by
# XLA, which folds the constant and multiplies by its reciprocal. The same
# form agrees with it at every power of two, where ``torch.log2`` does not
# always, and ``floor(log2)`` then decides a bit (``fq.int_ops.get_mn``).
RCP_LN2 = float(np.float32(1.0 / np.float32(np.log(np.float32(2.0)))))


# ``jnp.exp2`` compiles to ``exp(x * float32(ln 2))``, which is not exact at
# integers (exp2(15) = 32767.984), and the FQ path feeds it integers only
# (-15..45: shift counts and log2 indices), where the bits decide floors.
# The CPU's ``torch.exp`` of the same products gives XLA's values at every
# integer of [-125, 127] but 32 (reached only by ``log_round`` of a ratio
# past 2^32, whose LIS output is 0 either way); CUDA's ``expf`` misses a
# quarter of them. So every device reads this table, made on the CPU.
LN2 = float(np.float32(np.log(2.0)))
EXP2_MIN, EXP2_MAX = -126, 127
_EXP2_TABLE = torch.exp(torch.arange(EXP2_MIN, EXP2_MAX + 1, dtype=torch.float32) * LN2)


@functools.lru_cache(maxsize=None)
def _exp2_table(device: torch.device) -> torch.Tensor:
    return _EXP2_TABLE.to(device)


def _log2(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2`` of ``max(x, 1e-30)`` in float32, as XLA computes it."""
    return torch.log(torch.clamp(x.float(), min=1e-30)).mul_(RCP_LN2)


def _exp2(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp2`` of integer-valued ``x`` in [-126, 127], as XLA computes it."""
    index = (x - EXP2_MIN).clamp_(0, EXP2_MAX - EXP2_MIN).int()
    return _exp2_table(x.device)[index]


def log2_fake_quant(x: torch.Tensor, bt: BitType) -> torch.Tensor:
    """Log2 quantization of softmax outputs in [0, 1] (log2.py:18-27):
    ``q = round(-log2 x)``; values with ``q >= 2^bits`` flush to exactly 0."""
    rounds = _log2(x).neg_().round_()
    out = _exp2(rounds.clamp(0, 2**bt.bits - 1).neg_())
    return out.masked_fill_(rounds >= 2**bt.bits, 0.0).to(x.dtype)


def log_round(x: torch.Tensor) -> torch.Tensor:
    """Round in log space to the nearest power-of-two index
    (QIntSoftmax.log_round, fq_vit layers.py:340-346)."""
    big = torch.floor(_log2(x))
    extra = (x - _exp2(big)) >= _exp2(big - 1.0)
    return torch.where(extra, big + 1.0, big)
