"""The quantization context threaded through the port's models.

Counterpart of ``sam_quantization_tpu/quant/context.py``. The reference
instruments its model with stateful ``QAct`` modules
(fq_vit/models/sam/image_encoder.py:216-478); here a context object is
passed to ``forward``, and the model calls ``ctx.act(path, x)``,
``ctx.softmax(path, logits, scale_path)``, ``ctx.layer_norm(path, module,
x, eps, ...)`` and ``ctx.linear(path, module, x)`` at the JAX package's
observation points, under its path strings. The context decides what happens
there:

* :class:`NullCtx` (``NULL_CTX``): each hook runs its module or returns its
  input, so the float, GPTQ and packed models run unchanged and the
  encoder's kernel branches stay open to them (they test ``type(ctx) is
  NullCtx``, as JAX tests ``type(ctx) is type(NULL_CTX)``);
* ``quant.fq.pipeline.FQCtx``: FQ-ViT calibration (observer updates) or
  fake-quant inference with the integer LayerNorm and Log-Int-Softmax.

The hooks take the port's modules where JAX's take a parameter dict, so a
forward hook on a module sees every call a context makes to it.
"""

from __future__ import annotations

from typing import Optional

import torch


class NullCtx:
    """Float behaviour at every hook; also the base class of quant contexts."""

    def linear(self, path: str, module, x):
        return module(x)

    def conv2d(self, path: str, module, x):
        return module(x)

    def conv_transpose2d(self, path: str, module, x):
        return module(x)

    def act(self, path: str, x, ln_input: bool = False):
        """Activation observation point (a ``QAct`` in the reference)."""
        return x

    def softmax(self, path: str, attn, scale_path: Optional[str] = None, dim: int = -1):
        """Softmax observation point (``QIntSoftmax`` / LIS in the reference),
        float32 softmax in the logits' dtype."""
        return torch.softmax(attn.float(), dim=dim).to(attn.dtype)

    def layer_norm(
        self,
        path: str,
        module,
        x,
        in_path: Optional[str] = None,
        out_path: Optional[str] = None,
        in_scale_expand: int = 1,
    ):
        """LayerNorm point. Quant contexts may run the integer (PTF) LN with
        the quantizers at ``in_path`` / ``out_path``; ``module`` is a
        ``LayerNorm`` (its ``eps`` is the model's)."""
        return module(x)


NULL_CTX = NullCtx()
