"""Parameter-holding layers with the upstream ``segment_anything`` names.

Each layer owns ``weight`` / ``bias`` in the upstream torch layout, so a
model built from them takes an official SAM state dict through
``load_state_dict`` unchanged. ``forward`` runs the NHWC functional op from
:mod:`sam_quantization_tpu_torch.nn.functional`.

Constructors take a ``torch.Generator`` for seeded init (``None`` leaves the
tensors uninitialised, for a state dict to fill) and the device to build on.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sam_quantization_tpu_torch.nn import functional as F


def _param(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


class Linear(nn.Module):
    def __init__(self, in_features, out_features, bias=True, *, gen=None, device="cpu"):
        super().__init__()
        if gen is None:
            w = torch.empty(out_features, in_features, device=device)
            b = torch.empty(out_features, device=device) if bias else None
        else:
            w, b = F.init_linear(gen, in_features, out_features, bias, device)
        self.weight = _param(w)
        self.bias = _param(b)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Conv2d(nn.Module):
    """NHWC conv with an OIHW weight."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, bias=True, *,
                 gen=None, device="cpu"):
        super().__init__()
        self.stride, self.padding = stride, padding
        if gen is None:
            w = torch.empty(cout, cin, kernel, kernel, device=device)
            b = torch.empty(cout, device=device) if bias else None
        else:
            w, b = F.init_conv2d(gen, kernel, kernel, cin, cout, bias, device)
        self.weight = _param(w)
        self.bias = _param(b)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class ConvTranspose2d(nn.Module):
    """NHWC transposed conv, kernel == stride, weight ``(I, O, k, k)``."""

    def __init__(self, cin, cout, stride=2, *, gen=None, device="cpu"):
        super().__init__()
        self.stride = stride
        if gen is None:
            w = torch.empty(cin, cout, stride, stride, device=device)
            b = torch.empty(cout, device=device)
        else:
            # The JAX init draws (k, k, I, O) with fan_in = k*k*I.
            w, b = F.init_conv2d(gen, stride, stride, cin, cout, True, device)
            w = w.permute(1, 0, 2, 3).contiguous()
        self.weight = _param(w)
        self.bias = _param(b)

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, self.bias, self.stride)


class LayerNorm(nn.Module):
    """Last-axis LayerNorm (also the NHWC ``LayerNorm2d``)."""

    def __init__(self, dim, eps=1e-6, *, device="cpu"):
        super().__init__()
        self.eps = eps
        w, b = F.init_layer_norm(dim, device)
        self.weight = _param(w)
        self.bias = _param(b)

    def forward(self, x):
        return F.layer_norm(x, self.weight, self.bias, self.eps)


class Embedding(nn.Module):
    """A ``(num, dim)`` table under the name ``weight`` (``nn.Embedding``'s)."""

    def __init__(self, num, dim, *, gen=None, device="cpu"):
        super().__init__()
        if gen is None:
            w = torch.empty(num, dim, device=device)
        else:
            w = F.init_embedding(gen, num, dim, device)
        self.weight = _param(w)


class MLPBlock(nn.Module):
    """lin1 -> act -> lin2 (ref common.py:13-27); GELU in the encoder, ReLU
    in the two-way transformer. Either linear may be a ``PackedLinear``."""

    def __init__(self, dim, hidden, act=F.gelu, *, gen=None, device="cpu"):
        super().__init__()
        self.act = act
        self.lin1 = Linear(dim, hidden, gen=gen, device=device)
        self.lin2 = Linear(hidden, dim, gen=gen, device=device)

    def forward(self, x):
        return F.mlp_block(x, self.lin1, self.lin2, self.act)
