"""Sequential (block by block) GPTQ calibration of the SAM image encoder, and RTN.

Counterpart of ``sam_quantization_tpu/quant/sequential.py`` (itself after
the reference's ``sam_sequential`` + ``sam_pack``, gptq4sam.py:279-497):
embed the calibration batches, then for each block and each subset of its
linears accumulate the inputs' Hessians with the earlier subsets already
quantized, solve GPTQ, swap the layers, and propagate the *quantized*
block's outputs to the next block.

The JAX capture context becomes forward pre-hooks (:class:`HessianCaptureCtx`)
on the selected linears of one block. Calibration runs the blocks'
``"eager"`` branch, the counterpart of JAX's ``"xla"``: attention
materialises its logits and the MLP does not fuse, so ``mlp.lin2`` sees the
GELU output. Layers already quantized run their packed kernels on the card.
The hooks see the rows JAX's context sees, the zero rows that pad a
windowed block's partition included; the encoder needed no change for it.

Packing goes straight into the port's ``PackedLinear``. With ``actorder``,
or bits outside {2, 3, 4, 8} (``--wbits 16``), a layer keeps dense
fake-quant weights instead, as in JAX.

``GPTQConfig`` lives in :mod:`quant.gptq` and is re-exported here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from sam_quantization_tpu_torch.models.image_encoder import BLOCK_LINEARS
from sam_quantization_tpu_torch.nn.layers import Linear
from sam_quantization_tpu_torch.nn.packed import pack_int_weights, quantize_rtn
from sam_quantization_tpu_torch.quant import gptq
from sam_quantization_tpu_torch.quant.gptq import GPTQConfig
from sam_quantization_tpu_torch.quant.overrides import QuantOverrides

TRUE_SEQUENTIAL_SUBSETS: Sequence[Sequence[str]] = (
    ("attn.qkv",),
    ("attn.proj",),
    ("mlp.lin1", "mlp.lin2"),
)  # gptq4sam.py:348-352
BLOCK_PATHS = tuple(f"{owner}.{name}" for owner, name in BLOCK_LINEARS)


def _get_linear(block, path: str):
    owner, name = path.split(".")
    return getattr(getattr(block, owner), name)


def _set_linear(block, path: str, module) -> None:
    owner, name = path.split(".")
    setattr(getattr(block, owner), name, module)


@contextlib.contextmanager
def full_float32():
    """Float32 products without TF32 in cuBLAS and cuDNN, as JAX calibrates
    (cuDNN's default TF32 on the patch-embed conv would shift every
    Hessian)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class HessianCaptureCtx:
    """Records ``Σ xᵀx`` (float32, on the input's device) of the inputs of
    the linears ``paths`` (``"attn.qkv"`` and the like) of one block, over
    every forward run inside the ``with``."""

    def __init__(self, block, paths: Sequence[str]):
        self.block, self.paths = block, tuple(paths)
        self.xtx: Dict[str, torch.Tensor] = {}
        self._hooks: List = []

    def _hook(self, path: str):
        def hook(module, args):
            x = args[0]
            x2 = x.reshape(-1, x.shape[-1]).float()
            acc = x2.t() @ x2
            self.xtx[path] = acc if path not in self.xtx else self.xtx[path] + acc
        return hook

    def __enter__(self) -> "HessianCaptureCtx":
        self._hooks = [_get_linear(self.block, p).register_forward_pre_hook(self._hook(p))
                       for p in self.paths]
        return self

    def __exit__(self, *exc) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []


def quantize_linear_gptq(lin, h: torch.Tensor, qcfg: GPTQConfig) -> Tuple[torch.nn.Module, float]:
    """Solve GPTQ for one ``Linear`` (weight ``(N, K)``) given its Hessian and
    return ``(PackedLinear, or a dense fake-quant Linear, solver loss)``.

    The packed layout wants contiguous groups; with actorder the groups
    follow the permuted column order (``g_idx``), so such a layer keeps its
    dequantized weights, gathered through ``g_idx``, as a dense ``Linear``."""
    w = lin.weight.detach()
    N, K = w.shape
    # tiny layers: a group never exceeds the K axis (as quantize_rtn clamps)
    gsize = min(qcfg.groupsize, K) if qcfg.groupsize > 0 else qcfg.groupsize
    res = gptq.gptq_quantize_matrix(
        w.float(), h, bits=qcfg.bits, groupsize=gsize, sym=qcfg.sym, actorder=qcfg.actorder,
        percdamp=qcfg.percdamp, blocksize=qcfg.blocksize, mse=qcfg.mse,
    )
    loss = float(res.loss)
    bias = None if lin.bias is None else lin.bias.detach()
    if qcfg.actorder or qcfg.bits not in (2, 3, 4, 8):
        out = Linear(K, N, bias=bias is not None, device=w.device)
        out.weight.data.copy_(gptq.reconstruct(res).to(w.dtype))
        if bias is not None:
            out.bias.data.copy_(bias)
        return out, loss
    return pack_int_weights(
        res.q_int.t(), res.scales.t(), res.zeros.t(), None if bias is None else bias.float(),
        qcfg.bits, gsize, sym=qcfg.sym,
    ), loss


def _resolve_qcfg(
    qcfg: GPTQConfig, overrides: Optional[QuantOverrides], path: str
) -> Optional[GPTQConfig]:
    """The layer's config after ``overrides``; None: skip (leave it dense)."""
    if overrides is None:
        return qcfg
    ov = overrides.match(path)
    if ov is None:
        return qcfg
    if ov.skip:
        return None
    return dataclasses.replace(
        qcfg,
        bits=ov.bits if ov.bits is not None else qcfg.bits,
        groupsize=ov.groupsize if ov.groupsize is not None else qcfg.groupsize,
        sym=ov.sym if ov.sym is not None else qcfg.sym,
    )


def gptq_quantize_encoder(
    encoder,
    batches: Iterable[torch.Tensor],
    qcfg: GPTQConfig,
    true_sequential: bool = True,
    verbose: bool = False,
    overrides: Optional[QuantOverrides] = None,
) -> Tuple[torch.nn.Module, Dict[str, float]]:
    """GPTQ-quantize every block linear of ``encoder`` (an ``ImageEncoderViT``),
    in place on its device; returns ``(encoder, {layer path: solver loss})``.

    ``batches``: preprocessed (B, img, img, 3) float32 images on the
    encoder's device. A layer that ``overrides`` skips stays dense, with loss
    0.0. The Hessian of a subset is ``H = (2 / nbatches) Σ xᵀx``."""
    subsets = (
        TRUE_SEQUENTIAL_SUBSETS
        if true_sequential
        else (tuple(p for s in TRUE_SEQUENTIAL_SUBSETS for p in s),)
    )
    losses: Dict[str, float] = {}
    with torch.no_grad(), full_float32():
        xs = [encoder.embed(b) for b in batches]
        nbatches = len(xs)
        for i, block in enumerate(encoder.blocks):
            for subset in subsets:
                # Hessians of this subset, with the earlier subsets quantized
                # (gptq4sam.py:341-398).
                with HessianCaptureCtx(block, subset) as cap:
                    for x in xs:
                        block(x, "eager")
                for path in subset:
                    full_path = f"blocks.{i}.{path}"
                    layer_qcfg = _resolve_qcfg(qcfg, overrides, full_path)
                    if layer_qcfg is None:
                        losses[full_path] = 0.0
                        continue
                    h = (2.0 / nbatches) * cap.xtx[path]
                    qlin, loss = quantize_linear_gptq(_get_linear(block, path), h, layer_qcfg)
                    _set_linear(block, path, qlin)
                    losses[full_path] = loss
                    if verbose:
                        print(f"{full_path}: loss={loss:.4f}")
            # The quantized block's outputs feed the next (gptq4sam.py:399-412).
            xs = [block(x, "eager") for x in xs]
    return encoder, losses


def rtn_quantize_encoder(encoder, qcfg: GPTQConfig, overrides: Optional[QuantOverrides] = None):
    """Swap ``attn.qkv``, ``attn.proj``, ``mlp.lin1`` and ``mlp.lin2`` of every
    block of ``encoder`` (an ``ImageEncoderViT``) for RTN-quantized
    ``PackedLinear`` layers, in place on the weights' device; returns it.
    ``overrides`` sets a layer's bits, groupsize or sym, or leaves it dense."""
    for i, block in enumerate(encoder.blocks):
        for path in BLOCK_PATHS:
            layer_qcfg = _resolve_qcfg(qcfg, overrides, f"blocks.{i}.{path}")
            if layer_qcfg is None:
                continue
            lin = _get_linear(block, path)
            # The port's Linear is (out, in); the packed layout is (in, out).
            _set_linear(block, path, quantize_rtn(
                lin.weight.detach().float().t(), layer_qcfg.bits,
                max(layer_qcfg.groupsize, 0), layer_qcfg.sym,
                bias=None if lin.bias is None else lin.bias.detach(),
            ))
    return encoder
