"""Per-op quantization error analysis (SNR) over the image encoder.

Counterpart of ``sam_quantization_tpu/quant/analysis.py`` (:58-157), itself
after PPQ's ``graphwise_error_analyse`` / ``layerwise_error_analyse`` as the
reference uses them (script/analysis.py:596-625): run the dense and the
quantized encoder on the same data, read the outputs at every linear and
convolution, and report each op's SNR.

The JAX capture contexts become forward hooks. Outputs are keyed by the
JAX package's paths (``patch_embed``, ``blocks.3.attn.qkv``,
``blocks.3.mlp.lin1``, ``neck.conv1``, ...), so the two packages' reports
compare key by key. Both encoders run their ``"eager"`` branch, as JAX's run
``"xla"``, each through its quantization context where one is given (an FQ
model: the fake-quantized encoder with ``FQCtx("quant", ...)``); a context
calls the modules, so the hooks see what it computes.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, List

import torch

from sam_quantization_tpu_torch.models.image_encoder import BLOCK_LINEARS
from sam_quantization_tpu_torch.quant.context import NULL_CTX


def snr_db(ref: torch.Tensor, test: torch.Tensor) -> torch.Tensor:
    """Signal-to-noise ratio in dB (higher is better)."""
    ref = ref.float()
    noise = (test.float() - ref).square().sum()
    return 10.0 * torch.log10(ref.square().sum() / torch.clamp(noise, min=1e-20))


def _block_linears(encoder) -> Dict[str, torch.nn.Module]:
    return {f"blocks.{i}.{owner}.{name}": getattr(getattr(blk, owner), name)
            for i, blk in enumerate(encoder.blocks) for owner, name in BLOCK_LINEARS}


def _ops(encoder) -> Dict[str, torch.nn.Module]:
    """Every linear and convolution of ``encoder``, by its JAX path, in call order."""
    return {"patch_embed": encoder.patch_embed.proj, **_block_linears(encoder),
            "neck.conv1": encoder.neck[0], "neck.conv2": encoder.neck[2]}


@contextlib.contextmanager
def _forward_hooks(modules: Dict[str, torch.nn.Module], make: Callable):
    hooks = [m.register_forward_hook(make(path)) for path, m in modules.items()]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def _outputs(encoder, x: torch.Tensor, ctx) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def make(path):
        def hook(module, args, y):
            out[path] = y
        return hook

    with _forward_hooks(_ops(encoder), make):
        encoder(x, "eager", ctx or NULL_CTX)
    return out


def _mean(acc: Dict[str, List[float]]) -> Dict[str, float]:
    return {k: sum(v) / len(v) for k, v in acc.items()}


def graphwise_error_analyse(fp_encoder, q_encoder, batches: Iterable[torch.Tensor],
                            q_ctx=None, fp_ctx=None) -> Dict[str, float]:
    """Per-op SNR (dB) of the quantized encoder against the dense one,
    averaged over ``batches``. The quantized graph runs on its own
    (quantized) activations (graphwise semantics), through ``q_ctx`` (and
    the dense one through ``fp_ctx``) when given; see
    :func:`layerwise_error_analyse` for each layer's error alone."""
    acc: Dict[str, List[float]] = {}
    with torch.no_grad():
        for x in batches:
            yf, yq = _outputs(fp_encoder, x, fp_ctx), _outputs(q_encoder, x, q_ctx)
            for k in yf:
                if k in yq:
                    acc.setdefault(k, []).append(float(snr_db(yf[k], yq[k])))
    return _mean(acc)


def layerwise_error_analyse(fp_encoder, q_encoder, batches: Iterable[torch.Tensor]) -> Dict[str, float]:
    """Each block linear's SNR with *dense inputs* and only its own weights
    quantized (PPQ ``layerwise_error_analyse``): the dense encoder runs, and
    at each of its linears the quantized encoder's layer of the same path
    (where it is another module) runs on the same input."""
    q_layers = _block_linears(q_encoder)
    acc: Dict[str, List[float]] = {}

    def make(path):
        def hook(module, args, y):
            q = q_layers[path]
            if q is not module:
                acc.setdefault(path, []).append(float(snr_db(y, q(args[0]))))
        return hook

    with torch.no_grad(), _forward_hooks(_block_linears(fp_encoder), make):
        for x in batches:
            fp_encoder(x, "eager")
    return _mean(acc)


def format_report(snrs: Dict[str, float], worst_k: int = 10) -> str:
    items = sorted(snrs.items(), key=lambda kv: kv[1])
    lines = ["op-wise SNR report (worst first):"]
    for k, v in items[:worst_k]:
        lines.append(f"  {k:<40s} {v:8.2f} dB")
    lines.append(f"  mean: {sum(snrs.values()) / len(snrs):8.2f} dB")
    return "\n".join(lines)
