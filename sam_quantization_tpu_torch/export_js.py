"""Decoder weight export for the in-browser (pure-JS) mask decoder.

Counterpart of ``sam_quantization_tpu/export_js.py``: the prompt-encoder
and mask-decoder parameters flattened into one little-endian float32 blob
plus a JSON manifest of tensor offsets, which ``demo/decoder.js`` slices
with ``Float32Array`` views. The tensors are the JAX package's layout
(linear ``w`` (in, out), convolutions HWIO, ``build_sam.to_jax_params``),
walked in the same sorted order, so the manifest and blob are byte-identical
to the JAX export of the same weights.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from sam_quantization_tpu_torch.models import build_sam
from sam_quantization_tpu_torch.predictor import MAX_POINTS


def _walk(node, path, out: List[Tuple[str, np.ndarray]]):
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], f"{path}/{k}" if path else str(k), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, f"{path}/{i}", out)
    else:
        out.append((path, np.asarray(node, np.float32)))


def flatten_decoder(model) -> Tuple[Dict, bytes]:
    """(manifest, blob) for the browser decoder: the decode config (dims,
    heads, eps, ``max_points`` prompt slots) and a table of {name, shape,
    offset} into the float32 blob. Of the prompt encoder only the
    sparse-prompt tensors are shipped: the browser embeds points, not mask
    prompts."""
    sd = {k: v for k, v in model.state_dict().items()
          if k.startswith(("prompt_encoder.", "mask_decoder."))}
    pe, md = build_sam.to_jax_decoder_params(sd, model.config)
    tensors: List[Tuple[str, np.ndarray]] = []
    for name in ("pe_gaussian", "point_embeddings", "not_a_point_embed", "no_mask_embed"):
        _walk(pe[name], f"prompt_encoder/{name}", tensors)
    _walk(md, "mask_decoder", tensors)

    cfg = model.config
    dcfg = cfg.mask_decoder
    tcfg = dcfg.transformer
    table, parts, off = [], [], 0
    for name, arr in tensors:
        parts.append(arr.tobytes())
        table.append({"name": name, "shape": list(arr.shape), "offset": off})
        off += arr.size
    manifest = {
        "dtype": "float32",
        "total_floats": off,
        "config": {
            "img_size": cfg.image_encoder.img_size,
            "embed_dim": dcfg.transformer_dim,
            "embedding_size": list(cfg.prompt_encoder.image_embedding_size),
            "depth": tcfg.depth,
            "num_heads": tcfg.num_heads,
            "mlp_dim": tcfg.mlp_dim,
            "downsample_rate": tcfg.attention_downsample_rate,
            "num_mask_tokens": dcfg.num_mask_tokens,
            "ln_eps": tcfg.ln_eps,
            "ln_eps_decoder": dcfg.ln_eps,
            "mask_threshold": 0.0,
            # the predictor's prompt slots (label -1 pads), so the browser's
            # decode sees the server's token count
            "max_points": MAX_POINTS,
        },
        "tensors": table,
    }
    return manifest, b"".join(parts)


def export_decoder_js(model, out_dir: str) -> None:
    """Write ``decoder_manifest.json`` and ``decoder_weights.bin``."""
    os.makedirs(out_dir, exist_ok=True)
    manifest, blob = flatten_decoder(model)
    with open(os.path.join(out_dir, "decoder_manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(out_dir, "decoder_weights.bin"), "wb") as f:
        f.write(blob)
