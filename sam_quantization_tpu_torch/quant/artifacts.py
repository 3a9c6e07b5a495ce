"""Quantized-encoder artifacts in the JAX package's format, read and written
with numpy and torch.

Counterpart of ``sam_quantization_tpu/quant/artifacts.py``. An artifact is
a directory of ``weights.npz`` (the encoder pytree's leaves, flattened to
dotted keys), ``structure.json`` (list lengths, ``None`` leaves, and the
static fields of each packed linear) and ``quant_config.json``, exactly as
the JAX ``cli/quantize --save`` writes them.

:func:`load_quantized` returns the JAX encoder pytree as nested dicts and
lists of numpy arrays, each packed linear as a dict of its ``PackedLinear``
fields (the dataclass fields of the JAX ``PackedLinear``, so a dict with a
``qweight`` key); :func:`~sam_quantization_tpu_torch.models.build_sam.load_jax_encoder`
installs it on a model. Layers left dense (``--overrides`` skips) stay
``{"w", "b"}`` dicts, and per-layer bit widths and ``act_bits`` load as
they are.

An FQ-ViT artifact (``method == "fq"``) holds the dense encoder with
fake-quantized weights in the same files, and its activation quantizers in
``fq_qparams.npz`` under JAX's keys ``{path}.scale`` / ``{path}.zero``
(:func:`save_fq_qparams`, :func:`load_fq_qparams`).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np

_PACKED_ARRAYS = ("qweight", "qweight_hi", "scales", "zeros", "bias")


def is_packed(node: Any) -> bool:
    """Whether a tree node is a packed linear given as its fields."""
    return isinstance(node, dict) and "qweight" in node


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray], meta: Dict[str, Any]):
    if is_packed(tree):
        meta[prefix] = {
            "kind": "packed_linear",
            **{k: tree[k] for k in ("bits", "in_features", "out_features", "groupsize",
                                    "pack_block")},
            "has_bias": tree["bias"] is not None,
            "act_bits": tree["act_bits"],
            "sym": tree["sym"],
        }
        for k in _PACKED_ARRAYS:
            if tree[k] is not None:
                out[f"{prefix}.{k}"] = np.asarray(tree[k])
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}.{k}" if prefix else k, out, meta)
    elif isinstance(tree, (list, tuple)):
        meta[prefix + "#len"] = len(tree)
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}.{i}", out, meta)
    elif tree is None:
        meta[prefix] = {"kind": "none"}
    else:
        out[prefix] = np.asarray(tree)


def save_quantized(directory: str, encoder_tree: Any, quant_config: Dict[str, Any]) -> None:
    """Write quant_config.json + weights.npz + structure.json for a JAX-layout
    encoder tree (``build_sam.to_jax_encoder`` of a port encoder)."""
    os.makedirs(directory, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {}
    _flatten(encoder_tree, "", arrays, meta)
    np.savez(os.path.join(directory, "weights.npz"), **arrays)
    with open(os.path.join(directory, "quant_config.json"), "w") as f:
        json.dump(quant_config, f, indent=2)
    with open(os.path.join(directory, "structure.json"), "w") as f:
        json.dump(meta, f)


def _unflatten(arrays: Dict[str, np.ndarray], meta: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}

    def ensure(parts):
        node = root
        for p in parts:
            node = node.setdefault(p, {})
        return node

    packed = {k: v for k, v in meta.items()
              if isinstance(v, dict) and v.get("kind") == "packed_linear"}
    for key, arr in arrays.items():
        prefix, _, leaf = key.rpartition(".")
        if prefix in packed and leaf in _PACKED_ARRAYS:
            continue
        parts = key.split(".")
        ensure(parts[:-1])[parts[-1]] = arr
    for prefix, m in packed.items():
        parts = prefix.split(".")
        ensure(parts[:-1])[parts[-1]] = {
            **{k: arrays.get(f"{prefix}.{k}") for k in _PACKED_ARRAYS},
            "bits": m["bits"], "in_features": m["in_features"],
            "out_features": m["out_features"], "groupsize": m["groupsize"],
            "pack_block": m["pack_block"], "act_bits": m.get("act_bits", 0),
            "sym": m.get("sym", False),
        }

    def listify(node):
        if isinstance(node, dict) and not is_packed(node):
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def load_quantized(directory: str) -> Tuple[Any, Dict[str, Any]]:
    """Load (encoder tree, quant_config) from a ``save_quantized`` directory:
    packed layers as their fields, or, for an FQ-ViT artifact, the dense
    fake-quantized encoder (its activation qparams: :func:`load_fq_qparams`)."""
    if not os.path.isfile(os.path.join(directory, "quant_config.json")):
        raise FileNotFoundError(
            f"{directory!r} is not a quantized-artifact directory (missing "
            "quant_config.json; create one with `python -m "
            "sam_quantization_tpu.cli.quantize ... --save DIR`)"
        )
    with open(os.path.join(directory, "quant_config.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(directory, "structure.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(directory, "weights.npz")) as npz:
        arrays = dict(npz)
    return _unflatten(arrays, meta), cfg


FQ_QPARAMS = "fq_qparams.npz"


def save_fq_qparams(directory: str, qparams: Dict[str, Tuple[Any, Any]]) -> None:
    """Write ``{path: (scale, zero)}`` (arrays or tensors) as ``fq_qparams.npz``
    with the JAX CLI's keys ``{path}.scale`` and ``{path}.zero``."""
    def arr(v):
        return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)

    np.savez(os.path.join(directory, FQ_QPARAMS),
             **{f"{k}.{kind}": arr(v) for k, (scale, zero) in qparams.items()
                for kind, v in (("scale", scale), ("zero", zero))})


def load_fq_qparams(directory: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """``{path: (scale, zero)}`` numpy arrays of an artifact's
    ``fq_qparams.npz`` ({} when it has none, as the JAX CLI reads it)."""
    path = os.path.join(directory, FQ_QPARAMS)
    if not os.path.exists(path):
        return {}
    out: Dict[str, list] = {}
    with np.load(path) as raw:
        for key in raw.files:
            point, kind = key.rsplit(".", 1)
            out.setdefault(point, [None, None])[("scale", "zero").index(kind)] = raw[key]
    return {k: (s, z) for k, (s, z) in out.items()}
