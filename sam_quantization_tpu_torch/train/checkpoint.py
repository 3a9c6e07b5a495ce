"""Trainer checkpoints in the JAX trainer's own format.

Counterpart of ``sam_quantization_tpu/train/checkpoint.py``. A checkpoint is
``sam_model_{name}.npz`` plus ``sam_model_{name}.json`` (``{"epoch": ...}``
and any extras). The npz holds the leaves of the JAX ``Sam`` pytree as
``m0, m1, ...`` and those of the ``optax.adamw`` state as ``o0, o1, ...``,
each in JAX's flatten order and layout, so a run started by either package
resumes in the other:

* the pytree order: the ``Sam`` fields image_encoder, prompt_encoder,
  mask_decoder in turn; within them dict keys sorted, lists in order;
* the optax state ``(ScaleByAdamState(count, mu, nu), EmptyState(),
  EmptyState())`` flattens to ``count`` (int32), the mu leaves, the nu
  leaves (1 + 199 + 199 at vit_tiny).

The model and the two AdamW moments go through
``build_sam.to_jax_params`` / ``from_jax_params``; ``count`` is AdamW's
``step``. No JAX is needed: the tree's shape comes from the model.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from sam_quantization_tpu_torch.models import build_sam
from sam_quantization_tpu_torch.models import sam as sam_lib


def _leaves(tree) -> Iterator[np.ndarray]:
    """The leaves of a nested dict / list tree in JAX's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def _unflatten(tree, it: Iterator[np.ndarray]):
    """``tree``'s structure with its leaves taken from ``it`` in JAX order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out[k] = _unflatten(tree[k], it)
        return out
    if isinstance(tree, (list, tuple)):
        return [_unflatten(t, it) for t in tree]
    leaf = next(it)
    if leaf.shape != tree.shape:
        raise ValueError(f"checkpoint leaf of shape {leaf.shape}, model has {tree.shape}")
    return leaf


def _jax_leaves(tensors: Dict[str, torch.Tensor], model: sam_lib.Sam) -> List[np.ndarray]:
    return list(_leaves(build_sam.to_jax_params(tensors, model.config)))


def _gathered(tensors: Dict[str, torch.Tensor], model: sam_lib.Sam, mesh) -> Dict[str, torch.Tensor]:
    """The full tensors of a tensor-parallel shard's named tensors (a
    collective over the mesh's tp axis)."""
    from sam_quantization_tpu_torch.parallel import mesh as mesh_lib

    nh = model.config.image_encoder.num_heads
    return {n: mesh_lib.gather_tensor(n, t, mesh, nh) for n, t in tensors.items()}


def _from_jax_leaves(leaves: Iterator[np.ndarray], model: sam_lib.Sam) -> Dict[str, torch.Tensor]:
    skeleton = build_sam.to_jax_params(model.state_dict(), model.config)
    trees = [_unflatten(t, leaves) for t in skeleton]
    return build_sam.from_jax_params(*trees, model.config)


def _named_params(model: sam_lib.Sam, optimizer: torch.optim.Optimizer):
    """(name, parameter) in the optimizer's order; it must hold exactly the
    model's parameters, in one group."""
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    if sorted(names) != sorted(id(p) for p in params):
        raise ValueError("the optimizer must hold exactly the model's parameters")
    return [(names[id(p)], p) for p in params]


def save_checkpoint(
    directory: str,
    model: sam_lib.Sam,
    optimizer: torch.optim.Optimizer,
    epoch: int,
    name: str = "latest",
    extras: Optional[Dict[str, Any]] = None,
    mesh=None,
) -> None:
    """Write the model and its AdamW state as the JAX trainer does.

    On a dp x tp ``mesh`` every rank calls it: with tp > 1 the ranks gather
    the encoder's tensor-parallel shards (stock qkv layout, as
    ``trainer.shard_for_training`` cut them), and rank 0 alone writes the
    full model, which a one-process run resumes."""
    named = _named_params(model, optimizer)
    states = [optimizer.state.get(p, {}) for _, p in named]
    count = int(states[0]["step"]) if states[0] else 0

    def moment(key):
        return {n: s[key] if s else torch.zeros_like(p) for (n, p), s in zip(named, states)}

    tensors = [model.state_dict(), moment("exp_avg"), moment("exp_avg_sq")]
    if mesh is not None:
        if mesh["tp"].size() > 1:
            tensors = [_gathered(t, model, mesh) for t in tensors]
        if mesh.get_rank() != 0:
            return
    os.makedirs(directory, exist_ok=True)
    flat_m = _jax_leaves(tensors[0], model)
    flat_o = [np.asarray(count, np.int32), *_jax_leaves(tensors[1], model),
              *_jax_leaves(tensors[2], model)]
    np.savez(
        os.path.join(directory, f"sam_model_{name}.npz"),
        **{f"m{i}": x for i, x in enumerate(flat_m)},
        **{f"o{i}": x for i, x in enumerate(flat_o)},
    )
    with open(os.path.join(directory, f"sam_model_{name}.json"), "w") as f:
        json.dump({"epoch": epoch, **(extras or {})}, f)


def _load_model_leaves(data, model: sam_lib.Sam) -> int:
    """Copy the ``m*`` leaves of a loaded npz into ``model``; returns their count."""
    n_m = sum(1 for k in data.files if k.startswith("m"))
    sd = _from_jax_leaves((data[f"m{i}"] for i in range(n_m)), model)
    with torch.no_grad():
        model.load_state_dict(sd, strict=True)
    return n_m


def _epoch(directory: str, name: str) -> int:
    with open(os.path.join(directory, f"sam_model_{name}.json")) as f:
        return json.load(f)["epoch"]


def load_weights(directory: str, model: sam_lib.Sam, name: str = "latest") -> int:
    """Restore only the model's weights from a checkpoint written by either
    package, as evaluation needs (the optimizer state is not read); returns
    the stored epoch."""
    with np.load(os.path.join(directory, f"sam_model_{name}.npz")) as data:
        _load_model_leaves(data, model)
    return _epoch(directory, name)


def load_checkpoint(
    directory: str, model: sam_lib.Sam, optimizer: torch.optim.Optimizer, name: str = "latest"
) -> int:
    """Restore the model's weights and the AdamW state from a checkpoint
    written by either package; returns the stored epoch."""
    data = np.load(os.path.join(directory, f"sam_model_{name}.npz"))
    n_m = _load_model_leaves(data, model)
    n = sum(1 for k in data.files if k.startswith("o")) - 1
    if n != 2 * n_m:
        raise ValueError(f"optimizer state of {n + 1} leaves does not fit {n_m} parameters")
    mu = _from_jax_leaves((data[f"o{1 + i}"] for i in range(n_m)), model)
    nu = _from_jax_leaves((data[f"o{1 + n_m + i}"] for i in range(n_m)), model)
    step = float(data["o0"])
    named = _named_params(model, optimizer)
    state = optimizer.state_dict()
    state["state"] = {
        i: {"step": torch.tensor(step), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
        for i, (n, _) in enumerate(named)
    }
    optimizer.load_state_dict(state)
    return _epoch(directory, name)
