"""Sequence-parallel global attention over a process group.

Counterpart of ``sam_quantization_tpu/parallel/sp_attention.py`` (SURVEY
§5's long-context mapping). SAM's windowed blocks are embarrassingly
parallel; the global blocks are where sequence parallelism applies. Each
rank takes its ``L / n`` query rows with their rel-pos tiles (functions of
q only, so they shard with the queries) and its K/V rows, all-gathers K and
V, computes JAX's body (float32 logits, plain softmax, the rel bias added)
and all-gathers the output rows, so the activations stay replicated and the
rest of the encoder runs as before.

No kernel runs here, in JAX or in the port: the body is eager. It is
differentiable, as JAX's ``shard_map`` body is: the gathers are autograd
operators, and the replicated inputs' gradients are summed over the group,
so every rank holds the full gradient of each input.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from sam_quantization_tpu_torch.parallel.distributed import all_gather_cat
from sam_quantization_tpu_torch.parallel.mesh import copy_to_tp, group_of

# ---------------------------------------------------------------------------
# Active-group context: the encoder's production call site. The model code
# (models/image_encoder.Attention) consults it instead of taking a group, so
# the same forward serves one card and sequence-parallel execution:
# ``with sequence_parallel(mesh): encoder(x)``.
# ---------------------------------------------------------------------------

_ACTIVE: List[Tuple[object, int]] = []


@contextlib.contextmanager
def sequence_parallel(mesh, axis: str = "tp", min_len: int = 1024):
    """Route global-attention blocks through :func:`sp_attention` over
    ``axis`` of ``mesh`` (or over a process group given in its place) inside
    the with-body. ``min_len``: only sequences at least this long shard (the
    windowed blocks' short L would pay collective latency for nothing)."""
    _ACTIVE.append((group_of(mesh, axis), min_len))
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_sp(seq_len: int):
    """The process group to use for a global-attention call, or None:
    ``L >= min_len`` and ``L`` divides over the group."""
    if not _ACTIVE:
        return None
    group, min_len = _ACTIVE[-1]
    if seq_len < min_len or seq_len % group.size() != 0:
        return None
    return group


class _GatherRows(torch.autograd.Function):
    """``all_gather_cat`` along ``dim`` as an autograd operator. Its backward
    takes this rank's rows of the incoming gradient: summed over the group
    first where each rank holds a part of it (``partial``: K and V, which
    every rank's queries read), as it is where every rank holds all of it
    (the output rows, gathered onto every rank)."""

    @staticmethod
    def forward(ctx, x, group, dim: int, partial: bool):
        ctx.group, ctx.dim, ctx.partial, ctx.rows = group, dim, partial, x.shape[dim]
        return all_gather_cat(x, group, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.partial:
            grad = grad.contiguous().clone()
            dist.all_reduce(grad, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return grad.narrow(ctx.dim, r * ctx.rows, ctx.rows), None, None, None


def _body(q, k, v, rel_h, rel_w, scale):
    """JAX's shard body: (B, nh, Lq, hd) queries against (B, nh, L, hd) keys."""
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if rel_h is not None:
        bias = rel_h[..., :, None] + rel_w[..., None, :]  # (B, nh, Lq, kh, kw)
        s = s + bias.reshape(s.shape).float()
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def sp_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_h: Optional[torch.Tensor],
    rel_w: Optional[torch.Tensor],
    scale: float,
    group,
) -> torch.Tensor:
    """Global self-attention with the L axis split over ``group``.

    q/k/v: (B, nh, L, hd), the same on every rank; rel_h: (B, nh, L, kh);
    rel_w: (B, nh, L, kw) (kh * kw = L), or both None. Each rank computes
    its L/n query rows against the all-gathered K/V; the output rows are
    all-gathered into (B, nh, L, hd) on every rank. Under autograd every
    rank's gradient of each input is the full one (copy-to-tp: the ranks'
    shares are summed over the group).
    """
    L = q.shape[2]
    n, r = group.size(), dist.get_rank(group)
    rows = slice(r * (L // n), (r + 1) * (L // n))
    q, k, v = (copy_to_tp(t, group) for t in (q, k, v))
    k_full = _GatherRows.apply(k[:, :, rows], group, 2, True)
    v_full = _GatherRows.apply(v[:, :, rows], group, 2, True)
    rel = (None, None)
    if rel_h is not None:
        rel = (copy_to_tp(rel_h, group)[:, :, rows], copy_to_tp(rel_w, group)[:, :, rows])
    out = _body(q[:, :, rows], k_full, v_full, *rel, scale)
    return _GatherRows.apply(out, group, 2, False)


def sp_attention_reference(q, k, v, rel_h, rel_w, scale) -> torch.Tensor:
    """The same attention on one rank."""
    return _body(q, k, v, rel_h, rel_w, scale)
