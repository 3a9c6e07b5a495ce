"""The dp x tp device mesh and Megatron tensor parallelism for the encoder.

Counterpart of ``sam_quantization_tpu/parallel/mesh.py``. JAX states the
parallelism as named shardings and lets GSPMD insert the collectives; here
each rank holds its own shard and the collectives are explicit:

* :func:`make_mesh` is a ``DeviceMesh`` over ``("dp", "tp")``, one rank a
  card (gloo ranks on the CPU in the tests);
* :func:`shard_params` cuts this rank's shard out of a full model, in place.
  In every encoder block qkv and lin1 are split by output columns with
  their bias (column-parallel); proj and lin2 by input rows, their bias
  kept whole and added once after the reduce (row-parallel). Norms, rel-pos
  tables, the patch embed, the neck, the prompt encoder and the decoder are
  replicated. So a block needs one all-reduce after proj and one after lin2;
* inside :func:`tensor_parallel` the encoder runs each rank's ``nh / tp``
  heads (``models/image_encoder.py``) through :func:`column_parallel` and
  :func:`row_parallel`, whose collectives are the two Megatron operators,
  ``torch.autograd.Function`` s for training: copy-to-tp (identity forward,
  all-reduce backward) and reduce-from-tp (all-reduce forward, identity
  backward).

A packed low-bit layer shards the same way. A column shard takes whole
columns of ``qweight``, ``scales`` and ``zeros``; a row shard cuts K, so it
must take whole pack blocks and whole quantization groups (or lie inside
one group, whose scales it shares), and :func:`shard_params` refuses a
``tp`` for which it does not. A row shard of a layer that quantizes its
input per token to int8 (W-A8, or a cached-int8 layer with no static scale)
quantizes its slice at the token amax all-reduced (MAX) over the group, so
its integers are the unsharded layer's.

JAX's ``tp_constrain`` and the ``PartitionSpec`` trees have no counterpart:
the shard a rank holds is its spec.
"""

from __future__ import annotations

import contextlib
import re
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from sam_quantization_tpu_torch.nn import functional as F
from sam_quantization_tpu_torch.nn.layers import Linear
from sam_quantization_tpu_torch.nn.packed import IntLinear, PackedLinear
from sam_quantization_tpu_torch.ops import quant_matmul
from sam_quantization_tpu_torch.parallel.distributed import all_gather_cat

# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


def check_tp(world: int, tp: int) -> None:
    """Raise ``ValueError`` naming ``tp`` unless it divides the world."""
    if tp < 1 or world % tp:
        raise ValueError(f"tp={tp} does not divide the world of {world} rank(s)")


def make_mesh(n: Optional[int] = None, tp: int = 1):
    """A ``(world // tp, tp)`` ``DeviceMesh`` named ``("dp", "tp")`` over the
    joined world (:func:`distributed.initialize`): ranks ``r`` and ``r + 1``
    share a dp row, so a tp group is ``tp`` consecutive ranks (one host's
    cards under torchrun). ``n``, if given, must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a joined world: call parallel.distributed.initialize")
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"a mesh spans the whole world of {world} ranks, not {n}")
    check_tp(world, tp)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world // tp, tp), mesh_dim_names=("dp", "tp"))


def group_of(mesh, axis: str = "tp"):
    """The process group of ``axis`` on a ``DeviceMesh``; a process group
    given in its place is returned as it is."""
    return mesh.get_group(axis) if hasattr(mesh, "get_group") else mesh


# ---------------------------------------------------------------------------
# The tensor-parallel context (the encoder's production call site)
# ---------------------------------------------------------------------------

_TP_ACTIVE: List[Tuple[object, str]] = []


@contextlib.contextmanager
def tensor_parallel(mesh, axis: str = "tp"):
    """Within the body, the encoder runs each rank's shard of every block
    over ``axis``: its ``nh / tp`` heads in the eager plain-softmax form (as
    JAX, which turns flash off under this context) and its share of the MLP.
    The model must hold shards cut by :func:`shard_params`. JAX's
    ``packed_qkv`` flag has no counterpart here: a rank's qkv shard is
    head-aligned whichever layout it was cut from (:func:`shard_params`
    takes the layout), so the encoder reads it one way."""
    _TP_ACTIVE.append((mesh, axis))
    try:
        yield
    finally:
        _TP_ACTIVE.pop()


def active_tp(num_heads: int) -> Optional[Tuple[object, str]]:
    """(mesh, axis) when a tensor-parallel context is active and the head
    count divides over it."""
    if not _TP_ACTIVE:
        return None
    mesh, axis = _TP_ACTIVE[-1]
    if num_heads % group_of(mesh, axis).size() != 0:
        return None
    return mesh, axis


# ---------------------------------------------------------------------------
# Megatron operators
# ---------------------------------------------------------------------------


class _CopyToTP(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a column-parallel
    layer, whose gradient each rank holds a part of."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce forward, identity backward: the sum of a row-parallel
    layer's partial products."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group)


def column_parallel(layer: nn.Module, x: torch.Tensor, group) -> torch.Tensor:
    """A column shard on the replicated input: its share of the outputs."""
    return layer(copy_to_tp(x, group))


def _takes_int8_tokens(layer) -> bool:
    """Whether ``layer`` quantizes its input per token to int8 at run time:
    a W-A8 ``PackedLinear``, or an ``IntLinear`` with no static scale."""
    return ((isinstance(layer, PackedLinear) and layer.act_bits == 8)
            or (isinstance(layer, IntLinear) and layer.in_scale is None))


def _int8_row_product(layer, x: torch.Tensor, group) -> torch.Tensor:
    """A per-token int8 row shard's partial product: the token amax of this
    rank's slice of x, MAX-reduced over the group (exact), quantizes the
    slice as the unsharded layer quantizes the whole token (JAX's GSPMD
    program reduces the same amax across shards)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    amax = x2.detach().float().abs().amax(dim=-1, keepdim=True)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    xq, xs = quant_matmul.quantize_activations_int8(x2, amax)
    y = quant_matmul.int8_token_product(xq, xs, layer, x.dtype)
    return y.reshape(*lead, y.shape[-1])


def row_parallel(layer: nn.Module, x: torch.Tensor, group) -> torch.Tensor:
    """A row shard on its share of the inputs: the partial products summed
    over the group, then the whole bias once. A layer that quantizes its
    input per token takes the token amax over the group first."""
    if _takes_int8_tokens(layer):
        y = reduce_from_tp(_int8_row_product(layer, x, group), group)
    else:
        y = reduce_from_tp(F.linear_product(x, layer), group)
    if layer.bias is not None:
        y = y + layer.bias.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# qkv layout
# ---------------------------------------------------------------------------


def _qkv_perm(nh: int, hd: int, tp: int) -> np.ndarray:
    """Column permutation [q|k|v] (head-major) -> tp-major interleave
    [q_d | k_d | v_d for shard d]: contiguous N-chunks become head-aligned
    (JAX ``mesh._qkv_perm``, the same array)."""
    return (
        np.arange(3 * nh * hd)
        .reshape(3, tp, nh // tp, hd)
        .transpose(1, 0, 2, 3)
        .reshape(-1)
    )


def out_features(layer) -> int:
    """The output width of a ``Linear``, ``PackedLinear`` or ``IntLinear``."""
    return layer.out_features if hasattr(layer, "out_features") else layer.weight.shape[0]


def _param_like(old, t: torch.Tensor):
    """``t`` as a Parameter when ``old`` was one (keeping its grad flag)."""
    if isinstance(old, nn.Parameter):
        return nn.Parameter(t.contiguous(), requires_grad=old.requires_grad)
    return t.contiguous()


def _encoder_of(module):
    return getattr(module, "image_encoder", module)


def tp_pack_qkv(module, num_heads: int, tp: int):
    """Re-lay every block's fused qkv columns in the tp-major order of
    :func:`_qkv_perm`, in place, on a ``Sam`` or its encoder with dense,
    ``PackedLinear`` or ``IntLinear`` qkv layers (packing runs along K, so a
    column permutation is exact): a column cut of every column. Returns
    ``module``. Output channel order is unchanged, so proj needs nothing.
    Cut its shards with ``shard_params(..., packed_qkv=True)``."""
    enc = _encoder_of(module)
    for i, blk in enumerate(enc.blocks):
        hd = out_features(blk.attn.qkv) // (3 * num_heads)
        idx = torch.from_numpy(_qkv_perm(num_heads, hd, tp))
        blk.attn.qkv = _cut_layer(blk.attn.qkv, idx, what=f"blocks.{i}.attn.qkv")
    return module


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------

_ROLES = {"attn.qkv": "column", "mlp.lin1": "column", "attn.proj": "row", "mlp.lin2": "row"}
_BLOCK_LINEAR = re.compile(r"(?:^|\.)blocks\.\d+\.(attn\.qkv|attn\.proj|mlp\.lin1|mlp\.lin2)"
                           r"\.(weight|bias)$")


def _cut_of(which: str, n_out: int, k: int, rank: int, tp: int, nh: int, packed_qkv: bool,
            what: str) -> Tuple[Optional[torch.Tensor], int, int]:
    """This rank's cut of block linear ``which`` (``n_out`` outputs, ``k``
    inputs) as ``(cols, k0, k1)``: its output columns ``cols`` when it is
    column-parallel (qkv in the stock [q|k|v] order taken by index unless
    ``packed_qkv``), else ``cols`` None and its input rows [k0, k1)."""
    if _ROLES[which] == "column":
        n = n_out // tp
        if which == "attn.qkv" and not packed_qkv:
            perm = _qkv_perm(nh, n_out // (3 * nh), tp)
            return torch.from_numpy(perm[rank * n:(rank + 1) * n]), 0, 0
        return torch.arange(rank * n, (rank + 1) * n), 0, 0
    if k % tp:
        raise ValueError(f"{what}: tp={tp} does not divide its {k} input rows")
    ks = k // tp
    return None, rank * ks, (rank + 1) * ks


def _cut_dense(t: torch.Tensor, cols: Optional[torch.Tensor], k0: int, k1: int) -> torch.Tensor:
    """The cut of a dense (N, K) weight or (N,) bias: rows ``cols`` of
    either for a column shard; input columns [k0, k1) of the weight for a
    row shard, whose bias stays whole."""
    if cols is not None:
        return t[cols.to(t.device)]
    return t if t.dim() == 1 else t[:, k0:k1]


def _cut_groups(groupsize: int, k0: int, k1: int, what: str) -> Tuple[int, int, int]:
    """Rows [r0, r1) of a (G, N) scale table for input rows [k0, k1), and the
    shard's group size: whole groups, or a shard inside one group."""
    ks = k1 - k0
    if ks % groupsize == 0:
        return k0 // groupsize, k1 // groupsize, groupsize
    if groupsize % ks == 0:
        return k0 // groupsize, k0 // groupsize + 1, ks
    raise ValueError(f"{what}: a row shard of {ks} input rows cuts quantization groups of "
                     f"{groupsize}; pick a tp that gives whole groups")


def _cut_layer(layer, cols: Optional[torch.Tensor], k0: int = 0, k1: int = 0, what: str = ""):
    """A new layer of ``layer``'s class: its columns ``cols`` (column shard),
    or its input rows [k0, k1) with the bias whole (row shard)."""
    if isinstance(layer, Linear):
        w = _cut_dense(layer.weight, cols, k0, k1)
        out = Linear(w.shape[1], w.shape[0], bias=layer.bias is not None, device="meta")
        out.weight = _param_like(layer.weight, w)
        if layer.bias is not None:
            out.bias = _param_like(layer.bias, _cut_dense(layer.bias, cols, k0, k1).clone())
        return out
    if isinstance(layer, PackedLinear):
        if cols is not None:
            c = cols.to(layer.qweight.device)
            out = PackedLinear(layer.in_features, len(c), bits=layer.bits,
                               groupsize=layer.groupsize, pack_block=layer.pack_block,
                               bias=layer.bias is not None, act_bits=layer.act_bits,
                               sym=layer.sym, device=layer.qweight.device)
            out.qweight.copy_(layer.qweight[:, c])
            if layer.qweight_hi is not None:
                out.qweight_hi.copy_(layer.qweight_hi[:, c])
            out.scales.copy_(layer.scales[:, c])
            out.zeros.copy_(layer.zeros[:, c])
            if layer.bias is not None:
                out.bias.copy_(layer.bias[c])
            return out
        ks = k1 - k0
        if ks % layer.pack_block:
            raise ValueError(f"{what}: a row shard of {ks} input rows cuts pack blocks of "
                             f"{layer.pack_block}; pick a tp that gives whole pack blocks")
        g0, g1, g = _cut_groups(layer.groupsize, k0, k1, what)
        out = PackedLinear(ks, layer.out_features, bits=layer.bits, groupsize=g,
                           pack_block=layer.pack_block, bias=layer.bias is not None,
                           act_bits=layer.act_bits, sym=layer.sym, device=layer.qweight.device)
        per = layer.values_per_word
        out.qweight.copy_(layer.qweight[k0 // per:k1 // per])
        if layer.qweight_hi is not None:
            out.qweight_hi.copy_(layer.qweight_hi[k0 // 32:k1 // 32])
        out.scales.copy_(layer.scales[g0:g1])
        out.zeros.copy_(layer.zeros[g0:g1])
        if layer.bias is not None:
            out.bias.copy_(layer.bias)
        return out
    if isinstance(layer, IntLinear):
        if cols is not None:
            c = cols.to(layer.w8.device)
            w8 = layer.w8[c, :] if layer.layout == "nk" else layer.w8[:, c]
            return IntLinear(w8, layer.scales[:, c],
                             None if layer.bias is None else layer.bias[c],
                             layer.in_scale, groupsize=layer.groupsize, layout=layer.layout)
        g = layer.groupsize or layer.in_features
        g0, g1, gs = _cut_groups(g, k0, k1, what)
        w8 = layer.w8[:, k0:k1] if layer.layout == "nk" else layer.w8[k0:k1, :]
        return IntLinear(w8, layer.scales[g0:g1], layer.bias, layer.in_scale,
                         groupsize=0 if g1 - g0 == 1 else gs, layout=layer.layout)
    raise TypeError(f"{what}: cannot shard a {type(layer).__name__}")


def shard_params(module, mesh, axis: str = "tp", packed_qkv: bool = False):
    """Cut this rank's tensor-parallel shard out of a full ``Sam`` or encoder,
    in place (the counterpart of ``encoder_param_specs`` /
    ``sam_param_specs`` + ``shard_params``); returns ``module``.

    ``packed_qkv``: ``True`` when the qkv columns are already in
    :func:`tp_pack_qkv`'s order, so a rank takes a contiguous chunk; with
    ``False`` (a model as built or loaded) they are in the stock [q|k|v]
    order and the rank takes the same columns by index. Either way the
    shard is ``[q_d | k_d | v_d]`` of its heads. At ``tp`` 1 the
    shards are the whole layers (proj and lin2 then add their bias after a
    one-rank reduce).
    """
    enc = _encoder_of(module)
    cfg = enc.cfg
    group = group_of(mesh, axis)
    tp, rank = group.size(), dist.get_rank(group)
    if cfg.num_heads % tp:
        raise ValueError(f"tp={tp} does not divide the {cfg.num_heads} heads")
    for i, blk in enumerate(enc.blocks):
        for which in _ROLES:
            parent, attr = (blk.attn, which[5:]) if which.startswith("attn") else \
                (blk.mlp, which[4:])
            layer = getattr(parent, attr)
            what = f"blocks.{i}.{which}"
            k = layer.weight.shape[1] if isinstance(layer, Linear) else layer.in_features
            cut = _cut_of(which, out_features(layer), k, rank, tp, cfg.num_heads, packed_qkv,
                          what)
            setattr(parent, attr, _cut_layer(layer, *cut, what))
    return module


def shard_tensor(name: str, t: torch.Tensor, mesh, num_heads: int,
                 axis: str = "tp") -> torch.Tensor:
    """This rank's shard of the full dense tensor ``name`` (an upstream
    state-dict name), for tensors that ride along with a stock model's
    parameters (AdamW's moments): the cut :func:`shard_params` makes of a
    ``Linear``'s weight or bias. Tensors outside the block linears come back
    whole."""
    m = _BLOCK_LINEAR.search(name)
    if m is None:
        return t
    which = m.group(1)
    group = group_of(mesh, axis)
    cut = _cut_of(which, t.shape[0], t.shape[-1], dist.get_rank(group), group.size(),
                  num_heads, False, name)
    return _cut_dense(t, *cut).contiguous()


def gather_tensor(name: str, t: torch.Tensor, mesh, num_heads: int,
                  axis: str = "tp") -> torch.Tensor:
    """The full tensor ``name`` of a stock model from every rank's shard
    ``t`` (the inverse of :func:`shard_tensor`; a collective over ``axis``,
    so every rank of the group calls it)."""
    m = _BLOCK_LINEAR.search(name)
    if m is None:
        return t
    which, leaf = m.groups()
    if _ROLES[which] == "row" and leaf == "bias":
        return t
    group = group_of(mesh, axis)
    if _ROLES[which] == "row":
        return all_gather_cat(t, group, dim=1)
    full = all_gather_cat(t, group)
    if which == "attn.qkv":
        perm = torch.from_numpy(_qkv_perm(num_heads, full.shape[0] // (3 * num_heads),
                                          group.size()))
        out = torch.empty_like(full)
        out[perm.to(full.device)] = full
        return out
    return full
