"""Model registry and weight bridge.

Counterpart of ``sam_quantization_tpu/models/build_sam.py``. The port's
modules carry the upstream ``segment_anything`` parameter names and layouts,
so an official SAM ``.pth`` state dict loads with ``load_state_dict`` as it
is. :func:`from_jax_params` turns the JAX package's parameter pytree
(nested dicts of numpy arrays) into that same state dict without JAX, and
:func:`load_jax_encoder` installs a JAX encoder pytree, quantized or not, on
a model whose prompt encoder and decoder come from elsewhere.

A packed linear in a JAX pytree is given as the dict of its ``PackedLinear``
fields (``qweight``, ``scales``, ..., ``bits``, ``groupsize``, ...), as
``quant.artifacts.load_quantized`` returns it.

Builders run on the CUDA device unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sam_quantization_tpu_torch.models import sam as sam_lib
from sam_quantization_tpu_torch.models.configs import CONFIGS, ImageEncoderConfig, SamConfig
from sam_quantization_tpu_torch.models.image_encoder import BLOCK_LINEARS
from sam_quantization_tpu_torch.nn.layers import Linear
from sam_quantization_tpu_torch.nn.packed import PackedLinear

_PACKED_FIELDS = ("bits", "in_features", "out_features", "groupsize", "pack_block",
                  "act_bits", "sym")


def _tensor(a, perm=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    if perm is not None:
        a = a.transpose(perm)
    return torch.tensor(a)  # a copy: the source may be read-only


def _encoder_state_dict(
    enc: dict, ecfg: ImageEncoderConfig, prefix: str = ""
) -> Tuple[Dict[str, torch.Tensor], Dict[str, dict]]:
    """Upstream-named state dict of a JAX encoder pytree, and the static
    fields of each packed linear by module name (its buffers are in the
    state dict under that name)."""
    out: Dict[str, torch.Tensor] = {}
    packed: Dict[str, dict] = {}

    def put(key, a, perm=None):
        out[prefix + key] = _tensor(a, perm)

    def put_lin(name, p):
        if "qweight" in p:  # a packed linear, given as its fields
            packed[name] = {k: p[k] for k in _PACKED_FIELDS}
            for k in ("qweight", "qweight_hi", "scales", "zeros", "bias"):
                if p.get(k) is not None:
                    put(f"{name}.{k}", p[k])
            return
        put(f"{name}.weight", p["w"], (1, 0))
        if "b" in p:
            put(f"{name}.bias", p["b"])

    def put_ln(name, p):
        put(f"{name}.weight", p["w"])
        put(f"{name}.bias", p["b"])

    def put_conv(name, p):
        put(f"{name}.weight", p["w"], (3, 2, 0, 1))
        if "b" in p:
            put(f"{name}.bias", p["b"])

    put_conv("patch_embed.proj", enc["patch_embed"])
    if ecfg.use_abs_pos:
        put("pos_embed", enc["pos_embed"])
    put_conv("neck.0", enc["neck"]["conv1"])
    put_ln("neck.1", enc["neck"]["ln1"])
    put_conv("neck.2", enc["neck"]["conv2"])
    put_ln("neck.3", enc["neck"]["ln2"])
    for i, blk in enumerate(enc["blocks"]):
        b = f"blocks.{i}"
        put_ln(f"{b}.norm1", blk["norm1"])
        put_lin(f"{b}.attn.qkv", blk["attn"]["qkv"])
        put_lin(f"{b}.attn.proj", blk["attn"]["proj"])
        put_ln(f"{b}.norm2", blk["norm2"])
        put_lin(f"{b}.mlp.lin1", blk["mlp"]["lin1"])
        put_lin(f"{b}.mlp.lin2", blk["mlp"]["lin2"])
        if ecfg.use_rel_pos:
            put(f"{b}.attn.rel_pos_h", blk["attn"]["rel_pos_h"])
            put(f"{b}.attn.rel_pos_w", blk["attn"]["rel_pos_w"])
    return out, packed


def from_jax_params(image_encoder: dict, prompt_encoder: dict, mask_decoder: dict,
                    cfg: SamConfig) -> Dict[str, torch.Tensor]:
    """Upstream-named torch state dict from the JAX ``Sam`` pytree's three
    subtrees (nested dicts / lists of numpy arrays).

    Linear (in, out) -> (out, in); HWIO conv -> OIHW; (kh, kw, I, O)
    transposed conv -> (I, O, kh, kw); the stacked ``point_embeddings`` and
    the ``hypernetworks`` / ``iou_head`` lists are split into upstream keys.
    The inverse of the JAX package's ``convert_torch_state_dict``. A packed
    encoder linear contributes its buffers; :func:`load_jax_encoder` also
    swaps in the ``PackedLinear`` modules that take them.
    """
    out, _ = _encoder_state_dict(image_encoder, cfg.image_encoder, "image_encoder.")

    def put(key, a, perm=None):
        out[key] = _tensor(a, perm)

    def put_lin(prefix, p):
        put(f"{prefix}.weight", p["w"], (1, 0))
        if "b" in p:
            put(f"{prefix}.bias", p["b"])

    def put_ln(prefix, p):
        put(f"{prefix}.weight", p["w"])
        put(f"{prefix}.bias", p["b"])

    def put_conv(prefix, p, perm=(3, 2, 0, 1)):
        put(f"{prefix}.weight", p["w"], perm)
        if "b" in p:
            put(f"{prefix}.bias", p["b"])

    pe, pp = "prompt_encoder", prompt_encoder
    put(f"{pe}.pe_layer.positional_encoding_gaussian_matrix", pp["pe_gaussian"])
    pts = np.asarray(pp["point_embeddings"])
    for i in range(pts.shape[0]):
        put(f"{pe}.point_embeddings.{i}.weight", pts[i : i + 1])
    put(f"{pe}.not_a_point_embed.weight", pp["not_a_point_embed"])
    put(f"{pe}.no_mask_embed.weight", pp["no_mask_embed"])
    md = pp["mask_downscaling"]
    for ours, theirs in (("conv1", "0"), ("ln1", "1"), ("conv2", "3"), ("ln2", "4"),
                         ("conv3", "6")):
        put_one = put_conv if ours.startswith("conv") else put_ln
        put_one(f"{pe}.mask_downscaling.{theirs}", md[ours])

    m, dd = "mask_decoder", mask_decoder

    def put_attn(prefix, p):
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put_lin(f"{prefix}.{name}", p[name])

    for i, layer in enumerate(dd["transformer"]["layers"]):
        t = f"{m}.transformer.layers.{i}"
        put_attn(f"{t}.self_attn", layer["self_attn"])
        put_ln(f"{t}.norm1", layer["norm1"])
        put_attn(f"{t}.cross_attn_token_to_image", layer["cross_attn_t2i"])
        put_ln(f"{t}.norm2", layer["norm2"])
        put_lin(f"{t}.mlp.lin1", layer["mlp"]["lin1"])
        put_lin(f"{t}.mlp.lin2", layer["mlp"]["lin2"])
        put_ln(f"{t}.norm3", layer["norm3"])
        put_ln(f"{t}.norm4", layer["norm4"])
        put_attn(f"{t}.cross_attn_image_to_token", layer["cross_attn_i2t"])
    put_attn(f"{m}.transformer.final_attn_token_to_image", dd["transformer"]["final_attn"])
    put_ln(f"{m}.transformer.norm_final_attn", dd["transformer"]["norm_final"])
    put(f"{m}.iou_token.weight", dd["iou_token"])
    put(f"{m}.mask_tokens.weight", dd["mask_tokens"])
    up = dd["output_upscaling"]
    put_conv(f"{m}.output_upscaling.0", up["convt1"], (2, 3, 0, 1))
    put_ln(f"{m}.output_upscaling.1", up["ln"])
    put_conv(f"{m}.output_upscaling.3", up["convt2"], (2, 3, 0, 1))
    for i, h in enumerate(dd["hypernetworks"]):
        for j, lin in enumerate(h["layers"]):
            put_lin(f"{m}.output_hypernetworks_mlps.{i}.layers.{j}", lin)
    for j, lin in enumerate(dd["iou_head"]["layers"]):
        put_lin(f"{m}.iou_prediction_head.layers.{j}", lin)
    return out


def load_jax_encoder(model: sam_lib.Sam, image_encoder: dict) -> sam_lib.Sam:
    """Install a JAX encoder pytree on ``model``, on the model's device: each
    linear given as packed fields replaces its ``Linear`` with a
    ``PackedLinear``, each one given as ``{"w", "b"}`` becomes a ``Linear``
    again, and every tensor of the encoder is loaded (strict)."""
    enc = model.image_encoder
    device = model.device
    sd, packed = _encoder_state_dict(image_encoder, model.config.image_encoder)
    for i, blk in enumerate(enc.blocks):
        for owner_name, name in BLOCK_LINEARS:
            owner = getattr(blk, owner_name)
            old = getattr(owner, name)
            fields = packed.get(f"blocks.{i}.{owner_name}.{name}")
            if fields is not None:
                new = PackedLinear(fields["in_features"], fields["out_features"],
                                   bits=fields["bits"], groupsize=fields["groupsize"],
                                   pack_block=fields["pack_block"],
                                   bias=f"blocks.{i}.{owner_name}.{name}.bias" in sd,
                                   act_bits=fields["act_bits"], sym=fields["sym"],
                                   device=device)
            elif isinstance(old, PackedLinear):
                new = Linear(old.in_features, old.out_features,
                             bias=f"blocks.{i}.{owner_name}.{name}.bias" in sd, device=device)
            else:
                continue
            setattr(owner, name, new)
    enc.load_state_dict(sd, strict=True)
    return model


def _np(t: torch.Tensor, perm=None) -> np.ndarray:
    a = t.detach().cpu()
    a = (a.float() if a.is_floating_point() else a).numpy()
    return a.transpose(perm) if perm is not None else a


def _lin_tree(get, has, name) -> Optional[dict]:
    """``{"w", "b"}`` of a dense linear, or None when ``name.weight`` is absent."""
    if not has(f"{name}.weight"):
        return None
    p = {"w": get(f"{name}.weight", (1, 0))}
    if has(f"{name}.bias"):
        p["b"] = get(f"{name}.bias")
    return p


def _jax_encoder_tree(sd: Dict[str, torch.Tensor], ecfg: ImageEncoderConfig,
                      prefix: str = "") -> dict:
    """The JAX encoder pytree (numpy) of an upstream-named dict of tensors:
    the inverse of :func:`_encoder_state_dict` for dense layers. A linear
    with no ``weight`` in ``sd`` (a packed one) is left as None."""

    def get(key, perm=None):
        return _np(sd[prefix + key], perm)

    def has(key):
        return prefix + key in sd

    def ln(name):
        return {"w": get(f"{name}.weight"), "b": get(f"{name}.bias")}

    def conv(name):
        return {"w": get(f"{name}.weight", (2, 3, 1, 0)),
                **({"b": get(f"{name}.bias")} if has(f"{name}.bias") else {})}

    tree = {
        "patch_embed": conv("patch_embed.proj"),
        "neck": {"conv1": conv("neck.0"), "ln1": ln("neck.1"),
                 "conv2": conv("neck.2"), "ln2": ln("neck.3")},
        "blocks": [],
    }
    if ecfg.use_abs_pos:
        tree["pos_embed"] = get("pos_embed")
    for i in range(ecfg.depth):
        b = f"blocks.{i}"
        blk = {"norm1": ln(f"{b}.norm1"),
               "attn": {"qkv": _lin_tree(get, has, f"{b}.attn.qkv"),
                        "proj": _lin_tree(get, has, f"{b}.attn.proj")},
               "norm2": ln(f"{b}.norm2"),
               "mlp": {"lin1": _lin_tree(get, has, f"{b}.mlp.lin1"),
                       "lin2": _lin_tree(get, has, f"{b}.mlp.lin2")}}
        if ecfg.use_rel_pos:
            blk["attn"]["rel_pos_h"] = get(f"{b}.attn.rel_pos_h")
            blk["attn"]["rel_pos_w"] = get(f"{b}.attn.rel_pos_w")
        tree["blocks"].append(blk)
    return tree


def to_jax_encoder(encoder) -> dict:
    """The JAX encoder pytree (numpy arrays; packed linears as their fields)
    of a port ``ImageEncoderViT``: the inverse of :func:`load_jax_encoder`."""
    tree = _jax_encoder_tree(encoder.state_dict(), encoder.cfg)
    for i, blk in enumerate(encoder.blocks):
        for owner_name, name in BLOCK_LINEARS:
            m = getattr(getattr(blk, owner_name), name)
            if isinstance(m, PackedLinear):
                tree["blocks"][i][owner_name][name] = {
                    **{k: None if getattr(m, k) is None else _np(getattr(m, k))
                       for k in ("qweight", "qweight_hi", "scales", "zeros", "bias")},
                    **{k: getattr(m, k) for k in _PACKED_FIELDS},
                }
    return tree


def to_jax_params(sd: Dict[str, torch.Tensor], cfg: SamConfig) -> Tuple[dict, dict, dict]:
    """The JAX ``Sam`` pytree's three subtrees (image encoder, prompt
    encoder, mask decoder; nested dicts and lists of numpy arrays) of an
    upstream-named dict of dense tensors: the inverse of
    :func:`from_jax_params`. The trainer's checkpoints write the model and
    its AdamW moments through it."""

    def get(key, perm=None):
        return _np(sd[key], perm)

    def has(key):
        return key in sd

    def lin(name):
        return _lin_tree(get, has, name)

    def ln(name):
        return {"w": get(f"{name}.weight"), "b": get(f"{name}.bias")}

    def conv(name, perm=(2, 3, 1, 0)):
        return {"w": get(f"{name}.weight", perm),
                **({"b": get(f"{name}.bias")} if has(f"{name}.bias") else {})}

    pe = "prompt_encoder"
    prompt = {
        "pe_gaussian": get(f"{pe}.pe_layer.positional_encoding_gaussian_matrix"),
        "point_embeddings": np.concatenate(
            [get(f"{pe}.point_embeddings.{i}.weight") for i in range(4)], axis=0),
        "not_a_point_embed": get(f"{pe}.not_a_point_embed.weight"),
        "no_mask_embed": get(f"{pe}.no_mask_embed.weight"),
        "mask_downscaling": {"conv1": conv(f"{pe}.mask_downscaling.0"),
                             "ln1": ln(f"{pe}.mask_downscaling.1"),
                             "conv2": conv(f"{pe}.mask_downscaling.3"),
                             "ln2": ln(f"{pe}.mask_downscaling.4"),
                             "conv3": conv(f"{pe}.mask_downscaling.6")},
    }

    m = "mask_decoder"
    mcfg = cfg.mask_decoder

    def attn(prefix):
        return {name: lin(f"{prefix}.{name}")
                for name in ("q_proj", "k_proj", "v_proj", "out_proj")}

    def mlp(prefix, n):
        return {"layers": [lin(f"{prefix}.layers.{j}") for j in range(n)]}

    layers = []
    for i in range(mcfg.transformer.depth):
        t = f"{m}.transformer.layers.{i}"
        layers.append({
            "self_attn": attn(f"{t}.self_attn"), "norm1": ln(f"{t}.norm1"),
            "cross_attn_t2i": attn(f"{t}.cross_attn_token_to_image"), "norm2": ln(f"{t}.norm2"),
            "mlp": {"lin1": lin(f"{t}.mlp.lin1"), "lin2": lin(f"{t}.mlp.lin2")},
            "norm3": ln(f"{t}.norm3"), "norm4": ln(f"{t}.norm4"),
            "cross_attn_i2t": attn(f"{t}.cross_attn_image_to_token"),
        })
    decoder = {
        "transformer": {"layers": layers,
                        "final_attn": attn(f"{m}.transformer.final_attn_token_to_image"),
                        "norm_final": ln(f"{m}.transformer.norm_final_attn")},
        "iou_token": get(f"{m}.iou_token.weight"),
        "mask_tokens": get(f"{m}.mask_tokens.weight"),
        "output_upscaling": {"convt1": conv(f"{m}.output_upscaling.0", (2, 3, 0, 1)),
                             "ln": ln(f"{m}.output_upscaling.1"),
                             "convt2": conv(f"{m}.output_upscaling.3", (2, 3, 0, 1))},
        "hypernetworks": [mlp(f"{m}.output_hypernetworks_mlps.{i}", 3)
                          for i in range(mcfg.num_mask_tokens)],
        "iou_head": mlp(f"{m}.iou_prediction_head", mcfg.iou_head_depth),
    }
    return _jax_encoder_tree(sd, cfg.image_encoder, "image_encoder."), prompt, decoder


def load_state_dict(model: sam_lib.Sam, sd: Dict[str, torch.Tensor]) -> sam_lib.Sam:
    """Load an upstream-named state dict (strict) and return the model."""
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _build(name: str, checkpoint: Optional[str] = None, *, device="cuda",
           seed: int = 0) -> sam_lib.Sam:
    cfg = CONFIGS[name]
    if checkpoint is None:
        return sam_lib.init(cfg, seed, device)
    model = sam_lib.Sam(cfg, device=device)  # raises before the load without a card
    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    return load_state_dict(model, sd)


def build_sam_vit_h(checkpoint=None, **kw):
    return _build("vit_h", checkpoint, **kw)


def build_sam_vit_l(checkpoint=None, **kw):
    return _build("vit_l", checkpoint, **kw)


def build_sam_vit_b(checkpoint=None, **kw):
    return _build("vit_b", checkpoint, **kw)


def build_sam_vit_tiny(checkpoint=None, **kw):
    return _build("vit_tiny", checkpoint, **kw)


sam_model_registry = {
    "default": build_sam_vit_h,
    "vit_h": build_sam_vit_h,
    "vit_l": build_sam_vit_l,
    "vit_b": build_sam_vit_b,
    "vit_tiny": build_sam_vit_tiny,
}
