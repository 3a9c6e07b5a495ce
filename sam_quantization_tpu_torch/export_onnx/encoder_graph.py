"""SAM ViT image encoder as an explicit ONNX opset-11 graph.

The port's copy of the JAX package's ``export_onnx/encoder_graph.py``, node
for node, reading the JAX-layout numpy tree of the port's encoder weights
(``build_sam.to_jax_params``). Counterpart of the reference's PPQ-path
encoder export (``script/custimized_quant.py:334-344``:
``torch.onnx.export(model.image_encoder, opset 11)``).

I/O (reference ONNX tensor convention, NCHW):

- ``input`` (1, 3, S, S) float - the preprocessed (normalized, padded)
  image, what ``image_encoder(images)`` consumes;
- output ``image_embeddings`` (1, out_chans, G, G) - plugs straight into
  the decoder graph's ``image_embeddings`` input.

Design notes:
- Window partition/unpartition are static Reshape/Transpose chains with
  zero-padding via Concat (no Pad op needed; shapes are compile-time).
- The decomposed rel-pos bias uses the upstream einsum semantics
  (``bhwc,hkc`` / ``bhwc,wkc``); the rel_w einsum is emitted as
  transpose->matmul->transpose so the batched MatMul broadcast contracts the
  w-indexed table.
- ``get_rel_pos`` index selection is a pure function of static sizes, so
  Rh/Rw land in the graph as pre-gathered (q, k, hd) constants, computed in
  numpy as the JAX package computes them.

One ``ModelProto`` holds every weight, and protobuf caps a message at 2 GiB:
the :class:`~.builder.GraphBuilder` counts the initializers as it adds them
and refuses an encoder past the cap (ViT-H's float32 weights take about
2.5 GB) before anything is serialized.
"""

from __future__ import annotations

import numpy as np

from sam_quantization_tpu_torch.export_onnx.builder import GraphBuilder
from sam_quantization_tpu_torch.models.build_sam import to_jax_encoder
from sam_quantization_tpu_torch.models.image_encoder import BLOCK_LINEARS


def _rel_table(rel_pos: np.ndarray, q_size: int, k_size: int) -> np.ndarray:
    """get_rel_pos at export time (the JAX package's, with its linear
    resize of a table of another length)."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        # linear resize along axis 0 (jax.image.resize 'linear')
        src = rel_pos
        n, c = src.shape
        pos = (np.arange(max_rel_dist) + 0.5) * n / max_rel_dist - 0.5
        lo = np.clip(np.floor(pos).astype(int), 0, n - 1)
        hi = np.clip(lo + 1, 0, n - 1)
        t = np.clip(pos - lo, 0.0, 1.0)[:, None]
        rel_pos = src[lo] * (1 - t) + src[hi] * t
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.astype(np.int64)]  # (q, k, hd)


def _attention(g: GraphBuilder, p: dict, x: str, nw: int, gh: int, gw: int,
               nh: int, hd: int, hint: str) -> str:
    """Windowed/global attention on (NW, gh*gw, C) tokens with decomposed
    rel-pos bias (the encoder's eager path)."""
    C = nh * hd
    L = gh * gw
    qkv = g.linear(x, p["qkv"]["w"], p["qkv"].get("b"), hint + "_qkv")
    outs = []
    parts = {}
    for i, name in enumerate(("q", "k", "v")):
        s = g.slice(qkv, [i * C], [(i + 1) * C], [2])  # (NW, L, C)
        s = g.reshape(s, (nw, L, nh, hd))
        parts[name] = g.transpose(s, (0, 2, 1, 3))  # (NW, nh, L, hd)
    scale = float(hd) ** -0.5
    qs = g.mul(parts["q"], g.scalar(scale))
    kt = g.transpose(parts["k"], (0, 1, 3, 2))
    logits = g.matmul(qs, kt)  # (NW, nh, L, L)

    if "rel_pos_h" in p:
        Rh = _rel_table(p["rel_pos_h"], gh, gh)  # (gh, gh, hd)
        Rw = _rel_table(p["rel_pos_w"], gw, gw)  # (gw, gw, hd)
        rq = g.reshape(parts["q"], (nw * nh, gh, gw, hd))
        # rel_h = einsum('bhwc,hkc->bhwk'): batched MatMul with RhT (gh, hd,
        # gh) broadcasts the h batch dim - the h-indexed contraction.
        rel_h = g.matmul(
            rq, g.init(np.ascontiguousarray(Rh.transpose(0, 2, 1)), hint + "_RhT")
        )  # (B, gh, gw, gh)
        # rel_w = einsum('bhwc,wkc->bhwk'): transpose so w leads the batch,
        # contract the w-indexed table, transpose back (upstream semantics).
        rqw = g.transpose(rq, (0, 2, 1, 3))  # (B, gw, gh, hd)
        rel_w = g.matmul(
            rqw, g.init(np.ascontiguousarray(Rw.transpose(0, 2, 1)), hint + "_RwT")
        )  # (B, gw, gh, gw)
        rel_w = g.transpose(rel_w, (0, 2, 1, 3))  # (B, gh, gw, gw)
        bias = g.add(
            g.unsqueeze(rel_h, [4]),  # (B, gh, gw, gh, 1)
            g.unsqueeze(rel_w, [3]),  # (B, gh, gw, 1, gw)
        )  # (B, gh, gw, gh, gw)
        logits = g.add(logits, g.reshape(bias, (nw, nh, L, L)))

    attn = g.softmax_lastaxis(logits, rank=4)
    out = g.matmul(attn, parts["v"])  # (NW, nh, L, hd)
    out = g.reshape(g.transpose(out, (0, 2, 1, 3)), (nw, L, C))
    return g.linear(out, p["proj"]["w"], p["proj"].get("b"), hint + "_proj")


def build_encoder_graph(model):
    """Return a populated :class:`GraphBuilder` for ``model``'s image
    encoder (input "input" NCHW preprocessed image -> "image_embeddings").
    Its linears must be dense."""
    ecfg = model.config.image_encoder
    enc = to_jax_encoder(model.image_encoder)
    if any(blk[owner][name] is None or "w" not in blk[owner][name]
           for blk in enc["blocks"] for owner, name in BLOCK_LINEARS):
        raise ValueError("the ONNX encoder takes dense linears (no PackedLinear or IntLinear)")
    S = ecfg.img_size
    G = ecfg.grid_size
    C = ecfg.embed_dim
    nh, hd = ecfg.num_heads, ecfg.head_dim

    g = GraphBuilder("sam_image_encoder")
    img = g.add_input("input", (1, 3, S, S))

    x = g.conv(img, enc["patch_embed"]["w"], enc["patch_embed"].get("b"),
               stride=ecfg.patch_size)  # (1, C, G, G)
    x = g.transpose(x, (0, 2, 3, 1))  # NHWC tokens (1, G, G, C)
    if ecfg.use_abs_pos:
        x = g.add(x, g.init(enc["pos_embed"], "pos_embed"))

    for i in range(ecfg.depth):
        p = enc["blocks"][i]
        hint = f"b{i}"
        ws = ecfg.block_window(i)
        shortcut = x
        h = g.layer_norm(x, p["norm1"]["w"], p["norm1"]["b"], ecfg.ln_eps)
        if ws > 0:
            pad = (-G) % ws
            Gp = G + pad
            nw = (Gp // ws) ** 2
            if pad:
                # zero-pad H then W via Concat (static shapes)
                zh = g.const(np.zeros((1, pad, G, C), np.float32), hint + "_zh")
                h = g.concat([h, zh], axis=1)
                zw = g.const(np.zeros((1, Gp, pad, C), np.float32), hint + "_zw")
                h = g.concat([h, zw], axis=2)
            h = g.reshape(h, (1, Gp // ws, ws, Gp // ws, ws, C))
            h = g.transpose(h, (0, 1, 3, 2, 4, 5))
            h = g.reshape(h, (nw, ws * ws, C))
            h = _attention(g, p["attn"], h, nw, ws, ws, nh, hd, hint)
            h = g.reshape(h, (1, Gp // ws, Gp // ws, ws, ws, C))
            h = g.transpose(h, (0, 1, 3, 2, 4, 5))
            h = g.reshape(h, (1, Gp, Gp, C))
            if pad:
                h = g.slice(h, [0, 0], [G, G], [1, 2])
        else:
            h = g.reshape(h, (1, G * G, C))
            h = _attention(g, p["attn"], h, 1, G, G, nh, hd, hint)
            h = g.reshape(h, (1, G, G, C))
        x = g.add(shortcut, h)
        h = g.layer_norm(x, p["norm2"]["w"], p["norm2"]["b"], ecfg.ln_eps)
        h = g.linear(h, p["mlp"]["lin1"]["w"], p["mlp"]["lin1"].get("b"),
                     hint + "_mlp1")
        h = g.gelu(h)
        h = g.linear(h, p["mlp"]["lin2"]["w"], p["mlp"]["lin2"].get("b"),
                     hint + "_mlp2")
        x = g.add(x, h)

    # neck: NCHW convs + channel LN
    x = g.transpose(x, (0, 3, 1, 2))  # (1, C, G, G)
    nk = enc["neck"]
    x = g.conv(x, nk["conv1"]["w"], nk["conv1"].get("b"), stride=1)
    x = g.layer_norm(x, nk["ln1"]["w"], nk["ln1"]["b"], ecfg.ln_eps,
                     axis_shape=(1, -1, 1, 1))
    x = g.conv(x, nk["conv2"]["w"], nk["conv2"].get("b"), stride=1, pad=1)
    x = g.layer_norm(x, nk["ln2"]["w"], nk["ln2"]["b"], ecfg.ln_eps,
                     axis_shape=(1, -1, 1, 1))

    out = ecfg.out_chans
    g.mark_output(x, (1, out, G, G))
    g.outputs[-1].name = x
    # stable interface name
    for node in g.nodes:
        for j, o in enumerate(node.output):
            if o == x:
                node.output[j] = "image_embeddings"
    g.outputs[-1].name = "image_embeddings"
    return g
