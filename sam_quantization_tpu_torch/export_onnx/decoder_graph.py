"""SAM prompt-encoder + mask-decoder as an explicit ONNX opset-11 graph.

The port's copy of the JAX package's ``export_onnx/decoder_graph.py``, node
for node, reading the JAX-layout numpy trees of the port's weights
(``build_sam.to_jax_decoder_params``; linear ``w`` is (in, out)). It is the
literal counterpart of the reference's ``SamOnnxModel`` export
(segment_anything/utils/onnx.py:17-144, scripts/export_onnx_model.py:97-200):
the same surface - fixed-size point prompts with the padding point appended
inside the graph, optional low-res mask input gated by ``has_mask_input``,
best-mask selection, full-resolution upsample - emitted as a hand-built
GraphProto rather than a torch trace.

I/O follows the reference's ONNX tensor convention (NCHW imagery):

- ``image_embeddings`` (1, 256, 64, 64)  - encoder output
- ``point_coords``     (1, N, 2) float   - (x, y) pixels in the 1024 frame
- ``point_labels``     (1, N) float      - 1 pos / 0 neg / 2,3 box corners
- ``mask_input``       (1, 1, 256, 256)  - low-res logits from a prior click
- ``has_mask_input``   (1,)              - 0/1 gate for ``mask_input``
- outputs: ``masks`` (1, K, 1024, 1024), ``iou_predictions`` (1, K),
  ``low_res_masks`` (1, K, 256, 256); K = 1 when ``return_single_mask``.

Numerics mirror :class:`sam_quantization_tpu_torch.export.SamDecoderModule`;
every op used is in the opset-11 core domain, so stock onnxruntime and the
browser ORT-web build both consume the artifact.
"""

from __future__ import annotations

import numpy as np

from sam_quantization_tpu_torch.export_onnx.builder import GraphBuilder
from sam_quantization_tpu_torch.models.build_sam import to_jax_decoder_params


def _dense_pe_tokens(pe: dict, h: int, w: int) -> np.ndarray:
    """get_dense_pe as a baked (1, h*w, C) constant (a pure function of the
    frozen pe_gaussian weights), computed in numpy as the JAX package does."""
    ys = (np.arange(h, dtype=np.float32) + 0.5) / h
    xs = (np.arange(w, dtype=np.float32) + 0.5) / w
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    grid = np.stack([gx, gy], axis=-1)  # (h, w, 2) [x, y]
    c = (2.0 * grid - 1.0) @ pe["pe_gaussian"]
    c = 2.0 * np.pi * c
    pe_grid = np.concatenate([np.sin(c), np.cos(c)], axis=-1)
    return pe_grid.reshape(1, h * w, -1).astype(np.float32)


def _mlp(g: GraphBuilder, x: str, layers: list, hint: str) -> str:
    """The mask decoder's MLP: relu between layers, none after the last."""
    n = len(layers)
    for i, lay in enumerate(layers):
        x = g.linear(x, lay["w"], lay.get("b"), f"{hint}{i}")
        if i < n - 1:
            x = g.relu(x)
    return x


def _attention(
    g: GraphBuilder, p: dict, q: str, k: str, v: str,
    nq: int, nk: int, num_heads: int, hint: str,
) -> str:
    """Projected multi-head attention (models/transformer.py)."""
    C = p["q_proj"]["w"].shape[1]
    hd = C // num_heads
    qh = g.linear(q, p["q_proj"]["w"], p["q_proj"].get("b"), hint + "_q")
    kh = g.linear(k, p["k_proj"]["w"], p["k_proj"].get("b"), hint + "_k")
    vh = g.linear(v, p["v_proj"]["w"], p["v_proj"].get("b"), hint + "_v")
    qh = g.transpose(g.reshape(qh, (1, nq, num_heads, hd)), (0, 2, 1, 3))
    kt = g.transpose(g.reshape(kh, (1, nk, num_heads, hd)), (0, 2, 3, 1))
    vh = g.transpose(g.reshape(vh, (1, nk, num_heads, hd)), (0, 2, 1, 3))
    logits = g.div(g.matmul(qh, kt), g.scalar(float(np.sqrt(hd))))
    attn = g.softmax_lastaxis(logits, rank=4)
    out = g.matmul(attn, vh)
    out = g.reshape(g.transpose(out, (0, 2, 1, 3)), (1, nq, C))
    return g.linear(out, p["out_proj"]["w"], p["out_proj"].get("b"), hint + "_o")


def _layer_norm2d_nchw(g, x, ln, eps):
    """Channel LayerNorm on NCHW (ref LayerNorm2d)."""
    return g.layer_norm(x, ln["w"], ln["b"], eps, axis_shape=(1, -1, 1, 1))


def build_decoder_graph(
    model,
    num_points: int = 8,
    return_single_mask: bool = True,
    use_stability_score: bool = False,
    stability_score_offset: float = 1.0,
):
    """Return a populated :class:`GraphBuilder` for ``model``'s decoder."""
    pe, md = to_jax_decoder_params(model.state_dict(), model.config)
    pcfg = model.config.prompt_encoder
    mcfg = model.config.mask_decoder
    tcfg = mcfg.transformer
    h, w = pcfg.image_embedding_size
    d = pcfg.embed_dim
    in_h, in_w = pcfg.input_image_size
    L = h * w
    n_mask_tokens = mcfg.num_mask_tokens
    N1 = num_points + 1  # + in-graph padding point (PromptEncoder.embed_points)

    g = GraphBuilder("sam_decoder")
    img_emb = g.add_input("image_embeddings", (1, d, h, w))
    coords_in = g.add_input("point_coords", (1, num_points, 2))
    labels_in = g.add_input("point_labels", (1, num_points))
    mask_in = g.add_input("mask_input", (1, 1, 4 * h, 4 * w))
    has_mask = g.add_input("has_mask_input", (1,))

    # ---- embed_points (models/prompt_encoder.py) ------------------------
    coords = g.add(coords_in, g.scalar(0.5))
    coords = g.concat(
        [coords, g.const(np.zeros((1, 1, 2), np.float32), "pad_pt")], axis=1
    )
    labels = g.concat(
        [labels_in, g.const(np.full((1, 1), -1.0, np.float32), "pad_lab")],
        axis=1,
    )
    norm = g.div(coords, g.const(np.array([in_w, in_h], np.float32), "wh"))
    c = g.sub(g.mul(norm, g.scalar(2.0)), g.scalar(1.0))
    c = g.matmul(c, g.init(pe["pe_gaussian"], "pe_gaussian"))
    c = g.mul(c, g.scalar(float(2.0 * np.pi)))
    pts = g.concat([g.sin(c), g.cos(c)], axis=2)  # (1, N1, d)
    lab = g.unsqueeze(labels, [2])  # (1, N1, 1)

    def lab_is(v: float) -> str:
        return g.equal(lab, g.scalar(v))

    zero = g.scalar(0.0)
    pts = g.where(lab_is(-1.0), zero, pts)
    pts = g.add(pts, g.where(lab_is(-1.0), g.init(pe["not_a_point_embed"][0], "nap"), zero))
    for li in range(4):  # labels 0/1 points, 2/3 box-corner slots
        pts = g.add(
            pts,
            g.where(
                lab_is(float(li)),
                g.init(pe["point_embeddings"][li], f"pt_emb{li}"),
                zero,
            ),
        )

    # ---- mask branch (PromptEncoder.embed_masks) -------------------------
    mdown = pe["mask_downscaling"]
    x = g.conv(mask_in, mdown["conv1"]["w"], mdown["conv1"].get("b"), stride=2)
    x = _layer_norm2d_nchw(g, x, mdown["ln1"], pcfg.ln_eps)
    x = g.gelu(x)
    x = g.conv(x, mdown["conv2"]["w"], mdown["conv2"].get("b"), stride=2)
    x = _layer_norm2d_nchw(g, x, mdown["ln2"], pcfg.ln_eps)
    x = g.gelu(x)
    mask_emb = g.conv(x, mdown["conv3"]["w"], mdown["conv3"].get("b"), stride=1)
    no_mask = g.init(
        pe["no_mask_embed"].reshape(1, d, 1, 1), "no_mask_embed"
    )
    gate = g.greater(g.reshape(has_mask, (1, 1, 1, 1)), g.scalar(0.5))
    dense = g.where(gate, mask_emb, no_mask)  # (1, d, h, w)

    # ---- token assembly (MaskDecoder.predict_masks) ----------------------
    output_tokens = np.concatenate([md["iou_token"], md["mask_tokens"]], 0)
    tokens = g.concat(
        [g.init(output_tokens[None], "output_tokens"), pts], axis=1
    )  # (1, 1 + n_mask_tokens + N1, d)
    n_tok = 1 + n_mask_tokens + N1

    src = g.reshape(g.transpose(img_emb, (0, 2, 3, 1)), (1, L, d))
    dense_tok = g.reshape(g.transpose(dense, (0, 2, 3, 1)), (1, L, d))
    src = g.add(src, dense_tok)
    img_pe = g.init(_dense_pe_tokens(pe, h, w), "image_pe")

    # ---- TwoWayTransformer (models/transformer.py) ------------------------
    nh = tcfg.num_heads
    queries, keys = tokens, src
    for i, lay in enumerate(md["transformer"]["layers"]):
        hint = f"l{i}"
        if i == 0:  # skip_first_layer_pe
            queries = _attention(
                g, lay["self_attn"], queries, queries, queries,
                n_tok, n_tok, nh, hint + "_self",
            )
        else:
            q = g.add(queries, tokens)
            queries = g.add(
                queries,
                _attention(g, lay["self_attn"], q, q, queries,
                           n_tok, n_tok, nh, hint + "_self"),
            )
        queries = g.layer_norm(queries, lay["norm1"]["w"], lay["norm1"]["b"], tcfg.ln_eps)

        q = g.add(queries, tokens)
        k = g.add(keys, img_pe)
        queries = g.add(
            queries,
            _attention(g, lay["cross_attn_t2i"], q, k, keys,
                       n_tok, L, nh, hint + "_t2i"),
        )
        queries = g.layer_norm(queries, lay["norm2"]["w"], lay["norm2"]["b"], tcfg.ln_eps)

        hmid = g.relu(g.linear(queries, lay["mlp"]["lin1"]["w"],
                               lay["mlp"]["lin1"].get("b"), hint + "_mlp1"))
        hout = g.linear(hmid, lay["mlp"]["lin2"]["w"],
                        lay["mlp"]["lin2"].get("b"), hint + "_mlp2")
        queries = g.add(queries, hout)
        queries = g.layer_norm(queries, lay["norm3"]["w"], lay["norm3"]["b"], tcfg.ln_eps)

        q = g.add(queries, tokens)
        k = g.add(keys, img_pe)
        keys = g.add(
            keys,
            _attention(g, lay["cross_attn_i2t"], k, q, queries,
                       L, n_tok, nh, hint + "_i2t"),
        )
        keys = g.layer_norm(keys, lay["norm4"]["w"], lay["norm4"]["b"], tcfg.ln_eps)

    q = g.add(queries, tokens)
    k = g.add(keys, img_pe)
    tf = md["transformer"]
    attn_out = _attention(
        g, tf["final_attn"], q, k, keys, n_tok, L, nh, "final"
    )
    queries = g.add(queries, attn_out)
    queries = g.layer_norm(
        queries, tf["norm_final"]["w"], tf["norm_final"]["b"], tcfg.ln_eps
    )

    # ---- heads + upscaling (MaskDecoder.predict_masks) -------------------
    iou_tok = g.reshape(g.slice(queries, [0], [1], [1]), (1, d))
    up = md["output_upscaling"]
    src_img = g.transpose(g.reshape(keys, (1, h, w, d)), (0, 3, 1, 2))
    x = g.conv_transpose(src_img, up["convt1"]["w"], up["convt1"].get("b"), 2)
    x = _layer_norm2d_nchw(g, x, up["ln"], mcfg.ln_eps)
    x = g.gelu(x)
    x = g.conv_transpose(x, up["convt2"]["w"], up["convt2"].get("b"), 2)
    upscaled = g.gelu(x)  # (1, d//8, 4h, 4w)

    hyper = []
    for i in range(n_mask_tokens):
        tok = g.reshape(g.slice(queries, [1 + i], [2 + i], [1]), (1, d))
        hyper.append(
            g.unsqueeze(_mlp(g, tok, md["hypernetworks"][i]["layers"], f"hyp{i}_"), [1])
        )
    hyper_in = g.concat(hyper, axis=1)  # (1, n_mask_tokens, d//8)
    up_flat = g.reshape(upscaled, (1, d // 8, 16 * L))
    masks = g.reshape(
        g.matmul(hyper_in, up_flat), (1, n_mask_tokens, 4 * h, 4 * w)
    )
    iou_pred = _mlp(g, iou_tok, md["iou_head"]["layers"], "iou_")  # (1, n_mask_tokens)

    # multimask_output=True slice (MaskDecoder.forward)
    masks = g.slice(masks, [1], [n_mask_tokens], [1])
    iou_pred = g.slice(iou_pred, [1], [n_mask_tokens], [1])
    n_out = n_mask_tokens - 1

    # ---- selection + upsample (export.SamDecoderModule) ------------------
    scores = iou_pred
    if use_stability_score:
        hi = g.reduce_sum(
            g.cast(g.greater(masks, g.scalar(stability_score_offset)), 1),
            [2, 3], keepdims=False,
        )
        lo = g.reduce_sum(
            g.cast(g.greater(masks, g.scalar(-stability_score_offset)), 1),
            [2, 3], keepdims=False,
        )
        scores = g.div(hi, g.node("Max", [lo, g.scalar(1.0)]))
    if return_single_mask:
        best = g.argmax(scores, axis=1, keepdims=False)  # (1,) int64
        take = g.gather(masks, best, axis=1)             # (1, 1, 4h, 4w)
        iou_out = g.gather(iou_pred, best, axis=1)       # (1, 1)
        n_out = 1
    else:
        take, iou_out = masks, iou_pred

    size_scale = float(model.config.image_encoder.img_size) / (4 * h)
    full = g.resize_linear(take, [1.0, 1.0, size_scale, size_scale])

    g.mark_output(full, (1, n_out, in_h, in_w))
    g.outputs[-1].name = full
    g.mark_output(iou_out, (1, n_out))
    g.mark_output(take, (1, n_out, 4 * h, 4 * w))
    # Stable interface names for ORT/browser callers (ref onnx.py output
    # names): rename the three graph outputs in place.
    renames = {full: "masks", iou_out: "iou_predictions", take: "low_res_masks"}
    for vi in g.outputs:
        vi.name = renames[vi.name]
    for node in g.nodes:
        for j, o in enumerate(node.output):
            if o in renames:
                node.output[j] = renames[o]
        for j, s in enumerate(node.input):
            if s in renames:
                node.input[j] = renames[s]
    return g
