"""Minimal numpy evaluator + structural checker for ONNX models.

The port's copy of the JAX package's ``export_onnx/runtime.py``, reading the
bytes through the port's own wire codec (:mod:`._wire`). There is no
``onnxruntime``, so artifacts from :mod:`.decoder_graph` and
:mod:`.encoder_graph` are validated by an independent interpreter: it
re-parses the serialized ``.onnx`` bytes and executes the graph with numpy,
op by op, per the opset-11 specs.

Implements exactly the core-domain subset the SAM graphs emit (see
``OnnxRuntime._exec``); unknown ops fail loudly rather than silently
skipping.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from sam_quantization_tpu_torch.export_onnx import _wire as W

try:  # exact erf: scipy if present, else math.erf vectorized
    from scipy.special import erf as _erf
except Exception:  # pragma: no cover
    _erf = np.vectorize(math.erf, otypes=[np.float64])

_ONNX_TO_NP = {
    W.FLOAT: np.float32,
    W.DOUBLE: np.float64,
    W.INT64: np.int64,
    W.INT32: np.int32,
    W.INT8: np.int8,
    W.UINT8: np.uint8,
    W.BOOL: np.bool_,
}


def tensor_to_numpy(t) -> np.ndarray:
    dtype = _ONNX_TO_NP[t.data_type]
    shape = tuple(t.dims)
    if t.raw_data:
        return np.frombuffer(t.raw_data, dtype=dtype).reshape(shape).copy()
    field = {
        W.FLOAT: t.float_data,
        W.DOUBLE: t.double_data,
        W.INT64: t.int64_data,
        W.INT32: t.int32_data,
    }[t.data_type]
    return np.asarray(list(field), dtype=dtype).reshape(shape)


def _attrs(node) -> dict:
    out = {}
    for a in node.attribute:
        if a.type == W.ATTR_FLOAT:
            out[a.name] = a.f
        elif a.type == W.ATTR_INT:
            out[a.name] = a.i
        elif a.type == W.ATTR_STRING:
            out[a.name] = a.s.decode()
        elif a.type == W.ATTR_INTS:
            out[a.name] = list(a.ints)
        elif a.type == W.ATTR_FLOATS:
            out[a.name] = list(a.floats)
        elif a.type == W.ATTR_TENSOR:
            out[a.name] = tensor_to_numpy(a.t)
        else:
            raise NotImplementedError(f"attribute type {a.type}")
    return out


def _softmax_coerced(x: np.ndarray, axis: int) -> np.ndarray:
    """Opset-11 Softmax: coerce to 2D [prod(:axis), prod(axis:)]."""
    shape = x.shape
    x2 = x.reshape(int(np.prod(shape[:axis], initial=1)), -1)
    m = x2.max(axis=1, keepdims=True)
    e = np.exp(x2 - m)
    return (e / e.sum(axis=1, keepdims=True)).reshape(shape).astype(x.dtype)


def _conv(x, w, b, strides, pads, kernel_shape):
    if any(pads):
        x = np.pad(
            x, ((0, 0), (0, 0), (pads[0], pads[2]), (pads[1], pads[3]))
        )
    kh, kw = kernel_shape
    sh, sw = strides
    N, C, H, W = x.shape
    O = w.shape[0]
    Ho = (H - kh) // sh + 1
    Wo = (W - kw) // sw + 1
    y = np.zeros((N, O, Ho, Wo), np.float32)
    for di in range(kh):
        for dj in range(kw):
            patch = x[:, :, di : di + sh * Ho : sh, dj : dj + sw * Wo : sw]
            y += np.einsum("nchw,oc->nohw", patch, w[:, :, di, dj])
    if b is not None:
        y += b.reshape(1, -1, 1, 1)
    return y.astype(np.float32)


def _conv_transpose(x, w, b, strides, kernel_shape):
    kh, kw = kernel_shape
    sh, sw = strides
    assert (kh, kw) == (sh, sw), "only kernel == stride emitted/supported"
    N, C, H, W = x.shape
    O = w.shape[1]
    y = np.zeros((N, O, H * sh, W * sw), np.float32)
    for di in range(kh):
        for dj in range(kw):
            y[:, :, di::sh, dj::sw] = np.einsum("nchw,co->nohw", x, w[:, :, di, dj])
    if b is not None:
        y += b.reshape(1, -1, 1, 1)
    return y.astype(np.float32)


def _resize_linear_half_pixel(x: np.ndarray, scales) -> np.ndarray:
    """Separable linear resize with half_pixel coords (Resize-11)."""
    out = x.astype(np.float32)
    for axis, s in enumerate(scales):
        if s == 1.0:
            continue
        n_in = out.shape[axis]
        n_out = int(np.floor(n_in * s))
        # Clamp the SOURCE coordinate before splitting into neighbors —
        # ORT's linear resize replicates edges this way (and jax.image
        # .resize matches); clamping the indices after the split instead
        # interpolates into row 1 at the border.
        pos = (np.arange(n_out, dtype=np.float64) + 0.5) / s - 0.5
        pos = np.clip(pos, 0.0, n_in - 1)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        frac = (pos - lo).astype(np.float32)
        a = np.take(out, lo, axis=axis)
        bv = np.take(out, hi, axis=axis)
        shape = [1] * out.ndim
        shape[axis] = n_out
        f = frac.reshape(shape)
        out = a * (1.0 - f) + bv * f
    return out.astype(np.float32)


class OnnxRuntime:
    """Load serialized ONNX bytes and run the graph with numpy."""

    def __init__(self, model_bytes: bytes):
        m = W.parse("ModelProto", model_bytes)
        self.model = m
        self.graph = m.graph
        self.opset = {o.domain: o.version for o in m.opset_import}
        self.initializers: Dict[str, np.ndarray] = {
            t.name: tensor_to_numpy(t) for t in self.graph.initializer
        }
        self.input_names = [
            vi.name for vi in self.graph.input
            if vi.name not in self.initializers
        ]
        self.output_names = [vi.name for vi in self.graph.output]
        check_model(m)

    def run(self, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        env: Dict[str, np.ndarray] = dict(self.initializers)
        for k in self.input_names:
            env[k] = np.asarray(feeds[k])
        for node in self.graph.node:
            ins = [env[i] if i else None for i in node.input]
            outs = self._exec(node, ins)
            for name, val in zip(node.output, outs):
                env[name] = val
        return {k: env[k] for k in self.output_names}

    def _exec(self, node, ins):
        op = node.op_type
        at = _attrs(node)
        a = ins[0] if ins else None
        if op == "MatMul":
            return [(ins[0].astype(np.float32) @ ins[1].astype(np.float32))]
        if op == "Add":
            return [ins[0] + ins[1]]
        if op == "Sub":
            return [ins[0] - ins[1]]
        if op == "Mul":
            return [ins[0] * ins[1]]
        if op == "Div":
            return [ins[0] / ins[1]]
        if op == "Sqrt":
            return [np.sqrt(a)]
        if op == "Erf":
            return [_erf(a.astype(np.float64)).astype(np.float32)]
        if op == "Sin":
            return [np.sin(a)]
        if op == "Cos":
            return [np.cos(a)]
        if op == "Relu":
            return [np.maximum(a, 0)]
        if op == "Sigmoid":
            return [(1.0 / (1.0 + np.exp(-a.astype(np.float32))))]
        if op == "Max":
            out = ins[0]
            for x in ins[1:]:
                out = np.maximum(out, x)
            return [out]
        if op == "Equal":
            return [ins[0] == ins[1]]
        if op == "Greater":
            return [ins[0] > ins[1]]
        if op == "Where":
            return [np.where(ins[0], ins[1], ins[2])]
        if op == "Cast":
            return [a.astype(_ONNX_TO_NP[at["to"]])]
        if op == "Softmax":
            return [_softmax_coerced(a, at.get("axis", 1))]
        if op == "Transpose":
            return [np.transpose(a, at["perm"])]
        if op == "Reshape":
            return [a.reshape([int(d) for d in ins[1]])]
        if op == "Concat":
            return [np.concatenate(ins, axis=at["axis"])]
        if op == "Slice":
            starts, ends, axes = (np.asarray(x).tolist() for x in ins[1:4])
            sl = [slice(None)] * a.ndim
            for s, e, ax in zip(starts, ends, axes):
                sl[ax] = slice(s, e)
            return [a[tuple(sl)]]
        if op == "Gather":
            return [np.take(a, ins[1].astype(np.int64), axis=at.get("axis", 0))]
        if op == "Unsqueeze":
            out = a
            for ax in sorted(at["axes"]):
                out = np.expand_dims(out, ax)
            return [out]
        if op == "ReduceMean":
            return [
                np.mean(a, axis=tuple(at["axes"]),
                        keepdims=bool(at.get("keepdims", 1)), dtype=np.float32)
            ]
        if op == "ReduceSum":
            return [
                np.sum(a, axis=tuple(at["axes"]),
                       keepdims=bool(at.get("keepdims", 1)), dtype=np.float32)
            ]
        if op == "ArgMax":
            out = np.argmax(a, axis=at.get("axis", 0)).astype(np.int64)
            if at.get("keepdims", 1):
                out = np.expand_dims(out, at.get("axis", 0))
            return [out]
        if op == "Expand":
            return [np.broadcast_to(a, [int(d) for d in ins[1]]).copy()]
        if op == "Conv":
            return [
                _conv(a, ins[1], ins[2] if len(ins) > 2 else None,
                      at["strides"], at.get("pads", [0, 0, 0, 0]),
                      at["kernel_shape"])
            ]
        if op == "ConvTranspose":
            return [
                _conv_transpose(a, ins[1], ins[2] if len(ins) > 2 else None,
                                at["strides"], at["kernel_shape"])
            ]
        if op == "Resize":
            assert at["mode"] == "linear"
            assert at["coordinate_transformation_mode"] == "half_pixel"
            return [_resize_linear_half_pixel(a, np.asarray(ins[2]).tolist())]
        raise NotImplementedError(f"op {op} (node {node.name})")


def check_model(model) -> None:
    """Structural validation (onnx.checker-lite): single core-domain opset,
    topologically sorted nodes, every input produced exactly once, graph
    outputs defined, initializer dtypes supported."""
    if not model.opset_import or model.opset_import[0].domain != "":
        raise ValueError("missing core-domain opset import")
    g = model.graph
    defined = {t.name for t in g.initializer}
    for vi in g.input:
        defined.add(vi.name)
    for node in g.node:
        for i in node.input:
            if i and i not in defined:
                raise ValueError(
                    f"node {node.name} ({node.op_type}) consumes undefined "
                    f"tensor {i!r} — graph not topologically sorted?"
                )
        for o in node.output:
            if o in defined:
                raise ValueError(f"tensor {o!r} defined twice")
            defined.add(o)
    for vi in g.output:
        if vi.name not in defined:
            raise ValueError(f"graph output {vi.name!r} never produced")
    for t in g.initializer:
        if t.data_type not in _ONNX_TO_NP:
            raise ValueError(f"initializer {t.name}: unsupported dtype")


def load(path_or_bytes) -> OnnxRuntime:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return OnnxRuntime(bytes(path_or_bytes))
    with open(path_or_bytes, "rb") as f:
        return OnnxRuntime(f.read())
