"""Typed ONNX GraphProto builder (the port's copy of the JAX package's
``export_onnx/builder.py``, on the messages of :mod:`._wire`).

Every method appends one NodeProto and returns the (unique) output name, so
graph construction reads like the math it encodes. Counterpart of the
reference's torch.onnx trace step (scripts/export_onnx_model.py:97-144):
the graph is constructed explicitly, node for node as the JAX package
builds it, so the two packages' artifacts are byte-identical for the same
weights and producer string.

Opset-11 notes baked into the helpers:
- ``Softmax`` uses the coerce-to-2D semantics; only last-axis softmax is
  exposed (what SAM needs) so the coercion is a no-op.
- ``Unsqueeze``/``Squeeze``/``Slice``/``Reduce*`` take axes as ATTRIBUTES
  (they moved to inputs only in opset 13).
- LayerNorm/GELU do not exist as single ops; ``layer_norm``/``gelu`` emit
  the canonical decompositions (ReduceMean/Sub/Mul/Sqrt/Div and
  0.5x(1+Erf(x/sqrt2))) that ORT's fusion passes re-fuse.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

from sam_quantization_tpu_torch.export_onnx import _wire as W
from sam_quantization_tpu_torch.export_onnx._wire import MAX_MESSAGE_BYTES, Message

PRODUCER = "sam_quantization_tpu_torch"
_NP_TO_ONNX = {
    np.dtype(np.float32): W.FLOAT,
    np.dtype(np.float64): W.DOUBLE,
    np.dtype(np.int64): W.INT64,
    np.dtype(np.int32): W.INT32,
    np.dtype(np.int8): W.INT8,
    np.dtype(np.uint8): W.UINT8,
    np.dtype(np.bool_): W.BOOL,
}


def tensor_proto(name: str, arr: np.ndarray) -> Message:
    return Message("TensorProto", dims=list(arr.shape), data_type=_NP_TO_ONNX[arr.dtype],
                   name=name, raw_data=np.ascontiguousarray(arr).tobytes())


def value_info(name: str, shape: Sequence[int], elem_type=W.FLOAT) -> Message:
    dims = [Message("TensorShapeProto.Dimension", dim_value=int(d)) for d in shape]
    tensor = Message("TypeProto.Tensor", elem_type=elem_type,
                     shape=Message("TensorShapeProto", dim=dims) if dims else None)
    return Message("ValueInfoProto", name=name,
                   type=Message("TypeProto", tensor_type=tensor))


def _attribute(name: str, v) -> Message:
    a = Message("AttributeProto", name=name)
    if isinstance(v, str):
        a.type, a.s = W.ATTR_STRING, v.encode()
    elif isinstance(v, float):
        a.type, a.f = W.ATTR_FLOAT, v
    elif isinstance(v, (bool, int, np.integer)):
        a.type, a.i = W.ATTR_INT, int(v)
    elif isinstance(v, (list, tuple)) and all(isinstance(x, (int, np.integer)) for x in v):
        a.type, a.ints = W.ATTR_INTS, [int(x) for x in v]
    elif isinstance(v, (list, tuple)) and all(isinstance(x, float) for x in v):
        a.type, a.floats = W.ATTR_FLOATS, list(v)
    else:
        raise TypeError(f"unsupported attribute {name}={v!r}")
    return a


class GraphBuilder:
    def __init__(self, name: str):
        self.name = name
        self.nodes: list = []
        self.initializers: list = []
        self.inputs: list = []
        self.outputs: list = []
        self._n = 0
        self._const_cache: dict = {}
        self.nbytes = 0  # bytes of the initializers' data so far

    # -- plumbing ---------------------------------------------------------

    def _fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def add_input(self, name: str, shape: Sequence[int], elem_type=W.FLOAT):
        self.inputs.append(value_info(name, shape, elem_type))
        return name

    def mark_output(self, name: str, shape: Sequence[int], elem_type=W.FLOAT):
        self.outputs.append(value_info(name, shape, elem_type))
        return name

    def init(self, arr: np.ndarray, name_hint: str = "w") -> str:
        """Add a weight/constant initializer, returning its tensor name.
        ``ValueError`` once the initializers pass protobuf's 2 GiB limit on
        one message (no external-data form is written), before the one
        that passes it is copied."""
        arr = np.asarray(arr)
        self.nbytes += arr.nbytes
        if self.nbytes > MAX_MESSAGE_BYTES:
            raise ValueError(
                f"the ONNX graph {self.name!r} holds more than {self.nbytes - arr.nbytes} bytes "
                f"of initializers and {name_hint!r} adds {arr.nbytes}, past protobuf's limit "
                f"of 2 GiB - 1 ({MAX_MESSAGE_BYTES}) bytes for one ModelProto")
        name = self._fresh(name_hint)
        self.initializers.append(tensor_proto(name, arr))
        return name

    def const(self, arr, name_hint: str = "c", dtype=None) -> str:
        """Deduplicated small constant initializer."""
        a = np.asarray(arr, dtype=dtype)
        key = (a.dtype.str, a.shape, a.tobytes())
        if key not in self._const_cache:
            self._const_cache[key] = self.init(a, name_hint)
        return self._const_cache[key]

    def node(self, op_type: str, inputs: Iterable[str], n_outputs: int = 1,
             name_hint: Optional[str] = None, **attrs):
        outs = [self._fresh(name_hint or op_type.lower()) for _ in range(n_outputs)]
        self.nodes.append(Message(
            "NodeProto", input=list(inputs), output=outs, name=outs[0] + "_node",
            op_type=op_type, attribute=[_attribute(k, v) for k, v in attrs.items()]))
        return outs[0] if n_outputs == 1 else outs

    # -- elementwise / math ------------------------------------------------

    def add(self, a, b):
        return self.node("Add", [a, b])

    def sub(self, a, b):
        return self.node("Sub", [a, b])

    def mul(self, a, b):
        return self.node("Mul", [a, b])

    def div(self, a, b):
        return self.node("Div", [a, b])

    def sqrt(self, a):
        return self.node("Sqrt", [a])

    def erf(self, a):
        return self.node("Erf", [a])

    def sin(self, a):
        return self.node("Sin", [a])

    def cos(self, a):
        return self.node("Cos", [a])

    def relu(self, a):
        return self.node("Relu", [a])

    def equal(self, a, b):
        return self.node("Equal", [a, b])

    def greater(self, a, b):
        return self.node("Greater", [a, b])

    def where(self, cond, a, b):
        return self.node("Where", [cond, a, b])

    def cast(self, a, to):
        return self.node("Cast", [a], to=int(to))

    def scalar(self, v: float) -> str:
        return self.const(np.float32(v).reshape(()), "scalar")

    def gelu(self, x):
        """erf-GELU (torch nn.GELU default)."""
        inner = self.div(x, self.scalar(float(np.sqrt(2.0))))
        return self.mul(
            self.mul(x, self.scalar(0.5)),
            self.add(self.scalar(1.0), self.erf(inner)),
        )

    # -- linear algebra -----------------------------------------------------

    def matmul(self, a, b):
        return self.node("MatMul", [a, b])

    def linear(self, x, w: np.ndarray, b: Optional[np.ndarray], hint="lin"):
        """x @ w + b with (K, N) weights (the JAX package's linear layout)."""
        y = self.node("MatMul", [x, self.init(np.asarray(w, np.float32), hint + "_w")])
        if b is not None:
            y = self.node("Add", [y, self.init(np.asarray(b, np.float32), hint + "_b")])
        return y

    def softmax_lastaxis(self, x, rank: int):
        # Opset-11 Softmax coerces to 2D around `axis`; for axis == rank-1
        # that is exactly a last-axis softmax.
        return self.node("Softmax", [x], axis=rank - 1)

    def transpose(self, x, perm):
        return self.node("Transpose", [x], perm=list(perm))

    def reshape(self, x, shape):
        return self.node("Reshape", [x, self.const(np.asarray(shape, np.int64), "shape")])

    def concat(self, xs, axis):
        return self.node("Concat", list(xs), axis=axis)

    def slice(self, x, starts, ends, axes):
        return self.node(
            "Slice",
            [
                x,
                self.const(np.asarray(starts, np.int64), "starts"),
                self.const(np.asarray(ends, np.int64), "ends"),
                self.const(np.asarray(axes, np.int64), "axes"),
            ],
        )

    def gather(self, x, indices, axis):
        return self.node("Gather", [x, indices], axis=axis)

    def unsqueeze(self, x, axes):
        return self.node("Unsqueeze", [x], axes=list(axes))

    def reduce_mean(self, x, axes, keepdims=True):
        return self.node("ReduceMean", [x], axes=list(axes), keepdims=int(keepdims))

    def reduce_sum(self, x, axes, keepdims=True):
        return self.node("ReduceSum", [x], axes=list(axes), keepdims=int(keepdims))

    def argmax(self, x, axis, keepdims=False):
        return self.node("ArgMax", [x], axis=axis, keepdims=int(keepdims))

    def layer_norm(self, x, w: np.ndarray, b: np.ndarray, eps: float, axis_shape=None):
        """Last-axis LayerNorm decomposition.

        ``axis_shape``: reshape target for the scale/bias when normalizing a
        non-last axis (e.g. (1, C, 1, 1) for NCHW channel LN).
        """
        axes = [-1] if axis_shape is None else [1]
        mean = self.reduce_mean(x, axes)
        centered = self.sub(x, mean)
        var = self.reduce_mean(self.mul(centered, centered), axes)
        rstd = self.div(self.scalar(1.0), self.sqrt(self.add(var, self.scalar(eps))))
        y = self.mul(centered, rstd)
        wv = np.asarray(w, np.float32)
        bv = np.asarray(b, np.float32)
        if axis_shape is not None:
            wv = wv.reshape(axis_shape)
            bv = bv.reshape(axis_shape)
        return self.add(self.mul(y, self.init(wv, "ln_w")), self.init(bv, "ln_b"))

    def conv(self, x, w_hwio: np.ndarray, b: Optional[np.ndarray], stride: int, pad: int = 0):
        """NCHW Conv from an HWIO kernel."""
        w = np.ascontiguousarray(np.transpose(np.asarray(w_hwio, np.float32), (3, 2, 0, 1)))
        kh, kw = w.shape[2], w.shape[3]
        ins = [x, self.init(w, "conv_w")]
        if b is not None:
            ins.append(self.init(np.asarray(b, np.float32), "conv_b"))
        return self.node(
            "Conv", ins, kernel_shape=[kh, kw], strides=[stride, stride],
            pads=[pad, pad, pad, pad],
        )

    def conv_transpose(self, x, w_hwio: np.ndarray, b: Optional[np.ndarray], stride: int):
        """NCHW ConvTranspose from an HWIO kernel; kernel == stride, no pad
        (the only form SAM uses: the mask decoder's output upscaling)."""
        w = np.ascontiguousarray(np.transpose(np.asarray(w_hwio, np.float32), (2, 3, 0, 1)))
        kh, kw = w.shape[2], w.shape[3]
        ins = [x, self.init(w, "convt_w")]
        if b is not None:
            ins.append(self.init(np.asarray(b, np.float32), "convt_b"))
        return self.node(
            "ConvTranspose", ins, kernel_shape=[kh, kw],
            strides=[stride, stride], pads=[0, 0, 0, 0],
        )

    def resize_linear(self, x, scales: Sequence[float]):
        """Opset-11 Resize, linear, half_pixel (``jax.image.resize``
        'bilinear' when upsampling)."""
        roi = self.const(np.zeros((0,), np.float32), "roi")
        sc = self.const(np.asarray(scales, np.float32), "scales")
        return self.node(
            "Resize", [x, roi, sc], mode="linear",
            coordinate_transformation_mode="half_pixel",
        )

    # -- assembly -----------------------------------------------------------

    def build_model(self, opset: int = 11, producer: str = PRODUCER) -> Message:
        graph = Message("GraphProto", node=list(self.nodes), name=self.name,
                        initializer=list(self.initializers), input=list(self.inputs),
                        output=list(self.outputs))
        return Message("ModelProto", ir_version=W.IR_VERSION, producer_name=producer,
                       producer_version="0.4", graph=graph,
                       opset_import=[Message("OperatorSetIdProto", domain="", version=opset)])
