"""The protobuf wire format of the ONNX messages the exporter writes and reads.

The JAX package builds its ONNX message classes from the committed
descriptor through ``google.protobuf``; the port needs no protobuf package.
It keeps its own table of the fields the exporter and the runtime use
(name, number, type; the upstream ``onnx.proto``, proto2), holds a message
as a :class:`Message` of plain Python values, and writes and reads the wire
format itself:

* fields go out in field-number order, as protobuf's serializers write them
  (ModelProto's ``graph`` (7) before ``opset_import`` (8), which the schema
  declares second);
* a singular field is written when it is set, even to its default (proto2
  presence: the opset import's empty ``domain`` is written); a repeated one
  when it has elements;
* integers are varints, a negative one as its 64-bit two's complement (ten
  bytes); ``float`` is fixed32 and ``double`` fixed64, little-endian;
* repeated scalars are unpacked unless the schema packs them:
  ``TensorProto.dims`` and ``AttributeProto.ints`` / ``floats`` are unpacked,
  ``TensorProto.float_data`` / ``int32_data`` / ``int64_data`` /
  ``double_data`` packed. The reader takes either form, as protobuf's do.

A message may not exceed 2 GiB - 1 bytes (protobuf's limit):
:func:`serialize` reckons the size before it joins any byte and raises
``ValueError`` past it. Fields the table does not know are skipped when read.
"""

from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple, Tuple

MAX_MESSAGE_BYTES = 2**31 - 1  # protobuf's limit on one serialized message

# TensorProto.DataType
FLOAT, UINT8, INT8, INT32, INT64, BOOL, DOUBLE = 1, 2, 3, 6, 7, 9, 11
# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR, ATTR_FLOATS, ATTR_INTS = 1, 2, 3, 4, 6, 7
# IR version 7 (2020-5-8): what torch and tf2onnx emit for opset 11-13
# exports, accepted by every onnxruntime since 1.2.
IR_VERSION = 7

VARINT, I64, LEN, I32 = 0, 1, 2, 5  # wire types
_SCALARS = {"int64": VARINT, "int32": VARINT, "float": I32, "double": I64,
            "string": LEN, "bytes": LEN}


class Field(NamedTuple):
    number: int
    kind: str  # a scalar kind of _SCALARS, or a message name of SCHEMA
    repeated: bool = False
    packed: bool = False


_R, _P = {"repeated": True}, {"repeated": True, "packed": True}
SCHEMA: Dict[str, Dict[str, Field]] = {
    "ModelProto": {
        "ir_version": Field(1, "int64"),
        "producer_name": Field(2, "string"),
        "producer_version": Field(3, "string"),
        "graph": Field(7, "GraphProto"),
        "opset_import": Field(8, "OperatorSetIdProto", **_R),
    },
    "OperatorSetIdProto": {
        "domain": Field(1, "string"),
        "version": Field(2, "int64"),
    },
    "GraphProto": {
        "node": Field(1, "NodeProto", **_R),
        "name": Field(2, "string"),
        "initializer": Field(5, "TensorProto", **_R),
        "input": Field(11, "ValueInfoProto", **_R),
        "output": Field(12, "ValueInfoProto", **_R),
    },
    "NodeProto": {
        "input": Field(1, "string", **_R),
        "output": Field(2, "string", **_R),
        "name": Field(3, "string"),
        "op_type": Field(4, "string"),
        "attribute": Field(5, "AttributeProto", **_R),
    },
    "AttributeProto": {
        "name": Field(1, "string"),
        "f": Field(2, "float"),
        "i": Field(3, "int64"),
        "s": Field(4, "bytes"),
        "t": Field(5, "TensorProto"),
        "floats": Field(7, "float", **_R),
        "ints": Field(8, "int64", **_R),
        "type": Field(20, "int32"),
    },
    "TensorProto": {
        "dims": Field(1, "int64", **_R),
        "data_type": Field(2, "int32"),
        "float_data": Field(4, "float", **_P),
        "int32_data": Field(5, "int32", **_P),
        "int64_data": Field(7, "int64", **_P),
        "name": Field(8, "string"),
        "raw_data": Field(9, "bytes"),
        "double_data": Field(10, "double", **_P),
    },
    "ValueInfoProto": {
        "name": Field(1, "string"),
        "type": Field(2, "TypeProto"),
    },
    "TypeProto": {
        "tensor_type": Field(1, "TypeProto.Tensor"),
    },
    "TypeProto.Tensor": {
        "elem_type": Field(1, "int32"),
        "shape": Field(2, "TensorShapeProto"),
    },
    "TensorShapeProto": {
        "dim": Field(1, "TensorShapeProto.Dimension", **_R),
    },
    "TensorShapeProto.Dimension": {
        "dim_value": Field(1, "int64"),
    },
}
_ORDERED = {m: sorted(fields.items(), key=lambda kv: kv[1].number)
            for m, fields in SCHEMA.items()}
_BY_NUMBER = {m: {f.number: (name, f) for name, f in fields.items()}
              for m, fields in SCHEMA.items()}


class Message:
    """One ONNX message: each field of ``SCHEMA[type_name]`` is an attribute,
    None (absent) or its value for a singular field, a list for a repeated
    one; a message-typed field holds a :class:`Message`."""

    def __init__(self, type_name: str, **values):
        object.__setattr__(self, "type_name", type_name)
        for name, f in SCHEMA[type_name].items():
            object.__setattr__(self, name, [] if f.repeated else None)
        for name, value in values.items():
            setattr(self, name, value)

    def __setattr__(self, name, value):
        if name not in SCHEMA[self.type_name]:
            raise AttributeError(f"{self.type_name} has no field {name!r}")
        object.__setattr__(self, name, value)

    def __eq__(self, other):
        return (isinstance(other, Message) and other.type_name == self.type_name
                and all(getattr(self, n) == getattr(other, n) for n in SCHEMA[self.type_name]))


# ------------------------------------------------------------------ writing
def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1  # a negative int64 or int32 goes out as 10 bytes
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _key(number: int, wire_type: int) -> bytes:
    return _varint(number << 3 | wire_type)


def _scalar(kind: str, v) -> bytes:
    if kind in ("int64", "int32"):
        return _varint(int(v))
    if kind == "float":
        return struct.pack("<f", v)
    if kind == "double":
        return struct.pack("<d", v)
    raise TypeError(kind)


def _chunks(msg: Message, out: List[bytes]) -> int:
    """Append ``msg``'s encoding to ``out`` piece by piece (a tensor's raw
    bytes as they are, uncopied); return its length."""
    size = 0

    def emit(*pieces):
        nonlocal size
        out.extend(pieces)
        size += sum(len(p) for p in pieces)

    for name, f in _ORDERED[msg.type_name]:
        value = getattr(msg, name)
        if value is None or (f.repeated and not value):
            continue
        if f.packed:
            body = b"".join(_scalar(f.kind, v) for v in value)
            emit(_key(f.number, LEN), _varint(len(body)), body)
            continue
        for v in (value if f.repeated else (value,)):
            if f.kind in SCHEMA:
                head = _key(f.number, LEN)
                out.append(head)
                at = len(out)
                out.append(b"")  # the length, once the message is written
                n = _chunks(v, out)
                out[at] = _varint(n)
                size += len(head) + len(out[at]) + n
            elif f.kind in ("string", "bytes"):
                data = v.encode() if isinstance(v, str) else bytes(v)
                emit(_key(f.number, LEN), _varint(len(data)), data)
            else:
                emit(_key(f.number, _SCALARS[f.kind]), _scalar(f.kind, v))
    return size


def serialize(msg: Message) -> bytes:
    """The wire bytes of ``msg``; ``ValueError`` past protobuf's 2 GiB
    limit, raised before any byte is joined."""
    out: List[bytes] = []
    size = _chunks(msg, out)
    if size > MAX_MESSAGE_BYTES:
        raise ValueError(f"{msg.type_name} would take {size} bytes, past protobuf's limit "
                         f"of 2 GiB - 1 ({MAX_MESSAGE_BYTES}) bytes for one message")
    return b"".join(out)


# ------------------------------------------------------------------ reading
def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _decode_scalar(kind: str, wire_type: int, raw) -> object:
    if kind in ("int64", "int32"):
        return _signed(raw)
    if kind == "float":
        return struct.unpack("<f", raw)[0]
    if kind == "double":
        return struct.unpack("<d", raw)[0]
    if kind == "string":
        return bytes(raw).decode()
    return bytes(raw)


def _unpack(kind: str, data: memoryview) -> list:
    """Elements of a packed repeated scalar field."""
    if kind == "float":
        return list(struct.unpack(f"<{len(data) // 4}f", data))
    if kind == "double":
        return list(struct.unpack(f"<{len(data) // 8}d", data))
    vals, pos = [], 0
    while pos < len(data):
        v, pos = _read_varint(data, pos)
        vals.append(_signed(v))
    return vals


def _parse(type_name: str, buf: memoryview) -> Message:
    msg = Message(type_name)
    fields = _BY_NUMBER[type_name]
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        number, wire_type = key >> 3, key & 7
        if wire_type == VARINT:
            raw, pos = _read_varint(buf, pos)
        elif wire_type == I64:
            raw, pos = buf[pos:pos + 8], pos + 8
        elif wire_type == I32:
            raw, pos = buf[pos:pos + 4], pos + 4
        elif wire_type == LEN:
            n, pos = _read_varint(buf, pos)
            raw, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"{type_name}: unsupported wire type {wire_type}")
        if pos > end:
            raise ValueError(f"{type_name}: truncated field {number}")
        entry = fields.get(number)
        if entry is None:
            continue
        name, f = entry
        if f.kind in SCHEMA:
            value = _parse(f.kind, raw)
        elif f.repeated and wire_type == LEN and _SCALARS[f.kind] != LEN:
            getattr(msg, name).extend(_unpack(f.kind, raw))
            continue
        else:
            value = _decode_scalar(f.kind, wire_type, raw)
        if f.repeated:
            getattr(msg, name).append(value)
        else:
            setattr(msg, name, value)
    return msg


def parse(type_name: str, data: bytes) -> Message:
    """The :class:`Message` of ``type_name`` that the wire bytes ``data``
    hold."""
    return _parse(type_name, memoryview(data))
