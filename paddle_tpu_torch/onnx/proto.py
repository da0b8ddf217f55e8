"""ONNX message encoders over the raw wire encoder (the port's own copy of
`paddle_tpu/onnx/proto.py`; the producer names this package).

Field numbers follow the public onnx.proto3 schema (onnx/onnx.proto):
ModelProto{ir_version=1, producer_name=2, producer_version=3, domain=4,
model_version=5, doc_string=6, graph=7, opset_import=8},
GraphProto{node=1, name=2, initializer=5, doc_string=10, input=11,
output=12, value_info=13},
NodeProto{input=1, output=2, name=3, op_type=4, attribute=5, doc_string=6,
domain=7},
AttributeProto{name=1, f=2, i=3, s=4, t=5, g=6, floats=7, ints=8,
strings=9, type=20},
TensorProto{dims=1, data_type=2, name=8, raw_data=9},
ValueInfoProto{name=1, type=2}, TypeProto{tensor_type=1},
TypeProto.Tensor{elem_type=1, shape=2}, TensorShapeProto{dim=1},
Dimension{dim_value=1, dim_param=2},
OperatorSetIdProto{domain=1, version=2}.
"""
from __future__ import annotations

import numpy as np

from . import wire

__all__ = ["DTYPE_MAP", "np_dtype_to_onnx", "tensor_proto", "attr",
           "node_proto", "value_info", "graph_parts", "graph_proto",
           "model_parts", "model_proto"]

# onnx TensorProto.DataType
DTYPE_MAP = {
    "float32": 1, "uint8": 2, "int8": 3, "uint16": 4, "int16": 5,
    "int32": 6, "int64": 7, "bool": 9, "float16": 10, "float64": 11,
    "uint32": 12, "uint64": 13, "bfloat16": 16,
}

ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8


def np_dtype_to_onnx(dt) -> int:
    name = np.dtype(dt).name if np.dtype(dt).name in DTYPE_MAP else str(dt)
    if name not in DTYPE_MAP:
        raise ValueError(f"no ONNX dtype for {dt}")
    return DTYPE_MAP[name]


def tensor_proto(name: str, array) -> bytes:
    """TensorProto with raw_data (little-endian)."""
    arr = np.asarray(array)
    if arr.dtype.name == "bfloat16" or str(arr.dtype) == "bfloat16":
        onnx_dt = 16
        raw = arr.view(np.uint16)
        raw = np.ascontiguousarray(raw, dtype="<u2").tobytes()
    else:
        onnx_dt = np_dtype_to_onnx(arr.dtype)
        raw = np.ascontiguousarray(
            arr.astype(arr.dtype.newbyteorder("<"))).tobytes()
    msg = b"".join(wire.field_varint(1, d) for d in arr.shape)
    msg += wire.field_varint(2, onnx_dt)
    msg += wire.field_string(8, name)
    msg += wire.field_bytes(9, raw)
    return msg


def attr(name: str, value) -> bytes:
    """AttributeProto from a python value (type inferred)."""
    msg = wire.field_string(1, name)
    if isinstance(value, bool):
        msg += wire.field_varint(3, int(value))
        msg += wire.field_varint(20, ATTR_INT)
    elif isinstance(value, int):
        msg += wire.field_varint(3, value)
        msg += wire.field_varint(20, ATTR_INT)
    elif isinstance(value, float):
        msg += wire.field_float(2, value)
        msg += wire.field_varint(20, ATTR_FLOAT)
    elif isinstance(value, str):
        msg += wire.field_bytes(4, value.encode())
        msg += wire.field_varint(20, ATTR_STRING)
    elif isinstance(value, bytes):
        msg += wire.field_bytes(4, value)
        msg += wire.field_varint(20, ATTR_STRING)
    elif isinstance(value, np.ndarray):
        msg += wire.field_message(5, tensor_proto(name, value))
        msg += wire.field_varint(20, ATTR_TENSOR)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            for v in value:
                msg += wire.field_varint(8, int(v))
            msg += wire.field_varint(20, ATTR_INTS)
        elif all(isinstance(v, (float, np.floating)) for v in value):
            import struct
            payload = b"".join(struct.pack("<f", float(v)) for v in value)
            msg += wire.field_bytes(7, payload)
            msg += wire.field_varint(20, ATTR_FLOATS)
        else:
            for v in value:
                msg += wire.field_bytes(9, str(v).encode())
            msg += wire.field_varint(20, ATTR_STRINGS)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return msg


def node_proto(op_type: str, inputs, outputs, name: str = "",
               attrs: dict | None = None) -> bytes:
    msg = b"".join(wire.field_string(1, i) for i in inputs)
    msg += b"".join(wire.field_string(2, o) for o in outputs)
    if name:
        msg += wire.field_string(3, name)
    msg += wire.field_string(4, op_type)
    for k, v in (attrs or {}).items():
        msg += wire.field_message(5, attr(k, v))
    return msg


def value_info(name: str, shape, np_dtype) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += wire.field_message(1, wire.field_string(2, d))
        else:
            dims += wire.field_message(1, wire.field_varint(1, int(d)))
    shape_msg = dims
    tensor_type = wire.field_varint(1, np_dtype_to_onnx(np_dtype))
    tensor_type += wire.field_message(2, shape_msg)
    type_msg = wire.field_message(1, tensor_type)
    return wire.field_string(1, name) + wire.field_message(2, type_msg)


def graph_parts(nodes, name, initializers, inputs, outputs) -> list:
    """The GraphProto's bytes as a list of chunks (joined: `graph_proto`),
    so that a large model is written without one copy of it in memory."""
    return ([wire.field_message(1, n) for n in nodes]
            + [wire.field_string(2, name)]
            + [wire.field_message(5, t) for t in initializers]
            + [wire.field_message(11, i) for i in inputs]
            + [wire.field_message(12, o) for o in outputs])


def graph_proto(nodes, name, initializers, inputs, outputs) -> bytes:
    return b"".join(graph_parts(nodes, name, initializers, inputs, outputs))


def model_parts(graph_chunks, opset_version: int = 13,
                producer: str = "paddle_tpu_torch") -> list:
    """The ModelProto's bytes as chunks around the graph's chunks (joined:
    `model_proto`, the JAX package's bytes)."""
    opset = wire.field_string(1, "") + wire.field_varint(2, opset_version)
    size = sum(len(c) for c in graph_chunks)
    return ([wire.field_varint(1, 7),                 # ir_version 7
             wire.field_string(2, producer),
             wire.field_string(3, "1.0"),
             wire.tag(7, 2) + wire.varint(size)]
            + list(graph_chunks)
            + [wire.field_message(8, opset)])


def model_proto(graph: bytes, opset_version: int = 13,
                producer: str = "paddle_tpu_torch") -> bytes:
    return b"".join(model_parts([graph], opset_version, producer))
