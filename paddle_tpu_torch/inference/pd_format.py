"""Reference .pdmodel / .pdiparams wire-format reader (port of
`paddle_tpu.inference.pd_format`, which is pure Python and numpy; this
is its copy).

Schema facts (field numbers, enum values, stream framing) come from:
  - `paddle/fluid/framework/framework.proto:43-207` (ProgramDesc ⊃
    BlockDesc ⊃ OpDesc/VarDesc, AttrType, VarType.Type)
  - `paddle/fluid/framework/lod_tensor.cc:244` SerializeToStream
    (u32 version, u64 lod_level, per-level u64 size + data)
  - `paddle/fluid/framework/tensor_util.cc` TensorToStream
    (u32 version, i32 TensorDesc size, TensorDesc proto, raw data)
  - `paddle/fluid/operators/save_combine_op.h:34` (tensors concatenated
    in input-name order)

The decoder is a generic protobuf-2 wire parser (varint / 64-bit /
length-delimited / 32-bit), schema-driven — no generated code, no .proto
file and no protobuf package at run time.
"""
from __future__ import annotations

import io
import struct
from typing import Any, Dict, List, Tuple

import numpy as np

__all__ = ["parse_program_desc", "read_combined_params",
           "read_lod_tensor_stream"]


# ---------------------------------------------------------------------------
# generic proto2 wire decoding
# ---------------------------------------------------------------------------

def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip(buf, pos, wire):
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def _decode(buf: memoryview, schema: Dict[int, tuple]) -> Dict[str, Any]:
    """schema: field_no → (name, kind[, sub_schema]); kind ∈ varint,
    float, double, string, bytes, message, and repeated_* variants.
    Repeated scalar fields accept both packed and unpacked encodings."""
    out: Dict[str, Any] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        spec = schema.get(field)
        if spec is None:
            pos = _skip(buf, pos, wire)
            continue
        name, kind = spec[0], spec[1]
        repeated = kind.startswith("repeated_")
        base = kind[len("repeated_"):] if repeated else kind

        def put(v):
            if repeated:
                out.setdefault(name, []).append(v)
            else:
                out[name] = v

        if base == "varint":
            if wire == 2:             # packed repeated varints
                n, pos = _read_varint(buf, pos)
                end = pos + n
                while pos < end:
                    v, pos = _read_varint(buf, pos)
                    put(v)
            else:
                v, pos = _read_varint(buf, pos)
                put(v)
        elif base == "float":
            if wire == 2:
                n, pos = _read_varint(buf, pos)
                for i in range(n // 4):
                    put(struct.unpack_from("<f", buf, pos + 4 * i)[0])
                pos += n
            else:
                put(struct.unpack_from("<f", buf, pos)[0])
                pos += 4
        elif base == "double":
            if wire == 2:
                n, pos = _read_varint(buf, pos)
                for i in range(n // 8):
                    put(struct.unpack_from("<d", buf, pos + 8 * i)[0])
                pos += n
            else:
                put(struct.unpack_from("<d", buf, pos)[0])
                pos += 8
        elif base in ("string", "bytes", "message"):
            n, pos = _read_varint(buf, pos)
            chunk = buf[pos:pos + n]
            pos += n
            if base == "string":
                put(bytes(chunk).decode("utf-8"))
            elif base == "bytes":
                put(bytes(chunk))
            else:
                put(_decode(chunk, spec[2]))
        else:
            raise ValueError(f"unknown kind {kind}")
    return out


# framework.proto schemas (field numbers cited in the module docstring)
_TENSOR_DESC = {1: ("data_type", "varint"),
                2: ("dims", "repeated_varint")}
_LOD_TENSOR_DESC = {1: ("tensor", "message", _TENSOR_DESC),
                    2: ("lod_level", "varint")}
_VAR_TYPE = {1: ("type", "varint"),
             2: ("selected_rows", "message", _TENSOR_DESC),
             3: ("lod_tensor", "message", _LOD_TENSOR_DESC)}
_VAR_DESC = {1: ("name", "string"),
             2: ("type", "message", _VAR_TYPE),
             3: ("persistable", "varint")}
_OP_VAR = {1: ("parameter", "string"),
           2: ("arguments", "repeated_string")}
_OP_ATTR = {1: ("name", "string"), 2: ("type", "varint"),
            3: ("i", "varint"), 4: ("f", "float"), 5: ("s", "string"),
            6: ("ints", "repeated_varint"),
            7: ("floats", "repeated_float"),
            8: ("strings", "repeated_string"),
            10: ("b", "varint"), 11: ("bools", "repeated_varint"),
            12: ("block_idx", "varint"), 13: ("l", "varint"),
            15: ("longs", "repeated_varint"),
            16: ("float64s", "repeated_double")}
_OP_DESC = {1: ("inputs", "repeated_message", _OP_VAR),
            2: ("outputs", "repeated_message", _OP_VAR),
            3: ("type", "string"),
            4: ("attrs", "repeated_message", _OP_ATTR)}
_BLOCK_DESC = {1: ("idx", "varint"), 2: ("parent_idx", "varint"),
               3: ("vars", "repeated_message", _VAR_DESC),
               4: ("ops", "repeated_message", _OP_DESC)}
_PROGRAM_DESC = {1: ("blocks", "repeated_message", _BLOCK_DESC),
                 4: ("version", "message", {1: ("version", "varint")})}

# AttrType enum (framework.proto:25)
ATTR_KINDS = {0: "i", 1: "f", 2: "s", 3: "ints", 4: "floats",
              5: "strings", 6: "b", 7: "bools", 8: "block_idx", 9: "l",
              10: "blocks_idx", 11: "longs", 12: "float64s"}

# VarType.Type data types (framework.proto:106)
DTYPES = {0: np.bool_, 1: np.int16, 2: np.int32, 3: np.int64,
          4: np.float16, 5: np.float32, 6: np.float64,
          20: np.uint8, 21: np.int8}


def _signed(v: int) -> int:
    """proto int32/int64 varints are two's-complement."""
    return v - (1 << 64) if v >= (1 << 63) else v


def parse_program_desc(data: bytes) -> Dict[str, Any]:
    """ProgramDesc bytes → {"blocks": [{"vars": {...}, "ops": [...]}]}."""
    raw = _decode(memoryview(data), _PROGRAM_DESC)
    blocks = []
    for b in raw.get("blocks", []):
        vars_by_name = {}
        for v in b.get("vars", []):
            vt = v.get("type", {})
            lod = vt.get("lod_tensor", {})
            td = lod.get("tensor", {})
            vars_by_name[v["name"]] = {
                "persistable": bool(v.get("persistable", 0)),
                "type": vt.get("type"),
                "dtype": DTYPES.get(td.get("data_type", 5), np.float32),
                "shape": [_signed(d) for d in td.get("dims", [])],
            }
        ops = []
        for o in b.get("ops", []):
            attrs = {}
            for a in o.get("attrs", []):
                kind = ATTR_KINDS.get(a.get("type"))
                if kind is None:
                    continue
                val = a.get(kind)
                if kind in ("i", "l"):
                    val = _signed(val) if val is not None else 0
                elif kind in ("ints", "longs"):
                    val = [_signed(x) for x in (val or [])]
                elif kind == "b":
                    val = bool(val)
                elif kind == "bools":
                    val = [bool(x) for x in (val or [])]
                elif kind in ("floats", "strings", "float64s"):
                    val = val or []
                attrs[a["name"]] = val
            ops.append({
                "type": o["type"],
                "inputs": {i["parameter"]: i.get("arguments", [])
                           for i in o.get("inputs", [])},
                "outputs": {i["parameter"]: i.get("arguments", [])
                            for i in o.get("outputs", [])},
                "attrs": attrs,
            })
        blocks.append({"idx": b.get("idx", 0), "vars": vars_by_name,
                       "ops": ops})
    return {"blocks": blocks}


# ---------------------------------------------------------------------------
# LoDTensor / save_combine streams
# ---------------------------------------------------------------------------

def read_lod_tensor_stream(f) -> np.ndarray:
    """One LoDTensor record (lod_tensor.cc:244 + tensor_util.cc
    TensorToStream)."""
    _version = struct.unpack("<I", f.read(4))[0]
    lod_level = struct.unpack("<Q", f.read(8))[0]
    for _ in range(lod_level):
        n = struct.unpack("<Q", f.read(8))[0]
        f.read(n)
    _tversion = struct.unpack("<I", f.read(4))[0]
    desc_size = struct.unpack("<i", f.read(4))[0]
    desc = _decode(memoryview(f.read(desc_size)), _TENSOR_DESC)
    dtype = DTYPES.get(desc.get("data_type", 5), np.float32)
    dims = [_signed(d) for d in desc.get("dims", [])]
    count = int(np.prod(dims)) if dims else 1
    data = f.read(count * np.dtype(dtype).itemsize)
    return np.frombuffer(data, dtype=dtype).reshape(dims).copy()


def read_combined_params(data: bytes, names: List[str]) -> Dict[str, np.ndarray]:
    """save_combine payload: LoDTensor streams back to back, in `names`
    order (save_combine_op.h:34)."""
    f = io.BytesIO(data)
    out = {}
    for n in names:
        out[n] = read_lod_tensor_stream(f)
    if f.read(1):
        raise ValueError("trailing bytes after the last combined param — "
                         "name list does not match the file")
    return out
