"""Protocol-buffer wire-format encoder/decoder (no protobuf runtime needed;
the port's own copy of `paddle_tpu/onnx/wire.py`, byte for byte the same
encoding).

The ONNX model format is an ordinary proto3 message; its wire encoding is
just tagged varints/length-delimited fields. This module implements exactly
that subset so `paddle_tpu_torch.onnx.export` writes real `.onnx` bytes
without the `onnx`/`protobuf` packages (reference `python/paddle/onnx/
export.py` delegates to the external paddle2onnx package instead).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

__all__ = ["varint", "tag", "field_varint", "field_bytes", "field_string",
           "field_message", "field_float", "decode"]


def varint(n: int) -> bytes:
    """Unsigned LEB128."""
    if n < 0:  # two's-complement 64-bit, as protobuf encodes negative ints
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(field_no: int, wire_type: int) -> bytes:
    return varint((field_no << 3) | wire_type)


def field_varint(field_no: int, value: int) -> bytes:
    return tag(field_no, 0) + varint(int(value))


def field_bytes(field_no: int, payload: bytes) -> bytes:
    return tag(field_no, 2) + varint(len(payload)) + payload


def field_string(field_no: int, s: str) -> bytes:
    return field_bytes(field_no, s.encode("utf-8"))


field_message = field_bytes


def field_float(field_no: int, value: float) -> bytes:
    return tag(field_no, 5) + struct.pack("<f", float(value))


# ---------------------------------------------------------------------------
# decoding (for tests / introspection of emitted models)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def decode(buf: bytes) -> Dict[int, List]:
    """Parse one message level into {field_no: [raw values]}.

    Varint fields decode to int; length-delimited fields stay `bytes`
    (call decode() again for nested messages); fixed32 floats decode to
    float. Repeated fields accumulate in list order.
    """
    out: Dict[int, List] = {}
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field_no, wire_type = key >> 3, key & 7
        if wire_type == 0:
            val, i = _read_varint(buf, i)
        elif wire_type == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wire_type == 5:
            val = struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        elif wire_type == 1:
            val = struct.unpack("<d", buf[i:i + 8])[0]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        out.setdefault(field_no, []).append(val)
    return out

