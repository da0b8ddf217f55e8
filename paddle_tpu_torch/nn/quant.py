"""Weight-only quantization primitives (port of `paddle_tpu.nn.quant`;
reference direction `paddle.nn.quant.weight_quantize` /
`weight_only_linear`).

Serving is bound by device-memory capacity and bandwidth, not by integer
math: weights store as int8 (4x smaller than float32) or packed int4 (8x,
two nibbles a byte) with per-output-channel float32 scales, stay integer
on the device, and dequantize at the point of use, inside the matmul's
expression. Symmetric abs-max, as in the JAX package:

    scale[o] = max(|W[o, :]|) / qmax        (qmax: 127 int8, 7 int4)
    q        = clip(round(W / scale), -qmax, qmax)
    W'       = q * scale

Layout: the JAX package stores Linear weights `[in, out]`, the port
PyTorch's `[out, in]`; every function here takes and returns the port's
`[out, in]` layout (`q` of a JAX weight is the transpose of the port's).
int4 packs two nibbles a byte along the OUTPUT axis, as in the JAX
package: output channels 2j (low nibble) and 2j + 1 (high nibble) share
byte j, so a packed int4 weight is `[ceil(out / 2), in]` here and the
transpose of the JAX package's `[in, ceil(out / 2)]`; an odd channel
count pads one zero channel that unpacking slices back off. Nibbles are
sign-extended on unpack with int8 arithmetic shifts.

The divisions are tensor-by-tensor (`torch.full_like` divisors), which
round exactly as the JAX package's numpy divisions; a division by a
Python scalar may run as a multiplication by its reciprocal.
"""
from __future__ import annotations

import torch

from .. import amp
from ..framework.static_hook import named_op

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "quant_bits", "pack_int4", "unpack_int4"]

_ALGOS = {"weight_only_int8": 8, "weight_only_int4": 4}


def quant_bits(algo: str) -> int:
    if algo not in _ALGOS:
        raise ValueError(f"unknown weight-quant algo {algo!r}; expected "
                         f"one of {sorted(_ALGOS)}")
    return _ALGOS[algo]


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (int8 storage, range [-7, 7]) two a byte along the
    first (output) axis: row 2j -> low nibble, row 2j + 1 -> high nibble.
    An odd row count gets one zero pad row. int8 [out, in] ->
    int8 [ceil(out / 2), in]."""
    q = torch.as_tensor(q).to(torch.int8)
    if q.shape[0] % 2:
        q = torch.cat([q, q.new_zeros((1,) + tuple(q.shape[1:]))])
    lo = q[0::2].to(torch.uint8) & 0x0F
    hi = q[1::2].to(torch.uint8) & 0x0F
    return ((hi << 4) | lo).view(torch.int8).contiguous()


def unpack_int4(packed: torch.Tensor, out_features: int) -> torch.Tensor:
    """Sign-extend packed nibbles back to int8 values in [-8, 7] and drop
    the odd-count pad row: int8 [ceil(out / 2), in] -> int8 [out, in]."""
    p = torch.as_tensor(packed).to(torch.int8)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(p, 4), 4)
    hi = torch.bitwise_right_shift(p, 4)
    q = torch.stack([lo, hi], dim=1).reshape((-1,) + tuple(p.shape[1:]))
    return q[:int(out_features)]


def weight_quantize(w, algo: str = "weight_only_int8"):
    """Symmetric abs-max per-output-channel weight quantization.

    w: float [out_features, in_features] (PyTorch's Linear layout).
    Returns (q, scale) on w's device: int8 `q` [out, in] for int8 or
    packed [ceil(out / 2), in] for int4; `scale` float32 [out]."""
    bits = quant_bits(algo)
    w = torch.as_tensor(w).detach().to(torch.float32)
    if w.dim() != 2:
        raise ValueError(f"weight_quantize expects a 2-D [out, in] weight, "
                         f"got shape {tuple(w.shape)}")
    qmax = float(2 ** (bits - 1) - 1)
    amax = torch.clamp(w.abs().amax(dim=1), min=1e-8)
    scale = amax / torch.full_like(amax, qmax)
    q = torch.clamp(torch.round(w / scale[:, None].expand_as(w)), -qmax,
                    qmax).to(torch.int8)
    if bits == 4:
        q = pack_int4(q)
    return q, scale


def weight_dequantize(q, scale, algo: str = "weight_only_int8",
                      out_dtype=torch.float32):
    """Inverse of weight_quantize: the float [out, in] weight
    `q * scale`, computed in `out_dtype` (the JAX package's
    `q.astype(dtype) * scale.astype(dtype)`)."""
    bits = quant_bits(algo)
    q = torch.as_tensor(q)
    scale = torch.as_tensor(scale)
    if bits == 4:
        q = unpack_int4(q, scale.shape[-1])
    return q.to(out_dtype) * scale.to(out_dtype)[:, None]


@named_op
def weight_only_linear(x, weight, weight_scale, bias=None,
                       weight_dtype: str = "int8"):
    """y = x @ dequant(weight)^T (+ bias): the weight stays integer on
    the device and is dequantized into a temporary in x's type for this
    product only (no float copy outlives the call). AMP's white op
    "weight_only_linear": under AMP the float32 arguments (x, the scale,
    the bias) are cast to the autocast type, as the JAX package's
    `apply_op` casts them. A plain torch product, as the JAX package's is
    a plain jnp product (the matmul, then the bias add)."""
    algo = {"int8": "weight_only_int8",
            "int4": "weight_only_int4"}.get(weight_dtype)
    if algo is None:
        raise ValueError(f"weight_dtype must be 'int8' or 'int4', got "
                         f"{weight_dtype!r}")
    args = (x, weight, weight_scale) + ((bias,) if bias is not None else ())
    x, weight, weight_scale, *b = amp.cast_args("weight_only_linear", *args)
    w = weight_dequantize(weight, weight_scale, algo, out_dtype=x.dtype)
    out = torch.matmul(x, w.t())
    if b:
        out = out + b[0]
    return out
