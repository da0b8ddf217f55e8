"""A small numpy evaluator of ONNX models, for the tests and the chip
check of `paddle_tpu_torch.onnx.export` (not a package feature).

It reads the `.onnx` bytes with the port's own wire decoder
(`paddle_tpu_torch.onnx.wire`) and runs the graph's nodes in order on
numpy arrays. It covers the ONNX-13 ops that both exporters emit (the
JAX package's jaxpr walker and the port's ATen walker): elementwise
arithmetic and comparisons, casts, shape ops, reductions, Einsum / MatMul
/ Gemm, Softmax, Conv, the poolings and BatchNormalization. An op it does
not know raises. Float32 stays float32 throughout (numpy's BLAS for the
products), so a float32 model evaluates in float32 as a runtime would.

    from torch_onnx_eval import run
    outs = run("model.onnx", {"x": array})   # list, in graph output order
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from paddle_tpu_torch.onnx import wire

__all__ = ["load", "run", "OnnxModel"]

_NP = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
       6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
       11: np.float64, 12: np.uint32, 13: np.uint64,
       16: np.float32}   # bfloat16 is evaluated as float32


def _str(b) -> str:
    return bytes(b).decode()


def _s64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _tensor(msg: bytes):
    d = wire.decode(msg)
    dims = [_s64(x) for x in d.get(1, [])]
    dt = d[2][0]
    name = _str(d[8][0]) if 8 in d else ""
    raw = d[9][0] if 9 in d else b""
    if dt == 16:
        bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(raw, np.dtype(_NP[dt]).newbyteorder("<"))
    return name, arr.astype(_NP[dt]).reshape(dims)


def _attr(msg: bytes):
    d = wire.decode(msg)
    name = _str(d[1][0])
    kind = d[20][0]
    if kind == 1:
        return name, float(d[2][0])
    if kind == 2:
        return name, _s64(d[3][0])
    if kind == 3:
        return name, _str(d[4][0])
    if kind == 4:
        return name, _tensor(d[5][0])[1]
    if kind == 6:
        return name, [float(x) for x in np.frombuffer(d[7][0], "<f4")] \
            if 7 in d else []
    if kind == 7:
        return name, [_s64(x) for x in d.get(8, [])]
    if kind == 8:
        return name, [_str(x) for x in d.get(9, [])]
    raise NotImplementedError(f"attribute kind {kind}")


class OnnxModel:
    def __init__(self, buf: bytes):
        model = wire.decode(buf)
        self.opset = wire.decode(model[8][0])[2][0]
        g = wire.decode(model[7][0])
        self.initializers = dict(_tensor(t) for t in g.get(5, []))
        self.inputs = [_str(wire.decode(v)[1][0]) for v in g.get(11, [])]
        self.outputs = [_str(wire.decode(v)[1][0]) for v in g.get(12, [])]
        self.nodes = []
        for n in g.get(1, []):
            d = wire.decode(n)
            self.nodes.append((
                _str(d[4][0]), [_str(i) for i in d.get(1, [])],
                [_str(o) for o in d.get(2, [])],
                dict(_attr(a) for a in d.get(5, []))))

    def op_types(self) -> List[str]:
        return [n[0] for n in self.nodes]

    def run(self, feeds: Dict[str, np.ndarray]) -> List[np.ndarray]:
        env = dict(self.initializers)
        for k in self.inputs:
            env[k] = np.asarray(feeds[k])
        for op, ins, outs, attrs in self.nodes:
            fn = _OPS.get(op)
            if fn is None:
                raise NotImplementedError(f"ONNX op {op}")
            vals = [env[i] if i else None for i in ins]
            res = fn(*vals, **attrs)
            if not isinstance(res, tuple):
                res = (res,)
            for o, r in zip(outs, res):
                env[o] = r
        return [env[o] for o in self.outputs]


def load(path_or_bytes) -> OnnxModel:
    """The model of a file or its bytes; the bytes are read through a
    memoryview, so a tensor's payload is not copied until it is used."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return OnnxModel(memoryview(path_or_bytes))
    with open(path_or_bytes, "rb") as f:
        return OnnxModel(memoryview(f.read()))


def run(path_or_bytes, feeds) -> List[np.ndarray]:
    return load(path_or_bytes).run(feeds)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def _like(x, v):
    return np.asarray(v).astype(np.asarray(x).dtype, copy=False)


def _erf(x):
    try:
        from scipy.special import erf
        return _like(x, erf(x))
    except ImportError:   # pragma: no cover — scipy is in both images
        return _like(x, np.vectorize(math.erf)(x))


def _binary(fn):
    def op(a, b, **_):
        return _like(a, fn(a, b)) if fn not in _BOOL_OUT else fn(a, b)
    return op


_BOOL_OUT = {np.equal, np.less, np.less_equal, np.greater,
             np.greater_equal, np.logical_and, np.logical_or,
             np.logical_xor}


def _div(a, b, **_):
    if np.issubdtype(np.asarray(a).dtype, np.integer):
        return _like(a, np.trunc(np.true_divide(a, b)))
    return _like(a, np.true_divide(a, b))


def _mod(a, b, fmod=0, **_):
    return _like(a, np.fmod(a, b) if fmod else np.mod(a, b))


def _unary(fn):
    def op(x, **_):
        return _like(x, fn(x))
    return op


def _cast(x, to, **_):
    return np.asarray(x).astype(_NP[to])


def _reshape(x, shape, allowzero=0, **_):
    shape = [int(s) for s in shape]
    if not allowzero:
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return np.reshape(x, shape)


def _transpose(x, perm=None, **_):
    return np.transpose(x, perm)


def _concat(*xs, axis, **_):
    return np.concatenate(xs, axis=axis)


def _expand(x, shape, **_):
    return np.broadcast_to(x, np.broadcast_shapes(x.shape, tuple(
        int(s) for s in shape)))


def _slice(x, starts, ends, axes=None, steps=None, **_):
    nd = x.ndim
    axes = range(len(starts)) if axes is None else axes
    steps = [1] * len(starts) if steps is None else steps
    sl = [slice(None)] * nd
    for s, e, a, st in zip(starts, ends, axes, steps):
        s, e, st = int(s), int(e), int(st)
        if st < 0 and e <= -(1 << 62):
            e = None
        elif e >= (1 << 62):
            e = None
        sl[int(a) % nd] = slice(s, e, st)
    return x[tuple(sl)]


def _split(x, split=None, axis=0, **_):
    if split is None:
        raise NotImplementedError("Split without sizes")
    idx = np.cumsum([int(s) for s in split])[:-1]
    return tuple(np.split(x, idx, axis=axis))


def _gather(x, idx, axis=0, **_):
    return np.take(x, np.asarray(idx).astype(np.int64), axis=axis)


def _gather_elements(x, idx, axis=0, **_):
    return np.take_along_axis(x, np.asarray(idx).astype(np.int64), axis)


def _pad(x, pads, value=None, mode="constant", **_):
    if mode != "constant":
        raise NotImplementedError(f"Pad mode {mode}")
    n = x.ndim
    pw = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    cv = 0 if value is None else np.asarray(value).item()
    return np.pad(x, pw, constant_values=cv)


def _tile(x, reps, **_):
    return np.tile(x, [int(r) for r in reps])


def _where(c, a, b, **_):
    return np.where(c, a, b)


def _reduce(fn):
    def op(x, axes_in=None, axes=None, keepdims=1, noop_with_empty_axes=0,
           **_):
        ax = axes if axes_in is None else [int(a) for a in axes_in]
        if ax is not None and len(ax) == 0:
            if noop_with_empty_axes:
                return x
            ax = None
        ax = None if ax is None else tuple(int(a) for a in ax)
        return _like(x, fn(x, axis=ax, keepdims=bool(keepdims)))
    return op


def _reduce_sum(x, axes=None, keepdims=1, noop_with_empty_axes=0, **_):
    return _reduce(np.sum)(x, axes_in=axes, keepdims=keepdims,
                           noop_with_empty_axes=noop_with_empty_axes)


def _logsumexp(x, axis=None, keepdims=False):
    m = np.max(x, axis=axis, keepdims=True)
    s = np.log(np.sum(np.exp(x - m), axis=axis, keepdims=True)) + m
    return s if keepdims else np.squeeze(s, axis=axis)


def _arg(fn):
    def op(x, axis=0, keepdims=1, select_last_index=0, **_):
        r = fn(x, axis=axis)
        if keepdims:
            r = np.expand_dims(r, axis)
        return r.astype(np.int64)
    return op


def _cumsum(x, axis, exclusive=0, reverse=0, **_):
    ax = int(np.asarray(axis))
    v = np.flip(x, ax) if reverse else x
    out = np.cumsum(v, axis=ax, dtype=x.dtype)
    if exclusive:
        out = out - v
    return np.flip(out, ax) if reverse else out


def _topk(x, k, axis=-1, largest=1, sorted=1, **_):
    k = int(np.asarray(k).reshape(-1)[0])
    order = np.argsort(-x if largest else x, axis=axis, kind="stable")
    idx = np.take(order, np.arange(k), axis=axis)
    return np.take_along_axis(x, idx, axis), idx.astype(np.int64)


def _softmax(x, axis=-1, **_):
    e = np.exp(x - np.max(x, axis=axis, keepdims=True))
    return _like(x, e / np.sum(e, axis=axis, keepdims=True))


def _log_softmax(x, axis=-1, **_):
    return _like(x, x - _logsumexp(x, axis=axis, keepdims=True))


def _einsum(*xs, equation, **_):
    return np.einsum(equation, *xs, optimize=True)


def _matmul(a, b, **_):
    return np.matmul(a, b)


def _gemm(a, b, c=None, alpha=1.0, beta=1.0, transA=0, transB=0, **_):
    a = a.T if transA else a
    b = b.T if transB else b
    out = np.matmul(a, b)
    if alpha != 1.0:
        out = out * _like(out, alpha)
    if c is not None:
        out = out + (c * _like(out, beta) if beta != 1.0 else c)
    return out


def _clip(x, lo=None, hi=None, **_):
    if lo is not None:
        x = np.maximum(x, lo)
    if hi is not None:
        x = np.minimum(x, hi)
    return x


def _variadic(fn):
    def op(*xs, **_):
        out = xs[0]
        for x in xs[1:]:
            out = fn(out, x)
        return _like(xs[0], out)
    return op


def _windows(x, kernel, strides, dilations, pads, fill):
    """[N, C, *out, *kernel] windows of x after padding."""
    n = len(kernel)
    pw = [(0, 0), (0, 0)] + [(int(pads[i]), int(pads[i + n]))
                             for i in range(n)]
    xp = np.pad(x, pw, constant_values=fill)
    span = [(k - 1) * d + 1 for k, d in zip(kernel, dilations)]
    win = np.lib.stride_tricks.sliding_window_view(
        xp, span, axis=tuple(range(2, 2 + n)))
    sl = [slice(None), slice(None)]
    sl += [slice(None, None, s) for s in strides]
    sl += [slice(None, None, d) for d in dilations]
    return win[tuple(sl)]


def _pool_args(x, kernel_shape, strides=None, pads=None, dilations=None,
               ceil_mode=0):
    n = len(kernel_shape)
    strides = strides or [1] * n
    dilations = dilations or [1] * n
    pads = list(pads or [0] * (2 * n))
    if ceil_mode:
        for i in range(n):
            size = x.shape[2 + i] + pads[i] + pads[i + n]
            span = (kernel_shape[i] - 1) * dilations[i] + 1
            out = -(-(size - span) // strides[i]) + 1
            if (out - 1) * strides[i] >= x.shape[2 + i] + pads[i]:
                out -= 1
            pads[i + n] += max(0, (out - 1) * strides[i] + span - size)
    return kernel_shape, strides, dilations, pads


def _conv(x, w, b=None, kernel_shape=None, strides=None, pads=None,
          dilations=None, group=1, auto_pad="NOTSET", **_):
    n = w.ndim - 2
    kernel = list(w.shape[2:])
    strides = strides or [1] * n
    dilations = dilations or [1] * n
    pads = pads or [0] * (2 * n)
    N, C = x.shape[:2]
    O = w.shape[0]
    G = int(group)
    if all(k == 1 for k in kernel) and not any(pads):
        # a 1x1 convolution reads no window
        win = x[(slice(None), slice(None))
                + tuple(slice(None, None, s) for s in strides)]
        win = win.reshape(win.shape + (1,) * n)
    else:
        win = _windows(x, kernel, strides, dilations, pads, 0)
    out_sp = win.shape[2:2 + n]
    P, K = int(np.prod(out_sp)), C // G * int(np.prod(kernel))
    # im2col: [N, G, positions, C/G x kernel] against [G, C/G x kernel, O/G]
    cols = win.reshape((N, G, C // G) + tuple(out_sp) + tuple(kernel))
    cols = np.moveaxis(cols, 2, 2 + n).reshape(N, G, P, K)
    wk = w.reshape(G, O // G, K).transpose(0, 2, 1)
    out = np.matmul(cols, wk)                      # [N, G, P, O/G]
    out = out.transpose(0, 1, 3, 2).reshape((N, O) + tuple(out_sp))
    if b is not None:
        out = out + b.reshape((1, O) + (1,) * n)
    return out.astype(x.dtype, copy=False)


def _max_pool(x, kernel_shape, strides=None, pads=None, dilations=None,
              ceil_mode=0, storage_order=0, **_):
    k, s, d, p = _pool_args(x, kernel_shape, strides, pads, dilations,
                            ceil_mode)
    win = _windows(x, k, s, d, p, -np.inf)
    n = len(k)
    return win.max(axis=tuple(range(-n, 0)))


def _avg_pool(x, kernel_shape, strides=None, pads=None, ceil_mode=0,
              count_include_pad=0, **_):
    n = len(kernel_shape)
    k, s, d, p = _pool_args(x, kernel_shape, strides, pads, None, ceil_mode)
    axes = tuple(range(-n, 0))
    total = _windows(x, k, s, d, p, 0).sum(axis=axes)
    if count_include_pad:
        base = list(pads or [0] * (2 * n))
        ones = np.pad(np.ones((1, 1) + x.shape[2:], x.dtype),
                      [(0, 0), (0, 0)] + [(base[i], base[i + n])
                                          for i in range(n)],
                      constant_values=1)
        extra = [0] * n + [p[i + n] - base[i + n] for i in range(n)]
        cnt = _windows(ones, k, s, d, extra, 0).sum(axis=axes)
    else:
        ones = np.ones((1, 1) + x.shape[2:], x.dtype)
        cnt = _windows(ones, k, s, d, p, 0).sum(axis=axes)
    return (total / cnt).astype(x.dtype, copy=False)


def _global_avg(x, **_):
    return x.mean(axis=tuple(range(2, x.ndim)), keepdims=True)


def _batch_norm(x, scale, b, mean, var, epsilon=1e-5, **_):
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = (1.0 / np.sqrt(var + _like(var, epsilon))).reshape(shape)
    return ((x - mean.reshape(shape)) * inv * scale.reshape(shape)
            + b.reshape(shape)).astype(x.dtype, copy=False)


_OPS = {
    "Identity": lambda x, **_: x,
    "Add": _binary(np.add), "Sub": _binary(np.subtract),
    "Mul": _binary(np.multiply), "Div": _div, "Pow": _binary(np.power),
    "Max": _variadic(np.maximum), "Min": _variadic(np.minimum),
    "Mod": _mod,
    "Equal": _binary(np.equal), "Less": _binary(np.less),
    "LessOrEqual": _binary(np.less_equal), "Greater": _binary(np.greater),
    "GreaterOrEqual": _binary(np.greater_equal),
    "And": _binary(np.logical_and), "Or": _binary(np.logical_or),
    "Xor": _binary(np.logical_xor), "Not": lambda x, **_: np.logical_not(x),
    "Neg": _unary(np.negative), "Exp": _unary(np.exp), "Log": _unary(np.log),
    "Tanh": _unary(np.tanh), "Sqrt": _unary(np.sqrt),
    "Sigmoid": _unary(lambda x: 1.0 / (1.0 + np.exp(-x))),
    "Reciprocal": _unary(lambda x: 1.0 / x), "Abs": _unary(np.abs),
    "Sign": _unary(np.sign), "Floor": _unary(np.floor),
    "Ceil": _unary(np.ceil), "Round": _unary(np.round), "Erf": _erf,
    "Sin": _unary(np.sin), "Cos": _unary(np.cos), "Tan": _unary(np.tan),
    "Asin": _unary(np.arcsin), "Acos": _unary(np.arccos),
    "Atan": _unary(np.arctan), "Sinh": _unary(np.sinh),
    "Cosh": _unary(np.cosh), "Relu": _unary(lambda x: np.maximum(x, 0)),
    "LeakyRelu": lambda x, alpha=0.01, **_: _like(
        x, np.where(x >= 0, x, alpha * x)),
    "Elu": lambda x, alpha=1.0, **_: _like(
        x, np.where(x > 0, x, alpha * (np.exp(x) - 1))),
    "IsNaN": lambda x, **_: np.isnan(x), "IsInf": lambda x, **_: np.isinf(x),
    "Clip": _clip, "Where": _where, "Cast": _cast,
    "Reshape": _reshape, "Transpose": _transpose, "Concat": _concat,
    "Expand": _expand, "Slice": _slice, "Split": _split, "Gather": _gather,
    "GatherElements": _gather_elements, "Pad": _pad, "Tile": _tile,
    "ReduceSum": _reduce_sum, "ReduceMean": _reduce(np.mean),
    "ReduceMax": _reduce(np.max), "ReduceMin": _reduce(np.min),
    "ReduceProd": _reduce(np.prod), "ReduceLogSumExp": _reduce(_logsumexp),
    "ArgMax": _arg(np.argmax), "ArgMin": _arg(np.argmin),
    "CumSum": _cumsum, "TopK": _topk,
    "Softmax": _softmax, "LogSoftmax": _log_softmax,
    "Einsum": _einsum, "MatMul": _matmul, "Gemm": _gemm,
    "Conv": _conv, "MaxPool": _max_pool, "AveragePool": _avg_pool,
    "GlobalAveragePool": _global_avg, "BatchNormalization": _batch_norm,
}
