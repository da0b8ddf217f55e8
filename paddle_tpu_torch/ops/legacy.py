"""Legacy (fluid-era) op aliases, tensor arrays, LoD sequence ops and
their static-mode pieces (port of `paddle_tpu/ops/legacy.py`; reference
`python/paddle/fluid/layers/{tensor,nn,control_flow}.py`,
`python/paddle/fluid/lod_tensor.py`, `operators/sequence_ops/*`,
`operators/print_op.cc`, `operators/pyramid_hash_op.cc`).

Plain PyTorch over the port's op families, on the input's device (a
number or array goes to the default device); no TPU kernel lies here.

- `elementwise_*` keep fluid's mid-rank broadcast (`axis`) and `act`
  (add, sub, mul and div are `ops.math`'s); `reduce_*` are the modern
  reductions under fluid's argument names.
- LoD is an explicit offsets list beside a dense tensor: `LoDTensor` is a
  `torch.Tensor` subclass carrying `_lod` whose torch calls give plain
  tensors; the `sequence_*` ops run on the host (numpy) over it and put
  their results on the input's device, as the JAX package runs them
  eagerly over its own.
- Static mode (`enable_static`): `create_parameter` inside a Program is a
  Program parameter (`static.program.make_parameter`) that
  `Executor.run` trains; in dygraph it is a `torch.nn.Parameter`
  (XavierNormal, or Constant 0 when `is_bias`). `create_global_var` is a
  full tensor with `persistable` set. `Print` is one recorded op: silent
  and uncounted while the Program is built, it prints at run time (each
  `Executor.run` replays it) up to `first_n` times, `summarize < 0`
  printing every value. The JAX package prints only a traced line there
  (its runtime has no host callbacks); the port's Program replays
  eagerly, so the values print.
- `search_pyramid_hash` (alias `pyramid_hash`) hashes n-grams with its own
  copy of `_xxh32` (the public XXH32), so the two packages hash alike.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import static_hook
from ..framework.dtype import (get_default_dtype,  # noqa: F401
                               set_default_dtype, to_torch_dtype)
from ..framework.place import resolve_device
from ..framework.selected_rows import SelectedRows
from . import creation, manipulation, reduction
from ._util import ints, tensor
from .extra_ops import (affine_channel, affine_grid, batch_fc,  # noqa: F401
                        bilateral_slice, bpr_loss, center_loss, conv_shift,
                        correlation, cross_entropy2, cvm, data_norm,
                        deformable_conv, filter_by_instag, fsp, gather_tree,
                        hinge_loss, im2sequence, l1_norm, linear_chain_crf,
                        nce, pad_constant_like, partial_concat, partial_sum,
                        prroi_pool, psroi_pool, rank_attention, rank_loss,
                        row_conv, sample_logits, shuffle_batch,
                        space_to_depth, squared_l2_norm, temporal_shift,
                        tree_conv, var_conv_2d)
from .math import (_fluid_act, _fluid_axis, elementwise_add,  # noqa: F401
                   elementwise_div, elementwise_mul, elementwise_sub)

__all__ = [
    "add_n", "broadcast_shape", "crop_tensor", "fill_constant",
    "elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_floordiv", "elementwise_mod", "elementwise_pow",
    "elementwise_max", "elementwise_min",
    "reduce_sum", "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
    "reduce_all", "reduce_any", "has_inf", "has_nan", "rank", "shape",
    "reverse", "scatter_nd", "get_tensor_from_selected_rows",
    "merge_selected_rows", "create_array", "array_write", "array_read",
    "array_length", "tensor_array_to_tensor", "LoDTensor", "LoDTensorArray",
    "set_printoptions", "get_default_dtype", "set_default_dtype",
    "create_parameter", "create_global_var", "lod_reset",
    "sequence_pad", "sequence_unpad", "sequence_pool", "sequence_softmax",
    "sequence_reverse", "sequence_concat", "sequence_expand",
    "sequence_reshape", "sequence_slice", "sequence_scatter", "Print",
    "search_pyramid_hash", "pyramid_hash",
    # the fluid-era ops of extra_ops, re-exported as the reference does
    "affine_channel", "row_conv", "conv_shift", "cvm", "data_norm",
    "space_to_depth", "pad_constant_like", "partial_concat", "partial_sum",
    "l1_norm", "squared_l2_norm", "rank_loss", "bpr_loss", "center_loss",
    "hinge_loss", "im2sequence", "linear_chain_crf", "shuffle_batch",
    "gather_tree", "affine_grid", "temporal_shift", "fsp",
    "cross_entropy2", "psroi_pool", "prroi_pool", "correlation", "nce",
    "deformable_conv", "batch_fc", "sample_logits", "filter_by_instag",
    "var_conv_2d", "tree_conv", "bilateral_slice", "rank_attention",
]


def _t(x, like=None):
    """`x` as a tensor: a tensor as it is; a number or array in the JAX
    package's types (int64 -> int32, float64 -> float32) on `like`'s
    device, the default device without one."""
    if torch.is_tensor(x):
        return x
    a = np.asarray(x)
    # reshaped: `tensor` makes a 0-d array 1-d
    return tensor(a, like.device if torch.is_tensor(like) else None
                  ).reshape(a.shape)


def _host(x) -> np.ndarray:
    """A tensor's values as numpy (bfloat16 as float32)."""
    x = _t(x).detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Reference: `python/paddle/tensor/to_string.py`. The port's tensors
    print through torch: its printoptions."""
    kw = {k: v for k, v in (("precision", precision),
                            ("threshold", threshold),
                            ("edgeitems", edgeitems),
                            ("linewidth", linewidth),
                            ("sci_mode", sci_mode)) if v is not None}
    torch.set_printoptions(**kw)


# --------------------------------------------------------------------------
# elementwise_* / reduce_* legacy names

def _elementwise(name, fn):
    def op(x, y, axis=-1, act=None, name=None):
        x, y = _fluid_axis(_t(x, y), _t(y, x), axis)
        return _fluid_act(fn(x, y), act)
    op.__name__ = op.__qualname__ = f"elementwise_{name}"
    return op


elementwise_floordiv = _elementwise("floordiv", torch.floor_divide)
elementwise_mod = _elementwise("mod", torch.remainder)
elementwise_pow = _elementwise("pow", torch.pow)
elementwise_max = _elementwise("max", torch.maximum)
elementwise_min = _elementwise("min", torch.minimum)


def _reduce(new_fn, name):
    def op(input, dim=None, keep_dim=False, name=None):
        return new_fn(input, axis=dim, keepdim=keep_dim)
    op.__name__ = op.__qualname__ = name
    return op


reduce_sum = _reduce(reduction.sum, "reduce_sum")
reduce_mean = _reduce(reduction.mean, "reduce_mean")
reduce_max = _reduce(reduction.max, "reduce_max")
reduce_min = _reduce(reduction.min, "reduce_min")
reduce_prod = _reduce(reduction.prod, "reduce_prod")
reduce_all = _reduce(reduction.all, "reduce_all")
reduce_any = _reduce(reduction.any, "reduce_any")


# --------------------------------------------------------------------------
# misc tensor ops

def add_n(inputs, name=None):
    if torch.is_tensor(inputs):
        return inputs
    out = inputs[0]
    for v in inputs[1:]:
        out = out + v
    return out


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    t = creation.full(shape, value, dtype=dtype)
    if out is not None:
        with torch.no_grad():
            out.copy_(t)
        return out
    return t


def crop_tensor(x, shape=None, offsets=None, name=None):
    xshape = list(x.shape)
    shape = list(shape) if shape is not None else xshape
    shape = [xshape[i] if s in (-1, None) else int(s)
             for i, s in enumerate(shape)]
    offsets = list(offsets) if offsets is not None else [0] * len(xshape)
    return x[tuple(slice(int(o), int(o) + int(s))
                   for o, s in zip(offsets, shape))]


def has_inf(x, name=None):
    return torch.isinf(x).any()


def has_nan(x, name=None):
    return torch.isnan(x).any()


def rank(input, name=None):
    return _t(np.asarray(input.dim(), np.int32))


def shape(input, name=None):
    return _t(np.asarray(tuple(input.shape), np.int32))


def reverse(x, axis, name=None):
    return manipulation.flip(x, axis)


def scatter_nd(index, updates, shape, name=None):
    zeros = torch.zeros(ints(shape), dtype=updates.dtype,
                        device=updates.device)
    return manipulation.scatter_nd_add(zeros, index, updates)


def get_tensor_from_selected_rows(x, name=None):
    """reference `operators/get_tensor_from_selected_rows_op.cc`:
    materialize a SelectedRows into its dense tensor (a numpy one onto the
    default device). Dense tensors pass through."""
    if isinstance(x, SelectedRows):
        return _t(x.to_dense())
    return x


def merge_selected_rows(x, name=None):
    """reference `operators/merge_selected_rows_op.cc`: sum duplicate
    row ids."""
    if isinstance(x, SelectedRows):
        return x.merge()
    return x


_PARAM_COUNT = [0]


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """Reference: `python/paddle/fluid/layers/tensor.py` create_parameter.
    Dygraph: a `torch.nn.Parameter` on the default device. While a static
    Program is built: a Program parameter (`make_parameter`) that
    `Executor.run` trains."""
    from ..nn import initializer as init
    ini = default_initializer
    if ini is None:
        ini = init.Constant(0.0) if is_bias else init.XavierNormal()
    with static_hook.suppressed():
        value = torch.empty(ints(shape), dtype=to_torch_dtype(dtype),
                            device=resolve_device(None))
        ini(value)
    if static_hook.recording():
        from ..static import program as _prog
        if name is None:
            _PARAM_COUNT[0] += 1
            name = f"create_parameter_{_PARAM_COUNT[0]}"
        return _prog.make_parameter(name, value)
    p = torch.nn.Parameter(value)
    if name is not None:
        p._pt_name = name
    return p


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    t = creation.full(shape, value, dtype=dtype)
    t.persistable = persistable
    if name:
        t._pt_name = name   # torch.Tensor's `name` is not settable
    return t


# --------------------------------------------------------------------------
# tensor arrays (reference: LoDTensorArray + layers/control_flow array ops)

class LoDTensorArray(list):
    """Python-list-backed tensor array (the reference's C++
    vector<LoDTensor> variable type for while-loop state)."""


class LoDTensor(torch.Tensor):
    """Dense tensor + LoD offsets (`framework/lod_tensor.h:114`). Its
    torch calls give plain tensors (the offsets would not hold for them);
    the `sequence_*` ops read and write the offsets."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __new__(cls, value=None, lod=None):
        if value is None:
            value = np.zeros((0,), np.float32)
        t = _t(value).as_subclass(cls)
        t._lod = [list(level) for level in (lod or [])]
        return t

    def __init__(self, value=None, lod=None):
        pass

    def lod(self):
        return self._lod

    def set_lod(self, lod):
        self._lod = lod

    def recursive_sequence_lengths(self):
        return [[b - a for a, b in zip(level[:-1], level[1:])]
                for level in self._lod]


def _lod_like(value, lod, like):
    """A LoDTensor of `value` (numpy) on `like`'s device."""
    return LoDTensor(_t(value, like), lod)


def create_array(dtype="float32", initialized_list=None):
    arr = LoDTensorArray()
    if initialized_list:
        arr.extend(initialized_list)
    return arr


def array_write(x, i, array=None):
    if array is None:
        array = create_array()
    idx = int(i)
    while len(array) <= idx:
        array.append(None)
    array[idx] = x
    return array


def array_read(array, i):
    return array[int(i)]


def array_length(array):
    return _t(np.asarray(len(array), np.int64))


def tensor_array_to_tensor(input, axis=1, use_stack=False, name=None):
    op = manipulation.stack if use_stack else manipulation.concat
    out = op(list(input), axis=axis)
    sizes = np.asarray([t.shape[axis] if not use_stack else 1
                        for t in input], np.int32)
    return out, _t(sizes, out)


# ---------------------------------------------------------------------------
# LoD sequence ops (reference `operators/sequence_ops/*.cc`): host-side
# conveniences over a LoDTensor (concat-of-sequences + offsets); compiled
# models use padded dense + sequence_mask instead.
# ---------------------------------------------------------------------------

def _seq_offsets(x):
    lod = x.lod() if isinstance(x, LoDTensor) else []
    if not lod:
        raise ValueError("sequence op needs a LoDTensor with level-0 LoD")
    return list(lod[0])


def sequence_pad(x, pad_value=0.0, maxlen=None, name=None):
    """(LoDTensor rows) → (padded [N, maxlen, ...], lengths [N] int64)
    (reference `sequence_pad_op.cc`)."""
    offs = _seq_offsets(x)
    v = _host(x)
    lens = [b - a for a, b in zip(offs[:-1], offs[1:])]
    m = maxlen or max(lens)
    out = np.full((len(lens), m) + v.shape[1:], pad_value, v.dtype)
    for i, (a, b) in enumerate(zip(offs[:-1], offs[1:])):
        out[i, :b - a] = v[a:b]
    return _t(out, x), _t(np.asarray(lens, np.int64), x)


def sequence_unpad(x, length, name=None):
    """Inverse of sequence_pad (reference `sequence_unpad_op.cc`)."""
    v = _host(x)
    lens = _host(length).astype(np.int64)
    rows = np.concatenate([v[i, :l] for i, l in enumerate(lens)], axis=0)
    offs = np.concatenate([[0], np.cumsum(lens)]).tolist()
    return _lod_like(rows, [offs], x)


def sequence_pool(input, pool_type="average", name=None):
    """Per-sequence pooling (reference `sequence_pool_op.cc`):
    sum/average/sqrt/max/min/last/first; an empty sequence pools to 0."""
    offs = _seq_offsets(input)
    v = _host(input)
    p = pool_type.lower()
    if p not in ("sum", "average", "mean", "sqrt", "max", "min", "last",
                 "first"):
        raise ValueError(f"unknown pool_type {pool_type!r}")
    outs = []
    for a, b in zip(offs[:-1], offs[1:]):
        if b == a:
            outs.append(np.zeros(v.shape[1:], v.dtype))
            continue
        seg = v[a:b]
        if p == "sum":
            outs.append(seg.sum(0))
        elif p in ("average", "mean"):
            outs.append(seg.mean(0))
        elif p == "sqrt":
            outs.append(seg.sum(0) / np.sqrt(b - a))
        elif p == "max":
            outs.append(seg.max(0))
        elif p == "min":
            outs.append(seg.min(0))
        elif p == "last":
            outs.append(seg[-1])
        else:
            outs.append(seg[0])
    return _t(np.stack(outs), input)


def sequence_softmax(input, name=None):
    """Softmax within each sequence (reference `sequence_softmax_op.cc`,
    width-1 input)."""
    offs = _seq_offsets(input)
    v = _host(input).astype(np.float32)
    if v.ndim > 1 and v.shape[-1] != 1:
        raise ValueError(
            f"sequence_softmax requires input width 1, got {v.shape}")
    out = np.empty_like(v)
    for a, b in zip(offs[:-1], offs[1:]):
        if b == a:
            continue
        e = np.exp(v[a:b] - v[a:b].max())
        out[a:b] = e / e.sum()
    return _lod_like(out, input.lod(), input)


def sequence_reverse(x, name=None):
    """Reverse rows inside each sequence (reference
    `sequence_reverse_op.h`)."""
    offs = _seq_offsets(x)
    v = _host(x).copy()
    for a, b in zip(offs[:-1], offs[1:]):
        v[a:b] = v[a:b][::-1]
    return _lod_like(v, x.lod(), x)


def sequence_concat(input, name=None):
    """Concatenate LoDTensors sequence by sequence (reference
    `sequence_concat_op.cc`)."""
    all_offs = [_seq_offsets(t) for t in input]
    n = len(all_offs[0]) - 1
    vals = [_host(t) for t in input]
    rows, offs = [], [0]
    for i in range(n):
        for v, of in zip(vals, all_offs):
            rows.append(v[of[i]:of[i + 1]])
        offs.append(offs[-1] + sum(of[i + 1] - of[i] for of in all_offs))
    if not rows:
        return _lod_like(np.zeros((0,) + vals[0].shape[1:], vals[0].dtype),
                         [offs], input[0])
    return _lod_like(np.concatenate(rows, 0), [offs], input[0])


def sequence_expand(x, y, ref_level=0, name=None):
    """Repeat each sequence of x to match y's LoD at ref_level (reference
    `sequence_expand_op.cc`); a dense x repeats row by row."""
    x_offs = _seq_offsets(x) if isinstance(x, LoDTensor) and x.lod() \
        else None
    y_offs = list(y.lod()[ref_level])
    v = _host(x)
    rows, offs = [], [0]
    for i in range(len(y_offs) - 1):
        reps = y_offs[i + 1] - y_offs[i]
        seg = v[x_offs[i]:x_offs[i + 1]] if x_offs is not None \
            else v[i:i + 1]
        rows.extend([seg] * reps)
        offs.append(offs[-1] + reps * seg.shape[0])
    if not rows:
        return _lod_like(np.zeros((0,) + v.shape[1:], v.dtype), [offs], x)
    return _lod_like(np.concatenate(rows, 0), [offs], x)


def lod_reset(x, y=None, target_lod=None):
    """reference `lod_reset_op.cc`: replace x's LoD with y's (or the given
    offsets)."""
    if y is not None:
        lod = [_seq_offsets(y)] if isinstance(y, LoDTensor) else \
            [list(_host(y).astype(int))]
    elif target_lod is not None:
        lod = [list(target_lod)]
    else:
        raise ValueError("lod_reset needs y or target_lod")
    return LoDTensor(_t(x).detach() if torch.is_tensor(x) else x, lod)


def sequence_reshape(input, new_dim):
    """reference `sequence_reshape_op.cc`: re-chunk each sequence's
    flattened payload to rows of new_dim."""
    offs = _seq_offsets(input)
    v = _host(input)
    new_offs, rows = [0], []
    for a, b in zip(offs[:-1], offs[1:]):
        payload = v[a:b].reshape(-1)
        if payload.size % new_dim:
            raise ValueError("sequence payload not divisible by new_dim")
        rows.append(payload.reshape(-1, new_dim))
        new_offs.append(new_offs[-1] + rows[-1].shape[0])
    return _lod_like(np.concatenate(rows, 0), [new_offs], input)


def sequence_slice(input, offset, length):
    """reference `sequence_slice_op.cc`: per-sequence [offset, offset +
    length) slices."""
    offs = _seq_offsets(input)
    v = _host(input)
    off = _host(offset).reshape(-1).astype(int)
    ln = _host(length).reshape(-1).astype(int)
    rows, new_offs = [], [0]
    for i, (a, b) in enumerate(zip(offs[:-1], offs[1:])):
        rows.append(v[a + off[i]:a + off[i] + ln[i]])
        new_offs.append(new_offs[-1] + rows[-1].shape[0])
    return _lod_like(np.concatenate(rows, 0), [new_offs], input)


def sequence_scatter(input, index, updates):
    """reference `sequence_scatter_op.cc`: add `updates` rows into `input`
    at per-sequence `index` positions (sequence i of the LoD pair
    addresses row i of the dense input)."""
    out = _host(input).copy()
    offs = _seq_offsets(index)
    iv = _host(index).reshape(-1).astype(int)
    uv = _host(updates)
    for i, (a, b) in enumerate(zip(offs[:-1], offs[1:])):
        # np.add.at accumulates duplicate indices (fancy += would not)
        np.add.at(out[i], iv[a:b], uv[a:b] if uv.ndim == 1 else uv[a:b, 0])
    return _t(out, input)


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both", name=None):
    """reference `operators/print_op.cc` / fluid.layers.Print: print the
    tensor as a side effect and pass it through, at most `first_n` times
    (all when negative), the first `summarize` values (all when
    negative). While a static Program is built it records one op named
    "print" and stays silent, counting nothing; each run of the Program
    replays it and prints."""
    from ..static import program as _prog
    msg = str(message or getattr(input, "name", None) or "var")
    state = {"n": 0, "building": static_hook.recording()}

    def fmt(v, values):
        parts = [msg] if print_tensor_name else []
        if print_tensor_shape:
            parts.append(f"shape={tuple(v.shape)}")
        if print_tensor_type:
            parts.append(f"dtype={str(v.dtype).replace('torch.', '')}")
        return f"{' '.join(parts)} value={values}"

    def impl(v):
        # a view, not `v` itself: the recorder keeps only ops that make a
        # new tensor
        out = v.view_as(v)
        if state["building"] or 0 <= first_n <= state["n"]:
            return out
        state["n"] += 1
        flat = _host(v).ravel()
        print(fmt(v, flat if summarize < 0 else flat[:summarize]),
              flush=True)
        return out
    out = _prog.apply_op("print", impl, (input,))
    state["building"] = False
    return out


def _xxh32(data: bytes, seed: int = 0) -> int:
    """XXH32 (public spec), the hash pyramid_hash_op.h uses via
    <xxhash.h>; the JAX package's pure-Python copy, so both packages hash
    alike with no native dependency."""
    P1, P2, P3, P4, P5 = (2654435761, 2246822519, 3266489917,
                          668265263, 374761393)
    M = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & M

    n = len(data)
    i = 0
    if n >= 16:
        v = [(seed + P1 + P2) & M, (seed + P2) & M, seed & M,
             (seed - P1) & M]
        while i <= n - 16:
            for j in range(4):
                lane = int.from_bytes(data[i + 4 * j:i + 4 * j + 4],
                                      "little")
                v[j] = (rotl((v[j] + lane * P2) & M, 13) * P1) & M
            i += 16
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12)
             + rotl(v[3], 18)) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while i <= n - 4:
        h = (h + int.from_bytes(data[i:i + 4], "little") * P3) & M
        h = (rotl(h, 17) * P4) & M
        i += 4
    while i < n:
        h = (h + data[i] * P5) & M
        h = (rotl(h, 11) * P1) & M
        i += 1
    h ^= h >> 15
    h = (h * P2) & M
    h ^= h >> 13
    h = (h * P3) & M
    h ^= h >> 16
    return h


_PYRAMID_RNGS = {}


def search_pyramid_hash(input, num_emb, space_len, pyramid_layer, rand_len,
                        drop_out_percent=0.0, is_training=False,
                        use_filter=False, white_list=None, black_list=None,
                        seed=0, weights=None, name=None):
    """reference `operators/pyramid_hash_op.cc`
    (fluid.contrib.layers.search_pyramid_hash): hash every n-gram window
    (lengths 2..pyramid_layer) of an int-id LoD sequence with XXH32 and
    assemble a num_emb embedding from rand_len-wide chunks of the flat
    weight table at the chained hash offsets.

    Returns a LoDTensor with one embedding row per surviving n-gram; the
    gather from `weights` is differentiable (the hash positions are
    computed on the host). White/black lists filter by exact membership of
    the n-gram hash (the JAX package's simplification of the reference's
    bloom filter)."""
    if num_emb % rand_len:
        raise ValueError("num_emb must be divisible by rand_len")
    w_t = weights if torch.is_tensor(weights) else _t(
        np.asarray(weights, np.float32).reshape(-1))
    W_len = int(w_t.numel())
    if W_len < space_len + rand_len:
        raise ValueError("weights must hold space_len + rand_len floats")
    offs = _seq_offsets(input)
    ids = _host(input).reshape(-1).astype(np.int32)
    white = set(int(x) for x in np.asarray(white_list).ravel()) \
        if (use_filter and white_list is not None) else None
    black = set(int(x) for x in np.asarray(black_list).ravel()) \
        if (use_filter and black_list is not None) else None
    # one RNG per seed for the process (the reference advances a member
    # seed across calls: a fresh one per call would drop the same grams
    # every step)
    rng = _PYRAMID_RNGS.setdefault(int(seed),
                                   np.random.RandomState(int(seed) or 1))
    gather_rows, new_offs = [], [0]
    for a, b in zip(offs[:-1], offs[1:]):
        seq = ids[a:b]
        count = 0
        for win in range(2, int(pyramid_layer) + 1):
            for st in range(0, len(seq) - win + 1):
                gram = seq[st:st + win].astype(np.float32).tobytes()
                key = _xxh32(gram, 0)
                if white is not None and key not in white:
                    continue
                if black is not None and key in black:
                    continue
                # drop_out_percent is 0-100 (rand % 100 > percent keeps)
                if is_training and drop_out_percent > 0 and \
                        not rng.randint(0, 100) > drop_out_percent:
                    continue
                idx = np.empty(num_emb, np.int64)
                pos1 = key % space_len
                pos2 = _xxh32(gram, rand_len) % space_len
                for j in range(0, num_emb, rand_len):
                    pos3 = _xxh32(gram, j + 2 * rand_len) % space_len
                    idx[j:j + rand_len] = np.arange(pos1, pos1 + rand_len)
                    pos1, pos2 = pos2, pos3
                gather_rows.append(idx)
                count += 1
        new_offs.append(new_offs[-1] + count)
    if gather_rows:
        idx_mat = torch.from_numpy(np.stack(gather_rows)).to(w_t.device)
        out = w_t.reshape(-1)[idx_mat]
    else:
        out = torch.zeros((0, num_emb), dtype=w_t.dtype, device=w_t.device)
    # keep the autograd graph: view the result as a LoDTensor
    out = out.as_subclass(LoDTensor)
    out._lod = [new_offs]
    return out


pyramid_hash = search_pyramid_hash
