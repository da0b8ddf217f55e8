"""paddle_tpu_torch.onnx.export — ONNX-13 from the port's own trace.

The JAX package traces a layer to a jaxpr and maps each primitive onto an
ONNX op (`paddle_tpu/onnx/export.py`). The port's counterpart of that
trace is the `torch.export` program that `jit.save` builds: the layer in
eval mode is exported at the input specs' shapes, the program is run
through `run_decompositions()` to core ATen, and each ATen op maps onto
ONNX-13 ops here. As in the JAX package:

- parameters and buffers become initializers under their `state_dict`
  names, holding the port's own tensors (a Linear weight stays [out, in];
  the graph reads it through `Gemm(transB=1)` or a `Transpose`), copied
  to the host from whatever device the layer is on;
- an op whose inputs are all constants is evaluated at export time and
  becomes an initializer when its result is at most 1 MiB
  (`_FOLD_LIMIT_BYTES`), so index grids and masks melt into constants;
- an op with no mapping raises `UnsupportedOnnxExport` naming it, and no
  file is written. The fused recurrent ops (`aten.lstm`, `gru`,
  `rnn_tanh`, `rnn_relu`) are kept whole by the decomposition, so the
  port's `nn.LSTM` is refused, as the JAX package refuses its scan;
- `None` dims are traced at 1 (the JAX package's `_spec_to_sds` without a
  scope): the graph has fixed shapes;
- bfloat16 values are written and computed as float32.

Attention. Kernel K2, the registered op `paddle_tpu_torch::flash_fwd`, is
a custom op, so the decomposition leaves it whole; ONNX-13 has no
attention op and cannot hold a CUDA kernel, so the exporter writes what
K2's plain version computes (`ops.flash_ops._flash_fwd_reference`):
`MatMul(Q, K^T) * scale`, plus the key-padding bias, with the causal cut
when the op is causal, then `Softmax` and `MatMul(., V)`, in float32. A
node with dropout p > 0 is refused (eval mode never makes one). Below
`FLAGS_flash_attention_min_seq` the port's attention is its plain math
(`nn.functional.attention._sdpa_ref`: einsum, softmax), which traces to
ordinary ops. The trace is not forced onto the math backend: a layer of
the caller's that calls PyTorch's own scaled-dot-product attention
records one of the library's attention ops, and those are lowered the
same way.
"""
from __future__ import annotations

import operator
import warnings

import numpy as np
import torch

from . import proto

__all__ = ["export", "trace", "write", "TorchToOnnx",
           "UnsupportedOnnxExport"]

_FOLD_LIMIT_BYTES = 1 << 20   # don't materialize folded constants above 1MB
_NEG = -1e30                  # the flash kernels' masked score

# the fused recurrences: kept whole by the decomposition, so that the
# exporter refuses them instead of writing an unrolled cell loop
_KEEP_WHOLE = ("lstm.input", "lstm.data", "gru.input", "gru.data",
               "rnn_tanh.input", "rnn_tanh.data", "rnn_relu.input",
               "rnn_relu.data")

# ops whose result depends only on their inputs' shapes and types
_SHAPE_ONLY = {"aten::full_like", "aten::zeros_like", "aten::ones_like",
               "aten::empty_like", "aten::new_zeros", "aten::new_ones",
               "aten::new_full", "aten::new_empty"}

# ops with no value: dropped from the graph
_NO_VALUE = {"aten::_assert_tensor_metadata", "aten::_assert_scalar",
             "aten::sym_constrain_range_for_size",
             "aten::_assert_async"}

_ONNX_DT = {torch.float32: 1, torch.uint8: 2, torch.int8: 3,
            torch.int16: 5, torch.int32: 6, torch.int64: 7, torch.bool: 9,
            torch.float16: 10, torch.float64: 11, torch.bfloat16: 1}


class UnsupportedOnnxExport(NotImplementedError):
    pass


def _dt(dtype):
    """The dtype a value has in the graph (bfloat16 is float32 there)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _onnx_dtype(dtype) -> int:
    if dtype not in _ONNX_DT:
        raise UnsupportedOnnxExport(f"no ONNX type for {dtype}")
    return _ONNX_DT[dtype]


def _np(t: torch.Tensor) -> np.ndarray:
    """A constant as a host numpy array (bfloat16 as float32)."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.contiguous().numpy()


def _np_dtype(dtype):
    return _np(torch.empty(0, dtype=_dt(dtype))).dtype


def _op_name(target) -> str:
    schema = getattr(target, "_schema", None)
    return schema.name if schema is not None else str(target)


def _bind(node) -> dict:
    """The node's arguments by their schema names, defaults filled in."""
    out = {}
    for i, a in enumerate(node.target._schema.arguments):
        if not a.kwarg_only and i < len(node.args):
            out[a.name] = node.args[i]
        elif a.name in node.kwargs:
            out[a.name] = node.kwargs[a.name]
        else:
            out[a.name] = a.default_value if a.has_default_value() else None
    return out


def _meta(node):
    return node.meta.get("val")


def _is_const_val(v) -> bool:
    if isinstance(v, (list, tuple)):
        return all(_is_const_val(x) for x in v)
    return torch.is_tensor(v)


class TorchToOnnx:
    """Walks a decomposed `torch.export` graph and emits ONNX nodes.

    `env` maps each graph node to its value: a host tensor (a constant,
    foldable), an ONNX value name, or a list of either (an op with several
    outputs)."""

    def __init__(self):
        self.nodes = []            # (op_type, inputs, outputs, attrs)
        self.initializers = {}     # name -> encoded TensorProto
        self.env = {}              # fx node -> value
        self.dtypes = {}           # onnx name -> torch dtype
        self._const_names = {}     # id(constant tensor) -> initializer
        self._deferred = set()     # [1, 0] permutes read by Gemm(transB)
        self._transposed = {}      # Transpose output -> (input, perm)
        self.weights = set()       # initializers of parameters / buffers
        self._n = 0

    # -- naming ---------------------------------------------------------------
    def fresh(self, hint="t"):
        self._n += 1
        return f"{hint}_{self._n}"

    def add_initializer(self, value, hint="const", name=None):
        arr = value if isinstance(value, np.ndarray) else _np(value)
        name = name or self.fresh(hint)
        self.initializers[name] = proto.tensor_proto(name, arr)
        self.dtypes[name] = torch.from_numpy(np.zeros(0, arr.dtype)).dtype \
            if arr.dtype != np.bool_ else torch.bool
        return name

    def const(self, value, dtype, hint="const"):
        """An initializer holding `value` (a number or array) as `dtype`."""
        t = torch.as_tensor(np.asarray(value)).to(_dt(dtype))
        return self.add_initializer(t, hint)

    def emit(self, op_type, in_names, out_names, attrs=None, dtype=None):
        self.nodes.append((op_type, list(in_names), list(out_names), attrs))
        if dtype is not None:
            for o in out_names:
                self.dtypes[o] = _dt(dtype)

    def op(self, op_type, in_names, dtype, attrs=None, hint=None):
        """Emit one single-output node; returns its output's name."""
        out = self.fresh(hint or op_type.lower())
        self.emit(op_type, in_names, [out], attrs, dtype)
        return out

    # -- values ---------------------------------------------------------------
    def dtype_of(self, x):
        if isinstance(x, torch.fx.Node):
            v = self.env[x]
            if torch.is_tensor(v):
                return _dt(v.dtype)
            return self.dtypes[v]
        if torch.is_tensor(x):
            return _dt(x.dtype)
        return None

    def name_of(self, x, dtype=None):
        """The ONNX name of an argument (a graph node, a tensor or a
        number), cast to `dtype` when given and different."""
        v = self.env[x] if isinstance(x, torch.fx.Node) else x
        if isinstance(v, _Unavailable):
            raise UnsupportedOnnxExport(f"the graph reads {v}")
        if not torch.is_tensor(v) and not isinstance(v, str):
            if dtype is None:
                raise UnsupportedOnnxExport(f"untyped scalar operand {v!r}")
            return self.const(v, dtype, "scalar")
        if torch.is_tensor(v):
            if dtype is not None and _dt(v.dtype) != _dt(dtype):
                return self.add_initializer(v.to(_dt(dtype)))
            # every constant stays alive in `env` while exporting, so its
            # id names it
            name = self._const_names.get(id(v))
            if name is None:
                name = self._const_names[id(v)] = self.add_initializer(v)
            return name
        if dtype is not None and self.dtypes[v] != _dt(dtype):
            return self.op("Cast", [v], dtype, {"to": _onnx_dtype(
                _dt(dtype))})
        return v

    def transpose(self, name, perm, dtype):
        """`name` transposed by `perm`; a transpose of a transpose reads
        the first one's input with the two permutations composed (none at
        all when they cancel)."""
        if name in self._transposed:
            src, first = self._transposed[name]
            name, perm = src, [first[p] for p in perm]
        if list(perm) == list(range(len(perm))):
            return name
        out = self.op("Transpose", [name], dtype, {"perm": list(perm)})
        self._transposed[out] = (name, list(perm))
        return out

    def encoded_nodes(self, outputs):
        """The NodeProtos of the nodes that the graph outputs depend on
        (a transpose folded into a later one is dropped), and the
        initializers they read or that hold weights."""
        live, keep = set(outputs), []
        for op_type, ins, outs, attrs in reversed(self.nodes):
            if any(o in live for o in outs):
                keep.append((op_type, ins, outs, attrs))
                live.update(i for i in ins if i)
        nodes = [proto.node_proto(op_type, ins, outs,
                                  f"{op_type.lower()}_{i}", attrs)
                 for i, (op_type, ins, outs, attrs)
                 in enumerate(reversed(keep))]
        inits = [t for n, t in self.initializers.items()
                 if n in live or n in self.weights]
        return nodes, inits

    def shape_const(self, dims, hint="shape"):
        return self.add_initializer(np.asarray(list(dims), np.int64), hint)

    # -- conversion -----------------------------------------------------------
    def run(self, ep):
        graph = ep.graph
        self._defer_transposes(graph)
        for node in graph.nodes:
            if node.op == "call_function":
                self.call(node)
            elif node.op not in ("placeholder", "output"):
                raise UnsupportedOnnxExport(
                    f"graph node kind {node.op!r} ({node.target})")

    def _defer_transposes(self, graph):
        """[1, 0] permutes whose every reader takes them as a matrix
        product's second operand: the product reads the permute's input
        with transB=1, so a Linear's [out, in] weight needs no Transpose."""
        for node in graph.nodes:
            if node.op != "call_function" or \
                    _op_name(node.target) != "aten::permute":
                continue
            if len(_meta(node.args[0]).shape) != 2 or \
                    [int(d) % 2 for d in _bind(node)["dims"]] != [1, 0]:
                continue
            if node.users and all(_second_operand_only(node, u)
                                  for u in node.users):
                self._deferred.add(node)

    def call(self, node):
        target = node.target
        if target is operator.getitem:
            src, idx = node.args
            self.env[node] = self.env[src][idx]
            return
        name = _op_name(target)
        if name in _NO_VALUE:
            self.env[node] = None
            return
        if node in self._deferred:
            self.env[node] = ("transposed", node.args[0])
            return
        if self._fold(node, name):
            return
        handler = _HANDLERS.get(name)
        if handler is None:
            raise UnsupportedOnnxExport(
                f"ATen op '{target}' has no ONNX mapping (node "
                f"{node.name}: {node.format_node()})")
        handler(self, node, _bind(node) if hasattr(target, "_schema")
                else None)

    def _fold(self, node, name) -> bool:
        """Evaluate a node whose inputs are all constants (or, for the
        shape-only ops, whose values it does not read); True when its
        result became a constant."""
        tags = getattr(node.target, "tags", ())
        if torch.Tag.nondeterministic_seeded in tags or \
                name == "paddle_tpu_torch::flash_fwd":
            return False
        shape_only = name in _SHAPE_ONLY

        def sub(x):
            if isinstance(x, torch.fx.Node):
                v = self.env[x]
                if _is_const_val(v):
                    return v
                if shape_only:
                    m = _meta(x)
                    return torch.empty(tuple(m.shape), dtype=m.dtype)
                raise _NotConst
            if isinstance(x, torch.device):
                return torch.device("cpu")
            return x
        try:
            args = torch.fx.node.map_aggregate(node.args, sub)
            kwargs = torch.fx.node.map_aggregate(node.kwargs, sub)
        except _NotConst:
            return False
        try:
            with torch.no_grad():
                out = node.target(*args, **dict(kwargs))
        except Exception:  # noqa: BLE001 — left to the op's handler
            return False
        leaves = out if isinstance(out, (list, tuple)) else [out]
        if not all(torch.is_tensor(t) for t in leaves) or sum(
                t.numel() * t.element_size() for t in leaves) \
                > _FOLD_LIMIT_BYTES:
            return False
        self.env[node] = list(out) if isinstance(out, (list, tuple)) \
            else out
        return True


class _NotConst(Exception):
    pass


class _Unavailable(str):
    """An output the graph does not compute (a pooling's indices, a batch
    norm's saved statistics); reading it refuses the export."""


def _second_operand_only(node, user) -> bool:
    """`user` is a matrix product that reads `node` as its second operand
    only."""
    pos = {"aten::addmm": 2, "aten::mm": 1}.get(_op_name(user.target))
    if pos is None:
        return False
    args = list(user.args)
    return len(args) > pos and args[pos] is node and node not in args[:pos]


# ---------------------------------------------------------------------------
# op handlers: fn(conv, node, bound_args)
# ---------------------------------------------------------------------------

_HANDLERS = {}


def _handles(*names):
    def deco(fn):
        for n in names:
            _HANDLERS[f"aten::{n}" if "::" not in n else n] = fn
        return fn
    return deco


def _out_dtype(node):
    """The traced type of the node's (first) output."""
    m = _meta(node)
    if isinstance(m, (list, tuple)):
        m = m[0]
    return _dt(m.dtype)


def _proxy(conv, x):
    dt = conv.dtype_of(x)
    return torch.empty(1, dtype=dt) if dt is not None else x


def _result_type(conv, *xs):
    xs = [x for x in xs if x is not None]
    t = _proxy(conv, xs[0])
    for x in xs[1:]:
        t = torch.empty(1, dtype=torch.result_type(t, _proxy(conv, x)))
    return t.dtype if torch.is_tensor(t) else torch.float32


def _set(conv, node, name):
    conv.env[node] = name


def _finish(conv, node, name, dtype):
    """Bind `name` (of `dtype`) to the node, cast to its traced type."""
    want = _out_dtype(node)
    if _dt(dtype) != want:
        name = conv.op("Cast", [name], want, {"to": _onnx_dtype(want)})
    _set(conv, node, name)


_BINARY = {
    "add": "Add", "sub": "Sub", "mul": "Mul", "div": "Div",
    "maximum": "Max", "minimum": "Min", "fmod": "Mod",
    "eq": "Equal", "lt": "Less", "le": "LessOrEqual", "gt": "Greater",
    "ge": "GreaterOrEqual", "ne": "Equal",
    "logical_and": "And", "logical_or": "Or", "logical_xor": "Xor",
    "bitwise_and": "And", "bitwise_or": "Or", "bitwise_xor": "Xor",
    "pow": "Pow", "remainder": "Mod", "atan2": None,
}
_COMPARE = {"eq", "lt", "le", "gt", "ge", "ne"}
_LOGICAL = {"logical_and", "logical_or", "logical_xor", "bitwise_and",
            "bitwise_or", "bitwise_xor"}


@_handles(*[k for k, v in _BINARY.items() if v])
def _binary(conv, node, a):
    base = node.target._schema.name.split("::")[1]
    x = a.get("self", a.get("input"))
    y = a.get("other", a.get("exponent"))
    ct = _result_type(conv, x, y)
    mode = a.get("rounding_mode") if base == "div" else None
    if base == "div" and not ct.is_floating_point and mode is None:
        ct = torch.float32
    if base in _LOGICAL:
        ct = torch.bool
    if base == "pow" and conv.dtype_of(y) is None:
        # a number exponent keeps the base's type
        ct = conv.dtype_of(x) or ct
    xn, yn = conv.name_of(x, ct), conv.name_of(y, ct)
    alpha = a.get("alpha", 1)
    if alpha not in (None, 1) and base in ("add", "sub"):
        yn = conv.op("Mul", [yn, conv.const(alpha, ct)], ct)
    if mode is not None:
        # ONNX's integer Div truncates; a float quotient is rounded here
        if not ct.is_floating_point and mode == "floor":
            raise UnsupportedOnnxExport("integer floor division")
        q = conv.op("Div", [xn, yn], ct)
        if ct.is_floating_point:
            q = conv.op("Floor", [q], ct) if mode == "floor" \
                else _trunc(conv, q, ct)
        return _finish(conv, node, q, ct)
    if base == "remainder":
        if ct.is_floating_point:
            q = conv.op("Floor", [conv.op("Div", [xn, yn], ct)], ct)
            out = conv.op("Sub", [xn, conv.op("Mul", [q, yn], ct)], ct)
        else:
            out = conv.op("Mod", [xn, yn], ct, {"fmod": 0})
        return _finish(conv, node, out, ct)
    op = _BINARY[base]
    attrs = {"fmod": 1} if base == "fmod" else None
    if base in _COMPARE:
        out = conv.op(op, [xn, yn], torch.bool)
        if base == "ne":
            out = conv.op("Not", [out], torch.bool)
        return _finish(conv, node, out, torch.bool)
    out = conv.op(op, [xn, yn], ct, attrs)
    _finish(conv, node, out, ct)


def _trunc(conv, x, dt):
    """Round toward zero: sign(x) * floor(|x|)."""
    return conv.op("Mul", [conv.op("Sign", [x], dt), conv.op(
        "Floor", [conv.op("Abs", [x], dt)], dt)], dt)


_UNARY = {
    "neg": "Neg", "exp": "Exp", "log": "Log", "tanh": "Tanh",
    "sigmoid": "Sigmoid", "sqrt": "Sqrt", "abs": "Abs", "sign": "Sign",
    "floor": "Floor", "ceil": "Ceil", "erf": "Erf", "sin": "Sin",
    "cos": "Cos", "tan": "Tan", "asin": "Asin", "acos": "Acos",
    "atan": "Atan", "sinh": "Sinh", "cosh": "Cosh", "relu": "Relu",
    "reciprocal": "Reciprocal", "round": "Round", "logical_not": "Not",
    "bitwise_not": "Not", "isnan": "IsNaN", "clone": "Identity",
}


@_handles(*_UNARY)
def _unary(conv, node, a):
    base = node.target._schema.name.split("::")[1]
    x = a["self"]
    dt = conv.dtype_of(x)
    if base == "logical_not":
        xn, dt = conv.name_of(x, torch.bool), torch.bool
    elif base == "bitwise_not" and dt != torch.bool:
        raise UnsupportedOnnxExport("bitwise_not of an integer tensor")
    else:
        xn = conv.name_of(x)
    if base == "clone":
        return _set(conv, node, xn)
    if base == "isnan":
        return _set(conv, node, conv.op("IsNaN", [xn], torch.bool))
    if not dt.is_floating_point and base not in (
            "neg", "abs", "sign", "relu", "logical_not", "bitwise_not"):
        ft = _out_dtype(node)
        xn, dt = conv.name_of(x, ft), ft
    _finish(conv, node, conv.op(_UNARY[base], [xn], dt), dt)


@_handles("isinf")
def _isinf(conv, node, a):
    _set(conv, node, conv.op("IsInf", [conv.name_of(a["self"])],
                             torch.bool))


@_handles("rsqrt")
def _rsqrt(conv, node, a):
    dt = _out_dtype(node)
    x = conv.name_of(a["self"], dt)
    _set(conv, node, conv.op("Reciprocal", [conv.op("Sqrt", [x], dt)], dt))


@_handles("log1p", "expm1")
def _log1p_expm1(conv, node, a):
    dt = _out_dtype(node)
    x = conv.name_of(a["self"], dt)
    one = conv.const(1.0, dt, "one")
    if node.target._schema.name == "aten::log1p":
        out = conv.op("Log", [conv.op("Add", [x, one], dt)], dt)
    else:
        out = conv.op("Sub", [conv.op("Exp", [x], dt), one], dt)
    _set(conv, node, out)


@_handles("gelu")
def _gelu(conv, node, a):
    dt = _out_dtype(node)
    x = conv.name_of(a["self"], dt)
    half = conv.const(0.5, dt, "half")
    one = conv.const(1.0, dt, "one")
    if a.get("approximate", "none") == "tanh":
        c = conv.const(np.sqrt(2.0 / np.pi), dt, "c")
        k = conv.const(0.044715, dt, "k")
        x3 = conv.op("Mul", [conv.op("Mul", [x, x], dt), x], dt)
        inner = conv.op("Mul", [c, conv.op("Add", [
            x, conv.op("Mul", [k, x3], dt)], dt)], dt)
        t = conv.op("Tanh", [inner], dt)
    else:
        r2 = conv.const(np.sqrt(2.0), dt, "sqrt2")
        t = conv.op("Erf", [conv.op("Div", [x, r2], dt)], dt)
    out = conv.op("Mul", [conv.op("Mul", [half, x], dt),
                          conv.op("Add", [one, t], dt)], dt)
    _set(conv, node, out)


@_handles("leaky_relu")
def _leaky_relu(conv, node, a):
    dt = _out_dtype(node)
    _set(conv, node, conv.op("LeakyRelu", [conv.name_of(a["self"], dt)],
                             dt, {"alpha": float(a["negative_slope"])}))


@_handles("elu")
def _elu(conv, node, a):
    if a.get("scale", 1) != 1 or a.get("input_scale", 1) != 1:
        raise UnsupportedOnnxExport("elu with a scale")
    dt = _out_dtype(node)
    _set(conv, node, conv.op("Elu", [conv.name_of(a["self"], dt)], dt,
                             {"alpha": float(a["alpha"])}))


@_handles("clamp", "hardtanh")
def _clamp(conv, node, a):
    dt = _out_dtype(node)
    x = conv.name_of(a["self"], dt)
    if node.target._schema.name == "aten::hardtanh":
        lo, hi = a["min_val"], a["max_val"]
    else:
        lo, hi = a.get("min"), a.get("max")
    ins = [x, "" if lo is None else conv.name_of(lo, dt),
           "" if hi is None else conv.name_of(hi, dt)]
    while ins[-1] == "":
        ins.pop()
    _set(conv, node, conv.op("Clip", ins, dt))


@_handles("where")
def _where(conv, node, a):
    dt = _out_dtype(node)
    c = conv.name_of(a["condition"], torch.bool)
    _set(conv, node, conv.op("Where", [c, conv.name_of(a["self"], dt),
                                       conv.name_of(a["other"], dt)], dt))


@_handles("_to_copy")
def _to_copy(conv, node, a):
    dt = _out_dtype(node)
    _set(conv, node, conv.name_of(a["self"], dt))


# -- shapes -----------------------------------------------------------------------

@_handles("view", "squeeze", "unsqueeze")
def _reshape(conv, node, a):
    x = conv.name_of(a["self"])
    shape = conv.shape_const(_meta(node).shape)
    _set(conv, node, conv.op("Reshape", [x, shape], conv.dtype_of(
        a["self"])))


@_handles("permute")
def _permute(conv, node, a):
    nd = len(_meta(a["self"]).shape)
    perm = [int(p) % nd for p in a["dims"]]
    _set(conv, node, conv.transpose(conv.name_of(a["self"]), perm,
                                    conv.dtype_of(a["self"])))


@_handles("expand")
def _expand(conv, node, a):
    x = conv.name_of(a["self"])
    shape = conv.shape_const(_meta(node).shape)
    _set(conv, node, conv.op("Expand", [x, shape], conv.dtype_of(
        a["self"])))


@_handles("cat")
def _cat(conv, node, a):
    dt = _out_dtype(node)
    ts = [t for t in a["tensors"]
          if tuple(_meta(t).shape) != (0,) or len(_meta(node).shape) == 1]
    axis = int(a["dim"]) % len(_meta(node).shape)
    _set(conv, node, conv.op("Concat", [conv.name_of(t, dt) for t in ts],
                             dt, {"axis": axis}))


@_handles("split_with_sizes")
def _split(conv, node, a):
    x = a["self"]
    nd = len(_meta(x).shape)
    dim = int(a["dim"]) % nd
    sizes = [int(s) for s in a["split_sizes"]]
    outs = [conv.fresh("split") for _ in sizes]
    conv.emit("Split", [conv.name_of(x), conv.shape_const(sizes, "split")],
              outs, {"axis": dim}, conv.dtype_of(x))
    conv.env[node] = outs


@_handles("slice")
def _slice(conv, node, a):
    x = a["self"]
    shape = _meta(x).shape
    dim = int(a["dim"]) % len(shape)
    n = int(shape[dim])
    start = 0 if a["start"] is None else int(a["start"])
    end = n if a["end"] is None else int(a["end"])
    start = max(0, min(n, start + n if start < 0 else start))
    end = max(0, min(n, end + n if end < 0 else end))
    ins = [conv.name_of(x), conv.shape_const([start], "starts"),
           conv.shape_const([end], "ends"), conv.shape_const([dim], "axes"),
           conv.shape_const([int(a["step"])], "steps")]
    _set(conv, node, conv.op("Slice", ins, conv.dtype_of(x)))


@_handles("select")
def _select(conv, node, a):
    x = a["self"]
    shape = _meta(x).shape
    dim = int(a["dim"]) % len(shape)
    idx = int(a["index"]) % int(shape[dim])
    i = conv.add_initializer(np.asarray(idx, np.int64), "index")
    _set(conv, node, conv.op("Gather", [conv.name_of(x), i],
                             conv.dtype_of(x), {"axis": dim}))


@_handles("index_select")
def _index_select(conv, node, a):
    x = a["self"]
    dim = int(a["dim"]) % len(_meta(x).shape)
    _set(conv, node, conv.op("Gather", [conv.name_of(x), conv.name_of(
        a["index"])], conv.dtype_of(x), {"axis": dim}))


@_handles("embedding")
def _embedding(conv, node, a):
    w = a["weight"]
    _set(conv, node, conv.op("Gather", [conv.name_of(w), conv.name_of(
        a["indices"])], conv.dtype_of(w), {"axis": 0}))


@_handles("index")
def _index(conv, node, a):
    x = a["self"]
    idx = list(a["indices"])
    live = [i for i, t in enumerate(idx) if t is not None]
    if len(live) != 1 or any(t is not None for t in idx[live[0] + 1:]):
        raise UnsupportedOnnxExport(
            f"advanced indexing with {len(live)} index tensors")
    ax = live[0]
    ind = idx[ax]
    if conv.dtype_of(ind) == torch.bool:
        raise UnsupportedOnnxExport("boolean-mask indexing")
    _set(conv, node, conv.op("Gather", [conv.name_of(x), conv.name_of(ind)],
                             conv.dtype_of(x), {"axis": ax}))


@_handles("gather")
def _gather(conv, node, a):
    x = a["self"]
    dim = int(a["dim"]) % len(_meta(x).shape)
    _set(conv, node, conv.op("GatherElements", [
        conv.name_of(x), conv.name_of(a["index"], torch.int64)],
        conv.dtype_of(x), {"axis": dim}))


@_handles("flip")
def _flip(conv, node, a):
    x = a["self"]
    nd = len(_meta(x).shape)
    dims = [int(d) % nd for d in a["dims"]]
    n = len(dims)
    ins = [conv.name_of(x), conv.shape_const([-1] * n, "starts"),
           conv.shape_const([np.iinfo(np.int64).min] * n, "ends"),
           conv.shape_const(dims, "axes"), conv.shape_const([-1] * n,
                                                            "steps")]
    _set(conv, node, conv.op("Slice", ins, conv.dtype_of(x)))


@_handles("repeat")
def _repeat(conv, node, a):
    x = a["self"]
    reps = [int(r) for r in a["repeats"]]
    shape = list(_meta(x).shape)
    xn = conv.name_of(x)
    if len(reps) > len(shape):
        shape = [1] * (len(reps) - len(shape)) + shape
        xn = conv.op("Reshape", [xn, conv.shape_const(shape)],
                     conv.dtype_of(x))
    _set(conv, node, conv.op("Tile", [xn, conv.shape_const(reps, "reps")],
                             conv.dtype_of(x)))


@_handles("constant_pad_nd")
def _pad(conv, node, a):
    x = a["self"]
    nd = len(_meta(x).shape)
    pad = [int(p) for p in a["pad"]]
    if any(p < 0 for p in pad):
        raise UnsupportedOnnxExport("negative padding")
    begin, end = [0] * nd, [0] * nd
    for i in range(len(pad) // 2):
        begin[nd - 1 - i], end[nd - 1 - i] = pad[2 * i], pad[2 * i + 1]
    dt = conv.dtype_of(x)
    ins = [conv.name_of(x), conv.shape_const(begin + end, "pads"),
           conv.const(a["value"], dt, "value")]
    _set(conv, node, conv.op("Pad", ins, dt, {"mode": "constant"}))


# -- reductions -------------------------------------------------------------------

def _axes(x, dims, node):
    nd = len(_meta(x).shape)
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return list(range(nd))
    if isinstance(dims, int):
        dims = [dims]
    return [int(d) % nd for d in dims]


@_handles("sum", "mean", "amax", "amin", "prod", "any", "all")
def _reduce(conv, node, a):
    base = node.target._schema.name.split("::")[1]
    x = a["self"]
    dims = a.get("dim", a.get("dims"))
    axes = _axes(x, dims, node)
    keep = int(bool(a.get("keepdim", False)))
    dt = _out_dtype(node)
    if base in ("any", "all"):
        t = conv.name_of(x, torch.int32)
        op = "ReduceMax" if base == "any" else "ReduceMin"
        r = conv.op(op, [t], torch.int32, {"axes": axes, "keepdims": keep})
        return _set(conv, node, conv.op("Cast", [r], torch.bool, {"to": 9}))
    xn = conv.name_of(x, dt)
    if base == "sum":
        out = conv.op("ReduceSum", [xn, conv.shape_const(axes, "axes")], dt,
                      {"keepdims": keep})
    else:
        op = {"mean": "ReduceMean", "amax": "ReduceMax",
              "amin": "ReduceMin", "prod": "ReduceProd"}[base]
        out = conv.op(op, [xn], dt, {"axes": axes, "keepdims": keep})
    _set(conv, node, out)


@_handles("max", "min")
def _max_dim(conv, node, a):
    base = node.target._schema.name.split("::")[1]
    x = a["self"]
    if "dim" not in a:   # max.default / max.other
        if "other" in a:
            return _binary_minmax(conv, node, a, base)
        axes = _axes(x, None, node)
        out = conv.op("ReduceMax" if base == "max" else "ReduceMin",
                      [conv.name_of(x)], conv.dtype_of(x),
                      {"axes": axes, "keepdims": 0})
        return _set(conv, node, out)
    dim = int(a["dim"]) % len(_meta(x).shape)
    keep = int(bool(a["keepdim"]))
    xn = conv.name_of(x)
    vals = conv.op("ReduceMax" if base == "max" else "ReduceMin", [xn],
                   conv.dtype_of(x), {"axes": [dim], "keepdims": keep})
    idx = conv.op("ArgMax" if base == "max" else "ArgMin", [xn],
                  torch.int64, {"axis": dim, "keepdims": keep})
    conv.env[node] = [vals, idx]


def _binary_minmax(conv, node, a, base):
    dt = _out_dtype(node)
    _set(conv, node, conv.op("Max" if base == "max" else "Min", [
        conv.name_of(a["self"], dt), conv.name_of(a["other"], dt)], dt))


@_handles("argmax", "argmin")
def _argmax(conv, node, a):
    base = node.target._schema.name.split("::")[1]
    x = a["self"]
    xn = conv.name_of(x)
    keep = int(bool(a["keepdim"]))
    if a["dim"] is None:
        n = int(np.prod(_meta(x).shape))
        xn = conv.op("Reshape", [xn, conv.shape_const([n])],
                     conv.dtype_of(x))
        dim = 0
    else:
        dim = int(a["dim"]) % len(_meta(x).shape)
    _set(conv, node, conv.op("ArgMax" if base == "argmax" else "ArgMin",
                             [xn], torch.int64,
                             {"axis": dim, "keepdims": keep}))


@_handles("cumsum")
def _cumsum(conv, node, a):
    x = a["self"]
    dt = _out_dtype(node)
    dim = int(a["dim"]) % len(_meta(x).shape)
    _set(conv, node, conv.op("CumSum", [conv.name_of(x, dt), conv.add_initializer(
        np.asarray(dim, np.int64), "axis")], dt))


@_handles("topk")
def _topk(conv, node, a):
    x = a["self"]
    dim = int(a["dim"]) % len(_meta(x).shape)
    vals, idx = conv.fresh("topk"), conv.fresh("topk_idx")
    conv.emit("TopK", [conv.name_of(x), conv.shape_const([int(a["k"])],
                                                         "k")],
              [vals, idx], {"axis": dim, "largest": int(bool(a["largest"])),
                            "sorted": 1})
    conv.dtypes[vals] = conv.dtype_of(x)
    conv.dtypes[idx] = torch.int64
    conv.env[node] = [vals, idx]


@_handles("_softmax", "_log_softmax")
def _softmax(conv, node, a):
    base = node.target._schema.name.split("::")[1]
    x = a["self"]
    dt = _out_dtype(node)
    axis = int(a["dim"]) % len(_meta(x).shape)
    op = "LogSoftmax" if "log" in base else "Softmax"
    _set(conv, node, conv.op(op, [conv.name_of(x, dt)], dt, {"axis": axis}))


# -- products, convolutions, normalisation ------------------------------------------

def _mat2(conv, m):
    """(name, transB) of a matrix product's second operand."""
    v = conv.env[m] if isinstance(m, torch.fx.Node) else None
    if isinstance(v, tuple) and v and v[0] == "transposed":
        return conv.name_of(v[1]), 1
    return conv.name_of(m), 0


@_handles("addmm")
def _addmm(conv, node, a):
    dt = _out_dtype(node)
    b, tb = _mat2(conv, a["mat2"])
    attrs = {"transB": tb}
    if a["alpha"] != 1:
        attrs["alpha"] = float(a["alpha"])
    if a["beta"] != 1:
        attrs["beta"] = float(a["beta"])
    _set(conv, node, conv.op("Gemm", [conv.name_of(a["mat1"]), b,
                                      conv.name_of(a["self"])], dt, attrs))


@_handles("mm")
def _mm(conv, node, a):
    dt = _out_dtype(node)
    b, tb = _mat2(conv, a["mat2"])
    if tb:
        out = conv.op("Gemm", [conv.name_of(a["self"]), b], dt,
                      {"transB": 1})
    else:
        out = conv.op("MatMul", [conv.name_of(a["self"]), b], dt)
    _set(conv, node, out)


@_handles("bmm")
def _bmm(conv, node, a):
    dt = _out_dtype(node)
    _set(conv, node, conv.op("MatMul", [conv.name_of(a["self"]),
                                        conv.name_of(a["mat2"])], dt))


def _pair(v, n):
    if isinstance(v, int):
        return [v] * n
    v = [int(x) for x in v]
    return v * n if len(v) == 1 else v


@_handles("convolution")
def _convolution(conv, node, a):
    dt = _out_dtype(node)
    w = a["weight"]
    n = len(_meta(w).shape) - 2
    pads = _pair(a["padding"], n)
    attrs = {"strides": _pair(a["stride"], n), "pads": pads + pads,
             "dilations": _pair(a["dilation"], n), "group": int(a["groups"]),
             "kernel_shape": [int(k) for k in _meta(w).shape[2:]]}
    if a["transposed"]:
        raise UnsupportedOnnxExport("transposed convolution")
    ins = [conv.name_of(a["input"]), conv.name_of(w)]
    if a["bias"] is not None:
        ins.append(conv.name_of(a["bias"]))
    _set(conv, node, conv.op("Conv", ins, dt, attrs))


@_handles("native_layer_norm")
def _layer_norm(conv, node, a):
    x = a["input"]
    dt = _out_dtype(node)
    nd = len(_meta(x).shape)
    k = len(a["normalized_shape"])
    axes = list(range(nd - k, nd))
    xn = conv.name_of(x, dt)
    mean = conv.op("ReduceMean", [xn], dt, {"axes": axes, "keepdims": 1})
    d = conv.op("Sub", [xn, mean], dt)
    var = conv.op("ReduceMean", [conv.op("Mul", [d, d], dt)], dt,
                  {"axes": axes, "keepdims": 1})
    rstd = conv.op("Reciprocal", [conv.op("Sqrt", [conv.op(
        "Add", [var, conv.const(a["eps"], dt, "eps")], dt)], dt)], dt)
    out = conv.op("Mul", [d, rstd], dt)
    if a["weight"] is not None:
        out = conv.op("Mul", [out, conv.name_of(a["weight"], dt)], dt)
    if a["bias"] is not None:
        out = conv.op("Add", [out, conv.name_of(a["bias"], dt)], dt)
    conv.env[node] = [out, mean, rstd]


@_handles("_native_batch_norm_legit_no_training")
def _batch_norm(conv, node, a):
    x = a["input"]
    dt = _out_dtype(node)
    c = _meta(x).shape[1]

    def param(t, fill):
        return conv.name_of(t, dt) if t is not None else conv.const(
            np.full(c, fill), dt)
    ins = [conv.name_of(x, dt), param(a["weight"], 1.0),
           param(a["bias"], 0.0), conv.name_of(a["running_mean"], dt),
           conv.name_of(a["running_var"], dt)]
    out = conv.op("BatchNormalization", ins, dt,
                  {"epsilon": float(a["eps"])})
    conv.env[node] = [out, _Unavailable("batch_norm's saved mean"),
                      _Unavailable("batch_norm's saved inverse std")]


def _pool_attrs(a, n, kernel):
    stride = _pair(a["stride"], n) if a["stride"] else list(kernel)
    pads = _pair(a["padding"], n)
    return {"kernel_shape": list(kernel), "strides": stride,
            "pads": pads + pads, "ceil_mode": int(bool(a["ceil_mode"]))}


@_handles("max_pool2d_with_indices")
def _max_pool(conv, node, a):
    x = a["self"]
    n = len(_meta(x).shape) - 2
    kernel = _pair(a["kernel_size"], n)
    attrs = _pool_attrs(a, n, kernel)
    dil = _pair(a.get("dilation", 1), n)
    if any(d != 1 for d in dil):
        attrs["dilations"] = dil
    out = conv.op("MaxPool", [conv.name_of(x)], conv.dtype_of(x), attrs)
    conv.env[node] = [out, _Unavailable("max_pool's indices")]


@_handles("avg_pool2d")
def _avg_pool(conv, node, a):
    if a.get("divisor_override") is not None:
        raise UnsupportedOnnxExport("avg_pool with divisor_override")
    x = a["self"]
    n = len(_meta(x).shape) - 2
    kernel = _pair(a["kernel_size"], n)
    attrs = _pool_attrs(a, n, kernel)
    attrs["count_include_pad"] = int(bool(a["count_include_pad"]))
    _set(conv, node, conv.op("AveragePool", [conv.name_of(x)],
                             conv.dtype_of(x), attrs))


@_handles("_adaptive_avg_pool2d")
def _adaptive_avg(conv, node, a):
    x = a["self"]
    shape = list(_meta(x).shape)
    out = [int(s) for s in a["output_size"]]
    if out == [1, 1]:
        return _set(conv, node, conv.op("GlobalAveragePool", [
            conv.name_of(x)], conv.dtype_of(x)))
    if any(i % o for i, o in zip(shape[2:], out)):
        raise UnsupportedOnnxExport(
            f"adaptive pooling {shape[2:]} -> {out} with uneven windows")
    k = [i // o for i, o in zip(shape[2:], out)]
    _set(conv, node, conv.op("AveragePool", [conv.name_of(x)],
                             conv.dtype_of(x),
                             {"kernel_shape": k, "strides": k}))


# -- attention ----------------------------------------------------------------------

def _attention(conv, q, k, v, bias, mask, causal, scale, want_lse,
               out_dtype):
    """What K2's plain version computes, in float32: softmax(Q K^T *
    scale + bias, causal cut) V, cast to q's type; and the row
    log-sum-exp when asked. `bias` is a [B, Sk] key bias, `mask` a
    general additive or boolean mask broadcast over the scores."""
    f32 = torch.float32
    qs, ks = _meta(q).shape, _meta(k).shape
    B, H, Sq, D = (int(s) for s in qs)
    Sk = int(ks[-2])
    if scale is None:
        scale = 1.0 / float(D) ** 0.5
    qn, kn, vn = (conv.name_of(t, f32) for t in (q, k, v))
    kt = conv.transpose(kn, [0, 1, 3, 2], f32)
    s = conv.op("MatMul", [qn, kt], f32, hint="scores")
    s = conv.op("Mul", [s, conv.const(scale, f32, "scale")], f32)
    if bias is not None:
        bn = conv.op("Reshape", [conv.name_of(bias, f32), conv.shape_const(
            [B, 1, 1, Sk])], f32)
        s = conv.op("Add", [s, bn], f32)
    if causal:
        keep = np.tril(np.ones((Sq, Sk), np.bool_))
        s = conv.op("Where", [conv.add_initializer(keep, "causal"), s,
                              conv.const(_NEG, f32, "neg")], f32)
    if mask is not None:
        if conv.dtype_of(mask) == torch.bool:
            s = conv.op("Where", [conv.name_of(mask), s,
                                  conv.const(_NEG, f32, "neg")], f32)
        else:
            s = conv.op("Add", [s, conv.name_of(mask, f32)], f32)
    p = conv.op("Softmax", [s], f32, {"axis": 3})
    out = conv.op("MatMul", [p, vn], f32, hint="attn")
    if _dt(out_dtype) != f32:
        out = conv.op("Cast", [out], out_dtype,
                      {"to": _onnx_dtype(_dt(out_dtype))})
    lse = _Unavailable("attention's log-sum-exp")
    if want_lse:
        lse = conv.op("ReduceLogSumExp", [s], f32, {"axes": [3],
                                                    "keepdims": 0})
        lse = conv.op("Reshape", [lse, conv.shape_const([B * H, Sq])], f32)
    return out, lse


def _reads_output(node, i):
    return any(u.target is operator.getitem and u.args[1] == i
               for u in node.users)


@_handles("paddle_tpu_torch::flash_fwd")
def _flash_fwd(conv, node, a):
    q, k, v, bias = a["q"], a["k"], a["v"], a["bias"]
    causal, scale, dropout_p = a["causal"], a["scale"], a["dropout_p"]
    if dropout_p > 0.0:
        raise UnsupportedOnnxExport(
            f"paddle_tpu_torch::flash_fwd with dropout p={dropout_p} "
            f"(export traces eval mode, which has none)")
    out, lse = _attention(conv, q, k, v, bias, None, causal, scale,
                          _reads_output(node, 1), _meta(q).dtype)
    conv.env[node] = [out, lse]


@_handles("_scaled_dot_product_flash_attention_for_cpu",
          "_scaled_dot_product_efficient_attention",
          "_scaled_dot_product_flash_attention",
          "_scaled_dot_product_cudnn_attention")
def _library_sdpa(conv, node, a):
    if a.get("dropout_p", 0.0) > 0.0:
        raise UnsupportedOnnxExport(f"{node.target} with dropout")
    mask = a.get("attn_mask", a.get("attn_bias"))
    out, lse = _attention(conv, a["query"], a["key"], a["value"], None,
                          mask, bool(a.get("is_causal", False)),
                          a.get("scale"), _reads_output(node, 1),
                          _meta(a["query"]).dtype)
    n = len(node.target._schema.returns)
    conv.env[node] = out if n == 1 else [out, lse] + [
        _Unavailable(f"{node.target}'s output {i}") for i in range(2, n)]


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def _decompositions():
    table = torch.export.default_decompositions()
    for name in _KEEP_WHOLE:
        packet, _, overload = name.partition(".")
        op = getattr(getattr(torch.ops.aten, packet), overload, None)
        if op is not None:
            table.pop(op, None)
    return table


def _example_inputs(input_spec, device):
    """Example tensors at the specs' shapes, None/-1 dims at 1, and the
    graph input names (the spec's name, else x<i>)."""
    from ..static.input_spec import _torch_dtype
    xs, names = [], []
    for i, spec in enumerate(input_spec):
        if torch.is_tensor(spec):
            xs.append(spec.to(device))
        else:
            shape = [1 if d is None or d == -1 else int(d)
                     for d in spec.shape]
            xs.append(torch.zeros(shape, dtype=_torch_dtype(spec.dtype),
                                  device=device))
        names.append(getattr(spec, "name", None) or f"x{i}")
    return xs, names


def _check_wellformed(nodes, initializers, inputs):
    """Every node input is produced before it is read (the checker that
    `enable_onnx_checker` asks for)."""
    from . import wire
    have = set(initializers) | set(inputs)
    for n in nodes:
        d = wire.decode(n)
        for i in d.get(1, []):
            if i and i.decode() not in have:
                raise UnsupportedOnnxExport(
                    f"node {d[4][0].decode()} reads undefined {i.decode()}")
        have.update(o.decode() for o in d.get(2, []))


def trace(layer, input_spec):
    """The decomposed `torch.export` program of `layer` in eval mode at
    the specs' shapes, on the layer's device, and the input names."""
    p0 = next(iter(layer.parameters()), None)
    if p0 is None:
        p0 = next(iter(layer.buffers()), None)
    device = p0.device if p0 is not None else torch.device("cpu")
    xs, names = _example_inputs(input_spec, device)
    was_training = layer.training
    layer.eval()
    try:
        with torch.no_grad():
            ep = torch.export.export(layer, tuple(xs))
    finally:
        layer.train(was_training)
    return ep.run_decompositions(_decompositions()), names


def export(layer, path, input_spec=None, opset_version=13,
           enable_onnx_checker=True, **configs):
    """Trace `layer` (eval mode, on its own device) and write
    `{path}.onnx`; returns the written file's path (see the module
    docstring). The call surface of the reference's paddle2onnx
    delegation and of the JAX package's `paddle_tpu.onnx.export`."""
    if not isinstance(layer, torch.nn.Module):
        raise TypeError("paddle.onnx.export expects an nn.Layer")
    if input_spec is None:
        raise ValueError("paddle.onnx.export requires input_spec")
    if opset_version < 13:
        # the emitted op forms (axes-as-input ReduceSum/Slice/Pad/Split)
        # need opset 13; stamping a lower version would be an invalid model
        warnings.warn(f"opset_version={opset_version} unsupported; "
                      "emitting opset 13")
        opset_version = 13
    ep, in_names = trace(layer, input_spec)
    return write(ep, in_names, path, opset_version, enable_onnx_checker)


def write(ep, in_names, path, opset_version=13, enable_onnx_checker=True):
    """Write the decomposed program `ep` (from `trace`) as
    `{path}.onnx`, its user inputs named `in_names`; returns the path."""
    conv = TorchToOnnx()
    sig = ep.graph_signature
    kinds = {s.arg.name: s for s in sig.input_specs}
    state = dict(ep.state_dict)
    inputs, user = [], iter(in_names)
    for node in ep.graph.nodes:
        if node.op != "placeholder":
            continue
        spec = kinds[node.name]
        kind = spec.kind.name
        if kind in ("PARAMETER", "BUFFER"):
            t = state[spec.target] if spec.target in state else \
                ep.constants[spec.target]
            conv.add_initializer(t, name=spec.target)
            conv.weights.add(spec.target)
            conv.env[node] = spec.target
        elif kind == "CONSTANT_TENSOR":
            conv.env[node] = ep.constants[spec.target].detach().cpu()
        elif kind == "USER_INPUT":
            name = next(user)
            m = _meta(node)
            conv.env[node] = name
            conv.dtypes[name] = _dt(m.dtype)
            inputs.append(proto.value_info(name, tuple(m.shape),
                                           _np_dtype(m.dtype)))
        else:
            raise UnsupportedOnnxExport(f"program input of kind {kind}")
    conv.run(ep)
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    leaves = [x for x in torch.utils._pytree.tree_leaves(out_node.args[0])
              if isinstance(x, torch.fx.Node)]
    outputs, out_names, taken = [], [], set(in_names)
    for i, leaf in enumerate(leaves):
        name = conv.name_of(leaf)
        if name in conv.initializers or name in taken:
            name = conv.op("Identity", [name], conv.dtypes[name],
                           hint="output")
        taken.add(name)
        out_names.append(name)
        m = _meta(leaf)
        outputs.append(proto.value_info(name, tuple(m.shape),
                                        _np_dtype(m.dtype)))
    nodes, inits = conv.encoded_nodes(out_names)
    if enable_onnx_checker:
        _check_wellformed(nodes, conv.initializers, in_names)
    graph = proto.graph_parts(nodes, "paddle_tpu_torch_graph", inits,
                              inputs, outputs)
    out_path = path if path.endswith(".onnx") else path + ".onnx"
    with open(out_path, "wb") as f:
        f.writelines(proto.model_parts(graph, opset_version))
    return out_path
