"""The top-level API of paddle_tpu_torch held to paddle_tpu's.

- Places: the default device is the CUDA card, so with no card an entry
  point left on it raises UnavailableError; `set_device("cpu")` and
  `place=CPUPlace()` ask for the CPU; `set_device("tpu")` raises; the
  default is thread-local.
- Generators: after `set_rng_state(get_rng_state())` a random op and a
  flash kernel's dropout seed replay; `rng_scope` restores the state.
- `paddle.Model` is hapi's; the dtype names, `ParamAttr` (accepted by the
  layers that take `weight_attr`) and `device`.
- `test_tensor_methods`: every entry of `ops.tensor_methods.METHODS`
  (each of the reference's Tensor method names) run on a torch tensor
  against the reference's Tensor method on the same call, the values
  within 1e-5 x max(1, max |ref|) and the types equal; in-place ones
  compare the tensor they changed too.
- `test_top_level_names_still_missing`: the reference's public top-level
  names the port lacks are the four it lacks by design
  (`test_torch_public_names.py` holds every other module).
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework import random as frandom
from paddle_tpu_torch.framework.errors import UnavailableError
from paddle_tpu_torch.ops import tensor_methods as tmeth
from torch_ops_parity import (compare, jx, on_the_cpu,  # noqa: F401
                              r, ri, tx)

# the reference's public top-level names the port has no counterpart for,
# by design: the JAX package's own Tensor / Parameter / VarBase classes
# (the port's tensors are torch.Tensor) and `annotations`, the
# reference's `from __future__ import annotations`
STILL_MISSING = sorted("Parameter Tensor VarBase annotations".split())


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_top_level_names_still_missing():
    assert sorted(_public(paddle) - _public(ptt)) == STILL_MISSING


# the public names of the reference's nn, nn.functional, nn.utils and
# optimizer that the port lacks, each with its reason
NN_STILL_MISSING = {
    # the port does not wrap torch.Tensor: a parameter is a
    # torch.nn.Parameter, made by nn.Layer.create_parameter (ROADMAP A)
    "nn": ["Parameter"],
    "nn.functional": [],
    "nn.utils": [],
    "optimizer": [],
}


@pytest.mark.parametrize("mod", sorted(NN_STILL_MISSING))
def test_nn_names_still_missing(mod):
    import importlib
    ref = importlib.import_module(f"paddle_tpu.{mod}")
    port = importlib.import_module(f"paddle_tpu_torch.{mod}")
    names = set(ref.__all__) if hasattr(ref, "__all__") else _public(ref)
    assert sorted(names - _public(port)) == NN_STILL_MISSING[mod]


def test_reexports_are_the_modules_functions():
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.framework import io_state
    assert ptt.Model is hapi.Model
    assert ptt.concat is ptt.manipulation.concat
    assert ptt.random is ptt.ops.random_ops
    assert ptt.save is io_state.save and ptt.load is io_state.load
    assert ptt.int64 == torch.int64 and ptt.float32 == "float32"
    assert ptt.bfloat16 == ptt.framework.dtype.convert_dtype(torch.bfloat16)
    assert ptt.framework.dtype.convert_dtype(np.float16) is ptt.float16


def test_default_device_is_the_card_and_cpu_is_asked_for():
    assert ptt.get_device() == "cpu"        # the fixture asked for it
    t = ptt.zeros([2], dtype="float32")
    assert t.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    ptt.set_device("gpu:0")
    assert ptt.get_device() == "gpu:0"
    for fn in (lambda: ptt.zeros([2]), lambda: ptt.rand([2]),
               lambda: ptt.to_tensor([1]), lambda: ptt.framework.place
               .resolve_device(None),
               lambda: ptt.models.GPTForCausalLM(
                   ptt.models.GPTConfig.tiny())):
        with pytest.raises(UnavailableError):
            fn()
    t = ptt.to_tensor([1.0, 2.0], place=ptt.CPUPlace())
    assert t.device.type == "cpu"
    assert ptt.to_tensor([1.0], place="cpu").device.type == "cpu"
    with pytest.raises(UnavailableError):
        ptt.set_device("tpu")
    with pytest.raises(UnavailableError):
        ptt.TPUPlace(0).torch_device()


def test_default_device_is_thread_local():
    seen = []
    t = threading.Thread(target=lambda: seen.append(ptt.get_device()))
    t.start()
    t.join()
    assert ptt.get_device() == "cpu" and seen == ["gpu:0"]


def test_device_queries():
    assert ptt.device_count() == torch.cuda.device_count()
    assert ptt.is_compiled_with_tpu() is False
    assert ptt.is_compiled_with_xpu() is False
    assert isinstance(ptt.is_compiled_with_cuda(), bool)
    assert ptt.device.get_device() == "cpu"
    assert ptt.device.cuda.device_count() == ptt.device_count()
    if not torch.cuda.is_available():
        assert ptt.get_cudnn_version() is None
        assert ptt.device.cuda.memory_allocated() == 0


def test_rng_state_replays_random_ops_and_flash_seeds():
    ptt.seed(7)
    state = ptt.get_rng_state()
    a = ptt.rand([16]).numpy()
    s1 = frandom.next_seed("cpu")
    drop1 = torch.nn.functional.dropout(torch.ones(64), 0.5).numpy()
    ptt.set_rng_state(state)
    b = ptt.rand([16]).numpy()
    s2 = frandom.next_seed("cpu")
    drop2 = torch.nn.functional.dropout(torch.ones(64), 0.5).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(drop1, drop2)
    assert s1 == s2
    assert ptt.get_cuda_rng_state() == [] or torch.cuda.is_available()


def test_rng_scope_restores_the_state():
    ptt.seed(1)
    before = ptt.rand([4]).numpy()
    ptt.seed(1)
    with ptt.rng_scope(99):
        inside = ptt.rand([4]).numpy()
    after = ptt.rand([4]).numpy()
    np.testing.assert_array_equal(before, after)
    ptt.seed(99)
    np.testing.assert_array_equal(inside, ptt.rand([4]).numpy())


def test_param_attr_reaches_the_layers():
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import initializer as I
    attr = ptt.ParamAttr(initializer=I.Constant(0.5), trainable=False)
    lin = nn.Linear(3, 2, weight_attr=attr, bias_attr=ptt.ParamAttr(
        initializer=I.Constant(0.25)))
    assert torch.all(lin.weight == 0.5) and torch.all(lin.bias == 0.25)
    assert not lin.weight.requires_grad and lin.bias.requires_grad
    emb = nn.Embedding(4, 3, weight_attr=ptt.ParamAttr(
        initializer=I.Constant(1.5)))
    assert torch.all(emb.weight == 1.5)
    conv = nn.Conv2D(2, 3, 3, weight_attr=ptt.ParamAttr(
        initializer=I.Constant(0.1)))
    assert torch.all(conv.weight == 0.1)
    bn = nn.BatchNorm2D(3, weight_attr=ptt.ParamAttr(
        initializer=I.Constant(2.0)))
    assert torch.all(bn.weight == 2.0)
    assert ptt.ParamAttr._to_attr("w").name == "w"
    assert ptt.ParamAttr._to_attr(False) is False


X = r(0, 3, 4)
Y = r(1, 3, 4) + 0.1
POS = r(2, 3, 4, lo=0.2, hi=3.0)
AWAY = (r(3, 3, 4, lo=0.5, hi=2.0) * np.sign(r(4, 3, 4))).astype("float32")
SQ = (r(5, 4, 4) + 4 * np.eye(4)).astype("float32")
SPD = (SQ @ SQ.T).astype("float32")
COL = r(6, 3, 1, 4)
X3 = r(7, 2, 3, 4)
I = ri(8, 3, 4, lo=-6, hi=7)
I2 = ri(9, 3, 4, lo=1, hi=7)
B = X > 0
B2 = Y > 0.3
IDX = np.array([2, 0], "int32")
IDX2 = np.array([[1], [0], [3]], "int32")

_UNARY = {n: (X, (), {}) for n in (
    "exp", "square", "abs", "sign", "floor", "ceil", "round", "trunc",
    "sin", "cos", "tan", "tanh", "sigmoid", "erf", "isnan", "isinf",
    "isfinite", "neg", "flatten", "t", "norm", "tril_", "round_",
    "floor_", "ceil_", "abs_", "tanh_", "exp_", "zero_", "flatten_",
    "__neg__", "__abs__", "__iter__")}
_UNARY.pop("tril_")
_POS = {n: (POS, (), {}) for n in ("log", "sqrt", "rsqrt", "reciprocal",
                                   "sqrt_", "rsqrt_", "reciprocal_")}
_BIN = {n: (X, (Y,), {}) for n in (
    "add", "subtract", "multiply", "divide", "maximum", "minimum",
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "isclose", "add_", "subtract_", "multiply_",
    "__add__", "__sub__", "__mul__", "__truediv__", "__eq__", "__ne__",
    "__lt__", "__le__", "__gt__", "__ge__")}
_DIV = {n: (X * 4, (AWAY,), {}) for n in (
    "mod", "floor_divide", "remainder", "__mod__", "__floordiv__")}
_INTS = {n: (I, (I2,), {}) for n in ("bitwise_and", "bitwise_or",
                                      "bitwise_xor", "__and__", "__or__",
                                      "__xor__")}
_BOOLS = {n: (B, (B2,), {}) for n in ("logical_and", "logical_or",
                                       "logical_xor")}
CALLS = {**_UNARY, **_POS, **_BIN, **_DIV, **_INTS, **_BOOLS}
CALLS.update({
    "scale": (X, (), dict(scale=2.0, bias=1.0)),
    "clip": (X, (-0.5, 0.5), {}),
    "cumsum": (X, (), dict(axis=1)),
    "cumprod": (X, (), dict(dim=1)),
    "pow": (POS, (1.5,), {}),
    "trace": (SQ, (), dict(offset=1)),
    "lerp": (X, (Y, 0.3), {}),
    "addmm": (r(10, 3, 2), (X, r(11, 4, 2)), dict(beta=0.5, alpha=2.0)),
    "sum": (X, (), dict(axis=1)),
    "mean": (X, (), dict(axis=0, keepdim=True)),
    "max": (X, (), dict(axis=1)),
    "min": (X, (), {}),
    "prod": (X, (), dict(axis=1)),
    "all": (B, (), dict(axis=1)),
    "any": (B, (), {}),
    "logsumexp": (X, (), dict(axis=1)),
    "std": (X, (), dict(axis=1)),
    "var": (X, (), {}),
    "reshape": (X, ([4, 3],), {}),
    "transpose": (X, ([1, 0],), {}),
    "squeeze": (COL, (), dict(axis=1)),
    "unsqueeze": (X, (), dict(axis=[0])),
    "split": (X, (2,), dict(axis=1)),
    "chunk": (X, (2,), dict(axis=1)),
    "tile": (X, ([2, 1],), {}),
    "expand": (COL, ([2, 3, 5, 4],), {}),
    "expand_as": (COL, (np.zeros((3, 6, 4), "float32"),), {}),
    "broadcast_to": (COL, ([3, 2, 4],), {}),
    "gather": (X, (IDX,), {}),
    "gather_nd": (X, (np.array([[0, 1], [2, 3]], "int32"),), {}),
    "scatter": (X, (IDX, r(12, 2, 4)), {}),
    "index_select": (X, (IDX,), dict(axis=1)),
    "masked_select": (X, (B,), {}),
    "roll": (X, (1, 1), {}),
    "flip": (X, (1,), {}),
    "cast": (X, ("int32",), {}),
    "astype": (X, ("float16",), {}),
    "unbind": (X, (1,), {}),
    "repeat_interleave": (X, (2, 0), {}),
    "take_along_axis": (X, (IDX2, 1), {}),
    "put_along_axis": (X, (IDX2, 9.0, 1), {}),
    "unique": (I, (), {}),
    "nonzero": (B, (), {}),
    "diagonal": (SQ, (1,), {}),
    "masked_fill": (X, (B, -1.0), {}),
    "moveaxis": (X3, (0, 2), {}),
    "matmul": (X, (r(13, 4, 5),), {}),
    "mm": (X, (r(13, 4, 5),), {}),
    "bmm": (X3, (r(14, 2, 4, 2),), {}),
    "dot": (X, (Y,), {}),
    "dist": (X, (Y,), {}),
    "cross": (r(15, 4, 3), (r(16, 4, 3),), {}),
    "cholesky": (SPD, (), {}),
    "inverse": (SQ, (), {}),
    "det": (SQ, (), {}),
    "matrix_power": (SQ, (2,), {}),
    "mv": (X, (r(17, 4),), {}),
    "logical_not": (B, (), {}),
    "allclose": (X, (X + 1e-7,), {}),
    "equal_all": (X, (X,), {}),
    "bitwise_not": (I, (), {}),
    "argmax": (X, (), dict(axis=1)),
    "argmin": (X, (), {}),
    "argsort": (X, (), dict(axis=1)),
    "sort": (X, (), dict(axis=0)),
    "topk": (X, (2,), {}),
    "kthvalue": (X, (2,), {}),
    "tril": (SQ, (), {}),
    "triu": (SQ, (1,), {}),
    "reshape_": (X, ([4, 3],), {}),
    "squeeze_": (COL, (), dict(axis=1)),
    "unsqueeze_": (X, (), dict(axis=0)),
    "scatter_": (X, (IDX, r(12, 2, 4)), {}),
    "clip_": (X, (-0.5, 0.5), {}),
    "scale_": (X, (2.0,), {}),
    "fill_": (X, (2.5,), {}),
    "__radd__": (X, (2.0,), {}),
    "__rsub__": (X, (2.0,), {}),
    "__rmul__": (X, (3.0,), {}),
    "__rtruediv__": (AWAY, (2.0,), {}),
    "__rfloordiv__": (AWAY, (3.0,), {}),
    "__pow__": (POS, (2.0,), {}),
    "__rpow__": (X, (2.0,), {}),
    "__matmul__": (X, (r(13, 4, 5),), {}),
    "__rmatmul__": (X, (r(18, 2, 3),), {}),
    "__invert__": (I, (), {}),
    "__getitem__": (X3, ((1, slice(None, 2)),), {}),
    "__setitem__": (X, ((0, 1), 5.0), {}),
})
IN_PLACE = {n for n in CALLS if n.endswith("_") and not n.startswith("__")
            } | {"__setitem__"}


def test_every_reference_method_has_an_entry_and_a_case():
    from paddle_tpu.ops import tensor_methods as jtm
    names = {"astype", "zero_", "fill_"} | set(jtm._INPLACE)
    for _, ns in jtm._METHOD_SOURCES:
        names |= set(ns)
    assert names <= set(tmeth.METHODS), names - set(tmeth.METHODS)
    assert set(tmeth.METHODS) == set(CALLS)
    for n, entry in tmeth.METHODS.items():
        assert entry is tmeth.TORCH or callable(entry), n
        if entry is tmeth.TORCH:
            assert hasattr(torch.Tensor, n), n


def _conv(a, f):
    if isinstance(a, np.ndarray):
        return f(a)
    if isinstance(a, tuple):
        return tuple(_conv(x, f) for x in a)
    if isinstance(a, list) and any(isinstance(x, np.ndarray) for x in a):
        return [_conv(x, f) for x in a]
    return a


@pytest.mark.parametrize("name", sorted(CALLS))
def test_tensor_methods(name):
    src, args, kw = CALLS[name]
    jt = paddle.to_tensor(src)
    tt = torch.from_numpy(src.copy())
    want = getattr(jt, name)(*_conv(args, jx), **kw)
    got = tmeth.call(tt, name, *_conv(args, tx), **kw)
    if name == "__iter__":
        got, want = list(got), list(want)
    if name in IN_PLACE:
        compare(name, tt, jt, 1e-5)
        if name == "__setitem__":
            return
    compare(name, got, want, 1e-5)


def test_top_level_in_place_aliases():
    t = torch.from_numpy(X.copy())
    assert ptt.reshape_(t, [4, 3]) is t and tuple(t.shape) == (4, 3)
    assert ptt.unsqueeze_(t, 0) is t and tuple(t.shape) == (1, 4, 3)
    assert ptt.squeeze_(t, [0]) is t and tuple(t.shape) == (4, 3)
    assert ptt.flatten_(t) is t and tuple(t.shape) == (12,)
    assert ptt.scale_(t, 2.0) is t
    np.testing.assert_allclose(t.numpy(), 2 * X.reshape(-1), rtol=1e-6)
    assert ptt.tanh_(t) is t and ptt.exp_(t) is t
    assert ptt.clip_(t, 0.0, 1.5) is t and float(t.max()) <= 1.5
    assert ptt.sqrt_(t) is t
    s = torch.zeros(3, 2)
    assert ptt.scatter_(s, torch.tensor([1], dtype=torch.int32),
                        torch.ones(1, 2)) is s
    assert float(s.sum()) == 2.0
