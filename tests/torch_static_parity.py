"""Shared by the tests/test_torch_static*.py files: build the same
static Program in the JAX package and in the port, carry the JAX
Program's parameter values into the port's scope, and run both.

Parameters are matched in the order the two Programs first read them
(the recorders record the same named ops in the same order); a weight
the port's `nn.Linear` holds as [out, in] (its recorded `linear` op says
`weight_layout="out_in"`) takes the transpose of the JAX package's
[in, out]."""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu import static as jst
from paddle_tpu_torch import static as tst


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port's default device is the card: these tests ask for the
    CPU, and leave the default as they found it (static mode off)."""
    before = T.framework.place.default_place()
    T.set_device("cpu")
    yield
    J.disable_static()
    T.disable_static()
    T.set_device(before)


@contextlib.contextmanager
def static_both():
    J.enable_static()
    T.enable_static()
    try:
        yield
    finally:
        J.disable_static()
        T.disable_static()


def port_exe():
    return tst.Executor(T.CPUPlace())


def _out_in_slots(prog):
    return {op.in_refs[1][1] for op in prog.ops
            if op.name == "linear" and op.attrs.get("weight_layout")
            == "out_in"}


def copy_scope(jprog, tprog, jscope=None, tscope=None):
    """The JAX Program's parameters into the port Program's scope, in
    order of first use; returns the matched name pairs."""
    jscope = jst.global_scope() if jscope is None else jscope
    tscope = tst.global_scope() if tscope is None else tscope
    jn, tn = list(jprog.param_vars), list(tprog.param_vars)
    assert len(jn) == len(tn), (jn, tn)
    flip = _out_in_slots(tprog)
    for a, b in zip(jn, tn):
        v = np.asarray(jscope[a])
        if tprog.param_vars[b].slot in flip:
            v = v.T
        t = tscope[b]
        assert tuple(t.shape) == v.shape, (a, b, v.shape, tuple(t.shape))
        tscope[b] = torch.from_numpy(np.ascontiguousarray(v)).to(t.dtype)
    return list(zip(jn, tn))


def unique_jax_param_names(layer):
    """Name the JAX layer's parameters by their structure: the JAX
    Program keys parameters by name, and the copies its
    `TransformerEncoder` deep-copies keep their first layer's names, so
    they would collide (ROADMAP C29)."""
    for n, p in layer.named_parameters():
        p.name = n


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (err, tol * scale)
