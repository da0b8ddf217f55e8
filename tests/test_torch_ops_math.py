"""paddle_tpu_torch.ops.math held to paddle_tpu.ops.math, op by op.

Every name of `paddle_tpu.ops.math.__all__` (100: the generated unary
and binary ops, `pow`, the elementwise aliases and the 37 written out)
runs on the same numpy-seeded float32 inputs, drawn inside each op's
domain, through both packages: the output's dtype is the JAX package's
and its values agree within 1e-5 x max(1, max |ref|), rtol 1e-5 (both
compute in float32; the special functions, erfinv, digamma, lgamma,
i0/i1, gammainc and the cumulative log-sum-exp, are other algorithms
in the two libraries, held to 1e-4).

The dtype rules, on int32 inputs in both packages (the JAX package runs
with 64-bit types off): arithmetic keeps int32, `divide`, `exp` and
`sqrt` give float32, `cumsum` and `trace` keep int32; and on bfloat16
inputs, elementwise ops keep bfloat16.

The AMP cast by op name, under O1 in bfloat16: the generated ops take
their AMP name from their own `name=` argument (None by default, so
`exp` of a bfloat16 input stays bfloat16 in both packages; `exp(x,
name="exp")` is cast up to float32, the black list); `cumsum`, which
names itself, is cast up; `scale` is in no list and keeps its type.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.ops.math as jm
from paddle_tpu_torch import amp as tamp
import paddle_tpu_torch as tpkg
import paddle_tpu_torch.ops.math as tm

TOL = 1e-5
SPECIAL_TOL = 1e-4
SPECIAL = {"erfinv", "digamma", "lgamma", "i0", "i0e", "i1", "i1e",
           "gammaln", "gammainc", "logcumsumexp"}


def _r(seed, *shape, lo=None, hi=None):
    rng = np.random.RandomState(seed)
    if lo is None:
        return rng.standard_normal(shape).astype("float32")
    return rng.uniform(lo, hi, shape).astype("float32")


def _away(seed, *shape):
    """Magnitudes in [0.5, 2), random signs: clear of 0."""
    rng = np.random.RandomState(seed)
    return (rng.uniform(0.5, 2.0, shape)
            * rng.choice([-1.0, 1.0], shape)).astype("float32")


X = _r(0, 3, 4)
Y = _r(1, 3, 4)
POS = _r(2, 3, 4, lo=0.1, hi=3.0)
UNIT = _r(3, 3, 4, lo=-0.9, hi=0.9)
PROB = _r(4, 3, 4, lo=0.05, hi=0.95)
CPLX = (_r(5, 3, 4) + 1j * _r(6, 3, 4)).astype("complex64")
SPECIALS = np.array([[1.0, np.nan, np.inf, -np.inf],
                     [-2.0, 0.5, np.nan, 3.0]], "float32")

UNARY_DOMAIN = {"log": POS, "log2": POS, "log10": POS, "log1p": POS,
                "sqrt": POS, "rsqrt": POS, "asin": UNIT, "acos": UNIT,
                "atanh": UNIT, "erfinv": UNIT, "acosh": POS + 1.0,
                "reciprocal": _away(7, 3, 4), "digamma": POS,
                "lgamma": POS}

# name -> (args, kwargs): numpy arrays become each package's tensors
CASES = {n: ((UNARY_DOMAIN.get(n, X),), {}) for n in (
    "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt", "rsqrt",
    "square", "abs", "neg", "sign", "floor", "ceil", "round", "trunc",
    "frac", "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
    "tanh", "asinh", "acosh", "atanh", "reciprocal", "erf", "erfinv",
    "sigmoid", "digamma", "lgamma", "angle", "conj", "real", "imag",
    "sgn", "sinc", "i0", "i0e", "i1", "i1e", "gammaln", "frexp",
    "isnan", "isinf", "isfinite", "stanh")}
CASES.update({n: ((X, Y), {}) for n in (
    "add", "subtract", "multiply", "maximum", "minimum", "fmax", "fmin",
    "atan2", "logaddexp", "heaviside", "hypot", "nextafter",
    "elementwise_add", "elementwise_mul", "elementwise_sub")})
CASES.update({
    "divide": ((X, _away(8, 3, 4)), {}),
    "elementwise_div": ((X, _away(8, 3, 4)), {}),
    "floor_divide": ((X * 4, _away(9, 3, 4)), {}),
    "mod": ((X * 4, _away(9, 3, 4)), {}),
    "remainder": ((X * 4, _away(9, 3, 4)), {}),
    "floor_mod": ((X * 4, _away(9, 3, 4)), {}),
    "pow_": ((POS, Y), {}),
    "pow": ((POS, 1.5), {}),
    "kron": ((_r(10, 2, 3), _r(11, 3, 2)), {}),
    "outer": ((_r(10, 2, 3), _r(11, 4)), {}),
    "inner": ((_r(10, 2, 3), _r(11, 4, 3)), {}),
    "gcd": ((np.array([12, 18, -8, 0], "int32"),
             np.array([8, 27, 6, 5], "int32")), {}),
    "lcm": ((np.array([4, 6, -8, 3], "int32"),
             np.array([6, 9, 6, 5], "int32")), {}),
    "scale": ((X,), dict(scale=2.0, bias=0.5, bias_after_scale=False)),
    "clip": ((X,), dict(min=-0.5, max=0.5)),
    "lerp": ((X, Y, 0.3), {}),
    "logit": ((PROB,), dict(eps=0.1)),
    "multiplex": (([X, Y], np.array([[1], [0], [1]], "int32")), {}),
    "cumsum": ((X,), dict(axis=1)),
    "cumprod": ((X,), dict(dim=1)),
    "cummax": ((X,), dict(axis=1)),
    "nan_to_num": ((SPECIALS,), dict(nan=-7.0)),
    "addmm": ((_r(12, 3, 2), _r(13, 3, 4), _r(14, 4, 2)),
              dict(beta=0.5, alpha=2.0)),
    "trace": ((_r(15, 4, 4),), dict(offset=1)),
    "diff": ((X,), dict(n=2, axis=1)),
    "renorm": ((X,), dict(p=2.0, axis=0, max_norm=1.0)),
    "logcumsumexp": ((X,), dict(axis=1)),
    "trapezoid": ((X,), dict(dx=0.5)),
    "copysign": ((X, Y), {}),
    "ldexp": ((X, np.array([[1, -2, 3, 0]] * 3, "float32")), {}),
    "polar": ((POS, X), {}),
    "gammainc": ((POS, POS[::-1].copy()), {}),
    "nanquantile": ((SPECIALS[:, :2].copy(),), dict(q=0.5, axis=1)),
})
for _n in ("isnan", "isinf", "isfinite"):
    CASES[_n] = ((SPECIALS,), {})
# increment is in-place: its own test below
NAMES = sorted(set(jm.__all__) - {"increment"})


def _jx(a):
    return paddle.to_tensor(a) if isinstance(a, np.ndarray) else a


def _tx(a):
    return torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a


def _conv(args, f):
    return [[f(x) for x in a] if isinstance(a, list) else f(a)
            for a in args]


def _jnp(out):
    return np.asarray(out._value) if hasattr(out, "_value") else \
        np.asarray(out)


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _dtype(a):
    return np.dtype(a.dtype).name


def _compare(name, got, want, tol):
    for g, w in zip(_flat(got), _flat(want)):
        w = _jnp(w)
        g = g.float() if g.dtype == torch.bfloat16 else g
        assert str(g.dtype).replace("torch.", "") == _dtype(w) or (
            _dtype(w) == "bfloat16" and g.dtype == torch.float32), \
            (name, g.dtype, w.dtype)
        g = g.numpy()
        w = w.astype(g.dtype)
        if np.issubdtype(w.dtype, np.inexact):
            fin = np.isfinite(w)
            np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=name)
            np.testing.assert_allclose(
                g[fin], w[fin], rtol=tol,
                atol=tol * max(1.0, float(np.abs(w[fin]).max()
                                          if fin.any() else 0.0)),
                err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_names_match_and_are_reexported():
    assert list(tm.__all__) == list(jm.__all__)
    for n in tm.__all__:
        assert getattr(tpkg, n) is getattr(tm, n), n
    assert set(NAMES) | {"increment"} == set(CASES) | {"increment"}


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_jax(name):
    args, kw = CASES[name]
    want = getattr(jm, name)(*_conv(args, _jx), **kw)
    got = getattr(tm, name)(*_conv(args, _tx), **kw)
    _compare(name, got, want, SPECIAL_TOL if name in SPECIAL else TOL)


@pytest.mark.parametrize("name", ["angle", "conj", "real", "imag", "sgn",
                                  "abs", "exp"])
def test_complex_input(name):
    want = getattr(jm, name)(paddle.to_tensor(CPLX))
    got = getattr(tm, name)(torch.from_numpy(CPLX.copy()))
    w = _jnp(want)
    assert str(got.dtype).replace("torch.", "") == _dtype(w)
    np.testing.assert_allclose(got.numpy(), w, rtol=TOL, atol=TOL)


def test_increment_in_place():
    jx, tx = paddle.to_tensor(X.copy()), torch.from_numpy(X.copy())
    jr = jm.increment(jx, 2.5)
    tr = tm.increment(tx, 2.5)
    assert tr is tx
    np.testing.assert_allclose(tx.numpy(), _jnp(jr), rtol=TOL)
    np.testing.assert_allclose(tx.numpy(), _jnp(jx), rtol=TOL)


INT_A = np.array([[7, -3, 4], [2, 9, -6]], "int32")
INT_B = np.array([[2, 5, -3], [4, -2, 3]], "int32")


@pytest.mark.parametrize("name,args,kw", [
    ("add", (INT_A, INT_B), {}), ("multiply", (INT_A, INT_B), {}),
    ("subtract", (INT_A, INT_B), {}), ("maximum", (INT_A, INT_B), {}),
    ("floor_divide", (INT_A, INT_B), {}), ("mod", (INT_A, INT_B), {}),
    ("divide", (INT_A, INT_B), {}), ("add", (INT_A, 2.5), {}),
    ("exp", (INT_A,), {}), ("sqrt", (np.abs(INT_A),), {}),
    ("square", (INT_A,), {}), ("abs", (INT_A,), {}),
    ("cumsum", (INT_A,), dict(axis=1)), ("cumsum", (INT_A,), {}),
    ("cumprod", (INT_A,), dict(dim=0)),
    ("trace", (np.arange(9, dtype="int32").reshape(3, 3),), {}),
])
def test_int32_dtype_rules(name, args, kw):
    want = getattr(jm, name)(*_conv(args, _jx), **kw)
    got = getattr(tm, name)(*_conv(args, _tx), **kw)
    _compare(name, got, want, TOL)


BF16_OPS = ("tanh", "exp", "sigmoid", "add", "multiply", "maximum",
            "scale", "clip", "sqrt")


@pytest.mark.parametrize("name", BF16_OPS)
def test_bfloat16_keeps_type(name):
    args, kw = CASES[name]

    def jconv(a):
        return paddle.to_tensor(a).astype("bfloat16") \
            if isinstance(a, np.ndarray) else a

    def tconv(a):
        return torch.from_numpy(a.copy()).to(torch.bfloat16) \
            if isinstance(a, np.ndarray) else a
    want = getattr(jm, name)(*_conv(args, jconv), **kw)
    got = getattr(tm, name)(*_conv(args, tconv), **kw)
    assert _dtype(_jnp(want)) == "bfloat16"
    assert got.dtype == torch.bfloat16
    w = _jnp(want).astype("float32")
    np.testing.assert_allclose(got.float().numpy(), w, rtol=2e-2,
                               atol=2e-2 * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("name,kw,dtype_want", [
    ("exp", {}, "bfloat16"),               # name None: in no list
    ("exp", dict(name="exp"), "float32"),  # the black list casts up
    ("log", dict(name="log"), "float32"),
    ("cumsum", dict(axis=1), "float32"),   # names itself: black list
    ("scale", dict(scale=2.0), "bfloat16"),  # in no list
    ("tanh", {}, "bfloat16"),
])
def test_amp_cast_by_op_name(name, kw, dtype_want):
    x = POS
    with jamp.auto_cast(dtype="bfloat16"):
        want = getattr(jm, name)(paddle.to_tensor(x).astype("bfloat16"),
                                 **kw)
    with tamp.auto_cast(dtype="bfloat16"):
        got = getattr(tm, name)(torch.from_numpy(x.copy()).to(
            torch.bfloat16), **kw)
    assert _dtype(_jnp(want)) == dtype_want
    assert str(got.dtype).replace("torch.", "") == dtype_want
    w = _jnp(want).astype("float32")
    np.testing.assert_allclose(got.float().numpy(), w, rtol=2e-2,
                               atol=2e-2 * max(1.0, float(np.abs(w).max())))
