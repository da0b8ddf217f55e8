"""Math ops (port of `paddle_tpu.ops.math`; reference
`python/paddle/tensor/math.py`). Plain functions on tensors: PyTorch's
elementwise kernels do the work, as XLA's fused elementwise HLO does in
the JAX package. No TPU kernel lies here.

AMP casts by op name through `amp.cast_args`, where the JAX package's
`apply_op` would. The names are the JAX package's, quirks included:

- the generated unary and binary ops (`exp`, `log`, `tanh`, `add`, ...)
  hand `apply_op` their own `name=` argument, which is None unless the
  caller passes one, so under AMP `exp(x)` is not cast up to float32
  (`exp` and `log` are on the black list) unless called as
  `exp(x, name="exp")`;
- the other ops use their literal names ("pow", "cumsum", ...), so
  `cumsum` casts a 16-bit input up to float32 under AMP.

Types follow jnp's rules where PyTorch's differ: `cumsum`, `cumprod` and
`trace` keep an integer input's type (PyTorch widens to int64); `imag`
of a real tensor is zeros (PyTorch raises); `outer` flattens its
operands. The port's default integer type is int64 where the JAX
package's is int32 (64-bit mode off); the tests feed both int32.
`diff` ignores `prepend` / `append`, as the JAX package does.
"""
from __future__ import annotations

import torch

from .. import amp

__all__ = []


def _t(x):
    """x as a tensor: a Python number or array becomes one, in PyTorch's
    default types."""
    return x if torch.is_tensor(x) else torch.as_tensor(x)


def _unary(opname, fn):
    def op(x, name=None):
        (x,) = amp.cast_args(name, _t(x))
        return fn(x)
    op.__name__ = op.__qualname__ = opname
    globals()[opname] = op
    __all__.append(opname)
    return op


def _binary(opname, fn):
    def op(x, y, name=None):
        if not torch.is_tensor(x) and not torch.is_tensor(y):
            x = _t(x)
        x, y = amp.cast_args(name, x, y)
        return fn(x, y)
    op.__name__ = op.__qualname__ = opname
    globals()[opname] = op
    __all__.append(opname)
    return op


def _imag(v):
    return torch.imag(v) if v.is_complex() else torch.zeros_like(v)


_unary("exp", torch.exp)
_unary("expm1", torch.expm1)
_unary("log", torch.log)
_unary("log2", torch.log2)
_unary("log10", torch.log10)
_unary("log1p", torch.log1p)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("square", torch.square)
_unary("abs", torch.abs)
_unary("neg", torch.neg)
_unary("sign", torch.sign)
_unary("floor", torch.floor)
_unary("ceil", torch.ceil)
_unary("round", torch.round)
_unary("trunc", torch.trunc)
_unary("frac", lambda v: v - torch.trunc(v))
_unary("sin", torch.sin)
_unary("cos", torch.cos)
_unary("tan", torch.tan)
_unary("asin", torch.asin)
_unary("acos", torch.acos)
_unary("atan", torch.atan)
_unary("sinh", torch.sinh)
_unary("cosh", torch.cosh)
_unary("tanh", torch.tanh)
_unary("asinh", torch.asinh)
_unary("acosh", torch.acosh)
_unary("atanh", torch.atanh)
_unary("reciprocal", torch.reciprocal)
_unary("erf", torch.erf)
_unary("erfinv", torch.erfinv)
_unary("sigmoid", torch.sigmoid)
_unary("digamma", torch.digamma)
_unary("lgamma", torch.lgamma)
_unary("angle", torch.angle)
_unary("conj", torch.conj_physical)
_unary("real", torch.real)
_unary("imag", _imag)

_binary("add", torch.add)
_binary("subtract", torch.subtract)
_binary("multiply", torch.multiply)
_binary("divide", torch.divide)
_binary("floor_divide", torch.floor_divide)
_binary("mod", torch.remainder)
_binary("remainder", torch.remainder)
_binary("floor_mod", torch.remainder)
_binary("pow_", torch.pow)
_binary("maximum", torch.maximum)
_binary("minimum", torch.minimum)
_binary("fmax", torch.fmax)
_binary("fmin", torch.fmin)
_binary("atan2", torch.atan2)
_binary("logaddexp", torch.logaddexp)
_binary("heaviside", torch.heaviside)
_binary("kron", torch.kron)
_binary("outer", lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)))
_binary("inner", torch.inner)
_binary("gcd", torch.gcd)
_binary("lcm", torch.lcm)


def pow(x, y, name=None):
    x, y = amp.cast_args("pow", _t(x), y)
    return torch.pow(x, y)


__all__.append("pow")


def _fluid_axis(x, y, axis):
    """fluid's elementwise broadcast: a `y` of lower rank lines up with
    `x`'s dims from `axis` (-1: numpy's trailing alignment)."""
    if axis != -1 and torch.is_tensor(x) and torch.is_tensor(y) \
            and y.dim() < x.dim():
        shape = [1] * x.dim()
        shape[axis:axis + y.dim()] = y.shape
        y = y.reshape(shape)
    return x, y


def _fluid_act(out, act):
    if act is None:
        return out
    from ..nn import functional as F
    return getattr(F, act)(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    """fluid's elementwise_add (`ops.legacy` and the top level re-export
    it): `axis` and `act` as the JAX package's `legacy` takes them."""
    return _fluid_act(add(*_fluid_axis(x, y, axis)), act)  # noqa: F821


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _fluid_act(multiply(*_fluid_axis(x, y, axis)),  # noqa: F821
                      act)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _fluid_act(subtract(*_fluid_axis(x, y, axis)),  # noqa: F821
                      act)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _fluid_act(divide(*_fluid_axis(x, y, axis)), act)  # noqa: F821


__all__ += ["elementwise_add", "elementwise_mul", "elementwise_sub",
            "elementwise_div"]


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """reference `operators/scale_op.cc`; `act` is accepted and unused, as
    in the JAX package."""
    (v,) = amp.cast_args("scale", _t(x))
    return v * scale + bias if bias_after_scale else (v + bias) * scale


def clip(x, min=None, max=None, name=None):
    (v,) = amp.cast_args("clip", _t(x))
    if min is None and max is None:
        return v.clone()
    return torch.clamp(v, min, max)


def lerp(x, y, weight, name=None):
    if torch.is_tensor(weight):
        a, b, w = amp.cast_args("lerp", _t(x), y, weight)
    else:
        (a, b), w = amp.cast_args("lerp", _t(x), y), weight
    return a + w * (b - a)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    (v,) = amp.cast_args("stanh", _t(x))
    return scale_b * torch.tanh(scale_a * v)


def logit(x, eps=None, name=None):
    (v,) = amp.cast_args("logit", _t(x))
    u = v if eps is None else torch.clamp(v, eps, 1 - eps)
    return torch.log(u / (1 - u))


def multiplex(inputs, index, name=None):
    """Row i of the output is row i of inputs[index[i]]."""
    *xs, idx = amp.cast_args("multiplex", *inputs, index)
    stacked = torch.stack(xs, 0)
    idx = idx.reshape(1, -1, *([1] * (stacked.dim() - 2))).long()
    return torch.gather(stacked, 0,
                        idx.expand(1, *stacked.shape[1:]))[0]


def _cum(fn, v, axis, dtype):
    """jnp's cumulative-op rules: axis None runs over the flattened
    tensor; an integer input keeps its type unless `dtype` says."""
    if axis is None:
        v, axis = v.reshape(-1), 0
    if dtype is not None:
        dt = amp._torch_dtype(dtype)
    elif not v.is_floating_point() and not v.is_complex():
        dt = v.dtype
    else:
        dt = None
    return fn(v, axis, dtype=dt)


def cumsum(x, axis=None, dtype=None, name=None):
    (v,) = amp.cast_args("cumsum", _t(x))
    return _cum(torch.cumsum, v, axis, dtype)


def cumprod(x, dim=None, dtype=None, name=None):
    (v,) = amp.cast_args("cumprod", _t(x))
    return _cum(torch.cumprod, v, dim, dtype)


def cummax(x, axis=None, dtype="int64", name=None):
    """The running maximum (values only, as in the JAX package)."""
    (v,) = amp.cast_args("cummax", _t(x))
    if axis is None:
        v, axis = v.reshape(-1), 0
    return torch.cummax(v, axis).values


def isnan(x, name=None):
    (v,) = amp.cast_args("isnan", _t(x))
    return torch.isnan(v)


def isinf(x, name=None):
    (v,) = amp.cast_args("isinf", _t(x))
    return torch.isinf(v)


def isfinite(x, name=None):
    (v,) = amp.cast_args("isfinite", _t(x))
    return torch.isfinite(v)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    (v,) = amp.cast_args("nan_to_num", _t(x))
    return torch.nan_to_num(v, nan=nan, posinf=posinf, neginf=neginf)


def increment(x, value=1.0, name=None):
    """x += value in place (x keeps its type); returns x."""
    (v,) = amp.cast_args("increment", x)
    with torch.no_grad():
        x.copy_(v + value)
    return x


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    i, a, b = amp.cast_args("addmm", input, x, y)
    return beta * i + alpha * torch.matmul(a, b)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    (v,) = amp.cast_args("trace", _t(x))
    out = torch.diagonal(v, offset, axis1, axis2).sum(-1)
    return out if v.is_floating_point() or v.is_complex() \
        else out.to(v.dtype)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    """n-th forward difference along `axis`; `prepend` and `append` are
    accepted and ignored, as in the JAX package."""
    (v,) = amp.cast_args("diff", _t(x))
    return torch.diff(v, n=n, dim=axis)


__all__ += ["scale", "clip", "lerp", "stanh", "logit", "multiplex", "cumsum",
            "cumprod", "cummax", "isnan", "isinf", "isfinite", "nan_to_num",
            "increment", "addmm", "trace", "diff"]


def renorm(x, p, axis, max_norm, name=None):
    """Per-slice p-norm clamp along `axis` (reference
    `operators/renorm_op.cc`): slices whose p-norm exceeds max_norm are
    rescaled to max_norm."""
    (v,) = amp.cast_args("renorm", _t(x))
    ax = axis if axis >= 0 else v.dim() + axis
    red = tuple(i for i in range(v.dim()) if i != ax)
    norms = torch.sum(torch.abs(v) ** p, dim=red, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones((), dtype=norms.dtype,
                                    device=norms.device))
    return v * factor


def logcumsumexp(x, axis=None, dtype=None, name=None):
    """Cumulative log-sum-exp along `axis` (the flattened tensor when
    None)."""
    (v,) = amp.cast_args("logcumsumexp", _t(x))
    if dtype is not None:
        v = v.to(amp._torch_dtype(dtype))
    if axis is None:
        v, axis = v.reshape(-1), 0
    return torch.logcumsumexp(v, axis)


__all__ += ["renorm", "logcumsumexp"]


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    """reference `paddle.trapezoid` (the trapezoidal rule)."""
    if x is not None:
        yv, xv = amp.cast_args("trapezoid", _t(y), x)
        return torch.trapezoid(yv, xv, dim=axis)
    (yv,) = amp.cast_args("trapezoid", _t(y))
    return torch.trapezoid(yv, dx=1.0 if dx is None else dx, dim=axis)


def hypot(x, y, name=None):
    a, b = amp.cast_args("hypot", _t(x), _t(y))
    return torch.hypot(a, b)


def copysign(x, y, name=None):
    if not torch.is_tensor(y):
        y = torch.as_tensor(y, dtype=torch.float32)
    a, b = amp.cast_args("copysign", _t(x), y)
    return torch.copysign(a, b)


def ldexp(x, y, name=None):
    a, b = amp.cast_args("ldexp", _t(x), _t(y))
    return a * torch.pow(2.0, b.to(a.dtype))


def polar(abs, angle, name=None):
    r, t = amp.cast_args("polar", _t(abs), _t(angle))
    return torch.complex(r * torch.cos(t), r * torch.sin(t)).to(
        torch.complex64)


def sgn(x, name=None):
    (v,) = amp.cast_args("sgn", _t(x))
    return torch.sgn(v)


def sinc(x, name=None):
    (v,) = amp.cast_args("sinc", _t(x))
    return torch.sinc(v)


def i0(x, name=None):
    (v,) = amp.cast_args("i0", _t(x))
    return torch.special.i0(v)


def i0e(x, name=None):
    (v,) = amp.cast_args("i0e", _t(x))
    return torch.special.i0e(v)


def i1(x, name=None):
    (v,) = amp.cast_args("i1", _t(x))
    return torch.special.i1(v)


def i1e(x, name=None):
    (v,) = amp.cast_args("i1e", _t(x))
    return torch.special.i1e(v)


def gammaln(x, name=None):
    (v,) = amp.cast_args("gammaln", _t(x))
    return torch.lgamma(v)


def gammainc(x, y, name=None):
    """The regularized lower incomplete gamma function P(x, y)."""
    a, b = amp.cast_args("gammainc", _t(x), _t(y))
    return torch.special.gammainc(a, b)


def nextafter(x, y, name=None):
    a, b = amp.cast_args("nextafter", _t(x), _t(y))
    return torch.nextafter(a, b)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    """Quantiles ignoring NaNs, linear interpolation (jnp's default); a
    list of q gives a leading axis of quantiles."""
    (v,) = amp.cast_args("nanquantile", _t(x))
    qt = torch.as_tensor(q, dtype=v.dtype, device=v.device)
    return torch.nanquantile(v, qt, dim=axis, keepdim=keepdim)


def frexp(x, name=None):
    """(mantissa, int32 exponent) with x = mantissa * 2 ** exponent."""
    (v,) = amp.cast_args("frexp", _t(x))
    m, e = torch.frexp(v)
    return m, e.to(torch.int32)


__all__ += ["trapezoid", "hypot", "copysign", "ldexp", "polar", "sgn",
            "sinc", "i0", "i0e", "i1", "i1e", "gammaln", "gammainc",
            "nextafter", "nanquantile", "frexp"]
