"""Random ops (port of `paddle_tpu.ops.random_ops`; reference
`python/paddle/tensor/random.py`, `operators/gaussian_random_op` etc.).

Each draws from torch's default generator of the device it makes its
tensor on, which `framework.random.seed` (`paddle.seed`) seeds and
`get_rng_state` / `set_rng_state` snapshot and restore. A function that
makes a tensor from a shape makes it on the default device (`set_device`;
the CUDA card unless the caller chose another); the others on their
input's device. `uniform(seed=s)` with s != 0 draws from a generator of
its own seeded with s, as the JAX package draws from PRNGKey(s). Bits
differ from the JAX package's (another generator); shapes, types and
ranges are its: no `dtype` gives the default float type, integer
outputs are int32."""
from __future__ import annotations

import torch

from ..framework.dtype import canonical_dtype, default_float_dtype
from ..framework.place import resolve_device
from ._util import ints, named

__all__ = ["rand", "randn", "randint", "randint_like", "uniform", "normal",
           "standard_normal", "bernoulli", "multinomial", "randperm",
           "poisson", "uniform_", "normal_", "shuffle"]


def _dt(dtype):
    return canonical_dtype(default_float_dtype() if dtype is None
                           else dtype)


def rand(shape, dtype=None, name=None):
    return torch.rand(ints(shape), dtype=_dt(dtype),
                      device=resolve_device())


def randn(shape, dtype=None, name=None):
    return torch.randn(ints(shape), dtype=_dt(dtype),
                       device=resolve_device())


standard_normal = randn


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    return torch.randint(low, high, ints(shape), dtype=canonical_dtype(dtype),
                         device=resolve_device())


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dt = x.dtype if dtype is None else canonical_dtype(dtype)
    return torch.randint(low, high, tuple(x.shape), dtype=dt,
                         device=x.device)


def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0, name=None):
    dev = resolve_device()
    gen = torch.Generator(device=dev).manual_seed(int(seed)) if seed \
        else None
    out = torch.empty(ints(shape), dtype=_dt(dtype), device=dev)
    return out.uniform_(min, max, generator=gen)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """mean + std * N(0, 1): of the broadcast shape of a tensor `mean` /
    `std`, else of `shape` (a scalar when None), float32."""
    if torch.is_tensor(mean) or torch.is_tensor(std):
        ref = mean if torch.is_tensor(mean) else std
        m = torch.as_tensor(mean, device=ref.device)
        s = torch.as_tensor(std, device=ref.device)
        shp = torch.broadcast_shapes(m.shape, s.shape)
        z = torch.randn(shp, dtype=torch.float32, device=ref.device)
        return m + s * z
    shp = ints(shape) if shape is not None else ()
    return mean + std * torch.randn(shp, dtype=torch.float32,
                                    device=resolve_device())


def bernoulli(x, name=None):
    (v,) = named("bernoulli", x)
    return torch.bernoulli(v)


def poisson(x, name=None):
    (v,) = named("poisson", x)
    return torch.poisson(v)


def multinomial(x, num_samples=1, replacement=False, name=None):
    """Category ids drawn by the probabilities of `x`'s last axis."""
    (v,) = named("multinomial", x)
    return torch.multinomial(v, num_samples, replacement).to(torch.int32)


def randperm(n, dtype="int64", name=None):
    return torch.randperm(n, device=resolve_device()).to(
        canonical_dtype(dtype))


def shuffle(x, axis=0, name=None):
    """`x` with its slices along `axis` in a random order."""
    (v,) = named("shuffle", x)
    return torch.index_select(v, axis, torch.randperm(v.shape[axis],
                                                      device=v.device))


def uniform_(x, min=-1.0, max=1.0, name=None):
    with torch.no_grad():
        return x.uniform_(min, max)


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        return x.normal_(mean, std)
