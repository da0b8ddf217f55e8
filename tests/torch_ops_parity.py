"""Shared by the tests/test_torch_ops_*.py files: run one op of the JAX
package and its port on the same numpy inputs and compare the outputs'
types and values.

A case is `(args, kwargs)`: numpy arrays in `args` (also inside lists)
become `paddle_tpu.to_tensor` arrays on one side and `torch.from_numpy`
tensors on the other; everything else passes as it is. The outputs are
flattened (tuples, lists) and held pairwise: the type name must be the
JAX package's, integer and bool values equal, floating values within
`tol` x max(1, max |ref|) (0 for exact)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port's default device is the card: these tests ask for the
    CPU, and leave the default as they found it."""
    before = ptt.framework.place.default_place()
    ptt.set_device("cpu")
    yield
    ptt.set_device(before)


def jx(a):
    if isinstance(a, np.ndarray):
        return paddle.to_tensor(a)
    if isinstance(a, list):
        return [jx(x) for x in a]
    return a


def tx(a):
    if isinstance(a, np.ndarray):
        return torch.from_numpy(a.copy())
    if isinstance(a, list):
        return [tx(x) for x in a]
    return a


def host(out):
    """A JAX-package or port output as numpy (bfloat16 as float32)."""
    if torch.is_tensor(out):
        t = out.detach()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    v = np.asarray(out._value if hasattr(out, "_value") else out)
    return v.astype(np.float32) if v.dtype.name == "bfloat16" else v


def type_name(out):
    if torch.is_tensor(out):
        return str(out.dtype).replace("torch.", "")
    v = out._value if hasattr(out, "_value") else np.asarray(out)
    return np.dtype(v.dtype).name


def flat(out):
    if isinstance(out, (tuple, list)):
        return [y for x in out for y in flat(x)]
    return [out]


def compare(name, got, want, tol):
    g, w = flat(got), flat(want)
    assert len(g) == len(w), (name, len(g), len(w))
    for a, b in zip(g, w):
        if isinstance(b, (bool, int, float)) and not hasattr(b, "_value"):
            assert a == b, (name, a, b)
            continue
        assert type_name(a) == type_name(b), (name, type_name(a),
                                              type_name(b))
        ha, hb = host(a), host(b)
        assert ha.shape == hb.shape, (name, ha.shape, hb.shape)
        if np.issubdtype(hb.dtype, np.inexact) and tol:
            fin = np.isfinite(hb)
            np.testing.assert_array_equal(np.isfinite(ha), fin, err_msg=name)
            scale = max(1.0, float(np.abs(hb[fin]).max()) if fin.any()
                        else 0.0)
            np.testing.assert_allclose(ha[fin], hb[fin], rtol=0,
                                       atol=tol * scale, err_msg=name)
        else:
            np.testing.assert_array_equal(ha, hb, err_msg=name)


def run_case(jmod, tmod, name, case, tol):
    """Case `name` ("op" or "op#variant") of op `op` through both."""
    args, kw = case
    fn = name.split("#")[0]
    want = getattr(jmod, fn)(*[jx(a) for a in args], **kw)
    got = getattr(tmod, fn)(*[tx(a) for a in args], **kw)
    compare(name, got, want, tol)


def r(seed, *shape, lo=None, hi=None, dtype="float32"):
    rng = np.random.RandomState(seed)
    if lo is None:
        return rng.standard_normal(shape).astype(dtype)
    return rng.uniform(lo, hi, shape).astype(dtype)


def ri(seed, *shape, lo=0, hi=10):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype("int32")


def names_of(jmod):
    """The reference module's `__all__` as a sorted set (it may list a
    name twice)."""
    return sorted(set(jmod.__all__))


# XLA's CPU backend without its costly LLVM passes: the reference
# captures here run once each, so their compile dominates
QUICK = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


class _Bare(paddle.nn.Layer):
    """A JAX-package layer with no parameters, to capture a function."""


def jax_jit_grads(fn, args, grad_pos, layer=None, seed=5):
    """The JAX side of a value-and-gradient parity under one `jax.jit`
    (one compile instead of one per eager op): out = fn(*args) through
    the JAX package's functional capture of `layer` (a bare one when
    None), and the gradients of sum(first output * w), w standard normal
    from `seed` in that output's shape, for args[grad_pos] and for the
    layer's parameters. Returns (out, [arg gradients], {name: param
    gradient}) as arrays."""
    return jax_jit_grads_many({0: (fn, args, grad_pos, layer, seed)})[0]


def jax_jit_grads_many(cases):
    """`jax_jit_grads` for several cases under one `jax.jit`, so that a
    file's cases share one compile: `cases` maps a key to (fn, args,
    grad_pos, layer, seed); the gradients are those of the sum of the
    cases' projections, which is each case's own since no two cases
    share an input or a parameter. Returns {key: (out, [arg
    gradients], {name: param gradient})}."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.framework.functional import functionalize
    keys = list(cases)
    holder = _Bare()
    for i, k in enumerate(keys):
        if cases[k][3] is not None:
            holder.add_sublayer(f"c{i}", cases[k][3])
    consts = {k: [jnp.asarray(a) if isinstance(a, np.ndarray) else a
                  for a in cases[k][1]] for k in keys}

    def forward(gargs, cargs):
        outs = {}
        for k in keys:
            fn, _, grad_pos, _, _ = cases[k]
            full = list(cargs[k])
            for p, v in zip(grad_pos, gargs[k]):
                full[p] = v
            outs[k] = fn(*full)
        return outs
    apply_fn, pv, bv = functionalize(holder, forward=forward)

    def loss(pv, gargs):
        outs, _ = apply_fn(pv, bv, jax.random.PRNGKey(0), True, gargs,
                           consts)
        total = 0.0
        for k in keys:
            first = flat(outs[k])[0]
            w = np.random.RandomState(cases[k][4]).standard_normal(
                tuple(first.shape)).astype(np.float32)
            total = total + (first * w).sum()
        return total, outs

    gargs = {k: [consts[k][p] for p in cases[k][2]] for k in keys}
    (_, outs), (gp, ga) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True), compiler_options=QUICK)(
            pv, gargs)
    res = {}
    for i, k in enumerate(keys):
        pre = f"c{i}."
        res[k] = (outs[k], list(ga[k]),
                  {n[len(pre):]: g for n, g in gp.items()
                   if n.startswith(pre)})
    return res
