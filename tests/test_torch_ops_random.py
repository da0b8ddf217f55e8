"""paddle_tpu_torch.ops.random_ops held to paddle_tpu.ops.random_ops, op
by op: every name of the reference module's `__all__` runs the same call
through both packages. The generators differ (torch's against JAX's
keys), so the draws are held on shape, type and range, never on bits
(ROADMAP C2), and on the port's own replay: `seed(s)` twice gives the
same draws, and so does `set_rng_state(get_rng_state())`."""
import numpy as np
import pytest
import torch

import paddle_tpu.ops.random_ops as jr
import paddle_tpu_torch as ptt
import paddle_tpu_torch.ops.random_ops as tr
from torch_ops_parity import (host, jx, names_of, on_the_cpu,  # noqa: F401
                              r, tx, type_name)

PROB = r(0, 4, 6, lo=0.05, hi=0.95)
RATE = r(1, 4, 6, lo=0.5, hi=4.0)
WEIGHTS = np.array([[0.1, 0.2, 0.3, 0.4], [0.7, 0.1, 0.1, 0.1]], "float32")


def _ranged(lo=None, hi=None, integer=False, sum_to=None):
    def check(v):
        if lo is not None:
            assert v.min() >= lo, v.min()
        if hi is not None:
            assert v.max() < hi or (not integer and v.max() <= hi), v.max()
        if integer:
            assert np.array_equal(v, np.round(v))
    return check


# name -> (args, kwargs, range check of the values)
CASES = {
    "rand": (([3, 4],), {}, _ranged(0.0, 1.0)),
    "rand#dtype": (([5],), dict(dtype="float16"), _ranged(0.0, 1.0)),
    "randn": (([64, 8],), {}, _ranged(-10, 10)),
    "standard_normal": (([16],), {}, _ranged(-10, 10)),
    "randint": ((2, 9), dict(shape=[50]), _ranged(2, 9, integer=True)),
    "randint#high_only": ((5,), dict(shape=[3, 3]),
                          _ranged(0, 5, integer=True)),
    "randint_like": ((np.zeros((4, 5), "int32"), 3, 7), {},
                     _ranged(3, 7, integer=True)),
    "uniform": (([40],), dict(min=-2.0, max=3.0), _ranged(-2.0, 3.0)),
    "uniform#seeded": (([40],), dict(min=0.0, max=1.0, seed=11),
                       _ranged(0.0, 1.0)),
    "normal": ((), dict(mean=1.0, std=0.1, shape=[200]),
               _ranged(0.0, 2.0)),
    "normal#tensor": ((np.zeros((2, 3), "float32"),
                       np.ones((2, 3), "float32")), {}, _ranged(-10, 10)),
    "bernoulli": ((PROB,), {}, _ranged(0, 1.5, integer=True)),
    "poisson": ((RATE,), {}, _ranged(0, 60, integer=True)),
    "multinomial": ((WEIGHTS,), dict(num_samples=3),
                    _ranged(0, 4, integer=True)),
    # the JAX package draws with replacement from 1-D weights only (its
    # categorical's sample shape does not broadcast over rows)
    "multinomial#replacement": ((WEIGHTS[0],), dict(num_samples=6,
                                                    replacement=True),
                                _ranged(0, 4, integer=True)),
    "randperm": ((10,), {}, _ranged(0, 10, integer=True)),
    "shuffle": ((np.arange(12, dtype="float32").reshape(6, 2),), {},
                _ranged(0, 12)),
    "uniform_": ((np.zeros((3, 4), "float32"),), dict(min=0.5, max=0.75),
                 _ranged(0.5, 0.75)),
    "normal_": ((np.zeros((50,), "float32"),), dict(mean=5.0, std=0.5),
                _ranged(2.0, 8.0)),
}


def _call(mod, conv, name, args, kw):
    fn = getattr(mod, name.split("#")[0])
    if mod is jr and name == "poisson":
        # jax.random.poisson takes threefry keys only, and the JAX
        # package's default generator is rbg: give it a threefry key
        import jax
        from paddle_tpu.framework.random import rng_scope
        with rng_scope(jax.random.key(0, impl="threefry2x32")):
            return fn(*[conv(a) for a in args], **kw)
    return fn(*[conv(a) for a in args], **kw)


def test_every_reference_name_has_a_case():
    assert names_of(jr) == sorted(tr.__all__)
    assert set(names_of(jr)) == {n.split("#")[0] for n in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_shape_type_range_and_replay(name):
    args, kw, check = CASES[name]
    want = _call(jr, jx, name, args, kw)
    got = _call(tr, tx, name, args, kw)
    assert type_name(got) == type_name(want), (type_name(got),
                                               type_name(want))
    assert tuple(got.shape) == tuple(want.shape)
    check(host(got).astype(np.float64))
    check(host(want).astype(np.float64))
    ptt.seed(3)
    a = host(_call(tr, tx, name, args, kw))
    ptt.seed(3)
    b = host(_call(tr, tx, name, args, kw))
    np.testing.assert_array_equal(a, b)
    state = ptt.get_rng_state()
    c = host(_call(tr, tx, name, args, kw))
    ptt.set_rng_state(state)
    d = host(_call(tr, tx, name, args, kw))
    np.testing.assert_array_equal(c, d)


def test_other_seeds_draw_other_values():
    ptt.seed(1)
    a = tr.rand([64]).numpy()
    ptt.seed(2)
    b = tr.rand([64]).numpy()
    assert not np.array_equal(a, b)
    u1 = tr.uniform([8], seed=5).numpy()
    u2 = tr.uniform([8], seed=5).numpy()
    np.testing.assert_array_equal(u1, u2)


def test_shuffle_permutes_rows_and_samples_are_distinct():
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    out = tr.shuffle(x)
    assert sorted(out[:, 0].tolist()) == x[:, 0].tolist()
    np.testing.assert_array_equal(out[:, 1] - out[:, 0], np.ones(6))
    s = tr.multinomial(torch.from_numpy(WEIGHTS), 4).numpy()
    assert all(len(set(row)) == 4 for row in s)
    assert sorted(tr.randperm(10).tolist()) == list(range(10))
