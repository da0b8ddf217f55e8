"""paddle_tpu_torch.distributed's collectives and mesh held to paddle_tpu's.

The port's ranks are gloo processes on the CPU (`torch_dist_ranks.py`,
one spawn a world size); the JAX side runs the JAX package's collective
inside `shard_map` over a mesh of as many of the 8 virtual CPU devices
(`tests/test_distributed.py:30`), each member fed the block its rank
holds. Integers exact, fp32 within 1e-6. Also `DistributedBatchSampler`
against the JAX sampler (no process needed: rank and replicas given).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu.distributed import collective as C
from paddle_tpu.parallel.spmd import compat_shard_map

from torch_dist_ranks import launch_ranks


def _jax(n, fn, per_rank):
    """fn(local value, n) inside shard_map over n devices; per_rank [n, ...]
    stacks each member's input. Returns [n, ...] member results."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))

    def body(v):
        with C.shard_ctx("x"):
            return fn(v[0], n)[None]
    return np.asarray(compat_shard_map(body, mesh=mesh, in_specs=P("x"),
                                       out_specs=P("x"))(
        jnp.asarray(per_rank)))


def _val(t):
    return t._value if isinstance(t, paddle.Tensor) else t


def _xs(n):
    return np.stack([np.arange(8, dtype=np.float32) + 10 * r
                     for r in range(n)])


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    wd = tmp_path_factory.mktemp("coll2")
    np.savez(wd / "in.npz", none=np.zeros(1))
    return launch_ranks("collective", 2, str(wd))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    wd = tmp_path_factory.mktemp("coll4")
    np.savez(wd / "in.npz", none=np.zeros(1))
    return launch_ranks("collective4", 4, str(wd))


def _ar(op):
    def fn(v, n):
        t = paddle.Tensor(v)
        C.all_reduce(t, op)
        return _val(t)
    return fn


def _ag(v, n):
    return _val(C.all_gather([], paddle.Tensor(v)))


def _check(ranks, key, want, exact=False):
    for r, got in enumerate(ranks):
        if exact:
            np.testing.assert_array_equal(got[key], want[r])
        else:
            np.testing.assert_allclose(got[key], want[r], rtol=0,
                                       atol=1e-6 * max(1, abs(want).max()))


@pytest.mark.parametrize("name,op", [("sum", C.ReduceOp.SUM),
                                     ("max", C.ReduceOp.MAX),
                                     ("min", C.ReduceOp.MIN),
                                     ("prod", C.ReduceOp.PROD)])
def test_all_reduce_world2(ranks2, name, op):
    xs = _xs(2) / 10 + 1 if name == "prod" else _xs(2)
    _check(ranks2, f"ar_{name}", _jax(2, _ar(op), xs))


def test_all_reduce_int_exact_world2(ranks2):
    xs = np.stack([np.arange(8, dtype=np.int32) * (r + 1) for r in range(2)])
    _check(ranks2, "ar_int", _jax(2, _ar(C.ReduceOp.SUM), xs), exact=True)


@pytest.mark.parametrize("key,fn", [
    ("ag", _ag),
    ("bc", lambda v, n: _val(C.broadcast(paddle.Tensor(v), src=1))),
    ("red", lambda v, n: _val(C.reduce(paddle.Tensor(v), dst=0))),
])
def test_gather_broadcast_reduce_world2(ranks2, key, fn):
    _check(ranks2, key, _jax(2, fn, _xs(2)))


def test_scatter_reduce_scatter_alltoall_send_world2(ranks2):
    def sc(v, n):
        t = paddle.Tensor(jnp.zeros(4))
        parts = [paddle.Tensor(jnp.arange(4.0) + 100 * i) for i in range(n)]
        return _val(C.scatter(t, parts, src=0))

    def rs(v, n):
        t = paddle.Tensor(jnp.zeros(8 // n))
        parts = [paddle.Tensor(c) for c in jnp.split(v, n)]
        return _val(C.reduce_scatter(t, parts))

    def a2a(v, n):
        return _val(C.alltoall([paddle.Tensor(x) for x in
                                v.reshape(n, 8 // n)]))

    def send(v, n):
        return _val(C.send(paddle.Tensor(v), dst=1))
    xs = _xs(2)
    _check(ranks2, "sc", _jax(2, sc, xs))
    _check(ranks2, "rs", _jax(2, rs, xs))
    _check(ranks2, "a2a", _jax(2, a2a, xs))
    # the JAX send shifts the ring: member 1 receives member 0's value
    np.testing.assert_array_equal(ranks2[1]["p2p"], _jax(2, send, xs)[1])
    np.testing.assert_array_equal(ranks2[0]["p2p"], xs[0])


@pytest.mark.parametrize("key,fn", [("ar_sum", _ar(C.ReduceOp.SUM)),
                                    ("ag", _ag)])
def test_all_reduce_all_gather_world4(ranks4, key, fn):
    _check(ranks4, key, _jax(4, fn, _xs(4)))


def test_mesh_axes_world4(ranks4):
    """create_mesh({'dp': 2, 'tp': 2}) lays the ranks out row-major: an
    all-reduce over 'tp' sums a dp row's two ranks, over 'dp' a column's,
    as the JAX collective over each axis of a 2 x 2 mesh does."""
    xs = _xs(4)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    for ax in ("dp", "tp"):
        def body(v, ax=ax):
            with C.shard_ctx(ax):
                t = paddle.Tensor(v[0, 0])
                C.all_reduce(t)
                return _val(t)[None, None]
        want = np.asarray(compat_shard_map(
            body, mesh=mesh, in_specs=P("dp", "tp"),
            out_specs=P("dp", "tp"))(jnp.asarray(xs.reshape(2, 2, 8))))
        for r, got in enumerate(ranks4):
            assert tuple(got["coords"]) == (r // 2, r % 2)
            np.testing.assert_allclose(got[f"ar_{ax}"],
                                       want[r // 2, r % 2], rtol=0,
                                       atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("shuffle,drop_last,n", [(False, False, 10),
                                                 (True, False, 11),
                                                 (True, True, 13)])
def test_distributed_batch_sampler_matches_jax(shuffle, drop_last, n):
    from paddle_tpu.io.sampler import DistributedBatchSampler as J
    from paddle_tpu_torch.io import DistributedBatchSampler as T
    data = list(range(n))
    for rank in range(3):
        j = J(data, 2, num_replicas=3, rank=rank, shuffle=shuffle,
              drop_last=drop_last)
        t = T(data, 2, num_replicas=3, rank=rank, shuffle=shuffle,
              drop_last=drop_last)
        for epoch in (0, 3):
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            assert list(t) == list(j)
            assert len(t) == len(j)
