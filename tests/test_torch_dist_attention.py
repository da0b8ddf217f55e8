"""The sharded kernel dispatches held to paddle_tpu's on the CPU mesh.

- `parallel.spmd.sharded_splash_attention` at dp = 2 (two gloo ranks of
  `torch_dist_ranks.py`, each on its rows of a packed batch): forward and
  the q/k/v gradients against the JAX `sharded_splash_attention` on a
  dp = 2 mesh (the splash kernels through their plain reference), within
  `tests/test_splash_attention.py:333`'s 2e-5. With dropout the rank is
  folded into the seed: two ranks on identical rows draw different keep
  masks, each the plain version's at seed + rank.
- `ops.paged_ops.sharded_paged_attention` at tp = 2 (each rank its two
  heads of four), fp32 and int8 pools with their scale grids, against the
  JAX `sharded_paged_attention` on a tp = 2 mesh, within the port's K1
  parity tolerance (atol 1e-5, `tests/test_torch_paged_ops.py`).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from paddle_tpu.ops.paged_ops import sharded_paged_attention
from paddle_tpu.parallel.mesh import set_mesh
from paddle_tpu.parallel.spmd import sharded_splash_attention

from torch_dist_ranks import launch_ranks

B, H, S, D = 4, 2, 128, 16


def _segments(boundaries):
    seg = np.zeros((S,), np.int32)
    for b in boundaries:
        seg[b:] += 1
    return seg


def _inputs():
    rng = np.random.RandomState(24)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    seg = np.stack([_segments((40, 100)), _segments((64,)),
                    _segments((10, 50, 90)), _segments(())])
    # K1: 3 sequences, 4 heads of 16, pages of 4, 13 pages
    PH, N, P, PP = 4, 13, 4, 3
    lens = np.array([5, 12, 9])
    pt = np.zeros((3, PP), np.int32)
    perm = rng.permutation(N - 1) + 1
    for b, n in enumerate(lens):
        npg = -(-n // P)
        pt[b, :npg] = perm[b * PP:b * PP + npg]
    kq = rng.randint(-127, 128, size=(PH, N, P, D)).astype(np.int8)
    vq = rng.randint(-127, 128, size=(PH, N, P, D)).astype(np.int8)
    return dict(q=mk(B, H, S, D), k=mk(B, H, S, D), v=mk(B, H, S, D),
                dout=mk(B, H, S, D), seg=seg, pq=mk(3, PH, D),
                kp=mk(PH, N, P, D), vp=mk(PH, N, P, D), pt=pt,
                pos=(lens - 1).astype(np.int32), kq=kq, vq=vq,
                ks=(rng.rand(PH, N) * 0.02).astype(np.float32),
                vs=(rng.rand(PH, N) * 0.02).astype(np.float32))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    wd = tmp_path_factory.mktemp("attn")
    inp = _inputs()
    np.savez(wd / "in.npz", **inp)
    return inp, launch_ranks("attention", 2, str(wd))


def test_sharded_splash_forward_and_grads_match_jax(run):
    inp, ranks = run
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    try:
        set_mesh(mesh)
        f = sharded_splash_attention(mesh, causal=True)
        q, k, v, dout = (jnp.asarray(inp[x]) for x in ("q", "k", "v",
                                                       "dout"))
        seg = jnp.asarray(inp["seg"])
        out = f(q, k, v, seg, seg)
        grads = jax.grad(lambda a, b, c: jnp.sum(f(a, b, c, seg, seg)
                                                 * dout), (0, 1, 2))(q, k, v)
    finally:
        set_mesh(None)
    want = {"out": np.asarray(out), "dq": np.asarray(grads[0]),
            "dk": np.asarray(grads[1]), "dv": np.asarray(grads[2])}
    for key, w in want.items():
        got = np.concatenate([r[key] for r in ranks], 0)
        np.testing.assert_allclose(got, w, rtol=2e-5, atol=2e-5,
                                   err_msg=key)


def test_sharded_splash_dropout_folds_the_rank(run):
    _, ranks = run
    a, b = ranks[0]["drop"], ranks[1]["drop"]
    # identical rows, one seed: the masks differ by rank ...
    assert not np.array_equal(a, b)
    # ... and each is the plain version's at seed + rank
    for r in ranks:
        np.testing.assert_allclose(r["drop"], r["drop_plain"], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("quantized", [False, True])
def test_sharded_paged_attention_matches_jax(run, quantized):
    from paddle_tpu.parallel.spmd import tp_mesh
    inp, ranks = run
    mesh = tp_mesh(2, devices=jax.devices()[:2])
    scale = 1.0 / D ** 0.5
    f = sharded_paged_attention(mesh, scale, quantized=quantized)
    a = lambda k: jnp.asarray(inp[k])  # noqa: E731
    if quantized:
        want = f(a("pq"), a("kq"), a("vq"), a("ks"), a("vs"), a("pt"),
                 a("pos"))
    else:
        want = f(a("pq"), a("kp"), a("vp"), a("pt"), a("pos"))
    key = "paged_q8" if quantized else "paged"
    got = np.concatenate([r[key] for r in ranks], 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    # on CPU tensors the wrappers take their plain versions: no K1 launch
    assert all(int(r["launches"]) == 0 for r in ranks)
