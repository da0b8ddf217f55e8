"""paddle_tpu_torch's LocalSGD and DGC held to paddle_tpu's on the
8-virtual-device CPU mesh.

`dgc_compress` runs in this process against the JAX one on the same
gradients and state, three steps chained, with and without `rampup_step`
(the quantile threshold, `paddle_tpu/parallel/compression.py:66-71`): the
kept mask bit-equal, the emitted gradient and both state leaves within
1e-6. The steps run in two gloo ranks (`torch_dist_ranks.py` job
"localsgd") against the JAX steps on a dp = 2 mesh of virtual devices
(`tests/test_localsgd_dgc.py:72-127`'s model and data): LocalSGD with
k_steps=1 equal to synchronous dp, k_steps=4's replicas apart between
syncs and equal right after each, adaptive k moving as the JAX package's,
and `make_sharded_train_step(dgc=True)`'s losses and error feedback.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.parallel import (create_mesh, dgc_compress, dgc_init,
                                 make_local_train_step,
                                 make_sharded_train_step, mesh_scope,
                                 set_mesh)

from torch_dist_ranks import start_ranks

LOSS = dict(rtol=1e-5, atol=1e-7)


def _toy():
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype("float32")
    w = rng.randn(8, 1).astype("float32")
    return x, (x @ w).astype("float32")


def _build():
    paddle.seed(11)
    net = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 1))
    return net, paddle.optimizer.SGD(0.1, parameters=net.parameters())


def _mse(outs, labels):
    out = outs[0] if isinstance(outs, (list, tuple)) else outs
    d = out - labels[0]
    return (d * d).mean()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wd = tmp_path_factory.mktemp("localsgd")
    x, y = _toy()
    inp = {"x": x, "y": y}
    for k, v in _build()[0].state_dict().items():
        inp[f"mlp.{k}"] = v.numpy()
    np.savez(wd / "in.npz", **inp)
    job = start_ranks("localsgd", 2, str(wd))
    yield job
    job.close()


def _mesh2():
    return create_mesh({"dp": 2}, devices=jax.devices()[:2])


def _jax_losses(make, steps, collect=None):
    x, y = _toy()
    net, opt = _build()
    out = []
    with mesh_scope(_mesh2()):
        step, st = make(net, opt)
        for _ in range(steps):
            st, lv = step(st, (x,), (y,), rng=jax.random.PRNGKey(0))
            out.append(float(lv))
            if collect is not None:
                collect(st)
    set_mesh(None)
    return out, st


@pytest.mark.parametrize("rampup", [None, 2])
def test_dgc_compress_matches_jax(rampup):
    import torch
    from paddle_tpu_torch.parallel import compression as tc
    rng = np.random.RandomState(4)
    shapes = {"w": (16, 32), "b": (32,), "one": (3,)}
    js = dgc_init({k: jnp.zeros(s) for k, s in shapes.items()})
    ts = tc.dgc_init({k: torch.zeros(s) for k, s in shapes.items()})
    for step_no in range(3):
        g = {k: rng.randn(*s).astype("float32") for k, s in shapes.items()}
        kw = dict(momentum=0.9, sparsity=0.9, rampup_step=rampup,
                  step_no=step_no if rampup else None)
        jo, js = dgc_compress({k: jnp.asarray(v) for k, v in g.items()},
                              js, **kw)
        to, ts = tc.dgc_compress({k: torch.tensor(v) for k, v in g.items()},
                                 ts, **kw)
        for k in shapes:
            jm = np.asarray(jo[k]) != 0
            np.testing.assert_array_equal(to[k].numpy() != 0, jm, err_msg=k)
            if rampup is None:
                # k kept, more only at ties of |v|
                assert jm.sum() >= max(1, round(jm.size * 0.1))
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       rtol=1e-6, atol=1e-6)
            for leaf in ("u", "v"):
                np.testing.assert_allclose(ts[k][leaf].numpy(),
                                           np.asarray(js[k][leaf]),
                                           rtol=1e-6, atol=1e-6)


def test_localsgd_k1_equals_sync_dp(ranks):
    sync, _ = _jax_losses(lambda n, o: make_sharded_train_step(
        n, o, _mse, zero_stage=0), 4)
    local, _ = _jax_losses(lambda n, o: make_local_train_step(
        n, o, _mse, k_steps=1, begin_step=0), 4)
    np.testing.assert_allclose(local, sync, rtol=2e-4)
    for got in ranks.wait():
        np.testing.assert_allclose(got["sync.losses"], sync, **LOSS)
        np.testing.assert_allclose(got["local1.losses"], local, **LOSS)
        np.testing.assert_allclose(got["local1.losses"],
                                   got["sync.losses"], rtol=1e-6)


def test_localsgd_k4_replicas_meet_at_syncs(ranks):
    r0, r1 = ranks.wait()
    w0, w1 = r0["k4.w"], r1["k4.w"]
    for i in range(8):
        synced = (i + 1) % 4 == 0
        if synced:
            np.testing.assert_array_equal(w0[i], w1[i])
        else:
            assert not np.array_equal(w0[i], w1[i]), i
    assert int(r0["k4.since"]) == 0
    np.testing.assert_allclose(r0["k4.written"], r1["k4.written"])
    np.testing.assert_allclose(r0["k4.written"], w0[-1], rtol=1e-6)


def test_adaptive_k_moves_as_in_jax(ranks):
    ks = []
    losses, st = _jax_losses(lambda n, o: make_local_train_step(
        n, o, _mse, k_steps=2, adaptive=True), 12,
        collect=lambda s: ks.append(int(s["k"])))
    for got in ranks.wait():
        assert got["adaptive.k"].tolist() == ks
        assert len(set(ks)) > 1, ks
        np.testing.assert_allclose(float(got["adaptive.loss0"]),
                                   float(st["loss0"]), rtol=1e-5)
        np.testing.assert_allclose(got["adaptive.losses"], losses, **LOSS)


def test_dgc_steps_match_jax(ranks):
    losses, st = _jax_losses(lambda n, o: make_sharded_train_step(
        n, o, _mse, zero_stage=0, dgc=True, dgc_sparsity=0.75), 3)
    for got in ranks.wait():
        np.testing.assert_allclose(got["dgc.losses"], losses, **LOSS)
        for k, v in st["dgc"].items():
            want = np.asarray(v["v"])
            if k.endswith("weight"):
                want = want.T
            np.testing.assert_allclose(got[f"dgc.v.{k}"], want, rtol=1e-5,
                                       atol=1e-7, err_msg=k)
