"""paddle_tpu_torch's data- and tensor-parallel training held to
paddle_tpu's sharded step on the 8-virtual-device CPU mesh.

The port runs gloo ranks (`torch_dist_ranks.py`: one spawn of 2 ranks,
one of 4); the JAX package runs `make_sharded_train_step` on a mesh of 2
(dp) or 4 (dp x mp) of the virtual devices, from the same weights (the
JAX model's, carried over by `load_reference_state` and, for the
tensor-parallel layers, each rank's slice of them) and the same global
batch. Losses within rtol 2e-4 / atol 2e-5 (`tests/test_dist_cluster.py:
91-92`), parameters after 3 steps within rtol 1e-4 / atol 1e-5.
Also: ZeRO 0/1/2 and `group_sharded_parallel`'s three levels,
`DataParallel` at world 2 against one process on the full batch, and
`sharded_checkpoint` saved at world 2 and loaded at world 1, and the
other way, exact.
"""
import json

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.parallel import create_mesh, make_sharded_train_step, \
    mesh_scope, set_mesh, write_back

from torch_dist_ranks import _mlp, _params, launch_ranks

LOSS = dict(rtol=2e-4, atol=2e-5)
PARAM = dict(rtol=1e-4, atol=1e-5)


def _jax_mlp():
    paddle.seed(7)
    return jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))


def _data():
    rng = np.random.RandomState(0)
    return (rng.randn(16, 8).astype("float32"),
            rng.randint(0, 4, 16).astype("int64"))


def _jax_run(opt_name, lr, n=2, level=None):
    x, y = _data()
    net = _jax_mlp()
    opt = getattr(paddle.optimizer, opt_name)(lr,
                                              parameters=net.parameters())
    ce = jnn.CrossEntropyLoss()
    with mesh_scope(create_mesh({"dp": n}, devices=jax.devices()[:n])):
        if level:
            net, opt = paddle.distributed.group_sharded_parallel(net, opt,
                                                                  level)
        # the JAX zero_sharding adds 'dp' to a ZeRO-3 parameter's spec
        # that has it already (a duplicate-axis spec: ROADMAP C34), so its
        # ZeRO-3 run takes the state's spec from the parameter alone
        step, st = make_sharded_train_step(
            net, opt, lambda o, lb: ce(o[0] if isinstance(o, (list, tuple))
                                       else o, lb[0]),
            zero_stage=0 if level == "p_g_os" else 1)
        losses = []
        for _ in range(3):
            st, lv = step(st, (x,), (y,), rng=jax.random.PRNGKey(0))
            losses.append(float(lv))
        write_back(net, st)
    set_mesh(None)
    return losses, {k: v.numpy() for k, v in net.state_dict().items()}


def _weights():
    return {f"w.{k}": v.numpy() for k, v in _jax_mlp().state_dict().items()}


@pytest.fixture(scope="module")
def world1_ckpt(tmp_path_factory):
    """A world-1 ZeRO-1 Adam state after 2 steps, saved by this process
    (no process group), for the ranks to load under their blocks."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.framework.sharded_checkpoint import save_sharded
    from paddle_tpu_torch.parallel import make_sharded_train_step as mk
    wd = tmp_path_factory.mktemp("train2")
    x, y = _data()
    net = _mlp(_weights(), "w.")
    opt = ptt.optimizer.Adam(0.01, parameters=net.parameters())
    ce = nn.CrossEntropyLoss()
    step, st = mk(net, opt, lambda o, lb: ce(o, lb[0]))
    for _ in range(2):
        st, _ = step(st, (x,), (y,))
    save_sharded(st, str(wd / "ck1"), shardings=step.state_sharding)
    return wd, st


@pytest.fixture(scope="module")
def ranks2(world1_ckpt):
    wd, _ = world1_ckpt
    x, y = _data()
    np.savez(wd / "in.npz", x=x, y=y, **_weights())
    return wd, launch_ranks("train", 2, str(wd))


def _torch_to_jax_names(params):
    """port [out, in] Linear weights back to the JAX layout."""
    return {k: (v.T if k.endswith("weight") else v)
            for k, v in params.items()}


@pytest.mark.parametrize("zero", ["zero0", "zero1", "zero2",
                                  "recompute"])
def test_dp2_zero_matches_jax(ranks2, zero):
    """ZeRO 0/1/2 (and ZeRO-1 with the forward recomputed) at dp 2
    against the JAX step on a dp = 2 mesh."""
    _, ranks = ranks2
    losses, params = _jax_run("Momentum", 0.1)
    for got in ranks:
        np.testing.assert_allclose(got[f"{zero}.losses"], losses, **LOSS)
        for k, want in params.items():
            np.testing.assert_allclose(
                _torch_to_jax_names({k: got[f"{zero}.{k}"]})[k], want,
                **PARAM)


@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
def test_group_sharded_levels_match_jax(ranks2, level):
    _, ranks = ranks2
    losses, params = _jax_run("Adam", 0.01, level=level)
    for got in ranks:
        np.testing.assert_allclose(got[f"{level}.losses"], losses, **LOSS)
        for k, want in params.items():
            np.testing.assert_allclose(
                _torch_to_jax_names({k: got[f"{level}.{k}"]})[k], want,
                **PARAM)


def test_zero1_state_is_split_over_dp(ranks2):
    """Each rank keeps the block of every state leaf on the axis
    zero_sharding picks: the largest dp-divisible one."""
    _, ranks = ranks2
    axes = json.loads(str(ranks[0]["zero_axes"]))
    assert axes == {"0.weight": 0, "0.bias": 0, "2.weight": 1,
                    "2.bias": 0}
    full = np.concatenate([ranks[0]["os.opt.0.weight.moment1"],
                           ranks[1]["os.opt.0.weight.moment1"]], 0)
    assert full.shape == (16, 8)
    assert not np.array_equal(ranks[0]["os.opt.0.weight.moment1"],
                              ranks[1]["os.opt.0.weight.moment1"])


def test_data_parallel_equals_one_process(ranks2):
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn
    _, ranks = ranks2
    x, y = _data()
    net = _mlp(_weights(), "w.")
    opt = ptt.optimizer.Momentum(0.1, parameters=net.parameters())
    ce = nn.CrossEntropyLoss()
    for _ in range(3):
        ce(net(torch.tensor(x)), torch.tensor(y)).backward()
        opt.step()
        opt.clear_grad()
    for k, want in _params(net).items():
        for got in ranks:
            np.testing.assert_allclose(got[f"dp.{k}"], want, rtol=1e-5,
                                       atol=1e-6)


def test_data_parallel_unused_parameters(ranks2):
    _, ranks = ranks2
    for got in ranks:
        assert bool(got["unused.False"])            # refused, named
        assert float(got["unused.True"]) == 0.0     # reduced as zeros


def test_sharded_checkpoint_world2_to_world1(ranks2):
    from paddle_tpu_torch.framework.sharded_checkpoint import load_sharded
    wd, ranks = ranks2
    back = load_sharded(str(wd / "ck2"))
    assert back["step_no"] == 3
    axes = json.loads(str(ranks[0]["zero_axes"]))
    for name, ax in axes.items():
        for s in ("moment1", "moment2"):
            blocks = [r[f"os.opt.{name}.{s}"] for r in ranks]
            want = (np.concatenate(blocks, ax) if ax is not None
                    else blocks[0])
            np.testing.assert_array_equal(back["opt_state"][name][s].numpy(),
                                          want)
    for k in back["params"]:
        np.testing.assert_array_equal(back["params"][k].numpy(),
                                      ranks[0][f"os.{k}"])
    assert all(bool(r["async_equal"]) for r in ranks)


def test_sharded_checkpoint_world1_to_world2(ranks2, world1_ckpt):
    _, ranks = ranks2
    _, st = world1_ckpt
    axes = json.loads(str(ranks[0]["zero_axes"]))
    for r, got in enumerate(ranks):
        assert int(got["ck1.step_no"]) == 2
        for name, ax in axes.items():
            for s in ("moment1", "moment2"):
                full = st["opt_state"][name][s].numpy()
                want = (np.split(full, 2, ax)[r] if ax is not None
                        else full)
                np.testing.assert_array_equal(got[f"ck1.opt.{name}.{s}"],
                                              want)


# -- tensor parallel -----------------------------------------------------------

def _jax_tp_net():
    from paddle_tpu.distributed import (ColumnParallelLinear,
                                        RowParallelLinear,
                                        VocabParallelEmbedding)

    class Net(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = VocabParallelEmbedding(32, 16)
            self.up = ColumnParallelLinear(16, 32, gather_output=False)
            self.down = RowParallelLinear(32, 16, input_is_parallel=True)

        def forward(self, ids):
            return self.down(paddle.nn.functional.relu(
                self.up(self.emb(ids))))
    return Net()


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    wd = tmp_path_factory.mktemp("tp")
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 32, 8).astype("int64")
    y = rng.randn(8, 16).astype("float32")
    paddle.seed(3)
    w = {f"w.{k}": v.numpy() for k, v in _jax_tp_net().state_dict().items()}
    np.savez(wd / "in.npz", ids=ids, y=y, **w)
    ranks = launch_ranks("tp_train", 4, str(wd))
    with mesh_scope(create_mesh({"dp": 2, "mp": 2},
                                devices=jax.devices()[:4])):
        paddle.seed(3)
        net = _jax_tp_net()
        opt = paddle.optimizer.Adam(0.01, parameters=net.parameters())
        step, st = make_sharded_train_step(
            net, opt, lambda o, lb: paddle.nn.functional.mse_loss(
                o[0] if isinstance(o, (list, tuple)) else o, lb[0]),
            zero_stage=1)
        losses = []
        for _ in range(3):
            st, lv = step(st, (ids,), (y,), rng=jax.random.PRNGKey(1))
            losses.append(float(lv))
        write_back(net, st)
        params = {k: v.numpy() for k, v in net.state_dict().items()}
    set_mesh(None)
    return ranks, losses, params


def test_dp2_tp2_step_matches_jax(tp_run):
    """dp 2 x mp 2 over ColumnParallelLinear / RowParallelLinear /
    VocabParallelEmbedding with ZeRO-1 Adam: every rank's loss, and each
    parameter reassembled from the mp ranks' slices, against the JAX
    step on a 2 x 2 mesh (`tests/test_distributed.py:86`)."""
    ranks, losses, params = tp_run
    split = {"emb.weight": 0, "up.weight": 1, "up.bias": 0,
             "down.weight": 0}
    for got in ranks:
        np.testing.assert_allclose(got["losses"], losses, **LOSS)
    for k, want in params.items():
        for dp in (0, 1):
            rows = [g for g in ranks if tuple(g["coords"])[0] == dp]
            rows.sort(key=lambda g: tuple(g["coords"])[1])
            got = (np.concatenate([g[f"p.{k}"] for g in rows], split[k])
                   if k in split else rows[0][f"p.{k}"])
            np.testing.assert_allclose(got, want, **PARAM)
    assert losses[2] < losses[0]
