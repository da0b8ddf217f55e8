"""paddle_tpu_torch.distributed.fleet held to paddle_tpu's fleet on the
8-virtual-device CPU mesh.

The port runs two gloo ranks (`torch_dist_ranks.py` job "fleet", one
spawn); the JAX side runs `fleet.init` + `fleet.build_sharded_train_step`
(and `Model.fit` under fleet) in this process over two of the virtual
devices (`hybrid_configs` dp 2, or pp 2 / sp 2), from the same weights
and batches:
- each branch of the strategy dispatch (`paddle_tpu/distributed/fleet/
  fleet_base.py:145-175`): the step it builds, its mesh, the batch
  placement `Fleet.batch_placement` gives (`:127-140`) and its 2 losses,
  within rtol 2e-4 / atol 2e-5 (`tests/test_dist_cluster.py:91-92`);
- the role makers from the PADDLE_* env, against the JAX ones;
- the eight fleet metrics and `UtilBase` over the two ranks, against the
  JAX metrics of the ranks' values combined;
- `Model.fit` routed through fleet (a 20-sample set at batch 8: the tail
  padded and masked), its per-step losses and final parameters against
  the JAX `Model.fit` under fleet, rtol 1e-5; the same at ZeRO-3, with
  `Model.save`'s weights and `evaluate`'s loss.
"""
import json
import os

import numpy as np
import pytest

import jax

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.models import GPTConfig, GPTForCausalLM
from paddle_tpu.ops.manipulation import reshape
from paddle_tpu.parallel import get_mesh, set_mesh

from torch_dist_ranks import (FLEET_BRANCHES, PLACED_SHAPES, _mlp_tok,
                              _params, fleet_strategy, start_ranks)

LOSS = dict(rtol=2e-4, atol=2e-5)
FIT = dict(rtol=1e-5, atol=1e-6)


def _mlp(out_f, seed):
    paddle.seed(seed)
    return jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(),
                          jnn.Linear(16, out_f))


def _gpt():
    paddle.seed(42)
    return GPTForCausalLM(GPTConfig.tiny(
        vocab_size=128, num_layers=4, hidden_size=32, num_heads=2,
        intermediate_size=64, max_position_embeddings=32, dropout=0.0))


def _inputs():
    rng = np.random.RandomState(5)
    a = {"tx": rng.randn(8, 6, 8).astype("float32"),
         "ty": rng.randn(8, 6, 4).astype("float32"),
         "ids": rng.randint(0, 128, size=(8, 16)).astype("int64"),
         "tgt": rng.randint(0, 128, size=(8, 16)).astype("int64"),
         "fx": rng.randn(20, 8).astype("float32"),
         "fy": rng.randint(0, 4, size=(20,)).astype("int64")}
    for r in range(2):
        a[f"m{r}.a"] = rng.rand(3).astype("float64")
        a[f"m{r}.c"] = np.asarray(rng.randint(0, 10), "float64")
        a[f"m{r}.t"] = np.asarray(10 + r, "float64")
        a[f"m{r}.e"] = np.asarray(rng.rand() * 3, "float64")
        a[f"m{r}.pos"] = rng.randint(0, 5, size=(6,)).astype("float64")
        a[f"m{r}.neg"] = rng.randint(0, 5, size=(6,)).astype("float64")
    for k, v in _mlp(4, 3).state_dict().items():
        a[f"tok.{k}"] = v.numpy()
        a[f"fit.{k}"] = v.numpy()
    for k, v in _gpt().state_dict().items():
        a[f"gpt.{k}"] = v.numpy()
    return a


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wd = tmp_path_factory.mktemp("fleet")
    inp = _inputs()
    np.savez(wd / "in.npz", **inp)
    job = start_ranks("fleet", 2, str(wd), timeout=200)
    yield inp, job
    job.close()
    jfleet.fleet._inited = False
    set_mesh(None)


def _mse(outs, labels):
    out = outs[0] if isinstance(outs, (list, tuple)) else outs
    d = out - labels[0]
    return (d * d).mean()


ce = jnn.CrossEntropyLoss()


def _lm_loss(outs, labels):
    out = outs[0] if isinstance(outs, (list, tuple)) else outs
    b, s, v = out.shape
    return ce(reshape(out, [b * s, v]), reshape(labels[0], [b * s]))


def _jax_branch(inp, br):
    jfleet.init(is_collective=True, strategy=fleet_strategy(jfleet, br))
    if br == "pipeline":
        net, lf = _gpt(), _lm_loss
        data = ((inp["ids"].astype("int32"),), (inp["tgt"].astype("int32"),))
    else:
        net, lf = _mlp(4, 3), _mse
        data = ((inp["tx"],), (inp["ty"],))
    opt = jfleet.distributed_optimizer(
        paddle.optimizer.SGD(0.1, parameters=net.parameters()))
    step, st = jfleet.fleet.build_sharded_train_step(net, opt, lf)
    losses = []
    for _ in range(2):
        st, lv = step(st, *data, rng=jax.random.PRNGKey(0))
        losses.append(float(lv))
    mesh = dict(get_mesh().shape)
    place = jfleet.fleet.batch_placement()
    placed = [None if place(np.zeros(sh)) is None else
              [a for a in place(np.zeros(sh)).spec] +
              [None] * (len(sh) - len(place(np.zeros(sh)).spec))
              for sh in PLACED_SHAPES]
    set_mesh(None)
    return losses, mesh, placed


WHICH = {"pipeline": "pipeline", "localsgd": "local",
         "adaptive_localsgd": "local", "dgc": "sharded+dgc"}


@pytest.mark.parametrize("branch", FLEET_BRANCHES)
def test_strategy_dispatch_matches_jax(ranks, branch):
    inp, job = ranks
    losses, mesh, placed = _jax_branch(inp, branch)
    for got in job.wait():
        assert str(got[f"{branch}.which"]) == WHICH.get(branch, "sharded")
        assert json.loads(str(got[f"{branch}.mesh"])) == mesh
        # Fleet.batch_placement agrees with the step's split
        assert json.loads(str(got[f"{branch}.placement"])) == placed
        np.testing.assert_allclose(got[f"{branch}.losses"], losses, **LOSS)


@pytest.mark.parametrize("role", ["TRAINER", "PSERVER"])
def test_role_makers_from_the_env_match_jax(monkeypatch, role):
    from paddle_tpu_torch.distributed import fleet as tfleet
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "10.0.0.1:6170,"
                       "10.0.0.2:6170,10.0.0.3:6170")
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST", "10.0.0.9:6000")
    monkeypatch.setenv("TRAINING_ROLE", role)
    monkeypatch.setenv("PADDLE_PORT_ID", "0")

    def view(F):
        rm = F.PaddleCloudRoleMaker(is_collective=True)
        ud = F.UserDefinedRoleMaker(current_id=2, role=F.Role.SERVER,
                                    worker_endpoints=["a:1", "b:2"],
                                    server_endpoints=["c:3"])
        return [(m.is_worker(), m.is_server(), m.is_first_worker(),
                 m.worker_index(), m.server_index(), m.worker_num(),
                 m.server_num(), m.get_trainer_endpoints(),
                 m.get_pserver_endpoints()) for m in (rm, ud)]
    assert view(tfleet) == view(jfleet)


def test_fleet_metrics_over_two_ranks_match_jax(ranks):
    inp, job = ranks
    m = {k: inp[f"m0.{k}"] + inp[f"m1.{k}"]
         for k in ("a", "c", "t", "e", "pos", "neg")}
    want = {"sum": jfleet.metrics.sum(m["a"]),
            "max": jfleet.metrics.max(np.maximum(inp["m0.a"], inp["m1.a"])),
            "min": jfleet.metrics.min(np.minimum(inp["m0.a"], inp["m1.a"])),
            "mean": jfleet.metrics.mean(m["a"] / 2),
            "acc": jfleet.metrics.acc(m["c"], m["t"]),
            "mae": jfleet.metrics.mae(m["e"], m["t"]),
            "rmse": jfleet.metrics.rmse(m["e"], m["t"]),
            "auc": jfleet.metrics.auc(m["pos"], m["neg"]),
            "util_sum": m["a"],
            "util_max": np.maximum(inp["m0.a"], inp["m1.a"]),
            "util_gather": [inp["m0.a"], inp["m1.a"]]}
    for got in job.wait():
        g = json.loads(str(got["metrics"]))
        for k, w in want.items():
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w),
                                       rtol=1e-12, err_msg=k)


def test_model_fit_routes_through_fleet_like_jax(ranks):
    inp, job = ranks
    jfleet.init(is_collective=True)
    net = _mlp(4, 3)
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.SGD(0.1, parameters=net.parameters()),
                  jnn.CrossEntropyLoss())
    assert model._dist_ctx is not None

    class DS(paddle.io.Dataset):
        def __len__(self):
            return 20

        def __getitem__(self, i):
            return inp["fx"][i], inp["fy"][i].astype("int32")
    got_j = []

    class Rec(paddle.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            got_j.append(float(logs["loss"]))
    model.fit(DS(), batch_size=8, epochs=2, shuffle=False, verbose=0,
              log_freq=1, callbacks=[Rec()])
    want = {k: v.numpy() for k, v in net.state_dict().items()}
    jfleet.fleet._inited = False
    set_mesh(None)
    for got in job.wait():
        assert bool(got["fit.routed"])
        np.testing.assert_allclose(got["fit.losses"], got_j, **FIT)
        port = _params(_mlp_tok({f"w.{k}": v for k, v in want.items()},
                                "w."))
        for k, w in port.items():
            np.testing.assert_allclose(got[f"fit.p.{k}"], w, **FIT,
                                       err_msg=k)


def test_model_fit_at_zero3_saves_and_evaluates_whole_weights(ranks):
    """`Model.fit` through fleet with `sharding_configs["stage"] = 3`: the
    step keeps a rank's blocks, gathered into the network at each epoch's
    end (`step.write_back`), so `Model.save` writes and `evaluate` runs
    the whole weights: the saved weights, the losses and the evaluated
    loss are the JAX `Model.fit` / `evaluate` under fleet's (the same
    global function; the JAX side at its default stage, C34)."""
    inp, job = ranks
    jfleet.init(is_collective=True)
    net = _mlp(4, 3)
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.SGD(0.1, parameters=net.parameters()),
                  jnn.CrossEntropyLoss())

    class DS(paddle.io.Dataset):
        def __len__(self):
            return 20

        def __getitem__(self, i):
            return inp["fx"][i], inp["fy"][i].astype("int32")
    got_j = []

    class Rec(paddle.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            got_j.append(float(logs["loss"]))
    model.fit(DS(), batch_size=8, epochs=2, shuffle=False, verbose=0,
              log_freq=1, callbacks=[Rec()])
    ev = float(np.ravel(model.evaluate(DS(), batch_size=8,
                                       verbose=0)["loss"])[0])
    want = {k: v.numpy() for k, v in net.state_dict().items()}
    jfleet.fleet._inited = False
    set_mesh(None)
    port = _params(_mlp_tok({f"w.{k}": v for k, v in want.items()}, "w."))
    for got in job.wait():
        assert int(got["fit3.blocks"]) == 4
        np.testing.assert_allclose(got["fit3.losses"], got_j, **FIT)
        for k, w in port.items():
            np.testing.assert_allclose(got[f"fit3.saved.{k}"], w, **FIT,
                                       err_msg=k)
        np.testing.assert_allclose(float(got["fit3.eval"]), ev, **FIT)


def test_fleet_surface(monkeypatch):
    """The fleet names the port exports (the parameter server's too), and
    an init_server -> init_worker -> stop_worker round trip of the port's
    fleet on localhost (the server on port 0)."""
    from paddle_tpu_torch.distributed import fleet as tfleet
    from paddle_tpu_torch.distributed.ps import runtime as truntime
    for name in ("init", "distributed_optimizer", "distributed_model",
                 "build_sharded_train_step", "worker_num", "is_first_worker",
                 "DistributedStrategy", "PaddleCloudRoleMaker",
                 "UserDefinedRoleMaker", "UtilBase", "LocalFS", "HDFSClient",
                 "ElasticManager", "HeartbeatClient", "ElasticStatus",
                 "KVServer", "KVClient", "metrics", "worker_index",
                 "FleetWrapper", "DownpourWorker", "InMemoryDataset",
                 "QueueDataset", "MultiSlotDataGenerator"):
        assert hasattr(tfleet, name) and hasattr(jfleet, name), name
    monkeypatch.setattr(truntime, "_runtime", None)
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST", "127.0.0.1:0")
    monkeypatch.setenv("PADDLE_PSERVER_ID", "0")
    rt = truntime.the_one_ps()
    tid = rt.register_dense_table(3, rule="sum")
    tfleet.init_server()
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST",
                       f"127.0.0.1:{rt.server.port}")
    tfleet.init_worker()
    rt.client.push_dense(tid, np.ones(3, np.float32))
    np.testing.assert_array_equal(rt.client.pull_dense(tid), np.ones(3))
    tfleet.stop_worker()
    rt.server._thread.join(5)
    assert not rt.server._thread.is_alive()
    s = tfleet.DistributedStrategy()
    assert s.mesh_axes(8) == jfleet.DistributedStrategy().mesh_axes(8)
    s.pipeline, s.sequence_parallel = True, True
    s.sequence_parallel_configs = {"degree": 2}
    j = jfleet.DistributedStrategy()
    j.pipeline, j.sequence_parallel = True, True
    j.sequence_parallel_configs = {"degree": 2}
    assert s.mesh_axes(8) == j.mesh_axes(8) == {"dp": 2, "pp": 2, "sp": 2}
    fs = tfleet.LocalFS()
    assert fs.is_exist(os.path.dirname(__file__))
