"""The port's parameter server (`paddle_tpu_torch.distributed.ps`,
`fleet.FleetWrapper`, `fleet.DownpourWorker`) held to the JAX package's
(`paddle_tpu.distributed.ps`) in one process, on the CPU:
- the native tables: the same seed and pushes give the same bits (sgd,
  adam and sum rules), and a sparse table saved by either package loads
  bit-exact in the other;
- the wire: the port's client against the JAX package's server and the
  JAX client against the port's server (dense and sparse pull / push,
  set, barrier, save / load), each held to a local table;
- the communicators, the runtime's env contract and the fleet surface;
- FleetWrapper + DownpourWorker: losses of the port (rtol 1e-5) and the
  servers' rows (1e-6 x max) against the JAX package's worker.
"""
import os

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu_torch.distributed import fleet as tfleet

from torch_ps_parity import (DIM, PS, batches, endpoint, heads, losses,
                             on_the_cpu, serve)  # noqa: F401

RULES = ("sgd", "adam", "sum")


def _pushes(rs, n, dim, vocab=50):
    return [(rs.randint(0, vocab, size=n).astype(np.int64),
             rs.standard_normal((n, dim)).astype(np.float32))
            for _ in range(5)]


@pytest.mark.parametrize("rule", RULES)
def test_tables_are_bit_equal(rule):
    """Dense and sparse tables of the two packages: the same seed and
    pushes (duplicate ids within a push included) give the same bits."""
    rs = np.random.RandomState(0)
    pushes = _pushes(rs, 24, DIM)
    dense_g = [rs.standard_normal(33).astype(np.float32) for _ in range(4)]
    out = {}
    for pkg, ps in PS.items():
        st = ps.SparseTable(DIM, rule=rule, lr=0.05, seed=3)
        for ids, g in pushes:
            st.push(ids, g)
        dt = ps.DenseTable(33, rule=rule, lr=0.05)
        dt.set(np.linspace(-1, 1, 33, dtype=np.float32))
        for g in dense_g:
            dt.push(g)
        out[pkg] = (st.pull(np.arange(60)), len(st), dt.pull())
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1] == 60
    np.testing.assert_array_equal(out["port"][2], out["jax"][2])


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
def test_sparse_table_save_load_across_packages(tmp_path, direction):
    src, dst = direction.split("->")
    a = PS[src].SparseTable(DIM, rule="adam", lr=0.01, seed=1)
    rs = np.random.RandomState(2)
    for ids, g in _pushes(rs, 16, DIM):
        a.push(ids, g)
    path = str(tmp_path / "t.bin")
    assert a.save(path) == len(a)
    b = PS[dst].SparseTable(DIM, rule="adam", lr=0.01, seed=9)
    assert b.load(path) == len(a) == len(b)
    ids = np.arange(50)
    np.testing.assert_array_equal(b.pull(ids), a.pull(ids))


def _save_push_load(client, path, ids, rows, dense):
    """save, push ones, load: the rows and the dense table of before."""
    client.save(path)
    client.push_sparse(1, ids, np.ones((ids.size, DIM), np.float32))
    client.push_dense(0, np.ones(12, np.float32), server=1 % len(
        client._endpoints))
    client.load(path)
    np.testing.assert_array_equal(client.pull_sparse(1, ids, DIM), rows)
    np.testing.assert_array_equal(
        client.pull_dense(0, server=1 % len(client._endpoints)), dense)


def _ref_tables(rule="sgd"):
    ps = PS["port"]
    return ps.DenseTable(12, rule, 0.1), ps.SparseTable(DIM, rule, 0.1,
                                                        0.05)


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_client_server_interop(tmp_path, client_pkg, server_pkg):
    """Either package's client against the other's two servers (one
    dense table each, one sparse table sharded by |id| mod 2), held to
    local tables given the same calls; barrier, save and load."""
    sps = PS[server_pkg]
    cfg = [sps.TableConfig(0, "dense", size=12, rule="sgd", lr=0.1),
           sps.TableConfig(1, "sparse", dim=DIM, rule="sgd", lr=0.1)]
    servers = [serve(server_pkg, cfg), serve(server_pkg, cfg)]
    client = PS[client_pkg].PsClient([endpoint(s) for s in servers])
    dense, sparse = _ref_tables()
    try:
        rs = np.random.RandomState(4)
        init = rs.standard_normal(12).astype(np.float32)
        client.set_dense(0, init, server=1)
        dense.set(init)
        for _ in range(3):
            g = rs.standard_normal(12).astype(np.float32)
            client.push_dense(0, g, server=1)
            dense.push(g)
            ids = rs.randint(-20, 40, size=30).astype(np.int64)
            np.testing.assert_array_equal(client.pull_sparse(1, ids, DIM),
                                          sparse.pull(ids))
            sg = rs.standard_normal((30, DIM)).astype(np.float32)
            client.push_sparse(1, ids, sg)
            sparse.push(ids, sg)
        np.testing.assert_array_equal(client.pull_dense(0, server=1),
                                      dense.pull())
        np.testing.assert_array_equal(client.pull_dense(0, server=0),
                                      np.zeros(12, np.float32))
        ids = np.arange(-20, 40)
        want = sparse.pull(ids)
        np.testing.assert_array_equal(client.pull_sparse(1, ids, DIM), want)
        client.barrier()
        if client_pkg == "port":
            _save_push_load(client, str(tmp_path / "ckpt"), ids, want,
                            dense.pull())
        else:   # the JAX client's servers share one path (C41): one server
            one = PS["jax"].PsClient([endpoint(servers[1])])
            odd = ids[np.abs(ids) % 2 == 1]
            _save_push_load(one, str(tmp_path / "ckpt"), odd,
                            sparse.pull(odd), dense.pull())
            one.close()
    finally:
        client.stop_server()
        client.close()
        for s in servers:
            s.stop()
    assert all(s._stop.is_set() for s in servers)


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_port_server_reports_a_failed_request(client_pkg):
    """A request the port's server cannot serve (no such table) is
    answered with status 1, which both packages' clients raise; the
    connection stays usable."""
    tps = PS["port"]
    s = serve("port", [tps.TableConfig(0, "dense", size=4)])
    client = PS[client_pkg].PsClient([endpoint(s)])
    try:
        with pytest.raises(RuntimeError, match="PS call failed"):
            client.pull_dense(7)
        np.testing.assert_array_equal(client.pull_dense(0),
                                      np.zeros(4, np.float32))
    finally:
        client.close()
        s.stop()


def _communicate(pkg, geo):
    ps = PS[pkg]
    rule = "sum" if geo else "sgd"
    s = serve(pkg, [ps.TableConfig(0, "dense", size=6, rule=rule, lr=0.1),
                    ps.TableConfig(1, "sparse", dim=DIM, rule="sgd",
                                   lr=0.1)])
    client = ps.PsClient([endpoint(s)])
    rs = np.random.RandomState(6)
    try:
        if geo:
            comm = ps.GeoCommunicator(client, k_steps=2)
            local = rs.standard_normal(6).astype(np.float32)
            comm.register_dense(0, local)
            seen = []
            for _ in range(4):
                local = local - 0.1 * rs.standard_normal(6).astype(
                    np.float32)
                local = comm.maybe_sync_dense(0, local)
                seen.append(local.copy())
            return seen, client.pull_dense(0)
        comm = ps.AsyncCommunicator(client).start()
        for _ in range(6):
            ids = rs.randint(0, 12, size=10).astype(np.int64)
            comm.push_sparse_async(1, ids, rs.standard_normal(
                (10, DIM)).astype(np.float32))
            comm.push_dense_async(0, rs.standard_normal(6).astype(
                np.float32))
        comm.stop()
        return client.pull_sparse(1, np.arange(12), DIM), \
            client.pull_dense(0)
    finally:
        client.close()
        s.stop()


@pytest.mark.parametrize("geo", [False, True], ids=["async", "geo"])
def test_communicators_match_jax(geo):
    """The async communicator's merged pushes and the geo communicator's
    k-step delta syncs leave the port's tables where the JAX package's
    leave its (the merge sums in queue order, so the async batches may
    group differently: 1e-5 x max)."""
    t, j = _communicate("port", geo), _communicate("jax", geo)
    for a, b in zip(t, j):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(b).max()))


def test_runtime_env_contract(monkeypatch):
    """TheOnePSRuntime of both packages under the PADDLE_* env: the
    server takes PADDLE_PSERVERS_IP_PORT_LIST[PADDLE_PSERVER_ID] (port
    0: a free port), a worker reaches it through the list,
    DistributedEmbedding pulls and pushes rows, and stop_worker stops
    the server."""
    got = {}
    for pkg, ps in PS.items():
        rt = ps.TheOnePSRuntime()
        tid = rt.register_sparse_table(DIM, rule="sgd", lr=0.5)
        assert rt.register_dense_table(4) == tid + 1
        monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST", "127.0.0.1:0")
        monkeypatch.setenv("PADDLE_PSERVER_ID", "0")
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
        server = rt.init_server()
        monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST", endpoint(server))
        rt.init_worker()
        emb = ps.DistributedEmbedding(rt, tid, DIM)
        ids = np.array([[3, 5], [5, 9]], np.int64)
        rows = emb.pull(ids)
        assert rows.shape == (2, 2, DIM)
        emb.push_grad(np.ones((4, DIM), np.float32), async_=False)
        got[pkg] = (rows, emb.pull(ids))
        rt.stop_worker()
        server._thread.join(5)
        assert not server._thread.is_alive()
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    np.testing.assert_array_equal(got["port"][1], got["jax"][1])
    np.testing.assert_allclose(got["port"][1][0, 1] - got["port"][0][0, 1],
                               -1.0, rtol=1e-6)   # id 5 twice: 2 x 0.5


def _downpour(pkg, head, data, async_push):
    ps = PS[pkg]
    fl = jfleet if pkg == "jax" else tfleet
    fw = fl.FleetWrapper()
    ep = fw.init_server("127.0.0.1:0", [ps.TableConfig(
        0, "sparse", dim=DIM, rule="sgd", lr=0.1)])
    fw.init_worker([ep])
    try:
        mod = J if pkg == "jax" else T
        opt = mod.optimizer.SGD(0.1, parameters=head.parameters())
        kw = {} if pkg == "jax" else {"device": "cpu"}
        worker = fl.DownpourWorker(fw, sparse_table_id=0, fea_dim=DIM,
                                   dense_layer=head, optimizer=opt,
                                   loss_fn=losses(mod),
                                   async_push=async_push, **kw)
        ls = worker.train_from_dataset(data, epochs=1, flush_every=3)
        rows = fw.pull_sparse_vars_sync(0, np.arange(20))
        return ls, rows, len(fw._server._tables[0])
    finally:
        fw.stop_server()


def test_downpour_worker_matches_jax():
    """FleetWrapper + DownpourWorker with synchronous push, 3 batches
    five times: the port's losses within rtol 1e-5 of the JAX worker's,
    the servers' rows within 1e-6 x max, the same rows created; the loss
    falls."""
    jh, th = heads(3)
    data = batches(3) * 5
    jl, jrows, jn = _downpour("jax", jh, data, False)
    tl, trows, tn = _downpour("port", th, data, False)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(trows, jrows, rtol=0,
                               atol=1e-6 * np.abs(jrows).max())
    assert tn == jn
    assert np.mean(tl[-3:]) < np.mean(tl[:3])


def test_downpour_async_push_and_flush_errors():
    """The default asynchronous push trains too (the loss falls, rows
    move); an error of the push thread is raised at client_flush(),
    once."""
    _, th = heads(5)
    data = batches(3, seed=2) * 5
    tl, rows, n = _downpour("port", th, data, True)
    assert all(np.isfinite(tl)) and np.mean(tl[-3:]) < np.mean(tl[:3])
    fw = tfleet.FleetWrapper()
    ep = fw.init_server("127.0.0.1:0", [PS["port"].TableConfig(
        0, "sparse", dim=DIM)])
    fw.init_worker([ep])
    try:
        fw.push_sparse_vars_async(5, [1, 2], np.ones((2, DIM)))  # no table
        with pytest.raises(RuntimeError, match="async push failed"):
            fw.client_flush()
        fw.client_flush()
    finally:
        fw.stop_server()


def test_save_persistables_writes_an_empty_state(tmp_path):
    """ROADMAP C39: `fleet.save_persistables` writes an empty state and
    not the tables, in both packages (the JAX package's
    `fleet_base.py:195-201`)."""
    for name, fl, io in (("jax", jfleet, J), ("port", tfleet, T)):
        d = str(tmp_path / name)
        fl.fleet.save_persistables(None, d)
        files = os.listdir(d)
        assert files == ["fleet_persistables.pdparams"], files
        assert dict(io.load(os.path.join(d, files[0]))) == {}


_BUILD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("native", sys.argv[1])
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
m._compile("ps_core.cc", m.Path(sys.argv[2]))
"""


def test_native_build_is_race_free_and_a_failure_raises(tmp_path,
                                                        monkeypatch):
    """Four processes building the table core into one path at once (as
    xdist workers do) leave one loadable library; a source that does not
    compile raises, and nothing else is loaded in its place."""
    import ctypes
    import subprocess
    import sys
    from paddle_tpu_torch.framework import native
    out = str(tmp_path / "ps_core-test.so")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD,
                               native.__file__, out]) for _ in range(4)]
    assert [p.wait(120) for p in procs] == [0] * 4
    assert sorted(os.listdir(tmp_path)) == ["ps_core-test.so"]
    lib = ctypes.CDLL(out)
    assert hasattr(lib, "sparse_table_create")
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "ps_core.cc").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSRC", tmp_path / "src")
    with pytest.raises(RuntimeError, match="failed on ps_core.cc"):
        native._compile("ps_core.cc", tmp_path / "broken.so")
    assert not (tmp_path / "broken.so").exists()
