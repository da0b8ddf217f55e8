"""The port's host-embedding step (`paddle_tpu_torch.distributed.ps.
make_host_embedding_step`) and sparse-row gradients
(`framework.selected_rows`, `Optimizer.apply_selected_rows`) held to the
JAX package's on the CPU:
- the step over a seeded native table with the JAX head's weights
  carried in: losses within rtol 1e-5, the table's rows after 6 steps
  within 1e-6 x max, for the sgd table with SGD on the head and the adam
  table with Adam;
- a batch of one id repeated applies one summed update (the JAX
  package's `tests/test_host_embedding.py:96-114`), equal to the JAX
  step's row;
- SelectedRows' merge / to_dense on numpy and on torch tensors, and
  `apply_selected_rows` for every row-wise-safe optimizer against the
  JAX package's (1e-6 x max(1, |ref|)), untouched rows and accumulators
  bit-unchanged; Lamb and LarsMomentum raise in both packages.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.framework.selected_rows import SelectedRows as JRows
from paddle_tpu_torch.framework.selected_rows import (SelectedRows as TRows,
                                                      rows_of_embedding_grad)

from torch_ps_parity import (B, DIM, PS, SEQ, VOCAB, batches, heads,
                             losses, on_the_cpu)  # noqa: F401

CASES = {"sgd": ("sgd", "SGD", 0.05), "adam": ("adam", "Adam", 1e-2)}


def _train(pkg, head, rule, opt_name, lr, data, seed=3):
    ps = PS[pkg]
    mod = J if pkg == "jax" else T
    host = ps.HostEmbedding(DIM, rule=rule, lr=lr, seed=seed)
    opt = getattr(mod.optimizer, opt_name)(lr, parameters=head.parameters())
    kw = {} if pkg == "jax" else {"device": "cpu"}
    step = ps.make_host_embedding_step(head, opt, losses(mod), host, **kw)
    ls = [step(ids, labels) for ids, labels in data]
    return ls, host.table.pull(np.arange(VOCAB)), step


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_jax(case):
    rule, opt_name, lr = CASES[case]
    jh, th = heads(7)
    data = batches(3) * 2
    jl, jrows, _ = _train("jax", jh, rule, opt_name, lr, data)
    tl, trows, step = _train("port", th, rule, opt_name, lr, data)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(trows, jrows, rtol=0,
                               atol=1e-6 * np.abs(jrows).max())
    assert np.mean(tl[3:]) < np.mean(tl[:3])
    assert step.state["n"] == 6 and len(step.timings) == 6
    t = step.timings[-1]
    assert t["uniq"] == np.unique(data[-1][0]).size
    assert set(t) >= {"pull", "h2d", "device", "d2h", "push", "wall"}


def test_one_id_repeated_applies_one_summed_update():
    """All B x SEQ ids equal: one row in the table, moved once by the sum
    of the batch's gradients, as the JAX step moves it."""
    got = {}
    for pkg, head in zip(("jax", "port"), heads(5)):
        ps = PS[pkg]
        mod = J if pkg == "jax" else T
        host = ps.HostEmbedding(DIM, rule="sgd", lr=1.0, seed=5)
        opt = mod.optimizer.SGD(0.0, parameters=head.parameters())
        kw = {} if pkg == "jax" else {"device": "cpu"}
        step = ps.make_host_embedding_step(
            head, opt, lambda out, data: (out * out).mean(), host, **kw)
        before = host.table.pull(np.array([3])).copy()
        step(np.full((B, SEQ), 3, np.int64), np.zeros(B, np.int64))
        assert len(host) == 1
        got[pkg] = (before, host.table.pull(np.array([3])))
    assert not np.allclose(got["port"][0], got["port"][1])
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    np.testing.assert_allclose(got["port"][1], got["jax"][1], rtol=0,
                               atol=1e-6 * np.abs(got["jax"][1]).max())


def test_host_embedding_save_load(tmp_path):
    a = PS["port"].HostEmbedding(DIM, seed=9)
    rows = a.table.pull(np.arange(7))
    p = str(tmp_path / "table.bin")
    a.save(p)
    b = PS["jax"].HostEmbedding(DIM, seed=1)
    b.load(p)
    np.testing.assert_array_equal(b.table.pull(np.arange(7)), rows)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_selected_rows_merge_matches_jax(kind):
    rs = np.random.RandomState(0)
    rows = np.array([3, 1, 3, 7, 1], np.int64)
    value = rs.standard_normal((5, 4)).astype(np.float32)
    j = JRows(rows, value, height=9)
    t = TRows(rows if kind == "numpy" else torch.from_numpy(rows),
              value if kind == "numpy" else torch.from_numpy(value),
              height=9)
    jm, tm = j.merge(), t.merge()
    np.testing.assert_array_equal(np.asarray(tm.rows), jm.rows)
    np.testing.assert_allclose(np.asarray(tm.value), jm.value, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(t.to_dense()), j.to_dense(),
                               rtol=1e-6)
    ids = rs.randint(0, 6, size=(2, 3))
    dout = rs.standard_normal((2, 3, 4)).astype(np.float32)
    from paddle_tpu.framework.selected_rows import rows_of_embedding_grad \
        as jgrad
    want = jgrad(ids, dout, 6)
    got = rows_of_embedding_grad(
        ids, dout if kind == "numpy" else torch.from_numpy(dout), 6)
    np.testing.assert_array_equal(np.asarray(got.rows), want.rows)
    np.testing.assert_allclose(np.asarray(got.value), want.value, rtol=1e-6)
    with pytest.raises(ValueError, match="leading dims"):
        TRows([1, 2], np.zeros((3, 4)), 5)


ROWWISE = ["SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
           "Adadelta", "RMSProp"]


def _jax_apply(name, w0, steps):
    p = J.create_parameter(list(w0.shape), "float32")
    p.set_value(w0.copy())
    opt = getattr(J.optimizer, name)(0.1, parameters=[p])
    for rows, vals in steps:
        opt.apply_selected_rows(p, JRows(rows, vals, height=w0.shape[0]))
    st = {k: np.asarray(v) for k, v in opt._accumulators[id(p)].items()}
    return p.numpy(), st


@pytest.mark.parametrize("name", ROWWISE)
def test_apply_selected_rows_matches_jax(name):
    """Two sparse updates (rows {1, 4, 4} then {4, 2}) of a [6, 3]
    parameter: the port's touched rows within 1e-6 x max(1, |ref|) of
    the JAX package's, untouched rows and accumulator rows bit-unchanged,
    the step count advanced twice."""
    rs = np.random.RandomState(1)
    w0 = rs.standard_normal((6, 3)).astype(np.float32)
    steps = [(np.array([1, 4, 4]), rs.standard_normal((3, 3)).astype(
        np.float32)), (np.array([4, 2]), rs.standard_normal((2, 3)).astype(
            np.float32))]
    jw, jst = _jax_apply(name, w0, steps)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = getattr(T.optimizer, name)(0.1, parameters=[p])
    init = {k: v.clone() for k, v in opt._init_state(p).items()}
    for rows, vals in steps:
        opt.apply_selected_rows(p, TRows(torch.from_numpy(rows),
                                         torch.from_numpy(vals), height=6))
    assert opt._global_step == 2
    tw = p.detach().numpy()
    touched, untouched = [1, 2, 4], [0, 3, 5]
    np.testing.assert_allclose(tw[touched], jw[touched], rtol=0,
                               atol=1e-6 * max(1.0, np.abs(jw).max()))
    np.testing.assert_array_equal(tw[untouched], w0[untouched])
    st = opt._accumulators[id(p)]
    assert set(st) == set(jst)
    for k, v in st.items():
        v = v.numpy()
        np.testing.assert_allclose(v[touched], jst[k][touched], rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(
                                       jst[k]).max()), err_msg=k)
        np.testing.assert_array_equal(v[untouched],
                                      init[k].numpy()[untouched])


@pytest.mark.parametrize("name", ["Lamb", "LarsMomentum"])
def test_trust_ratio_rules_refuse_rows(name):
    p = torch.nn.Parameter(torch.zeros(4, 2))
    opt = getattr(T.optimizer, name)(0.1, parameters=[p])
    with pytest.raises(NotImplementedError, match="trust-ratio"):
        opt.apply_selected_rows(p, TRows([1], np.ones((1, 2)), 4))
    jp = J.create_parameter([4, 2], "float32")
    jopt = getattr(J.optimizer, name)(0.1, parameters=[jp])
    with pytest.raises(NotImplementedError, match="trust-ratio"):
        jopt.apply_selected_rows(jp, JRows([1], np.ones((1, 2)), 4))


def test_advance_step_false_keeps_the_count():
    p = torch.nn.Parameter(torch.zeros(4, 2))
    opt = T.optimizer.Adam(0.1, parameters=[p])
    opt.apply_selected_rows(p, TRows([1], np.ones((1, 2), np.float32), 4),
                            advance_step=False)
    assert opt._global_step == 0
    with pytest.raises(ValueError, match="height"):
        opt.apply_selected_rows(p, TRows([1], np.ones((1, 2)), 5))
