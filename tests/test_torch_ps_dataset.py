"""The port's slot datasets (`paddle_tpu_torch.distributed.fleet.
{InMemoryDataset, QueueDataset, MultiSlotDataGenerator}`) held to the JAX
package's on the CPU, over slot files written from numpy-seeded records:
- both generators write the same bytes;
- the padded per-slot batches of both packages' InMemoryDataset and
  QueueDataset are bit-equal, and so are they after `local_shuffle`
  under the same `random.seed`;
- ROADMAP C40: the shuffles draw from Python's global `random`, unseeded
  by the datasets, and `global_shuffle` is the local shuffle;
- a static Program trained by `Executor.train_from_dataset` over each
  package's dataset: losses within rtol 1e-5.
"""
import random

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu import static as jst
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu_torch import static as tst
from paddle_tpu_torch.distributed import fleet as tfleet

from torch_static_parity import (copy_scope, on_the_cpu,  # noqa: F401
                                 port_exe, static_both)

FLEET = {"jax": jfleet, "port": tfleet}
SLOTS = [("a_dense", "float32"), ("b_ids", "int64"), ("c_label", "float32")]


def _records(n=37, seed=0):
    rs = np.random.RandomState(seed)
    return [[("a_dense", [round(float(v), 4) for v in rs.standard_normal(4)]),
             ("b_ids", [int(v) for v in rs.randint(0, 1000,
                                                   size=rs.randint(1, 6))]),
             ("c_label", [float(rs.randint(0, 2))])] for _ in range(n)]


def _write(pkg, tmp_path, records, name):
    class Gen(FLEET[pkg].MultiSlotDataGenerator):
        def generate_sample(self, line):
            def it():
                yield records[int(line)]
            return it
    src = tmp_path / f"{name}.idx"
    src.write_text("".join(f"{i}\n" for i in range(len(records))))
    out = tmp_path / f"{pkg}_{name}.txt"
    Gen().run_from_files([str(src)], str(out))
    return str(out)


@pytest.fixture
def slot_files(tmp_path):
    files = {}
    for pkg in FLEET:
        files[pkg] = [_write(pkg, tmp_path, _records(37, s), f"part{s}")
                      for s in (0, 1)]
    return files


def _dataset(pkg, files, cls="InMemoryDataset", batch=8):
    ds = getattr(FLEET[pkg], cls)()
    ds.init(batch_size=batch, use_var=SLOTS)
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds


def _assert_same(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y) == len(SLOTS)
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


def test_generators_write_the_same_bytes(slot_files):
    for t, j in zip(slot_files["port"], slot_files["jax"]):
        assert open(t, "rb").read() == open(j, "rb").read()


@pytest.mark.parametrize("cls", ["InMemoryDataset", "QueueDataset"])
def test_batches_bit_equal(slot_files, cls):
    t = _dataset("port", slot_files["port"], cls)
    j = _dataset("jax", slot_files["jax"], cls)
    _assert_same(t, j)
    if cls == "InMemoryDataset":
        assert t.get_memory_data_size() == j.get_memory_data_size() == 74
        first = next(iter(t))
        assert first[1].shape == (8, max(len(r[1][1])
                                         for r in _records(37, 0)[:8]))


@pytest.mark.parametrize("shuffle", ["local_shuffle", "global_shuffle"])
def test_shuffle_matches_jax_under_one_seed(slot_files, shuffle):
    """C40: the same `random.seed` gives the JAX package's order, for
    `global_shuffle` too (it is the local shuffle); without a seed the
    datasets draw from the global `random`'s state as they find it."""
    t = _dataset("port", slot_files["port"])
    j = _dataset("jax", slot_files["jax"])
    random.seed(3)
    getattr(t, shuffle)()
    random.seed(3)
    getattr(j, shuffle)()
    _assert_same(t, j)
    random.seed(3)
    j.release_memory()
    j = _dataset("jax", slot_files["jax"])
    j.local_shuffle()
    _assert_same(t, j)          # global == local under the same draw
    t.local_shuffle()           # the generator moved on: another order
    assert [b[0].tobytes() for b in t] != [b[0].tobytes() for b in j]


def _program(P, st):
    main, startup = st.Program(), st.Program()
    with st.program_guard(main, startup):
        x = st.data("a_dense", [None, 4], "float32")
        ids = st.data("b_ids", [None, 5], "int64")
        y = st.data("c_label", [None, 1], "float32")
        h = st.nn.fc(x, 8, activation="relu")
        pred = st.nn.fc(h, 1)
        loss = P.mean((pred - y) ** 2) + 0.0 * P.mean(
            P.cast(ids, "float32"))
        P.optimizer.SGD(0.05).minimize(loss)
    return main, startup, loss


def test_train_from_dataset_matches_jax(slot_files):
    """`Executor.train_from_dataset` takes the dataset's batches as they
    are (sorted feed names = the slots' order), in both packages, from
    the same weights: losses within rtol 1e-5."""
    with static_both():
        jm, js, jl = _program(J, jst)
        tm, ts, tl = _program(T, tst)
        copy_scope(jm, tm)
        je, te = jst.Executor(), port_exe()
        je.run(js)
        te.run(ts)
        jds = _dataset("jax", slot_files["jax"])
        tds = _dataset("port", slot_files["port"])
        # b_ids pads to each batch's longest record: take batches of one
        # width so both Programs see a fixed feed shape
        keep = [i for i, b in enumerate(tds) if b[1].shape[1] == 5]
        jb = [b for i, b in enumerate(jds) if i in keep]
        tb = [b for i, b in enumerate(tds) if i in keep]
        assert len(keep) >= 3
        jr = je.train_from_dataset(jm, jb * 3, fetch_list=[jl])
        tr = te.train_from_dataset(tm, tb * 3, fetch_list=[tl])
    jls = [float(np.asarray(r[0])) for r in jr]
    tls = [float(np.asarray(r[0])) for r in tr]
    np.testing.assert_allclose(tls, jls, rtol=1e-5)
    assert np.mean(tls[-len(keep):]) < np.mean(tls[:len(keep)])
