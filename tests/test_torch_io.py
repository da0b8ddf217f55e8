"""paddle_tpu_torch.io held to paddle_tpu.io on the same numpy data.

The single-process DataLoader yields the same batches, values and types
(float64 narrowed to float32) as the JAX package's for sequential
sampling, with and without `drop_last`, over tuples and dicts. Random
sampling cannot share the JAX package's order (another generator), so
it is held to its own contract: each epoch is a permutation of every
index, `framework.random.seed` fixes it, and `set_epoch` changes it."""
import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.framework import random as trandom


def _jnp(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


@pytest.mark.parametrize("n,batch,drop_last", [(10, 4, False), (10, 4, True),
                                               (8, 4, False), (3, 5, False)])
def test_sequential_batches_match_jax(n, batch, drop_last):
    rng = np.random.RandomState(n + batch)
    x = rng.standard_normal((n, 3))              # float64 -> float32
    y = rng.randint(0, 7, size=(n,)).astype(np.int64)
    want = list(jio.DataLoader(jio.TensorDataset([x, y]), batch_size=batch,
                               shuffle=False, drop_last=drop_last))
    loader = tio.DataLoader(tio.TensorDataset([x, torch.from_numpy(y)]),
                            batch_size=batch, shuffle=False,
                            drop_last=drop_last)
    got = list(loader)
    assert len(got) == len(want) == len(loader)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == torch.float32 and gy.dtype == torch.int64
        np.testing.assert_array_equal(gx.numpy(), _jnp(wx))
        np.testing.assert_array_equal(gy.numpy(), _jnp(wy))


class _DictSet(tio.Dataset):
    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        return {"ids": np.arange(4) + i, "w": float(i)}

    def __len__(self):
        return self.n


def test_dict_samples_collate_like_jax():
    class J(jio.Dataset):
        __getitem__ = _DictSet.__getitem__
        __len__ = _DictSet.__len__
        __init__ = _DictSet.__init__
    want = list(jio.DataLoader(J(5), batch_size=2))
    got = list(tio.DataLoader(_DictSet(5), batch_size=2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == {"ids", "w"}
        for k in g:
            np.testing.assert_array_equal(g[k].numpy(), _jnp(w[k]))
        assert g["w"].dtype == torch.float32


def test_random_sampler_is_seeded_and_reshuffles_per_epoch():
    data = tio.TensorDataset([np.arange(50)])

    def epochs(seed):
        trandom.seed(seed)
        bs = tio.BatchSampler(data, shuffle=True, batch_size=8)
        out = []
        for e in range(2):
            bs.set_epoch(e)
            out.append([i for b in bs for i in b])
        return out

    a, b = epochs(3), epochs(3)
    assert a == b                                 # the seed fixes the order
    assert sorted(a[0]) == sorted(a[1]) == list(range(50))
    assert a[0] != a[1]                           # each epoch reshuffles
    assert epochs(4)[0] != a[0]


def test_tensor_dataset_rejects_unequal_lengths():
    with pytest.raises(ValueError):
        tio.TensorDataset([np.zeros((3, 2)), np.zeros((4,))])
