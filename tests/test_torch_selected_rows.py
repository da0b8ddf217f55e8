"""SelectedRows.merge adds a row's duplicates in their order of
occurrence, as the JAX package's `np.add.at` merge does, on every device.

On the CPU: float32 rows whose ids repeat many times (Zipf-distributed,
values spread over 16 binades, so that the order of the additions shows
in the bits) merge bit for bit as `np.unique` + `np.add.at` merge them:
the same rows ascending, the same sums. `to_dense`, the optimizers'
sparse update (`apply_selected_rows`, SGD) and `rows_of_embedding_grad`
inherit it. The `chip` test holds a CUDA tensor's merge to the same
numpy merge bit for bit (it skips without a card; on the card run it with
`python -m pytest --noconftest -m chip tests/test_torch_selected_rows.py`).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import optimizer
from paddle_tpu_torch.framework.selected_rows import (SelectedRows,
                                                       rows_of_embedding_grad)


def _rows(seed, n=6000, height=500, dim=7):
    rng = np.random.RandomState(seed)
    ids = (rng.zipf(1.3, n) % height).astype(np.int64)
    vals = (rng.standard_normal((n, dim))
            * np.exp2(rng.randint(-8, 8, (n, 1)))).astype(np.float32)
    return ids, vals, height


def _numpy_merge(ids, vals):
    uniq, inv = np.unique(ids, return_inverse=True)
    out = np.zeros((uniq.size,) + vals.shape[1:], vals.dtype)
    np.add.at(out, inv, vals)
    return uniq, out


def _held(device, seed):
    ids, vals, height = _rows(seed)
    m = SelectedRows(torch.from_numpy(ids).to(device),
                     torch.from_numpy(vals).to(device), height).merge()
    uniq, out = _numpy_merge(ids, vals)
    assert m.rows.device.type == torch.device(device).type
    assert int(np.bincount(ids).max()) > 100     # many duplicates
    np.testing.assert_array_equal(m.rows.cpu().numpy(), uniq)
    np.testing.assert_array_equal(m.value.cpu().numpy(), out)
    return ids, vals, height, uniq, out


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_is_numpy_add_at_bit_for_bit(seed):
    ids, vals, height, uniq, out = _held("cpu", seed)
    dense = SelectedRows(torch.from_numpy(ids), torch.from_numpy(vals),
                         height).to_dense()
    want = np.zeros((height, vals.shape[1]), np.float32)
    want[uniq] = out
    np.testing.assert_array_equal(dense.numpy(), want)
    g = rows_of_embedding_grad(torch.from_numpy(ids.reshape(60, 100)),
                               torch.from_numpy(vals.reshape(60, 100, -1)),
                               height)
    np.testing.assert_array_equal(g.value.numpy(), out)


def test_sparse_update_uses_the_ordered_merge():
    ids, vals, height = _rows(2)
    w0 = np.random.RandomState(3).standard_normal(
        (height, vals.shape[1])).astype(np.float32)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    optimizer.SGD(0.5, parameters=[p]).apply_selected_rows(
        p, SelectedRows(torch.from_numpy(ids), torch.from_numpy(vals),
                        height))
    uniq, out = _numpy_merge(ids, vals)
    want = w0.copy()
    want[uniq] = (torch.from_numpy(w0[uniq])
                  - 0.5 * torch.from_numpy(out)).numpy()
    np.testing.assert_array_equal(p.detach().numpy(), want)


def test_empty_and_unique_rows():
    m = SelectedRows(torch.zeros(0, dtype=torch.int64), torch.zeros(0, 3),
                     4).merge()
    assert m.rows.numel() == 0 and tuple(m.value.shape) == (0, 3)
    v = torch.arange(6.0).reshape(3, 2)
    m = SelectedRows(torch.tensor([2, 0, 1]), v, 4).merge()
    assert m.rows.tolist() == [0, 1, 2]
    assert torch.equal(m.value, v[[1, 2, 0]])


@pytest.mark.chip
def test_merge_on_the_card_is_numpy_add_at_bit_for_bit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's merge runs there")
    for seed in (0, 1):
        _held("cuda", seed)
