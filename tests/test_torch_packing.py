"""paddle_tpu_torch `io.PackingCollator` held to paddle_tpu's, array for
array, on the same samples: first-fit layout, the pad policy, truncation
and drop (counters and one warning), the cumulative fill counter,
`suggest_rows`, the errors, and packs through the port's DataLoader."""
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu.framework.monitor import stat_get as jstat_get
from paddle_tpu.io import PackingCollator as JCollator
from paddle_tpu.io import suggest_rows as jsuggest_rows
from paddle_tpu_torch import io
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.io.packing import _fields_of

COUNTERS = ("STAT_packing_packs", "STAT_packing_sequences",
            "STAT_packing_tokens", "STAT_packing_slots",
            "STAT_packing_fill_ratio_pct", "STAT_packing_dropped_seqs",
            "STAT_packing_truncated_seqs")


def _seqs(n, seed, T=64, fields=2):
    rng = np.random.RandomState(seed)
    lengths = np.clip(np.round(np.exp(rng.normal(2.3, 0.9, n))).astype(int),
                      1, 2 * T)
    return [tuple(rng.randint(0, 100, (L,)).astype("int64")
                  for _ in range(fields)) for L in lengths]


def _same_packs(tcoll, jcoll, batch):
    """Both collators on `batch`: equal arrays, dtypes, fill ratios and
    counter deltas."""
    t0 = {c: monitor.stat_get(c) for c in COUNTERS}
    j0 = {c: jstat_get(c) for c in COUNTERS}
    got, want = tcoll(batch), jcoll(batch)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tcoll.last_fill_ratio == jcoll.last_fill_ratio
    for c in COUNTERS:
        assert monitor.stat_get(c) - t0[c] == jstat_get(c) - j0[c], c
    return got


@pytest.mark.parametrize("policy", ["first_fit", "pad"])
@pytest.mark.parametrize("fields", [1, 2, 3])
def test_packs_equal_jax(policy, fields):
    seqs = _seqs(12, seed=fields, fields=fields)
    rows = 12 if policy == "pad" else 5
    batch = [s[0] if fields == 1 else s for s in seqs]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        packs = _same_packs(io.PackingCollator(64, rows, policy=policy),
                            JCollator(64, rows, policy=policy), batch)
    seg = packs[1]
    assert (np.diff(seg, axis=1) >= 0).all()     # the splash contract
    assert len(packs) == fields + 3


def test_first_fit_layout():
    samples = [(np.arange(10, dtype=np.int64),
                np.arange(10, dtype=np.int64) + 100),
               (np.arange(20, dtype=np.int64),
                np.arange(20, dtype=np.int64) + 100),
               (np.arange(6, dtype=np.int64),
                np.arange(6, dtype=np.int64) + 100)]
    coll = io.PackingCollator(max_tokens=32, rows=2)
    toks, seg, pos, labels, mask = _same_packs(coll, JCollator(32, 2),
                                               samples)
    np.testing.assert_array_equal(toks[0, 10:30], np.arange(20))
    np.testing.assert_array_equal(seg[0, 30:], 2)   # one trailing pad id
    np.testing.assert_array_equal(pos[0, 10:30], np.arange(20))
    assert mask.sum() == 36 and coll.last_fill_ratio == 36 / 64.0
    assert coll.emits_token_mask


def test_truncate_and_drop_counters_and_one_warning():
    long = np.arange(40, dtype=np.int64)
    batch = [long, np.arange(10, dtype=np.int64), np.arange(12,
                                                            dtype=np.int64)]
    coll = io.PackingCollator(max_tokens=16, rows=1)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        d0 = monitor.stat_get("STAT_packing_dropped_seqs")
        t0 = monitor.stat_get("STAT_packing_truncated_seqs")
        toks, seg, pos, mask = _same_packs(coll, JCollator(16, 1), batch)
        assert monitor.stat_get("STAT_packing_truncated_seqs") == t0 + 1
        assert monitor.stat_get("STAT_packing_dropped_seqs") == d0 + 2
        coll(batch)
    # one warning from each package's collator, not one per drop or call
    assert len([x for x in w if "dropped" in str(x.message)]) == 2
    np.testing.assert_array_equal(toks[0], np.arange(16))
    assert mask.sum() == 16


def test_cumulative_fill_counter():
    p0 = monitor.stat_get("STAT_packing_packs")
    f0 = monitor.stat_get("STAT_packing_fill_ratio_pct")
    coll = io.PackingCollator(16, rows=1)
    coll([np.arange(8, dtype=np.int64)])
    coll([np.arange(16, dtype=np.int64)])
    assert monitor.stat_get("STAT_packing_packs") == p0 + 2
    assert monitor.stat_get("STAT_packing_fill_ratio_pct") == f0 + 150


@pytest.mark.parametrize("headroom", [1.0, 1.1, 1.15, 1.6])
def test_suggest_rows_equal_jax(headroom):
    for lengths, bs, T in (([8, 8, 8, 8], 4, 16), ([100], 1, 16),
                           (list(range(3, 900, 7)), 64, 1024)):
        assert io.suggest_rows(lengths, bs, T, headroom) == \
            jsuggest_rows(lengths, bs, T, headroom)
    assert io.suggest_rows([8, 8, 8, 8], batch_size=4, max_tokens=16) == 3


def test_errors():
    with pytest.raises(ValueError, match="policy"):
        io.PackingCollator(16, 2, policy="best_fit")
    with pytest.raises(ValueError, match="positive"):
        io.PackingCollator(0, 2)
    with pytest.raises(ValueError, match="equal length"):
        _fields_of((np.arange(4), np.arange(5)))
    with pytest.raises(ValueError, match="empty batch"):
        io.PackingCollator(16, 2)([])


def test_packs_through_the_dataloader():
    """As a DataLoader collate_fn: CPU tensors of the collator's dtypes,
    one pack per batch, a partial last pack the same shape."""
    seqs = _seqs(10, seed=8)

    class Data(io.Dataset):
        def __len__(self):
            return len(seqs)

        def __getitem__(self, i):
            return seqs[i]
    coll = io.PackingCollator(64, 4)
    loader = io.DataLoader(Data(), batch_size=4, collate_fn=coll)
    batches = list(loader)
    assert len(batches) == 3 and loader.collate_fn.emits_token_mask
    for b, i in zip(batches, (0, 4, 8)):
        assert [t.dtype for t in b] == [torch.int64, torch.int32,
                                        torch.int32, torch.int64,
                                        torch.float32]
        assert all(tuple(t.shape) == (4, 64) for t in b)
        want = JCollator(64, 4)(seqs[i:i + 4])
        for a, w in zip(b, want):
            np.testing.assert_array_equal(a.numpy(), w)
