"""paddle_tpu_torch.text held to paddle_tpu.text.

- The seven datasets (`Imdb`, `Imikolov`, `UCIHousing`, `WMT14`,
  `WMT16`, `Conll05st`, `Movielens`) in train and test mode: the same
  length and the same items, bit for bit (seeded synthetic corpora in
  both; `Imdb` warns alike), and they batch through `io.DataLoader`.
- `viterbi_decode` / `ViterbiDecoder` on float32 potentials of lengths
  1, 2 and 7, with ties: the score within 1e-6 (the same max-plus
  recursion, float32) and the path equal, including the reference's
  path layout (ROADMAP C28), on CPU tensors; the result stays on the
  potentials' device.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import text as jtext
from paddle_tpu_torch import io
from paddle_tpu_torch import text as ttext

NAMES = ["Imdb", "Imikolov", "UCIHousing", "WMT14", "WMT16", "Conll05st",
         "Movielens"]


def test_same_names():
    assert sorted(jtext.__all__) == sorted(ttext.__all__)


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name", NAMES)
def test_datasets_match_jax(name, mode):
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        j = getattr(jtext, name)(mode=mode)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        t = getattr(ttext, name)(mode=mode)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert len(t) == len(j) > 0
    for i in range(len(j)):
        ti, ji = t[i], j[i]
        assert len(ti) == len(ji)
        for a, b in zip(ti, ji):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_fixed_width_datasets_batch():
    got = next(iter(io.DataLoader(ttext.UCIHousing(), batch_size=4)))
    assert got[0].shape == (4, 13) and got[1].shape == (4, 1)
    got = next(iter(io.DataLoader(ttext.Movielens(), batch_size=4)))
    assert [g.dtype for g in got] == [torch.int64, torch.int64,
                                      torch.float32]


@pytest.mark.parametrize("T", [1, 2, 7])
def test_viterbi_decode_matches_jax(T):
    rng = np.random.RandomState(T)
    pot = rng.randn(3, T, 5).astype(np.float32)
    trans = rng.randn(5, 5).astype(np.float32)
    pot[0] = np.round(pot[0])        # ties in the first row
    trans[:2] = np.round(trans[:2])
    js, jp = jtext.viterbi_decode(paddle.to_tensor(pot),
                                  paddle.to_tensor(trans))
    ts, tp = ttext.viterbi_decode(torch.from_numpy(pot),
                                  torch.from_numpy(trans))
    assert tp.dtype == torch.int64 and tp.shape == (3, T)
    assert ts.device.type == tp.device.type == "cpu"
    np.testing.assert_allclose(ts.numpy(), np.asarray(js.numpy()),
                               rtol=1e-6, atol=1e-6)
    assert np.array_equal(tp.numpy(), np.asarray(jp.numpy()))
    dec = ttext.ViterbiDecoder(torch.from_numpy(trans))
    s2, p2 = dec(torch.from_numpy(pot))
    assert torch.equal(s2, ts) and torch.equal(p2, tp)
