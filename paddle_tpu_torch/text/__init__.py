"""paddle.text (port of `paddle_tpu.text`; reference
`python/paddle/text/`): the datasets Imdb, Imikolov, Conll05st,
Movielens, UCIHousing, WMT14 and WMT16, and Viterbi decoding.

Nothing is downloaded. The datasets are the JAX package's seeded
synthetic corpora, of the same shapes and types (it reads no local file
either: `Imdb` only warns when `data_file` is absent), as numpy arrays.
`viterbi_decode` runs in torch on the potentials' device."""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ..io import Dataset

__all__ = ["Imdb", "Imikolov", "UCIHousing", "WMT14", "WMT16", "Conll05st",
           "Movielens", "ViterbiDecoder", "viterbi_decode"]


def _synth_text(n, vocab, seq_len, seed, with_label=True, n_classes=2):
    rng = np.random.RandomState(seed)
    docs = [rng.randint(1, vocab, size=rng.randint(5, seq_len)).astype(
        "int64") for _ in range(n)]
    labels = rng.randint(0, n_classes, n).astype("int64")
    return docs, labels


class Imdb(Dataset):
    def __init__(self, data_file=None, mode="train", cutoff=150,
                 download=True):
        warnings.warn("Imdb: synthetic fallback (offline env)") \
            if not (data_file and os.path.exists(data_file)) else None
        self.docs, self.labels = _synth_text(
            512 if mode == "train" else 128, 5000, 100,
            seed=50 if mode == "train" else 51)

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50, download=True):
        self.window = window_size
        rng = np.random.RandomState(60)
        n = 1024 if mode == "train" else 256
        self.data = rng.randint(0, 2000, size=(n, window_size)).astype(
            "int64")

    def __getitem__(self, idx):
        row = self.data[idx]
        return tuple(row[:-1]) + (row[-1:],)

    def __len__(self):
        return len(self.data)


class UCIHousing(Dataset):
    def __init__(self, data_file=None, mode="train", download=True):
        rng = np.random.RandomState(70)
        n = 404 if mode == "train" else 102
        self.x = rng.randn(n, 13).astype("float32")
        w = rng.randn(13).astype("float32")
        self.y = (self.x @ w + 0.1 * rng.randn(n)).astype(
            "float32").reshape(-1, 1)

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx]

    def __len__(self):
        return len(self.x)


class _MTBase(Dataset):
    def __init__(self, mode="train", src_vocab=1000, tgt_vocab=1000,
                 seed=80):
        rng = np.random.RandomState(seed)
        n = 512 if mode == "train" else 64
        self.src = [rng.randint(2, src_vocab, size=rng.randint(4, 20))
                    .astype("int64") for _ in range(n)]
        self.tgt = [rng.randint(2, tgt_vocab, size=rng.randint(4, 20))
                    .astype("int64") for _ in range(n)]

    def __getitem__(self, idx):
        t = self.tgt[idx]
        return self.src[idx], t[:-1], t[1:]

    def __len__(self):
        return len(self.src)


class WMT14(_MTBase):
    def __init__(self, data_file=None, mode="train", dict_size=1000,
                 download=True):
        super().__init__(mode, dict_size, dict_size, 81)


class WMT16(_MTBase):
    def __init__(self, data_file=None, mode="train", src_dict_size=1000,
                 trg_dict_size=1000, lang="en", download=True):
        super().__init__(mode, src_dict_size, trg_dict_size, 82)


class Conll05st(Dataset):
    def __init__(self, data_file=None, mode="train", download=True, **kw):
        rng = np.random.RandomState(90)
        n = 256
        self.sents = [rng.randint(0, 500, size=rng.randint(5, 30)).astype(
            "int64") for _ in range(n)]
        self.labels = [rng.randint(0, 20, size=len(s)).astype("int64")
                       for s in self.sents]

    def __getitem__(self, idx):
        return self.sents[idx], self.labels[idx]

    def __len__(self):
        return len(self.sents)


class Movielens(Dataset):
    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0, download=True):
        rng = np.random.RandomState(95)
        n = 1024 if mode == "train" else 128
        self.users = rng.randint(0, 500, n).astype("int64")
        self.items = rng.randint(0, 1000, n).astype("int64")
        self.ratings = rng.randint(1, 6, n).astype("float32")

    def __getitem__(self, idx):
        return self.users[idx], self.items[idx], self.ratings[idx]

    def __len__(self):
        return len(self.users)


def viterbi_decode(potentials, transition_params, lengths=None,
                   include_bos_eos_tag=True):
    """Viterbi decoding of `potentials` [B, T, N] under
    `transition_params` [N, N] (reference `text/viterbi_decode.py`):
    (best score [B], path [B, T] int64), on the potentials' device.
    `lengths` and `include_bos_eos_tag` are accepted and not read, as in
    the JAX package; ties go to the lowest tag, as `jnp.argmax` breaks
    them. The path is the JAX package's: the best tags of positions 1 to
    T - 1, then the last one again (its backtrack emits each step's tag
    one position early and drops position 0's; ROADMAP C28)."""
    pot = torch.as_tensor(potentials)
    trans = torch.as_tensor(transition_params, device=pot.device)
    score = pot[:, 0]
    backptrs = []
    for t in range(1, pot.shape[1]):
        cand = score[:, :, None] + trans[None] + pot[:, t, None, :]
        score, idx = cand.max(dim=1)
        backptrs.append(idx)
    last = score.argmax(dim=-1)
    tags = [last]   # the best tags, last position first
    for bp in reversed(backptrs):
        tags.append(bp.gather(1, tags[-1][:, None])[:, 0])
    tags = tags[::-1]
    path = torch.stack(tags[1:] + [last], dim=1)
    return score.max(dim=-1).values, path.to(torch.int64)


class ViterbiDecoder:
    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        self.transitions = transitions

    def __call__(self, potentials, lengths=None):
        return viterbi_decode(potentials, self.transitions, lengths)
