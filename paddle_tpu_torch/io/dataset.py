"""Datasets (port of `paddle_tpu.io.dataset`; reference
`python/paddle/io/__init__.py`, `fluid/dataloader/dataset.py`)."""
from __future__ import annotations

import bisect
from typing import Iterable, List, Sequence

import numpy as np
import torch

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split"]


class Dataset:
    """Map-style dataset: `__getitem__(i)` and `__len__`."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    """A stream of samples: `__iter__`, no index and no length."""

    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    """Rows of equally long arrays or tensors, kept as numpy arrays on
    the host; item i is the tuple of row i of each."""

    def __init__(self, tensors: Sequence):
        arrays = [t.detach().cpu().numpy() if torch.is_tensor(t)
                  else np.asarray(t) for t in tensors]
        if any(a.shape[0] != arrays[0].shape[0] for a in arrays):
            raise ValueError(
                f"TensorDataset: first dimensions differ: "
                f"{[a.shape[0] for a in arrays]}")
        self.tensors = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """Item i is the concatenation of item i of every dataset (a tuple
    item is spliced in, anything else appended); the length is the
    shortest dataset's."""

    def __init__(self, datasets: List[Dataset]):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, tuple):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)

    def __len__(self):
        return min(len(d) for d in self.datasets)


class ChainDataset(IterableDataset):
    """The iterable datasets one after another."""

    def __init__(self, datasets: List[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    """The map-style datasets end to end; a negative index counts from
    the end."""

    def __init__(self, datasets: Iterable[Dataset]):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    """The items of `dataset` at `indices`, in that order."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Disjoint `Subset`s of the given lengths over one permutation drawn
    from numpy's global generator, as the JAX package draws it (so one
    `np.random.seed` gives both packages the same split); `generator` is
    accepted and not read, as there."""
    total = sum(lengths)
    if total != len(dataset):
        raise ValueError(f"random_split: lengths sum to {total}, the "
                         f"dataset holds {len(dataset)}")
    perm = np.random.permutation(total)
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out
