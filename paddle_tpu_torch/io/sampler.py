"""Samplers (port of `paddle_tpu.io.sampler`; reference
`fluid/dataloader/batch_sampler.py`).

`RandomSampler` draws its base seed from `framework.random` when it is
built, so `framework.random.seed(s)` fixes every epoch's order; epoch e
permutes with base + e (`set_epoch`, which `hapi.Model.fit` calls
through `BatchSampler.set_epoch` at each epoch's start). With
`num_samples`, an epoch is the first `num_samples` of that permutation;
with `replacement`, it is `num_samples` draws from numpy's global
generator, as the JAX package draws them, and so is every
`WeightedRandomSampler` epoch: one `np.random.seed` gives both packages
the same indices there. `generator` is accepted and not read, as in the
JAX package.

`DistributedBatchSampler` shards the index stream over the data-parallel
ranks as the JAX package's does: the epoch's indices (a permutation
seeded by the epoch when shuffled) padded to a multiple of the ranks by
repeating the first ones, rank r taking every n-th from r."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework import random as frandom

__all__ = ["Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler"]


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A permutation of the whole data source, one per epoch."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self._base_seed = frandom.next_seed("cpu")
        self.epoch = 0

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def set_epoch(self, epoch):
        self.epoch = int(epoch)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        g = torch.Generator().manual_seed(self._base_seed + self.epoch)
        return iter(torch.randperm(n, generator=g)[:self.num_samples]
                    .tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    """`num_samples` indices drawn with probabilities proportional to
    `weights` (numpy's global generator, as the JAX package)."""

    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def set_epoch(self, epoch):
        """Forwarded to the sampler, which reshuffles per epoch."""
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Batches of this rank's share of the indices (reference
    `fluid/dataloader/batch_sampler.py:DistributedBatchSampler`); rank
    and rank count default to the process group's."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed.env import get_rank, get_world_size
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = (num_replicas if num_replicas is not None
                       else get_world_size())
        self.local_rank = rank if rank is not None else get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(
                n).tolist()
        else:
            indices = list(range(n))
        indices += indices[:(self.total_size - n)]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
