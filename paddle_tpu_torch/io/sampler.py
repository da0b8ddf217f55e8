"""Samplers (port of `paddle_tpu.io.sampler`; reference
`fluid/dataloader/batch_sampler.py`).

`RandomSampler` draws its base seed from `framework.random` when it is
built, so `framework.random.seed(s)` fixes every epoch's order; epoch e
permutes with base + e (`set_epoch`, which `hapi.Model.fit` calls
through `BatchSampler.set_epoch` at each epoch's start)."""
from __future__ import annotations

import torch

from ..framework import random as frandom

__all__ = ["Sampler", "SequenceSampler", "RandomSampler", "BatchSampler"]


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

    def __init__(self, data_source):
        super().__init__(data_source)
        self._base_seed = frandom.next_seed("cpu")
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = int(epoch)

    def __iter__(self):
        g = torch.Generator().manual_seed(self._base_seed + self.epoch)
        return iter(torch.randperm(len(self.data_source),
                                   generator=g).tolist())


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
