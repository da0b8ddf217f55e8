"""DataLoader, single-process (port of the `num_workers=0` path of
`paddle_tpu.io.dataloader`; reference `python/paddle/io/reader.py`).

Batches are collated on the host into CPU tensors (float64 narrowed to
float32, as the JAX package does); `hapi.Model` moves each batch to the
model's device. The shared-memory worker ring and the `DeviceFeeder`
prefetch of the JAX package are not ported yet: `num_workers > 0`
raises."""
from __future__ import annotations

import numpy as np
import torch

from .dataset import Dataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn"]


def default_collate_fn(batch):
    """Stack a list of samples (reference
    `fluid/dataloader/collate.py:default_collate_fn`)."""
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        return np.stack(batch)
    if torch.is_tensor(sample):
        return torch.stack(batch)
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn(list(items))
                     for items in zip(*batch))
    return batch


def _to_tensors(collated):
    if isinstance(collated, np.ndarray):
        if collated.dtype == np.float64:
            collated = collated.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(collated))
    if isinstance(collated, dict):
        return {k: _to_tensors(v) for k, v in collated.items()}
    if isinstance(collated, (list, tuple)):
        return type(collated)(_to_tensors(v) for v in collated)
    return collated


class DataLoader:
    def __init__(self, dataset: Dataset, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0):
        if num_workers:
            raise NotImplementedError(
                "DataLoader: worker processes are not ported yet; use "
                "num_workers=0")
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size",
                                      batch_size)
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)
            self.batch_size = batch_size

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self):
        for indices in self.batch_sampler:
            yield _to_tensors(self.collate_fn(
                [self.dataset[i] for i in indices]))
