"""Datasets (port of `paddle_tpu.io.dataset`; reference
`python/paddle/io/__init__.py`, `fluid/dataloader/dataset.py`)."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["Dataset", "TensorDataset"]


class Dataset:
    """Map-style dataset: `__getitem__(i)` and `__len__`."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


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
