"""SelectedRows: sparse-row gradients (port of
`paddle_tpu.framework.selected_rows`; reference
`paddle/fluid/framework/selected_rows.h`: rows_ + value_ + height_, the
gradient `lookup_table(..., is_sparse=True)` produces and the sparse
optimizer kernels and the parameter server's push consume).

`rows` and `value` are numpy arrays or torch tensors. numpy stays numpy
(the host boundary, as in the JAX package); a torch `value` stays on its
device, so a sparse gradient made on the card never visits the host.
`merge` adds a row's duplicates in their order of occurrence on every
device, as the JAX package's `np.add.at` does: a stable sort of the ids,
then one running sum a row, one occurrence a pass (no atomics, so the
card's sums are the CPU's bit for bit).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["SelectedRows", "rows_of_embedding_grad"]


class SelectedRows:
    """rows: int64 [n] ids; value: float [n, ...] rows; height: vocab."""

    def __init__(self, rows, value, height: int):
        if torch.is_tensor(value):
            self.value = value
            self.rows = torch.as_tensor(rows, dtype=torch.int64,
                                        device=value.device).reshape(-1)
        else:
            self.rows = np.ascontiguousarray(np.asarray(rows, np.int64))
            self.value = np.asarray(value)
        if self.value.shape[0] != self.rows.shape[0]:
            raise ValueError(
                f"rows ({self.rows.shape[0]}) and value "
                f"({self.value.shape[0]}) leading dims differ")
        self.height = int(height)

    def merge(self) -> "SelectedRows":
        """Sum duplicate row ids, rows ascending (reference
        `operators/math/selected_rows_functor.cc` MergeAdd)."""
        if torch.is_tensor(self.value):
            return SelectedRows(*_merge_in_order(self.rows, self.value),
                                self.height)
        uniq, inv = np.unique(self.rows, return_inverse=True)
        out = np.zeros((uniq.size,) + self.value.shape[1:],
                       self.value.dtype)
        np.add.at(out, inv, self.value)
        return SelectedRows(uniq, out, self.height)

    def to_dense(self):
        """The [height, ...] dense tensor (reference SelectedRows::Get /
        the GetTensorFromSelectedRows op), of `value`'s kind."""
        m = self.merge()
        if torch.is_tensor(m.value):
            dense = m.value.new_zeros((self.height,)
                                      + tuple(m.value.shape[1:]))
            dense[m.rows] = m.value
            return dense
        dense = np.zeros((self.height,) + m.value.shape[1:], m.value.dtype)
        dense[m.rows] = m.value
        return dense

    def __repr__(self):
        return (f"SelectedRows(n={self.rows.shape[0]}, height={self.height}, "
                f"dim={tuple(self.value.shape[1:])})")


def _merge_in_order(rows, value):
    """(unique rows ascending, their sums): each sum starts at 0 and adds
    the row's values in their order of occurrence. Pass j adds the j-th
    occurrence of every row that has one; the rows are visited in order
    of falling count, so pass j's rows are a prefix of that order and no
    pass reads back to the host."""
    order = torch.sort(rows, stable=True).indices
    srows, svals = rows[order], value[order]
    uniq, counts = torch.unique_consecutive(srows, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    by_count = torch.sort(counts, descending=True, stable=True).indices
    counts_host = np.sort(counts.cpu().numpy())[::-1]
    out = value.new_zeros((uniq.numel(),) + tuple(value.shape[1:]))
    for j in range(int(counts_host[0]) if counts_host.size else 0):
        live = by_count[:int(np.count_nonzero(counts_host > j))]
        out[live] = out[live] + svals[starts[live] + j]
    return uniq, out


def rows_of_embedding_grad(ids, dout, height: int) -> SelectedRows:
    """The merged sparse gradient of an embedding lookup: ids [any
    shape], dout [ids.shape + (dim,)], the lookup's output cotangent
    (what `lookup_table_grad(is_sparse=True)` emits in the reference)."""
    if torch.is_tensor(dout):
        ids = torch.as_tensor(ids, dtype=torch.int64,
                              device=dout.device).reshape(-1)
        return SelectedRows(ids, dout.reshape(ids.numel(), -1),
                            height).merge()
    ids = np.asarray(ids, np.int64).reshape(-1)
    d = np.asarray(dout)
    return SelectedRows(ids, d.reshape(ids.size, -1), height).merge()
