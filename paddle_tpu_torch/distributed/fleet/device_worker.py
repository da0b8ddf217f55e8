"""Device workers: a training loop over a Dataset stream (port of
`paddle_tpu.distributed.fleet.device_worker`; reference
`paddle/fluid/framework/device_worker.h:148-637`, DownpourWorker in
`downpour_worker.cc`, driven by MultiTrainer / DistMultiTrainer,
`framework/trainer.h:53`, and `executor.cc:152` RunFromDataset).

A worker here is the host loop that feeds one device step: per batch it
pulls the touched sparse rows through FleetWrapper, runs the dense
forward and backward on the card (`ps.host_embedding.
make_host_embedding_step`) and pushes the row gradients, asynchronously
by default, for the table to apply its rule. HogwildWorker is
`static.Executor.train_from_dataset`.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["DownpourWorker"]


class _PsTableView:
    """FleetWrapper's pull and push under the interface
    `make_host_embedding_step` programs against (`HostEmbedding`'s), so
    the device step is written once."""

    def __init__(self, fw, table_id: int, dim: int, async_push: bool):
        self.fw = fw
        self.tid = table_id
        self.dim = dim
        self.async_push = async_push

    def pull_dedup(self, ids):
        ids = np.ascontiguousarray(np.asarray(ids, np.int64)).reshape(-1)
        uniq, inverse = np.unique(ids, return_inverse=True)
        rows = self.fw.pull_sparse_vars_sync(self.tid, uniq,
                                             fea_dim=self.dim)
        return rows, inverse.reshape(-1), uniq

    def push(self, uniq_ids, grads):
        if self.async_push:
            self.fw.push_sparse_vars_async(self.tid, uniq_ids, grads)
        else:
            self.fw._client.push_sparse(
                self.tid, np.asarray(uniq_ids, np.int64),
                np.asarray(grads, np.float32))


class DownpourWorker:
    """Train a dense head over sparse embeddings held by the servers.

    dense_layer(emb_flat, *batch_rest) -> out; loss_fn(out, batch_rest)
    -> a loss tensor. Batches yield (ids, *rest). The dense parameters
    train on `device` (the card unless the caller names the CPU) through
    `optimizer`; the sparse rows train on the servers (asynchronous push
    by default, as the reference's Downpour push queue)."""

    def __init__(self, fleet_wrapper, sparse_table_id: int, fea_dim: int,
                 dense_layer, optimizer, loss_fn: Callable,
                 async_push: bool = True, device=None):
        from ..ps.host_embedding import make_host_embedding_step
        self.fw = fleet_wrapper
        self._view = _PsTableView(fleet_wrapper, sparse_table_id, fea_dim,
                                  async_push)
        self._step = make_host_embedding_step(dense_layer, optimizer,
                                              loss_fn, self._view,
                                              device=device)

    @property
    def timings(self):
        """Each step's split in ms (`make_host_embedding_step`)."""
        return self._step.timings

    def train_one_batch(self, ids, *data) -> float:
        return self._step(ids, *data)

    def train_from_dataset(self, dataset, epochs: int = 1,
                           flush_every: Optional[int] = None):
        """reference Executor::RunFromDataset + DownpourWorker::TrainFiles:
        `dataset` yields (ids, *rest) batches; returns the losses."""
        losses = []
        for _ in range(epochs):
            for i, batch in enumerate(dataset):
                losses.append(self.train_one_batch(*batch))
                if flush_every and (i + 1) % flush_every == 0:
                    self.fw.client_flush()
        self.fw.client_flush()
        return losses
