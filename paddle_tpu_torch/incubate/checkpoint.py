"""Auto-checkpoint (port of `paddle_tpu.incubate.checkpoint`; reference
`fluid/incubate/checkpoint/auto_checkpoint.py:265` TrainEpochRange,
`:598` train_epoch_range, `:71` AutoCheckpointChecker): an epoch range
that saves its layers' and optimizers' state after each epoch and, when
made again under the same job and name, resumes after the last saved
epoch. Files are the port's `save` / `load` format (the reference's
pickled numpy), written on the host; the metadata is replaced
atomically, so an interrupted save leaves the previous epoch's."""
from __future__ import annotations

import json
import os

__all__ = ["AutoCheckpointChecker", "TrainEpochRange", "train_epoch_range"]


class AutoCheckpointChecker:
    """The environment's contract (reference :71):
    PADDLE_RUNNING_ENV=PADDLE_EDL_AUTO_CHECKPOINT, PADDLE_JOB_ID and
    PADDLE_EDL_HDFS_CHECKPOINT_PATH (any file-system path here)."""

    def __init__(self):
        self.run_env = os.environ.get("PADDLE_RUNNING_ENV", "")
        self.job_id = os.environ.get("PADDLE_JOB_ID", "default_job")
        self.ckpt_path = os.environ.get(
            "PADDLE_EDL_HDFS_CHECKPOINT_PATH",
            os.environ.get("PADDLE_CHECKPOINT_PATH", "./auto_ckpt"))
        self.save_interval = int(os.environ.get(
            "PADDLE_EDL_SAVE_CHECKPOINT_INTER", "900"))

    def get_job_checkpoint_path(self):
        return os.path.join(self.ckpt_path, self.job_id)

    @property
    def valid(self):
        return self.run_env == "PADDLE_EDL_AUTO_CHECKPOINT" or \
            os.environ.get("PADDLE_AUTO_CHECKPOINT", "") == "1"


def _set_state(obj, state):
    """A layer's or optimizer's `set_state_dict`; a plain torch module
    (the vision models) loads through `io_state.set_state_dict`."""
    if hasattr(obj, "set_state_dict"):
        obj.set_state_dict(state)
    else:
        from ..framework.io_state import set_state_dict
        set_state_dict(obj, state)


class TrainEpochRange:
    """Iterate epochs; made where a finished epoch was saved, it restores
    that epoch's state (at `add`) and starts after it."""

    def __init__(self, max_epoch_num, name, checkpoint_inter=None,
                 save_checkpoint=True):
        self.max_epoch_num = max_epoch_num
        self.name = name
        self.checker = AutoCheckpointChecker()
        self.save_checkpoint = save_checkpoint
        self._models = []
        self._start_epoch = 0
        self._dir = os.path.join(self.checker.get_job_checkpoint_path(),
                                 name)
        self._meta_path = os.path.join(self._dir, "meta.json")
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self._start_epoch = json.load(f).get("epoch", -1) + 1

    def add(self, layer, optimizer=None):
        """Register a layer (and its optimizer) whose state rides the
        checkpoint."""
        self._models.append((layer, optimizer))
        if self._start_epoch > 0:
            self._restore()
        return self

    def _restore(self):
        from ..framework.io_state import load
        for i, (layer, opt) in enumerate(self._models):
            p = os.path.join(self._dir, f"model_{i}.pdparams")
            if os.path.exists(p):
                _set_state(layer, load(p))
            po = os.path.join(self._dir, f"model_{i}.pdopt")
            if opt is not None and os.path.exists(po):
                opt.set_state_dict(load(po))

    def _save(self, epoch):
        from ..framework.io_state import save
        os.makedirs(self._dir, exist_ok=True)
        for i, (layer, opt) in enumerate(self._models):
            save(layer.state_dict(),
                 os.path.join(self._dir, f"model_{i}.pdparams"))
            if opt is not None:
                save(opt.state_dict(),
                     os.path.join(self._dir, f"model_{i}.pdopt"))
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"epoch": epoch, "name": self.name}, f)
        os.replace(tmp, self._meta_path)

    def get(self):
        return self._start_epoch

    def __iter__(self):
        for epoch in range(self._start_epoch, self.max_epoch_num):
            yield epoch
            if self.save_checkpoint:
                self._save(epoch)


def train_epoch_range(max_epoch_num, save_checkpoint_inter=None):
    return TrainEpochRange(max_epoch_num, "_range_", save_checkpoint_inter)
