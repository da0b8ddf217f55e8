"""DistributeTranspiler, the legacy fluid parameter-server split (port of
`paddle_tpu.distributed.transpiler`; reference
`python/paddle/fluid/transpiler/distribute_transpiler.py:156`: rewrite one
train Program into trainer programs that SEND gradients and pserver
programs that RECV and apply them).

`transpile` places the Program's parameters round-robin over the pserver
endpoints as dense tables (the TCP service and native tables of
`distributed/ps`); the pserver's "program" is the tables' configs, whose
rule (sgd, adam) applies each push; the trainer's is `_TrainerProgram`:
pull the parameters, replay the static Program on the trainer's device
(the card unless the caller names the CPU) with `torch.autograd.grad`
over the pulled values, push the gradients scaled by 1 / trainers, and
wait at the servers' barrier in sync mode: the reference's sync-SGD
dataflow.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig"]


class DistributeTranspilerConfig:
    """reference transpiler config (slice_var_up and the other
    partitioning knobs). Only round-robin placement of whole parameters
    is implemented."""

    def __init__(self):
        self.slice_var_up = False
        self.split_method = "RoundRobin"
        self.min_block_size = 8192


class DistributeTranspiler:
    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()
        self._placement: Dict[str, tuple] = {}   # name → (endpoint, tid)
        self._program = None
        self._trainers = 1
        self._pservers: List[str] = []

    def transpile(self, trainer_id, program=None, pservers="",
                  trainers=1, sync_mode=True, startup_program=None):
        from ..static.program import default_main_program
        self._program = program or default_main_program()
        self._trainer_id = trainer_id
        self._trainers = trainers
        self._sync = sync_mode
        self._pservers = [e for e in pservers.split(",") if e]
        if not self._pservers:
            raise ValueError("transpile needs at least one pserver "
                             "endpoint")
        names = sorted(self._program.param_vars)
        for i, n in enumerate(names):
            ep = self._pservers[i % len(self._pservers)]
            self._placement[n] = (ep, i)
        return self

    # -- pserver side -------------------------------------------------------
    def get_pserver_program(self, endpoint):
        """Table configs this endpoint must host (the reference returns a
        recv+apply ProgramDesc; the rule-applying table IS that program
        here)."""
        from .ps.service import TableConfig
        opt = self._program._opt_hooks[-1] if self._program._opt_hooks \
            else None
        name = type(opt).__name__.lower() if opt else "sgd"
        supported = {"sgd": "sgd", "adam": "adam", "adamw": "adam"}
        if name not in supported:
            raise ValueError(
                f"pserver tables implement sgd/adam rules only; got "
                f"{type(opt).__name__} — use SGD/Adam(W) for the "
                f"transpiled PS mode (reference legacy PS had the same "
                f"per-rule server kernels)")
        rule = supported[name]
        if name == "adamw" and getattr(opt, "_coeff", 0.0):
            import warnings
            warnings.warn("AdamW weight decay is not applied by the "
                          "pserver adam rule; decoupled decay is dropped "
                          "in transpiled PS mode")
        from ..optimizer.lr import LRScheduler
        if opt is not None and isinstance(opt._lr, LRScheduler):
            import warnings
            warnings.warn("pserver tables apply a FIXED lr; the "
                          "LRScheduler will not take effect server-side")
        lr = opt.get_lr() if opt else 0.01
        cfgs = []
        for name, (ep, tid) in sorted(self._placement.items()):
            if ep != endpoint:
                continue
            v = self._program.param_vars[name]
            cfgs.append(TableConfig(tid, "dense",
                                    size=int(v.numel()),
                                    rule=rule, lr=lr, name=name))
        return cfgs

    get_pserver_programs = get_pserver_program

    def get_startup_program(self, endpoint=None, pserver_program=None):
        """Initial values each table must be seeded with (reference:
        the pserver startup program holding param init ops)."""
        from ..static.program import _host, global_scope
        scope = global_scope()
        out = {}
        for name, (ep, tid) in self._placement.items():
            if endpoint is None or ep == endpoint:
                init = scope.get(name, self._program.param_vars[name])
                out[tid] = np.asarray(_host(init), np.float32).reshape(-1)
        return out

    # -- trainer side -------------------------------------------------------
    def get_trainer_program(self, wait_port=True, device=None):
        """A runnable trainer: pull, gradients on `device`, push (the
        reference splices send / recv ops; here the wrapper is the
        program)."""
        return _TrainerProgram(self, device)


class _TrainerProgram:
    """One trainer against the pservers, run like an Executor step:
    `run(feed, fetch_list)` -> the loss (and the fetches)."""

    def __init__(self, t: DistributeTranspiler, device=None):
        from ..framework.place import resolve_device
        from .ps.service import PsClient
        self.t = t
        self.client = PsClient(t._pservers)
        self.program = t._program
        self.device = resolve_device(device)
        self._lowered = None
        self._key = None

    def run(self, feed=None, fetch_list=None):
        from ..static.program import (_Lowered, _as_feed, _host,
                                      recorder_paused)
        program, t = self.program, self.t
        fetch_slots = [v.slot for v in (fetch_list or [])]
        key = tuple(fetch_slots)
        if self._key != key:
            self._lowered = _Lowered(program, [program._loss_slot]
                                     + fetch_slots, self.device)
            self._key = key
        lowered = self._lowered
        feed = feed or {}
        feeds = [_as_feed(feed[n] if n in feed else program.feed_vars[n],
                          self.device) for n in lowered.feed_names]
        # the parameters' current values from their tables
        srv_of = {ep: i for i, ep in enumerate(t._pservers)}
        leaves = []
        for n in lowered.param_names:
            ep, tid = t._placement[n]
            flat = self.client.pull_dense(tid, server=srv_of[ep])
            v = torch.from_numpy(flat.reshape(
                tuple(program.param_vars[n].shape))).to(self.device)
            leaves.append(v.requires_grad_(v.is_floating_point()))
        with recorder_paused(), torch.enable_grad():
            env = lowered.env(feeds, leaves)
            outs = lowered.fetch(env)
            diff = [i for i, p in enumerate(leaves) if p.requires_grad]
            grads = torch.autograd.grad(outs[0], [leaves[i] for i in diff],
                                        allow_unused=True)
        # gradients scaled by 1 / trainers (the reference's sync SGD
        # averages over the trainers); the table applies its rule a push
        scale = 1.0 / max(t._trainers, 1)
        for i, g in zip(diff, grads):
            ep, tid = t._placement[lowered.param_names[i]]
            g = torch.zeros_like(leaves[i]) if g is None else g
            self.client.push_dense(
                tid, (_host(g).astype(np.float32) * np.float32(scale))
                .reshape(-1), server=srv_of[ep])
        if t._sync:
            self.client.barrier()
        loss = float(_host(outs[0]))
        if fetch_list:
            return [loss] + [_host(o) for o in outs[1:]]
        return loss

    def close(self):
        self.client.close()
