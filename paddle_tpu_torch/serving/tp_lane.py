"""The tensor-parallel lane of `GenerationEngine` across ranks.

The JAX engine runs a tp lane as one process whose programs are
`shard_map`s over a 'tp' mesh axis. The port runs one process a card, so
a lane of tp ranks has one scheduler: rank 0's engine admits, allocates
pages, samples and answers requests, exactly as at tp = 1. Each device
program it runs (`PROGRAMS`: the prefills, the CoW copy, the decode and
verify steps, the zeroing of freed pages) is first broadcast to the
other ranks as a descriptor (the method's name and its host arguments:
page-table rows, token ids, positions, masks; pickled, a few hundred
bytes, over a gloo group of the lane's ranks, so the step's tensors stay
off it); each other rank's engine runs the same program on its heads in
the same order, and the programs' row-parallel all-reduces (over the
lane's tp group) meet. A follower's results are dropped: the logits are
replicated after the last all-reduce, so rank 0's are the lane's.
Ranks whose schedulers diverged would deadlock their collectives; with
one scheduler they cannot diverge. `stop()` (rank 0's step loop ending)
sends the empty descriptor that ends the followers' loops.
"""
from __future__ import annotations

import threading

import torch
import torch.distributed as dist

__all__ = ["PROGRAMS", "TPLane"]

PROGRAMS = ("_prefill_call", "_tail_prefill_call", "_cow_copy",
            "_decode_call", "_verify_call", "_zero_pages")


class TPLane:
    def __init__(self, mesh, axis="tp"):
        self.ranks = mesh.group_ranks(axis)
        self.rank = mesh.axis_rank(axis)
        self.leader = self.rank == 0
        self.group = mesh.group(axis)
        # the descriptors ride a gloo group of the lane's ranks: host
        # objects, whatever backend carries the step's tensors
        self.control = dist.new_group(self.ranks, backend="gloo")
        self._stopped = False
        self.thread = None

    def reduce(self, x):
        """The row-parallel sum over the lane's ranks, in place."""
        dist.all_reduce(x, group=self.group)
        return x

    def _send(self, desc):
        dist.broadcast_object_list([desc], src=self.ranks[0],
                                   group=self.control)

    def wrap(self, engine):
        """Rank 0: each program broadcasts its call before it runs."""
        for name in PROGRAMS:
            fn = getattr(engine, name)

            def call(*args, _fn=fn, _name=name, **kw):
                self._send((_name, args, kw))
                return _fn(*args, **kw)
            setattr(engine, name, call)

    def stop(self):
        """Rank 0: end the followers' loops (once)."""
        if self.leader and not self._stopped:
            self._stopped = True
            self._send(None)

    def follow(self, engine):
        """A follower's loop: run each broadcast program on this rank's
        heads until the empty descriptor."""
        def loop():
            if engine._device.type == "cuda":
                torch.cuda.set_device(engine._device)
            with torch.inference_mode():
                while True:
                    box = [None]
                    dist.broadcast_object_list(box, src=self.ranks[0],
                                               group=self.control)
                    if box[0] is None:
                        return
                    name, args, kw = box[0]
                    getattr(engine, name)(*args, **kw)
        self.thread = threading.Thread(target=loop, daemon=True,
                                       name=f"{engine.name}-tp-follow")
        self.thread.start()
