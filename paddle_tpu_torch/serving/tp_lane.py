"""The tensor-parallel lane of `GenerationEngine` across ranks.

The JAX engine runs a tp lane as one process whose programs are
`shard_map`s over a 'tp' mesh axis. The port runs one process a card, so
a lane of tp ranks has one scheduler: the lane's first rank admits,
allocates pages and host-tier slots, samples and answers requests,
exactly as at tp = 1. Each device program it runs (`PROGRAMS`: the
prefills, the CoW copy, the decode and verify steps, the zeroing of
freed pages, and the host tier's gather, upload and scatter) is first
broadcast to the other ranks as a descriptor (the method's name and its
host arguments: page-table rows, token ids, positions, masks, the
(page, slot) pairs of a demotion, the slots and staging key of an
upload; pickled, a few hundred bytes, over a gloo group of the lane's
ranks, so the step's tensors stay off it); each other rank's engine runs
the same program on its heads in the same order, and the programs'
row-parallel all-reduces (over the lane's tp group) meet. A follower's
results are dropped: the logits are replicated after the last
all-reduce, so the leader's are the lane's. A descriptor carries every
piece of state its program reads: a follower keeps no queue, allocator
or staging handle of the leader's, only buffers keyed by what the
descriptor names.

**One lane an engine.** Each lane makes its own tp group and its own gloo
control group, with only its members (`mesh.local_group`): two lanes may
share ranks (`Router(model, tp=2, num_replicas=2)` runs two schedulers on
rank 0 and two followers on rank 1), and with one group pair each their
all-reduces, issued from different threads, cannot meet out of order.

**Across incarnations.** The lane outlives an engine: under an
`EngineSupervisor` the leader's rebuilt engine sends the rebuild
descriptor (`REBUILD`: the incarnation and the degraded verdict) before
its warmup, and each follower builds its next engine from its own
sharded weights on the same lane and groups (the `follow` thread carries
on with it). `stop()` ends the followers' loops: an unsupervised
engine's step loop sends it as it ends, a supervised lane's supervisor at
its shutdown.

**Faults.** The tp group's collectives are bounded by
`FLAGS_gen_tp_timeout_s`. A rank whose program raises records the fault
in the job's store and ends the lane with a `LaneFault` naming itself; a
rank whose collective times out reads the record and ends it with a
`LaneFault` naming the rank at fault. A follower at fault skips the
programs that follow until the leader's step loop, whose next all-reduce
times out, ends the lane (`stop()`): every rank ends within one timeout
of the fault's next collective. A lane that faulted is not rebuilt.
"""
from __future__ import annotations

import collections
import threading

import torch
import torch.distributed as dist

from ..framework.errors import UnavailableError
from ..framework.flags import flag
from ..parallel.mesh import local_group

__all__ = ["LaneFault", "PROGRAMS", "REBUILD", "TPLane"]

PROGRAMS = ("_prefill_call", "_tail_prefill_call", "_cow_copy",
            "_decode_call", "_verify_call", "_zero_pages",
            "_tier_gather_call", "_tier_upload_call", "_tier_write_call")

REBUILD = "__rebuild__"

# lanes built over each rank set, in this process: the k-th lane over
# ranks R is the k-th on every member, so "R#k" names it alike on all
_built = collections.Counter()


class LaneFault(UnavailableError):
    """A tp lane ended because a program raised on one of its ranks.
    `rank` is the global rank at fault (None where no rank reported a
    fault and a collective failed all the same: a peer is gone)."""

    def __init__(self, msg: str, rank=None):
        super().__init__(msg)
        self.rank = rank


def _collective_failure(e: BaseException) -> bool:
    """An error of the tp group itself (gloo's timeout, a lost peer)."""
    backend_err = getattr(dist, "DistBackendError", ())
    text = str(e)
    return (isinstance(e, backend_err) or "Timed out" in text
            or "Connection closed" in text or "Connection reset" in text)


class TPLane:
    """The lane of the mesh slice along `axis` that holds this rank."""

    def __init__(self, mesh, axis="tp"):
        self.mesh = mesh
        self.ranks = mesh.group_ranks(axis)
        self.rank = mesh.axis_rank(axis)
        self.global_rank = self.ranks[self.rank]
        self.leader = self.rank == 0
        key = tuple(self.ranks)
        self.name = "_".join(map(str, key)) + f"#{_built[key]}"
        _built[key] += 1
        self.timeout_s = float(flag("FLAGS_gen_tp_timeout_s"))
        self.group = local_group(self.ranks, timeout_s=self.timeout_s)
        # the descriptors ride a gloo group of the lane's ranks: host
        # objects, whatever backend carries the step's tensors. Its
        # collectives keep the default bound: a follower waits on it for
        # as long as its leader idles
        self.control = local_group(self.ranks, backend="gloo")
        self._store = dist.distributed_c10d._get_default_store()
        self._fault_key = f"tp_lane/{self.name}/fault"
        self._stopped = False
        self.error = None       # the LaneFault that ended the lane here
        self.thread = None

    def reduce(self, x):
        """The row-parallel sum over the lane's ranks, in place."""
        dist.all_reduce(x, group=self.group)
        return x

    def _send(self, desc):
        dist.broadcast_object_list([desc], src=self.ranks[0],
                                   group=self.control)

    def _recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=self.ranks[0],
                                   group=self.control)
        return box[0]

    # -- faults --------------------------------------------------------------

    def fault(self, e: BaseException, program: str) -> LaneFault:
        """The lane's verdict on `e`, raised inside `program` on this
        rank: a LaneFault naming the rank at fault (recorded in the store
        when it is this one). The lane is ended here from now on."""
        if isinstance(e, LaneFault):
            self.error = e
            return e
        where = f"tp lane {self.ranks} ({self.name})"
        peer = None
        if self._store.check([self._fault_key]):
            peer = self._store.get(self._fault_key).decode()
        if peer is not None:
            at, _, what = peer.partition(":")
            err = LaneFault(
                f"{where}: rank {self.global_rank} ended the lane in "
                f"{program}: rank {at} faulted inside a program ({what}); "
                f"here: {type(e).__name__}: {e}", rank=int(at))
        elif _collective_failure(e):
            err = LaneFault(
                f"{where}: rank {self.global_rank} ended the lane in "
                f"{program}: a collective failed and no rank reported a "
                f"fault (a peer is gone): {type(e).__name__}: {e}")
        else:
            self._store.set(self._fault_key,
                            f"{self.global_rank}:{program}: {e!r}")
            err = LaneFault(
                f"{where}: rank {self.global_rank} faulted inside "
                f"{program}: {e!r}", rank=self.global_rank)
        self.error = err
        return err

    # -- the leader ----------------------------------------------------------

    def wrap(self, engine):
        """The leader: each program broadcasts its call before it runs;
        a program that raises ends the lane (`fault`)."""
        for name in PROGRAMS:
            fn = getattr(engine, name)

            def call(*args, _fn=fn, _name=name, **kw):
                if self.error is not None:
                    raise self.error
                self._send((_name, args, kw))
                try:
                    return _fn(*args, **kw)
                except BaseException as e:
                    raise self.fault(e, _name) from e
            setattr(engine, name, call)

    def announce_rebuild(self, incarnation: int, degraded_spec_off: bool):
        """The leader's next incarnation: the followers build theirs
        before the programs of its warmup reach them."""
        self._send((REBUILD, (int(incarnation), bool(degraded_spec_off)),
                    {}))

    def stop(self):
        """The leader: end the followers' loops (once)."""
        if self.leader and not self._stopped:
            self._stopped = True
            self._send(None)

    # -- a follower ----------------------------------------------------------

    def follow(self, engine):
        """A follower's loop: run each broadcast program on this rank's
        heads until the empty descriptor; a rebuild descriptor swaps in
        the engine's next incarnation (`engine._follow_rebuild`). After a
        fault the loop skips programs until the leader ends the lane."""
        def loop():
            eng = engine
            if eng._device.type == "cuda":
                torch.cuda.set_device(eng._device)
            while True:
                desc = self._recv()
                if desc is None:
                    return
                name, args, kw = desc
                if name == REBUILD:
                    eng = eng._follow_rebuild(*args)
                    continue
                if self.error is not None:
                    continue
                try:
                    with torch.inference_mode():
                        getattr(eng, name)(*args, **kw)
                except BaseException as e:  # noqa: BLE001 — ends the lane
                    self.fault(e, name)
        self.thread = threading.Thread(target=loop, daemon=True,
                                       name=f"{engine.name}-tp-follow")
        self.thread.start()
