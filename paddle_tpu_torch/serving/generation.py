"""Continuous-batching generation engine over a paged KV cache.

Port of the core of `paddle_tpu.serving.generation.GenerationEngine`:
iteration-level scheduling (Orca) over a paged KV cache (vLLM).
Requests join the running batch through a prefill pass; every engine
step advances EVERY live sequence by one token through one fixed-slot
decode step; sequences leave on EOS / max-tokens / deadline and free
their pages the same step.

Shape discipline carries over: the decode batch is a fixed number of
slots (`max_slots`), inactive slots parked on the scratch page, and
prompts pad up to `prefill_buckets`. PyTorch runs eagerly, so nothing is
compiled; `stats()["compiles"]` counts the distinct program shapes run
(`prefill[b=S]`, `decode[m=M]`), key for key comparable with the JAX
engine's trace ledger. Each decode layer attends through
`ops.paged_ops.paged_attention`: the hand-written CUDA kernel on the
card, the dense-gather plain version on the CPU.

**Prefix cache** (`FLAGS_gen_prefix_cache` / `prefix_cache=True`): full
pages of prompt K/V are indexed by a content-hash block chain
(`serving/prefix_cache.py`) over refcounted pages; a request whose prompt
walks a cached chain maps those pages read-only and prefills ONLY the
tail through a per-bucket `prefill_tail[b=S]` program (tail queries
attend the cached pages plus their own in-flight K/V,
`ops.paged_ops.paged_prefix_attention`). A full-prompt match recomputes
just its last position, copy-on-write splitting the page that holds it
(`cow_copy`), so the shared original is never written under its other
readers. Zero-on-free keys on refcounts, and refcount-0 cached chains are
LRU-evicted before alloc whenever the free list alone is short.

**Speculative decoding** (`FLAGS_gen_spec_k` / `spec_k=K`): ONE fixed-k
verify program (`verify[k=K]`) replaces the decode step. Each live slot's
[current token + K prompt-lookup drafts] block (`serving/spec_decode.py`)
runs one `gpt_spec_verify` pass over the paged cache; acceptance (exact
greedy agreement) is computed on the device and only consumed positions'
K/V commit: rejected lanes, inactive slots and pad positions write to the
scratch page. A step delivers 1..K+1 tokens, token-identical to
speculation off. **Chunked prefill** (`FLAGS_gen_prefill_chunk`): long
prompts admit at once but prefill one fixed-size chunk per engine
iteration through the tail programs, between decode steps.

Hardening: bounded intake (`EngineOverloaded`), worst-case page admission
with FIFO head-of-line blocking, per-request deadlines checked while
queued and before every decode step, poison isolation through a
per-slot non-finite-logit flag (pages zeroed before reuse), shutdown
drain, and `health()`.

**int8 KV pages** (`kv_cache_dtype="int8"`, FLAGS_kv_cache_dtype): the
pools store int8 pages beside per-(layer, head, page) scale pools; every
program quantizes on append (`paged_write_quantized`: decode appends grow
and requantize their page, prefills scatter-max their pages' scales, the
tail, chunk and verify writes requantize pages that hold content) and
dequantizes on read (the decode attention takes the dequantizing gather
and launches no K1, as the JAX engine's does); `cow_copy` clones the
scale row, and zero-on-free resets freed pages' scales to 0. About 4x the
sequences a pool byte. A `quantization.quantize_weights`'d model
composes independently: its decode-weight leaves are (int8, scale) pairs
dequantized at their point of use.

**Host KV tier** (`FLAGS_kv_tier` / `kv_tier=True`, with the prefix
cache): a prefix-cache eviction demotes the chain's pages into a
bounded host store (`serving/kv_tier.py`: raw bytes and int8 scale rows
in the slots of a host slab that grows by segments up to the budget,
pinned on the card) instead of discarding them, through the
`tier_gather` program (one batch an eviction pass: a gather a pool, then
a device-to-host copy a page, queued on the engine's stream and not
waited for).
A later prompt that walks the chain through host-state nodes promotes
them: chunks of `kv_tier_chunk_pages` pages upload on a side CUDA stream
into fresh staging buffers while the main stream scatters the previous
chunk into the admission's fresh pages (`tier_write[w=C]`). Every pool
write (zero-on-free, the scatter, an abandon's zeroing) stays on the
main stream, which waits on each chunk's upload event before its
scatter, so the tail prefill and every later decode read the promoted
pages in order. The `kv_tier.promote_upload` failpoint abandons a
promotion (written pages zeroed, cold prefill), `kv_tier.demote_gather`
turns a demotion into a plain eviction.

**Observability**, as in the JAX engine: a reason-coded decision audit
ring (`profiler/audit.py`, optional JSONL sink `FLAGS_gen_audit_log`),
one `StepRecord` per engine iteration (`profiler/step_log.py`,
`FLAGS_gen_step_log`) whose six goodput buckets tile the iteration wall
exactly, per-request spans with trace ids (`profiler/spans.py`,
`FLAGS_serving_spans`) feeding the `ttft_ms`/`tpot_ms` histograms and
the SLO burn rates (`profiler/slo.py`), flight-recorder dumps on engine
death, a poisoned sequence and allocator exhaustion, device telemetry,
and the HTTP exporter (`metrics_port=`: `/metrics`, `/stats`, `/steps`,
`/slo`, `/trace`, `/history`, `/healthz`, `/readyz`). Deterministic
fault injection goes through `serving/failpoints.py`
(`FLAGS_failpoints`).

**Supervised restart** (`serving/supervisor.py`): an engine built with
`on_death=` hands a `CrashManifest` to that callback when its step loop
raises (queued requests verbatim, live slots as prompt + generated
continuations, each with the caller's future and stream) instead of
failing the requests; `replay_submit` re-enqueues an entry on the rebuilt
engine, and a from-scratch greedy replay suppresses the `skip_stream`
tokens a stream already delivered. The dead engine releases its pools
before the callback runs (the JAX engine donated them into the failing
call), so a rebuild never holds two sets. `incarnation` rides every
StepRecord and span; `_carryover` hands the next incarnation the program
ledger, the step and audit rings and the degraded verdict. **Degraded
modes**: `FLAGS_gen_poison_degrade_k` poison events in
`FLAGS_gen_degraded_window_s` turn speculation off (the plain decode
step is warmed beside the verify program, so the ledger does not move),
and `FLAGS_gen_exhaust_clamp_k` page-blocked admission iterations clamp
admission (submits the pool cannot cover now fail fast) until the next
admission.

**Tensor-parallel lanes** (`tp` > 1, or `mesh=` with a 'tp' axis):
this rank's slice of the mesh along 'tp' holds the heads/tp slice of
every projection and pool, its first rank schedules, and every device
program runs on each rank of the lane (`serving/tp_lane.py`), the host
tier's included; a lane outlives a supervised restart. Lanes may share
ranks and may cover part of the world.

**Program store** (`program_store=<dir>` / FLAGS_gen_program_store_dir,
`serving/program_store.py`): each covered program (`prefill[b=S]`,
`prefill_tail[b=S]`, `decode[m=M]`, `verify[k=K]`, `cow_copy`) is a
function of tensors (`_*_prog`: weights and pools in, pools written in
place, no host sync), run eagerly with the store off. With the store on,
warmup exports each with `torch.export` on a miss and saves it under a
content key; a fresh process with the same key loads every program
instead, and a loaded program serves only after an in-place self-check
and a numeric smoke probe (`_warm_one`). Sampling draws its noise from
the engine's generator outside the programs, in the order the eager path
draws it, so a sampled request gets the same tokens with the store on as
off. Not at tp > 1 (ROADMAP C46).
"""
from __future__ import annotations

import copy
import itertools
import queue as _queue
import threading
import time
import traceback
from collections import deque
from concurrent.futures import CancelledError, Future
from typing import List, Optional

import numpy as np
import torch

from ..framework import monitor
from ..framework.errors import (ExecutionTimeoutError, FatalError,
                                InvalidArgumentError,
                                ResourceExhaustedError, UnavailableError)
from ..framework.flags import flag
from ..framework.place import resolve_device
from ..profiler import (RecordEvent, audit, device_telemetry, exporter,
                        flight_recorder, slo, spans, step_log, timeseries,
                        trace_context)
from . import failpoints
from .kv_tier import HostEntry, HostSlab, HostTier
from ..models.gpt import (GPTForCausalLM, gpt_decode_step, gpt_logits,
                          shard_decode_weights,
                          gpt_prefill, gpt_prefill_extend, gpt_spec_verify,
                          sample_logits, sample_logits_with_noise,
                          sampling_noise)
from ..ops.paged_ops import (page_rows_for_positions, paged_attention,
                             paged_gather, paged_gather_layers,
                             paged_gather_quantized, paged_prefix_attention,
                             paged_write, paged_write_quantized)
from .kv_cache import TRASH_PAGE, PagedKVCache
from .prefix_cache import PrefixCache
from .spec_decode import NGramProposer

monitor.register_gauge("STAT_gen_queue_depth", updown=True)

__all__ = ["CrashManifest", "EngineOverloaded", "GenerationConfig",
           "GenerationEngine", "ReplayEntry", "TokenStream"]


class EngineOverloaded(ResourceExhaustedError):
    """Raised by `submit` when the bounded request queue is full —
    explicit load-shedding backpressure, never silent growth."""


def _now_ms() -> float:
    return time.perf_counter() * 1000.0


def _last_real(h, length):
    """h[length - 1] of hidden states [S, E], with `length` a 0-d device
    tensor (clamped into [0, S)): the last real position of a
    bucket-padded prompt, gathered on the device."""
    idx = (length - 1).clamp(0, h.shape[0] - 1).reshape(1)
    return h.index_select(0, idx)[0]


class _Program(torch.nn.Module):
    """A program function of the engine as a module, for `torch.export`
    (its weights and pools are inputs, so it holds no parameter)."""

    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


class GenerationConfig:
    """Continuous-batching knobs; defaults ride the FLAGS_gen_* /
    FLAGS_paged_* / FLAGS_kv_tier* registry. `tp` > 1 shards the engine
    over a tensor-parallel lane of the world's first tp ranks
    (`serving.tp_lane`; an engine's `mesh=` wins over it), with every
    mode of the engine: the prefix cache, speculation, int8 pages, the
    host tier, and supervision by an `EngineSupervisor` on each rank.
    `program_store` is the root directory of the on-disk program store
    (None follows FLAGS_gen_program_store_dir, "" is off;
    `program_store_force` overrides the serialization gate, with a
    warning); a tp > 1 lane refuses it (ROADMAP C46). `warmup=False`
    skips the
    construction-time run of every program: the ledger then fills at
    each program's first call (and on the card the kernels build
    then)."""

    def __init__(self, max_slots: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 pages_per_seq: Optional[int] = None,
                 prefill_buckets=None,
                 max_new_tokens: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 request_timeout_ms: Optional[float] = None,
                 kv_cache_dtype: Optional[str] = None,
                 prefix_cache: Optional[bool] = None,
                 prefix_cache_max_pages: Optional[int] = None,
                 spec_k: Optional[int] = None,
                 spec_ngram: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 kv_tier: Optional[bool] = None,
                 kv_tier_host_bytes: Optional[int] = None,
                 kv_tier_chunk_pages: Optional[int] = None,
                 program_store: Optional[str] = None,
                 program_store_force: Optional[bool] = None,
                 tp: Optional[int] = None,
                 top_k: int = 0, seed: int = 0, warmup: bool = True):
        # the on-disk program store (serving/program_store.py): root dir
        # or None = off (device.program_store_dir resolves the flag)
        if program_store is None:
            from .. import device as _device
            self.program_store = _device.program_store_dir()
        else:
            self.program_store = str(program_store) or None
        self.program_store_force = bool(
            flag("FLAGS_gen_program_store_force")
            if program_store_force is None else program_store_force)
        # tensor-parallel lane: tp ranks of the process group, one card
        # each, the lane's first rank the scheduler (serving/tp_lane.py)
        self.tp = int(flag("FLAGS_gen_tp") if tp is None else tp)
        if self.tp < 1:
            raise InvalidArgumentError("tp must be >= 1")
        self.max_slots = int(flag("FLAGS_gen_max_slots")
                             if max_slots is None else max_slots)
        if self.max_slots < 1:
            raise InvalidArgumentError("max_slots must be >= 1")
        self.page_size = int(flag("FLAGS_paged_page_size")
                             if page_size is None else page_size)
        self.num_pages = int(flag("FLAGS_paged_num_pages")
                             if num_pages is None else num_pages)
        self.pages_per_seq = int(flag("FLAGS_paged_pages_per_seq")
                                 if pages_per_seq is None else pages_per_seq)
        if prefill_buckets is None:
            raw = str(flag("FLAGS_gen_prefill_buckets"))
            prefill_buckets = [int(x) for x in raw.split(",") if x.strip()]
        buckets = sorted({int(b) for b in prefill_buckets if int(b) >= 1})
        if not buckets:
            raise InvalidArgumentError("prefill_buckets must be non-empty")
        self.prefill_buckets = tuple(buckets)
        self.max_new_tokens = int(flag("FLAGS_gen_max_new_tokens")
                                  if max_new_tokens is None
                                  else max_new_tokens)
        self.max_queue_depth = int(flag("FLAGS_gen_max_queue_depth")
                                   if max_queue_depth is None
                                   else max_queue_depth)
        self.request_timeout_ms = float(
            flag("FLAGS_gen_request_timeout_ms")
            if request_timeout_ms is None else request_timeout_ms)
        self.kv_cache_dtype = str(flag("FLAGS_kv_cache_dtype")
                                  if kv_cache_dtype is None
                                  else kv_cache_dtype)
        if self.kv_cache_dtype not in ("auto", "int8", "float32",
                                       "bfloat16"):
            raise InvalidArgumentError(
                f"kv_cache_dtype must be auto/int8/float32/bfloat16, got "
                f"{self.kv_cache_dtype!r}")
        self.prefix_cache = bool(flag("FLAGS_gen_prefix_cache")
                                 if prefix_cache is None else prefix_cache)
        self.prefix_cache_max_pages = int(
            flag("FLAGS_gen_prefix_cache_max_pages")
            if prefix_cache_max_pages is None else prefix_cache_max_pages)
        if self.prefix_cache_max_pages < 0:
            raise InvalidArgumentError(
                "prefix_cache_max_pages must be >= 0 (0 = unbounded)")
        self.spec_k = int(flag("FLAGS_gen_spec_k")
                          if spec_k is None else spec_k)
        if self.spec_k < 0:
            raise InvalidArgumentError("spec_k must be >= 0 (0 = off)")
        self.spec_ngram = int(flag("FLAGS_gen_spec_ngram")
                              if spec_ngram is None else spec_ngram)
        if self.spec_k and self.spec_ngram < 1:
            raise InvalidArgumentError(
                "spec_ngram must be >= 1 when spec_k > 0")
        self.prefill_chunk = int(flag("FLAGS_gen_prefill_chunk")
                                 if prefill_chunk is None
                                 else prefill_chunk)
        if self.prefill_chunk < 0:
            raise InvalidArgumentError(
                "prefill_chunk must be >= 0 (0 = whole-prompt prefill)")
        # the host tier demotes prefix-cache chains: without the chain
        # index there is nothing to demote or promote
        self.kv_tier = bool(flag("FLAGS_kv_tier")
                            if kv_tier is None else kv_tier)
        if self.kv_tier and not self.prefix_cache:
            raise InvalidArgumentError(
                "kv_tier requires prefix_cache (the host tier demotes "
                "prefix-cache chains; enable FLAGS_gen_prefix_cache)")
        self.kv_tier_host_bytes = int(
            flag("FLAGS_kv_tier_host_bytes")
            if kv_tier_host_bytes is None else kv_tier_host_bytes)
        if self.kv_tier and self.kv_tier_host_bytes < 1:
            raise InvalidArgumentError(
                "kv_tier_host_bytes must be >= 1 when kv_tier is on")
        self.kv_tier_chunk_pages = int(
            flag("FLAGS_kv_tier_chunk_pages")
            if kv_tier_chunk_pages is None else kv_tier_chunk_pages)
        if self.kv_tier and self.kv_tier_chunk_pages < 1:
            raise InvalidArgumentError(
                "kv_tier_chunk_pages must be >= 1 when kv_tier is on")
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.warmup = bool(warmup)


class TokenStream:
    """Per-token delivery handle returned by `submit_stream`.

    Iterate it to receive generated token ids as the step thread decodes
    them; iteration ends after the final token, and the streamed tokens
    concatenate exactly to `result()`'s generated part. A failed request
    raises the same exception from the iterator and from `result()`."""

    _END = object()

    def __init__(self, future: Future):
        self._q = _queue.SimpleQueue()
        self._exc: Optional[BaseException] = None
        self._ended = False
        self.future = future
        # trace id, set at submit, so a streaming caller can correlate
        # its tokens with the trace
        self.trace_id: Optional[str] = None

    def _put(self, item) -> None:     # engine-side (step thread)
        self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self) -> int:
        if self._exc is not None:
            raise self._exc
        if self._ended:
            raise StopIteration
        item = self._q.get()
        if item is TokenStream._END:
            self._ended = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._exc = item
            raise item
        return int(item)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """The full sequence (prompt + generated, numpy int32)."""
        return self.future.result(timeout)


class _GenRequest:
    __slots__ = ("rid", "prompt", "max_new", "eos", "do_sample",
                 "temperature", "future", "deadline_ms", "t_enqueue_ms",
                 "span", "slot", "pt_row", "toks", "next_pos", "ordinal",
                 "defer_logged", "stream", "ttft_deadline_ms",
                 "prefix_tokens", "prefill_pos", "pending_digests",
                 "spec_accepted", "claimed", "retries", "skip_stream",
                 "trace_id")

    _ids = itertools.count(1)

    def __init__(self, prompt, max_new, eos, do_sample, temperature,
                 future, deadline_ms, t_enqueue_ms, span, stream=None,
                 ttft_deadline_ms=None, trace_id=None):
        self.rid = next(self._ids)
        self.prompt = prompt            # np.int32 [S]
        self.max_new = max_new
        self.eos = eos
        self.do_sample = do_sample
        self.temperature = temperature
        self.future = future
        self.deadline_ms = deadline_ms
        self.t_enqueue_ms = t_enqueue_ms
        self.span = span                # GenSpan or None
        self.slot: Optional[int] = None
        self.pt_row = None              # np.int32 [pages_per_seq]
        self.toks: List[int] = []       # generated tokens (eos included)
        self.next_pos = 0               # cache position the NEXT step writes
        self.ordinal = 0                # engine-local submit ordinal
        self.defer_logged = set()       # audit DEFER_* causes noted once
        self.stream = stream            # TokenStream or None
        self.ttft_deadline_ms = ttft_deadline_ms  # HARD (streams)
        self.prefix_tokens = 0          # prompt tokens served from cache
        self.prefill_pos = None         # chunked prefill: next prompt
        #                                 position to prefill (None =
        #                                 prefill complete / not chunked)
        self.pending_digests = None     # prompt digests held across chunks
        self.spec_accepted = 0          # draft tokens accepted
        self.claimed = False            # future claimed running (_admit)
        self.retries = 0                # supervised restarts survived
        self.skip_stream = 0            # stream tokens to suppress on a
        #                                 from-scratch greedy replay
        #                                 (exactly-once across restarts)
        self.trace_id = trace_id        # 16-hex trace id or None; one id
        #                                 across every incarnation


class ReplayEntry:
    """One request's restartable state inside a `CrashManifest`: the
    submit parameters verbatim, the generated prefix (a live slot replays
    as a prompt + generated continuation), the future and stream the
    caller still holds, and what an exactly-once replay needs
    (`delivered` streamed tokens, `claimed` future state, the `retries`
    already spent)."""

    __slots__ = ("rid", "ordinal", "prompt", "toks", "max_new", "eos",
                 "do_sample", "temperature", "future", "stream",
                 "deadline_ms", "ttft_deadline_ms", "t_enqueue_ms",
                 "claimed", "retries", "delivered", "queued", "trace_id")

    def __init__(self, req: "_GenRequest", queued: bool):
        self.rid = req.rid
        self.ordinal = req.ordinal
        self.prompt = req.prompt
        self.toks = list(req.toks)
        self.max_new = req.max_new
        self.eos = req.eos
        self.do_sample = req.do_sample
        self.temperature = req.temperature
        self.future = req.future
        self.stream = req.stream
        self.deadline_ms = req.deadline_ms
        self.ttft_deadline_ms = req.ttft_deadline_ms
        self.t_enqueue_ms = req.t_enqueue_ms
        self.claimed = req.claimed
        self.retries = req.retries
        # _die flushes the staged stream items before the manifest is
        # built, so every generated token was delivered or, in a
        # from-scratch replay, suppressed because an earlier incarnation
        # delivered it (skip_stream counts the suppressions still owed):
        # what the caller has seen = generated here + still owed
        self.delivered = (len(req.toks) + req.skip_stream
                          if req.stream is not None else 0)
        self.queued = queued
        self.trace_id = req.trace_id


class CrashManifest:
    """What `EngineSupervisor` needs to resurrect a dead engine: the
    replayable requests in admission order (live slots first, then the
    queued tail), the fatal error, the page-pool snapshot, the program
    ledger at death (the rebuilt engine must add no key to it) and the
    degraded state that survives the restart."""

    __slots__ = ("engine", "incarnation", "error", "entries",
                 "degraded_spec_off", "kv", "compiles")

    def __init__(self, engine: str, incarnation: int,
                 error: BaseException, entries: List[ReplayEntry],
                 degraded_spec_off: bool, kv: dict, compiles: dict):
        self.engine = engine
        self.incarnation = incarnation
        self.error = error
        self.entries = entries
        self.degraded_spec_off = degraded_spec_off
        self.kv = kv
        self.compiles = compiles

    def summary(self) -> dict:
        """Flight-dump payload: counts and per-entry state, no futures."""
        return {
            "engine": self.engine, "incarnation": self.incarnation,
            "error": repr(self.error),
            "entries": [{"rid": e.rid, "queued": e.queued,
                         "generated": len(e.toks),
                         "delivered": e.delivered,
                         "stream": e.stream is not None,
                         "retries": e.retries}
                        for e in self.entries],
            "degraded_spec_off": self.degraded_spec_off,
            "kv": self.kv, "compiles": dict(self.compiles)}


class GenerationEngine:
    """Token-level continuous-batching front-end over a
    `models.GPTForCausalLM`.

    `submit(prompt_ids, ...)` returns a `concurrent.futures.Future`
    resolving to the full token sequence (prompt + generated, numpy
    int32). Greedy by default; `do_sample=True` draws with the engine's
    `torch.Generator` (seeded from `config.seed`), shared by every
    sequence of a step.

    Scheduling: FIFO admission with head-of-line blocking — a request is
    admitted the moment a slot AND its worst-case pages (prompt +
    max_new) are free, prefills immediately, and joins the next decode
    step. Deadlines are whole-request and checked before every step.

    The engine runs on `device` (default the CUDA card; raises where
    there is none); the model must live there already. `mesh`, a mesh
    with a 'tp' axis, makes the engine this rank's slice of it along
    'tp' (a tp lane, `serving.tp_lane`); it wins over `config.tp`.
    `metrics_port` starts (or shares) the exporter's HTTP server on
    127.0.0.1: 0 binds an ephemeral port owned by this engine (read it
    back from `engine.metrics_server.port`), None follows
    FLAGS_metrics_port.

    The supervisor seam: `incarnation` is this engine generation's
    ordinal (on every StepRecord and span); with `on_death` set, a death
    hands a `CrashManifest` to it instead of failing the requests, and
    the supervisor, not the engine, is the exporter's registered entity;
    `_carryover` passes the previous incarnation's program ledger, step
    and audit rings and degraded verdict forward."""

    def __init__(self, model, config: Optional[GenerationConfig] = None,
                 name: str = "generation", device=None, mesh=None,
                 metrics_port: Optional[int] = None,
                 incarnation: int = 0, on_death=None, _carryover=None,
                 **overrides):
        if config is None:
            config = GenerationConfig(**overrides)
        elif overrides:
            raise InvalidArgumentError(
                "pass either a GenerationConfig or keyword overrides, "
                "not both")
        self._cfg = copy.copy(config)
        self.name = name
        self.incarnation = int(incarnation)
        self._on_death = on_death
        carry = _carryover or {}
        # a supervised follower's next incarnation comes from its
        # supervisor, when the leader's rebuild descriptor arrives
        self._rebuild = carry.get("rebuild")
        if not isinstance(model, GPTForCausalLM):
            raise InvalidArgumentError(
                f"GenerationEngine serves a models.GPTForCausalLM "
                f"(got {type(model).__name__})")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if model.device != dev:
            raise InvalidArgumentError(
                f"{name}: the model lives on {model.device}, the engine "
                f"was asked to run on {dev}")
        self._device = dev
        self._model = model
        mcfg = model.gpt.config
        # a resurrection reuses the dead incarnation's weight tree (a tp
        # rank's is its sharded copy), as the JAX engine reuses its pack's
        carried_W = carry.get("W")
        self._W = (model.decode_weights() if carried_W is None
                   else carried_W)    # raises for MoE
        self._H = mcfg.num_heads
        self._D = mcfg.hidden_size // mcfg.num_heads
        self._scale = 1.0 / self._D ** 0.5
        # an explicit mesh wins over config.tp and must carry a 'tp' axis
        if mesh is not None:
            if "tp" not in mesh.shape:
                raise InvalidArgumentError(
                    f"GenerationEngine mesh needs a 'tp' axis (got "
                    f"{tuple(mesh.axis_names)})")
            self._tp = int(mesh.shape["tp"])
        else:
            self._tp = self._cfg.tp
        self._cfg.tp = self._tp
        if self._H % self._tp != 0:
            raise InvalidArgumentError(
                f"num_heads={self._H} not divisible by tp={self._tp} — "
                f"head-sharded lanes need equal slices")
        if self._tp > 1 and self._cfg.program_store:
            raise InvalidArgumentError(
                f"{name}: the program store does not serve a tp > 1 lane "
                f"yet (ROADMAP C46): its programs all-reduce over the "
                f"lane's process group, which torch.export does not "
                f"trace; serve the lane with program_store off")
        # a tp lane: this rank's heads of every projection and pool, the
        # row-parallel sums all-reduced over the lane; its first rank
        # schedules. A resurrection follows the dead incarnation's lane
        self._lane = self._reduce = None
        if self._tp > 1:
            self._lane = carry.get("lane") or self._tp_lane(mesh)
            self._reduce = self._lane.reduce
            if carried_W is None:
                self._W = shard_decode_weights(self._W, self._lane.mesh,
                                               "tp")
        self._Hl = self._H // self._tp
        self._max_position = mcfg.max_position_embeddings
        if self._cfg.pages_per_seq <= 0:
            self._cfg.pages_per_seq = -(-self._max_position
                                        // self._cfg.page_size)
        # a bucket wider than the per-sequence page capacity would
        # compute page indices past the table width
        cap = min(self._max_position,
                  self._cfg.pages_per_seq * self._cfg.page_size)
        self._cfg.prefill_buckets = tuple(sorted(
            {min(int(b), cap) for b in self._cfg.prefill_buckets}))
        # "auto" pools take the weights' type (float16 too, ROADMAP C10)
        wdt = str(self._W["wte"].dtype).replace("torch.", "")
        kv_dtype = (wdt if self._cfg.kv_cache_dtype == "auto"
                    else self._cfg.kv_cache_dtype)
        self._cache = PagedKVCache(
            mcfg.num_layers, self._H, self._D, self._cfg.page_size,
            self._cfg.num_pages, self._cfg.pages_per_seq, dtype=kv_dtype,
            device=dev, tp=self._tp)
        # int8 page mode: the programs write and read the scale pools
        # beside the pages; everything above the pools (admission, page
        # tables, zero-on-free, the ledger) is type-blind
        self._quant_kv = self._cache.quantized
        self._gen = torch.Generator(device=dev).manual_seed(self._cfg.seed)
        # prefix cache: content-hash chain index over the refcounted
        # pages; None keeps single-owner pages (refcount 1, none shared)
        self._prefix = (PrefixCache(
            self._cache, name, max_pages=self._cfg.prefix_cache_max_pages)
            if self._cfg.prefix_cache else None)
        # host tier: bounded host store the prefix cache demotes cold
        # chains into (attach_tier below, once the audit ring exists).
        # Its entries live in a host slab (pinned on the card) that grows
        # by segments, one slot a page, up to enough slots for a full
        # budget, or for one admission's protected run with the budget
        # overshot by it, plus the page being gathered
        self._slab = self._tier = None
        if self._cfg.kv_tier and self._prefix is not None:
            c = self._cache
            # a rank's slots hold its heads; the budget counts whole
            # pages (the lane's bytes), so a lane holds as many entries
            # and evicts as tp = 1 does, and every rank has as many slots
            parts = [((c.num_layers, c.local_heads, c.page_size,
                       c.head_dim), c.k_pages.dtype)] * 2
            if self._quant_kv:
                parts += [((c.num_layers, c.local_heads),
                           torch.float32)] * 2
            per = self._page_bytes = c.page_host_bytes()
            self._slab = HostSlab(
                parts, max(self._cfg.kv_tier_host_bytes // per,
                           self._cfg.pages_per_seq + 1) + 1,
                pin=dev.type == "cuda")
            self._tier = HostTier(self._cfg.kv_tier_host_bytes, name,
                                  slab=self._slab)
        # promotion uploads run on their own stream (created at first
        # use on the card); pool writes stay on the current stream. A
        # staged chunk waits for its scatter under the key the upload's
        # descriptor names
        self._upload_stream = None
        self._staged = {}
        self._stage_seq = 0
        # demoted pages whose copy waits for the end of the eviction
        # pass: (page, slab slot), step thread only
        self._gather_q: List[tuple] = []
        # chunks ride the per-bucket tail programs, so a chunk is never
        # wider than the largest bucket; 0 keeps whole-prompt prefill
        self._cfg.prefill_chunk = min(self._cfg.prefill_chunk,
                                      self._cfg.prefill_buckets[-1])
        # the tail programs serve both prefix hits and prefill chunks
        self._use_tail = (self._prefix is not None
                          or self._cfg.prefill_chunk > 0)
        # speculative decoding: prompt-lookup drafts + ONE fixed-k verify
        # program in place of the decode step
        self._spec_k = self._cfg.spec_k
        self._proposer = (NGramProposer(self._cfg.spec_ngram)
                          if self._spec_k else None)
        self._spec_drafted_total = 0
        self._spec_accepted_total = 0
        self._chunks_total = 0
        # the program store: programs resolved by name (loaded from the
        # store, or exported and written back) and the loads counted; a
        # resurrection reuses the dead incarnation's, as the JAX engine
        # reuses its pack
        self._execs = carry.get("execs", {})
        self._loaded = carry.get("loaded", {})
        self._ones = None
        self._store = None
        if self._cfg.program_store:
            from .program_store import ProgramStore
            self._store = ProgramStore(
                self._cfg.program_store, self._store_key_material(),
                force=self._cfg.program_store_force)
            if self._store.refused:
                self._store = None

        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._slots: List[Optional[_GenRequest]] = \
            [None] * self._cfg.max_slots
        self._closed = False
        self._abort = False
        # futures and stream items whose delivery waits for the end of
        # the iteration (step-thread only); streams flush first, so a
        # stream's final token precedes its future's resolution
        self._resolve_q: List[tuple] = []
        self._stream_q: List[tuple] = []
        self._warmed = False
        self._steps_total = 0
        self._prefills_total = 0
        self._tokens_total = 0
        self._exhaust_dumped = False   # one flight dump per episode
        self._req_seq = 0              # engine-local submit ordinal
        # program shape key -> 1; a resurrection shares the dead
        # incarnation's dict, as the JAX engine shares its program pack's,
        # so a rebuild that runs no new program shape adds no key
        ledger = carry.get("ledger")
        self._ledger = {} if ledger is None else ledger
        self._death: Optional[BaseException] = None
        self._pre_step_hook = None     # test seam: runs on the step thread
        self._hist = monitor.histogram(f"{name}_request_ms")
        # degraded modes: the detector knobs are read once here (a flag
        # flip must not turn speculation on over an unwarmed program); the
        # spec-off verdict rides the crash manifest across a restart
        self._poison_degrade_k = int(flag("FLAGS_gen_poison_degrade_k"))
        self._exhaust_clamp_k = int(flag("FLAGS_gen_exhaust_clamp_k"))
        self._degraded_window_s = float(flag("FLAGS_gen_degraded_window_s"))
        self._degraded_spec_off = bool(carry.get("degraded_spec_off"))
        self._poison_times: deque = deque()
        self._exhaust_times: deque = deque()
        self._admit_clamped = False
        # decision audit ring (always on: one deque append a decision)
        # and the per-iteration step ring (FLAGS_gen_step_log, read once
        # here so a flag flip cannot half-enable a running engine); a
        # resurrection keeps the previous incarnation's rings, so the
        # restart lands in the same trail as the death that caused it
        self._audit = carry.get("audit") or audit.AuditLog(name)
        if self._tier is not None:
            # demote-on-evict: evictions copy page content off the
            # device into the host store before freeing it
            self._prefix.attach_tier(self._tier, self._tier_gather_page,
                                     audit=self._audit,
                                     flush=self._tier_gather_flush)
        self._step_log = carry.get("step_log") or (
            step_log.StepLog(name) if step_log.enabled() else None)
        if carry.get("step_log") is not None:
            # a failed rebuild attempt's error path unregisters the
            # carried ring; the next attempt restores it
            step_log.register(self._step_log)
        self._iters = 0
        # last-seen cumulative tier counters: _record_iteration takes
        # deltas for the per-iteration demote/promote counts
        self._tier_counts = (0, 0)
        self._it = self._fresh_it()
        # published before the step thread exists, so a poller reads a
        # truthful empty-engine snapshot
        self._pressure = self._compute_pressure()
        flight_recorder.touch()
        device_telemetry.touch()
        timeseries.touch()
        if self._lane is not None and not self._lane.leader:
            # a follower rank runs the leader's programs on its heads; it
            # takes no request and serves no metrics. A resurrection is
            # swapped into the loop that follows the lane already
            self._warmed = True
            self._owns_metrics_server = False
            self.metrics_server = None
            if self._lane.thread is None:
                self._lane.follow(self)
            return
        if self._lane is not None:
            if "lane" in carry:
                self._lane.announce_rebuild(self.incarnation,
                                            self._degraded_spec_off)
            self._lane.wrap(self)
        if self._on_death is None:
            # a supervised engine never registers: the supervisor is the
            # stable /readyz and /stats entity across incarnations
            exporter.register_engine(self)
        try:
            if self._cfg.warmup:
                self._warmup()
            self._warmed = True
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name=f"{name}-genstep")
            self._thread.start()
            self._owns_metrics_server = (metrics_port is not None
                                         and int(metrics_port) == 0)
            self.metrics_server = None
            self.metrics_server = exporter.start_metrics_server(
                metrics_port)
        except Exception:
            exporter.unregister_engine(self)   # no-op when supervised
            if self._step_log is not None:
                step_log.unregister(self._step_log)
            if self._lane is not None and "lane" not in carry:
                # no supervisor will send this lane a rebuild
                self._lane.stop()
            raise

    def _tp_lane(self, mesh):
        """The lane of a tp > 1 engine: this rank's slice along 'tp' of
        `mesh` (by default `tp_mesh(tp)`, the world's first tp ranks),
        with its own tp and control groups (`serving.tp_lane`); the
        slice's first rank schedules. Raises where no process group of at
        least tp ranks is live, and on a rank outside the mesh."""
        from ..distributed.env import get_rank, get_world_size, \
            is_initialized
        from ..parallel.spmd import tp_mesh
        from .tp_lane import TPLane
        tp = self._tp
        if not is_initialized() or get_world_size() < tp:
            raise InvalidArgumentError(
                f"{self.name}: GenerationConfig(tp={tp}) serves over {tp} "
                f"ranks of one process group (one a card), and "
                f"{'none is live' if not is_initialized() else 'the world has %d' % get_world_size()}: "
                f"start {tp} ranks with python -m "
                f"paddle_tpu_torch.distributed.launch --nproc_per_node "
                f"{tp} (or distributed.spawn) and call "
                f"distributed.init_parallel_env() in each before building "
                f"the engine")
        if mesh is None:
            mesh = tp_mesh(tp)
        if mesh.coords is None:
            raise InvalidArgumentError(
                f"{self.name}: rank {get_rank()} is in no lane of "
                f"{mesh!r} over ranks {mesh.devices.ravel().tolist()}: "
                f"build the engine on the mesh's ranks only")
        return TPLane(mesh)

    def _refuse_on_follower(self):
        if self._lane is not None and not self._lane.leader:
            raise InvalidArgumentError(
                f"{self.name}: rank {self._lane.global_rank} of a tp lane "
                f"runs the programs of its first rank, "
                f"{self._lane.ranks[0]}; requests go to that rank's "
                f"engine")

    def _follow_rebuild(self, incarnation: int, degraded_spec_off: bool):
        """A follower's next incarnation, on the leader's rebuild
        descriptor: this engine's pools go first (as the leader's went
        before its rebuild), then the supervisor builds the next engine
        on the same lane from the same sharded weights, ledger and
        rings."""
        if self._rebuild is None:
            raise InvalidArgumentError(
                f"{self.name}: the lane's leader rebuilt its engine, but "
                f"this follower is not supervised")
        self._cache.release_pools()
        return self._rebuild(incarnation, {
            "ledger": self._ledger, "step_log": self._step_log,
            "audit": self._audit, "W": self._W, "lane": self._lane,
            "degraded_spec_off": bool(degraded_spec_off)})

    @staticmethod
    def _fresh_it() -> dict:
        """The per-iteration counters `_record_iteration` turns into a
        StepRecord (zeroed every iteration, step ring on or off)."""
        return {"admitted": 0, "completed": 0, "expired": 0,
                "poisoned": 0, "aborted": 0, "freed": 0,
                "prefix_tokens": 0, "cow_splits": 0, "tokens": 0,
                "spec_drafted": 0, "spec_accepted": 0,
                "prefill_chunks": 0, "prefill_ms": 0.0, "decode_ms": 0.0,
                "promote_ms": 0.0, "attr_idle_ms": 0.0,
                "attr_sched_ms": 0.0, "attr_wall_ms": 0.0}

    # -- device programs ---------------------------------------------------

    def _note(self, key: str):
        """Record one program shape in the ledger (once per shape)."""
        if key not in self._ledger:
            self._ledger[key] = 1
            monitor.stat_add("STAT_gen_compiles")

    def _t(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=self._device)

    def _t_async(self, a, dtype=None):
        """`_t` without waiting for the stream: on the card the host
        array goes up through pinned memory, in stream order."""
        t = torch.as_tensor(a, dtype=dtype)
        if self._device.type != "cuda":
            return t
        return t.pin_memory().to(self._device, non_blocking=True)

    def _write_pages(self, pools, layer, page_ids, offs, k, v,
                     requant=False):
        """Write K/V into `pools` in place: quantized on append in the int8
        mode (`requant=True` where the target pages may hold content: the
        tail, chunk and verify writes), else cast to the pools' type."""
        if self._quant_kv:
            kp, vp, ks, vs = pools
            paged_write_quantized(kp, ks, layer, page_ids, offs, k,
                                  requant=requant)
            paged_write_quantized(vp, vs, layer, page_ids, offs, v,
                                  requant=requant)
        else:
            kp, vp = pools
            paged_write(kp, layer, page_ids, offs, k)
            paged_write(vp, layer, page_ids, offs, v)

    def _gather_layer(self, pools, layer, pt, dtype):
        """One layer's K and V of the page-table rows `pt` [B, PP] as dense
        `dtype` views [B, H, PP*P, D] (dequantized in the int8 mode)."""
        if self._quant_kv:
            kp, vp, ks, vs = pools
            return (paged_gather_quantized(kp[layer], ks[layer], pt, dtype),
                    paged_gather_quantized(vp[layer], vs[layer], pt, dtype))
        kp, vp = pools
        return (paged_gather(kp[layer], pt).to(dtype),
                paged_gather(vp[layer], pt).to(dtype))

    # The five program families. Each is a function of tensors, the
    # weights and the pools first: it writes the pools in place, returns
    # tensors, and holds no host sync and no Python branch on a device
    # value, so `torch.export` can keep it whole for the program store.
    # `_note` inside runs where the program is traced (or, store off, at
    # each call): a program loaded from the store notes no ledger key.
    # The host-facing `_*_call` methods below (the tp lane's PROGRAMS)
    # turn host arrays into tensors and run them through `_run_program`.

    def _prefill_prog(self, W, pools, pt_row, ids, length):
        """Bucketed prefill of one prompt: writes its K/V pages (pad
        positions go to the scratch page) and returns the last real
        position's logits [V]."""
        S_b = ids.shape[1]
        self._note(f"prefill[b={S_b}]")
        h, ks, vs = gpt_prefill(W, ids, num_heads=self._Hl,
                                scale=self._scale, reduce=self._reduce)
        pos = torch.arange(S_b, device=ids.device)
        page_ids, offs = page_rows_for_positions(pt_row, pos,
                                                 self._cfg.page_size)
        # bucket-pad positions write to the scratch page, never the
        # sequence's own pages: in the int8 mode the scatter-max scales
        # must not take pad tokens' magnitudes into a real page's grid
        valid = pos < length
        page_ids = torch.where(valid, page_ids, TRASH_PAGE)
        offs = torch.where(valid, offs, 0)
        self._write_pages(pools, None, page_ids, offs, ks[:, 0], vs[:, 0])
        return gpt_logits(W, _last_real(h[0], length))

    def _tail_prog(self, W, pools, pt_row, ids, length, offset):
        """Prefill of a prompt TAIL (a prefix-cache hit, or one chunk):
        only positions [offset, offset + length) run the model; their
        queries attend the sequence's cached pages READ-ONLY (positions
        < offset) plus their own in-flight K/V, and their writes land in
        the tail's pages (pad positions go to the scratch page, so a
        shared page never receives a pad write). `offset` is a [1]
        tensor. Returns the last real position's logits [V]."""
        S_b = ids.shape[1]
        self._note(f"prefill_tail[b={S_b}]")
        P, scale = self._cfg.page_size, self._scale
        ar = torch.arange(S_b, device=ids.device)
        valid = ar < length
        # pad positions clamp to 0: neither the wpe gather nor the page
        # arithmetic reads out of range; their writes go to the scratch
        # page below
        positions = torch.where(valid, offset + ar, 0)
        # this row's pages, gathered once across all layers (dequantized
        # in the int8 mode)
        kp, vp = pools[:2]
        ksc, vsc = pools[2:] if self._quant_kv else (None, None)
        kb_all = paged_gather_layers(kp, pt_row, ksc)
        vb_all = paged_gather_layers(vp, pt_row, vsc)

        def ctx_attend(layer, q, k, v):
            return paged_prefix_attention(
                q, kb_all[layer][None].to(q.dtype),
                vb_all[layer][None].to(q.dtype), k, v, offset, scale)

        h, ks, vs = gpt_prefill_extend(W, ids, positions, ctx_attend,
                                       num_heads=self._Hl, scale=scale,
                                       reduce=self._reduce)
        page_ids, offs = page_rows_for_positions(pt_row, positions, P)
        page_ids = torch.where(valid, page_ids, TRASH_PAGE)
        offs = torch.where(valid, offs, 0)
        # requant: a CoW split page (or a chunk's partial page) arrives
        # with content and, in the int8 mode, a non-zero scale
        self._write_pages(pools, None, page_ids, offs, ks[:, 0], vs[:, 0],
                          requant=True)
        return gpt_logits(W, _last_real(h[0], length))

    def _cow_prog(self, W, pools, src, dst):
        """Copy-on-write split on the device: clone page `src`'s content
        ([1] tensors) across every layer and head to page `dst`, in place,
        with its scale rows in the int8 mode, so the private copy
        dequantizes as the shared original does."""
        self._note("cow_copy")
        for pool in pools:
            pool[:, :, dst] = pool[:, :, src]

    def _sample(self, logits, temps, smask, noise):
        """The decode programs' next token: greedy argmax, or for the
        slots in `smask` a temperature / top-k draw whose Exp(1) noise
        (`sampling_noise`, from the engine's generator) is an input. Store
        off, `noise` is None when no slot samples and the draw is
        skipped."""
        nxt = torch.argmax(logits, -1)
        if noise is None:
            return nxt
        sampled = sample_logits_with_noise(logits / temps[:, None], 1.0,
                                           self._cfg.top_k, noise)
        return torch.where(smask, sampled, nxt)

    def _decode_prog(self, W, pools, pt, toks, pos, active, temps, smask,
                     noise):
        """ONE fixed-slot decode step: each layer writes the slots' K/V
        into their pages and attends them through
        `ops.paged_ops.paged_attention` (K1 on the card), in place, in one
        program. Returns (next token [M], non-finite-logit flag [M])."""
        M = toks.shape[0]
        self._note(f"decode[m={M}]")
        P, scale = self._cfg.page_size, self._scale
        kp, vp = pools[:2]

        def write_kv(cache, layer, k, v, p):
            page_ids, offs = page_rows_for_positions(pt, p, P)
            self._write_pages(pools, layer, page_ids, offs, k, v)
            return cache

        def attend(cache, layer, q, p):
            scales = ((pools[2][layer], pools[3][layer])
                      if self._quant_kv else ())
            return paged_attention(q, kp[layer], vp[layer], pt, p, scale,
                                   *scales)

        logits, _ = gpt_decode_step(
            W, toks, pos, None, write_kv, attend, num_heads=self._Hl,
            scale=scale, reduce=self._reduce)
        nxt = self._sample(logits, temps, smask, noise)
        nxt = torch.where(active, nxt, 0)
        bad = active & ~torch.isfinite(logits).all(-1)
        return nxt, bad

    def _verify_prog(self, W, pools, pt, toks_blk, dmask, pos0, active,
                     temps, smask, noise):
        """ONE speculative verify step: score every live slot's [current
        token + K drafts] block (K+1 positions) in one pass over the
        paged cache (`gpt_spec_verify`), accept the longest greedily
        agreeing draft prefix on the device, and commit only the
        consumed positions' K/V: rejected draft lanes, inactive slots
        and clamped pad positions write to the scratch page, so a
        rejected draft never dirties a real page (that routing IS the
        rollback). Block queries attend the cached pages READ-ONLY
        (per-slot prefix length = the slot's cache position) plus the
        block's own K/V. Sampled slots take no drafts and sample their
        first position as the decode step does. Returns (accepted drafts
        [M], next token [M], non-finite flag [M])."""
        M, K1 = toks_blk.shape
        self._note(f"verify[k={K1 - 1}]")
        P, scale = self._cfg.page_size, self._scale
        dev = toks_blk.device
        # pad / overflow positions clamp into the wpe range; their writes
        # go to the scratch page (drafts are truncated to each request's
        # token budget, so every consumed position is in range)
        positions = (pos0.long()[:, None]
                     + torch.arange(K1, device=dev)[None, :]
                     ).clamp(0, self._max_position - 1)

        def ctx_attend(layer, q, k, v):
            kb, vb = self._gather_layer(pools, layer, pt, q.dtype)
            return paged_prefix_attention(q, kb, vb, k, v, pos0, scale)

        h, ks, vs = gpt_spec_verify(W, toks_blk, positions, ctx_attend,
                                    num_heads=self._Hl, reduce=self._reduce)
        logits = gpt_logits(W, h)                           # [M, K1, V]
        greedy = torch.argmax(logits, -1)
        # draft j+1 is accepted iff it equals greedy[j], the model's token
        # after position j; n_acc = the longest agreeing prefix
        agree = (greedy[:, :-1] == toks_blk[:, 1:]) & dmask
        n_acc = torch.cumprod(agree.long(), dim=1).sum(1)
        n_acc = torch.where(smask, 0, n_acc)
        bonus = torch.gather(greedy, 1, n_acc[:, None])[:, 0]
        nxt = torch.where(smask, self._sample(logits[:, 0], temps, smask,
                                              noise), bonus)
        nxt = torch.where(active, nxt, 0)
        consumed = (torch.arange(K1, device=dev)[None, :]
                    <= n_acc[:, None])
        finite = torch.isfinite(logits).all(-1)             # [M, K1]
        bad = active & (consumed & ~finite).any(1)
        commit = consumed & active[:, None]
        page_ids, offs = page_rows_for_positions(pt, positions, P)
        page_ids = torch.where(commit, page_ids, TRASH_PAGE).reshape(-1)
        offs = torch.where(commit, offs, 0).reshape(-1)
        L, _, H, _, D = ks.shape
        # [L, M, H, K1, D] -> [L, H, M*K1, D]: the prefill-shaped
        # all-layers write (index m*K1 + j, as page_ids); requant: commits
        # land on each slot's current partial page, which holds content
        self._write_pages(pools, None, page_ids, offs,
                          ks.transpose(1, 2).reshape(L, H, M * K1, D),
                          vs.transpose(1, 2).reshape(L, H, M * K1, D),
                          requant=True)
        return n_acc, nxt, bad

    def _run_program(self, name, prog, *args):
        """Run program `name`: the program warmup resolved (loaded from
        the store, or exported and written back) when there is one; else,
        store on, resolve it now (`_warm_one`); store off, run `prog`
        eagerly, today's path. Returns its outputs."""
        ex = self._execs.get(name)
        if ex is not None:
            return ex(self._W, self._pools(), *args)
        if self._store is None:
            return prog(self._W, self._pools(), *args)
        return self._warm_one(name, prog, args)

    def _prefill_call(self, pt_row, ids, length):
        """The `prefill[b=S]` program on host arrays: the page-table row,
        the bucket-padded ids [1, S] and the prompt length. Returns the
        last real position's logits [V] (on the device)."""
        return self._run_program(
            f"prefill[b={ids.shape[1]}]", self._prefill_prog,
            self._t(pt_row), self._t(ids, torch.long),
            self._t(np.int64(length)))

    def _tail_prefill_call(self, pt_row, ids, length, offset):
        """The `prefill_tail[b=S]` program on host arrays (`_tail_prog`).
        Returns the last real position's logits [V]."""
        return self._run_program(
            f"prefill_tail[b={ids.shape[1]}]", self._tail_prog,
            self._t(pt_row), self._t(ids, torch.long),
            self._t(np.int64(length)),
            self._t(np.asarray([offset], np.int64)))

    def _pools(self):
        """The device pools: K and V pages, and the scale pools in the
        int8 mode."""
        c = self._cache
        return ((c.k_pages, c.v_pages, c.k_scales, c.v_scales)
                if self._quant_kv else (c.k_pages, c.v_pages))

    def _cow_copy(self, src: int, dst: int):
        """The `cow_copy` program: page `src` cloned into page `dst`."""
        self._run_program("cow_copy", self._cow_prog,
                          self._t(np.asarray([src], np.int64)),
                          self._t(np.asarray([dst], np.int64)))

    def _noise(self, M, smask):
        """The sampling draw of a decode or verify step, taken from the
        engine's generator before the program runs (the draw the eager
        path made inside it, in the same order): None when no slot
        samples and no program is stored, else [M, V] Exp(1) noise, or
        ones when no slot samples (the stored programs always take an
        input, and ones draw nothing)."""
        V = self._W["wte"].shape[0]
        if smask.any():
            return sampling_noise((M, V), self._device, self._gen)
        if self._store is None:
            return None
        if self._ones is None or self._ones.shape[0] != M:
            self._ones = torch.ones(M, V, device=self._device)
        return self._ones

    def _decode_call(self, pt, toks, pos, active, temps, smask):
        """ONE fixed-slot decode step (`_decode_prog`) on host arrays.
        Returns host arrays (next token [M] int, non-finite-logit flag [M]
        bool): the step's only device-to-host copy."""
        M = toks.shape[0]
        nxt, bad = self._run_program(
            f"decode[m={M}]", self._decode_prog, self._t(pt),
            self._t(toks, torch.long), self._t(pos), self._t(active),
            self._t(np.maximum(temps, 1e-6)), self._t(smask),
            self._noise(M, smask))
        out = torch.stack([nxt, bad.long()]).cpu().numpy()
        return out[0], out[1].astype(bool)

    def _verify_call(self, pt, toks_blk, dmask, pos0, active, temps, smask):
        """ONE speculative verify step (`_verify_prog`) on host arrays.
        Returns host arrays (accepted drafts [M], next token [M],
        non-finite flag [M])."""
        M, K1 = toks_blk.shape
        n_acc, nxt, bad = self._run_program(
            f"verify[k={K1 - 1}]", self._verify_prog, self._t(pt),
            self._t(toks_blk, torch.long), self._t(dmask), self._t(pos0),
            self._t(active), self._t(np.maximum(temps, 1e-6)),
            self._t(smask), self._noise(M, smask))
        out = torch.stack([n_acc, nxt, bad.long()]).cpu().numpy()
        return out[0], out[1], out[2].astype(bool)

    def _zero_pages(self, pages):
        """Zero freed pages on device, in rows of the fixed zeroing width
        (one sequence's free fits one row; a prefix-cache eviction can
        return more pages at once). The trash-padded row also scrubs the
        scratch page. The int8 mode resets the pages' scales to 0 too, so
        the next owner starts from a clean grid and a poisoned page's
        scale cannot outlive its content."""
        PP = self._cfg.pages_per_seq
        for i in range(0, max(len(pages), 1), PP):
            row = self._t_async(self._cache.zero_rows(pages[i:i + PP]),
                                torch.long)
            for pool in self._pools():
                pool[:, :, row] = 0

    # -- host tier ---------------------------------------------------------

    def _tier_gather(self, page: int) -> HostEntry:
        """One page's demotion: a free slot of the host slab (pinned on
        the card) is taken for it and the page queued. The copy is the
        `tier_gather` program at `_tier_gather_flush`, which the prefix
        cache runs when its eviction pass is over, before the engine can
        zero or reuse a freed page. The entry counts the lane's bytes of
        a page: a tp rank's slot holds its heads."""
        slot, views = self._slab.take()
        self._gather_q.append((page, slot))
        return HostEntry(*views, slot=slot, nbytes=self._page_bytes)

    def _tier_gather_flush(self):
        """Run the `tier_gather` program over the pages queued in this
        eviction pass (the leader chose their slots)."""
        queued, self._gather_q = self._gather_q, []
        if queued:
            self._tier_gather_call(queued)

    def _tier_gather_call(self, queued):
        """The `tier_gather` program: the (page, slot) pairs' raw blocks
        (and int8 scale rows) in one batch, one gather a pool into a
        device buffer of slot-shaped rows, then one copy a page into its
        slot of this rank's slab. On the card the copies are queued on
        the engine's stream and not waited for: every later write of a
        page (its zeroing when freed, a new owner's prefill) queues
        behind them on that stream, and a promotion's uploads wait for
        it (`_tier_upload_call`). It first waits for the upload stream:
        a slot freed by a promotion may still be read by that
        promotion's uploads."""
        self._note("tier_gather")
        # a slot released and taken again within one pass holds the
        # later page
        page_of = {slot: page for page, slot in queued}
        slots = list(page_of)
        cuda = self._device.type == "cuda"
        if cuda and self._upload_stream is not None:
            torch.cuda.current_stream(self._device).wait_stream(
                self._upload_stream)
        idx = self._t_async(np.asarray([page_of[s] for s in slots],
                                       np.int64))
        rows = torch.empty(len(slots), self._slab.slot_bytes,
                           dtype=torch.uint8, device=self._device)
        for pool, dst in zip(self._pools(), self._slab.part_views(rows)):
            dst.copy_(pool[:, :, idx].movedim(2, 0))
        for row, slot in zip(rows, slots):
            self._slab.raw(slot).copy_(row, non_blocking=cuda)

    def _tier_gather_page(self, page: int):
        """Demotion gather callback (`PrefixCache.attach_tier`): the
        page's `HostEntry`, or None when the `kv_tier.demote_gather`
        failpoint fires (the eviction then proceeds plain, content
        discarded)."""
        if failpoints.fire("kv_tier.demote_gather") is not None:
            return None
        return self._tier_gather(page)

    def _tier_upload_call(self, key, slots):
        """The upload half of a promotion chunk: stage `slots` of this
        rank's slab on the device, one copy of a slot's bytes a page,
        under `key` for the `_tier_write_call` that scatters it. On the
        card the copies run on the upload stream into a fresh staging
        buffer (the slab is pinned, so they are asynchronous DMA), after
        the engine's stream has queued the slots' gathers, and the event
        recorded after them is kept for the scatter to wait on; on the
        CPU the slots are stacked in place. Staged: blocks [c, L, H, P,
        D] (scale blocks [c, L, H]), views of the staging buffer."""
        if self._device.type != "cuda":
            rows = torch.stack([self._slab.raw(s) for s in slots])
            self._staged[key] = (self._slab.part_views(rows), None)
            return
        if self._upload_stream is None:
            self._upload_stream = torch.cuda.Stream(self._device)
        self._upload_stream.wait_stream(
            torch.cuda.current_stream(self._device))
        with torch.cuda.stream(self._upload_stream):
            rows = torch.empty(len(slots), self._slab.slot_bytes,
                               dtype=torch.uint8, device=self._device)
            for row, s in zip(rows, slots):
                row.copy_(self._slab.raw(s), non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._upload_stream)
        self._staged[key] = (self._slab.part_views(rows), ev)

    def _tier_write_call(self, key, targets):
        """The `tier_write[w=C]` program: scatter the chunk staged under
        `key` into its target pages on the current stream, after the
        chunk's upload event. The staging buffer is marked in use by
        this stream, so the allocator cannot hand it back to the upload
        stream before the scatter has read it. A chunk staged under an
        older key was left by an abandoned promotion: it goes now, on
        every rank alike."""
        self._note(f"tier_write[w={self._cfg.kv_tier_chunk_pages}]")
        blocks, ev = self._staged.pop(key)
        for old in [k for k in self._staged if k < key]:
            del self._staged[old]
        idx = self._t_async(np.asarray(targets, np.int64))
        if ev is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(ev)
            blocks[0].record_stream(cur)
        for pool, b in zip(self._pools(), blocks):
            pool[:, :, idx] = b.movedim(0, 2)

    def _tier_stage(self, entries) -> int:
        """Stage host entries through `_tier_upload_call`; returns the
        key its scatter names."""
        self._stage_seq += 1
        self._tier_upload_call(self._stage_seq, [e.slot for e in entries])
        return self._stage_seq

    def _promote_upload(self, req: _GenRequest, host_digests,
                        matched_hbm: int) -> bool:
        """Re-upload an admission's matched host-tier run into its own
        fresh target pages (`pt_row[matched_hbm:]`), double-buffered:
        chunk i+1's upload is issued before chunk i's scatter, so on the
        card the two overlap, and nothing here waits for the device —
        the tail prefill queues behind the scatters on the same stream.
        Returns True on success, False on abandon.

        Abandon (the `kv_tier.promote_upload` failpoint, checked before
        each chunk's scatter): the target pages written so far are
        zeroed, content and int8 scale grids (the tail prefill's
        requant write would otherwise merge junk scales into a grid that
        only ever widens); the never-written rest is still zero (fresh
        pages arrive zeroed), and the caller falls back to prefilling
        the whole suffix cold. The popped host entries are gone either
        way: move semantics, one copy ever."""
        C = self._cfg.kv_tier_chunk_pages
        n = len(host_digests)
        targets = [int(p) for p in
                   req.pt_row[matched_hbm:matched_hbm + n]]
        entries, cascaded = self._prefix.consume_promoted(host_digests)
        if cascaded:
            self._audit.audit("KV_TIER_EVICT", rid=req.rid,
                              entries=cascaded)
        if any(e is None for e in entries):
            # protect() held these across the eviction pass, so a
            # missing entry is a logic fault: abandon before any write
            self._tier.note_abandon()
            self._audit.audit("KV_PROMOTE_ABANDON", rid=req.rid,
                              pages=n, written=0)
            return False
        t0 = _now_ms()
        written = 0
        staged = self._tier_stage(entries[:C])
        while written < n:
            if failpoints.fire("kv_tier.promote_upload") is not None:
                self._zero_pages(targets[:written])
                self._tier.note_abandon()
                self._audit.audit("KV_PROMOTE_ABANDON", rid=req.rid,
                                  pages=n, written=written)
                self._it["promote_ms"] += _now_ms() - t0
                return False
            hi = min(written + C, n)
            nxt = (self._tier_stage(entries[hi:hi + C]) if hi < n
                   else None)
            with RecordEvent(f"generation::tier_write[w={C}]"):
                self._tier_write_call(staged, targets[written:hi])
            written, staged = hi, nxt
        self._tier.note_promotion(n)
        self._audit.audit("KV_PROMOTE", rid=req.rid, pages=n,
                          tokens=n * self._cfg.page_size,
                          ms=round(_now_ms() - t0, 3))
        self._it["promote_ms"] += _now_ms() - t0
        return True

    # -- the program store's seam --------------------------------------------

    def _store_key_material(self) -> dict:
        """Everything that shapes the traced programs, JSON-able: the
        content key the store's directories hang off. The decode-weight
        pytree spec tells quantized weights apart (int8 leaves and scale
        rows have their own types and shapes); the FLAGS listed are the
        kernel selections a traced program bakes in, and `kernels` the
        hash of each kernel source a program can launch, so an edited
        kernel misses."""
        from ..jit import pytree_spec
        from ..ops import _build
        mcfg = self._model.gpt.config
        cuda = self._device.type == "cuda"
        return {
            "model": {k: v for k, v in sorted(vars(mcfg).items())},
            "weights_spec": pytree_spec(self._W),
            "engine": {
                "max_slots": self._cfg.max_slots,
                "page_size": self._cfg.page_size,
                "num_pages": self._cfg.num_pages,
                "pages_per_seq": self._cfg.pages_per_seq,
                "prefill_buckets": list(self._cfg.prefill_buckets),
                "kv_dtype": self._cache.dtype,
                "quant_kv": bool(self._quant_kv),
                "use_tail": bool(self._use_tail),
                "prefix_cache": self._prefix is not None,
                "kv_tier": self._tier is not None,
                "kv_tier_chunk_pages": self._cfg.kv_tier_chunk_pages,
                "spec_k": self._spec_k,
                "top_k": self._cfg.top_k,
                "tp": self._tp,
            },
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "backend": self._device.type,
            "device_kind": (torch.cuda.get_device_name(self._device)
                            if cuda else "cpu"),
            "device": str(self._device),
            "flags": {n: flag(n) for n in (
                "FLAGS_use_paged_attention", "FLAGS_use_flash_attention",
                "FLAGS_flash_attention_min_seq")},
            "kernels": {src: _build.source_hash(src) for src in (
                "paged_attention.cu", "flash_fwd.cu")},
        }

    def _reset_pools(self):
        """Zero the pools after a loaded program failed its probe at
        warmup: they then hold nothing but its scratch-page writes, so
        zeros are the right state (after warmup a failed program's
        writes are rewritten by the export that replaces it)."""
        for pool in self._pools():
            pool.zero_()

    def _selfcheck_alias(self, program, recorded: str):
        """The structural gate on a LOADED program: the inputs it writes
        in place (`jit.compiled_alias_spec`) must be the ones recorded
        when it was exported, and must not be none: every covered program
        writes the pools, so a program that writes nothing in place
        writes copies (a functionalized program, the aliasing-drop
        corruption class: the engine would read stale pools). Returns an
        error string, or None when the check passes."""
        from ..jit import compiled_alias_spec
        live = compiled_alias_spec(program)
        if live != recorded:
            return (f"alias spec mismatch: loaded={live!r} vs "
                    f"recorded={recorded!r}")
        if not live.strip():
            return ("empty alias spec on a pool-writing program (the "
                    "aliasing-drop corruption class)")
        return None

    @staticmethod
    def _probe_ok(name: str, out) -> bool:
        """Numeric smoke verdict on one run of a loaded program: the
        prefill programs must return finite logits, decode / verify must
        not raise their non-finite flag; cow_copy completing is its
        probe."""
        if name.startswith("prefill"):
            return bool(torch.isfinite(out).all())
        if name.startswith(("decode", "verify")):
            return not bool(out[-1].any())
        return True

    def _warm_one(self, name: str, prog, args):
        """Resolve program `name` through the store, and run it once.

        Hit: load, run the in-place self-check, then the numeric smoke
        probe (ONE run: this call itself); only then does the program
        serve and `loaded[name]` count it. Any failure bumps
        STAT_pack_selfcheck_failures, dumps a flight record, zeroes the
        pools at warmup and falls through to an export, so a corrupt or
        stale entry costs a trace, never a wrong answer. Miss: export
        `prog` with `torch.export` (its `_note` runs at trace time, so
        the ledger counts it as store off does), write it back, run it.
        An export that fails raises: nothing quietly runs the eager
        path instead."""
        W, pools = self._W, self._pools()
        hit = self._store.load(name)
        if hit is not None:
            program, recorded = hit
            err = self._selfcheck_alias(program, recorded)
            if err is None:
                try:
                    module = program.module()
                    out = module(W, pools, *args)
                    if not self._probe_ok(name, out):
                        err = "numeric smoke probe failed"
                except Exception as e:  # noqa: BLE001 — falls back below
                    err = f"smoke probe raised: {e!r}"
            if err is None:
                self._execs[name] = module
                self._loaded[name] = self._loaded.get(name, 0) + 1
                return out
            monitor.stat_add("STAT_pack_selfcheck_failures")
            flight_recorder.dump(
                "program_store_selfcheck",
                {"engine": self.name, "program": name,
                 "key": self._store.key, "error": err})
            if not self._warmed:
                self._reset_pools()
        exported = torch.export.export(_Program(prog), (W, pools, *args),
                                       strict=False)
        module = exported.module()
        self._execs[name] = module
        self._store.store(name, exported)
        return module(W, pools, *args)

    @torch.inference_mode()
    def _warmup(self):
        """Run every prefill bucket (and, with the prefix cache or
        chunking on, its tail program), the CoW copy with the prefix
        cache, the tier gather and write with the host tier, and the
        decode step (or, with speculation on, the ONE verify[k] program
        that replaces it) once, so the kernels are built and the ledger
        is complete before the first request, as the JAX engine's
        warmup compiles them. Writes land only on the scratch page. With
        a program store each program resolves through `_warm_one`: a
        key-matched entry loads (self-check and smoke probe first) and
        the ledger does not move, `loaded` counts it; a miss exports it
        and writes it back, so the NEXT process loads it."""
        PP = self._cfg.pages_per_seq
        trash = np.zeros((PP,), np.int32)
        with RecordEvent("generation::warmup"):
            self._warmup_programs(trash)

    def _warmup_programs(self, trash):
        for b in self._cfg.prefill_buckets:
            ids = np.zeros((1, b), np.int64)
            self._prefill_call(trash, ids, 1).cpu()
            if self._use_tail:
                self._tail_prefill_call(trash, ids, 1, 0).cpu()
        if self._prefix is not None:
            self._cow_copy(TRASH_PAGE, TRASH_PAGE)
        if self._tier is not None:
            # the tier programs, on the scratch page: a gather, then two
            # full chunks of its copy in flight at once and scattered
            # back, as a promotion runs them, so the staging buffers a
            # promotion uses are allocated here and not on a request
            C = self._cfg.kv_tier_chunk_pages
            e = self._tier_gather(TRASH_PAGE)
            self._tier_gather_flush()
            staged = [self._tier_stage([e] * C) for _ in range(2)]
            for key in staged:
                self._tier_write_call(key, [TRASH_PAGE] * C)
            self._slab.release(e.slot)
        if self._spec_k:
            self._verify_call(*self._spec_arrays()[0])
        if (not self._spec_k or self._poison_degrade_k
                or self._degraded_spec_off):
            # with speculation on, the poison-storm detector may switch
            # the engine to the plain decode step mid-flight: warm it too,
            # so the DEGRADED_SPEC_OFF flip adds no ledger key (the ledger
            # then holds both verify[k] and decode[m])
            self._decode_call(*self._step_arrays())
        self._zero_pages([])

    # -- request intake ----------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               timeout_ms: Optional[float] = None,
               do_sample: bool = False,
               temperature: float = 1.0,
               trace_id: Optional[str] = None) -> Future:
        """Enqueue one prompt (1-D int token ids); returns a Future of
        the full sequence (prompt + generated tokens, numpy int32; EOS,
        when hit, is included). Raises `EngineOverloaded` at
        max_queue_depth, `InvalidArgumentError`/`ResourceExhaustedError`
        for requests that could never run. `trace_id` is an upstream
        hop's 16-hex trace id; omitted, the engine mints its own when
        FLAGS_trace_propagation is on."""
        return self._submit(prompt_ids, max_new_tokens, eos_token_id,
                            timeout_ms, do_sample, temperature,
                            stream=None, ttft_timeout_ms=None,
                            trace_id=trace_id).future

    def submit_stream(self, prompt_ids,
                      max_new_tokens: Optional[int] = None,
                      eos_token_id: Optional[int] = None,
                      timeout_ms: Optional[float] = None,
                      ttft_timeout_ms: Optional[float] = None,
                      do_sample: bool = False,
                      temperature: float = 1.0,
                      trace_id: Optional[str] = None) -> TokenStream:
        """Streaming submit: tokens leave the engine as they are decoded.
        `ttft_timeout_ms` is HARD (expiry before the first token cancels
        with ExecutionTimeoutError); `timeout_ms` is SOFT once tokens
        flow (expiry mid-stream resolves with what was delivered)."""
        if ttft_timeout_ms is not None and float(ttft_timeout_ms) < 0:
            raise InvalidArgumentError("ttft_timeout_ms must be >= 0")
        stream = TokenStream(Future())
        self._submit(prompt_ids, max_new_tokens, eos_token_id, timeout_ms,
                     do_sample, temperature, stream=stream,
                     ttft_timeout_ms=ttft_timeout_ms, trace_id=trace_id)
        return stream

    @RecordEvent("generation::submit")
    def _submit(self, prompt_ids, max_new_tokens, eos_token_id, timeout_ms,
                do_sample, temperature, stream, ttft_timeout_ms,
                trace_id=None):
        self._refuse_on_follower()
        if torch.is_tensor(prompt_ids):
            prompt_ids = prompt_ids.cpu().numpy()
        prompt = np.asarray(prompt_ids)
        if prompt.ndim != 1 or prompt.size < 1:
            raise InvalidArgumentError(
                f"{self.name}: prompt_ids must be a non-empty 1-D token "
                f"array, got shape {tuple(prompt.shape)}")
        if not np.issubdtype(prompt.dtype, np.integer):
            raise InvalidArgumentError(
                f"{self.name}: prompt_ids must be integer token ids")
        prompt = prompt.astype(np.int32)
        max_new = int(self._cfg.max_new_tokens
                      if max_new_tokens is None else max_new_tokens)
        if max_new < 1:
            raise InvalidArgumentError("max_new_tokens must be >= 1")
        S = int(prompt.size)
        total = S + max_new
        if S > self._cfg.prefill_buckets[-1]:
            raise InvalidArgumentError(
                f"{self.name}: prompt length {S} exceeds the largest "
                f"prefill bucket {self._cfg.prefill_buckets[-1]}")
        if total > self._max_position:
            raise InvalidArgumentError(
                f"{self.name}: {total} positions exceed "
                f"max_position_embeddings={self._max_position}")
        if not self._cache.fits(total):
            raise ResourceExhaustedError(
                f"{self.name}: {total} tokens need "
                f"{self._cache.pages_needed(total)} pages but the pool "
                f"holds {self._cache.usable_pages} "
                f"(pages_per_seq={self._cache.pages_per_seq}); raise "
                f"FLAGS_paged_num_pages or shrink the request")
        if self._admit_clamped and not self._cache.can_admit(total):
            # degraded admission clamp: the allocator was exhausted again
            # and again, so a request the pool cannot cover now would only
            # queue toward a timeout; shed it fast, typed
            monitor.stat_add("STAT_gen_rejected")
            raise ResourceExhaustedError(
                f"{self.name}: admission clamped after repeated allocator "
                f"exhaustion (FLAGS_gen_exhaust_clamp_k) and the pool "
                f"cannot cover {total} tokens now; retry later or shrink "
                f"the request")
        t = _now_ms()
        tmo = (self._cfg.request_timeout_ms if timeout_ms is None
               else float(timeout_ms))
        ttft_tmo = 0.0 if ttft_timeout_ms is None else float(ttft_timeout_ms)
        # trace context: an upstream hop's id continues its chain (a
        # flow STEP); a direct submit mints the chain root when
        # propagation is on; off = no id, no cost
        tid, trace_root = None, True
        if trace_id is not None and trace_context.is_trace_id(str(trace_id)):
            tid, trace_root = str(trace_id), False
        elif trace_context.enabled():
            tid = trace_context.new_trace_id()
        reject_depth = None
        with self._cv:
            if self._closed:
                raise UnavailableError(f"{self.name}: engine is shut down")
            if len(self._queue) >= self._cfg.max_queue_depth:
                reject_depth = len(self._queue)
            else:
                req = _GenRequest(
                    prompt, max_new, eos_token_id, bool(do_sample),
                    float(temperature),
                    stream.future if stream is not None else Future(),
                    None if not tmo else t + tmo, t,
                    spans.start_gen(self.name, incarnation=self.incarnation,
                                    trace_id=tid, trace_root=trace_root),
                    stream=stream,
                    ttft_deadline_ms=t + ttft_tmo if ttft_tmo else None,
                    trace_id=tid)
                if stream is not None:
                    stream.trace_id = tid
                self._req_seq += 1
                req.ordinal = self._req_seq
                self._queue.append(req)
                monitor.stat_add("STAT_gen_queue_depth")
                self._cv.notify_all()
        if reject_depth is not None:
            # audited outside the lock: the JSONL sink's disk write must
            # not stall the step thread behind rejected clients
            monitor.stat_add("STAT_gen_rejected")
            self._audit.audit("REJECT_QUEUE_FULL", queue_depth=reject_depth)
            self._audit.flush_sink()
            raise EngineOverloaded(
                f"{self.name}: queue depth {self._cfg.max_queue_depth} "
                f"reached; shed load or raise FLAGS_gen_max_queue_depth")
        monitor.stat_add("STAT_gen_requests")
        return req

    def generate(self, prompt_ids, **kw) -> np.ndarray:
        """Synchronous submit: blocks for this prompt's full sequence."""
        return self.submit(prompt_ids, **kw).result()

    def replay_submit(self, entry: ReplayEntry, prompt: np.ndarray,
                      max_new: int, skip_stream: int = 0) -> None:
        """Re-enqueue a crash-manifest entry on THIS (rebuilt) engine, the
        supervisor's seam. The caller's future and stream are kept as
        they are; `prompt`/`max_new` are the supervisor's continuation
        (prompt + generated so far, the remaining budget) or the original
        pair for a from-scratch replay, where `skip_stream` suppresses the
        greedy tokens a stream already delivered. Deadlines carry over
        unchanged (a replay buys no time). The queue-depth bound does not
        apply: the request was admitted once already."""
        prompt = np.asarray(prompt, np.int32)
        with self._cv:
            if self._closed:
                raise UnavailableError(f"{self.name}: engine is shut down")
            # the hard TTFT deadline is met once any token was delivered,
            # in an earlier incarnation too; the whole-request deadline
            # carries over as it is
            ttft = (entry.ttft_deadline_ms
                    if not entry.toks and not entry.delivered else None)
            req = _GenRequest(
                prompt, int(max_new), entry.eos, entry.do_sample,
                entry.temperature, entry.future, entry.deadline_ms,
                entry.t_enqueue_ms,
                spans.start_gen(self.name, incarnation=self.incarnation,
                                trace_id=entry.trace_id, trace_root=False),
                stream=entry.stream, ttft_deadline_ms=ttft,
                trace_id=entry.trace_id)
            req.claimed = entry.claimed
            req.retries = entry.retries + 1
            req.skip_stream = int(skip_stream)
            self._req_seq += 1
            req.ordinal = self._req_seq
            self._queue.append(req)
            monitor.stat_add("STAT_gen_queue_depth")
            self._cv.notify_all()
        monitor.stat_add("STAT_gen_replayed_requests")
        self._audit.audit(
            "REPLAY_ADMIT", rid=req.rid, orig_rid=entry.rid,
            retries=req.retries, generated=len(entry.toks),
            continuation=int(prompt.size) > int(entry.prompt.size),
            skip_stream=int(skip_stream),
            **({"trace": entry.trace_id} if entry.trace_id else {}))

    # -- step loop ---------------------------------------------------------

    def _num_active(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    def _loop(self):
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        handed_over = False
        try:
            with torch.inference_mode():
                self._run()
        except BaseException as e:  # noqa: BLE001 — never hang submitters
            # _die runs outside the inference mode: a supervisor rebuilds
            # the next engine from here
            handed_over = self._die(e)
            if handed_over:
                return   # supervised: handed over and handled
            raise
        finally:
            # a supervised death hands the lane to the next incarnation
            # (or to the supervisor, which ends it at its shutdown)
            if self._lane is not None and not handed_over:
                self._lane.stop()

    def _run(self):
        # goodput attribution marks: `t_mark` is the previous
        # iteration's record boundary, so the wall is mark to mark and
        # the record/flush work after a record lands is charged to the
        # NEXT iteration's bookkeeping bucket: consecutive records tile
        # the step thread's timeline exactly
        t_mark = time.perf_counter()
        idle_s = 0.0
        while True:
            with self._cv:
                while (not self._queue and self._num_active() == 0
                       and not self._closed):
                    t0 = time.perf_counter()
                    self._cv.wait()
                    idle_s += time.perf_counter() - t0
                if self._closed and self._abort:
                    self._evict_all(UnavailableError(
                        f"{self.name}: engine shut down"))
                    # the aborted/freed counts land in the ring too, so
                    # its sums reconcile on the abort exit
                    self._record_iteration()
                    self._flush_resolutions()
                    return
                if (self._closed and not self._queue
                        and self._num_active() == 0):
                    return
            t0 = time.perf_counter()
            self._admit()
            self._expire_active()
            if self._cfg.prefill_chunk:
                self._advance_prefills()
            sched_s = time.perf_counter() - t0
            stepped = False
            if any(r is not None and r.prefill_pos is None
                   for r in self._slots):
                self._step()
                stepped = True
            now = time.perf_counter()
            it = self._it
            it["attr_idle_ms"] = idle_s * 1000.0
            it["attr_sched_ms"] = sched_s * 1000.0
            it["attr_wall_ms"] = (now - t_mark) * 1000.0
            t_mark, idle_s = now, 0.0
            self._record_iteration()
            # sink before resolutions: a caller woken by result() may
            # read the JSONL at once, and its own event must be there
            self._audit.flush_sink()
            self._flush_resolutions()
            if not stepped:
                with self._cv:
                    if (self._queue and self._num_active() == 0
                            and not self._abort):
                        # unadmittable head (page exhaustion): bounded
                        # wait so queued deadlines still expire
                        t0 = time.perf_counter()
                        self._cv.wait(0.01)
                        idle_s += time.perf_counter() - t0

    def _record_iteration(self):
        """One compact scheduler record per engine iteration: decisions
        taken this pass, queue pressure, page-pool occupancy, prefill
        and decode wall, and the six goodput buckets. Host bookkeeping
        only: one ring append and a few histogram observes. The
        per-iteration counters are zeroed whether or not the ring is
        on."""
        it, self._it = self._it, self._fresh_it()
        # pressure snapshot, republished on the step thread (the only
        # thread that moves the allocator), so pressure() takes no lock
        self._pressure = self._compute_pressure()
        if self._step_log is None:
            return
        self._iters += 1
        with self._cv:
            depth = len(self._queue)
            oldest = (self._queue[0].t_enqueue_ms if self._queue
                      else None)
            live = self._num_active()
        tier_dem = tier_pro = 0
        if self._tier is not None:
            d, p = self._tier.demotions, self._tier.promotions
            ld, lp = self._tier_counts
            tier_dem, tier_pro = d - ld, p - lp
            self._tier_counts = (d, p)
        # six buckets that reconcile EXACTLY to the iteration wall: every
        # stored value is rounded first and bookkeeping is the remainder
        # of the rounded parts. The admit bucket is the scheduler time
        # less the prefill and promote work nested inside it
        a_wall = round(it["attr_wall_ms"], 3)
        a_idle = round(it["attr_idle_ms"], 3)
        a_prefill = round(it["prefill_ms"], 3)
        a_promote = round(it["promote_ms"], 3)
        a_decode = round(it["decode_ms"], 3)
        a_admit = round(max(0.0, it["attr_sched_ms"] - it["prefill_ms"]
                            - it["promote_ms"]), 3)
        a_book = (a_wall - a_idle - a_admit - a_prefill - a_promote
                  - a_decode)
        self._step_log.record(step_log.StepRecord(
            it=self._iters, step=self._steps_total,
            t=time.perf_counter(), live=live, queue_depth=depth,
            oldest_age_ms=(round(_now_ms() - oldest, 3)
                           if oldest is not None else 0.0),
            pages_in_use=self._cache.pages_in_use,
            free_pages=self._cache.free_pages,
            admitted=it["admitted"], completed=it["completed"],
            expired=it["expired"], poisoned=it["poisoned"],
            aborted=it["aborted"], freed=it["freed"],
            prefix_tokens=it["prefix_tokens"],
            cow_splits=it["cow_splits"], tokens=it["tokens"],
            spec_drafted=it["spec_drafted"],
            spec_accepted=it["spec_accepted"],
            prefill_chunks=it["prefill_chunks"],
            prefill_ms=a_prefill, decode_ms=a_decode,
            incarnation=self.incarnation,
            tier_demotions=tier_dem, tier_promotions=tier_pro, tp=1,
            attr_admit_ms=a_admit, attr_promote_ms=a_promote,
            attr_bookkeep_ms=a_book, attr_idle_ms=a_idle,
            attr_wall_ms=a_wall))

    def _resolve_later(self, req: Optional[_GenRequest], fut, result=None,
                       exc=None):
        """Hold a future's resolution until this iteration's record has
        landed: a caller woken by result() then sees a step ring and an
        audit tail that include its own outcome. `req` rides along so
        _die never hands a request with a staged outcome the death
        error as well."""
        self._resolve_q.append((req, fut, result, exc))

    def _resolve_req_later(self, req: _GenRequest, result=None, exc=None):
        """Request-level resolution: the stream (if any) gets its
        terminal marker (the error, or the end marker) staged before the
        future, behind the same barrier."""
        if req.stream is not None:
            self._stream_q.append((req.stream, exc if exc is not None
                                   else TokenStream._END))
        self._resolve_later(req, req.future, result, exc)

    def _stage_token(self, req: _GenRequest, tok: int):
        """Stage one token for delivery after the iteration's barrier. A
        from-scratch greedy replay suppresses its first `skip_stream`
        tokens: an earlier incarnation delivered them, and greedy
        re-derivation gives the same ones, so each reaches the caller
        once."""
        if req.stream is None:
            return
        if req.skip_stream > 0:
            req.skip_stream -= 1
            return
        self._stream_q.append((req.stream, tok))

    def _flush_resolutions(self):
        sq, self._stream_q = self._stream_q, []
        for stream, item in sq:
            stream._put(item)
        q, self._resolve_q = self._resolve_q, []
        for _req, fut, result, exc in q:
            try:
                if exc is not None:
                    fut.set_exception(exc)
                else:
                    fut.set_result(result)
            except Exception:  # noqa: BLE001 — racing caller-side cancel
                pass

    def _die(self, e: BaseException) -> bool:
        """The step loop raised. Supervised (`on_death`): build the crash
        manifest of every queued and live request, dump it, release the
        pools and hand the manifest over; returns True. Otherwise, or if
        the supervisor itself fails: fail every queued and live request
        with a typed error instead of leaving its caller waiting, audit
        each as ENGINE_DIED, dump the flight record with the step-log
        and audit tails that led here, and return False."""
        # two independent try blocks: a failed ring record on a
        # half-broken engine must not also strand the staged resolutions
        try:
            self._record_iteration()
        except Exception:  # noqa: BLE001 — best effort on a dying engine
            pass
        # requests with an outcome staged this iteration get it, never
        # the death error as well
        settled = {req.rid for req, _f, _r, _e in self._resolve_q
                   if req is not None}
        try:
            self._flush_resolutions()
        except Exception:  # noqa: BLE001 — best effort on a dying engine
            pass
        stranded = []
        with self._cv:
            self._closed = True
            self._death = e
            while self._queue:
                req = self._queue.popleft()
                monitor.stat_sub("STAT_gen_queue_depth")
                if req.rid not in settled:
                    stranded.append(req)
            self._cv.notify_all()
        active = [r for r in self._slots
                  if r is not None and r.rid not in settled]
        lane_fault = self._lane is not None and self._lane.error is not None
        if self._on_death is not None:
            manifest = CrashManifest(
                engine=self.name, incarnation=self.incarnation, error=e,
                entries=([ReplayEntry(r, queued=False)
                          for r in sorted(active, key=lambda r: r.ordinal)]
                         + [ReplayEntry(r, queued=True) for r in stranded]),
                degraded_spec_off=self._degraded_spec_off,
                kv=self._cache.manifest(), compiles=dict(self._ledger))
            self._audit.flush_sink()
            flight_recorder.dump("gen_engine_death", {
                "engine": self.name, "error": repr(e), "supervised": True,
                "manifest": manifest.summary(),
                "inflight_spans": [r.span.to_dict() for r in active
                                   if r.span is not None][:64],
                "step_log_tail": self._step_log_tail(),
                "audit_tail": self._audit.tail(64)})
            # the JAX engine's pools were donated into the failing call;
            # here the dead pools go now, before the supervisor allocates
            # the next set. The traceback's finished frames may hold
            # views of them (a decode step's locals): clear those too
            traceback.clear_frames(e.__traceback__)
            self._cache.release_pools()
            try:
                self._on_death(manifest)
                return True
            except Exception as sup_e:  # noqa: BLE001 — the supervisor
                #                         failed: strand typed instead
                e = RuntimeError(
                    f"supervisor failed during restart: {sup_e!r} "
                    f"(original death: {e!r})")
        # a lane fault is already typed and names the rank at fault
        err = (self._lane.error if lane_fault else UnavailableError(
            f"{self.name}: generation engine died: {e!r}"))
        for req in active + stranded:
            if req.stream is not None:
                # direct put: the step loop is dead, no flush follows
                req.stream._put(err)
            try:
                req.future.set_exception(err)
            except Exception:  # noqa: BLE001 — already settled
                pass
            self._audit.audit("ENGINE_DIED", rid=req.rid, error=repr(e))
            slo.observe_request(self.name, ok=False)
        self._audit.flush_sink()
        flight_recorder.dump("gen_engine_death", {
            "engine": self.name, "error": repr(e),
            "stranded_requests": len(stranded),
            "active_sequences": len(active),
            "inflight_spans": [r.span.to_dict() for r in active
                               if r.span is not None][:64],
            "step_log_tail": self._step_log_tail(),
            "audit_tail": self._audit.tail(64)})
        return False

    def _step_log_tail(self):
        return (self._step_log.tail(32) if self._step_log is not None
                else [])

    # -- admission ---------------------------------------------------------

    def _admit(self):
        """Admit queued requests while a slot AND worst-case pages are
        both free (FIFO, head-of-line blocking — later smaller requests
        never overtake). With the prefix cache, the longest cached chain
        the prompt walks maps read-only (pinned across the eviction
        pass), evictable chains are LRU-evicted before alloc when the
        free list alone is short, and a full-prompt match CoW-splits the
        page holding its last position. With the host tier, the walk
        continues through demoted pages, which are promoted into the
        admission's fresh pages before its tail prefill. A prompt whose
        uncached tail is longer than `prefill_chunk` is admitted now and
        prefilled one chunk per iteration."""
        P = self._cfg.page_size
        while True:
            with self._cv:
                # whole-queue sweep: a request behind a page-blocked head
                # still gets its deadline error on time
                self._expire_queued()
                if not self._queue:
                    return
                req = self._queue[0]
                slot = next((i for i, r in enumerate(self._slots)
                             if r is None), None)
                if slot is None:
                    # once per request per cause: a full batch defers the
                    # head every iteration
                    if "slots" not in req.defer_logged:
                        req.defer_logged.add("slots")
                        self._audit.audit("DEFER_SLOTS", rid=req.rid,
                                          queue_depth=len(self._queue))
                    return
                S = int(req.prompt.size)
                total = S + req.max_new
                need = self._cache.pages_needed(total)
                digests, hit_pages, host_digests = [], [], []
                if self._prefix is not None:
                    if self._tier is not None:
                        digests, hit_pages, host_digests = \
                            self._prefix.lookup_tiered(req.prompt)
                    else:
                        digests, hit_pages = self._prefix.lookup(req.prompt)
                matched_hbm = len(hit_pages)
                promote_n = len(host_digests)
                matched = matched_hbm + promote_n
                # a FULL-prompt match keeps every page but recomputes its
                # last position's logits, through a private copy of the
                # page holding it (the one divergent write); a full match
                # whose tail comes up from the host tier needs no CoW:
                # the last promoted page is this request's own
                full_match = matched > 0 and matched * P == S
                cow_needed = full_match and promote_n == 0
                # promotion targets are fresh pages too: (need - matched)
                # suffix pages + promote_n targets = need - matched_hbm
                fresh_needed = need - matched_hbm + (1 if cow_needed else 0)
                if matched_hbm:
                    # refcount >= 2 takes the matched chain out of the
                    # evictable set for the eviction below
                    self._cache.pin(hit_pages)
                if promote_n:
                    # the same eviction pass may demote victims into the
                    # tier: shield the matched host run from its LRU
                    self._prefix.protect(host_digests)
                try:
                    # the alloc_exhaust failpoint forces the exhaustion
                    # verdict without draining the pool
                    if (fresh_needed > self._cache.reclaimable_pages
                            or failpoints.fire("alloc_exhaust")
                            is not None):
                        self._defer_pages(req, fresh_needed)
                        return
                    if fresh_needed > self._cache.free_pages:
                        # evictable pages counted as capacity above;
                        # reclaim them now, before alloc
                        freed = self._prefix.evict(
                            fresh_needed - self._cache.free_pages,
                            exclude=hit_pages)
                        self._audit.audit(
                            "EVICT_PREFIX_LRU", rid=req.rid,
                            pages=len(freed),
                            free_pages=self._cache.free_pages)
                        if freed:
                            self._zero_pages(freed)
                        if fresh_needed > self._cache.free_pages:
                            # every remaining chain is live-shared or
                            # excluded: defer, pages return through
                            # those sequences' frees
                            monitor.stat_add("STAT_gen_admit_blocked")
                            return
                    self._queue.popleft()
                    monitor.stat_sub("STAT_gen_queue_depth")
                    # a replayed request's future is RUNNING since its
                    # first admission: claiming it again would raise
                    if not req.claimed:
                        if not req.future.set_running_or_notify_cancel():
                            self._audit.audit("CANCELLED", rid=req.rid)
                            if req.stream is not None:
                                self._stream_q.append(
                                    (req.stream, CancelledError()))
                            continue
                        req.claimed = True
                    req.slot = slot
                    req.pt_row = self._cache.alloc_shared(req.rid, total,
                                                          hit_pages)
                finally:
                    if matched_hbm:
                        self._cache.unpin(hit_pages)
                    if promote_n:
                        self._prefix.unprotect()
                cow_src = cow_dst = None
                if cow_needed:
                    cow_src = hit_pages[-1]
                    cow_dst = self._cache.cow_split(req.rid, cow_src)
                    req.pt_row[matched - 1] = cow_dst
                    monitor.stat_add("STAT_cow_splits")
                    self._it["cow_splits"] += 1
                    self._audit.audit("COW_SPLIT", rid=req.rid,
                                      src_page=cow_src, dst_page=cow_dst)
                self._slots[slot] = req
                self._it["admitted"] += 1
                if self._admit_clamped:
                    # the pool covered an admission again: the exhaustion
                    # episode is over, the clamp lifts
                    self._admit_clamped = False
                    self._exhaust_times.clear()
            if cow_dst is not None:
                # clone the shared page before the tail prefill writes
                # position S-1 through the private copy
                self._cow_copy(cow_src, cow_dst)
            if promote_n and not self._promote_upload(req, host_digests,
                                                      matched_hbm):
                # abandon: the match shrinks back to the device run and
                # the tail prefill covers the rest cold
                matched, full_match = matched_hbm, False
            # counted after the promotion resolved: an abandon must not
            # count host pages it never served
            req.prefix_tokens = (S - 1) if full_match else matched * P
            if self._prefix is not None:
                self._prefix.note_admitted(
                    req.prefix_tokens,
                    host_tokens=(matched - matched_hbm) * P)
            self._it["prefix_tokens"] += req.prefix_tokens
            if matched:
                self._audit.audit(
                    "ADMIT_PREFIX_HIT", rid=req.rid, slot=slot, pages=need,
                    shared_pages=matched_hbm,
                    promoted_pages=matched - matched_hbm,
                    prefix_tokens=req.prefix_tokens,
                    queued_ms=round(_now_ms() - req.t_enqueue_ms, 3))
            else:
                self._audit.audit(
                    "ADMIT", rid=req.rid, slot=slot, pages=need,
                    queued_ms=round(_now_ms() - req.t_enqueue_ms, 3))
            if req.span is not None:
                req.span.slot = slot
                req.span.prefix_tokens = req.prefix_tokens
                req.span.stamp("admitted")
            chunk = self._cfg.prefill_chunk
            if chunk and S - req.prefix_tokens > chunk:
                # the slot joins decode when prefill_pos reaches S
                req.prefill_pos = req.prefix_tokens
                req.pending_digests = digests
            else:
                self._do_prefill(req, digests)

    def _defer_pages(self, req: _GenRequest, fresh_needed: int):
        """The head cannot get its worst-case pages: count it, audit it
        once per request, and dump one flight record per exhaustion
        episode (a free of pages starts the next). Caller holds the
        lock. Every blocked iteration counts toward the admission-clamp
        detector: head-of-line blocking defers only the head, so a count
        a request would see one event an episode."""
        monitor.stat_add("STAT_gen_admit_blocked")
        self._note_exhaust()
        if "pages" not in req.defer_logged:
            req.defer_logged.add("pages")
            self._audit.audit(
                "DEFER_PAGES", rid=req.rid, need_pages=fresh_needed,
                free_pages=self._cache.free_pages,
                reclaimable=self._cache.reclaimable_pages)
        if not self._exhaust_dumped:
            self._exhaust_dumped = True
            flight_recorder.dump("gen_allocator_exhausted", {
                "engine": self.name, "rid": req.rid,
                "need_pages": fresh_needed, "cache": self._cache.stats(),
                "queue_depth": len(self._queue),
                "step_log_tail": self._step_log_tail(),
                "audit_tail": self._audit.tail(64)})

    def _expire_queued(self):
        """Fail every expired request and drop every cancelled one from
        the WHOLE queue (position-independent); caller holds the lock.
        While queued nothing has been delivered, so both stream
        deadlines are hard here."""
        t = _now_ms()
        live = deque()
        for req in self._queue:
            deadlines = [d for d in (req.deadline_ms, req.ttft_deadline_ms)
                         if d is not None]
            if deadlines and t > min(deadlines):
                monitor.stat_sub("STAT_gen_queue_depth")
                monitor.stat_add("STAT_gen_timeouts")
                self._it["expired"] += 1
                self._audit.audit("EXPIRE_QUEUED", rid=req.rid,
                                  queued_ms=round(t - req.t_enqueue_ms, 3))
                slo.observe_request(self.name, ok=False)
                self._resolve_req_later(req, exc=ExecutionTimeoutError(
                    f"{self.name}: request expired after "
                    f"{t - req.t_enqueue_ms:.1f}ms in queue"))
                continue
            if req.future.cancelled():
                monitor.stat_sub("STAT_gen_queue_depth")
                self._audit.audit("CANCELLED", rid=req.rid)
                if req.stream is not None:
                    self._stream_q.append((req.stream, CancelledError()))
                continue
            live.append(req)
        self._queue = live

    def _bucket_for(self, S: int) -> int:
        for b in self._cfg.prefill_buckets:
            if b >= S:
                return b
        return self._cfg.prefill_buckets[-1]

    def _do_prefill(self, req: _GenRequest, digests=None):
        """Prefill the prompt through its bucket (writes its K/V pages),
        sample the first token, and mark the slot live. A prefix hit
        (req.prefix_tokens > 0) prefills ONLY the tail through the tail
        program; the cached pages are read, never written. Non-finite
        logits fail ONLY this request and return its pages zeroed; an
        exception from the call itself kills the engine."""
        failpoints.maybe_raise("prefill_raise")
        S = int(req.prompt.size)
        pfx = req.prefix_tokens
        t0 = _now_ms()
        if pfx:
            tail = S - pfx
            bucket = self._bucket_for(tail)
            ids = np.zeros((1, bucket), np.int64)
            ids[0, :tail] = req.prompt[pfx:]
            with RecordEvent(f"generation::prefill_tail[b={bucket}]"):
                lg = self._tail_prefill_call(req.pt_row, ids, tail, pfx)
                tok, finite = self._first_token(req, lg)
        else:
            bucket = self._bucket_for(S)
            ids = np.zeros((1, bucket), np.int64)
            ids[0, :S] = req.prompt
            with RecordEvent(f"generation::prefill[b={bucket}]"):
                lg = self._prefill_call(req.pt_row, ids, S)
                tok, finite = self._first_token(req, lg)
        self._it["prefill_ms"] += _now_ms() - t0
        if not finite:
            self._poison_prefill(req, bucket)
            return
        self._finish_prefill(req, tok, digests)

    def _poison_decode(self, req: _GenRequest, slot: int):
        """Non-finite decode/verify logits: only THIS sequence fails,
        its pages return zeroed."""
        monitor.stat_add("STAT_gen_poisoned")
        self._it["poisoned"] += 1
        self._note_poison()
        self._audit.audit("POISON_DECODE", rid=req.rid, slot=slot,
                          generated=len(req.toks))
        slo.observe_request(self.name, ok=False)
        flight_recorder.dump("gen_poisoned_sequence", {
            "engine": self.name, "rid": req.rid, "stage": "decode",
            "slot": slot, "generated": len(req.toks),
            "error": "non-finite decode logits",
            "step_log_tail": self._step_log_tail(),
            "audit_tail": self._audit.tail(64)})
        self._evict(req, FatalError(
            f"{self.name}: sequence {req.rid} produced non-finite logits "
            f"at step {len(req.toks)}"))

    def _poison_prefill(self, req: _GenRequest, bucket: int):
        """Non-finite prefill logits (whole prompt, tail or chunk): only
        THIS request fails and its pages return zeroed."""
        monitor.stat_add("STAT_gen_poisoned")
        self._it["poisoned"] += 1
        self._note_poison()
        self._audit.audit("POISON_PREFILL", rid=req.rid, bucket=bucket)
        slo.observe_request(self.name, ok=False)
        flight_recorder.dump("gen_poisoned_sequence", {
            "engine": self.name, "rid": req.rid, "stage": "prefill",
            "bucket": bucket, "error": "non-finite prefill logits",
            "step_log_tail": self._step_log_tail(),
            "audit_tail": self._audit.tail(64)})
        self._release(req)
        self._resolve_req_later(req, exc=FatalError(
            f"{self.name}: non-finite prefill logits for request "
            f"{req.rid} (poisoned prompt or weights)"))

    def _finish_prefill(self, req: _GenRequest, tok: int, digests):
        """Shared end of every prefill flavor (whole prompt, prefix tail,
        final chunk): register the prompt's full pages in the prefix
        cache, deliver the first token, mark the slot decode-live."""
        self._prefills_total += 1
        monitor.stat_add("STAT_gen_prefills")
        if self._prefix is not None and digests:
            self._register_pages(req, digests)
        req.next_pos = int(req.prompt.size)
        if req.span is not None:
            req.span.stamp("prefilled")
            req.span.stamp("first_token")
        self._deliver(req, tok)

    def _register_pages(self, req: _GenRequest, digests):
        """Index full pages in the prefix cache; pages that a budget
        eviction freed (`prefix_cache_max_pages`) are zeroed here."""
        freed = self._prefix.register(digests, req.pt_row)
        if freed:
            self._zero_pages(freed)
            self._audit.audit("EVICT_PREFIX_BUDGET", rid=req.rid,
                              pages=len(freed),
                              free_pages=self._cache.free_pages)

    def _advance_prefills(self):
        """Advance the OLDEST partially prefilled slot by ONE chunk
        through the tail program. One chunk per engine iteration: between
        chunks the loop runs a decode step for every live sequence, which
        is the TPOT protection chunked prefill exists for."""
        req = None
        for r in self._slots:
            if (r is not None and r.prefill_pos is not None
                    and (req is None or r.ordinal < req.ordinal)):
                req = r
        if req is None:
            return
        failpoints.maybe_raise("prefill_raise")
        S = int(req.prompt.size)
        take = min(self._cfg.prefill_chunk, S - req.prefill_pos)
        bucket = self._bucket_for(take)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :take] = req.prompt[req.prefill_pos:req.prefill_pos + take]
        t0 = _now_ms()
        with RecordEvent(f"generation::prefill_chunk[b={bucket}]"):
            lg = self._tail_prefill_call(req.pt_row, ids, take,
                                         req.prefill_pos)
            tok, finite = self._first_token(req, lg)
        self._it["prefill_ms"] += _now_ms() - t0
        self._it["prefill_chunks"] += 1
        self._chunks_total += 1
        monitor.stat_add("STAT_gen_prefill_chunks")
        if not finite:
            req.prefill_pos = req.pending_digests = None
            self._poison_prefill(req, bucket)
            return
        req.prefill_pos += take
        if req.prefill_pos < S:
            return
        req.prefill_pos = None
        digests, req.pending_digests = req.pending_digests, None
        self._finish_prefill(req, tok, digests)

    def _first_token(self, req: _GenRequest, logits):
        """First-token sampling from the prefill logits, through the
        engine's generator. Returns (token, logits-all-finite): the
        prefill's one device-to-host copy."""
        tok = sample_logits(logits[None], req.do_sample, req.temperature,
                            self._cfg.top_k, self._gen)[0]
        out = torch.stack([tok, torch.isfinite(logits).all().long()]).cpu()
        return int(out[0]), bool(out[1])

    def _deliver(self, req: _GenRequest, tok: int):
        req.toks.append(tok)
        self._tokens_total += 1
        monitor.stat_add("STAT_gen_tokens")
        self._it["tokens"] += 1
        self._stage_token(req, tok)
        if req.span is not None:
            req.span.stamp("last_token")
        if self._finished(req, tok):
            self._complete(req)

    # -- decode step -------------------------------------------------------

    def _step_arrays(self):
        M, PP = self._cfg.max_slots, self._cfg.pages_per_seq
        toks = np.zeros((M,), np.int64)
        pos = np.zeros((M,), np.int32)
        active = np.zeros((M,), bool)
        temps = np.ones((M,), np.float32)
        smask = np.zeros((M,), bool)
        pt = np.zeros((M, PP), np.int32)
        for i, req in enumerate(self._slots):
            if req is None or req.prefill_pos is not None:
                continue  # empty, or still chunk-prefilling (no toks)
            active[i] = True
            toks[i] = req.toks[-1]
            pos[i] = req.next_pos
            temps[i] = req.temperature
            smask[i] = req.do_sample
            pt[i] = req.pt_row
        return pt, toks, pos, active, temps, smask

    def _spec_arrays(self):
        """Verify-step inputs: per-slot [current token + K drafts]
        blocks. Drafts come from the proposer over each sequence's OWN
        tokens, truncated to the request's remaining token budget (so
        every consumed position stays in the pages admission reserved);
        sampled slots take no drafts. Returns (args, drafted count)."""
        M, PP = self._cfg.max_slots, self._cfg.pages_per_seq
        K = self._spec_k
        toks_blk = np.zeros((M, K + 1), np.int64)
        dmask = np.zeros((M, K), bool)
        pos = np.zeros((M,), np.int32)
        active = np.zeros((M,), bool)
        temps = np.ones((M,), np.float32)
        smask = np.zeros((M,), bool)
        pt = np.zeros((M, PP), np.int32)
        drafted = 0
        for i, req in enumerate(self._slots):
            if req is None or req.prefill_pos is not None:
                continue
            active[i] = True
            toks_blk[i, 0] = req.toks[-1]
            pos[i] = req.next_pos
            temps[i] = req.temperature
            smask[i] = req.do_sample
            pt[i] = req.pt_row
            if not req.do_sample:
                budget = min(K, req.max_new - len(req.toks) - 1)
                if budget > 0:
                    drafts = self._proposer.propose(
                        np.concatenate([req.prompt,
                                        np.asarray(req.toks, np.int32)]),
                        budget)
                    n = int(drafts.size)
                    if n:
                        toks_blk[i, 1:1 + n] = drafts
                        dmask[i, :n] = True
                        drafted += n
        return (pt, toks_blk, dmask, pos, active, temps, smask), drafted

    def _inject_poison(self, bad: np.ndarray) -> np.ndarray:
        """`decode_poison_nan` failpoint: mark the first live slot's
        logits non-finite on the host, the verdict the decode program's
        isfinite check would have returned."""
        bad = np.array(bad, copy=True)
        for i, r in enumerate(self._slots):
            if r is not None and r.prefill_pos is None:
                bad[i] = True
                break
        return bad

    def _note_poison(self):
        """Poison-storm detector: k poison events inside the rolling
        window turn speculation OFF for this engine (non-finite logits
        keep coming: stop spending verify-wide commits on them and take
        the warmed one-token decode step). The verdict survives restarts
        through the crash manifest."""
        if (not self._poison_degrade_k or not self._spec_k
                or self._degraded_spec_off):
            return
        now = time.monotonic()
        self._poison_times.append(now)
        while (self._poison_times
               and now - self._poison_times[0] > self._degraded_window_s):
            self._poison_times.popleft()
        if len(self._poison_times) >= self._poison_degrade_k:
            self._degraded_spec_off = True
            monitor.stat_add("STAT_gen_degraded_spec_off")
            self._audit.audit(
                "DEGRADED_SPEC_OFF", poison_events=len(self._poison_times),
                window_s=self._degraded_window_s)

    def _note_exhaust(self):
        """Admission-clamp detector: k page-blocked admission iterations
        inside the rolling window clamp admission: new submits the pool
        cannot cover now fail fast with ResourceExhaustedError instead of
        queueing toward a timeout. The next admission clears it."""
        if not self._exhaust_clamp_k or self._admit_clamped:
            return
        now = time.monotonic()
        self._exhaust_times.append(now)
        while (self._exhaust_times
               and now - self._exhaust_times[0] > self._degraded_window_s):
            self._exhaust_times.popleft()
        if len(self._exhaust_times) >= self._exhaust_clamp_k:
            self._admit_clamped = True
            monitor.stat_add("STAT_gen_admit_clamped")
            self._audit.audit(
                "DEGRADED_ADMIT_CLAMP",
                exhaust_events=len(self._exhaust_times),
                window_s=self._degraded_window_s,
                free_pages=self._cache.free_pages)

    def _step(self):
        """ONE engine step: every live sequence advances one token
        (or, with speculation on, 1 to K+1 tokens through the verify
        program); inactive and chunk-prefilling slots park on the
        scratch page."""
        if self._pre_step_hook is not None:
            self._pre_step_hook(self)
        # fault-injection seams: a slow step first, then the
        # engine-fatal raise, as a failing launch would
        ms = failpoints.fire("slow_step_ms")
        if ms:
            time.sleep(ms / 1000.0)
        failpoints.maybe_raise("decode_step_raise")
        if self._spec_k and not self._degraded_spec_off:
            self._spec_step()
            return
        args = self._step_arrays()
        t0 = _now_ms()
        with RecordEvent(f"generation::step[m={self._cfg.max_slots}]"):
            nxt, bad = self._decode_call(*args)
        if failpoints.fire("decode_poison_nan") is not None:
            bad = self._inject_poison(bad)
        self._it["decode_ms"] += _now_ms() - t0
        self._steps_total += 1
        monitor.stat_add("STAT_gen_steps")
        for i, req in enumerate(self._slots):
            if req is None or req.prefill_pos is not None:
                continue
            if bad[i]:
                # poison isolation: only THIS sequence fails; its pages
                # are zeroed before reuse
                self._poison_decode(req, i)
                continue
            req.next_pos += 1
            self._deliver(req, int(nxt[i]))

    def _spec_step(self):
        """ONE speculative engine step: every live sequence advances by
        its accepted drafts plus the bonus token the verify pass scored
        at the first disagreement. Rejected positions were routed to the
        scratch page on the device, so there is nothing to undo here."""
        args, drafted = self._spec_arrays()
        t0 = _now_ms()
        with RecordEvent(f"generation::verify[k={self._spec_k}]"):
            n_acc, nxt, bad = self._verify_call(*args)
        if failpoints.fire("decode_poison_nan") is not None:
            bad = self._inject_poison(bad)
        self._it["decode_ms"] += _now_ms() - t0
        self._steps_total += 1
        monitor.stat_add("STAT_gen_steps")
        if drafted:
            monitor.stat_add("STAT_spec_drafted", drafted)
            self._it["spec_drafted"] += drafted
            self._spec_drafted_total += drafted
        toks_blk = args[1]
        for i, req in enumerate(self._slots):
            if req is None or req.prefill_pos is not None:
                continue
            if bad[i]:
                self._poison_decode(req, i)
                continue
            acc = int(n_acc[i])
            if acc:
                monitor.stat_add("STAT_spec_accepted", acc)
                self._it["spec_accepted"] += acc
                self._spec_accepted_total += acc
                req.spec_accepted += acc
            # accepted drafts in order, then the bonus token; EOS (or the
            # token budget) inside the block ends the sequence there —
            # later committed positions lie past next_pos, masked from
            # every later attend and zeroed with the free
            for tok in ([int(t) for t in toks_blk[i, 1:1 + acc]]
                        + [int(nxt[i])]):
                req.next_pos += 1
                self._deliver(req, tok)
                if self._finished(req, tok):
                    break

    def _finished(self, req: _GenRequest, tok: int) -> bool:
        return ((req.eos is not None and tok == req.eos)
                or len(req.toks) >= req.max_new)

    def _expire_active(self):
        """Per-step deadline enforcement: an expired non-streaming
        sequence is cancelled mid-decode (pages freed the same step);
        a streaming one that already delivered tokens resolves with
        them (its whole-request deadline is soft once tokens flow)."""
        t = _now_ms()
        for req in list(self._slots):
            if req is None:
                continue
            deadlines = [req.deadline_ms] if req.deadline_ms else []
            if req.ttft_deadline_ms is not None and not req.toks:
                deadlines.append(req.ttft_deadline_ms)
            if not deadlines or t <= min(deadlines):
                continue
            monitor.stat_add("STAT_gen_timeouts")
            self._it["expired"] += 1
            self._audit.audit(
                "EXPIRE_DECODE", rid=req.rid, slot=req.slot,
                generated=len(req.toks), stream=req.stream is not None,
                age_ms=round(t - req.t_enqueue_ms, 3))
            slo.observe_request(self.name, ok=False)
            if (req.stream is not None and req.toks
                    and req.skip_stream == 0):
                # soft: the stream ends normally with what it has. A
                # from-scratch replay still owing suppressions takes the
                # hard path below: resolving now would hand back fewer
                # tokens than the caller already streamed
                self._release(req)
                self._resolve_req_later(req, result=np.concatenate(
                    [req.prompt, np.asarray(req.toks, np.int32)]))
                self._finish_span(req)
                continue
            ttft_hit = (req.ttft_deadline_ms is not None and not req.toks
                        and t > req.ttft_deadline_ms)
            self._evict(req, ExecutionTimeoutError(
                f"{self.name}: request {req.rid} missed its HARD TTFT "
                f"deadline after {t - req.t_enqueue_ms:.1f}ms admitted "
                f"but still prefilling (no first token)" if ttft_hit else
                f"{self.name}: request {req.rid} expired after "
                f"{t - req.t_enqueue_ms:.1f}ms with "
                f"{len(req.toks)}/{req.max_new} tokens decoded"))

    # -- completion / eviction ---------------------------------------------

    def _release(self, req: _GenRequest):
        """Return the request's slot + pages (pages zeroed on device)."""
        pages = self._cache.free(req.rid)
        if pages:
            self._zero_pages(pages)
            self._exhaust_dumped = False  # pages freed: a new episode
        if req.slot is not None and self._slots[req.slot] is req:
            self._slots[req.slot] = None
            self._it["freed"] += 1
        with self._cv:
            self._cv.notify_all()

    def _finish_span(self, req: _GenRequest):
        if req.span is not None:
            req.span.stamp("resolved")
            req.span.finish(len(req.toks), prefix_tokens=req.prefix_tokens,
                            spec_tokens=req.spec_accepted)

    def _complete(self, req: _GenRequest):
        out = np.concatenate([req.prompt, np.asarray(req.toks, np.int32)])
        if self._prefix is not None and req.pt_row is not None:
            # register the full pages of prompt + answer before the
            # release, so a follow-up turn whose prompt is this whole
            # conversation walks the chain end to end. Only pages fully
            # covered by WRITTEN positions qualify: the final token's K/V
            # is never written, so the chain stops at next_pos
            self._register_pages(
                req, self._prefix.digests(out)[:req.next_pos
                                               // self._cfg.page_size])
        self._release(req)
        t_done = _now_ms()
        self._hist.observe(t_done - req.t_enqueue_ms)
        if req.deadline_ms is not None and t_done > req.deadline_ms:
            # finished the instant it expired: a timeout, not a
            # completion (a stream still gets its complete sequence)
            monitor.stat_add("STAT_gen_timeouts")
            self._it["expired"] += 1
            self._audit.audit("EXPIRE_LATE", rid=req.rid,
                              generated=len(req.toks))
            slo.observe_request(self.name, ok=False)
            if req.stream is not None:
                self._resolve_req_later(req, result=out)
                self._finish_span(req)
                return
            self._resolve_later(req, req.future, exc=ExecutionTimeoutError(
                f"{self.name}: request expired after "
                f"{t_done - req.t_enqueue_ms:.1f}ms"))
            return
        self._resolve_req_later(req, result=out)
        monitor.stat_add("STAT_gen_completions")
        self._it["completed"] += 1
        self._audit.audit(
            "COMPLETE_EOS" if (req.eos is not None and req.toks
                               and req.toks[-1] == req.eos)
            else "COMPLETE_MAX_NEW",
            rid=req.rid, generated=len(req.toks),
            e2e_ms=round(t_done - req.t_enqueue_ms, 3))
        slo.observe_request(self.name, ok=True)
        self._finish_span(req)

    def _evict(self, req: _GenRequest, err: BaseException):
        """Cancel a LIVE sequence: free + zero its pages, fail only its
        own future (and stream)."""
        self._release(req)
        monitor.stat_add("STAT_gen_evictions")
        self._resolve_req_later(req, exc=err)

    def _evict_all(self, err: BaseException):
        for req in list(self._slots):
            if req is not None:
                # an operator's action: audited, but not an SLO error
                self._it["aborted"] += 1
                self._audit.audit("EVICT_SHUTDOWN", rid=req.rid,
                                  generated=len(req.toks))
                self._evict(req, err)

    # -- lifecycle / introspection -----------------------------------------

    def stats(self) -> dict:
        """Engine snapshot: per-slot state, page-pool occupancy and KV
        introspection (owners, prefix and tier numbers, admission
        headroom), the program-shape ledger, token/step totals, the step
        log's counts and the latency histograms."""
        with self._cv:
            depth = len(self._queue)
            slots = [{"slot": i,
                      "rid": r.rid if r is not None else None,
                      "generated": len(r.toks) if r is not None else 0,
                      "prompt_len": int(r.prompt.size)
                      if r is not None else 0}
                     for i, r in enumerate(self._slots)]
            slot_of = {r.rid: i for i, r in enumerate(self._slots)
                       if r is not None}
            decode_tokens = self._tokens_total - self._prefills_total
            steps = self._steps_total
        kv = dict(self._cache.stats())
        kv["owners"] = [{"rid": rid, "slot": slot_of.get(rid),
                         "pages": pages}
                        for rid, pages in sorted(self._cache.owners()
                                                 .items())]
        kv["prefix"] = (self._prefix.stats() if self._prefix is not None
                        else {"enabled": False})
        kv["admit_headroom"] = self._headroom()
        ledger, loaded = dict(self._ledger), dict(self._loaded)
        return {
            "slots": slots,
            "queue_depth": depth,
            "pages": self._cache.stats(),
            "kv": kv,
            "compiles": ledger,
            # the program store: programs loaded from it, and how each
            # program came to serve
            "loaded": loaded,
            "programs": {n: ("loaded" if loaded.get(n) and not ledger.get(n)
                             else "compiled")
                         for n in set(ledger) | set(loaded)},
            "program_store": {
                "configured": bool(self._cfg.program_store),
                "active": self._store is not None,
                "key": self._store.key if self._store is not None
                else None,
                "dir": self._store.key_dir if self._store is not None
                else None,
            },
            "tp": self._tp,
            "steps": self._steps_total,
            "prefills": self._prefills_total,
            "tokens": self._tokens_total,
            # speculation economics (tokens_per_step > 1 is the win) and
            # the chunk count, under the JAX engine's names
            "spec": {
                "enabled": bool(self._spec_k),
                "k": self._spec_k,
                "drafted": self._spec_drafted_total,
                "accepted": self._spec_accepted_total,
                "acceptance_rate": round(
                    self._spec_accepted_total
                    / max(1, self._spec_drafted_total), 4),
                # decode-delivered tokens per decode step (every
                # prefill delivers one token, so those are subtracted)
                "tokens_per_step": round(decode_tokens / max(1, steps), 4),
            },
            "prefill_chunks": self._chunks_total,
            # which engine generation this is, and whether a degraded
            # mode is on
            "incarnation": self.incarnation,
            "degraded": {
                "spec_off": self._degraded_spec_off,
                "admit_clamped": self._admit_clamped,
                "poison_degrade_k": self._poison_degrade_k,
                "exhaust_clamp_k": self._exhaust_clamp_k,
            },
            "step_log": {
                "enabled": self._step_log is not None,
                "recorded": (self._step_log.recorded
                             if self._step_log is not None else 0),
                "audit_events": self._audit.recorded,
            },
            "device": str(self._device),
            "latency_ms": self._hist.snapshot(),
            "ttft_ms": monitor.histogram("ttft_ms").snapshot(),
            "tpot_ms": monitor.histogram("tpot_ms").snapshot(),
        }

    def _headroom(self) -> dict:
        """`can_admit` counts for this engine's representative request
        shapes (each prefill bucket + the default max-new)."""
        shapes = sorted({b + self._cfg.max_new_tokens
                         for b in self._cfg.prefill_buckets})
        return {str(t): n for t, n in sorted(
            self._cache.headroom(shapes).items())}

    def _compute_pressure(self) -> dict:
        """Step-thread half of `pressure()`: admission headroom, pool
        occupancy, slot availability (and the tier's surface), published
        as one plain-dict attribute store."""
        snap = {
            "headroom": self._headroom(),
            "free_pages": self._cache.free_pages,
            "pages_in_use": self._cache.pages_in_use,
            "slots_free": sum(1 for r in self._slots if r is None),
            "live": self._num_active(),
            "tp": self._tp,
            "kv_shard_bytes": self._cache.shard_hbm_bytes(),
        }
        if self._tier is not None:
            snap["tier"] = {
                "host_bytes": self._tier.host_bytes,
                "entries": len(self._tier),
                "hit_rate": round(
                    self._tier.hits
                    / max(1, self._prefix.hits + self._prefix.misses), 4),
            }
        return snap

    def pressure(self) -> dict:
        """Cheap pressure snapshot: page/slot fields from the step
        thread's last published `_compute_pressure()` (no engine lock),
        queue depth and oldest-queue age read live."""
        snap = dict(self._pressure)
        q = self._queue
        snap["queue_depth"] = len(q)
        try:
            snap["oldest_age_ms"] = round(_now_ms() - q[0].t_enqueue_ms, 3)
        except IndexError:   # the head raced an admission's popleft
            snap["oldest_age_ms"] = 0.0
        snap["queue_limit"] = self._cfg.max_queue_depth
        return snap

    def health(self) -> dict:
        """`/readyz` verdict, same shape as the JAX engine's; with
        FLAGS_slo_max_burn_rate set, an engine burning its error budget
        too fast reports not-ready."""
        with self._cv:
            depth = len(self._queue)
            draining = self._closed
            live = int(getattr(self, "_thread", None) is not None
                       and self._thread.is_alive() and self._death is None)
            slots_free = sum(1 for r in self._slots if r is None)
        limit = self._cfg.max_queue_depth
        warmed = self._warmed
        if draining:
            reason = "draining"
        elif not warmed:
            reason = "warming up"
        elif not live:
            reason = "step loop dead"
        elif depth >= limit:
            reason = "queue at rejection threshold"
        else:
            reason = slo.shed_verdict(self.name) or "ok"
        return {"ready": reason == "ok", "reason": reason,
                "warmup_complete": warmed, "draining": draining,
                "live_lanes": live, "queue_depth": depth,
                "queue_limit": limit, "slots_free": slots_free,
                "slots": self._cfg.max_slots}

    def shutdown(self, drain: bool = True,
                 timeout_s: Optional[float] = None):
        """Stop intake; by default every queued + live sequence finishes
        before the step loop exits. drain=False fails pending futures
        fast (live sequences are evicted, pages freed)."""
        dropped = []
        with self._cv:
            self._closed = True
            if not drain:
                self._abort = True
                while self._queue:
                    req = self._queue.popleft()
                    monitor.stat_sub("STAT_gen_queue_depth")
                    dropped.append(req)
                    err = UnavailableError(f"{self.name}: engine shut down")
                    if req.stream is not None:
                        req.stream._put(err)
                    try:
                        req.future.set_exception(err)
                    except Exception:  # noqa: BLE001 — already settled
                        pass
            self._cv.notify_all()
        for req in dropped:
            # audited outside the lock (disk sink)
            self._audit.audit("EVICT_SHUTDOWN_QUEUED", rid=req.rid,
                              queued_ms=round(_now_ms()
                                              - req.t_enqueue_ms, 3))
        if self._lane is not None and not self._lane.leader:
            # a follower ends when its leader ends the lane (across
            # incarnations: the thread is the lane's); a lane that ended
            # on a fault ends here with its typed error
            self._lane.thread.join(timeout_s)
            if self._lane.error is not None:
                raise self._lane.error
            return
        t = getattr(self, "_thread", None)
        if t is not None:
            t.join(timeout_s)
        exporter.unregister_engine(self)
        if self._step_log is not None:
            step_log.unregister(self._step_log)
        self._audit.close()
        slo.forget(self.name)
        if getattr(self, "_owns_metrics_server", False) \
                and self.metrics_server is not None:
            self.metrics_server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
