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

Hardening: bounded intake (`EngineOverloaded`), worst-case page admission
with FIFO head-of-line blocking, per-request deadlines checked while
queued and before every decode step, poison isolation through a
per-slot non-finite-logit flag (pages zeroed before reuse), shutdown
drain, and `health()`.

Not ported yet, each raising `InvalidArgumentError` when asked for:
prefix cache, speculative decoding, chunked prefill, the host KV tier,
the program store, tensor-parallel lanes and int8 pages. The step log,
audit ring, SLO tracking, exporter, failpoints and supervisor hooks come
with later slices too.
"""
from __future__ import annotations

import copy
import itertools
import queue as _queue
import threading
import time
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
from ..models.gpt import (GPTForCausalLM, gpt_decode_step, gpt_logits,
                          gpt_prefill, sample_logits)
from ..ops.paged_ops import (page_rows_for_positions, paged_attention,
                             paged_write)
from .kv_cache import TRASH_PAGE, PagedKVCache

monitor.register_gauge("STAT_gen_queue_depth", updown=True)

__all__ = ["EngineOverloaded", "GenerationConfig", "GenerationEngine",
           "TokenStream"]


class EngineOverloaded(ResourceExhaustedError):
    """Raised by `submit` when the bounded request queue is full —
    explicit load-shedding backpressure, never silent growth."""


def _now_ms() -> float:
    return time.perf_counter() * 1000.0


def _not_ported(knob: str):
    return InvalidArgumentError(
        f"GenerationConfig.{knob} is not yet ported to paddle_tpu_torch")


class GenerationConfig:
    """Continuous-batching knobs; defaults ride the FLAGS_gen_* /
    FLAGS_paged_* registry. The JAX engine's knobs that are not ported
    yet are accepted only in their off state and raise otherwise."""

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
                 spec_k: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 kv_tier: Optional[bool] = None,
                 program_store: Optional[str] = None,
                 tp: Optional[int] = None,
                 top_k: int = 0, seed: int = 0):
        for knob, value, off in (("prefix_cache", prefix_cache, False),
                                 ("spec_k", spec_k, 0),
                                 ("prefill_chunk", prefill_chunk, 0),
                                 ("kv_tier", kv_tier, False),
                                 ("program_store", program_store, ""),
                                 ("tp", tp, 1)):
            if value is not None and value != off:
                raise _not_ported(knob)
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
        if self.kv_cache_dtype == "int8":
            raise _not_ported("kv_cache_dtype='int8'")
        if self.kv_cache_dtype not in ("auto", "float32", "bfloat16"):
            raise InvalidArgumentError(
                f"kv_cache_dtype must be auto/float32/bfloat16, got "
                f"{self.kv_cache_dtype!r}")
        self.top_k = int(top_k)
        self.seed = int(seed)


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
                 "slot", "pt_row", "toks", "next_pos", "stream",
                 "ttft_deadline_ms", "t_first_ms", "t_last_ms")

    _ids = itertools.count(1)

    def __init__(self, prompt, max_new, eos, do_sample, temperature,
                 future, deadline_ms, t_enqueue_ms, stream=None,
                 ttft_deadline_ms=None):
        self.rid = next(self._ids)
        self.prompt = prompt            # np.int32 [S]
        self.max_new = max_new
        self.eos = eos
        self.do_sample = do_sample
        self.temperature = temperature
        self.future = future
        self.deadline_ms = deadline_ms
        self.t_enqueue_ms = t_enqueue_ms
        self.slot: Optional[int] = None
        self.pt_row = None              # np.int32 [pages_per_seq]
        self.toks: List[int] = []       # generated tokens (eos included)
        self.next_pos = 0               # cache position the NEXT step writes
        self.stream = stream            # TokenStream or None
        self.ttft_deadline_ms = ttft_deadline_ms  # HARD (streams)
        self.t_first_ms = None
        self.t_last_ms = None


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
    there is none); the model must live there already."""

    def __init__(self, model, config: Optional[GenerationConfig] = None,
                 name: str = "generation", device=None, **overrides):
        if config is None:
            config = GenerationConfig(**overrides)
        elif overrides:
            raise InvalidArgumentError(
                "pass either a GenerationConfig or keyword overrides, "
                "not both")
        self._cfg = copy.copy(config)
        self.name = name
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
        self._W = model.decode_weights()    # raises for MoE
        self._H = mcfg.num_heads
        self._D = mcfg.hidden_size // mcfg.num_heads
        self._scale = 1.0 / self._D ** 0.5
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
        wdt = str(self._W["wte"].dtype).replace("torch.", "")
        kv_dtype = (wdt if self._cfg.kv_cache_dtype == "auto"
                    else self._cfg.kv_cache_dtype)
        self._cache = PagedKVCache(
            mcfg.num_layers, self._H, self._D, self._cfg.page_size,
            self._cfg.num_pages, self._cfg.pages_per_seq, dtype=kv_dtype,
            device=dev)
        self._gen = torch.Generator(device=dev).manual_seed(self._cfg.seed)

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
        self._steps_total = 0
        self._prefills_total = 0
        self._tokens_total = 0
        self._ledger = {}              # "decode[m=M]"/"prefill[b=S]" -> 1
        self._death: Optional[BaseException] = None
        self._pre_step_hook = None     # test seam: runs on the step thread
        self._hist = monitor.histogram(f"{name}_request_ms")
        self._ttft_hist = monitor.histogram("ttft_ms")
        self._tpot_hist = monitor.histogram("tpot_ms")
        self._warmup()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"{name}-genstep")
        self._thread.start()

    # -- device programs ---------------------------------------------------

    def _note(self, key: str):
        """Record one program shape in the ledger (once per shape)."""
        if key not in self._ledger:
            self._ledger[key] = 1
            monitor.stat_add("STAT_gen_compiles")

    def _t(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=self._device)

    def _prefill_call(self, pt_row, ids, length):
        """Bucketed prefill of one prompt: writes its K/V pages (pad
        positions go to the scratch page) and returns the last real
        position's logits [V]."""
        S_b = ids.shape[1]
        self._note(f"prefill[b={S_b}]")
        h, ks, vs = gpt_prefill(self._W, self._t(ids, torch.long),
                                num_heads=self._H, scale=self._scale)
        pos = torch.arange(S_b, device=self._device)
        page_ids, offs = page_rows_for_positions(
            self._t(pt_row), pos, self._cfg.page_size)
        valid = pos < length
        page_ids = torch.where(valid, page_ids, TRASH_PAGE)
        offs = torch.where(valid, offs, 0)
        paged_write(self._cache.k_pages, None, page_ids, offs, ks[:, 0])
        paged_write(self._cache.v_pages, None, page_ids, offs, vs[:, 0])
        idx = min(max(int(length) - 1, 0), S_b - 1)
        return gpt_logits(self._W, h[0, idx])

    def _decode_call(self, pt, toks, pos, active, temps, smask):
        """ONE fixed-slot decode step. Returns host arrays (next token
        [M] int, non-finite-logit flag [M] bool) — the step's only
        device-to-host copy."""
        M = toks.shape[0]
        self._note(f"decode[m={M}]")
        kp, vp = self._cache.k_pages, self._cache.v_pages
        P, scale = self._cfg.page_size, self._scale
        pt_t = self._t(pt)
        pos_t = self._t(pos)

        def write_kv(cache, layer, k, v, p):
            page_ids, offs = page_rows_for_positions(pt_t, p, P)
            paged_write(kp, layer, page_ids, offs, k)
            paged_write(vp, layer, page_ids, offs, v)
            return cache

        def attend(cache, layer, q, p):
            return paged_attention(q, kp[layer], vp[layer], pt_t, p, scale)

        logits, _ = gpt_decode_step(
            self._W, self._t(toks, torch.long), pos_t, None, write_kv,
            attend, num_heads=self._H, scale=scale)
        nxt = torch.argmax(logits, -1)
        if smask.any():
            lg = logits / self._t(np.maximum(temps, 1e-6))[:, None]
            sampled = sample_logits(lg, True, 1.0, self._cfg.top_k,
                                    self._gen)
            nxt = torch.where(self._t(smask), sampled, nxt)
        active_t = self._t(active)
        nxt = torch.where(active_t, nxt, 0)
        bad = active_t & ~torch.isfinite(logits).all(-1)
        out = torch.stack([nxt, bad.long()]).cpu().numpy()
        return out[0], out[1].astype(bool)

    def _zero_pages(self, pages):
        """Zero freed pages on device (the trash-padded row also scrubs
        the scratch page)."""
        row = self._t(self._cache.zero_rows(pages), torch.long)
        self._cache.k_pages[:, :, row] = 0
        self._cache.v_pages[:, :, row] = 0

    @torch.inference_mode()
    def _warmup(self):
        """Run every prefill bucket and the decode step once, so the
        kernels are built and the ledger is complete before the first
        request. Writes land only on the scratch page."""
        M, PP = self._cfg.max_slots, self._cfg.pages_per_seq
        trash = np.zeros((PP,), np.int32)
        for b in self._cfg.prefill_buckets:
            lg = self._prefill_call(trash, np.zeros((1, b), np.int64), 1)
            lg.cpu()
        self._decode_call(np.zeros((M, PP), np.int32),
                          np.zeros((M,), np.int64), np.zeros((M,), np.int32),
                          np.zeros((M,), bool), np.ones((M,), np.float32),
                          np.zeros((M,), bool))
        self._zero_pages([])

    # -- request intake ----------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               timeout_ms: Optional[float] = None,
               do_sample: bool = False,
               temperature: float = 1.0) -> Future:
        """Enqueue one prompt (1-D int token ids); returns a Future of
        the full sequence (prompt + generated tokens, numpy int32; EOS,
        when hit, is included). Raises `EngineOverloaded` at
        max_queue_depth, `InvalidArgumentError`/`ResourceExhaustedError`
        for requests that could never run."""
        return self._submit(prompt_ids, max_new_tokens, eos_token_id,
                            timeout_ms, do_sample, temperature,
                            stream=None, ttft_timeout_ms=None).future

    def submit_stream(self, prompt_ids,
                      max_new_tokens: Optional[int] = None,
                      eos_token_id: Optional[int] = None,
                      timeout_ms: Optional[float] = None,
                      ttft_timeout_ms: Optional[float] = None,
                      do_sample: bool = False,
                      temperature: float = 1.0) -> TokenStream:
        """Streaming submit: tokens leave the engine as they are decoded.
        `ttft_timeout_ms` is HARD (expiry before the first token cancels
        with ExecutionTimeoutError); `timeout_ms` is SOFT once tokens
        flow (expiry mid-stream resolves with what was delivered)."""
        if ttft_timeout_ms is not None and float(ttft_timeout_ms) < 0:
            raise InvalidArgumentError("ttft_timeout_ms must be >= 0")
        stream = TokenStream(Future())
        self._submit(prompt_ids, max_new_tokens, eos_token_id, timeout_ms,
                     do_sample, temperature, stream=stream,
                     ttft_timeout_ms=ttft_timeout_ms)
        return stream

    def _submit(self, prompt_ids, max_new_tokens, eos_token_id, timeout_ms,
                do_sample, temperature, stream, ttft_timeout_ms):
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
        t = _now_ms()
        tmo = (self._cfg.request_timeout_ms if timeout_ms is None
               else float(timeout_ms))
        ttft_tmo = 0.0 if ttft_timeout_ms is None else float(ttft_timeout_ms)
        with self._cv:
            if self._closed:
                raise UnavailableError(f"{self.name}: engine is shut down")
            if len(self._queue) >= self._cfg.max_queue_depth:
                monitor.stat_add("STAT_gen_rejected")
                raise EngineOverloaded(
                    f"{self.name}: queue depth {self._cfg.max_queue_depth} "
                    f"reached; shed load or raise "
                    f"FLAGS_gen_max_queue_depth")
            req = _GenRequest(
                prompt, max_new, eos_token_id, bool(do_sample),
                float(temperature),
                stream.future if stream is not None else Future(),
                None if not tmo else t + tmo, t, stream=stream,
                ttft_deadline_ms=t + ttft_tmo if ttft_tmo else None)
            self._queue.append(req)
            monitor.stat_add("STAT_gen_queue_depth")
            self._cv.notify_all()
        monitor.stat_add("STAT_gen_requests")
        return req

    def generate(self, prompt_ids, **kw) -> np.ndarray:
        """Synchronous submit: blocks for this prompt's full sequence."""
        return self.submit(prompt_ids, **kw).result()

    # -- step loop ---------------------------------------------------------

    def _num_active(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    def _loop(self):
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        try:
            with torch.inference_mode():
                self._run()
        except BaseException as e:  # noqa: BLE001 — never hang submitters
            self._die(e)
            raise

    def _run(self):
        while True:
            with self._cv:
                while (not self._queue and self._num_active() == 0
                       and not self._closed):
                    self._cv.wait()
                if self._closed and self._abort:
                    self._evict_all(UnavailableError(
                        f"{self.name}: engine shut down"))
                    self._flush_resolutions()
                    return
                if (self._closed and not self._queue
                        and self._num_active() == 0):
                    return
            self._admit()
            self._expire_active()
            stepped = False
            if self._num_active():
                self._step()
                stepped = True
            self._flush_resolutions()
            if not stepped:
                with self._cv:
                    if (self._queue and self._num_active() == 0
                            and not self._abort):
                        # unadmittable head (page exhaustion): bounded
                        # wait so queued deadlines still expire
                        self._cv.wait(0.01)

    def _resolve_later(self, req: _GenRequest, result=None, exc=None):
        """Hold a request's resolution until the end of the iteration;
        its stream (if any) gets the terminal marker first."""
        if req.stream is not None:
            self._stream_q.append((req.stream, exc if exc is not None
                                   else TokenStream._END))
        self._resolve_q.append((req.future, result, exc))

    def _stage_token(self, req: _GenRequest, tok: int):
        if req.stream is not None:
            self._stream_q.append((req.stream, tok))

    def _flush_resolutions(self):
        sq, self._stream_q = self._stream_q, []
        for stream, item in sq:
            stream._put(item)
        q, self._resolve_q = self._resolve_q, []
        for fut, result, exc in q:
            try:
                if exc is not None:
                    fut.set_exception(exc)
                else:
                    fut.set_result(result)
            except Exception:  # noqa: BLE001 — racing caller-side cancel
                pass

    def _die(self, e: BaseException):
        """The step loop raised: fail every queued and live request with
        a typed error instead of leaving its caller waiting."""
        try:
            self._flush_resolutions()
        except Exception:  # noqa: BLE001 — best effort on a dying engine
            pass
        with self._cv:
            self._closed = True
            self._death = e
            stranded = list(self._queue)
            self._queue.clear()
            monitor.stat_sub("STAT_gen_queue_depth", len(stranded))
            self._cv.notify_all()
        err = UnavailableError(f"{self.name}: generation engine died: "
                               f"{e!r}")
        for req in [r for r in self._slots if r is not None] + stranded:
            if req.stream is not None:
                req.stream._put(err)
            try:
                req.future.set_exception(err)
            except Exception:  # noqa: BLE001 — already settled
                pass

    # -- admission ---------------------------------------------------------

    def _admit(self):
        """Admit queued requests while a slot AND worst-case pages are
        both free (FIFO, head-of-line blocking — later smaller requests
        never overtake)."""
        while True:
            with self._cv:
                self._expire_queued()
                if not self._queue:
                    return
                req = self._queue[0]
                slot = next((i for i, r in enumerate(self._slots)
                             if r is None), None)
                if slot is None:
                    return
                total = int(req.prompt.size) + req.max_new
                if not self._cache.can_admit(total):
                    monitor.stat_add("STAT_gen_admit_blocked")
                    return
                self._queue.popleft()
                monitor.stat_sub("STAT_gen_queue_depth")
                if not req.future.set_running_or_notify_cancel():
                    if req.stream is not None:
                        self._stream_q.append((req.stream, CancelledError()))
                    continue
                req.slot = slot
                req.pt_row = self._cache.alloc(req.rid, total)
                self._slots[slot] = req
            self._do_prefill(req)

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
                self._resolve_later(req, exc=ExecutionTimeoutError(
                    f"{self.name}: request expired after "
                    f"{t - req.t_enqueue_ms:.1f}ms in queue"))
                continue
            if req.future.cancelled():
                monitor.stat_sub("STAT_gen_queue_depth")
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

    def _do_prefill(self, req: _GenRequest):
        """Prefill the prompt through its bucket (writes its K/V pages),
        sample the first token, and mark the slot live. Non-finite
        logits fail ONLY this request and return its pages zeroed."""
        S = int(req.prompt.size)
        bucket = self._bucket_for(S)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :S] = req.prompt
        lg = self._prefill_call(req.pt_row, ids, S)
        tok, finite = self._first_token(req, lg)
        if not finite:
            monitor.stat_add("STAT_gen_poisoned")
            self._release(req)
            self._resolve_later(req, exc=FatalError(
                f"{self.name}: non-finite prefill logits for request "
                f"{req.rid} (poisoned prompt or weights)"))
            return
        self._prefills_total += 1
        monitor.stat_add("STAT_gen_prefills")
        req.next_pos = S
        req.t_first_ms = req.t_last_ms = _now_ms()
        self._deliver(req, tok)

    def _first_token(self, req: _GenRequest, logits):
        """First-token sampling from the prefill logits, through the
        engine's generator. Returns (token, logits-all-finite)."""
        tok = sample_logits(logits[None], req.do_sample, req.temperature,
                            self._cfg.top_k, self._gen)[0]
        out = torch.stack([tok, torch.isfinite(logits).all().long()]).cpu()
        return int(out[0]), bool(out[1])

    def _deliver(self, req: _GenRequest, tok: int):
        req.toks.append(tok)
        self._tokens_total += 1
        monitor.stat_add("STAT_gen_tokens")
        self._stage_token(req, tok)
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
            if req is None:
                continue
            active[i] = True
            toks[i] = req.toks[-1]
            pos[i] = req.next_pos
            temps[i] = req.temperature
            smask[i] = req.do_sample
            pt[i] = req.pt_row
        return pt, toks, pos, active, temps, smask

    def _step(self):
        """ONE engine step: every live sequence advances one token;
        inactive slots park on the scratch page."""
        if self._pre_step_hook is not None:
            self._pre_step_hook(self)
        nxt, bad = self._decode_call(*self._step_arrays())
        self._steps_total += 1
        monitor.stat_add("STAT_gen_steps")
        now = _now_ms()
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            if bad[i]:
                # poison isolation: only THIS sequence fails; its pages
                # are zeroed before reuse
                monitor.stat_add("STAT_gen_poisoned")
                self._evict(req, FatalError(
                    f"{self.name}: sequence {req.rid} produced non-finite "
                    f"logits at step {len(req.toks)}"))
                continue
            req.next_pos += 1
            req.t_last_ms = now
            self._deliver(req, int(nxt[i]))

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
            if req.stream is not None and req.toks:
                self._release(req)
                self._resolve_later(req, result=np.concatenate(
                    [req.prompt, np.asarray(req.toks, np.int32)]))
                continue
            self._evict(req, ExecutionTimeoutError(
                f"{self.name}: request {req.rid} expired after "
                f"{t - req.t_enqueue_ms:.1f}ms with "
                f"{len(req.toks)}/{req.max_new} tokens decoded"))

    # -- completion / eviction ---------------------------------------------

    def _release(self, req: _GenRequest):
        """Return the request's slot + pages (pages zeroed on device)."""
        pages = self._cache.free(req.rid)
        if pages:
            self._zero_pages(pages)
        if req.slot is not None and self._slots[req.slot] is req:
            self._slots[req.slot] = None
        with self._cv:
            self._cv.notify_all()

    def _complete(self, req: _GenRequest):
        out = np.concatenate([req.prompt, np.asarray(req.toks, np.int32)])
        self._release(req)
        t_done = _now_ms()
        self._hist.observe(t_done - req.t_enqueue_ms)
        self._ttft_hist.observe(req.t_first_ms - req.t_enqueue_ms)
        if len(req.toks) > 1:
            self._tpot_hist.observe((req.t_last_ms - req.t_first_ms)
                                    / (len(req.toks) - 1))
        if req.deadline_ms is not None and t_done > req.deadline_ms \
                and req.stream is None:
            monitor.stat_add("STAT_gen_timeouts")
            self._resolve_later(req, exc=ExecutionTimeoutError(
                f"{self.name}: request expired after "
                f"{t_done - req.t_enqueue_ms:.1f}ms"))
            return
        self._resolve_later(req, result=out)
        monitor.stat_add("STAT_gen_completions")

    def _evict(self, req: _GenRequest, err: BaseException):
        """Cancel a LIVE sequence: free + zero its pages, fail only its
        own future (and stream)."""
        self._release(req)
        monitor.stat_add("STAT_gen_evictions")
        self._resolve_later(req, exc=err)

    def _evict_all(self, err: BaseException):
        for req in list(self._slots):
            if req is not None:
                self._evict(req, err)

    # -- lifecycle / introspection -----------------------------------------

    def stats(self) -> dict:
        """Engine snapshot: per-slot state, page-pool occupancy, the
        program-shape ledger, token/step totals and latency histograms."""
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
        kv = dict(self._cache.stats())
        kv["owners"] = [{"rid": rid, "slot": slot_of.get(rid),
                         "pages": pages}
                        for rid, pages in sorted(self._cache.owners()
                                                 .items())]
        return {
            "slots": slots,
            "queue_depth": depth,
            "pages": self._cache.stats(),
            "kv": kv,
            "compiles": dict(self._ledger),
            "steps": self._steps_total,
            "prefills": self._prefills_total,
            "tokens": self._tokens_total,
            "device": str(self._device),
            "latency_ms": self._hist.snapshot(),
            "ttft_ms": self._ttft_hist.snapshot(),
            "tpot_ms": self._tpot_hist.snapshot(),
        }

    def health(self) -> dict:
        """Readiness verdict, same shape as the JAX engine's."""
        with self._cv:
            depth = len(self._queue)
            draining = self._closed
            live = int(self._thread.is_alive() and self._death is None)
            slots_free = sum(1 for r in self._slots if r is None)
        limit = self._cfg.max_queue_depth
        if draining:
            reason = "draining"
        elif not live:
            reason = "step loop dead"
        elif depth >= limit:
            reason = "queue at rejection threshold"
        else:
            reason = "ok"
        return {"ready": reason == "ok", "reason": reason,
                "warmup_complete": True, "draining": draining,
                "live_lanes": live, "queue_depth": depth,
                "queue_limit": limit, "slots_free": slots_free,
                "slots": self._cfg.max_slots}

    def shutdown(self, drain: bool = True,
                 timeout_s: Optional[float] = None):
        """Stop intake; by default every queued + live sequence finishes
        before the step loop exits. drain=False fails pending futures
        fast (live sequences are evicted, pages freed)."""
        with self._cv:
            self._closed = True
            if not drain:
                self._abort = True
                while self._queue:
                    req = self._queue.popleft()
                    monitor.stat_sub("STAT_gen_queue_depth")
                    err = UnavailableError(f"{self.name}: engine shut down")
                    if req.stream is not None:
                        req.stream._put(err)
                    try:
                        req.future.set_exception(err)
                    except Exception:  # noqa: BLE001 — already settled
                        pass
            self._cv.notify_all()
        self._thread.join(timeout_s)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
