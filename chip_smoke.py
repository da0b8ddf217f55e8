#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) end to end on one GPU.

    python3 chip_smoke.py            # every phase, exit 0 only if all pass
    python3 chip_smoke.py --kernels  # phases 1-3 only (build + kernel checks)
    python3 chip_smoke.py --profile  # also profile serving and train steps

Phases:
 1. card      name and power limit from nvidia-smi, torch/CUDA versions,
              the matmul settings (no TF32; 16-bit GEMMs reduce in fp32)
 2. build     nvcc builds every kernel from paddle_tpu_torch/csrc, timed;
              ptxas' registers and spills of every instantiation
 3. kernels   each kernel's wrapper against its plain PyTorch version on
              the card at the main paths' shapes (max abs error, kernel
              ms, plain ms, the least time the card could take, and one
              PyTorch library call where one computes the same function;
              CUDA-event time per call, and for K1, K2, K2's library
              call and K5 the device time per call beside it, see
              _time_ms):
              K1 paged decode (phase 3's 8 slots of random lengths, the
              decode profile's 8 x 230 tokens, 2 x 1024 tokens, and phase
              3's slots at head dims 80, 96, 256, 36 and 264; fp32, bf16
              and fp16;
              the split count per row), K2 flash forward (serving
              shape, fp32, bf16 and fp16, and the training shape with
              dropout), K3 flash dQ and K4 flash
              dK/dV (training shape, dropout 0 and 0.1, fp32, bf16 and
              fp16; head dims 128 and 32 at the train width, fp32 and
              bf16; Sq 1024 != Sk 1536; head dims 80, 96 and 256, which
              run at padded widths, in fp32, bf16 and fp16), with the
              achieved TFLOP/s;
              FlashAttention's gradients against autograd through the
              plain forward; gradients reaching q/k/v through K2 (C4)
 4. model     GPT-2 small (GPTConfig() defaults, fp32, seed 0): a [2,1024]
              full forward through the flash kernel against the plain path
 5. serving   GenerationEngine (8 slots, page 16, buckets 16/64/256/1024)
              serving 16 greedy streamed requests, some joining while
              others decode; every output token-identical to the port's
              own generate(); kernel launch counts read off this run;
              the observability gates (check_observability): the step
              ring read from /steps sums to stats() and the requests,
              its goodput buckets tile each iteration's wall exactly,
              /metrics over 127.0.0.1 shows STAT_kv_cache_hbm_bytes equal
              to the live caches' bytes, the device-memory gauge and one
              ttft_ms / tpot_ms count a request, /healthz 200;
              then a GPT with head dim 96 (hidden 768, 8 heads, 2 layers)
              serving 4 requests through K1, token-identical to generate(),
              its 300-token prompt prefilled through K2 at head dim 96
 5b. features GPT-2 small served with the JAX engine's three scheduling
              features, each against generate() and the engine with it
              off: a prefix arm (8 requests sharing a 192-token system
              prompt + a full-prompt repeat, cache on / off at equal
              pages: hits, one CoW split, K1 once a layer a step, no
              page leaked; TTFT p50), a spec arm (spec_k 4: the
              NGramProposer on motif prompts, spec off, an oracle
              proposer with acceptance 1.0 in <= ceil(64/5)+1 steps, a
              reject proposer and a later owner of its pages; no K1
              launch; tokens/s) and a chunk arm (a 900-token prompt
              joining 4 live streams with prefill_chunk 128, then 0:
              8 chunks and no K2 launch, then K2; the live streams'
              TPOT p50 and p99)
 5c. quant    GPT-2 small quantized on phase 5's engine settings and 16
              requests (int4 and fp16 arms: the first 8): weight-only
              int8 and int4 weights over fp32 pools
              (each token-identical to generate() on the same quantized
              model; K1 once a layer a step; K2 for the long prompts;
              resident weight bytes), fp32 weights over int8 pools twice
              (first token exact against fp32 pools, bit-stable, no K1;
              agreement, flip margins and can_admit capacity at equal pool
              bytes recorded), int8 pools with the prefix cache on 5b's
              prefix requests (the miss identical to the cache off, every
              other output up to a near-tie flip; one CoW split, freed
              pages' scale rows 0) and an fp16 GPT-2 small over fp16
              pools (first tokens exact, identical to its generate() up
              to near-tie flips, K1 in fp16); with --profile, the
              quantized decode steps' device time
 5d. tier    GPT-2 small with the prefix cache (80 pages) and the host
              KV tier on: four 592-token system prompts served one at a
              time, then again with new tails, so each revisit promotes
              its demoted chain; fp32 and int8 pools and the two tier
              failpoints (promote_upload@2, demote_gather@1); every output
              identical to a never-evicting engine (fp32: and to
              generate()), the audit counts each arm implies, no page
              leaked on either tier, K1 = steps x 12 (fp32), K2 = 12 x the
              cold prefills, the observability gates; TTFT of promoted
              against cold against device hits, the revisit's admission
              iteration by part, promotion ms a page, its H2D rate and
              host ms by part, demotion ms (host and stream), garbage
              collections, tokens/s with the step log, audit ring and
              spans on against off, and the host time of each
              observability call an iteration
 5e. fleet   GPT-2 small at phase 5's engine settings under the
              supervisor and the router. (a) Phase 5's 16 streamed
              requests (8 joining while 8 decode) through one
              EngineSupervisor (backoff 5 ms): decode_step_raise@12 (8
              live, 8 queued at the death), prefill_raise@1, and a
              spec_k 4 engine whose poison storm turns speculation off
              before decode_step_raise@1; each identical to generate(),
              every stream exactly once, one ENGINE_RESTART, REPLAY_ADMIT
              = the manifest's entries = the STAT_gen_replayed_requests
              delta, incarnation 1, no ledger key, no nvcc and the same
              loaded libraries, K1 = 12 x (decode steps of both
              incarnations + the rebuild's warmup step), K2 = 12 x the
              prefills in the 1024 bucket, no page leaked, the residency
              gauge back to one cache, the dead pools released, and the
              restart's peak allocated bytes under the death step's +
              half a pool set; the breaker arm (every step dies, retry
              limit 2, threshold 3): every request typed
              UnavailableError, BREAKER_OPEN once, /readyz 503 with the
              reason. (b) A Router over two supervised replicas (prefix
              cache on): four agent sessions of three turns with
              affinity on (turns 2-3 on turn 1's replica, 8
              ROUTE_AFFINITY) and off, identical to generate(); phase 5's
              requests with decode_step_raise@6 killing one replica
              (every request served through its replay, no
              ROUTE_REROUTE, the router's /readyz 200 throughout); two
              replicas against one engine, tokens/s. Printed: recovery
              ms, death to the first replayed token, steady and peak
              allocated bytes, prefix-hit tokens and TTFT with affinity
              on and off
 6. train     GPT-2 small (dropout 0.1, fp32) trained through
              hapi.Model.fit: AdamW under LinearWarmup, global-norm clip,
              cross-entropy, batch 8 x 1024, 20 steps over a seeded
              learnable token set; the loss falls and stays finite, every
              flash kernel launched 12 times a step; then one train_batch
              through the kernels against one through the plain path
              (dropout 0, [2, 1024]): loss and every gradient agree.
              Then the same fit under amp_configs="O1" (bf16; K2-K4
              launched 12 times a step, all counted in bf16), and the
              fp16 AMP loop of the same 20 steps (auto_cast(dtype=
              "float16") + GradScaler; K2-K4 counted in fp16), and the
              AMP step parities at [2, 1024], kernels against
              FLAGS_use_flash_attention=False under the same AMP: one
              bf16 train_batch, one hand-written amp.auto_cast(dtype=
              "float16") step with GradScaler (K2-K4 counted in fp16)
 7. packing   the packed LM of bench.py --mode packing at its full size
              (T 1024, hidden 256, 4 heads, vocab 8192, 2048 sequences of
              clipped-lognormal lengths, 64 a pack) trained through
              hapi.Model.fit with io.PackingCollator: one epoch packed
              (first-fit), one padded (one sequence a row, 16 rows);
              effective tokens/s, fill, step wall, K5-K7 launches a step;
              the loss falls; then one packed epoch under
              amp_configs="O1" (K5-K7 counted in bf16, the loss falls)
              and one written out under auto_cast(dtype="float16") +
              GradScaler (K5-K7 counted in fp16); then packed-vs-padded loss parity on 8 sequences and one
              train_batch through K5-K7 against one through the dense
              segment-masked path
Phase 3 also holds the splash kernels to their plain versions: K5 splash
forward, K6 splash dQ and K7 splash dK/dV at GPT-2 small's attention
width (B 8, H 12, S 1024, D 64) and at the packing phase's shape, with
segment ids from io.PackingCollator over the bench's lengths (causal, p
0 and 0.1, fp32, bf16 and fp16, and a non-causal case whose absent
segment gives exact zero rows; the packing phase's shape in fp32, bf16
and fp16, and at head dims 80, 96 and 256 in the three types), with
the share of K5's (warp band, key tile) pairs that take its mask-free
path, the share of the 16x8 sub-tiles of K6's and K7's tiles that can
hold an allowed pair and, where the library call runs, K5 against the
library's forward and K6 + K7 against its whole backward;
SplashAttention's gradients against autograd through the plain forward.
--profile's profiler sessions come after serving, so that run's train
and packing walls carry them; each train path (fp32, AMP) is profiled
over 3 steps with its GEMM share.
Then one JSON line describing the kernels (K1 also as a
"paged_attention.float16" row, K2-K4 as "flash_fwd.bfloat16"/".float16"
rows and K5-K7 as ".bfloat16" and ".float16" rows, their launches
counted in that type), and as the last line
{"ok": true, "device": {...}}. Any failed phase exits 1 with no result;
no CUDA device, or no paddle_tpu_torch next to this file, exits 2.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit).
# The fp32 bound is the fp32-accurate tensor-core rate, 3xTF32 (three TF32
# products a product): 495 / 3 TFLOP/s, the least time the card could take
# for fp32 products; the CUDA cores' 67 TFLOP/s is printed beside it.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12,
              "float16": 989e12}
CUDA_CORE_FP32 = 67e12

# kernel-vs-plain limits of K2-K4, x max(1, max |ref|) at the train shape
# (absolute at the serving shape): fp32 summation order (3xTF32); one
# rounding of P (K2) or dS / Pd (K3, K4) and of the output in the 16-bit
# types, float16 keeping 10 mantissa bits to bfloat16's 7
FLASH_TOL = {"float32": 1e-4, "bfloat16": 1e-2, "float16": 2e-3}
# K1 in fp16 (ROADMAP C10) against the plain version in fp32 on the same
# fp16 values, rounded to fp16: one rounding of an output below 4 in
# magnitude (ulp <= 2^-9) over fp32 sums
K1_FP16_TOL = 2e-3
K1_SHAPE = dict(B=8, H=12, D=64, P=16, PP=64)
K2_SHAPE = dict(B=2, H=12, S=1024, D=64)
TRAIN_SHAPE = dict(B=8, H=12, S=1024, D=64)   # the train phase's attention
TRAIN_STEPS = 20
DROPOUT = 0.1
# bench.py --mode packing, full size (bench.py:2348-2349, 2428, 2468)
PACK = dict(T=1024, DIM=256, HEADS=4, VOCAB=8192, NSEQ=2048, BS=64,
            HEADROOM=1.15, PAD_ROWS=16)
SPLASH_SHAPE = dict(B=8, H=12, S=1024, D=64)   # GPT-2 small's attention
# ROADMAP C11: head dims K2-K7 run at padded widths, each with the heads
# that keep about GPT-2 small's width (768) at the train and pack shapes
HEAD_DIM_CASES = ((80, 10), (96, 8), (256, 3))
# phase 5b's engines: phase 5's slots, page and buckets; spec_k of its
# spec arm
FEAT = dict(slots=8, page=16, buckets=(16, 64, 256, 1024), spec_k=4)
# phase 5c: a top-2 logit gap below which a token flip between two paths
# that round differently (an int8 prefix-cache hit against a miss; the
# fp16 engine's K1 against generate()'s dense fp16 attention) counts as a
# near-tie. Int8 pages move GPT-2 small's logits (std 0.55) by about 1e-3,
# and fp16 logits resolve 2^-9 = 1.95e-3 near its top logits; on an NVIDIA
# H100 80GB HBM3 at 700 W the flips sat at gaps of 2.9e-4 to 2.9e-3
# (PERF.md §2)
NEAR_TIE = 1e-2
# AMP step parity (kernels vs plain path under one AMP): loss rtol, and a
# gradient's share of its own max (see Smoke.amp_step_parity)
AMP_LOSS_RTOL = {"bfloat16": 1e-3, "float16": 1e-3}
AMP_GRAD_SHARE = {"bfloat16": 2.5e-2, "float16": 1e-2}
# kernel names of the GEMMs in a profile (cuBLAS, cuBLASLt, CUTLASS)
_GEMM = r"gemm|nvjet|xmma|cutlass|splitKreduce"


def _bench_lengths(np):
    """The bench's sequence lengths: clipped lognormal, mean ~235 of
    1024 (bench.py:2351-2353)."""
    T = PACK["T"]
    rng = np.random.RandomState(7)
    return np.clip(np.round(np.exp(rng.normal(
        np.log(T / 6.0), 0.9, PACK["NSEQ"]))).astype(int), 4, T)


def _motif_seqs(np, lengths):
    """(tokens, labels) per length: one of 64 seeded motifs (3-8 ids) run
    along the sequence, each label the next token, so the loss can
    fall."""
    rng = np.random.RandomState(0)
    motifs = [rng.randint(0, PACK["VOCAB"], size=rng.randint(3, 9))
              for _ in range(64)]
    out = []
    for n in lengths:
        s = np.resize(motifs[rng.randint(64)], n + 1).astype(np.int64)
        out.append((s[:-1], s[1:]))
    return out


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def _rates(flops, ms, dtype):
    """Achieved TFLOP/s of `flops` in `ms`, and for fp32 the time the
    same work takes at the CUDA cores' peak (67 TFLOP/s): (dict, text)."""
    r = dict(tflops=flops / ms / 1e9)
    text = f"achieved {r['tflops']:.1f} TFLOP/s"
    if dtype == "float32":
        r["cuda_core_bound_ms"] = flops / CUDA_CORE_FP32 * 1e3
        text += (f", fp32 CUDA-core bound {r['cuda_core_bound_ms']:.4f} ms "
                 f"(67 TFLOP/s)")
    return r, text


# cycles the card spins (torch.cuda._sleep; ~1 ms at the H100's 1.98
# GHz) before a device-timed call, while the host enqueues the call
_AHEAD_CYCLES = 2_000_000


def _time_ms(torch, fn, iters, flush=None, device=False):
    """Mean ms of `fn` over `iters` calls, CUDA events around each call;
    `flush` (untimed) runs before each call to evict the L2. Event time
    counts the wrapper's host time whenever the card waits for it. With
    `device`, the card first spins for _AHEAD_CYCLES while the host
    enqueues the events and the call, so the events time only the call's
    kernels on the card: device time per call. A call whose start event
    the card had passed before the host finished enqueuing it may still
    hold host time; such calls are counted and printed."""
    fn()
    torch.cuda.synchronize()
    total, late = 0.0, 0
    for _ in range(iters):
        if flush is not None:
            flush()
        if device:
            torch.cuda._sleep(_AHEAD_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        late += device and s.query()
        e.synchronize()
        total += s.elapsed_time(e)
    if late:
        print(f"  {late} of {iters} device-timed calls were still being "
              f"enqueued when the card reached them")
    return total / iters


class Smoke:
    def __init__(self, args):
        import torch
        self.torch = torch
        self.args = args
        self.failures = []
        self.kernel_rows = {}
        self.path_launches = {}   # main path -> kernel -> launches
        self.path_dtype_launches = {}   # ... -> kernel -> dtype -> launches
        self.details = {}
        # fp32 products in full fp32, as the JAX package pins
        # jax_default_matmul_precision="highest"; 16-bit GEMMs (the AMP
        # phases) reduce in fp32 too, not in the 16-bit type, as XLA
        # accumulates bf16 products in fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
            False
        self.l2 = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def flush(self):
        self.l2.zero_()

    def time_ms(self, fn, iters, flush=None):
        """(device ms, CUDA-event ms) per call of `fn` (`_time_ms`)."""
        return (_time_ms(self.torch, fn, iters, flush, device=True),
                _time_ms(self.torch, fn, iters, flush))

    def _wrappers(self):
        from paddle_tpu_torch.ops import flash_ops as fo, paged_ops as po
        from paddle_tpu_torch.ops import splash_ops as so
        return {"paged_attention": po.paged_attention,
                "flash_fwd": fo.flash_attention_fwd,
                "flash_bwd_dq": fo.flash_attention_dq,
                "flash_bwd_dkv": fo.flash_attention_dkv,
                "splash_fwd": so.splash_attention_fwd,
                "splash_bwd_dq": so.splash_attention_dq,
                "splash_bwd_dkv": so.splash_attention_dkv}

    def zero_launches(self):
        for w in self._wrappers().values():
            w.launches = 0
            if hasattr(w, "launches_by_dtype"):
                w.launches_by_dtype.clear()

    def read_launches(self):
        return {n: w.launches for n, w in self._wrappers().items()}

    def record_path(self, name):
        """Keep the launch counts of the main path `name` just driven (in
        all and by type); returns the counts in all."""
        self.path_launches[name] = self.read_launches()
        self.path_dtype_launches[name] = self.read_launches_by_dtype()
        return self.path_launches[name]

    def read_launches_by_dtype(self):
        """{kernel: {dtype: launches}} of the wrappers that count by type
        (K2-K7)."""
        return {n: dict(w.launches_by_dtype)
                for n, w in self._wrappers().items()
                if hasattr(w, "launches_by_dtype")}

    def phase(self, name, fn):
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
            print(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
            return True
        except Exception:  # noqa: BLE001 — recorded, the run exits 1
            traceback.print_exc()
            self.failures.append(name)
            print(f"== phase {name} FAILED", flush=True)
            return False

    # -- 1. card --------------------------------------------------------------

    def card(self):
        torch = self.torch
        self.smi = _smi()
        print(f"card: {self.smi}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} devices "
              f"{torch.cuda.device_count()}")
        m = torch.backends.cuda.matmul
        print(f"matmul: allow_tf32 {m.allow_tf32}, "
              f"allow_bf16_reduced_precision_reduction "
              f"{m.allow_bf16_reduced_precision_reduction}, "
              f"allow_fp16_reduced_precision_reduction "
              f"{m.allow_fp16_reduced_precision_reduction}")

    # -- 2. build -------------------------------------------------------------

    def build(self):
        from paddle_tpu_torch.ops import _build
        secs = _build.build()
        print(f"build: {len(_build.SOURCES)} sources in {secs:.1f} s "
              f"({_build.build_dir()})")
        ptxas = {}
        for src in _build.SOURCES:
            kernels = _ptxas_kernels(_build.ptxas_log(src))
            ptxas[src] = kernels
            for name, regs, spill in kernels:
                print(f"  ptxas {src}: {name}: {regs} registers, spill "
                      f"stores/loads {spill[0]}/{spill[1]} bytes")
        spilled = [f"{src}: {n}" for src, ks in ptxas.items()
                   for n, _, sp in ks if sp != (0, 0)]
        print(f"ptxas: {sum(map(len, ptxas.values()))} kernels, spills in "
              f"{spilled if spilled else 'none'}")
        self.details["build_s"] = secs
        self.details["ptxas"] = ptxas

    # -- 3. kernels against their plain versions --------------------------------

    def k1_inputs(self, dtype, B, lens=None, seed=0, D=None):
        """q, pools, page table and pos for B slots of K1_SHAPE's heads,
        pages and table width (head dim D, K1_SHAPE's by default): random
        lengths 1..PP*P (seeded) unless `lens` gives them. Page 0 is the
        scratch page, full of junk."""
        torch = self.torch
        H, P, PP = (K1_SHAPE[k] for k in ("H", "P", "PP"))
        D = D or K1_SHAPE["D"]
        g = torch.Generator(device="cuda").manual_seed(seed)
        N = B * PP + 1
        if lens is None:
            lens = torch.randint(1, PP * P + 1, (B,), generator=g,
                                 device="cuda")
        else:
            lens = torch.tensor(lens, device="cuda")
        kp = torch.randn(H, N, P, D, generator=g, device="cuda").to(dtype)
        vp = torch.randn(H, N, P, D, generator=g, device="cuda").to(dtype)
        kp[:, 0] = 1e4   # scratch-page junk: must never reach the result
        vp[:, 0] = 1e4
        perm = torch.randperm(N - 1, generator=g, device="cuda") + 1
        pt = torch.zeros(B, PP, dtype=torch.int32, device="cuda")
        for b in range(B):
            n = -(-int(lens[b]) // P)
            pt[b, :n] = perm[b * PP:b * PP + n].int()
        q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
        pos = (lens - 1).int()
        return q, kp, vp, pt, pos, lens

    def check_k1(self):
        """K1 against its plain version at three shapes, fp32, bf16 and
        fp16 (ROADMAP C10):
        phase 3's (8 slots of random lengths up to 1024), the decode
        profile's (8 slots of 230 tokens) and a long context (2 slots of
        1024); and phase 3's slots at head dims 80, 96 and 256 (ROADMAP
        C7: rows of 20/10, 24/12 and 64/32 16-byte chunks in fp32/bf16),
        36 and 264 (D % 8 != 0 and D > 256: the padded widths 64 and 512,
        one-value loads masked at D).
        ms: device time per call (`time_ms`; both kernels of the split),
        the event time beside it; the L2 is flushed before each call, as a
        decode step finds it cold; no library call computes K1's
        function."""
        torch = self.torch
        from paddle_tpu_torch.ops import paged_ops as po
        H, P, PP = (K1_SHAPE[k] for k in ("H", "P", "PP"))
        pps = po._pages_per_split(P)
        nsplit = -(-PP // pps)
        shapes = [("phase3", K1_SHAPE["B"], None, K1_SHAPE["D"]),
                  ("decode_profile", 8, [230] * 8, K1_SHAPE["D"]),
                  ("long", 2, [PP * P] * 2, K1_SHAPE["D"])]
        shapes += [(f"phase3_d{D}", K1_SHAPE["B"], None, D)
                   for D in (80, 96, 256, 36, 264)]
        rows = []
        for shape, B, lens_in, D in shapes:
            scale = 1.0 / D ** 0.5
            for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2),
                               (torch.float16, K1_FP16_TOL)):
                q, kp, vp, pt, pos, lens = self.k1_inputs(dtype, B, lens_in,
                                                          D=D)
                out = po.paged_attention(q, kp, vp, pt, pos, scale)
                # the plain version in float32 on the same inputs, then
                # rounded to the kernel's output type
                ref = po.paged_attention_plain(q.float(), kp.float(),
                                               vp.float(), pt, pos,
                                               scale).to(dtype)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()

                def call():
                    po.paged_attention(q, kp, vp, pt, pos, scale)
                ms, event_ms = self.time_ms(call, 50, self.flush)
                plain_ms = _time_ms(torch, lambda: po.paged_attention_plain(
                    q, kp, vp, pt, pos, scale), 10, self.flush)
                item = q.element_size()
                toks = int(lens.sum())
                live = sum(-(-int(n) // (pps * P)) for n in lens.tolist())
                nbytes = (2 * toks * H * D * item + 2 * q.numel() * item
                          + pt.numel() * 4 + pos.numel() * 4)
                flops = 4 * toks * H * D
                name = str(dtype).replace("torch.", "")
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / PEAK_FLOPS[name] * 1e3
                rates, rtext = _rates(flops, ms, name)
                row = dict(shape=shape, D=D, dtype=name, max_abs_err=err,
                           tol=tol, ms=ms, event_ms=event_ms, plain_ms=plain_ms,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else
                           "operations", library_ms=None, tokens=toks,
                           splits=nsplit, live_splits=live / B,
                           gbytes_per_s=nbytes / ms / 1e6, **rates)
                rows.append(row)
                print(f"K1 paged_attention {name} {shape} B={B} H={H} D={D} "
                      f"P={P} PP={PP} len sum {toks}: max_abs_err {err:.3e} "
                      f"(tol {tol}); splits per (b, h) {nsplit} of "
                      f"{pps * P} tokens, {live / B:.2f} live on average; "
                      f"device {ms:.4f} ms/call (event "
                      f"{event_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                      f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
                      f"{row['bound_ms'] / ms:.3f} of it), "
                      f"{row['gbytes_per_s']:.0f} GB/s; {rtext}")
                assert err <= tol, \
                    f"K1 {name} {shape} disagrees with its plain version"
        self.details["k1"] = rows
        self.kernel_rows["paged_attention"] = rows[0]
        # the fp16 serving path's row (phase 5c's fp16 arm): phase 3's slots
        self.kernel_rows["paged_attention.float16"] = next(
            r for r in rows if r["shape"] == "phase3"
            and r["dtype"] == "float16")

    def k2_inputs(self, dtype, causal, padded, seed=1):
        torch = self.torch
        B, H, S, D = (K2_SHAPE[k] for k in ("B", "H", "S", "D"))
        g = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v = (torch.randn(B, H, S, D, generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        bias = None
        if padded:
            bias = torch.zeros(B, S, device="cuda")
            bias[0, 700:] = -1e30
            # non-causal: a fully masked batch row (uniform output rows);
            # causal: key 0 stays visible to every query
            bias[1, 300 if causal else 0:] = -1e30
        return q, k, v, bias

    def check_k2(self):
        """K2 at the serving shape, p 0, fp32, bf16 and fp16, causal or
        not, with and without a key-padding bias. ms and library ms: device
        time per call (`time_ms`), the event time beside each."""
        torch = self.torch
        import torch.nn.functional as TF
        from paddle_tpu_torch.ops import flash_ops as fo
        B, H, S, D = (K2_SHAPE[k] for k in ("B", "H", "S", "D"))
        scale = 1.0 / D ** 0.5
        rows = []
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 1e-2),
                           (torch.float16, FLASH_TOL["float16"])):
            for causal in (True, False):
                for padded in (False, True):
                    q, k, v, bias = self.k2_inputs(dtype, causal, padded)
                    out, lse = fo.flash_attention_fwd(q, k, v, bias, causal,
                                                      scale)
                    ref, ref_lse = fo._flash_fwd_reference(q, k, v, bias,
                                                           causal, scale)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    lse_err = (lse - ref_lse).abs().max().item()

                    def call():
                        fo.flash_attention_fwd(q, k, v, bias, causal, scale)
                    ms, event_ms = self.time_ms(call, 20)
                    plain_ms = _time_ms(torch, lambda: fo._flash_fwd_reference(
                        q, k, v, bias, causal, scale), 5)
                    mask = None
                    if padded or causal:
                        mask = torch.zeros(B, 1, S, S, device="cuda")
                        if padded:
                            mask = mask + bias[:, None, None, :]
                        if causal:
                            mask = mask.masked_fill(torch.ones(
                                S, S, dtype=torch.bool,
                                device="cuda").triu(1), -1e30)
                        mask = mask.to(dtype)

                    def lib():
                        TF.scaled_dot_product_attention(q, k, v,
                                                        attn_mask=mask)
                    lib_ms, lib_event_ms = self.time_ms(lib, 20)
                    item = q.element_size()
                    nbytes = (4 * B * H * S * D * item + B * H * S * 4
                              + (bias.numel() * 4 if padded else 0))
                    pairs = S * (S + 1) // 2 if causal else S * S
                    flops = 4 * B * H * pairs * D
                    name = str(dtype).replace("torch.", "")
                    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    t_ops = flops / PEAK_FLOPS[name] * 1e3
                    rates, rtext = _rates(flops, ms, name)
                    row = dict(dtype=name, causal=causal, padded=padded,
                               max_abs_err=err, lse_err=lse_err, tol=tol,
                               ms=ms, event_ms=event_ms, plain_ms=plain_ms,
                               bound_ms=max(t_bytes, t_ops),
                               bound_by="bytes" if t_bytes >= t_ops
                               else "operations", library_ms=lib_ms,
                               library_event_ms=lib_event_ms, **rates)
                    rows.append(row)
                    print(f"K2 flash_fwd {name} causal={causal} "
                          f"padded={padded} B=2 H=12 S=1024 D=64: max_abs_err "
                          f"{err:.3e} lse_err {lse_err:.3e} (tol {tol}) "
                          f"device {ms:.4f} ms (event {event_ms:.4f}) plain "
                          f"{plain_ms:.4f} ms library device {lib_ms:.4f} ms "
                          f"(event {lib_event_ms:.4f}), "
                          f"{ms / lib_ms:.3f} x the library; bound "
                          f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
                          f"{row['bound_ms'] / ms:.3f} of it); {rtext}")
                    assert torch.isfinite(out.float()).all(), "K2 non-finite"
                    assert err <= tol and lse_err <= tol, \
                        f"K2 {name} causal={causal} padded={padded} " \
                        f"disagrees with its plain version"
        self.details["k2"] = rows

    def train_inputs(self, dtype, causal, padded, seed=2, H=None, D=None,
                     Sq=None, Sk=None):
        """q, dO [B, H, Sq, D] and k, v [B, H, Sk, D] (by default the
        train phase's attention shape), and a key bias whose masked tails
        leave every row some visible key."""
        torch = self.torch
        B = TRAIN_SHAPE["B"]
        H = H or TRAIN_SHAPE["H"]
        D = D or TRAIN_SHAPE["D"]
        Sq = Sq or TRAIN_SHAPE["S"]
        Sk = Sk or Sq
        g = torch.Generator(device="cuda").manual_seed(seed + 2 * causal)
        q, k, v, do = (torch.randn(B, H, S, D, generator=g, device="cuda")
                       .to(dtype) for S in (Sq, Sk, Sk, Sq))
        bias = None
        if padded:
            bias = torch.zeros(B, Sk, device="cuda")
            bias[0, 700:] = -1e30
            bias[1, 300:] = -1e30
        return q, k, v, do, bias

    def _row(self, name, dtype, err, ref_max, tol, ms, plain_ms, flops,
             nbytes, lib_ms, **extra):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        rates, rtext = _rates(flops, ms, dtype)
        row = dict(dtype=dtype, max_abs_err=err, ref_max=ref_max, tol=tol,
                   ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=lib_ms, **rates, **extra)
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        print(f"{name} {dtype} " + " ".join(f"{k}={v}" for k, v in
                                             extra.items())
              + f": max_abs_err {err:.3e} (max |ref| {ref_max:.3e}, tol "
              f"{tol} x max(1, max |ref|)) kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms library {lib} bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
              f"{row['bound_ms'] / ms:.3f} of it); {rtext}")
        assert err <= tol * max(1.0, ref_max), \
            f"{name} {dtype} {extra} disagrees with its plain version"
        return row

    def check_train_kernels(self):
        """K2 with dropout, K3 and K4 against their plain versions on the
        same inputs and seed. At the train phase's attention shape: fp32
        bf16 and fp16, causal or not, p 0 and 0.1, and a padded bias (fp32).
        At the train width with other head dims (D 128 with H 6, D 32 with H 24),
        causal, p 0.1, fp32 and bf16; and non-causal with Sq 1024 != Sk
        1536, p 0.1, fp32 and bf16. The backward pair is fed the plain
        forward's O, LSE and delta, so only the kernels' arithmetic
        differs. Tolerances, relative to max(1, max |ref|): FLASH_TOL."""
        torch = self.torch
        import torch.nn.functional as TF
        from paddle_tpu_torch.ops import flash_ops as fo
        B, H0, S0, D0 = (TRAIN_SHAPE[k] for k in ("B", "H", "S", "D"))
        seed = 1234
        rows = {"fwd": [], "dq": [], "dkv": []}
        train = dict(H=H0, D=D0, Sq=S0, Sk=S0)
        cases = [dict(train, dtype=dt, causal=c, p=p, padded=False)
                 for dt in ("float32", "bfloat16", "float16")
                 for c in (True, False) for p in (0.0, DROPOUT)]
        cases += [dict(train, dtype="float32", causal=c, p=DROPOUT,
                       padded=True) for c in (True, False)]
        for dt in ("float32", "bfloat16"):
            cases += [dict(H=6, D=128, Sq=S0, Sk=S0, dtype=dt, causal=True,
                           p=DROPOUT, padded=False),
                      dict(H=24, D=32, Sq=S0, Sk=S0, dtype=dt, causal=True,
                           p=DROPOUT, padded=False),
                      dict(H=H0, D=D0, Sq=S0, Sk=1536, dtype=dt,
                           causal=False, p=DROPOUT, padded=False)]
        # ROADMAP C11: head dims at padded widths, in every type
        cases += [dict(H=H, D=D, Sq=S0, Sk=S0, dtype=dt, causal=True,
                       p=DROPOUT, padded=False)
                  for D, H in HEAD_DIM_CASES
                  for dt in ("float32", "bfloat16", "float16")]
        lib = {}
        for case in cases:
            name, causal, p, padded = (case[k] for k in
                                       ("dtype", "causal", "p", "padded"))
            H, D, Sq, Sk = (case[k] for k in ("H", "D", "Sq", "Sk"))
            dtype = getattr(torch, name)
            scale = 1.0 / D ** 0.5
            tol = FLASH_TOL[name]
            q, k, v, do, bias = self.train_inputs(dtype, causal, padded,
                                                  H=H, D=D, Sq=Sq, Sk=Sk)
            tag = dict(shape=f"{B}x{H}x{Sq}x{Sk}x{D}", causal=causal, p=p,
                       padded=padded)
            pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
            # bytes each kernel must move: its [B,H,S,D] operands read or
            # written once, the [B*H,Sq] f32 statistics, the [B,Sk] bias
            q_b = B * H * Sq * D * q.element_size()
            k_b = B * H * Sk * D * q.element_size()
            row_b = B * H * Sq * 4
            bias_b = B * Sk * 4 if padded else 0
            key = (name, causal, tag["shape"])
            if key not in lib and not padded:
                # the library yardsticks, p = 0: SDPA forward (device time,
                # its event time beside it), and its backward under
                # autograd timed as one call (event time)
                ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))

                def lib_call():
                    TF.scaled_dot_product_attention(ql, kl, vl,
                                                    is_causal=causal)
                fwd_ms, fwd_event_ms = self.time_ms(lib_call, 10)
                ol = TF.scaled_dot_product_attention(ql, kl, vl,
                                                     is_causal=causal)
                bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(
                    ol, (ql, kl, vl), do, retain_graph=True), 10)
                lib[key] = (fwd_ms, bwd_ms, fwd_event_ms)
                del ql, kl, vl, ol
            lib_fwd, lib_bwd, lib_fwd_event = lib.get(
                key, (None, None, None)) if not padded else (None, None, None)
            # K2 (ms: device time, the event time beside it)
            out, lse = fo.flash_attention_fwd(q, k, v, bias, causal, scale,
                                              p, seed)
            ref, ref_lse = fo._flash_fwd_reference(q, k, v, bias, causal,
                                                   scale, p, seed)
            torch.cuda.synchronize()
            err = max((out.float() - ref.float()).abs().max().item(),
                      (lse - ref_lse).abs().max().item())
            assert torch.isfinite(out.float()).all(), "K2 non-finite"

            def k2_call():
                fo.flash_attention_fwd(q, k, v, bias, causal, scale, p, seed)
            k2_ms, k2_event_ms = self.time_ms(k2_call, 10)
            rows["fwd"].append(self._row(
                "K2 flash_fwd", name, err, ref.float().abs().max().item(),
                tol, k2_ms,
                _time_ms(torch, lambda: fo._flash_fwd_reference(
                    q, k, v, bias, causal, scale, p, seed), 3),
                4 * B * H * pairs * D, 2 * q_b + 2 * k_b + row_b + bias_b,
                lib_fwd, event_ms=round(k2_event_ms, 4),
                library_event_ms=None if lib_fwd_event is None
                else round(lib_fwd_event, 4), **tag))
            if lib_fwd is not None:
                print(f"K2 {name} {tag}: device {k2_ms:.4f} ms = "
                      f"{k2_ms / lib_fwd:.3f} x the library's forward "
                      f"(device {lib_fwd:.4f} ms)")
            del out, lse
            delta = fo._delta(ref, do)
            # K3
            dq = fo.flash_attention_dq(q, k, v, bias, do, ref_lse, delta,
                                       causal, scale, p, seed)
            dq_ref = fo._dq_reference(q, k, v, bias, do, ref_lse, delta,
                                      causal, scale, p, seed)
            torch.cuda.synchronize()
            assert torch.isfinite(dq.float()).all(), "K3 non-finite"
            rows["dq"].append(self._row(
                "K3 flash_dq", name, (dq.float() - dq_ref.float()).abs()
                .max().item(), dq_ref.float().abs().max().item(), tol,
                _time_ms(torch, lambda: fo.flash_attention_dq(
                    q, k, v, bias, do, ref_lse, delta, causal, scale, p,
                    seed), 10),
                _time_ms(torch, lambda: fo._dq_reference(
                    q, k, v, bias, do, ref_lse, delta, causal, scale, p,
                    seed), 3),
                3 * 2 * B * H * pairs * D,
                3 * q_b + 2 * k_b + 2 * row_b + bias_b, lib_bwd, **tag))
            del dq, dq_ref
            # K4
            dk, dv = fo.flash_attention_dkv(q, k, v, bias, do, ref_lse,
                                            delta, causal, scale, p, seed)
            dk_ref, dv_ref = fo._dkv_reference(q, k, v, bias, do, ref_lse,
                                               delta, causal, scale, p, seed)
            torch.cuda.synchronize()
            assert torch.isfinite(dk.float()).all() and \
                torch.isfinite(dv.float()).all(), "K4 non-finite"
            rows["dkv"].append(self._row(
                "K4 flash_dkv", name, max(
                    (dk.float() - dk_ref.float()).abs().max().item(),
                    (dv.float() - dv_ref.float()).abs().max().item()),
                max(dk_ref.float().abs().max().item(),
                    dv_ref.float().abs().max().item()), tol,
                _time_ms(torch, lambda: fo.flash_attention_dkv(
                    q, k, v, bias, do, ref_lse, delta, causal, scale, p,
                    seed), 10),
                _time_ms(torch, lambda: fo._dkv_reference(
                    q, k, v, bias, do, ref_lse, delta, causal, scale, p,
                    seed), 3),
                4 * 2 * B * H * pairs * D,
                2 * q_b + 4 * k_b + 2 * row_b + bias_b, lib_bwd, **tag))
            pair_ms = rows["dq"][-1]["ms"] + rows["dkv"][-1]["ms"]
            if lib_bwd is not None:
                print(f"K3 + K4 {name} {tag}: {pair_ms:.4f} ms = "
                      f"{pair_ms / lib_bwd:.3f} x the library's whole "
                      f"backward ({lib_bwd:.4f} ms)")
            del dk, dv, dk_ref, dv_ref, ref, ref_lse, delta
            torch.cuda.empty_cache()
        self.details["train_kernels"] = rows

        def pick(rs, dtype):   # the train phase's case: causal, p 0.1
            return next(r for r in rs if r["dtype"] == dtype
                        and r["causal"] and r["p"] == DROPOUT
                        and not r["padded"]
                        and r["shape"] == f"{B}x{H0}x{S0}x{S0}x{D0}")
        for dt in ("float32", "bfloat16", "float16"):
            sfx = "" if dt == "float32" else f".{dt}"
            self.kernel_rows["flash_fwd" + sfx] = pick(rows["fwd"], dt)
            self.kernel_rows["flash_bwd_dq" + sfx] = pick(rows["dq"], dt)
            self.kernel_rows["flash_bwd_dkv" + sfx] = pick(rows["dkv"], dt)

    def check_autograd(self):
        """FlashAttention's gradients on the card (K2 forward, K3 + K4
        backward) against autograd through the plain forward with the
        same keep mask; then the C4 check: through
        F.scaled_dot_product_attention with p = 0, gradients reach q, k
        and v through K2 and match autograd through `_sdpa_ref`. fp32,
        [2, 12, 1024, 64], causal; atol 1e-4 x max(1, max |grad|)."""
        torch = self.torch
        from paddle_tpu_torch.nn.functional import attention as attn
        from paddle_tpu_torch.ops import flash_ops as fo
        B, H, S, D = 2, 12, 1024, 64
        g = torch.Generator(device="cuda").manual_seed(7)
        q, k, v, do = (torch.randn(B, H, S, D, generator=g, device="cuda")
                       for _ in range(4))
        scale = 1.0 / D ** 0.5

        def grads(fn):
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(fn(*ins), ins, do)

        def compare(what, got, want):
            for n, a, b in zip("qkv", got, want):
                err = (a - b).abs().max().item()
                mx = b.abs().max().item()
                print(f"{what}: d{n} max_abs_err {err:.3e} (max |grad| "
                      f"{mx:.3e}, tol 1e-4 x max(1, max |grad|))")
                assert err <= 1e-4 * max(1.0, mx), f"{what} d{n} disagrees"

        n3, n4 = fo.flash_attention_dq.launches, fo.flash_attention_dkv.launches
        compare("FlashAttention p=0.1 vs autograd of the plain forward",
                grads(lambda a, b, c: fo.FlashAttention.apply(
                    a, b, c, None, 99, True, scale, DROPOUT)),
                grads(lambda a, b, c: fo._flash_fwd_reference(
                    a, b, c, None, True, scale, DROPOUT, 99)[0]))
        assert fo.flash_attention_dq.launches == n3 + 1
        assert fo.flash_attention_dkv.launches == n4 + 1
        n2 = fo.flash_attention_fwd.launches
        compare("C4: F.sdpa p=0 through K2 vs autograd of _sdpa_ref",
                grads(lambda a, b, c: attn.scaled_dot_product_attention(
                    a, b, c, is_causal=True, training=True)),
                grads(lambda a, b, c: attn._sdpa_ref(
                    a, b, c, None, scale, True)))
        assert fo.flash_attention_fwd.launches == n2 + 1, \
            "F.scaled_dot_product_attention did not launch K2"

    def splash_ids(self, rows, n=None):
        """Segment ids [rows, 1024] int32 on the card: io.PackingCollator
        (first-fit) over the bench's first `n` sequences, or, by default,
        as many as fill `rows` rows to about 93 %."""
        import numpy as np
        import warnings
        from paddle_tpu_torch import io
        T = PACK["T"]
        lengths = _bench_lengths(np)
        if n is None:
            n = int(np.searchsorted(np.cumsum(lengths), 0.93 * rows * T))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # a sequence may not fit
            pack = io.PackingCollator(T, rows)(
                [np.zeros(L, np.int64) for L in lengths[:n]])
        return self.torch.from_numpy(pack[1]).cuda()

    def check_splash_kernels(self):
        """K5, K6 and K7 against their plain versions on the same inputs,
        ids and seed, as check_train_kernels holds K2-K4 (same
        tolerances, FLASH_TOL): at GPT-2 small's attention width, causal,
        fp32, bf16 and fp16, p 0 and 0.1, plus a non-causal fp32 case
        whose kv lacks one query segment (those rows must be exactly 0);
        and at the packing phase's shape, causal p 0, bf16, fp16 and fp32
        (the kernels line's rows).
        The bound counts the allowed (query, key) pairs of these ids; the
        library call is SDPA with the boolean segment-within-causal mask
        (no row of these packs is fully masked, so it computes the same
        function), its backward under autograd timed as one call."""
        torch = self.torch
        import numpy as np
        import torch.nn.functional as TF
        from paddle_tpu_torch import io
        from paddle_tpu_torch.ops import flash_ops as fo, splash_ops as so
        B, H, S, D = (SPLASH_SHAPE[k] for k in ("B", "H", "S", "D"))
        scale = 1.0 / D ** 0.5
        seed = 4321
        ids = self.splash_ids(B)
        absent = ids.clone()
        absent[0][absent[0] == 2] = 1          # kv holds no segment 2
        prow = io.suggest_rows(_bench_lengths(np), PACK["BS"], PACK["T"],
                               headroom=PACK["HEADROOM"])
        ph = PACK["HEADS"]
        cases = [("gpt2", dt, True, p, ids, ids, H, D)
                 for dt in ("float32", "bfloat16", "float16")
                 for p in (0.0, DROPOUT)]
        packs = self.splash_ids(prow, PACK["BS"])
        cases += [("gpt2", "float32", False, 0.0, ids, absent, H, D)]
        cases += [("packed_lm", dt, True, 0.0, packs, None, ph, D)
                  for dt in ("bfloat16", "float16", "float32")]
        # ROADMAP C11: the pack at head dims of padded widths, every type
        cases += [("packed_lm", dt, True, 0.0, packs, None, hh, dd)
                  for dd, hh in HEAD_DIM_CASES
                  for dt in ("float32", "bfloat16", "float16")]
        rows = {"fwd": [], "dq": [], "dkv": []}
        for shape, name, causal, p, qs, ks, Hc, Dc in cases:
            ks = qs if ks is None else ks
            Bc = B if shape == "gpt2" else qs.shape[0]
            dtype = getattr(torch, name)
            tol = FLASH_TOL[name]
            sc = 1.0 / Dc ** 0.5
            g = torch.Generator(device="cuda").manual_seed(11 + causal)
            q, k, v, do = (torch.randn(Bc, Hc, S, Dc, generator=g,
                                       device="cuda").to(dtype)
                           for _ in range(4))
            kv_lo, kv_hi, q_lo, q_hi = so._block_bounds(qs, ks, 64, 64,
                                                        causal)
            allowed = so._allowed(qs, ks, causal)
            pairs = int(allowed.sum()) * Hc        # allowed pairs, all heads
            nt = S // 64
            sweep = Bc * (nt * (nt + 1) // 2 if causal else nt * nt)
            tiles = int((kv_hi - kv_lo).sum()) / sweep
            tiles_t = int((q_hi - q_lo).sum()) / sweep
            full = Bc * Hc * (S * (S + 1) // 2 if causal else S * S)
            tag = dict(shape=f"{Bc}x{Hc}x{S}x{Dc}", causal=causal, p=p,
                       absent=ks is not qs, tiles_visited=tiles,
                       pair_share=pairs / full)
            # K5's (warp band, key tile) pairs that take the mask-free path
            # (`_uniform_tiles`), of those its spans visit
            vis, uni = so._uniform_tiles(qs, ks, causal,
                                         so._k5_key_tile(Dc, dtype))
            k5_uniform = int(uni.sum()) / int(vis.sum())
            # the 16x8 sub-tiles of K6's and K7's visited tiles that can
            # hold an allowed pair (`_subtile_mask`): what a sub-tile skip
            # could keep of their product work
            sub = {}
            for kname, tr in (("dq", False), ("dkv", True)):
                vis, live = so._subtile_mask(qs, ks, causal, tr)
                sub[kname] = dict(
                    subtiles_live=int(live.sum()) / int(vis.sum()))
            bh_sd = Bc * Hc * S * Dc * q.element_size()
            row_b = Bc * Hc * S * 4
            ids_b = 2 * Bc * S * 4 + 2 * Bc * nt * 4
            lib_fwd = lib_bwd = lib_fwd_dev = None
            if p == 0.0:
                mask = allowed.expand(Bc, 1, S, S)
                ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
                lib_fwd_dev, lib_fwd = self.time_ms(
                    lambda: TF.scaled_dot_product_attention(
                        ql, kl, vl, attn_mask=mask), 10)
                ol = TF.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
                lib_bwd = _time_ms(torch, lambda: torch.autograd.grad(
                    ol, (ql, kl, vl), do, retain_graph=True), 10)
                del ql, kl, vl, ol, mask
            fargs = (q, k, v, qs, ks, causal, sc, p, seed)
            out, lse = so.splash_attention_fwd(*fargs, bounds=(kv_lo, kv_hi))
            ref, ref_lse = so._splash_fwd_reference(*fargs)
            torch.cuda.synchronize()
            err = max((out.float() - ref.float()).abs().max().item(),
                      (lse - ref_lse).abs().max().item())
            assert torch.isfinite(out.float()).all(), "K5 non-finite"
            if tag["absent"]:
                gone = (qs[0] == 2)
                assert bool(gone.any()) and \
                    (out[0][:, gone] == 0).all(), "K5 absent rows not 0"
            # event time is the row's ms (as in earlier runs); device time
            # beside it, the wrapper's host time left out
            k5_dev, k5_ev = self.time_ms(lambda: so.splash_attention_fwd(
                *fargs, bounds=(kv_lo, kv_hi)), 10)
            rows["fwd"].append(self._row(
                "K5 splash_fwd", name, err, ref.float().abs().max().item(),
                tol, k5_ev,
                _time_ms(torch, lambda: so._splash_fwd_reference(*fargs), 3),
                4 * pairs * Dc, 4 * bh_sd + row_b + ids_b, lib_fwd,
                device_ms=k5_dev, library_device_ms=lib_fwd_dev,
                uniform_tiles=k5_uniform, **tag))
            del out, lse
            delta = fo._delta(ref, do)
            bargs = (q, k, v, qs, ks, do, ref_lse, delta, causal, sc, p,
                     seed)
            dq = so.splash_attention_dq(*bargs, bounds=(kv_lo, kv_hi))
            dq_ref = so._splash_dq_reference(*bargs)
            torch.cuda.synchronize()
            assert torch.isfinite(dq.float()).all(), "K6 non-finite"
            if tag["absent"]:
                assert (dq[0][:, qs[0] == 2] == 0).all(), \
                    "K6 absent rows not 0"
            rows["dq"].append(self._row(
                "K6 splash_dq", name, (dq.float() - dq_ref.float()).abs()
                .max().item(), dq_ref.float().abs().max().item(), tol,
                _time_ms(torch, lambda: so.splash_attention_dq(
                    *bargs, bounds=(kv_lo, kv_hi)), 10),
                _time_ms(torch, lambda: so._splash_dq_reference(*bargs), 3),
                6 * pairs * Dc, 5 * bh_sd + 2 * row_b + ids_b, lib_bwd,
                **sub["dq"], **tag))
            del dq, dq_ref
            dk, dv = so.splash_attention_dkv(*bargs, bounds=(q_lo, q_hi))
            dk_ref, dv_ref = so._splash_dkv_reference(*bargs)
            torch.cuda.synchronize()
            assert torch.isfinite(dk.float()).all() and \
                torch.isfinite(dv.float()).all(), "K7 non-finite"
            rows["dkv"].append(self._row(
                "K7 splash_dkv", name, max(
                    (dk.float() - dk_ref.float()).abs().max().item(),
                    (dv.float() - dv_ref.float()).abs().max().item()),
                max(dk_ref.float().abs().max().item(),
                    dv_ref.float().abs().max().item()), tol,
                _time_ms(torch, lambda: so.splash_attention_dkv(
                    *bargs, bounds=(q_lo, q_hi)), 10),
                _time_ms(torch, lambda: so._splash_dkv_reference(*bargs), 3),
                8 * pairs * Dc, 6 * bh_sd + 2 * row_b + ids_b, lib_bwd,
                tiles_visited_t=tiles_t, **sub["dkv"], **tag))
            if lib_bwd is not None:
                pair_ms = rows["dq"][-1]["ms"] + rows["dkv"][-1]["ms"]
                print(f"K6 + K7 {name} {tag['shape']} causal={causal}: "
                      f"{pair_ms:.4f} ms = {pair_ms / lib_bwd:.3f} x the "
                      f"library's whole backward ({lib_bwd:.4f} ms); K5 "
                      f"{rows['fwd'][-1]['ms'] / lib_fwd:.3f} x its forward "
                      f"({lib_fwd:.4f} ms), device time "
                      f"{k5_dev / lib_fwd_dev:.3f} x ({lib_fwd_dev:.4f} ms)")
            del dk, dv, dk_ref, dv_ref, ref, ref_lse, delta, allowed
            torch.cuda.empty_cache()
        self.details["splash_kernels"] = rows
        pack_shape = f"{packs.shape[0]}x{ph}x{S}x{D}"
        for key, name in (("fwd", "splash_fwd"), ("dq", "splash_bwd_dq"),
                          ("dkv", "splash_bwd_dkv")):
            # the packing phase's cases at the pack shape: fp32, bf16 (its
            # AMP epoch) and fp16 (its fp16 AMP steps)
            for dt, sfx in (("float32", ""), ("bfloat16", ".bfloat16"),
                            ("float16", ".float16")):
                self.kernel_rows[name + sfx] = next(
                    r for r in rows[key] if r["shape"] == pack_shape
                    and r["dtype"] == dt)

        # SplashAttention (K5, then K6 + K7) against autograd through the
        # plain forward with the same keep mask: fp32, [2, 12, 1024, 64],
        # causal, p 0.1, atol 1e-4 x max(1, max |grad|)
        g = torch.Generator(device="cuda").manual_seed(8)
        q, k, v, do = (torch.randn(2, H, S, D, generator=g, device="cuda")
                       for _ in range(4))
        qs = ids[:2].contiguous()

        def grads(fn):
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(fn(*ins), ins, do)
        got = grads(lambda a, b, c: so.SplashAttention.apply(
            a, b, c, qs, qs, 99, True, scale, DROPOUT))
        want = grads(lambda a, b, c: so._splash_fwd_reference(
            a, b, c, qs, qs, True, scale, DROPOUT, 99)[0])
        for n, a, b in zip("qkv", got, want):
            err = (a - b).abs().max().item()
            mx = b.abs().max().item()
            print(f"SplashAttention p=0.1 vs autograd of the plain forward: "
                  f"d{n} max_abs_err {err:.3e} (max |grad| {mx:.3e}, tol "
                  f"1e-4 x max(1, max |grad|))")
            assert err <= 1e-4 * max(1.0, mx), f"SplashAttention d{n}"

    def kernels(self):
        self.check_k1()
        self.check_k2()
        self.check_train_kernels()
        self.check_autograd()
        self.check_splash_kernels()

    # -- 4. model --------------------------------------------------------------

    def model(self):
        torch = self.torch
        from paddle_tpu_torch.framework.flags import set_flags
        from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
        from paddle_tpu_torch.ops import flash_ops
        cfg = GPTConfig()
        self.gpt = GPTForCausalLM(cfg, device="cuda", seed=0).eval()
        nparams = sum(p.numel() for p in self.gpt.parameters())
        print(f"GPT: vocab {cfg.vocab_size} hidden {cfg.hidden_size} layers "
              f"{cfg.num_layers} heads {cfg.num_heads} ffn "
              f"{cfg.intermediate_size} positions "
              f"{cfg.max_position_embeddings}: {nparams} parameters fp32")
        g = torch.Generator(device="cuda").manual_seed(0)
        ids = torch.randint(0, cfg.vocab_size, (2, 1024), generator=g,
                            device="cuda")
        with torch.inference_mode():
            flash_ops.flash_attention_fwd.launches = 0
            t0 = time.perf_counter()
            lf = self.gpt(ids)
            torch.cuda.synchronize()
            t_flash = time.perf_counter() - t0
            launches = flash_ops.flash_attention_fwd.launches
            set_flags({"FLAGS_use_flash_attention": False})
            try:
                t0 = time.perf_counter()
                lp = self.gpt(ids)
                torch.cuda.synchronize()
                t_plain = time.perf_counter() - t0
            finally:
                set_flags({"FLAGS_use_flash_attention": True})
        err = (lf - lp).abs().max().item()
        tol = 1e-3
        print(f"model [2,1024] forward: logits max_abs_err flash vs plain "
              f"{err:.3e} (tol {tol}), logit std {lp.std().item():.3f}, "
              f"flash launches {launches}, wall {t_flash * 1e3:.1f} ms "
              f"flash / {t_plain * 1e3:.1f} ms plain (first calls)")
        assert tuple(lf.shape) == (2, 1024, cfg.vocab_size)
        assert torch.isfinite(lf).all(), "non-finite logits"
        assert launches == cfg.num_layers, \
            f"flash kernel launched {launches} times, expected " \
            f"{cfg.num_layers}"
        assert err <= tol, "flash forward disagrees with the plain path"
        self.details["model"] = dict(err=err, launches=launches)

    # -- 5. serving ------------------------------------------------------------

    def serving(self):
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.ops import flash_ops, paged_ops
        from paddle_tpu_torch.serving import GenerationEngine
        if not hasattr(self, "gpt"):
            from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
            self.gpt = GPTForCausalLM(GPTConfig(), device="cuda",
                                      seed=0).eval()
        cfg = self.gpt.gpt.config
        prompts, new = self.serving_requests(cfg.vocab_size)
        lens = [len(p) for p in prompts]
        n_req = len(prompts)
        page, slots = 16, 8
        num_pages = 1 + sum(-(-(s + m) // page)
                            for s, m in zip(lens, new))
        t0 = time.perf_counter()
        eng = GenerationEngine(
            self.gpt, device="cuda", name="chip_smoke", max_slots=slots,
            page_size=page, num_pages=num_pages,
            prefill_buckets=(16, 64, 256, 1024), max_new_tokens=64,
            request_timeout_ms=0, metrics_port=0)
        before = self.scrape(eng)
        print(f"engine: {slots} slots, page {page}, {num_pages} pages "
              f"({eng.stats()['pages']['hbm_bytes'] / 1e9:.2f} GB pools), "
              f"built + warmed in {time.perf_counter() - t0:.1f} s")
        # the main path starts here: every launch count from 0
        self.zero_launches()
        arrivals = [[] for _ in range(n_req)]
        submit_t = [0.0] * n_req
        results = [None] * n_req
        consumers = []

        def consume(i, stream):
            for _ in stream:
                arrivals[i].append(time.perf_counter())
            results[i] = stream.result()

        def submit(i):
            submit_t[i] = time.perf_counter()
            st = eng.submit_stream(prompts[i], max_new_tokens=new[i])
            th = threading.Thread(target=consume, args=(i, st), daemon=True)
            th.start()
            consumers.append(th)

        t_start = time.perf_counter()
        for i in range(slots):
            submit(i)
        joined_at = None
        for i in range(slots, n_req):
            # later requests join while the first batch decodes
            while eng.stats()["steps"] < 4 * (i - slots + 1):
                time.sleep(0.001)
            if joined_at is None:
                joined_at = eng.stats()["steps"]
            submit(i)
        for th in consumers:
            th.join(600)
        t_end = time.perf_counter()
        stats = eng.stats()
        self.check_observability("serving", eng, before, n_req)
        eng.shutdown(drain=True, timeout_s=60)
        k1 = paged_ops.paged_attention.launches
        k2 = flash_ops.flash_attention_fwd.launches
        gen_tokens = sum(len(a) for a in arrivals)
        ttfts = [(a[0] - s) * 1e3 for a, s in zip(arrivals, submit_t)]
        ttft = sorted(ttfts)
        first, joined = sorted(ttfts[:slots]), sorted(ttfts[slots:])
        tpot = sorted((a[-1] - a[0]) * 1e3 / (len(a) - 1)
                      for a in arrivals if len(a) > 1)
        wall = t_end - t_start
        print(f"serving on {self.smi}: {n_req} requests, {gen_tokens} "
              f"generated tokens in {wall:.3f} s = "
              f"{gen_tokens / wall:.1f} tokens/s; TTFT p50 "
              f"{ttft[len(ttft) // 2]:.2f} ms max {ttft[-1]:.2f} ms; TPOT "
              f"p50 {tpot[len(tpot) // 2]:.3f} ms max {tpot[-1]:.3f} ms; "
              f"{stats['steps']} decode steps, {stats['prefills']} "
              f"prefills, first join at step {joined_at}; compiles "
              f"{stats['compiles']}")
        print(f"TTFT p50 of the first {slots} requests "
              f"{first[len(first) // 2]:.2f} ms (their prefills run back to "
              f"back), of the {len(joined)} that queued for a slot "
              f"{joined[len(joined) // 2]:.2f} ms")
        print(f"launches on the serving path: paged_attention {k1}, "
              f"flash_fwd {k2}")
        self.details["serving"] = dict(
            tokens=gen_tokens, wall_s=wall, tokens_per_s=gen_tokens / wall,
            ttft_ms=ttft, ttft_first_wave_ms=first, ttft_queued_ms=joined,
            tpot_ms=tpot, steps=stats["steps"],
            compiles=stats["compiles"])
        self.record_path("serving")
        # checks: outputs, identity to generate(), launch counts, pages
        # kept for phase 5c, whose int8-KV arm serves the same requests
        self.serving_refs = self.assert_identical("serving", prompts, new,
                                                  results)
        assert k1 == stats["steps"] * cfg.num_layers, \
            f"paged_attention launches {k1} != steps {stats['steps']} x " \
            f"{cfg.num_layers} layers"
        assert k2 > 0, "flash kernel never launched on the serving path"
        assert eng.stats()["pages"]["pages_in_use"] == 0, "pages leaked"
        assert joined_at is not None and joined_at > 0
        self.serving_d96()

    @staticmethod
    def serving_requests(vocab, seed=0):
        """Phase 5's 16 greedy requests (seeded): prompts of 16-900
        tokens and 32-64 new tokens each; another `seed` gives other
        tokens at the same lengths."""
        import numpy as np
        rng = np.random.RandomState(seed)
        lens = [16, 900, 40, 700, 130, 300, 17, 520, 64, 800, 250, 33,
                610, 90, 400, 880]
        prompts = [rng.randint(0, vocab, size=(n,)) for n in lens]
        new = [int(x) for x in rng.randint(32, 65, size=len(lens))]
        return prompts, new

    def generate_refs(self, prompts, new, gpt=None):
        """The port's generate() of each prompt (one call a prompt) on
        `gpt` (phase 5's model by default), host arrays."""
        gpt = self.gpt if gpt is None else gpt
        return [gpt.generate(p[None], max_new_tokens=n)[0]
                .cpu().numpy() for p, n in zip(prompts, new)]

    def first_flips(self, prompts, new, outs, refs, gpt=None):
        """For each output that differs from its reference: (request,
        first differing step, top-2 logit gap of `gpt`'s full forward on
        the reference's context there)."""
        torch = self.torch
        import numpy as np
        gpt = self.gpt if gpt is None else gpt
        flips = []
        for i, (p, out, ref) in enumerate(zip(prompts, outs, refs)):
            if np.array_equal(out, ref):
                continue
            S = len(p)
            step = int(np.nonzero(out != ref)[0][0]) - S
            with torch.inference_mode():
                ctx = torch.as_tensor(ref[:S + step][None], device="cuda")
                top2 = torch.topk(gpt(ctx)[0, -1].float(), 2).values
            flips.append((i, step, (top2[0] - top2[1]).item()))
        return flips

    def assert_identical(self, label, prompts, new, outs, refs=None,
                         gpt=None):
        """Every output token-identical to generate() (of `gpt`, phase
        5's model by default); for each one that differs, print the first
        differing step and the top-2 logit margin of the full forward
        there (`first_flips`). Returns the references."""
        gpt = self.gpt if gpt is None else gpt
        refs = self.generate_refs(prompts, new, gpt) if refs is None \
            else refs
        for i, (p, out) in enumerate(zip(prompts, outs)):
            assert out is not None, f"{label}: request {i} produced no result"
            assert out.shape == (len(p) + new[i],), \
                f"{label}: request {i} shape {out.shape}"
        flips = self.first_flips(prompts, new, outs, refs, gpt)
        for i, step, gap in flips:
            S = len(prompts[i])
            print(f"{label}: request {i} (prompt {S}): first differing "
                  f"step {step}, engine token {outs[i][S + step]} vs "
                  f"generate {refs[i][S + step]}, top-2 logit margin "
                  f"{gap:.3e}")
        assert not flips, \
            f"{label}: {len(flips)} requests differ from generate()"
        return refs

    def serving_d96(self):
        """ROADMAP C7 on the card: a GPT with head dim 96 (hidden 768, 8
        heads, 2 layers; GPT-2 small's vocab, FFN and positions; fp32,
        seed 0) served by GenerationEngine: 4 greedy requests, 8 new
        tokens each, token-identical to the port's generate(), its decode
        attention through K1 (launches counted on this path, one a layer
        a step). The 300-token prompt prefills in bucket 512, at
        FLAGS_flash_attention_min_seq, through K2 at head dim 96 (ROADMAP
        C11: K2 runs at the padded width 128 there); its launches are
        counted on this path."""
        import numpy as np
        from paddle_tpu_torch.framework.flags import flag
        from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
        from paddle_tpu_torch.serving import GenerationEngine
        cfg = GPTConfig(hidden_size=768, num_heads=8, num_layers=2)
        gpt = GPTForCausalLM(cfg, device="cuda", seed=0).eval()
        rng = np.random.RandomState(1)
        lens, new = [24, 130, 300, 61], 8
        prompts = [rng.randint(0, cfg.vocab_size, size=(n,)) for n in lens]
        eng = GenerationEngine(
            gpt, device="cuda", name="chip_smoke_d96", max_slots=4,
            page_size=16, num_pages=1 + sum(-(-(n + new) // 16)
                                            for n in lens),
            prefill_buckets=(64, 256, 512), max_new_tokens=new,
            request_timeout_ms=0)
        # this path starts here: every launch count from 0
        self.zero_launches()
        t0 = time.perf_counter()
        futs = [eng.submit(p, max_new_tokens=new) for p in prompts]
        outs = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        stats = eng.stats()
        eng.shutdown(drain=True, timeout_s=60)
        launches = self.record_path("serving_d96")
        k1 = launches["paged_attention"]
        k2 = launches["flash_fwd"]
        same = [np.array_equal(o, gpt.generate(p[None], max_new_tokens=new)
                               [0].cpu().numpy())
                for o, p in zip(outs, prompts)]
        print(f"serving head dim 96 (hidden 768, 8 heads, 2 layers): "
              f"{len(prompts)} requests, {len(prompts) * new} tokens in "
              f"{wall:.3f} s, {stats['steps']} decode steps; identical to "
              f"generate(): {sum(same)} of {len(same)}; K1 launches {k1}, "
              f"K2 launches {k2} (head dim 96, bucket 512 >= min-seq "
              f"{flag('FLAGS_flash_attention_min_seq')})")
        self.details["serving_d96"] = dict(steps=stats["steps"], k1=k1,
                                           k2=k2, identical=sum(same),
                                           wall_s=wall)
        assert all(same), "the D 96 engine differs from generate()"
        assert k1 > 0 and k1 == stats["steps"] * cfg.num_layers, \
            f"K1 launched {k1} times in {stats['steps']} steps"
        assert k2 == cfg.num_layers, \
            f"K2 launched {k2} times for one bucket-512 prefill of " \
            f"{cfg.num_layers} layers"
        del eng, gpt
        self.torch.cuda.empty_cache()

    # -- 5b. prefix cache, speculative decoding, chunked prefill ----------------

    def feature_engine(self, name, num_pages, gpt=None, **kw):
        """GenerationEngine over GPT-2 small (phase 5's model unless
        `gpt` is given) at phase 5's settings (8 slots, page 16, buckets
        16/64/256/1024), built and warmed."""
        from paddle_tpu_torch.serving import GenerationEngine
        return GenerationEngine(
            self.gpt if gpt is None else gpt, device="cuda", name=name,
            max_slots=FEAT["slots"],
            page_size=FEAT["page"], num_pages=num_pages,
            prefill_buckets=FEAT["buckets"], max_new_tokens=64,
            request_timeout_ms=0, **kw)

    def stream_run(self, eng, prompts, new, first=None, join_steps=0):
        """Submit prompts as streams: all at once while holding the
        engine's lock (admitted in one pass), or `first` of them, then
        the rest once the engine has taken `join_steps` steps. Returns
        (results, per-request token arrival times, submit times, wall
        seconds)."""
        n = len(prompts)
        arrivals = [[] for _ in range(n)]
        submit_t = [0.0] * n
        results = [None] * n
        threads = []

        def consume(i, stream):
            for _ in stream:
                arrivals[i].append(time.perf_counter())
            results[i] = stream.result()

        def submit(i):
            submit_t[i] = time.perf_counter()
            st = eng.submit_stream(prompts[i], max_new_tokens=new[i])
            th = threading.Thread(target=consume, args=(i, st), daemon=True)
            th.start()
            threads.append(th)

        t0 = time.perf_counter()
        if first is None:
            with eng._cv:
                for i in range(n):
                    submit(i)
        else:
            for i in range(first):
                submit(i)
            while eng.stats()["steps"] < join_steps:
                time.sleep(0.0005)
            for i in range(first, n):
                submit(i)
        for th in threads:
            th.join(600)
        return results, arrivals, submit_t, time.perf_counter() - t0

    def features(self):
        """Phase 5b: the JAX engine's three scheduling features on the
        port's engine, GPT-2 small (fp32, seed 0), each arm against the
        port's generate() and the same engine with the feature off."""
        if not hasattr(self, "gpt"):
            from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
            self.gpt = GPTForCausalLM(GPTConfig(), device="cuda",
                                      seed=0).eval()
        self.feature_prefix()
        self.feature_spec()
        self.feature_chunk()

    def feature_prefix(self):
        """Prefix arm: 8 greedy requests share one 192-token system
        prompt (12 pages) plus a distinct 16-token tail, 32 new tokens
        each; request 0 first, requests 1-7 and a repeat of request 0's
        whole prompt (a full-prompt match: one CoW split) once it
        decodes. Cache on and cache off at equal num_pages: outputs
        identical to each other and to generate(); with the cache on,
        prefix tokens > 0, prefill_tail[b=..] and cow_copy in the ledger,
        K1 launched once a layer a decode step, and no page held after
        the drain but the cached chains (evicting them all empties the
        pool). TTFT p50 of both arms."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.framework import monitor
        cfg = self.gpt.gpt.config
        L, P = cfg.num_layers, FEAT["page"]
        rng = np.random.RandomState(10)
        system = rng.randint(0, cfg.vocab_size, size=(192,))
        prompts = [np.concatenate([system, rng.randint(
            0, cfg.vocab_size, size=(16,))]) for _ in range(8)]
        prompts.append(prompts[0].copy())           # the full-prompt repeat
        new = [32] * len(prompts)
        num_pages = 1 + sum(-(-(len(p) + n) // P)
                            for p, n in zip(prompts, new))
        refs = self.generate_refs(prompts, new)
        out = {}
        for arm, on in (("prefix_on", True), ("prefix_off", False)):
            eng = self.feature_engine(f"chip_smoke_{arm}", num_pages,
                                      prefix_cache=on)
            cow0 = monitor.stat_get("STAT_cow_splits")
            torch.cuda.synchronize()
            # this path starts here: every launch count from 0
            self.zero_launches()
            res, arr, sub, wall = self.stream_run(eng, prompts, new, first=1,
                                                  join_steps=1)
            launches = self.record_path(arm)
            stats = eng.stats()
            eng.shutdown(drain=True, timeout_s=60)
            ttft = sorted((a[0] - s) * 1e3 for a, s in zip(arr, sub))
            toks = sum(len(a) for a in arr)
            out[arm] = dict(ttft_ms=ttft, ttft_p50_ms=ttft[len(ttft) // 2],
                            wall_s=wall, tokens_per_s=toks / wall,
                            steps=stats["steps"], compiles=stats["compiles"],
                            prefix=stats["kv"]["prefix"],
                            cow_splits=monitor.stat_get("STAT_cow_splits")
                            - cow0, launches=launches)
            print(f"prefix arm {arm} on {self.smi}: {len(prompts)} requests "
                  f"(192-token system prompt + 16), {toks} tokens in "
                  f"{wall:.3f} s = {toks / wall:.1f} tokens/s; TTFT p50 "
                  f"{out[arm]['ttft_p50_ms']:.2f} ms max {ttft[-1]:.2f} ms; "
                  f"{stats['steps']} steps; K1 launches "
                  f"{launches['paged_attention']}; prefix "
                  f"{stats['kv']['prefix']}; CoW splits "
                  f"{out[arm]['cow_splits']}; compiles {stats['compiles']}")
            self.assert_identical(arm, prompts, new, res, refs)
            assert launches["paged_attention"] == stats["steps"] * L, \
                f"{arm}: K1 launched {launches['paged_attention']} times " \
                f"in {stats['steps']} steps"
            cache = eng._cache
            assert cache.owners() == {}, f"{arm}: pages still owned"
            if on:
                p = stats["kv"]["prefix"]
                assert p["hit_tokens"] > 0 and p["hits"] >= 8, p
                assert out[arm]["cow_splits"] >= 1, "no CoW split"
                assert "cow_copy" in stats["compiles"]
                assert any(k.startswith("prefill_tail[b=")
                           for k in stats["compiles"]), stats["compiles"]
                refs_held = cache.refcounts()
                assert set(refs_held) == set(cache.cached_pages())
                assert set(refs_held.values()) <= {1}
                freed = eng._prefix.evict(cache.usable_pages)
                assert sorted(freed) == sorted(refs_held), "chain leaked"
            assert cache.pages_in_use == 0, f"{arm}: pages leaked"
            del eng
            torch.cuda.empty_cache()
        print(f"prefix arm on {self.smi}: TTFT p50 cache on "
              f"{out['prefix_on']['ttft_p50_ms']:.2f} ms, cache off "
              f"{out['prefix_off']['ttft_p50_ms']:.2f} ms "
              f"({out['prefix_off']['ttft_p50_ms'] / out['prefix_on']['ttft_p50_ms']:.2f}x)")
        self.details["feature_prefix"] = out

    def feature_spec(self):
        """Spec arm: spec_k=4, spec_ngram=3, 8 prompts each a 16-token
        motif repeated to 256 tokens, 64 new tokens, submitted together:
        the engine's NGramProposer (acceptance rate recorded, not
        gated), speculation off (the tokens/s it is held against), an
        oracle proposer drafting generate()'s own continuation
        (acceptance rate 1.0, accepted > 0, steps <= ceil(64 / 5) + 1),
        and a reject proposer (every draft wrong; then a later request
        reuses the freed pages). Every output identical to generate(),
        verify[k=4] in the ledger, K1 never launched."""
        torch = self.torch
        import numpy as np
        cfg = self.gpt.gpt.config
        K, P = FEAT["spec_k"], FEAT["page"]
        rng = np.random.RandomState(11)
        prompts = [np.resize(rng.randint(0, cfg.vocab_size, size=(16,)), 256)
                   for _ in range(8)]
        new = [64] * len(prompts)
        refs = self.generate_refs(prompts, new)
        later, later_new = prompts[0], 96
        later_ref = self.generate_refs([later], [later_new])
        num_pages = 1 + len(prompts) * -(-(256 + later_new) // P)

        class Oracle:
            def propose(self, tokens, k):
                toks = np.asarray(tokens, np.int32)
                for full in refs:
                    if np.array_equal(full[:toks.size], toks):
                        return full[toks.size:toks.size + k].astype(np.int32)
                return np.zeros((0,), np.int32)

        class Reject:
            def propose(self, tokens, k):
                t = np.asarray(tokens, np.int32)
                return ((np.repeat(t[-1:], k) + 7)
                        % cfg.vocab_size).astype(np.int32)

        out = {}
        for arm, k, proposer in (("spec_ngram", K, None),
                                 ("spec_off", 0, None),
                                 ("spec_oracle", K, Oracle()),
                                 ("spec_reject", K, Reject())):
            eng = self.feature_engine(f"chip_smoke_{arm}", num_pages,
                                      spec_k=k, spec_ngram=3)
            if proposer is not None:
                eng._proposer = proposer
            torch.cuda.synchronize()
            # this path starts here: every launch count from 0
            self.zero_launches()
            res, arr, _, wall = self.stream_run(eng, prompts, new)
            if arm == "spec_reject":
                # a later owner of the rejection-heavy run's freed pages
                res.append(eng.generate(later, max_new_tokens=later_new))
            launches = self.record_path(arm)
            stats = eng.stats()
            eng.shutdown(drain=True, timeout_s=60)
            toks = sum(len(a) for a in arr)
            sp = stats["spec"]
            out[arm] = dict(wall_s=wall, tokens_per_s=toks / wall,
                            steps=stats["steps"], spec=sp,
                            compiles=stats["compiles"], launches=launches)
            print(f"spec arm {arm} on {self.smi}: {toks} tokens in "
                  f"{wall:.3f} s = {toks / wall:.1f} tokens/s, "
                  f"{stats['steps']} steps; spec {sp}; compiles "
                  f"{stats['compiles']}; K1 launches "
                  f"{launches['paged_attention']}")
            if arm == "spec_reject":
                self.assert_identical(arm, prompts + [later],
                                      new + [later_new], res,
                                      refs + later_ref)
            else:
                self.assert_identical(arm, prompts, new, res, refs)
            assert eng._cache.pages_in_use == 0, f"{arm}: pages leaked"
            if k:
                assert stats["compiles"].get(f"verify[k={K}]") == 1, \
                    stats["compiles"]
                assert launches["paged_attention"] == 0, \
                    f"{arm}: K1 launched under speculation"
            if arm == "spec_oracle":
                assert sp["accepted"] > 0 and sp["acceptance_rate"] == 1.0, sp
                assert stats["steps"] <= -(-new[0] // (K + 1)) + 1, \
                    f"oracle run took {stats['steps']} steps"
            if arm == "spec_reject":
                assert sp["drafted"] > 0 and sp["accepted"] == 0, sp
            del eng
            torch.cuda.empty_cache()
        print(f"spec arm on {self.smi}: tokens/s NGramProposer "
              f"{out['spec_ngram']['tokens_per_s']:.1f} (acceptance rate "
              f"{out['spec_ngram']['spec']['acceptance_rate']}) vs spec off "
              f"{out['spec_off']['tokens_per_s']:.1f} = "
              f"{out['spec_ngram']['tokens_per_s'] / out['spec_off']['tokens_per_s']:.2f}x; "
              f"oracle {out['spec_oracle']['tokens_per_s']:.1f} = "
              f"{out['spec_oracle']['tokens_per_s'] / out['spec_off']['tokens_per_s']:.2f}x")
        self.details["feature_spec"] = out

    def feature_chunk(self):
        """Chunk arm: 4 live streams (64-token prompts, 48 new tokens);
        a 900-token prompt (32 new) joins once they decode, with
        prefill_chunk=128, then with 0 (whole-prompt prefill, bucket
        1024). Identity to generate(); prefill_chunks == ceil(900/128);
        K2 launched 0 times in the chunked run and > 0 in the whole-
        prompt run; the live streams' TPOT p50 and p99 in both runs."""
        torch = self.torch
        import numpy as np
        cfg = self.gpt.gpt.config
        P, chunk = FEAT["page"], 128
        rng = np.random.RandomState(12)
        prompts = [rng.randint(0, cfg.vocab_size, size=(64,))
                   for _ in range(4)]
        prompts.append(rng.randint(0, cfg.vocab_size, size=(900,)))
        new = [48] * 4 + [32]
        num_pages = 1 + sum(-(-(len(p) + n) // P)
                            for p, n in zip(prompts, new))
        refs = self.generate_refs(prompts, new)
        out = {}
        for arm, c in (("chunk_128", chunk), ("chunk_0", 0)):
            eng = self.feature_engine(f"chip_smoke_{arm}", num_pages,
                                      prefill_chunk=c)
            torch.cuda.synchronize()
            # this path starts here: every launch count from 0
            self.zero_launches()
            res, arr, sub, wall = self.stream_run(eng, prompts, new, first=4,
                                                  join_steps=4)
            launches = self.record_path(arm)
            stats = eng.stats()
            eng.shutdown(drain=True, timeout_s=60)
            gaps = sorted((b - a) * 1e3 for a_ in arr[:4]
                          for a, b in zip(a_, a_[1:]))
            p50, p99 = gaps[len(gaps) // 2], gaps[int(0.99 * (len(gaps) - 1))]
            ttft_long = (arr[4][0] - sub[4]) * 1e3
            out[arm] = dict(tpot_p50_ms=p50, tpot_p99_ms=p99,
                            tpot_max_ms=gaps[-1], ttft_long_ms=ttft_long,
                            wall_s=wall, prefill_chunks=stats["prefill_chunks"],
                            steps=stats["steps"], compiles=stats["compiles"],
                            launches=launches)
            print(f"chunk arm {arm} on {self.smi}: live streams' TPOT p50 "
                  f"{p50:.3f} ms p99 {p99:.3f} ms max {gaps[-1]:.3f} ms; the "
                  f"900-token prompt's TTFT {ttft_long:.2f} ms; "
                  f"{stats['prefill_chunks']} chunks, {stats['steps']} steps; "
                  f"K2 launches {launches['flash_fwd']}, K1 "
                  f"{launches['paged_attention']}; compiles "
                  f"{stats['compiles']}")
            self.assert_identical(arm, prompts, new, res, refs)
            assert eng._cache.pages_in_use == 0, f"{arm}: pages leaked"
            if c:
                assert stats["prefill_chunks"] == -(-900 // chunk), stats
                assert launches["flash_fwd"] == 0, \
                    "K2 launched for a chunked prompt"
            else:
                assert stats["prefill_chunks"] == 0
                assert launches["flash_fwd"] > 0, \
                    "K2 never launched for the 900-token prefill"
            del eng
            torch.cuda.empty_cache()
        self.details["feature_chunk"] = out

    # -- 5c. quantized serving --------------------------------------------------

    def quant_serve(self, gpt, arm, num_pages, prompts, new, **kw):
        """Serve phase 5's way (8 requests, then the rest once the engine
        has taken 4 steps) on `gpt` with engine options `kw`; launches
        counted from 0 for this path. Returns (engine, results, row)."""
        torch = self.torch
        eng = self.feature_engine(f"chip_smoke_{arm}", num_pages, gpt=gpt,
                                  **kw)
        torch.cuda.synchronize()
        # this path starts here: every launch count from 0
        self.zero_launches()
        res, arr, sub, wall = self.stream_run(eng, prompts, new, first=8,
                                              join_steps=4)
        launches = self.record_path(arm)
        stats = eng.stats()
        eng.shutdown(drain=True, timeout_s=60)
        toks = sum(len(a) for a in arr)
        tpot = sorted((a[-1] - a[0]) * 1e3 / (len(a) - 1)
                      for a in arr if len(a) > 1)
        ttft = sorted((a[0] - s0) * 1e3 for a, s0 in zip(arr, sub))
        row = dict(tokens=toks, wall_s=wall, tokens_per_s=toks / wall,
                   tpot_p50_ms=tpot[len(tpot) // 2],
                   ttft_p50_ms=ttft[len(ttft) // 2], steps=stats["steps"],
                   compiles=stats["compiles"], launches=launches,
                   launches_by_dtype=self.path_dtype_launches[arm],
                   pages=stats["pages"])
        print(f"quant arm {arm} on {self.smi}: {len(prompts)} requests, "
              f"{toks} tokens in {wall:.3f} s = {toks / wall:.1f} tokens/s; "
              f"TPOT p50 {row['tpot_p50_ms']:.3f} ms; TTFT p50 "
              f"{row['ttft_p50_ms']:.2f} ms; {stats['steps']} steps; pools "
              f"{stats['pages']['dtype']} {stats['pages']['hbm_bytes']} "
              f"bytes; launches {launches}")
        return eng, res, row

    @staticmethod
    def resident_bytes(model):
        """Device bytes of a model's parameters and buffers (each tensor
        once)."""
        seen, n = set(), 0
        for t in list(model.parameters()) + list(model.buffers()):
            if t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                n += t.numel() * t.element_size()
        return n

    def quant(self):
        """Phase 5c: quantized serving of GPT-2 small (GPTConfig(), seed
        0) at phase 5's engine settings on phase 5's 16 requests ((b)
        and (e) on its first 8): (a) weight-only int8 and (b) int4
        weights over float32 pools, each
        token-identical to generate() on the same quantized model, K1 once
        a layer a decode step, K2 for every prompt in a bucket at or above
        FLAGS_flash_attention_min_seq; (c) float32 weights over int8 pools
        (two runs): first generated token exact against float32 pools,
        output bit-stable, no K1 launch, no page in use after the drain
        (token agreement, the top-2 logit gap at each first flip and
        can_admit capacity at equal pool bytes recorded); (d) int8 pools
        with the prefix cache on phase 5b's prefix-arm requests against
        the same engine with the cache off: the miss identical, every
        other output identical up to a first flip at a near-tie (top-2
        logit gap < NEAR_TIE), one CoW split, every freed page's scale
        rows 0 (agreement and TTFT p50 recorded); (e) a
        float16 GPT-2 small over float16 pools against its generate():
        first tokens exact, every output identical up to a first flip at
        a near-tie, K1 counted in float16. With --profile, the decode
        step of (a), (b) and (c) under torch.profiler, after all arms."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import quantization
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.framework.flags import flag
        from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
        from paddle_tpu_torch.serving import PagedKVCache
        cfg = GPTConfig()
        L, P = cfg.num_layers, FEAT["page"]
        prompts, new = self.serving_requests(cfg.vocab_size)
        num_pages = 1 + sum(-(-(len(p) + n) // P)
                            for p, n in zip(prompts, new))

        def flash_prefills(ps):
            # prompts whose bucket reaches FLAGS_flash_attention_min_seq
            return sum(next(b for b in FEAT["buckets"] if b >= len(p_))
                       >= flag("FLAGS_flash_attention_min_seq") for p_ in ps)
        # (b) and (e) serve the first 8 requests (prompts 16-900 tokens,
        # the 900-token one included), to keep the phase near the time of
        # phases 5 and 5b
        short = (prompts[:8], new[:8])
        out, profiled = {}, {}

        def fresh():
            return GPTForCausalLM(cfg, device="cuda", seed=0).eval()

        # (a), (b): weight-only int8 / int4 weights, float32 pools
        arm_s = {}   # wall seconds of each arm, references included
        for arm, bits, (ps, ns) in (("quant_w8", 8, (prompts, new)),
                                    ("quant_w4", 4, short)):
            t_arm = time.perf_counter()
            gpt = fresh()
            fp32_bytes = self.resident_bytes(gpt)
            quantization.quantize_weights(gpt, bits=bits)
            refs = self.generate_refs(ps, ns, gpt)
            eng, res, row = self.quant_serve(gpt, arm, num_pages, ps, ns)
            row.update(weight_bytes=self.resident_bytes(gpt),
                       fp32_weight_bytes=fp32_bytes)
            print(f"quant arm {arm}: resident weights {row['weight_bytes']} "
                  f"bytes against {fp32_bytes} in fp32 "
                  f"({fp32_bytes / row['weight_bytes']:.2f}x smaller)")
            out[arm] = row
            self.assert_identical(arm, ps, ns, res, refs, gpt)
            n = row["launches"]
            assert n["paged_attention"] == row["steps"] * L, \
                f"{arm}: K1 launched {n['paged_attention']} times in " \
                f"{row['steps']} steps"
            assert n["flash_fwd"] == flash_prefills(ps) * L, \
                f"{arm}: K2 launched {n['flash_fwd']} times for " \
                f"{flash_prefills(ps)} long prefills"
            assert eng._cache.pages_in_use == 0, f"{arm}: pages leaked"
            profiled[arm] = (gpt, {})
            del eng
            arm_s[arm] = time.perf_counter() - t_arm

        # (c): float32 weights, int8 pools, twice
        t_arm = time.perf_counter()
        gpt = self.gpt if getattr(self, "gpt", None) is not None else fresh()
        refs = getattr(self, "serving_refs", None) or \
            self.generate_refs(prompts, new, gpt)
        runs = []
        for arm in ("quant_kv8", "quant_kv8_repeat"):
            eng, res, row = self.quant_serve(gpt, arm, num_pages, prompts,
                                             new, kv_cache_dtype="int8")
            runs.append(res)
            out[arm] = row
            assert row["pages"]["dtype"] == "int8" and \
                row["pages"]["quantized"]
            assert row["launches"]["paged_attention"] == 0, \
                f"{arm}: K1 launched on int8 pools"
            assert eng._cache.pages_in_use == 0, f"{arm}: pages leaked"
            del eng
        row = out["quant_kv8"]
        for i, (a, b) in enumerate(zip(*runs)):
            assert np.array_equal(a, b), f"int8 KV request {i} not stable"
        S = [len(p_) for p_ in prompts]
        first = [int(r[s_] == f[s_]) for r, f, s_ in zip(runs[0], refs, S)]
        agree = float(np.mean([np.mean(r[s_:] == f[s_:])
                               for r, f, s_ in zip(runs[0], refs, S)]))
        flips = self.first_flips(prompts, new, runs[0], refs, gpt)
        dims = dict(num_layers=L, num_heads=cfg.num_heads,
                    head_dim=cfg.hidden_size // cfg.num_heads, page_size=P)
        budget = num_pages * PagedKVCache.page_hbm_bytes(dtype="float32",
                                                         **dims)
        cap = {}
        for dt in ("float32", "int8"):
            c = PagedKVCache(num_pages=PagedKVCache.pages_for_budget(
                budget, dtype=dt, **dims), pages_per_seq=64, dtype=dt,
                device="cuda", **dims)
            while c.can_admit(320):           # a 256-token prompt + 64
                c.alloc(cap.setdefault(dt, 0), 320)
                cap[dt] += 1
            del c
        row.update(first_token_exact=sum(first), token_agreement=agree,
                   flips=flips, capacity_at_equal_bytes=cap,
                   pool_budget_bytes=budget)
        print(f"quant arm quant_kv8 on {self.smi}: first token exact "
              f"{sum(first)} of {len(first)}; token agreement with fp32 "
              f"pools {agree:.4f}; first flips (request, step, top-2 logit "
              f"gap) {flips}; can_admit capacity at {budget} pool bytes: "
              f"fp32 {cap['float32']}, int8 {cap['int8']} requests of 320 "
              f"tokens ({cap['int8'] / cap['float32']:.2f}x)")
        assert all(first), "int8 KV changed a first generated token"
        profiled["quant_kv8"] = (gpt, dict(kv_cache_dtype="int8"))
        arm_s["quant_kv8"] = time.perf_counter() - t_arm
        t_arm = time.perf_counter()

        # (d): int8 pools with the prefix cache, phase 5b's prefix arm
        rng = np.random.RandomState(10)
        system = rng.randint(0, cfg.vocab_size, size=(192,))
        pprompts = [np.concatenate([system, rng.randint(
            0, cfg.vocab_size, size=(16,))]) for _ in range(8)]
        pprompts.append(pprompts[0].copy())     # the full-prompt repeat
        pnew = [32] * len(pprompts)
        pnum = 1 + sum(-(-(len(p_) + n_) // P)
                       for p_, n_ in zip(pprompts, pnew))
        res_on = None
        for arm, on in (("quant_kv8_prefix_on", True),
                        ("quant_kv8_prefix_off", False)):
            eng = self.feature_engine(f"chip_smoke_{arm}", pnum, gpt=gpt,
                                      kv_cache_dtype="int8",
                                      prefix_cache=on)
            cow0 = monitor.stat_get("STAT_cow_splits")
            torch.cuda.synchronize()
            self.zero_launches()
            res, arr, sub, wall = self.stream_run(eng, pprompts, pnew,
                                                  first=1, join_steps=1)
            launches = self.record_path(arm)
            stats = eng.stats()
            eng.shutdown(drain=True, timeout_s=60)
            ttft = sorted((a[0] - s0) * 1e3 for a, s0 in zip(arr, sub))
            cows = monitor.stat_get("STAT_cow_splits") - cow0
            out[arm] = dict(ttft_p50_ms=ttft[len(ttft) // 2], wall_s=wall,
                            steps=stats["steps"], cow_splits=cows,
                            prefix=stats["kv"]["prefix"],
                            compiles=stats["compiles"], launches=launches)
            print(f"quant arm {arm} on {self.smi}: TTFT p50 "
                  f"{out[arm]['ttft_p50_ms']:.2f} ms; {stats['steps']} "
                  f"steps; prefix {stats['kv']['prefix']}; CoW splits "
                  f"{cows}; K1 launches {launches['paged_attention']}")
            cache = eng._cache
            assert cache.owners() == {}, f"{arm}: pages still owned"
            assert launches["paged_attention"] == 0
            # every page the sequences freed has scale rows 0; the cached
            # chains keep theirs until their eviction zeroes them
            held = set(cache.cached_pages())
            freed = [pg for pg in range(1, cache.num_pages)
                     if pg not in held]
            for sc in (cache.k_scales, cache.v_scales):
                assert bool((sc[:, :, freed] == 0).all()), \
                    f"{arm}: a freed page kept its scale row"
            if on:
                res_on = res
                assert cows == 1, f"{arm}: {cows} CoW splits"
                assert stats["kv"]["prefix"]["hits"] >= 8
                assert held and bool((cache.k_scales[:, :, sorted(held)]
                                      > 0).any())
                # the engine's own eviction path: evict, then zero
                eng._zero_pages(eng._prefix.evict(cache.usable_pages))
            else:
                # a hit's tail attends its prefix dequantized from the int8
                # pages where the cache-off prefill computes it fresh, as
                # in the JAX engine: a near-tie may flip there, and the two
                # sequences part from that token on. The miss (request 0)
                # is exact, and every output equals the cache-off one up
                # to a first flip at a near-tie (agreement recorded)
                flips_d = self.first_flips(pprompts, pnew, res_on, res, gpt)
                S = len(pprompts[0])
                agree_d = float(np.mean([np.mean(a[S:] == b[S:])
                                         for a, b in zip(res_on, res)]))
                out[arm].update(flips_against_cache_on=flips_d,
                                agreement_with_cache_on=agree_d)
                print(f"quant arm int8 prefix cache on vs off on "
                      f"{self.smi}: token agreement {agree_d:.4f}; first "
                      f"flips (request, step, top-2 logit gap) {flips_d}")
                assert np.array_equal(res_on[0], res[0]), \
                    "the int8 prefix-cache miss differs from the cache off"
                assert all(gap < NEAR_TIE for _, _, gap in flips_d), \
                    f"a flip at a gap of {NEAR_TIE} or more: {flips_d}"
            assert cache.pages_in_use == 0, f"{arm}: pages leaked"
            for sc in (cache.k_scales, cache.v_scales):
                assert bool((sc[:, :, 1:] == 0).all()), \
                    f"{arm}: an evicted page kept its scale row"
            del eng

        arm_s["quant_kv8_prefix"] = time.perf_counter() - t_arm
        # (e): float16 GPT-2 small, float16 pools (ROADMAP C10)
        t_arm = time.perf_counter()
        gpt16 = fresh().half()
        ps, ns = short
        refs16 = self.generate_refs(ps, ns, gpt16)
        eng, res, row = self.quant_serve(gpt16, "fp16", num_pages, ps, ns)
        out["fp16"] = row
        by = row["launches_by_dtype"]["paged_attention"]
        assert row["pages"]["dtype"] == "float16"
        # K1 sums in fp32 where generate()'s dense attention rounds P to
        # fp16, and fp16 logits resolve 2^-9 near GPT-2 small's top
        # logits: a tie at one fp16 step may flip. The first token
        # (prefill, the same program) is exact, and every output equals
        # generate()'s up to a first flip at a near-tie
        flips16 = self.first_flips(ps, ns, res, refs16, gpt16)
        same16 = len(ps) - len(flips16)
        first16 = sum(int(r[len(p_)] == f[len(p_)])
                      for r, f, p_ in zip(res, refs16, ps))
        row.update(identical=same16, first_token_exact=first16,
                   flips=flips16)
        print(f"quant arm fp16 on {self.smi}: identical to generate() "
              f"{same16} of {len(ps)}; first token exact {first16}; "
              f"first flips (request, step, top-2 logit gap) {flips16}")
        assert first16 == len(ps), "fp16: a first token differs"
        assert all(gap < NEAR_TIE for _, _, gap in flips16), \
            f"fp16: a flip at a gap of {NEAR_TIE} or more: {flips16}"
        assert by.get("float16", 0) == row["launches"]["paged_attention"] \
            == row["steps"] * L, f"fp16: K1 launches {by} in " \
            f"{row['steps']} steps"
        assert row["launches_by_dtype"]["flash_fwd"].get("float16", 0) == \
            flash_prefills(ps) * L
        del eng, gpt16
        arm_s["fp16"] = time.perf_counter() - t_arm
        print(f"phase 5c arms' wall seconds: "
              f"{ {k: round(v, 1) for k, v in arm_s.items()} }")
        out["arm_s"] = arm_s

        if self.args.profile:
            for arm, (g, kw) in profiled.items():
                out[arm]["decode_profile"] = self.profile_decode(
                    g, f"profile_{arm}", **kw)
        self.details["quant"] = out
        del profiled
        torch.cuda.empty_cache()

    # -- observability: exporter scrapes and the step ring ----------------------

    def scrape(self, eng):
        """{metric: value} of the engine's `/metrics` page over 127.0.0.1
        (histograms by their _count and _sum lines)."""
        import urllib.request
        url = eng.metrics_server.url
        assert url.startswith("http://127.0.0.1:"), url
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            text = r.read().decode()
        vals = {}
        for line in text.splitlines():
            if line and not line.startswith("#") and "_bucket{" not in line:
                k, v = line.rsplit(" ", 1)
                vals[k] = float(v)
        return vals

    def check_observability(self, label, eng, before, n_req):
        """The observability gates on a drained engine still running:
        the step ring (read from `/steps`) sums to stats() (tokens) and
        to the requests (admitted, completed), every record's six attr_*
        buckets sum exactly to its attr_wall_ms; `/metrics` shows
        STAT_kv_cache_hbm_bytes equal to the sum of every live cache's
        hbm_bytes(), STAT_device0_hbm_bytes_in_use > 0 and one
        ttft_ms / tpot_ms count per request since `before`; `/healthz`
        is 200. Returns the ring's records."""
        import gc
        import urllib.request
        from paddle_tpu_torch.serving import PagedKVCache
        url = eng.metrics_server.url
        st = eng.stats()
        with urllib.request.urlopen(url + "/steps", timeout=30) as r:
            steps = json.loads(r.read().decode())
        ring = steps["engines"][eng.name]
        recs = ring["records"]
        assert ring["recorded_total"] == len(recs), \
            f"{label}: the step ring overflowed ({ring['recorded_total']})"
        sums = {k: sum(r[k] for r in recs)
                for k in ("tokens", "admitted", "completed")}
        assert sums["tokens"] == st["tokens"], (label, sums, st["tokens"])
        assert sums["admitted"] == sums["completed"] == n_req, (label, sums)
        parts = ("attr_admit_ms", "prefill_ms", "attr_promote_ms",
                 "decode_ms", "attr_bookkeep_ms", "attr_idle_ms")
        off = [r for r in recs if r["attr_wall_ms"] > 0
               and abs(sum(r[p] for p in parts) - r["attr_wall_ms"]) > 1e-9]
        assert not off, f"{label}: attribution off in {len(off)} records"
        gc.collect()
        live = sum(o.hbm_bytes() for o in gc.get_objects()
                   if isinstance(o, PagedKVCache))
        after = self.scrape(eng)
        gauge = after["paddle_tpu_stat_kv_cache_hbm_bytes"]
        dev = after.get("paddle_tpu_stat_device0_hbm_bytes_in_use", 0)
        counts = {h: after[f"paddle_tpu_{h}_count"]
                  - before.get(f"paddle_tpu_{h}_count", 0)
                  for h in ("ttft_ms", "tpot_ms")}
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = r.status
        attr = {p: round(sum(r[p] for r in recs), 3) for p in parts}
        print(f"observability {label}: {len(recs)} step records, ring sums "
              f"{sums}, attribution ms {attr}; /metrics "
              f"STAT_kv_cache_hbm_bytes {gauge:.0f} (live caches {live}), "
              f"STAT_device0_hbm_bytes_in_use {dev:.0f}, ttft/tpot counts "
              f"{counts}; /healthz {health}")
        assert gauge == live, f"{label}: gauge {gauge} != live {live}"
        assert dev > 0, f"{label}: no device memory gauge"
        assert counts == {"ttft_ms": n_req, "tpot_ms": n_req}, counts
        assert health == 200
        self.details.setdefault("observability", {})[label] = dict(
            records=len(recs), sums=sums, attr_ms=attr, kv_gauge=gauge,
            device0_in_use=dev)
        return recs

    # -- 5d. the host KV tier and the engine's observability --------------------

    def tier_traffic(self, vocab):
        """Phase 5d's requests: four distinct 592-token system prompts
        (37 pages of 16) A-D, each with a 16-48-token user tail; wave 2
        the same system prompts with new tails. 32 new tokens each."""
        import numpy as np
        rng = np.random.RandomState(20)
        systems = [rng.randint(0, vocab, size=(592,)) for _ in range(4)]
        waves = [[np.concatenate([s, rng.randint(
            0, vocab, size=(int(rng.randint(16, 49)),))]) for s in systems]
            for _ in range(2)]
        return waves[0] + waves[1], [32] * 8

    def tier_serve(self, arm, prompts, new, num_pages, **kw):
        """Serve `prompts` one at a time (each drained before the next)
        on a GPT-2-small engine at phase 5's settings with the prefix
        cache on and `kw`; launches counted from 0 for this path. Per
        request: TTFT on the client clock. The promotion's device time
        (CUDA events on the engine's stream around `_promote_upload`),
        each demotion's slot reservation (host time), and each eviction
        pass's batched gather (`_tier_gather_flush`: host time, pages, and
        the stream time between CUDA events around it, its copies being
        queued, not waited for) are recorded. Returns (engine, outputs,
        row)."""
        torch = self.torch
        eng = self.feature_engine(f"chip_smoke_{arm}", num_pages,
                                  prefix_cache=True, metrics_port=0, **kw)
        promote, demote, reserve = [], [], []
        if eng._tier is not None:
            orig_promote, orig_gather, orig_flush = eng._promote_upload, \
                eng._prefix._gather, eng._prefix._flush

            # host ms of a promotion's parts, summed per promotion (a
            # stall shows in the part that holds it)
            parts = {}

            def timed_part(name, fn):
                def wrapper(*a, **k):
                    t0 = time.perf_counter()
                    try:
                        return fn(*a, **k)
                    finally:
                        parts[name] = parts.get(name, 0.0) + (
                            time.perf_counter() - t0) * 1e3
                return wrapper
            eng._tier_upload = timed_part("upload", eng._tier_upload)
            eng._tier_write = timed_part("write", eng._tier_write)
            eng._zero_pages = timed_part("zero", eng._zero_pages)
            eng._prefix.consume_promoted = timed_part(
                "consume", eng._prefix.consume_promoted)

            def timed_promote(req, host_digests, matched_hbm):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                parts.clear()
                s.record()
                ok = orig_promote(req, host_digests, matched_hbm)
                e.record()
                promote.append((s, e, len(host_digests), ok,
                                {k: round(v, 3) for k, v in parts.items()}))
                return ok

            def timed_gather(page):
                t0 = time.perf_counter()
                out = orig_gather(page)
                reserve.append((time.perf_counter() - t0) * 1e3)
                return out

            def timed_flush():
                n = len(eng._gather_q)
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                s.record()
                orig_flush()
                e.record()
                if n:
                    demote.append(((time.perf_counter() - t0) * 1e3, n,
                                   s, e))
            eng._promote_upload = timed_promote
            eng._prefix._gather = timed_gather
            eng._prefix._flush = timed_flush
        before = self.scrape(eng)
        torch.cuda.synchronize()
        # the interpreter's garbage collections during the run (a pause
        # of one shows as a stall of whatever the thread was doing)
        import gc
        gc_open, gc_pauses = [], []

        def on_gc(phase, info):
            if phase == "start":
                gc_open.append(time.perf_counter())
            elif gc_open:
                gc_pauses.append(((time.perf_counter() - gc_open.pop())
                                  * 1e3, info["generation"]))
        gc.callbacks.append(on_gc)
        # this path starts here: every launch count from 0
        self.zero_launches()
        outs, ttft = [], []
        t0 = time.perf_counter()
        try:
            for p, n in zip(prompts, new):
                t_sub = time.perf_counter()
                st = eng.submit_stream(p, max_new_tokens=n)
                first = None
                for _ in st:
                    if first is None:
                        first = time.perf_counter()
                outs.append(st.result())
                ttft.append((first - t_sub) * 1e3)
        finally:
            gc.callbacks.remove(on_gc)
        wall = time.perf_counter() - t0
        launches = self.record_path(arm)
        stats = eng.stats()
        torch.cuda.synchronize()
        prom = [(s.elapsed_time(e), n, ok) for s, e, n, ok, _p in promote]
        prom_parts = [p for _s, _e, _n, _ok, p in promote]
        row = dict(wall_s=wall, ttft_ms=ttft, steps=stats["steps"],
                   launches=launches, compiles=stats["compiles"],
                   prefix=stats["kv"]["prefix"], promote=prom,
                   promote_parts_ms=prom_parts,
                   demote_passes=[(h, n, s.elapsed_time(e))
                                  for h, n, s, e in demote],
                   demote_reserve_ms=reserve,
                   pages=stats["pages"], gc_pauses_ms=gc_pauses,
                   audit=[e["reason"] for e in eng._audit.tail(2048)],
                   audit_events=eng._audit.tail(2048))
        recs = self.check_observability(arm, eng, before, len(prompts))
        row["step_records"] = len(recs)
        # the iteration that admitted each request (one at a time): its
        # first token is delivered at that iteration's end
        row["admit_iters"] = [
            {k: r[k] for k in ("attr_admit_ms", "prefill_ms",
                               "attr_promote_ms", "decode_ms",
                               "attr_bookkeep_ms", "attr_idle_ms",
                               "attr_wall_ms")}
            for r in recs if r["admitted"]]
        print(f"tier arm {arm} on {self.smi}: {len(prompts)} requests in "
              f"{wall:.3f} s; TTFT ms {[round(x, 2) for x in ttft]}; "
              f"{stats['steps']} steps; launches {launches}; prefix "
              f"{stats['kv']['prefix']}")
        return eng, outs, row

    @staticmethod
    def tier_leak_free(eng):
        """After the drain no page leaks on either tier: the host tier's
        byte ledger equals its entries' bytes and the host slab's held
        slots its entries, and every allocated pool page is held once,
        by the prefix cache alone."""
        tier, cache = eng._tier, eng._cache
        refs = cache.refcounts()
        cached = set(cache.cached_pages())
        host_ok = tier is None or (
            tier.host_bytes == sum(e.nbytes for e in tier._entries.values())
            and eng._slab.held == len(tier))
        return (host_ok and cache.owners() == {} and set(refs) == cached
                and sum(refs.values()) == len(cached)
                and cache.pages_in_use == len(cached))

    def tier(self):
        """Phase 5d: GPT-2 small (fp32, seed 0) at phase 5's engine
        settings with the prefix cache (at most 80 pages: two of the
        ~40-page chains) and the host KV tier on (256 MB, chunks of 4
        pages). Wave 1 serves A-D one at a time; the budget demotes the
        least recently used chains to the host, so wave 2 (A-D with new
        tails) finds each system prompt there and promotes it. Arms:
        fp32 pools, int8 pools, `kv_tier.promote_upload@2` and
        `kv_tier.demote_gather@1`. Gates: every output token-identical
        to a tier-off engine whose prefix cache is unbounded (chains
        never evicted; fp32 also to generate()); 4 KV_PROMOTE in the
        fp32 and int8 arms and no host-budget eviction; the upload
        failpoint's arm exactly 1 KV_PROMOTE_ABANDON, that request a
        cold prefill; the gather failpoint's arm one demotion fewer than
        the fp32 arm, its first eviction plain; no page leaked on either
        tier; K1 = steps x 12 on fp32 pools (0 on int8), K2 = 12 x the
        cold prefills (every prompt is in the 1024 bucket); the
        observability gates (`check_observability`). Printed: TTFT p50 of
        wave 2 against wave 1 and the never-evicted engine's device
        hits, wave 2's admission iterations by part, promotion ms per
        page, the H2D rate and each promotion's host ms by part,
        demotion ms per chain (host) and per page (stream), the
        collections during each arm; then tokens/s and wall per step
        with the step log, audit ring and spans on against off (phase
        5's first 8 requests, on, off, off, on) and the observability
        calls' host time (`observability_host_cost`)."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.framework.flags import set_flags
        from paddle_tpu_torch.serving import failpoints
        if not hasattr(self, "gpt"):
            from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
            self.gpt = GPTForCausalLM(GPTConfig(), device="cuda",
                                      seed=0).eval()
        L, P = self.gpt.gpt.config.num_layers, FEAT["page"]
        prompts, new = self.tier_traffic(self.gpt.gpt.config.vocab_size)
        need = max(-(-(len(p) + n) // P) for p, n in zip(prompts, new))
        budget = 80
        tier_pages = 1 + budget + need + 2
        ref_pages = 1 + sum(-(-(len(p) + n) // P)
                            for p, n in zip(prompts, new))
        tier_kw = dict(prefix_cache_max_pages=budget, kv_tier=True,
                       kv_tier_host_bytes=256 << 20, kv_tier_chunk_pages=4)
        gen_refs = self.generate_refs(prompts, new)
        out = {}

        def p50(xs):
            return sorted(xs)[len(xs) // 2]

        for dtype in ("float32", "int8"):
            eng, ref_outs, row = self.tier_serve(
                f"tier_ref_{dtype}", prompts, new, ref_pages,
                kv_cache_dtype=dtype)
            eng.shutdown(drain=True, timeout_s=60)
            assert row["prefix"]["evictions"] == 0, "a chain was evicted"
            if dtype == "float32":
                self.assert_identical("tier_ref_float32", prompts, new,
                                      ref_outs, gen_refs)
            out[f"ref_{dtype}"] = dict(outs=ref_outs, row=row)
            del eng
            torch.cuda.empty_cache()

        arms = (("tier_fp32", "float32", ""), ("tier_int8", "int8", ""),
                ("tier_abandon", "float32", "kv_tier.promote_upload@2"),
                ("tier_nogather", "float32", "kv_tier.demote_gather@1"))
        for arm, dtype, fp in arms:
            failpoints.reset()
            set_flags({"FLAGS_failpoints": fp})
            try:
                eng, outs, row = self.tier_serve(
                    arm, prompts, new, tier_pages, kv_cache_dtype=dtype,
                    **tier_kw)
            finally:
                set_flags({"FLAGS_failpoints": ""})
            ref = out[f"ref_{dtype}"]["outs"]
            same = [np.array_equal(a, b) for a, b in zip(outs, ref)]
            reasons = row["audit"]
            n = {c: reasons.count(c) for c in (
                "KV_PROMOTE", "KV_PROMOTE_ABANDON", "KV_DEMOTE",
                "KV_TIER_EVICT", "ADMIT", "ADMIT_PREFIX_HIT")}
            budget_evicts = [e for e in row["audit_events"]
                             if e["reason"] == "KV_TIER_EVICT"
                             and e["rid"] is None]
            leak_free = self.tier_leak_free(eng)
            tier_stats = eng._tier.stats()
            cold = n["ADMIT"]
            pr = [(ms, pages) for ms, pages, ok in row["promote"] if ok]
            page_bytes = eng._cache.page_host_bytes()
            prom_host = [e["ms"] for e in row["audit_events"]
                         if e["reason"] == "KV_PROMOTE"]
            row.update(identical=sum(same), audit_counts=n,
                       tier=tier_stats, leak_free=leak_free,
                       promote_host_ms=prom_host)
            del row["audit"], row["audit_events"]
            print(f"tier arm {arm}: identical to the never-evicted "
                  f"{dtype} engine {sum(same)} of {len(same)}; audit "
                  f"{n}; tier {tier_stats}; leak-free {leak_free}")
            if pr:
                ms = sum(m for m, _ in pr)
                pages = sum(p for _, p in pr)
                row["promote_ms_per_page"] = ms / pages
                row["promote_h2d_gb_s"] = pages * page_bytes / ms / 1e6
                print(f"tier arm {arm} on {self.smi}: promotion "
                      f"{ms / pages:.4f} ms a page ({page_bytes} bytes), "
                      f"{pages * page_bytes / ms / 1e6:.2f} GB/s implied, "
                      f"over {len(pr)} promotions of {pages} pages")
            if row["demote_passes"]:
                passes = row["demote_passes"]
                pages = sum(n for _h, n, _s in passes)
                host = sum(row["demote_reserve_ms"]) + sum(
                    h for h, _n, _s in passes)
                stream = sum(st for _h, _n, st in passes)
                row["demote_ms_per_page"] = host / pages
                row["demote_stream_ms_per_page"] = stream / pages
                print(f"tier arm {arm} on {self.smi}: demotion "
                      f"{host / pages:.4f} ms a page on the step thread "
                      f"(slot reservations and batched gathers), "
                      f"{host / pages * 37:.3f} ms a 37-page system "
                      f"prompt ({pages} pages in {len(passes)} passes, "
                      f"the longest pass {max(h for h, _n, _s in passes):.3f}"
                      f" ms); stream time {stream / pages:.4f} ms a page "
                      f"({pages * page_bytes / stream / 1e6:.2f} GB/s "
                      f"D2H); host slab {eng._slab.segments} segments, "
                      f"{eng._slab.reserved_bytes} bytes")
            prom_ms = [round(m, 3) for m, _p, _ok in row["promote"]]
            gcs = row["gc_pauses_ms"]
            print(f"tier arm {arm}: promotions in order, stream ms "
                  f"{prom_ms}, host ms {prom_host}, host ms by part "
                  f"{row['promote_parts_ms']}; {len(gcs)} garbage "
                  f"collections, the longest "
                  f"{max(gcs, default=(0.0, None))[0]:.3f} ms (generation "
                  f"{max(gcs, default=(0.0, None))[1]})")
            ttft = row["ttft_ms"]
            row["ttft_p50_wave1_ms"] = p50(ttft[:4])
            row["ttft_p50_wave2_ms"] = p50(ttft[4:])
            out[arm] = row
            assert all(same), f"{arm}: outputs differ from the " \
                f"never-evicted engine"
            if dtype == "float32":
                self.assert_identical(arm, prompts, new, outs, gen_refs)
            assert leak_free, f"{arm}: a page leaked"
            eng.shutdown(drain=True, timeout_s=60)
            assert not budget_evicts, f"{arm}: host-budget evictions"
            k1, k2 = row["launches"]["paged_attention"], \
                row["launches"]["flash_fwd"]
            assert k1 == (row["steps"] * L if dtype == "float32" else 0), \
                f"{arm}: K1 launched {k1} in {row['steps']} steps"
            assert k2 == L * cold, f"{arm}: K2 {k2} for {cold} cold prefills"
            if arm in ("tier_fp32", "tier_int8"):
                assert n["KV_PROMOTE"] == 4 and n["KV_PROMOTE_ABANDON"] == 0 \
                    and cold == 4, n
            elif arm == "tier_abandon":
                assert n["KV_PROMOTE_ABANDON"] == 1 and \
                    n["KV_PROMOTE"] == 3 and cold == 5, n
                assert tier_stats["abandons"] == 1
            else:
                assert tier_stats["demotions"] == \
                    out["tier_fp32"]["tier"]["demotions"] - 1, tier_stats
                assert row["prefix"]["evictions"] == \
                    out["tier_fp32"]["prefix"]["evictions"]
            del eng
            torch.cuda.empty_cache()
        hits = out["ref_float32"]["row"]["ttft_ms"][4:]
        print(f"tier TTFT p50 on {self.smi}: wave 1 cold "
              f"{out['tier_fp32']['ttft_p50_wave1_ms']:.2f} ms, wave 2 "
              f"promoted {out['tier_fp32']['ttft_p50_wave2_ms']:.2f} ms, "
              f"never-evicted device hits {p50(hits):.2f} ms (fp32); int8 "
              f"{out['tier_int8']['ttft_p50_wave1_ms']:.2f} / "
              f"{out['tier_int8']['ttft_p50_wave2_ms']:.2f} / "
              f"{p50(out['ref_int8']['row']['ttft_ms'][4:]):.2f} ms")

        def admit_parts(row):   # wave 2's admission iterations, mean ms
            its = row["admit_iters"][4:]
            return {k: round(sum(i[k] for i in its) / len(its), 3)
                    for k in its[0]}
        print(f"tier wave-2 admission iteration on {self.smi} (mean ms a "
              f"part): promoted {admit_parts(out['tier_fp32'])}, "
              f"never-evicted {admit_parts(out['ref_float32']['row'])}")
        for r in out.values():
            r.pop("outs", None)
        out["overhead"] = self.observability_overhead()
        self.details["tier"] = out

    def observability_overhead(self):
        """Tokens/s and wall per decode step of phase 5's engine on its
        first 8 requests with the step log, the audit ring and the spans
        on (the defaults) against off, in turns on, off, off, on. Off:
        FLAGS_gen_step_log and FLAGS_serving_spans false at construction,
        and the engine's audit ring replaced by a no-op on that engine
        (the ring has no flag; this patch is the measurement's only)."""
        from paddle_tpu_torch.framework.flags import set_flags
        prompts, new = self.serving_requests(self.gpt.gpt.config.vocab_size)
        prompts, new = prompts[:8], new[:8]
        num_pages = 1 + sum(-(-(len(p) + n) // FEAT["page"])
                            for p, n in zip(prompts, new))
        rows = []
        for on in (True, False, False, True):
            set_flags({"FLAGS_gen_step_log": on, "FLAGS_serving_spans": on})
            try:
                eng = self.feature_engine(f"chip_smoke_obs_{on}", num_pages)
            finally:
                set_flags({"FLAGS_gen_step_log": True,
                           "FLAGS_serving_spans": True})
            if not on:
                eng._audit.audit = lambda *a, **k: None
            res, arr, sub, wall = self.stream_run(eng, prompts, new)
            stats = eng.stats()
            eng.shutdown(drain=True, timeout_s=60)
            toks = sum(len(a) for a in arr)
            rows.append(dict(on=on, tokens_per_s=toks / wall,
                             ms_per_step=wall * 1e3 / stats["steps"],
                             steps=stats["steps"]))
            del eng
        for r in rows:
            print(f"observability {'on' if r['on'] else 'off'} on "
                  f"{self.smi}: {r['tokens_per_s']:.1f} tokens/s, "
                  f"{r['ms_per_step']:.3f} ms wall a step "
                  f"({r['steps']} steps)")
        on = [r["tokens_per_s"] for r in rows if r["on"]]
        off = [r["tokens_per_s"] for r in rows if not r["on"]]
        print(f"observability on / off tokens/s (same call): "
              f"{sum(on) / sum(off):.3f}")
        return dict(runs=rows, host_cost=self.observability_host_cost(
            prompts, new, num_pages))

    def observability_host_cost(self, prompts, new, num_pages):
        """The host time of the engine's observability calls, measured
        around each call (perf_counter) and summed over one run of phase
        5's first 8 requests with everything on: RecordEvent's begin and
        end (ring append and NVTX push / pop), the iteration's StepRecord
        (`_record_iteration`, which also republishes `pressure()`), the
        audit ring's calls and sink flushes, and the spans' stamps and
        finish. Per iteration, and as a share of the run's wall an
        iteration. Then one RecordEvent scope in a tight loop of 20000,
        NVTX on and off. The patches are this measurement's only."""
        import collections
        from paddle_tpu_torch import profiler
        from paddle_tpu_torch.profiler import spans
        acc, calls = collections.Counter(), collections.Counter()

        def timed(key, fn):
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    acc[key] += time.perf_counter() - t0
                    calls[key] += 1
            return wrapper
        saved = [(cls, name, cls.__dict__[name])
                 for cls, name in ((profiler.RecordEvent, "begin"),
                                   (profiler.RecordEvent, "end"),
                                   (spans.GenSpan, "stamp"),
                                   (spans.GenSpan, "finish"))]
        groups = {"RecordEvent.begin": "record_event",
                  "RecordEvent.end": "record_event",
                  "GenSpan.stamp": "spans", "GenSpan.finish": "spans",
                  "_record_iteration": "step_record", "audit": "audit",
                  "flush_sink": "audit"}
        for cls, name, fn in saved:
            setattr(cls, name, timed(f"{cls.__name__}.{name}", fn))
        try:
            eng = self.feature_engine("chip_smoke_obs_cost", num_pages)
            eng._record_iteration = timed("_record_iteration",
                                          eng._record_iteration)
            eng._audit.audit = timed("audit", eng._audit.audit)
            eng._audit.flush_sink = timed("flush_sink",
                                          eng._audit.flush_sink)
            acc.clear()
            calls.clear()
            it0 = eng._iters
            _res, _arr, _sub, wall = self.stream_run(eng, prompts, new)
            iters = eng._iters - it0
            steps = eng.stats()["steps"]
            eng.shutdown(drain=True, timeout_s=60)
        finally:
            for cls, name, fn in saved:
                setattr(cls, name, fn)
        us = collections.Counter()
        for k, v in acc.items():
            us[groups[k]] += v * 1e6 / iters
        total = sum(us.values())
        wall_it_ms = wall * 1e3 / iters
        # one scope in a tight loop, NVTX as the card has it, then off
        ev = profiler.RecordEvent("chip_smoke::scope")
        nvtx = list(profiler._nvtx)
        tight = {}
        try:
            for label, on in (("nvtx_on", True), ("nvtx_off", False)):
                profiler._nvtx[:] = [on]
                t0 = time.perf_counter()
                for _ in range(20000):
                    with ev:
                        pass
                tight[label] = (time.perf_counter() - t0) * 1e6 / 20000
        finally:
            profiler._nvtx[:] = nvtx
        row = dict(iters=iters, steps=steps, wall_ms_per_iter=wall_it_ms,
                   us_per_iter=dict(us), total_us_per_iter=total,
                   share_of_wall=total / (wall_it_ms * 1e3),
                   calls_per_iter={k: v / iters for k, v in calls.items()},
                   record_event_us=tight)
        print(f"observability host cost on {self.smi}: {total:.1f} us an "
              f"iteration = {100 * row['share_of_wall']:.2f} % of "
              f"{wall_it_ms:.3f} ms wall an iteration ({iters} iterations, "
              f"{steps} decode steps); by part (us an iteration): "
              f"{ {k: round(v, 2) for k, v in us.items()} }; calls an "
              f"iteration: "
              f"{ {k: round(v, 2) for k, v in row['calls_per_iter'].items()} }"
              f"; one RecordEvent scope in a tight loop: "
              f"{tight['nvtx_on']:.3f} us with NVTX, "
              f"{tight['nvtx_off']:.3f} us without")
        return row

    # -- optional: where the serving time goes ---------------------------------

    # -- 5e. supervised restart and the prefix-affinity router ------------------

    def fleet_kw(self, num_pages, **kw):
        """Phase 5's engine settings for a supervisor or a router."""
        return dict(device="cuda", max_slots=FEAT["slots"],
                    page_size=FEAT["page"], num_pages=num_pages,
                    prefill_buckets=FEAT["buckets"], max_new_tokens=64,
                    request_timeout_ms=0, **kw)

    @staticmethod
    def http_get(url):
        """(status, body) of a GET on 127.0.0.1, 5xx answers included."""
        import urllib.error
        import urllib.request
        assert url.startswith("http://127.0.0.1:"), url
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    @staticmethod
    def fleet_streams(front, prompts, new, join=None, lock=None,
                      handles=None):
        """Stream `prompts` through `front` (a supervisor or a router).
        With `join`, the first 8 go in at once, then, once `join()` says
        so, the rest at once (8 joining while 8 decode); else all at
        once. `lock()` gives the lock to hold while a group is submitted
        (the engine's, so its step thread admits the group in one pass),
        or None; `handles`, a list, receives the streams. Returns
        (results: the sequence or the exception, collected tokens,
        arrival times, submit times, wall s)."""
        n = len(prompts)
        results, collected = [None] * n, [[] for _ in range(n)]
        arrivals, submit_t = [[] for _ in range(n)], [0.0] * n
        threads = []
        if handles is not None:
            handles[:] = [None] * n

        def consume(i, stream):
            try:
                for tok in stream:
                    arrivals[i].append(time.perf_counter())
                    collected[i].append(tok)
                results[i] = stream.result()
            except Exception as e:  # noqa: BLE001 — the gates read it
                results[i] = e

        def submit(idx):
            lk = lock() if lock is not None else None
            if lk is not None:
                lk.acquire()
            try:
                for i in idx:
                    submit_t[i] = time.perf_counter()
                    st = front.submit_stream(prompts[i],
                                             max_new_tokens=new[i])
                    if handles is not None:
                        handles[i] = st
                    th = threading.Thread(target=consume, args=(i, st),
                                          daemon=True)
                    th.start()
                    threads.append(th)
            finally:
                if lk is not None:
                    lk.release()

        t0 = time.perf_counter()
        if join is None:
            submit(range(n))
        else:
            submit(range(min(8, n)))
            while not join():
                time.sleep(0.0005)
            submit(range(8, n))
        for th in threads:
            th.join(600)
        return results, collected, arrivals, submit_t, \
            time.perf_counter() - t0

    def death_probe(self, sup, n_death):
        """Instrument incarnation 0 of `sup`. Its pre-step hook counts
        steps; at step `n_death` (the step `decode_step_raise@n_death`
        kills) it records the time, the allocated bytes (the steady
        state) and resets the allocator's peak. Its death callback
        records the handover time, the manifest's entries and the dead
        pools' bytes, then runs the supervisor's and records the peak
        allocated bytes once the rebuilt engine is built and warmed, and
        once it has taken the replays."""
        torch = self.torch
        eng = sup.engine
        probe = {"steps": 0}

        def hook(e):
            probe["steps"] += 1
            if probe["steps"] == n_death:
                probe["t_death"] = time.perf_counter()
                probe["steady"] = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()

        def on_death(manifest, orig=eng._on_death):
            probe.setdefault("t_death", time.perf_counter())
            probe["t_handover"] = time.perf_counter()
            probe["live"] = sum(not e.queued for e in manifest.entries)
            probe["queued"] = sum(e.queued for e in manifest.entries)
            probe["replay_lens"] = [int(e.prompt.size) + len(e.toks)
                                    for e in manifest.entries]
            # tokens each stream had received before the death: its
            # next one is the first the new incarnation delivers
            probe["delivered"] = [(e.stream, e.delivered)
                                  for e in manifest.entries
                                  if e.stream is not None]
            probe["dead_hbm"] = eng._cache.hbm_bytes()
            orig(manifest)
            probe["t_rebuilt"] = time.perf_counter()
            probe["peak_rebuilt"] = torch.cuda.max_memory_allocated()

        def build(incarnation, carry, orig=sup._build_engine):
            new = orig(incarnation, carry)
            # the rebuilt engine allocated and warmed, no replay yet
            probe["peak_built"] = torch.cuda.max_memory_allocated()
            return new

        eng._pre_step_hook = hook
        eng._on_death = on_death
        sup._build_engine = build
        return probe

    @staticmethod
    def count_long_prefills():
        """Patch GenerationEngine._prefill_call to count the prefills (a
        rebuild's warmup included) whose bucket reaches
        FLAGS_flash_attention_min_seq, the ones that run K2. Returns
        (counter, undo)."""
        from paddle_tpu_torch.framework.flags import flag
        from paddle_tpu_torch.serving import generation
        orig = generation.GenerationEngine._prefill_call
        box = {"n": 0}

        def counted(eng, pt_row, ids, length):
            if ids.shape[1] >= int(flag("FLAGS_flash_attention_min_seq")):
                box["n"] += 1
            return orig(eng, pt_row, ids, length)

        generation.GenerationEngine._prefill_call = counted

        def undo():
            generation.GenerationEngine._prefill_call = orig
        return box, undo

    def fleet_restart_arm(self, arm, fp, prompts, new, refs, num_pages,
                          n_death=None, join=None, sup=None, **kw):
        """One supervised-restart arm: phase 5's streamed requests
        through an EngineSupervisor (built here with `kw` unless `sup`
        is given) with failpoint `fp` armed, launch counts from 0. The
        exact gates: outputs identical to generate(), each stream its
        generated tokens exactly once, one ENGINE_RESTART, REPLAY_ADMIT
        = the manifest's entries = the STAT_gen_replayed_requests delta,
        incarnation 1, the ledger, the loaded kernel libraries and nvcc
        untouched, K1 = 12 x (decode steps of both incarnations + the
        rebuild's warmup step), K2 = 12 x the prefills in buckets >= the
        min-seq flag, no page leaked, STAT_kv_cache_hbm_bytes back to
        before + the live cache's bytes, the dead pools released. Returns
        (supervisor, row)."""
        torch = self.torch
        import gc
        import numpy as np
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.framework.flags import set_flags
        from paddle_tpu_torch.ops import _build
        from paddle_tpu_torch.serving import EngineSupervisor, failpoints
        L = self.gpt.gpt.config.num_layers
        gc.collect()
        # the residency gauge without this arm's caches
        gauge0 = monitor.stat_get("STAT_kv_cache_hbm_bytes") - (
            sup.engine._cache.hbm_bytes() if sup is not None else 0)
        if sup is None:
            sup = EngineSupervisor(self.gpt, name=f"chip_smoke_{arm}",
                                   **self.fleet_kw(num_pages, **kw))
        eng0 = sup.engine
        ledger0, libs0 = dict(eng0._ledger), dict(_build._libs)
        pool_bytes = eng0._cache.hbm_bytes()
        probe = self.death_probe(sup, n_death)
        nvcc_calls = []
        orig_nvcc = _build._nvcc
        _build._nvcc = lambda: nvcc_calls.append(1) or orig_nvcc()
        prefills, undo = self.count_long_prefills()
        replayed0 = monitor.stat_get("STAT_gen_replayed_requests")
        steps0 = eng0.stats()["steps"]
        failpoints.reset()
        set_flags({"FLAGS_failpoints": fp})
        # this path starts here: every launch count from 0
        self.zero_launches()
        streams = []
        try:
            res, collected, arrivals, _s, wall = self.fleet_streams(
                sup, prompts, new, join=join and (lambda: join(sup)),
                lock=lambda: sup.engine._cv, handles=streams)
        finally:
            set_flags({"FLAGS_failpoints": ""})
            undo()
            _build._nvcc = orig_nvcc
        launches = self.record_path(arm)
        eng1 = sup.engine
        st1 = eng1.stats()
        steps = eng0.stats()["steps"] - steps0 + st1["steps"]
        reasons = [e["reason"] for e in eng1._audit.tail(4096)]
        restarts = [e for e in eng1._audit.tail(4096)
                    if e["reason"] == "ENGINE_RESTART"]
        sstats = sup.supervisor_stats()
        replayed = monitor.stat_get("STAT_gen_replayed_requests") - replayed0
        peak_end = torch.cuda.max_memory_allocated()
        gen_tokens = sum(len(c) for c in collected)
        t_death = probe.get("t_death")
        index = {id(st): i for i, st in enumerate(streams)}
        first_replayed = min(
            (arrivals[index[id(st)]][d] for st, d in probe.get(
                "delivered", []) if id(st) in index
             and len(arrivals[index[id(st)]]) > d), default=None)
        row = dict(
            wall_s=wall, tokens=gen_tokens, tokens_per_s=gen_tokens / wall,
            steps=steps, launches=launches, long_prefills=prefills["n"],
            live_at_death=probe.get("live"),
            queued_at_death=probe.get("queued"),
            entries=sum(e["entries"] for e in restarts),
            replay_admit=reasons.count("REPLAY_ADMIT"),
            replayed_stat=replayed, supervisor=sstats,
            handover_ms=(probe["t_handover"] - t_death) * 1e3
            if "t_handover" in probe else None,
            rebuilt_ms=(probe["t_rebuilt"] - t_death) * 1e3
            if "t_rebuilt" in probe else None,
            first_replayed_token_ms=(first_replayed - t_death) * 1e3
            if first_replayed is not None else None,
            steady_bytes=probe.get("steady"),
            peak_built_bytes=probe.get("peak_built"),
            peak_rebuilt_bytes=probe.get("peak_rebuilt"),
            peak_end_bytes=peak_end, pool_bytes=pool_bytes)
        print(f"fleet arm {arm} on {self.smi}: {len(prompts)} requests, "
              f"{gen_tokens} tokens in {wall:.3f} s "
              f"({gen_tokens / wall:.1f} tokens/s); {sstats['restarts']} "
              f"restart(s), {row['live_at_death']} live + "
              f"{row['queued_at_death']} queued at the death, "
              f"{row['replay_admit']} REPLAY_ADMIT; recovery "
              f"{sstats['last_recovery_ms']} ms in the supervisor "
              f"(rebuild, warmup, replay), death -> rebuilt "
              f"{row['rebuilt_ms']} ms, death -> first replayed token "
              f"{row['first_replayed_token_ms']} ms; {steps} decode steps, "
              f"launches {launches}, {prefills['n']} prefills in buckets "
              f">= the min-seq flag")
        if row["steady_bytes"] is not None:
            print(f"fleet arm {arm} on {self.smi}: allocated bytes steady "
                  f"(at the death step) {row['steady_bytes']}, peak to "
                  f"the rebuild's warmup {row['peak_built_bytes']} "
                  f"(+{row['peak_built_bytes'] - row['steady_bytes']}), "
                  f"to the replays taken {row['peak_rebuilt_bytes']} "
                  f"(+{row['peak_rebuilt_bytes'] - row['steady_bytes']}), "
                  f"peak to the arm's end {peak_end} "
                  f"(+{peak_end - row['steady_bytes']}); one pool set "
                  f"{pool_bytes}")
        # gates
        outs = [r if isinstance(r, np.ndarray) else None for r in res]
        bad = [(i, repr(r)) for i, r in enumerate(res)
               if not isinstance(r, np.ndarray)]
        assert not bad, f"{arm}: requests failed: {bad}"
        self.assert_identical(arm, prompts, new, outs, refs)
        once = [i for i, (p, o) in enumerate(zip(prompts, outs))
                if collected[i] != o[len(p):].tolist()]
        assert not once, f"{arm}: streams {once} not exactly once"
        assert sstats["restarts"] == len(restarts) == 1, (sstats, restarts)
        assert st1["incarnation"] == sstats["incarnation"] == 1, st1
        assert row["replay_admit"] == row["entries"] == replayed, row
        assert dict(eng1._ledger) == ledger0, \
            f"{arm}: the rebuild added ledger keys"
        assert dict(_build._libs) == libs0 and not nvcc_calls, \
            f"{arm}: a kernel was built during the arm"
        assert launches["paged_attention"] == (steps + 1) * L, \
            f"{arm}: K1 {launches['paged_attention']} for {steps} steps " \
            f"+ the rebuild's warmup step"
        assert launches["flash_fwd"] == prefills["n"] * L, \
            f"{arm}: K2 {launches['flash_fwd']} for {prefills['n']} " \
            f"long prefills"
        long_replays = sum(n > 256 for n in probe.get("replay_lens", []))
        assert prefills["n"] >= 1 + long_replays, (prefills, long_replays)
        assert probe.get("dead_hbm") == 0, "the dead pools were not released"
        sup.shutdown(drain=True, timeout_s=60)
        assert st1["pages"]["pages_in_use"] == 0 == \
            eng1.stats()["pages"]["pages_in_use"], f"{arm}: pages leaked"
        gc.collect()
        gauge = monitor.stat_get("STAT_kv_cache_hbm_bytes")
        assert gauge == gauge0 + eng1._cache.hbm_bytes(), \
            f"{arm}: STAT_kv_cache_hbm_bytes {gauge} != {gauge0} + " \
            f"{eng1._cache.hbm_bytes()}"
        if row["steady_bytes"] is not None:
            for k in ("peak_built_bytes", "peak_rebuilt_bytes",
                      "peak_end_bytes"):
                assert row[k] - row["steady_bytes"] < pool_bytes / 2, \
                    f"{arm}: {k} {row[k]} exceeds steady " \
                    f"{row['steady_bytes']} by half a pool set or more"
        row["reasons"] = {c: reasons.count(c) for c in set(reasons)}
        return sup, row

    def fleet_sessions(self, vocab, seed):
        """Four agent sessions: each its own 192-token system prompt; a
        turn's user message 16-32 tokens (seeded)."""
        import numpy as np
        rng = np.random.RandomState(seed)
        systems = [rng.randint(0, vocab, size=(192,)) for _ in range(4)]
        users = [[rng.randint(0, vocab, size=(int(rng.randint(16, 33)),))
                  for _ in range(3)] for _ in range(4)]
        return systems, users

    def fleet_session_run(self, router, systems, users, new=32):
        """Serve the four sessions turn by turn through `router`: turn
        t's prompt is turn t-1's prompt and output plus the next user
        message; turn t submits the sessions in an order rotated by t
        (agents answer at different times). Returns (prompts
        [turn][session], outputs, TTFT ms, the replica each request was
        placed on [turn][session], read off the router's audit ring)."""
        import numpy as np
        S = len(systems)
        prompts, outs, ttft, placed = [], [], [], []
        prev = [None] * S
        for t in range(3):
            order = [(i + t) % S for i in range(S)]
            ps = [np.concatenate([systems[s] if prev[s] is None
                                  else prev[s], users[s][t]])
                  for s in order]
            n0 = len(router.stats()["router"]["audit_tail"])
            res, _c, arr, sub, _w = self.fleet_streams(
                router, ps, [new] * S)
            for s, r in zip(order, res):
                assert isinstance(r, np.ndarray), \
                    f"session {s} turn {t}: {r!r}"
            where = [e["replica"] for e in router.stats()["router"][
                "audit_tail"][n0:] if e["reason"] in (
                    "ROUTE_AFFINITY", "ROUTE_LEAST_PRESSURE")]
            back = {s: i for i, s in enumerate(order)}
            prompts.append([ps[back[s]] for s in range(S)])
            outs.append([res[back[s]] for s in range(S)])
            ttft.append([(arr[back[s]][0] - sub[back[s]]) * 1e3
                         for s in range(S)])
            placed.append([where[back[s]] for s in range(S)])
            prev = outs[-1]
        return prompts, outs, ttft, placed

    def fleet_router_arms(self, prompts5, new5, refs5, num_pages):
        """Phase 5e (b): two replicas (EngineSupervisors with the prefix
        cache on) over the one GPT-2 small behind a Router. Four agent
        sessions of three turns with affinity on, then off (outputs
        identical to generate(); with affinity, turns 2-3 on turn 1's
        replica: 8 ROUTE_AFFINITY); then, on the affinity router, the
        kill arm (phase 5's 16 requests, decode_step_raise@6: every
        request served through its replica's replay, identical to
        generate() and exactly once, no ROUTE_REROUTE, the router's
        /readyz 200 throughout); then 16 requests at phase 5's lengths
        through the two replicas and through one engine (tokens/s, the
        same outputs). No page leaked on either replica."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.framework.flags import set_flags
        from paddle_tpu_torch.serving import (EngineSupervisor, Router,
                                              failpoints)
        L = self.gpt.gpt.config.num_layers
        out = {}

        def p50(xs):
            return sorted(xs)[len(xs) // 2]

        def hit_tokens(r):
            return sum(rep.sup.stats()["kv"]["prefix"]["hit_tokens"]
                       for rep in r._replicas)

        def leak_free(r):
            return all(rep.sup.engine._cache.owners() == {}
                       and rep.sup.engine._cache.pages_in_use
                       == len(rep.sup.engine._cache.cached_pages())
                       for rep in r._replicas)

        # sessions through the affinity router and the round-robin one,
        # in the order on, off, off, on (two session sets; each router
        # meets a set once), so the two are compared in turns
        routers = {aff: Router(
            self.gpt, num_replicas=2,
            name=f"chip_smoke_fleet_{'affinity' if aff else 'rr'}",
            affinity=aff, prefix_cache=True,
            metrics_port=0 if aff else None, **self.fleet_kw(num_pages))
            for aff in (True, False)}
        by_seed = {}
        for n, (aff, seed) in enumerate(((True, 5), (False, 5), (False, 6),
                                         (True, 6))):
            r = routers[aff]
            arm = f"fleet_sessions_{'on' if aff else 'off'}_{n // 2 + 1}"
            systems, users = self.fleet_sessions(
                self.gpt.gpt.config.vocab_size, seed)
            audit0 = len(r.stats()["router"]["audit_tail"])
            hits0 = hit_tokens(r)
            self.zero_launches()
            t0 = time.perf_counter()
            prompts, outs, ttft, placed = self.fleet_session_run(
                r, systems, users)
            wall = time.perf_counter() - t0
            launches = self.record_path(arm)
            reasons = [e["reason"] for e in
                       r.stats()["router"]["audit_tail"][audit0:]]
            flat_p = [p for turn in prompts for p in turn]
            flat_o = [o for turn in outs for o in turn]
            if seed not in by_seed:
                by_seed[seed] = (flat_p, self.generate_refs(
                    flat_p, [32] * len(flat_p)))
            same_p = all(np.array_equal(a, b)
                         for a, b in zip(flat_p, by_seed[seed][0]))
            assert same_p, f"{arm}: prompts differ between the routers"
            self.assert_identical(arm, flat_p, [32] * len(flat_p), flat_o,
                                  by_seed[seed][1])
            row = dict(wall_s=wall, placed=placed, launches=launches,
                       affinity_routes=reasons.count("ROUTE_AFFINITY"),
                       hit_tokens=hit_tokens(r) - hits0, ttft_ms=ttft,
                       ttft_p50_turns23_ms=p50(ttft[1] + ttft[2]),
                       ttft_p50_turn1_ms=p50(ttft[0]))
            out[arm] = row
            print(f"fleet arm {arm} on {self.smi}: 4 sessions x 3 turns "
                  f"in {wall:.3f} s; replicas by turn {placed}; "
                  f"ROUTE_AFFINITY {row['affinity_routes']}; prefix-hit "
                  f"tokens {row['hit_tokens']}; TTFT p50 turns 2-3 "
                  f"{row['ttft_p50_turns23_ms']:.2f} ms, turn 1 "
                  f"{row['ttft_p50_turn1_ms']:.2f} ms; launches "
                  f"{launches}")
            assert leak_free(r), f"{arm}: a page leaked"
            if aff:
                assert placed[1] == placed[0] == placed[2], \
                    f"{arm}: turns 2-3 left their session's replica " \
                    f"{placed}"
                assert row["affinity_routes"] == 8, reasons
        routers[False].shutdown(drain=True, timeout_s=60)
        assert leak_free(routers[False]), "fleet_sessions_off: a page leaked"
        del routers[False]
        r = routers[True]

        # the kill arm: decode_step_raise@6 kills one replica mid-load
        arm = "fleet_kill"
        engines0 = [rep.sup.engine for rep in r._replicas]
        steps0 = [e.stats()["steps"] for e in engines0]
        ledgers0 = [dict(e._ledger) for e in engines0]
        reroutes0 = monitor.stat_get("STAT_router_reroutes")
        audit0 = len(r.stats()["router"]["audit_tail"])
        url = r.metrics_server.url if r.metrics_server is not None else None
        statuses, stop = [], threading.Event()

        def poll():
            while not stop.is_set():
                code, body = self.http_get(url + "/readyz")
                statuses.append((code, json.loads(body)["engines"].get(
                    r.name, {}).get("ready")))
                time.sleep(0.01)

        poller = threading.Thread(target=poll, daemon=True)
        failpoints.reset()
        set_flags({"FLAGS_failpoints": "decode_step_raise@6"})
        self.zero_launches()
        poller.start()
        try:
            res, collected, _a, _s, wall = self.fleet_streams(
                r, prompts5, new5)
        finally:
            set_flags({"FLAGS_failpoints": ""})
            stop.set()
            poller.join(30)
        launches = self.record_path(arm)
        restarts = sum(rep.sup.restarts for rep in r._replicas)
        steps = sum(e.stats()["steps"] - s0
                    for e, s0 in zip(engines0, steps0))
        steps += sum(rep.sup.engine.stats()["steps"]
                     for rep, e in zip(r._replicas, engines0)
                     if rep.sup.engine is not e)
        route = [e["reason"] for e in
                 r.stats()["router"]["audit_tail"][audit0:]]
        reroutes = monitor.stat_get("STAT_router_reroutes") - reroutes0
        row = dict(wall_s=wall, restarts=restarts, steps=steps,
                   launches=launches, reroutes=reroutes,
                   route={c: route.count(c) for c in set(route)},
                   readyz=sorted({s for s in statuses}, key=str),
                   readyz_polls=len(statuses),
                   recovery_ms=[rep.sup.supervisor_stats()[
                       "last_recovery_ms"] for rep in r._replicas])
        out[arm] = row
        print(f"fleet arm {arm} on {self.smi}: {len(prompts5)} requests in "
              f"{wall:.3f} s; {restarts} restart(s), recovery ms "
              f"{row['recovery_ms']}; router audit {row['route']}; "
              f"/readyz (status, router ready) seen {row['readyz']} over "
              f"{len(statuses)} polls; {steps} decode steps, launches "
              f"{launches}")
        bad = [(i, repr(x)) for i, x in enumerate(res)
               if not isinstance(x, np.ndarray)]
        assert not bad, f"{arm}: requests failed: {bad}"
        self.assert_identical(arm, prompts5, new5, res, refs5)
        once = [i for i, (p, o) in enumerate(zip(prompts5, res))
                if collected[i] != o[len(p):].tolist()]
        assert not once, f"{arm}: streams {once} not exactly once"
        assert restarts == 1, f"{arm}: {restarts} restarts"
        assert reroutes == 0 and "ROUTE_REROUTE" not in route, \
            f"{arm}: re-routes without a placement-time failure"
        assert statuses and all(s == (200, True) for s in statuses), \
            f"{arm}: the router's /readyz left 200: {row['readyz']}"
        assert [dict(rep.sup.engine._ledger) for rep in r._replicas] == \
            ledgers0, f"{arm}: a rebuild added ledger keys"
        assert launches["paged_attention"] == (steps + restarts) * L, \
            f"{arm}: K1 {launches['paged_attention']} for {steps} steps " \
            f"+ {restarts} rebuild warmup step(s)"
        assert leak_free(r), f"{arm}: a page leaked"
        # aggregate tokens/s: phase 5's lengths with other tokens (no
        # prefix a replica holds) through the two replicas and through one
        # engine with the same settings, in the order two, one, one, two
        # (two token sets; each front meets a set once); the two fronts
        # give the same outputs
        one = EngineSupervisor(self.gpt, name="chip_smoke_fleet_one",
                               prefix_cache=True, **self.fleet_kw(num_pages))
        thr, outs_t = {"fleet_two": [], "fleet_one": []}, {}
        for arm, seed in (("fleet_two", 1), ("fleet_one", 1),
                          ("fleet_one", 2), ("fleet_two", 2)):
            front = r if arm == "fleet_two" else one
            prompts_t, new_t = self.serving_requests(
                self.gpt.gpt.config.vocab_size, seed=seed)
            self.zero_launches()
            res, _c, _a, _s, wall = self.fleet_streams(front, prompts_t,
                                                       new_t)
            self.record_path(f"{arm}_{seed}")
            bad = [(i, repr(x)) for i, x in enumerate(res)
                   if not isinstance(x, np.ndarray)]
            assert not bad, f"{arm}: requests failed: {bad}"
            thr[arm].append(sum(len(o) - len(p)
                                for o, p in zip(res, prompts_t)) / wall)
            if seed in outs_t:
                same = [np.array_equal(a, b)
                        for a, b in zip(outs_t[seed], res)]
                assert all(same), \
                    f"two replicas and one engine differ: {same}"
            outs_t[seed] = res
        one.shutdown(drain=True, timeout_s=60)
        del one
        out["tokens_per_s"] = thr
        two, single = sum(thr["fleet_two"]) / 2, sum(thr["fleet_one"]) / 2
        print(f"fleet throughput on {self.smi}: 16 requests at phase 5's "
              f"lengths, two replicas {[round(x, 1) for x in thr['fleet_two']]}"
              f" tokens/s, one engine "
              f"{[round(x, 1) for x in thr['fleet_one']]} tokens/s (two, "
              f"one, one, two: {two / single:.2f}x on the means)")
        r.shutdown(drain=True, timeout_s=60)
        assert leak_free(r), "fleet_two: a page leaked"
        del r
        torch.cuda.empty_cache()
        return out

    def fleet(self):
        """Phase 5e: GPT-2 small (fp32, seed 0) at phase 5's engine
        settings under EngineSupervisor and Router. (a) Phase 5's 16
        streamed requests (8 joining while 8 decode) through one
        supervisor with FLAGS_gen_restart_backoff_ms 5: arms
        decode_step_raise@12 (8 live and 8 queued at the death),
        prefill_raise@1, and a spec_k 4 engine with
        FLAGS_gen_poison_degrade_k 2 (decode_poison_nan@every:1 on two
        requests, then decode_step_raise@1); the exact gates of
        `fleet_restart_arm`; the restart's peak allocated bytes over the
        death step's by less than half a pool set; then the breaker arm
        (decode_step_raise@every:1, retry limit 2, threshold 3): every
        request fails typed, BREAKER_OPEN once, /readyz 503 with the
        reason. (b) `fleet_router_arms`."""
        torch = self.torch
        from paddle_tpu_torch.framework.errors import UnavailableError
        from paddle_tpu_torch.framework.flags import get_flags, set_flags
        from paddle_tpu_torch.serving import EngineSupervisor, failpoints
        if not hasattr(self, "gpt"):
            from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
            self.gpt = GPTForCausalLM(GPTConfig(), device="cuda",
                                      seed=0).eval()
        prompts, new = self.serving_requests(self.gpt.gpt.config.vocab_size)
        refs = getattr(self, "serving_refs", None) or \
            self.generate_refs(prompts, new)
        P = FEAT["page"]
        num_pages = 1 + sum(-(-(len(p) + n) // P)
                            for p, n in zip(prompts, new))
        saved = get_flags(["FLAGS_gen_restart_backoff_ms",
                           "FLAGS_gen_poison_degrade_k"])
        set_flags({"FLAGS_gen_restart_backoff_ms": 5.0})
        out = {}
        try:
            def steps_at(k, after_restart=False):
                return lambda sup: (sup.engine.stats()["steps"] >= k
                                    and (sup.restarts >= 1
                                         or not after_restart))

            _, out["fleet_restart"] = self.fleet_restart_arm(
                "fleet_restart", "decode_step_raise@12", prompts, new, refs,
                num_pages, n_death=12, join=steps_at(2))
            r = out["fleet_restart"]
            assert (r["live_at_death"], r["queued_at_death"]) == (8, 8), r
            assert r["steady_bytes"] is not None
            torch.cuda.empty_cache()
            _, out["fleet_prefill"] = self.fleet_restart_arm(
                "fleet_prefill", "prefill_raise@1", prompts, new, refs,
                num_pages, join=steps_at(2, after_restart=True))
            torch.cuda.empty_cache()

            # degraded: speculation off after two poison events, then a
            # death; incarnation 1 starts with speculation off
            set_flags({"FLAGS_gen_poison_degrade_k": 2})
            sup = EngineSupervisor(self.gpt, name="chip_smoke_fleet_spec",
                                   spec_k=FEAT["spec_k"],
                                   **self.fleet_kw(num_pages))
            failpoints.reset()
            set_flags({"FLAGS_failpoints": "decode_poison_nan@every:1"})
            self.zero_launches()
            try:
                for i in (0, 2):
                    try:
                        sup.submit(prompts[i],
                                   max_new_tokens=new[i]).result(60)
                        raise AssertionError("a poisoned request succeeded")
                    except AssertionError:
                        raise
                    except Exception as e:  # noqa: BLE001 — checked here
                        assert "non-finite" in str(e), repr(e)
            finally:
                set_flags({"FLAGS_failpoints": ""})
            poison = self.record_path("fleet_spec_poison")
            reasons = [e["reason"] for e in sup.engine._audit.tail(4096)]
            assert reasons.count("DEGRADED_SPEC_OFF") == 1, reasons
            assert sup.stats()["degraded"]["spec_off"]
            assert poison["paged_attention"] == 0, \
                f"the verify program launched K1: {poison}"
            _, row = self.fleet_restart_arm(
                "fleet_degraded", "decode_step_raise@1", prompts, new, refs,
                num_pages, join=steps_at(2, after_restart=True), sup=sup)
            assert row["reasons"]["DEGRADED_SPEC_OFF"] == 1, row["reasons"]
            assert row["launches"]["paged_attention"] > 0
            out["fleet_degraded"] = row
            degraded = sup.engine.stats()
            assert degraded["degraded"]["spec_off"] and \
                degraded["incarnation"] == 1, degraded["degraded"]
            del sup
            set_flags({"FLAGS_gen_poison_degrade_k": 0})
            torch.cuda.empty_cache()

            # the breaker: every step dies
            sup = EngineSupervisor(self.gpt, name="chip_smoke_fleet_breaker",
                                   retry_limit=2, breaker_threshold=3,
                                   metrics_port=0,
                                   **self.fleet_kw(num_pages))
            few = [0, 2, 6, 11]
            failpoints.reset()
            set_flags({"FLAGS_failpoints": "decode_step_raise@every:1"})
            self.zero_launches()
            try:
                res, _c, _a, _s, wall = self.fleet_streams(
                    sup, [prompts[i] for i in few], [new[i] for i in few],
                    lock=lambda: sup.engine._cv)
            finally:
                set_flags({"FLAGS_failpoints": ""})
            self.record_path("fleet_breaker")
            code, body = self.http_get(sup.metrics_server.url + "/readyz")
            entry = json.loads(body)["engines"][sup.name]
            reasons = [e["reason"] for e in sup.engine._audit.tail(4096)]
            ss = sup.supervisor_stats()
            print(f"fleet arm fleet_breaker on {self.smi}: "
                  f"{[type(x).__name__ for x in res]} in {wall:.3f} s; "
                  f"{ss['incarnation']} incarnations, breaker "
                  f"{ss['breaker']}; /readyz {code} {entry['reason']!r}")
            out["fleet_breaker"] = dict(
                errors=[type(x).__name__ for x in res], readyz=code,
                reason=entry["reason"], supervisor=ss,
                reasons={c: reasons.count(c) for c in set(reasons)})
            assert all(isinstance(x, UnavailableError) for x in res), res
            assert reasons.count("BREAKER_OPEN") == 1, reasons
            assert code == 503 and not entry["ready"] and \
                "breaker open" in entry["reason"], (code, entry)
            sup.shutdown(drain=True, timeout_s=60)
            del sup
            torch.cuda.empty_cache()
            out.update(self.fleet_router_arms(prompts, new, refs, num_pages))
        finally:
            set_flags(saved)
            set_flags({"FLAGS_failpoints": ""})
        self.details["fleet"] = out

    def profile(self):
        """Prefill wall time per bucket, then torch.profiler over 20
        decode steps of 8 live sequences: wall per step, device busy
        share, device time by kernel."""
        torch = self.torch
        from paddle_tpu_torch.models.gpt import gpt_prefill
        cfg = self.gpt.gpt.config
        W = self.gpt.decode_weights()
        H = cfg.num_heads
        scale = 1.0 / (cfg.hidden_size // H) ** 0.5
        with torch.inference_mode():
            for b in (16, 64, 256, 1024):
                ids = torch.zeros(1, b, dtype=torch.long, device="cuda")
                gpt_prefill(W, ids, num_heads=H, scale=scale)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    gpt_prefill(W, ids, num_heads=H, scale=scale)
                torch.cuda.synchronize()
                print(f"prefill[b={b}] wall "
                      f"{(time.perf_counter() - t0) / 5 * 1e3:.2f} ms")
        self.details["profile"] = self.profile_decode(self.gpt, "profile")

    def profile_decode(self, gpt, name, **engine_kw):
        """torch.profiler over 20 decode steps of 8 live slots at 230
        cached tokens each, on `gpt`'s engine (engine_kw: e.g. the pools'
        type): wall per step, device busy share, device time by kernel."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        import numpy as np
        from paddle_tpu_torch.serving import GenerationEngine
        # the decode step of 8 live slots at ~230 cached tokens each,
        # called on this thread (the profiler sees this thread's launches)
        eng = GenerationEngine(gpt, device="cuda", name=name,
                               max_slots=8, page_size=16, num_pages=8 * 20 + 1,
                               prefill_buckets=(256,), max_new_tokens=64,
                               request_timeout_ms=0, **engine_kw)
        eng.shutdown()
        M, PP = 8, eng._cfg.pages_per_seq
        pt = np.zeros((M, PP), np.int32)
        for i in range(M):
            pt[i] = eng._cache.alloc(1000 + i, 300)
        args = (pt, np.arange(M, dtype=np.int64), np.full((M,), 230, np.int32),
                np.ones((M,), bool), np.ones((M,), np.float32),
                np.zeros((M,), bool))
        steps = 20
        with torch.inference_mode():
            for _ in range(3):
                eng._decode_call(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    eng._decode_call(*args)
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            for _ in range(steps):
                eng._decode_call(*args)
            torch.cuda.synchronize()
            bare_ms = (time.perf_counter() - t0) * 1e3
        dev, top = _device_table(torch, prof, steps, bare_ms)
        print(f"decode step ({name}), 8 live slots at 230 cached tokens on "
              f"{self.smi}: wall {bare_ms / steps:.3f} ms/step unprofiled, "
              f"{wall_ms / steps:.3f} ms/step profiled; device busy "
              f"{dev:.3f} ms/step = {dev / (bare_ms / steps) * 100:.1f}% "
              f"of the unprofiled wall")
        return dict(steps=steps, wall_ms_per_step=bare_ms / steps,
                    device_ms_per_step=dev, top=top[:12])

    # -- 6. train ----------------------------------------------------------------

    def train(self):
        """GPT-2 small trained through hapi.Model.fit in fp32, then the
        step-parity check; then the same fit under amp_configs="O1" and
        the AMP step parities in bf16 and fp16 (see the module
        docstring)."""
        self.gpt = None   # the serving model's memory back to the pool
        self.torch.cuda.empty_cache()
        self.fit_gpt(None)
        self.step_parity()
        self.fit_gpt("O1")
        self.train_fp16()
        self.amp_step_parity("bfloat16")
        self.amp_step_parity("float16")

    def _gpt_train_setup(self):
        """GPT-2 small (dropout 0.1, seed 0) on the card, the train data
        (64 motifs of 3-8 ids out of 4096, each sequence one motif
        repeated, so the loss must fall; [B * steps, S + 1] int64) and
        AdamW under LinearWarmup with the global-norm clip."""
        import numpy as np
        from paddle_tpu_torch import nn, optimizer
        from paddle_tpu_torch.framework import random as frandom
        from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
        B, S = TRAIN_SHAPE["B"], TRAIN_SHAPE["S"]
        cfg = GPTConfig()
        assert cfg.dropout == DROPOUT
        frandom.seed(0)
        net = GPTForCausalLM(cfg, device="cuda", seed=0)
        rng = np.random.RandomState(0)
        motifs = [rng.randint(0, 4096, size=rng.randint(3, 9))
                  for _ in range(64)]
        ids = np.stack([np.resize(motifs[rng.randint(64)], S + 1)
                        for _ in range(B * TRAIN_STEPS)]).astype(np.int64)
        sched = optimizer.lr.LinearWarmup(6e-4, 5, 6e-5, 6e-4)
        opt = optimizer.AdamW(learning_rate=sched, weight_decay=0.01,
                              grad_clip=nn.ClipGradByGlobalNorm(1.0))
        return net, ids, opt

    def fit_gpt(self, amp_level):
        """TRAIN_STEPS steps of GPT-2 small (dropout 0.1) through
        hapi.Model.fit, in fp32 (`amp_level` None, the path "train") or
        under `amp_configs=amp_level` (bf16, the path "train_amp"): the
        loss is finite and falls, K2-K4 launch 12 times a step, all in
        the path's type."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import hapi, io, nn
        from paddle_tpu_torch.framework import monitor
        B, S = TRAIN_SHAPE["B"], TRAIN_SHAPE["S"]
        steps = TRAIN_STEPS
        path = "train" if amp_level is None else "train_amp"
        dtype = "float32" if amp_level is None else "bfloat16"
        net, ids, opt = self._gpt_train_setup()
        cfg = net.gpt.config
        data = io.TensorDataset([ids[:, :-1], ids[:, 1:]])
        model = hapi.Model(net).prepare(opt, nn.CrossEntropyLoss(),
                                        amp_configs=amp_level)

        class Steps(hapi.callbacks.Callback):
            """Loss handles and a CUDA event at every step's end: the
            device timeline of the steps, with no host wait in the loop."""
            def __init__(self):
                super().__init__()
                self.losses, self.events = [], []

            def on_train_batch_end(self, step, logs=None):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
                self.losses.append(logs["loss"])

        rec = Steps()
        log_freq = 10
        syncs0 = monitor.stat_get("STAT_train_host_syncs")
        torch.cuda.synchronize()
        # the main path starts here: every launch count from 0
        self.zero_launches()
        t0 = time.perf_counter()
        model.fit(data, batch_size=B, epochs=1, shuffle=True,
                  log_freq=log_freq, verbose=0, num_iters=steps,
                  callbacks=[rec])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.record_path(path)
        by_dtype = self.path_dtype_launches[path]
        syncs = monitor.stat_get("STAT_train_host_syncs") - syncs0
        losses = [float(x) for x in rec.losses]
        step_ms = [a.elapsed_time(b) for a, b in zip(rec.events,
                                                     rec.events[1:])]
        steady = sorted(step_ms[1:])   # the steps after the first two
        p50 = steady[len(steady) // 2]
        label = "fp32" if amp_level is None else f"AMP {amp_level} bf16"
        print(f"{path} on {self.smi}: GPT-2 small {label} dropout "
              f"{DROPOUT}, batch {B} x {S}, {steps} steps in {wall:.2f} s "
              f"wall (first step included)")
        print("per-step loss: " + " ".join(f"{x:.4f}" for x in losses))
        print(f"loss first {losses[0]:.4f} last {losses[-1]:.4f}; step wall "
              f"p50 {p50:.2f} ms (device timeline, steps 3-{steps}), "
              f"{B * S / p50 * 1e3:.0f} tokens/s; host syncs {syncs}; "
              f"launches fwd {launches['flash_fwd']} dq "
              f"{launches['flash_bwd_dq']} dkv {launches['flash_bwd_dkv']}; "
              f"by type {by_dtype['flash_fwd']}")
        self.details[path] = dict(
            losses=losses, step_ms=step_ms, step_ms_p50=p50,
            tokens_per_s=B * S / p50 * 1e3, wall_s=wall, host_syncs=syncs,
            launches=launches, launches_by_dtype=by_dtype)
        assert all(np.isfinite(losses)), "non-finite training loss"
        assert np.mean(losses[-3:]) < losses[0] - 1.0, "the loss did not fall"
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert launches[name] == cfg.num_layers * steps, \
                f"{name} launched {launches[name]} times, expected " \
                f"{cfg.num_layers} x {steps}"
            assert by_dtype[name] == {dtype: cfg.num_layers * steps}, \
                f"{name} launched {by_dtype[name]}, all {dtype} expected"
        assert launches["paged_attention"] == 0
        assert syncs <= -(-steps // log_freq) + 1, f"{syncs} host syncs"
        if self.args.profile:
            self.profile_train_step(model, ids[:B], path)
        del model, net, opt
        torch.cuda.empty_cache()

    def step_parity(self):
        """One train_batch (update=False: gradients kept) through the
        flash kernels against one through FLAGS_use_flash_attention=False
        from the same weights, dropout 0, [2, 1024], fp32. Tolerances:
        loss rtol 1e-5; each parameter's gradient max abs difference
        <= 1e-3 x its largest |gradient| + 1e-6 x the largest |gradient|
        of the model (summation order only; the floor is for the key
        biases, whose exact gradient is 0 — a key bias shifts every score
        of a row alike — so what both paths give there is rounding)."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import hapi, nn, optimizer
        from paddle_tpu_torch.framework.flags import set_flags
        from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
        net = GPTForCausalLM(GPTConfig(dropout=0.0), device="cuda", seed=0)
        opt = optimizer.AdamW(1e-4)
        model = hapi.Model(net).prepare(opt, nn.CrossEntropyLoss())
        ids = torch.from_numpy(np.random.RandomState(1).randint(
            0, net.gpt.config.vocab_size, size=(2, 1025)))

        def one():
            self.zero_launches()
            (lv,), _ = model.train_batch([ids[:, :-1]], [ids[:, 1:]],
                                         update=False)
            grads = {n: p.grad.clone() for n, p in net.named_parameters()}
            opt.clear_grad()
            return float(lv), grads, self.read_launches()

        lf, gf, nf = one()
        set_flags({"FLAGS_use_flash_attention": False})
        try:
            lp, gp, np_ = one()
        finally:
            set_flags({"FLAGS_use_flash_attention": True})
        floor = 1e-6 * max(g.abs().max().item() for g in gp.values())
        worst = max(((gf[n] - gp[n]).abs().max().item()
                     / (1e-3 * gp[n].abs().max().item() + floor), n)
                    for n in gp)
        print(f"step parity [2,1024] dropout 0: loss flash {lf:.6f} plain "
              f"{lp:.6f}; worst gradient max_abs_err / its tolerance "
              f"{worst[0]:.3e} ({worst[1]}); launches flash "
              f"{nf['flash_fwd']}/{nf['flash_bwd_dq']}/"
              f"{nf['flash_bwd_dkv']}, plain {np_['flash_fwd']}/"
              f"{np_['flash_bwd_dq']}/{np_['flash_bwd_dkv']}")
        self.details["step_parity"] = dict(loss_flash=lf, loss_plain=lp,
                                           worst_grad_over_tol=worst[0],
                                           worst_param=worst[1])
        assert abs(lf - lp) <= 1e-5 * abs(lp), "step-parity loss differs"
        assert worst[0] <= 1.0, f"step-parity gradient {worst[1]} differs"
        L = net.gpt.config.num_layers
        assert (nf["flash_fwd"], nf["flash_bwd_dq"], nf["flash_bwd_dkv"]) \
            == (L, L, L), nf
        assert (np_["flash_fwd"], np_["flash_bwd_dq"],
                np_["flash_bwd_dkv"]) == (0, 0, 0), np_

    def train_fp16(self):
        """GPT-2 small trained TRAIN_STEPS steps in float16 AMP (the path
        "train_fp16"): hapi's AMP is bfloat16, as the JAX package's, so
        the loop is written out: forward and loss under
        amp.auto_cast(dtype="float16"), GradScaler scale / step inside
        the block (C9), the LR stepped each step; _gpt_train_setup's
        model, data and optimizer, batches in order. The loss is finite
        and falls, K2-K4 launch 12 times a step, all in fp16; steps the
        scaler skips on a non-finite gradient are counted."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import amp, nn
        B, steps = TRAIN_SHAPE["B"], TRAIN_STEPS
        net, ids, opt = self._gpt_train_setup()
        opt._set_parameters(net.named_parameters())
        L = net.gpt.config.num_layers
        loss_fn = nn.CrossEntropyLoss()
        scaler = amp.GradScaler()
        batches = torch.from_numpy(ids).cuda().split(B)
        net.train()
        losses, events, skipped = [], [], 0
        torch.cuda.synchronize()
        # the main path starts here: every launch count from 0
        self.zero_launches()
        t0 = time.perf_counter()
        for xy in batches:
            with amp.auto_cast(dtype="float16"):
                lv = loss_fn(net(xy[:, :-1]), xy[:, 1:]).float().mean()
                scaler.scale(lv).backward()
                n = opt._global_step
                scaler.step(opt)
                skipped += opt._global_step == n
            opt.clear_grad()
            opt._lr.step()
            losses.append(lv.detach())
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.record_path("train_fp16")
        by_dtype = self.path_dtype_launches["train_fp16"]
        losses = [float(x) for x in losses]
        step_ms = sorted(a.elapsed_time(b) for a, b in zip(events[1:],
                                                            events[2:]))
        p50 = step_ms[len(step_ms) // 2]
        print(f"train_fp16 on {self.smi}: GPT-2 small AMP float16 dropout "
              f"{DROPOUT}, batch {B} x {TRAIN_SHAPE['S']}, {steps} steps "
              f"in {wall:.2f} s wall; loss first {losses[0]:.4f} last "
              f"{losses[-1]:.4f}; step wall p50 {p50:.2f} ms (device "
              f"timeline, steps 3-{steps}); scale {scaler.get_scale():g}, "
              f"{skipped} steps skipped; launches by type "
              f"{by_dtype['flash_fwd']}")
        print("per-step loss: " + " ".join(f"{x:.4f}" for x in losses))
        self.details["train_fp16"] = dict(
            losses=losses, step_ms_p50=p50, wall_s=wall, skipped=skipped,
            scale=scaler.get_scale(), launches_by_dtype=by_dtype)
        assert all(np.isfinite(losses)), "non-finite fp16 training loss"
        assert np.mean(losses[-3:]) < losses[0] - 1.0, \
            "the fp16 loss did not fall"
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert launches[name] == L * steps, (name, launches[name])
            assert by_dtype[name] == {"float16": L * steps}, by_dtype[name]
        del net, opt
        torch.cuda.empty_cache()

    def amp_step_parity(self, dtype):
        """One AMP step of GPT-2 small at [2, 1024], dropout 0, through
        K2-K4 against one with FLAGS_use_flash_attention=False under the
        same AMP, from the same weights. bfloat16: hapi's train_batch
        (update=False) under amp_configs="O1". float16: hapi's AMP is
        bfloat16, as the JAX package's, so the step is written out:
        forward and loss under amp.auto_cast(dtype="float16"),
        GradScaler.scale(loss).backward() and GradScaler.unscale_ (no
        gradient may overflow). Both paths round at other places in the
        16-bit type (the kernels keep S and P's sums in fp32, the plain
        path rounds S, P and O), so the limits are the type's: loss rtol
        AMP_LOSS_RTOL; each parameter's gradient within AMP_GRAD_SHARE x
        its largest |gradient| + 1e-3 x the model's largest (the floor is
        for the key biases, whose exact gradient is 0)."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import amp, hapi, nn, optimizer
        from paddle_tpu_torch.framework.flags import set_flags
        from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
        net = GPTForCausalLM(GPTConfig(dropout=0.0), device="cuda", seed=0)
        opt = optimizer.AdamW(1e-4)
        loss_fn = nn.CrossEntropyLoss()
        model = hapi.Model(net).prepare(opt, loss_fn, amp_configs="O1")
        ids = torch.from_numpy(np.random.RandomState(1).randint(
            0, net.gpt.config.vocab_size, size=(2, 1025)))
        x, y = ids[:, :-1].cuda(), ids[:, 1:].cuda()
        scaler = amp.GradScaler()

        def one():
            self.zero_launches()
            if dtype == "bfloat16":
                (lv,), _ = model.train_batch([x], [y], update=False)
            else:
                net.train()
                with amp.auto_cast(dtype="float16"):
                    lv = loss_fn(net(x), y).float().mean()
                    scaler.scale(lv).backward()
                    scaler.unscale_(opt)
                assert not scaler._found_inf, "fp16 gradients overflowed"
            grads = {n: p.grad.clone() for n, p in net.named_parameters()}
            opt.clear_grad()
            return float(lv.detach()), grads, self.read_launches_by_dtype()

        lf, gf, nf = one()
        set_flags({"FLAGS_use_flash_attention": False})
        try:
            lp, gp, np_ = one()
        finally:
            set_flags({"FLAGS_use_flash_attention": True})
        share = AMP_GRAD_SHARE[dtype]
        floor = 1e-3 * max(g.abs().max().item() for g in gp.values())
        worst = max(((gf[n] - gp[n]).abs().max().item()
                     / (share * gp[n].abs().max().item() + floor), n)
                    for n in gp)
        kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        print(f"AMP {dtype} step parity [2,1024] dropout 0: loss flash "
              f"{lf:.6f} plain {lp:.6f} (rtol {AMP_LOSS_RTOL[dtype]}); "
              f"worst gradient max_abs_err / its tolerance {worst[0]:.3e} "
              f"({worst[1]}); launches by type flash "
              f"{[nf[k] for k in kernels]}, plain {[np_[k] for k in kernels]}")
        self.details[f"amp_step_parity_{dtype}"] = dict(
            loss_flash=lf, loss_plain=lp, worst_grad_over_tol=worst[0],
            worst_param=worst[1], launches=nf)
        assert abs(lf - lp) <= AMP_LOSS_RTOL[dtype] * abs(lp), \
            f"AMP {dtype} step-parity loss differs"
        assert worst[0] <= 1.0, \
            f"AMP {dtype} step-parity gradient {worst[1]} differs"
        L = net.gpt.config.num_layers
        assert all(nf[k] == {dtype: L} for k in kernels), nf
        assert all(np_[k] == {} for k in kernels), np_
        del model, net, opt
        torch.cuda.empty_cache()

    def profile_train_step(self, model, ids, path):
        """torch.profiler over 3 train steps: wall per step, device busy
        share, device time by kernel, and the flash kernels' and the
        GEMMs' shares (GEMM: cuBLAS/CUTLASS kernel names, _GEMM)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        x, y = [ids[:, :-1]], [ids[:, 1:]]
        model.train_batch(x, y)
        torch.cuda.synchronize()
        steps = 3
        t0 = time.perf_counter()
        for _ in range(steps):
            model.train_batch(x, y)
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                model.train_batch(x, y)
            torch.cuda.synchronize()
        dev, top = _device_table(torch, prof, steps, bare_ms)
        import re
        flash = sum(ms for key, ms, _ in top if "flash_" in key)
        gemm = sum(ms for key, ms, _ in top if re.search(_GEMM, key))
        print(f"{path} step, batch {ids.shape[0]} x {ids.shape[1] - 1}: "
              f"wall {bare_ms / steps:.2f} ms/step unprofiled; device busy "
              f"{dev:.2f} ms/step = {dev / (bare_ms / steps) * 100:.1f}% of "
              f"it; flash kernels {flash:.2f} ms/step = "
              f"{flash / dev * 100:.1f}%, GEMMs {gemm:.2f} ms/step = "
              f"{gemm / dev * 100:.1f}% of the device time")
        self.details[f"profile_{path}"] = dict(
            steps=steps, wall_ms_per_step=bare_ms / steps,
            device_ms_per_step=dev, flash_ms_per_step=flash,
            gemm_ms_per_step=gemm, top=top[:12])

    # -- 7. packing ---------------------------------------------------------------

    def packing(self):
        """The bench's packed LM trained through hapi.Model.fit, packed and
        padded; then the loss parity and the splash-vs-dense step parity
        (see the module docstring)."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import hapi, io, nn, optimizer
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.nn import functional as F
        from paddle_tpu_torch.static import InputSpec
        T, DIM, HEADS, VOCAB, BS = (PACK[k] for k in
                                    ("T", "DIM", "HEADS", "VOCAB", "BS"))
        torch.cuda.empty_cache()
        lengths = _bench_lengths(np)
        seqs = _motif_seqs(np, lengths)
        rows = io.suggest_rows(lengths, BS, T, headroom=PACK["HEADROOM"])

        class SeqData(io.Dataset):
            def __init__(self, items):
                self.items = items

            def __len__(self):
                return len(self.items)

            def __getitem__(self, i):
                return self.items[i]

        class PackedLM(torch.nn.Module):
            """bench.py:2365-2387: embedding + position embedding, one
            causal-within-segment attention block, LM head; the port's nn
            layers, so AMP casts its projections."""

            def __init__(self):
                super().__init__()
                self.emb = nn.Embedding(VOCAB, DIM)
                self.pos = nn.Embedding(T, DIM)
                self.qkv = nn.Linear(DIM, 3 * DIM)
                self.proj = nn.Linear(DIM, DIM)
                self.head = nn.Linear(DIM, VOCAB)

            def forward(self, toks, seg, pos):
                x = self.emb(toks) + self.pos(pos)
                B, S = toks.shape
                qkv = self.qkv(x).reshape(B, S, 3, HEADS, DIM // HEADS) \
                    .permute(2, 0, 3, 1, 4)
                o = F.scaled_dot_product_attention(
                    qkv[0], qkv[1], qkv[2], is_causal=True, segment_ids=seg)
                return self.head(x + self.proj(
                    o.transpose(1, 2).reshape(B, S, DIM)))

        def make_model(seed, amp_level=None):
            torch.manual_seed(seed)
            net = PackedLM().cuda()
            spec = [InputSpec([None, T], "int64", "toks"),
                    InputSpec([None, T], "int32", "seg"),
                    InputSpec([None, T], "int32", "pos")]
            return net, hapi.Model(
                net, inputs=spec,
                labels=[InputSpec([None, T], "int64", "labels")]).prepare(
                    optimizer.Adam(1e-3), nn.CrossEntropyLoss(),
                    amp_configs=amp_level)

        class Steps(hapi.callbacks.Callback):
            """Loss handles, the real tokens of each step's pack (the
            collator's last pack is the one just trained: the loader
            collates in this process) and a CUDA event at each step's
            end."""
            def __init__(self, coll):
                super().__init__()
                self.coll = coll
                self.losses, self.tokens, self.events = [], [], []

            def on_train_batch_end(self, step, logs=None):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
                self.losses.append(logs["loss"])
                self.tokens.append(self.coll.last_fill_ratio
                                   * self.coll.rows * T)

        def arm(name, policy, pack_rows, batch, amp_level=None):
            coll = io.PackingCollator(T, pack_rows, policy=policy)
            loader = io.DataLoader(SeqData(seqs), batch_size=batch,
                                   shuffle=False, collate_fn=coll)
            net, model = make_model(0, amp_level)
            rec = Steps(coll)
            c0 = {c: monitor.stat_get(c) for c in (
                "STAT_packing_tokens", "STAT_packing_slots",
                "STAT_packing_dropped_seqs", "STAT_tail_pad_batches")}
            torch.cuda.synchronize()
            # the main path starts here: every launch count from 0
            self.zero_launches()
            t0 = time.perf_counter()
            model.fit(loader, epochs=1, shuffle=False, log_freq=10,
                      verbose=0, callbacks=[rec])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = self.record_path(name)
            d = {c: monitor.stat_get(c) - v for c, v in c0.items()}
            losses = [float(x) for x in rec.losses]
            steps = len(losses)
            step_ms = [a.elapsed_time(b) for a, b in zip(rec.events,
                                                         rec.events[1:])]
            p50 = sorted(step_ms)[len(step_ms) // 2]
            tokens = d["STAT_packing_tokens"]
            steady = sum(rec.tokens[1:]) / sum(step_ms) * 1e3
            r = dict(rows=pack_rows, steps=steps, wall_s=wall,
                     real_tokens=tokens, fill=tokens / d["STAT_packing_slots"],
                     dropped=d["STAT_packing_dropped_seqs"],
                     effective_tokens_per_s=tokens / wall,
                     steady_effective_tokens_per_s=steady,
                     step_ms_p50=p50, losses=losses, launches=launches)
            print(f"packing {name} on {self.smi}: [{pack_rows}, {T}] x "
                  f"{steps} steps, {tokens} real tokens, fill "
                  f"{r['fill']:.4f}, dropped {r['dropped']}; epoch wall "
                  f"{wall:.3f} s = {tokens / wall:.0f} effective tokens/s "
                  f"(steps 2-{steps} on the device timeline: {steady:.0f}); "
                  f"step wall p50 {p50:.3f} ms; launches per step K5 "
                  f"{launches['splash_fwd'] / steps:g} K6 "
                  f"{launches['splash_bwd_dq'] / steps:g} K7 "
                  f"{launches['splash_bwd_dkv'] / steps:g}")
            print(f"  loss first {losses[0]:.4f} last {losses[-1]:.4f}: "
                  + " ".join(f"{x:.3f}" for x in losses[::max(1,
                                                             steps // 16)]))
            assert all(np.isfinite(losses)), f"{name}: non-finite loss"
            assert np.mean(losses[-3:]) < losses[0] - 1.0, \
                f"{name}: the loss did not fall"
            dtype = "float32" if amp_level is None else "bfloat16"
            by_dtype = self.path_dtype_launches[name]
            r["launches_by_dtype"] = by_dtype
            for k in ("splash_fwd", "splash_bwd_dq", "splash_bwd_dkv"):
                assert launches[k] == steps, \
                    f"{name}: {k} launched {launches[k]} times in {steps} steps"
                assert by_dtype[k] == {dtype: steps}, \
                    f"{name}: {k} launched {by_dtype[k]}, all {dtype} expected"
            assert launches["flash_fwd"] == launches["paged_attention"] == 0
            assert d["STAT_tail_pad_batches"] == 0, "a batch was row-padded"
            del model, net
            torch.cuda.empty_cache()
            return r

        packed = arm("packing", "first_fit", rows, BS)
        padded = arm("padded", "pad", PACK["PAD_ROWS"], PACK["PAD_ROWS"])
        # one packed epoch under AMP O1: bf16 projections, K5-K7 in bf16
        packed_amp = arm("packing_amp", "first_fit", rows, BS, "O1")
        # the same packs under auto_cast(dtype="float16") + GradScaler
        packed_fp16 = self.packing_fp16(make_model, seqs, rows)
        print(f"packed AMP O1 / fp32 effective tokens/s: "
              f"{packed_amp['effective_tokens_per_s'] / packed['effective_tokens_per_s']:.3f} "
              f"(epoch wall)")
        gain = packed["effective_tokens_per_s"] / \
            padded["effective_tokens_per_s"]
        print(f"packed / padded effective tokens/s: {gain:.3f} (epoch wall), "
              f"{packed['steady_effective_tokens_per_s'] / padded['steady_effective_tokens_per_s']:.3f} "
              f"(device timeline); fill {packed['fill']:.4f} vs "
              f"{padded['fill']:.4f}")

        # parity (bench.py:2444-2466): the same 8 sequences packed and
        # padded, fresh identical models, token-normalised losses
        sample = seqs[:8]
        pk = io.PackingCollator(T, io.suggest_rows(
            [len(x[0]) for x in sample], 8, T, headroom=1.5))(sample)
        pd = io.PackingCollator(T, 8, policy="pad")(sample)
        assert pk[4].sum() == pd[4].sum(), "the parity pack dropped a sequence"

        def loss_of(batch):
            _, model = make_model(1)
            return float(model.eval_batch(list(batch[:3]), [batch[3]],
                                          loss_mask=batch[4])[0])
        la, lb = loss_of(pk), loss_of(pd)
        print(f"packed vs padded loss, 8 sequences: {la:.6f} vs {lb:.6f}, "
              f"|diff| {abs(la - lb):.3e} (tol 1e-3)")
        assert abs(la - lb) < 1e-3, "packed and padded losses differ"
        self.details["packing"] = dict(packed=packed, padded=padded,
                                       packed_amp=packed_amp,
                                       packed_fp16=packed_fp16, gain=gain,
                                       parity=(la, lb))
        self.splash_step_parity(make_model, seqs[:BS], rows)
        if self.args.profile:
            for amp_level in (None, "O1"):
                self.profile_packed_step(make_model, seqs[:BS], rows,
                                         amp_level)

    def packing_fp16(self, make_model, seqs, rows):
        """The packed LM trained one epoch of packs in float16 AMP (the
        path "packing_fp16"): hapi's AMP is bfloat16, as the JAX
        package's, so the step is written out as train_fp16's is: the
        forward and the token-masked loss under
        amp.auto_cast(dtype="float16"), GradScaler scale / step inside
        the block (C9). The loss is finite and falls (the mean of the
        last 3 below the first by more than 1), K5-K7 launch once a step
        each, all counted in float16; fewer than half the steps may be
        skipped by the scaler."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import amp, io
        coll = io.PackingCollator(PACK["T"], rows)
        BS = PACK["BS"]
        packs = [coll(seqs[i:i + BS]) for i in range(0, len(seqs), BS)]
        net, model = make_model(0)
        opt = model._optimizer
        scaler = amp.GradScaler()
        net.train()
        losses, skipped = [], 0
        torch.cuda.synchronize()
        # the main path starts here: every launch count from 0
        self.zero_launches()
        t0 = time.perf_counter()
        for b in packs:
            ins = model._place(list(b[:3]))
            lbs = model._place([b[3]])
            with amp.auto_cast(dtype="float16"):
                lv = model._step_loss(net(*ins), lbs, b[4])
                scaler.scale(lv).backward()
                n = opt._global_step
                scaler.step(opt)
                skipped += opt._global_step == n
            opt.clear_grad()
            losses.append(lv.detach())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.record_path("packing_fp16")
        by_dtype = self.path_dtype_launches["packing_fp16"]
        losses = [float(x) for x in losses]
        steps = len(losses)
        print(f"packing_fp16 on {self.smi}: [{rows}, {PACK['T']}] x {steps} "
              f"steps in {wall:.3f} s wall; loss first {losses[0]:.4f} last "
              f"{losses[-1]:.4f}; scale {scaler.get_scale():g}, {skipped} "
              f"steps skipped; K5-K7 launches by type "
              f"{by_dtype['splash_fwd']}/{by_dtype['splash_bwd_dq']}/"
              f"{by_dtype['splash_bwd_dkv']}")
        assert all(np.isfinite(losses)), "non-finite fp16 packed loss"
        assert np.mean(losses[-3:]) < losses[0] - 1.0, \
            "the fp16 packed loss did not fall"
        assert skipped < steps // 2, f"{skipped} of {steps} steps skipped"
        for k in ("splash_fwd", "splash_bwd_dq", "splash_bwd_dkv"):
            assert launches[k] == steps, (k, launches[k], steps)
            assert by_dtype[k] == {"float16": steps}, (k, by_dtype[k])
        del model, net
        torch.cuda.empty_cache()
        return dict(steps=steps, wall_s=wall, losses=losses,
                    skipped=skipped, scale=scaler.get_scale(),
                    launches_by_dtype=by_dtype)

    def profile_packed_step(self, make_model, sample, rows, amp_level):
        """torch.profiler over 5 packed train steps (collate included, as
        fit runs it; fp32, or under amp_configs=`amp_level`): wall per
        step, device busy share, device time by kernel, and the splash
        kernels' share."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from paddle_tpu_torch import io
        coll = io.PackingCollator(PACK["T"], rows)
        _, model = make_model(3, amp_level)

        def step():
            b = coll(sample)
            model.train_batch(list(b[:3]), [b[3]], loss_mask=b[4])
        step()
        torch.cuda.synchronize()
        steps = 5
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        dev, top = _device_table(torch, prof, steps, bare_ms)
        splash = sum(ms for key, ms, _ in top if "splash_" in key)
        label = "fp32" if amp_level is None else f"AMP {amp_level}"
        print(f"packed train step {label} [{rows}, {PACK['T']}]: wall "
              f"{bare_ms / steps:.2f} ms/step unprofiled; device busy "
              f"{dev:.2f} ms/step = {dev / (bare_ms / steps) * 100:.1f}% of "
              f"it; splash kernels {splash:.3f} ms/step = "
              f"{splash / dev * 100:.1f}% of the device time")
        self.details[f"profile_packed_{label}"] = dict(
            steps=steps, wall_ms_per_step=bare_ms / steps,
            device_ms_per_step=dev, splash_ms_per_step=splash, top=top[:12])

    def splash_step_parity(self, make_model, sample, rows):
        """One train_batch (update=False) on a pack through K5-K7 against
        one with FLAGS_use_splash_attention off (the dense segment-masked
        attention), same weights, with step_parity's rule: loss rtol 1e-5
        and each gradient within 1e-3 x its max + 1e-6 x the model's
        max."""
        from paddle_tpu_torch import io
        from paddle_tpu_torch.framework.flags import set_flags
        pack = io.PackingCollator(PACK["T"], rows)(sample)
        net, model = make_model(2)

        def one():
            self.zero_launches()
            (lv,), _ = model.train_batch(list(pack[:3]), [pack[3]],
                                         update=False, loss_mask=pack[4])
            grads = {n: p.grad.clone() for n, p in net.named_parameters()}
            model._optimizer.clear_grad()
            return float(lv), grads, self.read_launches()

        ls, gs, ns = one()
        set_flags({"FLAGS_use_splash_attention": False})
        try:
            ld, gd, nd = one()
        finally:
            set_flags({"FLAGS_use_splash_attention": True})
        floor = 1e-6 * max(g.abs().max().item() for g in gd.values())
        worst = max(((gs[n] - gd[n]).abs().max().item()
                     / (1e-3 * gd[n].abs().max().item() + floor), n)
                    for n in gd)
        print(f"splash step parity [{rows}, {PACK['T']}]: loss splash "
              f"{ls:.6f} dense {ld:.6f}; worst gradient max_abs_err / its "
              f"tolerance {worst[0]:.3e} ({worst[1]}); launches splash "
              f"{ns['splash_fwd']}/{ns['splash_bwd_dq']}/"
              f"{ns['splash_bwd_dkv']}, dense {nd['splash_fwd']}/"
              f"{nd['splash_bwd_dq']}/{nd['splash_bwd_dkv']}")
        self.details["splash_step_parity"] = dict(
            loss_splash=ls, loss_dense=ld, worst_grad_over_tol=worst[0],
            worst_param=worst[1])
        assert abs(ls - ld) <= 1e-5 * abs(ld), "step-parity loss differs"
        assert worst[0] <= 1.0, f"step-parity gradient {worst[1]} differs"
        assert (ns["splash_fwd"], ns["splash_bwd_dq"],
                ns["splash_bwd_dkv"]) == (1, 1, 1), ns
        assert (nd["splash_fwd"], nd["splash_bwd_dq"],
                nd["splash_bwd_dkv"]) == (0, 0, 0), nd

    def kernels_line(self):
        srcs = {"paged_attention": (
                    "paddle_tpu_torch/csrc/paged_attention.cu",
                    "jax/experimental/pallas/ops/tpu/paged_attention/"
                    "paged_attention_kernel.py:376 (dispatched at "
                    "paddle_tpu/ops/paged_ops.py:239)"),
                "flash_fwd": ("paddle_tpu_torch/csrc/flash_fwd.cu",
                              "paddle_tpu/ops/pallas_ops.py:143"),
                "flash_bwd_dq": ("paddle_tpu_torch/csrc/flash_bwd_dq.cu",
                                 "paddle_tpu/ops/pallas_ops.py:207"),
                "flash_bwd_dkv": ("paddle_tpu_torch/csrc/flash_bwd_dkv.cu",
                                  "paddle_tpu/ops/pallas_ops.py:251"),
                "splash_fwd": ("paddle_tpu_torch/csrc/splash_fwd.cu",
                               "paddle_tpu/ops/splash_ops.py:139"),
                "splash_bwd_dq": ("paddle_tpu_torch/csrc/splash_bwd_dq.cu",
                                  "paddle_tpu/ops/splash_ops.py:201"),
                "splash_bwd_dkv": ("paddle_tpu_torch/csrc/splash_bwd_dkv.cu",
                                   "paddle_tpu/ops/splash_ops.py:242")}
        out = []
        for name, (src, rep) in srcs.items():
            # the kernel in all (its fp32 row), then one entry per 16-bit
            # type a row was kept for ("flash_fwd.bfloat16"), launches
            # counted in that type
            for key in [name] + sorted(k for k in self.kernel_rows
                                       if k.startswith(name + ".")):
                r = self.kernel_rows.get(key, {})
                if key == name:
                    n = sum(p.get(name, 0)
                            for p in self.path_launches.values())
                else:
                    dt = key.split(".", 1)[1]
                    n = sum(p.get(name, {}).get(dt, 0)
                            for p in self.path_dtype_launches.values())
                out.append({"name": key, "route": "cuda", "source": src,
                            "replaces": rep, "launches": n,
                            "max_abs_err": r.get("max_abs_err"),
                            "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                            "bound_ms": r.get("bound_ms"),
                            "bound_by": r.get("bound_by"),
                            "library_ms": r.get("library_ms")})
        return {"kernels": out}


def _ptxas_kernels(log):
    """(name, registers, (spill store bytes, spill load bytes)) of every
    kernel in an `nvcc -Xptxas -v` log, the name demangled as far as
    `kernel<type, D>`."""
    import re
    out, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = _kernel_name(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def _kernel_name(mangled):
    """`paged_split_kernel<float, 80>` from its Itanium-mangled name (a
    kernel in an anonymous namespace, templated on a type and an int:
    `_ZN<n><namespace><m><name>I<type>Li<D>E...`); K2-K7's padded
    instantiations (a third, bool argument `Lb1E`) read
    `flash_fwd_kernel<float, 96, pad>`."""
    import re
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    base = rest[m.end():m.end() + int(m.group(1))]
    t = re.match(r"I(f|13__nv_bfloat16|6__half)Li(\d+)E(Lb([01])E)?",
                 rest[m.end() + int(m.group(1)):])
    if not t:
        return base
    ty = {"f": "float", "13__nv_bfloat16": "bfloat16",
          "6__half": "float16"}[t.group(1)]
    pad = ", pad" if t.group(4) == "1" else ""
    return f"{base}<{ty}, {t.group(2)}{pad}>"


def _device_table(torch, prof, steps, wall_ms):
    """Device ms per step over a profiled window of `steps`, and the top
    kernels as (name, ms per step, calls per step), printed."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    ev = [e for e in prof.key_averages()
          if getattr(e, "device_type", None)
          == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    dev = sum(dev_us(e) for e in ev) / 1e3 / steps
    print(f"  device {dev:.3f} ms/step over {wall_ms / steps:.3f} ms/step "
          f"wall; {sum(e.count for e in ev) / steps:.0f} kernels/step")
    top = sorted(ev, key=dev_us, reverse=True)[:12]
    for e in top:
        print(f"  {dev_us(e) / 1e3 / steps:8.4f} ms/step "
              f"{e.count / steps:6.1f} calls/step  {e.key[:90]}")
    return dev, [(e.key, dev_us(e) / 1e3 / steps, e.count / steps)
                 for e in sorted(ev, key=dev_us, reverse=True)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="build and check the kernels only (phases 1-3)")
    ap.add_argument("--profile", action="store_true",
                    help="after serving, profile prefill and decode steps; "
                    "after training, one train step; after packing, one "
                    "packed train step")
    ap.add_argument("--details", default="",
                    help="also write every measurement as JSON to this path")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (REPO / "paddle_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: paddle_tpu_torch not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sm = Smoke(args)
    sm.phase("card", sm.card)
    built = sm.phase("build", sm.build)
    if built:
        sm.phase("kernels", sm.kernels)
        if not args.kernels:
            sm.phase("model", sm.model)
            sm.phase("serving", sm.serving)
            sm.phase("features", sm.features)
            sm.phase("quant", sm.quant)
            sm.phase("tier", sm.tier)
            sm.phase("fleet", sm.fleet)
            if args.profile:
                sm.phase("profile", sm.profile)
            sm.phase("train", sm.train)
            sm.phase("packing", sm.packing)
    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)),
                    exist_ok=True)
        with open(args.details, "w") as f:
            json.dump({"card": sm.smi, "details": sm.details,
                       "path_launches": sm.path_launches}, f, indent=1)
    if sm.failures or args.kernels:
        print(f"chip_smoke: failed phases {sm.failures}" if sm.failures
              else "chip_smoke: kernel phases only, no result")
        return 1 if sm.failures else 0
    print(json.dumps(sm.kernels_line()))
    print(sm.smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
