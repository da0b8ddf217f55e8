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
              3's slots at head dims 80, 96 and 256; fp32 and bf16; the
              split count per row), K2 flash forward (serving
              shape, fp32, bf16 and fp16, and the training shape with
              dropout), K3 flash dQ and K4 flash
              dK/dV (training shape, dropout 0 and 0.1, fp32, bf16 and
              fp16; head dims 128 and 32 at the train width, fp32 and
              bf16; Sq 1024 != Sk 1536), with the achieved TFLOP/s;
              FlashAttention's gradients against autograd through the
              plain forward; gradients reaching q/k/v through K2 (C4)
 4. model     GPT-2 small (GPTConfig() defaults, fp32, seed 0): a [2,1024]
              full forward through the flash kernel against the plain path
 5. serving   GenerationEngine (8 slots, page 16, buckets 16/64/256/1024)
              serving 16 greedy streamed requests, some joining while
              others decode; every output token-identical to the port's
              own generate(); kernel launch counts read off this run;
              then a GPT with head dim 96 (hidden 768, 8 heads, 2 layers)
              serving 4 requests through K1, token-identical to generate()
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
              amp_configs="O1" (K5-K7 counted in bf16, the loss falls);
              then packed-vs-padded loss parity on 8 sequences and one
              train_batch through K5-K7 against one through the dense
              segment-masked path
Phase 3 also holds the splash kernels to their plain versions: K5 splash
forward, K6 splash dQ and K7 splash dK/dV at GPT-2 small's attention
width (B 8, H 12, S 1024, D 64) and at the packing phase's shape, with
segment ids from io.PackingCollator over the bench's lengths (causal, p
0 and 0.1, fp32 and bf16, and a non-causal case whose absent segment
gives exact zero rows; the packing phase's shape in fp32 and bf16), with
the share of K5's (warp band, key tile) pairs that take its mask-free
path, the share of the 16x8 sub-tiles of K6's and K7's tiles that can
hold an allowed pair and, where the library call runs, K5 against the
library's forward and K6 + K7 against its whole backward;
SplashAttention's gradients against autograd through the plain forward.
--profile's profiler sessions come after serving, so that run's train
and packing walls carry them; each train path (fp32, AMP) is profiled
over 3 steps with its GEMM share.
Then one JSON line describing the kernels (K2-K4 also as
"flash_fwd.bfloat16"/".float16" rows and K5-K7 as ".bfloat16" rows,
their launches counted in that type), and as the last line
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
K1_SHAPE = dict(B=8, H=12, D=64, P=16, PP=64)
K2_SHAPE = dict(B=2, H=12, S=1024, D=64)
TRAIN_SHAPE = dict(B=8, H=12, S=1024, D=64)   # the train phase's attention
TRAIN_STEPS = 20
DROPOUT = 0.1
# bench.py --mode packing, full size (bench.py:2348-2349, 2428, 2468)
PACK = dict(T=1024, DIM=256, HEADS=4, VOCAB=8192, NSEQ=2048, BS=64,
            HEADROOM=1.15, PAD_ROWS=16)
SPLASH_SHAPE = dict(B=8, H=12, S=1024, D=64)   # GPT-2 small's attention
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
        """K1 against its plain version at three shapes, fp32 and bf16:
        phase 3's (8 slots of random lengths up to 1024), the decode
        profile's (8 slots of 230 tokens) and a long context (2 slots of
        1024); and phase 3's slots at head dims 80, 96 and 256 (ROADMAP
        C7: rows of 20/10, 24/12 and 64/32 16-byte chunks in fp32/bf16).
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
                   for D in (80, 96, 256)]
        rows = []
        for shape, B, lens_in, D in shapes:
            scale = 1.0 / D ** 0.5
            for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2)):
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
        tolerances): at GPT-2 small's attention width, causal, fp32 and
        bf16, p 0 and 0.1, plus a non-causal fp32 case whose kv lacks one
        query segment (those rows must be exactly 0); and at the packing
        phase's shape, causal p 0, bf16 and fp32 (the kernels line's
        row).
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
        cases = [("gpt2", dt, True, p, ids, ids)
                 for dt in ("float32", "bfloat16") for p in (0.0, DROPOUT)]
        packs = self.splash_ids(prow, PACK["BS"])
        cases += [("gpt2", "float32", False, 0.0, ids, absent)]
        cases += [("packed_lm", dt, True, 0.0, packs, None)
                  for dt in ("bfloat16", "float32")]
        rows = {"fwd": [], "dq": [], "dkv": []}
        for shape, name, causal, p, qs, ks in cases:
            ks = qs if ks is None else ks
            Bc, Hc = (B, H) if shape == "gpt2" else (qs.shape[0], ph)
            dtype = getattr(torch, name)
            tol = 1e-4 if name == "float32" else 1e-2
            g = torch.Generator(device="cuda").manual_seed(11 + causal)
            q, k, v, do = (torch.randn(Bc, Hc, S, D, generator=g,
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
            tag = dict(shape=f"{Bc}x{Hc}x{S}x{D}", causal=causal, p=p,
                       absent=ks is not qs, tiles_visited=tiles,
                       pair_share=pairs / full)
            # K5's (warp band, key tile) pairs that take the mask-free path
            # (`_uniform_tiles`), of those its spans visit
            vis, uni = so._uniform_tiles(qs, ks, causal,
                                         32 if D == 128 else 64)
            k5_uniform = int(uni.sum()) / int(vis.sum())
            # the 16x8 sub-tiles of K6's and K7's visited tiles that can
            # hold an allowed pair (`_subtile_mask`): what a sub-tile skip
            # could keep of their product work
            sub = {}
            for kname, tr in (("dq", False), ("dkv", True)):
                vis, live = so._subtile_mask(qs, ks, causal, tr)
                sub[kname] = dict(
                    subtiles_live=int(live.sum()) / int(vis.sum()))
            bh_sd = Bc * Hc * S * D * q.element_size()
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
            fargs = (q, k, v, qs, ks, causal, scale, p, seed)
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
                4 * pairs * D, 4 * bh_sd + row_b + ids_b, lib_fwd,
                device_ms=k5_dev, library_device_ms=lib_fwd_dev,
                uniform_tiles=k5_uniform, **tag))
            del out, lse
            delta = fo._delta(ref, do)
            bargs = (q, k, v, qs, ks, do, ref_lse, delta, causal, scale, p,
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
                6 * pairs * D, 5 * bh_sd + 2 * row_b + ids_b, lib_bwd,
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
                8 * pairs * D, 6 * bh_sd + 2 * row_b + ids_b, lib_bwd,
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
            # the packing phase's cases: fp32 and (its AMP epoch) bf16 at
            # the pack shape
            for dt, sfx in (("float32", ""), ("bfloat16", ".bfloat16")):
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
        rng = np.random.RandomState(0)
        n_req = 16
        lens = [16, 900, 40, 700, 130, 300, 17, 520, 64, 800, 250, 33,
                610, 90, 400, 880]
        prompts = [rng.randint(0, cfg.vocab_size, size=(n,)) for n in lens]
        new = [int(x) for x in rng.randint(32, 65, size=n_req)]
        page, slots = 16, 8
        num_pages = 1 + sum(-(-(s + m) // page)
                            for s, m in zip(lens, new))
        t0 = time.perf_counter()
        eng = GenerationEngine(
            self.gpt, device="cuda", name="chip_smoke", max_slots=slots,
            page_size=page, num_pages=num_pages,
            prefill_buckets=(16, 64, 256, 1024), max_new_tokens=64,
            request_timeout_ms=0)
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
        mismatches = 0
        for i, (p, out) in enumerate(zip(prompts, results)):
            assert out is not None, f"request {i} produced no result"
            assert out.shape == (lens[i] + new[i],), out.shape
            ref = self.gpt.generate(p[None], max_new_tokens=new[i])[0]
            ref = ref.cpu().numpy()
            if not np.array_equal(out, ref):
                mismatches += 1
                step = int(np.nonzero(out != ref)[0][0]) - lens[i]
                with torch.inference_mode():
                    ctx = torch.as_tensor(ref[:lens[i] + step][None],
                                          device="cuda")
                    top2 = torch.topk(self.gpt(ctx)[0, -1], 2).values
                print(f"request {i} (prompt {lens[i]}): first differing "
                      f"step {step}, engine token {out[lens[i] + step]} vs "
                      f"generate {ref[lens[i] + step]}, top-2 logit margin "
                      f"{(top2[0] - top2[1]).item():.3e}")
        assert mismatches == 0, f"{mismatches} requests differ from generate()"
        assert k1 == stats["steps"] * cfg.num_layers, \
            f"paged_attention launches {k1} != steps {stats['steps']} x " \
            f"{cfg.num_layers} layers"
        assert k2 > 0, "flash kernel never launched on the serving path"
        assert eng.stats()["pages"]["pages_in_use"] == 0, "pages leaked"
        assert joined_at is not None and joined_at > 0
        self.serving_d96()

    def serving_d96(self):
        """ROADMAP C7 on the card: a GPT with head dim 96 (hidden 768, 8
        heads, 2 layers; GPT-2 small's vocab, FFN and positions; fp32,
        seed 0) served by GenerationEngine: 4 greedy requests, 8 new
        tokens each, token-identical to the port's generate(), its decode
        attention through K1 (launches counted on this path, one a layer
        a step). Prefill takes the plain attention: the flash kernels are
        built for head dims 32/64/128 (ROADMAP B item 5)."""
        import numpy as np
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
        same = [np.array_equal(o, gpt.generate(p[None], max_new_tokens=new)
                               [0].cpu().numpy())
                for o, p in zip(outs, prompts)]
        print(f"serving head dim 96 (hidden 768, 8 heads, 2 layers): "
              f"{len(prompts)} requests, {len(prompts) * new} tokens in "
              f"{wall:.3f} s, {stats['steps']} decode steps; identical to "
              f"generate(): {sum(same)} of {len(same)}; K1 launches {k1}")
        self.details["serving_d96"] = dict(steps=stats["steps"], k1=k1,
                                           identical=sum(same), wall_s=wall)
        assert all(same), "the D 96 engine differs from generate()"
        assert k1 > 0 and k1 == stats["steps"] * cfg.num_layers, \
            f"K1 launched {k1} times in {stats['steps']} steps"
        del eng, gpt
        self.torch.cuda.empty_cache()

    # -- optional: where the serving time goes ---------------------------------

    def profile(self):
        """Prefill wall time per bucket, then torch.profiler over 20
        decode steps of 8 live sequences: wall per step, device busy
        share, device time by kernel."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        import numpy as np
        from paddle_tpu_torch.models.gpt import gpt_prefill
        from paddle_tpu_torch.serving import GenerationEngine
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
        # the decode step of 8 live slots at ~230 cached tokens each,
        # called on this thread (the profiler sees this thread's launches)
        eng = GenerationEngine(self.gpt, device="cuda", name="profile",
                               max_slots=8, page_size=16, num_pages=8 * 20 + 1,
                               prefill_buckets=(256,), max_new_tokens=64,
                               request_timeout_ms=0)
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
        print(f"decode step, 8 live slots at 230 cached tokens: wall "
              f"{bare_ms / steps:.3f} ms/step unprofiled, "
              f"{wall_ms / steps:.3f} ms/step profiled; device busy "
              f"{dev:.3f} ms/step = {dev / (bare_ms / steps) * 100:.1f}% "
              f"of the unprofiled wall")
        self.details["profile"] = dict(
            steps=steps, wall_ms_per_step=bare_ms / steps,
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
                                       packed_amp=packed_amp, gain=gain,
                                       parity=(la, lb))
        self.splash_step_parity(make_model, seqs[:BS], rows)
        if self.args.profile:
            for amp_level in (None, "O1"):
                self.profile_packed_step(make_model, seqs[:BS], rows,
                                         amp_level)

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
    `_ZN<n><namespace><m><name>I<type>Li<D>E...`)."""
    import re
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    base = rest[m.end():m.end() + int(m.group(1))]
    t = re.match(r"I(f|13__nv_bfloat16|6__half)Li(\d+)E",
                 rest[m.end() + int(m.group(1)):])
    if not t:
        return base
    ty = {"f": "float", "13__nv_bfloat16": "bfloat16",
          "6__half": "float16"}[t.group(1)]
    return f"{base}<{ty}, {t.group(2)}>"


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
            if args.profile:
                sm.phase("profile", sm.profile)
            sm.phase("train", sm.train)
            sm.phase("packing", sm.packing)
    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)),
                    exist_ok=True)
        with open(args.details, "w") as f:
            json.dump({"card": sm.smi, "details": sm.details}, f, indent=1)
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
