#!/usr/bin/env python3
"""A/B variants of the splash kernels (K5, K6, K7) on one GPU.

    python3 kernel_ab.py shipped subtile_skip warp_skip shipped subtile_skip warp_skip
    python3 kernel_ab.py shipped k5_always_test k5_index_order shipped k5_always_test k5_index_order
    python3 kernel_ab.py shipped k5_no_floor k5_two_blocks shipped k5_no_floor k5_two_blocks

Each argument names a variant: `shipped` is paddle_tpu_torch/csrc as it
stands; the others are textual edits of it (VARIANTS below), copied into
build/ab/<name>/ and built there. For each argument in turn (repeat names
to alternate them), K5, K6 and K7 are held to their plain versions and
timed (mean of 20 calls; K6, K7, K3 and K4 by CUDA events around each
call, K5 and K2 by device time, `chip_smoke._time_ms(device=True)`, as
their calls are short enough for the wrapper's host time to show in
event time) beside K2, K3 and K4 at the same
width, in fp32 and bf16, causal, on three id layouts: one segment a row
(the flash kernels' work), packs of the packing bench's lengths at GPT-2
small's attention width [8, 12, 1024, 64], and the packing phase's
[17, 4, 1024, 64]. Each variant's build prints ptxas' registers and
spills for the sources the requested variants edit. Exits 1 if a variant
disagrees with the plain version (fp32 1e-4, bf16 1e-2, x max(1, max
|ref|)).

Variants:
- k5_always_test: K5 runs its per-element segment test on every tile,
  without the mask-free path for one-segment (warp band, key tile) pairs.
- k5_index_order: K5's blocks take the query tiles in index order instead
  of last first.
- k5_no_floor: K5 with no blocks-an-SM floor in its launch bounds.
- k5_two_blocks: K5 with a floor of 2 blocks an SM for every
  instantiation (the shipped floor is 3 where a Q row is 128 bytes or
  less).
- subtile_skip: K6 and K7 test each 16x8 sub-tile (a warp's 16 rows, one
  n8 group of columns) for an allowed pair, as `splash_ops._subtile_mask`
  does, and skip the products of those without one: the B fragment and
  mma's of the group in Q K^T and dO V^T (K V^T, V dO^T in K7), and the
  k slice it feeds in the second products, by a branch on a warp-uniform
  mask inside the unrolled loops of `flash_mma.cuh`.
- warp_skip: one such test a warp and tile (16 rows by the tile's 64 or
  32 columns), the whole tile body under one branch.
"""
from __future__ import annotations

import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# (file, anchor, replacement): each anchor must occur exactly once
_MMA = "flash_mma.cuh"
_DQ = "splash_bwd_dq.cu"
_FWD = "splash_fwd.cu"
_DKV = "splash_bwd_dkv.cu"
_DQ_IDS = ("  float acc[DC / 8][4];\n",
           "  const int wq0 = q0 + 16 * warp, wq1 = wq0 + 15;\n"
           "  const int qs_first = qsrow[wq0], qs_last = qsrow[wq1];\n"
           "  float acc[DC / 8][4];\n")
_DKV_IDS = ("    const int q0 = qt * BQ;\n",
            "    const int q0 = qt * BQ;\n"
            "    const int wk0 = k0 + 16 * warp;\n"
            "    const int ks_first = ks_s[16 * warp],"
            " ks_last = ks_s[16 * warp + 15];\n")
VARIANTS = {
    "shipped": [],
    "k5_always_test": [
        (_FWD, "    const bool one_seg = ",
         "    const bool one_seg = false && "),
    ],
    "k5_index_order": [
        (_FWD, "  const int qi = gridDim.y - 1 - blockIdx.y;",
         "  const int qi = blockIdx.y;"),
    ],
    "k5_no_floor": [
        (_FWD, "__launch_bounds__(kThreads, (kMinBlocks<T, DP>))",
         "__launch_bounds__(kThreads)"),
    ],
    "k5_two_blocks": [
        (_FWD, "__launch_bounds__(kThreads, (kMinBlocks<T, DP>))",
         "__launch_bounds__(kThreads, 2)"),
    ],
    "subtile_skip": [
        (_MMA, "                                             int rb, int kk, int lane) {",
         "                                             int rb, int kk, int lane,\n"
         "                                             uint32_t live = ~0u) {"),
        (_MMA, "    for (int j = 0; j < NT; ++j) {\n",
         "    for (int j = 0; j < NT; ++j) {\n"
         "      if (!((live >> j) & 1u)) continue;\n"),
        (_MMA, "    for (int j = 0; j < NT; j += 2) {\n",
         "    for (int j = 0; j < NT; j += 2) {\n"
         "      if (!((live >> j) & 3u)) continue;\n"),
        (_MMA, "                                        int lane) {",
         "                                        int lane, uint32_t live = ~0u) {"),
        (_MMA, "    mma_abt_step<T, D, NT>(acc, f, Bs, rb, kk, lane);",
         "    mma_abt_step<T, D, NT>(acc, f, Bs, rb, kk, lane, live);"),
        (_MMA, "                                       int rb, int lane, int c0 = 0) {",
         "                                       int rb, int lane, int c0 = 0,\n"
         "                                       uint32_t live = ~0u) {"),
        (_MMA, "    for (int kc = 0; kc < KT; ++kc) {\n",
         "    for (int kc = 0; kc < KT; ++kc) {\n"
         "      if (!((live >> kc) & 1u)) continue;\n"),
        (_MMA, "    for (int kc = 0; kc < KT / 2; ++kc) {\n",
         "    for (int kc = 0; kc < KT / 2; ++kc) {\n"
         "      if (!((live >> (2 * kc)) & 3u)) continue;\n"),
        (_DQ,) + _DQ_IDS,
        (_DQ, "    float s[NT][4], dp[NT][4];\n",
         "    uint32_t live = 0u;\n"
         "    for (int j = 0; j < NT; ++j) {\n"
         "      const int kf = kst[8 * j], kl = kst[8 * j + 7];\n"
         "      live |= (kf <= qs_last && kl >= qs_first\n"
         "               && (!causal || k0 + 8 * j <= wq1)) << j;\n"
         "    }\n"
         "    float s[NT][4], dp[NT][4];\n"),
        (_DQ, "Kt, 0, lane);\n    fmma::mma_abt", "Kt, 0, lane, live);\n    fmma::mma_abt"),
        (_DQ, "Vt, 0, lane);", "Vt, 0, lane, live);"),
        (_DQ, "(acc, s, Kt, 0, lane, c0);", "(acc, s, Kt, 0, lane, c0, live);"),
        (_DKV,) + _DKV_IDS,
        (_DKV, "    float s[NT][4], dp[NT][4];\n",
         "    uint32_t live = 0u;\n"
         "    for (int j = 0; j < NT; ++j) {\n"
         "      const int qf = qst[8 * j], ql = qst[8 * j + 7];\n"
         "      live |= (ks_first <= ql && ks_last >= qf\n"
         "               && (!causal || wk0 <= q0 + 8 * j + 7)) << j;\n"
         "    }\n"
         "    float s[NT][4], dp[NT][4];\n"),
        (_DKV, "Qt, 0, lane);\n    fmma::mma_abt", "Qt, 0, lane, live);\n    fmma::mma_abt"),
        (_DKV, "dOt, 0, lane);\n\n", "dOt, 0, lane, live);\n\n"),
        (_DKV, "(acc_v, s, dOt, 0, lane, c0);",
         "(acc_v, s, dOt, 0, lane, c0, live);"),
        (_DKV, "(acc_k, dp, Qt, 0, lane, c0);",
         "(acc_k, dp, Qt, 0, lane, c0, live);"),
    ],
    "warp_skip": [
        (_DQ,) + _DQ_IDS,
        (_DQ, "    float s[NT][4], dp[NT][4];\n",
         "    if (kst[0] <= qs_last && kst[BK - 1] >= qs_first\n"
         "        && (!causal || k0 <= wq1)) {\n"
         "    float s[NT][4], dp[NT][4];\n"),
        (_DQ, "    fmma::mma_pb<T, DP, NT, DC>(acc, s, Kt, 0, lane, c0);\n",
         "    fmma::mma_pb<T, DP, NT, DC>(acc, s, Kt, 0, lane, c0);\n    }\n"),
        (_DKV,) + _DKV_IDS,
        (_DKV, "    float s[NT][4], dp[NT][4];\n",
         "    if (ks_first <= qst[BQ - 1] && ks_last >= qst[0]\n"
         "        && (!causal || wk0 <= q0 + BQ - 1)) {\n"
         "    float s[NT][4], dp[NT][4];\n"),
        (_DKV, "    fmma::mma_pb<T, DP, NT, DC>(acc_k, dp, Qt, 0, lane, c0);\n",
         "    fmma::mma_pb<T, DP, NT, DC>(acc_k, dp, Qt, 0, lane, c0);\n"
         "    }\n"),
    ],
}


def _variant_dir(csrc, name):
    """A copy of the kernel sources `csrc` with `name`'s edits, under
    build/ab/ (`csrc` itself for `shipped`)."""
    if not VARIANTS[name]:
        return csrc
    d = REPO / "build" / "ab" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    for src, old, new in VARIANTS[name]:
        p = d / src
        text = p.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"kernel_ab: variant {name}: anchor {old!r} "
                             f"occurs {text.count(old)} times in {src}")
        p.write_text(text.replace(old, new))
    return d


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    names = argv or ["shipped"]
    for n in names:
        if n not in VARIANTS:
            print(f"kernel_ab: unknown variant {n} (one of {list(VARIANTS)})",
                  file=sys.stderr)
            return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from paddle_tpu_torch.ops import _build, flash_ops as fo
    from paddle_tpu_torch.ops import splash_ops as so
    torch.backends.cuda.matmul.allow_tf32 = False
    sm = chip_smoke.Smoke(type("Args", (), {"profile": False})())
    print(f"card: {chip_smoke._smi()}")
    S, D = 1024, 64
    layouts = [("one segment", torch.zeros(8, S, dtype=torch.int32,
                                            device="cuda"), 12),
               ("gpt2 pack", sm.splash_ids(8), 12),
               ("packed LM", sm.splash_ids(
                   17, chip_smoke.PACK["BS"]), chip_smoke.PACK["HEADS"])]
    shipped = _build.CSRC
    edited = sorted({src for n in names for src, *_ in VARIANTS[n]
                     if src.endswith(".cu")})
    bad = 0
    for name in names:
        _build.CSRC = _variant_dir(shipped, name)
        _build._libs.clear()
        _build._funcs.clear()
        t0 = time.perf_counter()
        _build.build(["splash_fwd.cu", "splash_bwd_dq.cu",
                      "splash_bwd_dkv.cu", "flash_fwd.cu", "flash_bwd_dq.cu",
                      "flash_bwd_dkv.cu"])
        print(f"== {name} (built in {time.perf_counter() - t0:.1f} s)")
        for src in edited:
            print(f"  ptxas {src}: " + "; ".join(
                f"{k} {r} registers, spill {s[0]}/{s[1]}" for k, r, s in
                chip_smoke._ptxas_kernels(_build.ptxas_log(src))))
        for dtype in (torch.float32, torch.bfloat16):
            tol = 1e-4 if dtype == torch.float32 else 1e-2
            for label, seg, H in layouts:
                B = seg.shape[0]
                g = torch.Generator(device="cuda").manual_seed(3)
                q, k, v, do = (torch.randn(B, H, S, D, generator=g,
                                           device="cuda").to(dtype)
                               for _ in range(4))
                sc = D ** -0.5
                ref, lse = so._splash_fwd_reference(q, k, v, seg, seg, True,
                                                    sc)
                delta = fo._delta(ref, do)
                args = (q, k, v, seg, seg, do, lse, delta, True, sc)
                bounds = so._block_bounds(seg, seg, 64, 64, True)
                fwd = (q, k, v, seg, seg, True, sc)
                got = [*so.splash_attention_fwd(*fwd, bounds=bounds[:2]),
                       so.splash_attention_dq(*args, bounds=bounds[:2]),
                       *so.splash_attention_dkv(*args, bounds=bounds[2:])]
                want = [ref, lse, so._splash_dq_reference(*args),
                        *so._splash_dkv_reference(*args)]
                err = max((a.float() - b.float()).abs().max().item()
                          / max(1.0, b.float().abs().max().item())
                          for a, b in zip(got, want))
                bad += err > tol
                t5 = chip_smoke._time_ms(torch, lambda: so.splash_attention_fwd(
                    *fwd, bounds=bounds[:2]), 20, device=True)
                t6 = chip_smoke._time_ms(torch, lambda: so.splash_attention_dq(
                    *args, bounds=bounds[:2]), 20)
                t7 = chip_smoke._time_ms(torch, lambda: so.splash_attention_dkv(
                    *args, bounds=bounds[2:]), 20)
                line = (f"  {name} {str(dtype)[6:]} {label} [{B},{H},{S},{D}]"
                        f": K5 {t5:.4f} ms K6 {t6:.4f} ms K7 {t7:.4f} ms"
                        f" (err {err:.2e}"
                        f" x max(1, max |ref|), tol {tol})")
                if label == "one segment":   # the flash kernels' work
                    fa = (q, k, v, None, do, lse, delta, True, sc)
                    t2 = chip_smoke._time_ms(
                        torch, lambda: fo.flash_attention_fwd(
                            q, k, v, None, True, sc), 20, device=True)
                    t3 = chip_smoke._time_ms(
                        torch, lambda: fo.flash_attention_dq(*fa), 20)
                    t4 = chip_smoke._time_ms(
                        torch, lambda: fo.flash_attention_dkv(*fa), 20)
                    line += f"; K2 {t2:.4f} K3 {t3:.4f} K4 {t4:.4f} ms"
                print(line, flush=True)
    _build.CSRC = shipped
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
