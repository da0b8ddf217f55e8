// Splash-attention backward, dQ, for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/ops/splash_ops.py:201 `_dq_kernel` (launched by
// `_splash_bwd_call`, splash_ops.py:367).
//
// Computes, per (b, h) and query tile, with the forward's LSE and
// delta = rowsum(dO * O) (O the dropped output, computed outside):
//
//     P  = masked ? 0 : exp(Q K^T * scale - LSE)   (the segment test of K5)
//     dP = dO V^T;  dP = keep ? dP / (1-p) : 0
//     dS = P * (dP - delta)
//     dQ = scale * dS K                            (dQ in q's type)
//
// the plain version `_splash_dq_reference` (paddle_tpu_torch/ops/
// splash_ops.py). Masked entries are zeroed OUTSIDE the exp (splash_ops.py:
// 192-198): a row with no visible key has LSE = -1e30, and exp(S - LSE)
// would not vanish there. The keep mask is the forward's (flash_common.cuh).
//
// Bound: operations. Three products of 2*D flops for each allowed pair (S,
// dP, dS K), against inputs read once. They run on the tensor cores
// (flash_mma.cuh): bf16 or fp16 operands on mma.sync m16n8k16 (989
// TFLOP/s peak), fp32 as 3xTF32 on mma.sync m16n8k8 (495 / 3 = 165 TFLOP/s
// of fp32-accurate products). dS is rounded to the operand type before dS K
// in bf16 and fp16, as the TPU kernel casts it (splash_ops.py:233).
//
// Design: K3's (flash_bwd_dq.cu). One block of 4 warps per (64-query tile,
// b*h), no atomics: the block owns its dQ rows, each warp 16 of them. Q and
// dO stay in shared memory in their input type; K, V and the key segment
// ids are double-buffered with 16-byte cp.async in tiles of 64 keys (32
// above D 64, to keep the registers free of spills; 16 in fp32 above D 128,
// for shared memory; every D % 8 == 0 up to 256 at a padded width,
// flash_mma.cuh "Head dims"; in fp32 above D 192 two blocks share the rows,
// one column half each, as in K3). The key loop runs over the
// wrapper's [kv_lo, kv_hi) for this (b, query tile), the forward's span, in
// 64-key units. S and dP come out of mma in accumulator fragments (queries
// as rows), dS is formed there, and that fragment is the A operand of
// dQ += dS K with K's fragments read transposed (ldmatrix.trans in bf16):
// dS never goes through shared memory. The query ids are per row and stay
// in registers; the key ids are per column and come from the shared tile.
//
// Sub-tiles, measured and not skipped: the ids are non-decreasing, so a
// warp's 16 rows and an n8 group of keys can hold an allowed pair only if
// their id ranges overlap and, under causal, the group's first key is at or
// before the warp's last query (`_subtile_mask` in ops/splash_ops.py counts
// them: 0.82 of the 16x8 sub-tiles of the visited tiles on the packing
// bench's pack). Skipping the others inside the unrolled products measured
// slower on the card than computing them, with a branch around each group
// or one test a warp and tile (`kernel_ab.py`, PERF.md §6) and with
// predicated mma's: control flow splits the straight-line code in which
// the compiler interleaves the groups' mma's and hides their latency, at
// 2-3 blocks of 4 warps an SM. So every group of a visited tile is
// computed, and the per-element test zeroes P.
//
// Why mma.sync and not wgmma: K3's reason (flash_bwd_dq.cu). The main
// path's type is fp32, and tf32 wgmma takes both operands K-major from
// shared memory only; K in dS K arrives MN-major.
#include <type_traits>

#include "flash_mma.cuh"
#include "splash_common.cuh"

namespace {

constexpr int kBQ = 64;       // query rows a block
constexpr int kUnit = 64;     // the wrapper's span unit, in keys
constexpr int kWarps = 4;     // 16 query rows a warp
constexpr int kThreads = 32 * kWarps;

// keys a tile, at the padded width DP (K3's rule): 64; 32 above DP 64, to
// keep the registers free of spills; 16 in fp32 above DP 128, for shared
// memory
template <typename T, int DP>
constexpr int kKeyTile =
    DP <= 64 ? 64 : (std::is_same<T, float>::value && DP > 128) ? 16 : 32;

// In fp32 above DP 192 the [16, DP] accumulator and the streamed tiles'
// tf32 splits outgrow 255 registers: a block then owns one of two column
// halves of its dQ rows (blockIdx.z) and recomputes S and dP for it, as
// K4 splits dK and dV
template <typename T, int DP>
constexpr int kParts = std::is_same<T, float>::value && DP > 192 ? 2 : 1;

// Padded widths compute their global offsets at run time, and ptxas,
// aiming at 168 registers (3 blocks an SM) there, spilled at bf16 width 64
// and fp32 width 32; a floor of 2 blocks lets it take up to 255. The
// exact widths keep the bound they were tuned with.
constexpr int kMinBlocks = 2;

template <typename T, int DP>
constexpr int smem_bytes() {
  return (2 * kBQ * DP + 4 * kKeyTile<T, DP> * DP) * (int)sizeof(T)
         + 2 * kKeyTile<T, DP> * (int)sizeof(int);
}

// DP: the padded width of the tiles; with kPad the head dim is the
// run-time d (global row stride, d <= DP), else DP itself
template <typename T, int DP, bool kPad>
__device__ __forceinline__ void
splash_bwd_dq_body(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ qseg,
                   const int* __restrict__ kseg, const int* __restrict__ kv_lo,
                   const int* __restrict__ kv_hi, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int H,
                   int S, int d, int causal, float scale, uint32_t thresh,
                   float keep_scale, uint32_t seed) {
  constexpr int BK = kKeyTile<T, DP>;
  constexpr int NT = BK / 8;   // score n-tiles (key groups) a warp
  constexpr int DC = DP / kParts<T, DP>;   // output columns a block
  const int D = kPad ? d : DP;
  // this block's first column (0 unless the output is split)
  const int c0 = kParts<T, DP> > 1 ? (int)blockIdx.z * DC : 0;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kBQ * DP;
  T* Ks = dOs + kBQ * DP;           // [2][BK * DP]
  T* Vs = Ks + 2 * BK * DP;         // [2][BK * DP]
  int* ks_s = reinterpret_cast<int*>(Vs + 2 * BK * DP);   // [2][BK]

  const int bh = blockIdx.x;
  const int qi = gridDim.y - 1 - blockIdx.y;   // most keys first (causal)
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qi * kBQ;
  const size_t qoff = ((size_t)bh * S + q0) * D;
  const T* kb = k + (size_t)bh * S * D;
  const T* vb = v + (size_t)bh * S * D;
  const int* ksrow = kseg + (size_t)b * S;

  int first, last;
  flash::tile_span(kv_lo, kv_hi, b * (S / kBQ) + qi, S / kUnit, &first,
                   &last);
  first = first * (kUnit / BK);
  last = last * (kUnit / BK);
  auto fetch = [&](int t) {
    const int buf = t & 1;
    fmma::load_tile_async<T, DP, BK, kThreads, kPad>(
        Ks + buf * BK * DP, kb + (size_t)t * BK * D, tid, D);
    fmma::load_tile_async<T, DP, BK, kThreads, kPad>(
        Vs + buf * BK * DP, vb + (size_t)t * BK * D, tid, D);
    fmma::load_vec_async<kThreads>(ks_s + buf * BK, ksrow + t * BK, BK, tid);
  };
  fmma::load_tile_async<T, DP, kBQ, kThreads, kPad>(Qs, q + qoff, tid, D);
  fmma::load_tile_async<T, DP, kBQ, kThreads, kPad>(dOs, dout + qoff, tid,
                                                    D);
  if (first < last) fetch(first);
  fmma::cp_async_commit();

  // this thread's two query rows (g and g + 8 of its warp's 16)
  const int* qsrow = qseg + (size_t)b * S;
  int qpos[2], qsg[2];
  float lse_r[2], dl_r[2];
  uint32_t rh[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qpos[h] = q0 + 16 * warp + g + 8 * h;
    qsg[h] = qsrow[qpos[h]];
    lse_r[h] = lse[(size_t)bh * S + qpos[h]];
    dl_r[h] = delta[(size_t)bh * S + qpos[h]];
    rh[h] = thresh ? flash::drop_row(seed, bh, qpos[h]) : 0u;
  }
  float acc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = first; t < last; ++t) {
    if (t + 1 < last) {
      fetch(t + 1);   // its buffer's reads ended at the last iteration's sync
      fmma::cp_async_commit();
      fmma::cp_async_wait<1>();
    } else {
      fmma::cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = t & 1;
    const T* Kt = Ks + buf * BK * DP;
    const T* Vt = Vs + buf * BK * DP;
    const int* kst = ks_s + buf * BK;
    const int k0 = t * BK;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    fmma::mma_abt<T, DP, NT>(s, Qs, 16 * warp, Kt, 0, lane);
    fmma::mma_abt<T, DP, NT>(dp, dOs, 16 * warp, Vt, 0, lane);

    // dS in place of S: rows qpos[e / 2], keys k0 + 8 j + 2 t4 + e % 2
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int c = 8 * j + 2 * t4 + (e & 1);
        const float p = flash::seg_allowed(qsg[h], kst[c], qpos[h], k0 + c,
                                           causal)
                            ? expf(s[j][e] * scale - lse_r[h]) : 0.f;
        float gd = dp[j][e];
        if (thresh)
          gd = flash::drop_keep(rh[h], k0 + c, thresh) ? gd * keep_scale
                                                        : 0.f;
        s[j][e] = p * (gd - dl_r[h]);
      }
    fmma::mma_pb<T, DP, NT, DC>(acc, s, Kt, 0, lane, c0);
    __syncthreads();   // this tile's K/V/id reads are done
  }
  fmma::cp_async_wait<0>();   // nothing left in flight (no key tile at all)

  fmma::store_rows<T, DC, kPad>(dq + qoff + (size_t)16 * warp * D + c0,
                                acc, scale, lane, D, D - c0);
}

// Two entries over one body: the exact widths (kPad false) with the launch
// bound they were tuned with, the padded widths with kMinBlocks.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
splash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ qseg,
                     const int* __restrict__ kseg,
                     const int* __restrict__ kv_lo,
                     const int* __restrict__ kv_hi, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq, int H,
                     int S, int d, int causal, float scale, uint32_t thresh,
                     float keep_scale, uint32_t seed) {
  splash_bwd_dq_body<T, DP, false>(
      q, k, v, qseg, kseg, kv_lo, kv_hi, dout, lse, delta, dq, H, S, d, causal,
      scale, thresh, keep_scale, seed);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
splash_bwd_dq_kernel_pad(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ qseg,
                         const int* __restrict__ kseg,
                         const int* __restrict__ kv_lo,
                         const int* __restrict__ kv_hi,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         int H, int S, int d, int causal, float scale,
                         uint32_t thresh, float keep_scale, uint32_t seed) {
  splash_bwd_dq_body<T, DP, true>(
      q, k, v, qseg, kseg, kv_lo, kv_hi, dout, lse, delta, dq, H, S, d, causal,
      scale, thresh, keep_scale, seed);
}

// the entry of width DP: the exact one, or the padded one
template <typename T, int DP, bool kPad>
auto kernel_for() {
  if constexpr (kPad) return splash_bwd_dq_kernel_pad<T, DP>;
  else return splash_bwd_dq_kernel<T, DP>;
}

template <typename T, int DP, bool kPad>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* qseg, const int* kseg, const int* lo,
                     const int* hi, const void* dout, const void* lse,
                     const void* delta, void* dq, int B, int H, int S, int D,
                     int causal, float scale, uint32_t thresh,
                     float keep_scale, uint32_t seed, cudaStream_t stream) {
  const int bytes = smem_bytes<T, DP>();
  auto* kernel = kernel_for<T, DP, kPad>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, S / kBQ, kParts<T, DP>), block(kThreads);
  kernel<<<grid, block, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, qseg, kseg, lo, hi,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq, H, S,
      D, causal, scale, thresh, keep_scale, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* qseg, const int* kseg, const int* lo,
                   const int* hi, const void* dout, const void* lse,
                   const void* delta, void* dq, int B, int H, int S, int D,
                   int causal, float scale, uint32_t thresh,
                   float keep_scale, uint32_t seed, cudaStream_t stream) {
  return fmma::dispatch_width<T>(D, [&](auto dp, auto pad) {
    return launch_d<T, decltype(dp)::value, decltype(pad)::value>(
        q, k, v, qseg, kseg, lo, hi, dout, lse, delta, dq, B, H, S, D,
        causal, scale, thresh, keep_scale, seed, stream);
  });
}

}  // namespace

// q/k/v/dout [B,H,S,D] contiguous in one type (dtype 0 = float32, 1 =
// bfloat16, 2 = float16); qseg/kseg [B,S] int32; kv_lo/kv_hi [B,S/64]
// int32 (the forward's key spans, in 64-key units); lse and delta [B*H,S]
// float32; dq like q. Self-attention only (Sq == Sk), a multiple of 64;
// D % 8 == 0, D <= 256; every pointer 16-byte aligned.
extern "C" int splash_attention_bwd_dq(void* q, void* k, void* v, void* qseg,
                                       void* kseg, void* kv_lo, void* kv_hi,
                                       void* dout, void* lse, void* delta,
                                       void* dq, int B, int H, int Sq, int Sk,
                                       int D, int dtype, int causal,
                                       float scale, unsigned int thresh,
                                       float keep_scale, unsigned int seed,
                                       void* stream) {
  if (Sq != Sk || Sq % kBQ != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* qs = (const int*)qseg;
  const int* ks = (const int*)kseg;
  const int* lo = (const int*)kv_lo;
  const int* hi = (const int*)kv_hi;
  switch (dtype) {
    case 0:
      return (int)launch<float>(q, k, v, qs, ks, lo, hi, dout, lse, delta, dq,
                                B, H, Sq, D, causal, scale, thresh,
                                keep_scale, seed, s);
    case 1:
      return (int)launch<__nv_bfloat16>(q, k, v, qs, ks, lo, hi, dout, lse,
                                        delta, dq, B, H, Sq, D, causal, scale,
                                        thresh, keep_scale, seed, s);
    case 2:
      return (int)launch<__half>(q, k, v, qs, ks, lo, hi, dout, lse, delta,
                                 dq, B, H, Sq, D, causal, scale, thresh,
                                 keep_scale, seed, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* splash_bwd_dq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
