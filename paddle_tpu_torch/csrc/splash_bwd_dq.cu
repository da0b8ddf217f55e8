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
// (flash_mma.cuh): bf16 operands on mma.sync m16n8k16 (989 TFLOP/s peak),
// fp32 as 3xTF32 on mma.sync m16n8k8 (495 / 3 = 165 TFLOP/s of
// fp32-accurate products). dS is rounded to bf16 before dS K in bf16, as
// the TPU kernel casts it (splash_ops.py:233).
//
// Design: K3's (flash_bwd_dq.cu). One block of 4 warps per (64-query tile,
// b*h), no atomics: the block owns its dQ rows, each warp 16 of them. Q and
// dO stay in shared memory in their input type; K, V and the key segment
// ids are double-buffered with 16-byte cp.async in tiles of 64 keys (32 at
// D 128, to keep the registers free of spills). The key loop runs over the
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
#include "flash_mma.cuh"
#include "splash_common.cuh"

namespace {

constexpr int kBQ = 64;       // query rows a block
constexpr int kUnit = 64;     // the wrapper's span unit, in keys
constexpr int kWarps = 4;     // 16 query rows a warp
constexpr int kThreads = 32 * kWarps;

template <int D>
constexpr int kKeyTile = D == 128 ? 32 : 64;   // keys a tile

template <typename T, int D>
constexpr int smem_bytes() {
  return (2 * kBQ * D + 4 * kKeyTile<D> * D) * (int)sizeof(T)
         + 2 * kKeyTile<D> * (int)sizeof(int);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
splash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ qseg,
                     const int* __restrict__ kseg,
                     const int* __restrict__ kv_lo,
                     const int* __restrict__ kv_hi,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     int H, int S, int causal, float scale, uint32_t thresh,
                     float keep_scale, uint32_t seed) {
  constexpr int BK = kKeyTile<D>;
  constexpr int NT = BK / 8;   // score n-tiles (key groups) a warp
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kBQ * D;
  T* Ks = dOs + kBQ * D;            // [2][BK * D]
  T* Vs = Ks + 2 * BK * D;          // [2][BK * D]
  int* ks_s = reinterpret_cast<int*>(Vs + 2 * BK * D);   // [2][BK]

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
    fmma::load_tile_async<T, D, BK, kThreads>(
        Ks + buf * BK * D, kb + (size_t)t * BK * D, tid);
    fmma::load_tile_async<T, D, BK, kThreads>(
        Vs + buf * BK * D, vb + (size_t)t * BK * D, tid);
    fmma::load_vec_async<kThreads>(ks_s + buf * BK, ksrow + t * BK, BK, tid);
  };
  fmma::load_tile_async<T, D, kBQ, kThreads>(Qs, q + qoff, tid);
  fmma::load_tile_async<T, D, kBQ, kThreads>(dOs, dout + qoff, tid);
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
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
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
    const T* Kt = Ks + buf * BK * D;
    const T* Vt = Vs + buf * BK * D;
    const int* kst = ks_s + buf * BK;
    const int k0 = t * BK;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    fmma::mma_abt<T, D, NT>(s, Qs, 16 * warp, Kt, 0, lane);
    fmma::mma_abt<T, D, NT>(dp, dOs, 16 * warp, Vt, 0, lane);

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
    fmma::mma_pb<T, D, NT>(acc, s, Kt, 0, lane);
    __syncthreads();   // this tile's K/V/id reads are done
  }
  fmma::cp_async_wait<0>();   // nothing left in flight (no key tile at all)

  fmma::store_rows<T, D>(dq + qoff + (size_t)16 * warp * D, acc, scale,
                         lane);
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* qseg, const int* kseg, const int* lo,
                     const int* hi, const void* dout, const void* lse,
                     const void* delta, void* dq, int B, int H, int S,
                     int causal, float scale, uint32_t thresh,
                     float keep_scale, uint32_t seed, cudaStream_t stream) {
  const int bytes = smem_bytes<T, D>();
  cudaError_t e = cudaFuncSetAttribute(
      splash_bwd_dq_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, S / kBQ), block(kThreads);
  splash_bwd_dq_kernel<T, D><<<grid, block, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, qseg, kseg, lo, hi,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq, H, S,
      causal, scale, thresh, keep_scale, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* qseg, const int* kseg, const int* lo,
                   const int* hi, const void* dout, const void* lse,
                   const void* delta, void* dq, int B, int H, int S, int D,
                   int causal, float scale, uint32_t thresh,
                   float keep_scale, uint32_t seed, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, qseg, kseg, lo, hi, dout, lse, delta,
                             dq, B, H, S, causal, scale, thresh, keep_scale,
                             seed, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, qseg, kseg, lo, hi, dout, lse, delta,
                             dq, B, H, S, causal, scale, thresh, keep_scale,
                             seed, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, qseg, kseg, lo, hi, dout, lse, delta,
                              dq, B, H, S, causal, scale, thresh, keep_scale,
                              seed, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/dout [B,H,S,D] contiguous in one type (dtype 0 = float32, 1 =
// bfloat16); qseg/kseg [B,S] int32; kv_lo/kv_hi [B,S/64] int32 (the
// forward's key spans, in 64-key units); lse and delta [B*H,S] float32; dq
// like q. Self-attention only (Sq == Sk), a multiple of 64; D 32, 64 or
// 128; every pointer 16-byte aligned.
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
  cudaError_t e = dtype == 0
      ? launch<float>(q, k, v, qs, ks, lo, hi, dout, lse, delta, dq, B, H, Sq,
                      D, causal, scale, thresh, keep_scale, seed, s)
      : launch<__nv_bfloat16>(q, k, v, qs, ks, lo, hi, dout, lse, delta, dq,
                              B, H, Sq, D, causal, scale, thresh, keep_scale,
                              seed, s);
  return (int)e;
}

extern "C" const char* splash_bwd_dq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
