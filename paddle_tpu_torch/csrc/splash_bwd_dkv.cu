// Splash-attention backward, dK and dV, for Hopper (sm_90a), plain C
// interface.
//
// Replaces: paddle_tpu/ops/splash_ops.py:242 `_dkv_kernel` (launched by
// `_splash_bwd_call`, splash_ops.py:389).
//
// Computes, per (b, h) and key tile, with the forward's LSE and
// delta = rowsum(dO * O) (O the dropped output, computed outside):
//
//     P  = masked ? 0 : exp(Q K^T * scale - LSE)   (the segment test of K5)
//     dP = dO V^T;  dP = keep ? dP / (1-p) : 0;  Pd = keep ? P / (1-p) : 0
//     dS = P * (dP - delta)
//     dV = Pd^T dO;  dK = scale * dS^T Q           (dK, dV in q's type)
//
// the plain version `_splash_dkv_reference` (paddle_tpu_torch/ops/
// splash_ops.py), masked entries zeroed outside the exp as in K6, with the
// forward's keep mask (flash_common.cuh).
//
// Bound: operations. Four products of 2*D flops for each allowed pair (S,
// dP, dV, dK), against inputs read once. They run on the tensor cores
// (flash_mma.cuh): bf16 operands on mma.sync m16n8k16 (989 TFLOP/s peak),
// fp32 as 3xTF32 on mma.sync m16n8k8 (495 / 3 = 165 TFLOP/s of
// fp32-accurate products). Pd and dS are rounded to bf16 before the second
// products in bf16, as the TPU kernel casts them (splash_ops.py:277, 281).
//
// Design: K4's (flash_bwd_dkv.cu). One block of 4 warps per (64-key tile,
// b*h) owns its dK and dV rows, each warp 16 keys, so the sums over queries
// stay in registers with no atomics and the result does not depend on
// scheduling. K, V and the key segment ids stay in shared memory; query
// tiles of Q, dO, LSE, delta and the query segment ids stream through,
// double-buffered with 16-byte cp.async, with the tile's dropout row
// hashes. Tiles are 64 queries; at D 128, 32 in bf16 and 8 in fp32, to
// keep the two D-wide accumulators free of spills (32 and 16 spilled in
// fp32, PERF.md §6).
// The query loop runs over the wrapper's transposed span [q_lo, q_hi) for
// this (b, key tile), in 64-query units. The kernel computes the TRANSPOSED
// scores, S^T = K Q^T and dP^T = V dO^T, so its own keys are the MMA rows:
// Pd^T and dS^T come out in accumulator fragments, which are the A operands
// of dV += Pd^T dO and dK += dS^T Q as they stand (dO and Q read
// transposed, ldmatrix.trans in bf16). In this layout the key ids are per
// row; LSE, delta, the query ids and the dropout row hash are per column.
//
// Sub-tiles: as in K6 (splash_bwd_dq.cu), every group of a visited tile is
// computed and the per-element test zeroes P; skipping the 16x8 sub-tiles
// that hold no allowed pair (`_subtile_mask(..., transposed=True)`)
// measured slower (PERF.md §6).
//
// Why mma.sync and not wgmma: K4's reason (flash_bwd_dkv.cu). The main
// path's type is fp32, and tf32 wgmma takes both operands K-major from
// shared memory only; dO and Q in the second products arrive MN-major.
#include <type_traits>

#include "flash_mma.cuh"
#include "splash_common.cuh"

namespace {

constexpr int kBK = 64;       // keys a block
constexpr int kUnit = 64;     // the wrapper's span unit, in queries
constexpr int kWarps = 4;     // 16 keys a warp
constexpr int kThreads = 32 * kWarps;

template <typename T, int D>   // queries a tile
constexpr int kQueryTile =
    D == 128 ? (std::is_same<T, float>::value ? 8 : 32) : 64;

template <typename T, int D>
constexpr int smem_bytes() {
  return (2 * kBK * D + 4 * kQueryTile<T, D> * D) * (int)sizeof(T)
         + 8 * kQueryTile<T, D> * 4 + kBK * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
splash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ qseg,
                      const int* __restrict__ kseg,
                      const int* __restrict__ q_lo,
                      const int* __restrict__ q_hi,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int S, int causal,
                      float scale, uint32_t thresh, float keep_scale,
                      uint32_t seed) {
  constexpr int BQ = kQueryTile<T, D>;
  constexpr int NT = BQ / 8;   // score n-tiles (query groups) a warp
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kBK * D;
  T* Qs = Vs + kBK * D;             // [2][BQ * D]
  T* dOs = Qs + 2 * BQ * D;         // [2][BQ * D]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * D);   // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                                // [2][BQ]
  int* qs_s = reinterpret_cast<int*>(dl_s + 2 * BQ);           // [2][BQ]
  uint32_t* rh_s = reinterpret_cast<uint32_t*>(qs_s + 2 * BQ);  // [2][BQ]
  int* ks_s = reinterpret_cast<int*>(rh_s + 2 * BQ);   // [kBK] key ids

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = kt * kBK;
  const size_t koff = ((size_t)bh * S + k0) * D;
  const T* qb = q + (size_t)bh * S * D;
  const T* ob = dout + (size_t)bh * S * D;
  const float* lb = lse + (size_t)bh * S;
  const float* db = delta + (size_t)bh * S;
  const int* qsrow = qseg + (size_t)b * S;

  int first, last;
  flash::tile_span(q_lo, q_hi, b * (S / kBK) + kt, S / kUnit, &first,
                   &last);
  first = first * (kUnit / BQ);
  last = last * (kUnit / BQ);
  auto fetch = [&](int qt) {
    const int buf = qt & 1;
    fmma::load_tile_async<T, D, BQ, kThreads>(
        Qs + buf * BQ * D, qb + (size_t)qt * BQ * D, tid);
    fmma::load_tile_async<T, D, BQ, kThreads>(
        dOs + buf * BQ * D, ob + (size_t)qt * BQ * D, tid);
    fmma::load_vec_async<kThreads>(lse_s + buf * BQ, lb + qt * BQ, BQ, tid);
    fmma::load_vec_async<kThreads>(dl_s + buf * BQ, db + qt * BQ, BQ, tid);
    fmma::load_vec_async<kThreads>(qs_s + buf * BQ, qsrow + qt * BQ, BQ,
                                   tid);
    if (thresh)   // the dropout hash of each query row, once a tile
      for (int i = tid; i < BQ; i += kThreads)
        rh_s[buf * BQ + i] = flash::drop_row(seed, bh, qt * BQ + i);
  };
  fmma::load_tile_async<T, D, kBK, kThreads>(Ks, k + koff, tid);
  fmma::load_tile_async<T, D, kBK, kThreads>(Vs, v + koff, tid);
  fmma::load_vec_async<kThreads>(ks_s, kseg + (size_t)b * S + k0, kBK, tid);
  if (first < last) fetch(first);
  fmma::cp_async_commit();

  // this thread's two keys: rows g and g + 8 of its warp's 16, their ids
  // in the shared tile
  const int kr = 16 * warp + g;
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  for (int qt = first; qt < last; ++qt) {
    const int buf = qt & 1;
    if (qt + 1 < last) {
      fetch(qt + 1);   // its buffer's reads ended at the last iteration's sync
      fmma::cp_async_commit();
      fmma::cp_async_wait<1>();
    } else {
      fmma::cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + buf * BQ * D;
    const T* dOt = dOs + buf * BQ * D;
    const float* lt = lse_s + buf * BQ;
    const float* dt = dl_s + buf * BQ;
    const int* qst = qs_s + buf * BQ;
    const uint32_t* rht = rh_s + buf * BQ;
    const int q0 = qt * BQ;

    // S^T = K Q^T and dP^T = V dO^T: keys as rows, queries as columns
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    fmma::mma_abt<T, D, NT>(s, Ks, 16 * warp, Qt, 0, lane);
    fmma::mma_abt<T, D, NT>(dp, Vs, 16 * warp, dOt, 0, lane);

    // Pd^T in place of S^T and dS^T in place of dP^T: rows
    // k0 + kr + 8 (e / 2), queries q0 + 8 j + 2 t4 + e % 2
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int c = 8 * j + 2 * t4 + cc;
        const int qpos = q0 + c;
        const float lse_c = lt[c], dl_c = dt[c];
        const int qsg = qst[c];
        const uint32_t rh = thresh ? rht[c] : 0u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + cc;
          const float p = flash::seg_allowed(qsg, ks_s[kr + 8 * h], qpos,
                                             k0 + kr + 8 * h, causal)
                              ? expf(s[j][e] * scale - lse_c) : 0.f;
          float gd = dp[j][e], pd = p;
          if (thresh) {
            const bool keep = flash::drop_keep(rh, k0 + kr + 8 * h, thresh);
            gd = keep ? gd * keep_scale : 0.f;
            pd = keep ? p * keep_scale : 0.f;
          }
          s[j][e] = pd;
          dp[j][e] = p * (gd - dl_c);
        }
      }
    fmma::mma_pb<T, D, NT>(acc_v, s, dOt, 0, lane);
    fmma::mma_pb<T, D, NT>(acc_k, dp, Qt, 0, lane);
    __syncthreads();   // this tile's Q/dO/LSE/delta/id/hash reads are done
  }
  fmma::cp_async_wait<0>();   // nothing left in flight (no query tile at all)

  const size_t wo = koff + (size_t)16 * warp * D;
  fmma::store_rows<T, D>(dk + wo, acc_k, scale, lane);
  fmma::store_rows<T, D>(dv + wo, acc_v, 1.f, lane);
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* qseg, const int* kseg, const int* lo,
                     const int* hi, const void* dout, const void* lse,
                     const void* delta, void* dk, void* dv, int B, int H,
                     int S, int causal, float scale, uint32_t thresh,
                     float keep_scale, uint32_t seed, cudaStream_t stream) {
  const int bytes = smem_bytes<T, D>();
  cudaError_t e = cudaFuncSetAttribute(
      splash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, S / kBK), block(kThreads);
  splash_bwd_dkv_kernel<T, D><<<grid, block, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, qseg, kseg, lo, hi,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
      H, S, causal, scale, thresh, keep_scale, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* qseg, const int* kseg, const int* lo,
                   const int* hi, const void* dout, const void* lse,
                   const void* delta, void* dk, void* dv, int B, int H, int S,
                   int D, int causal, float scale, uint32_t thresh,
                   float keep_scale, uint32_t seed, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, qseg, kseg, lo, hi, dout, lse, delta,
                             dk, dv, B, H, S, causal, scale, thresh,
                             keep_scale, seed, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, qseg, kseg, lo, hi, dout, lse, delta,
                             dk, dv, B, H, S, causal, scale, thresh,
                             keep_scale, seed, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, qseg, kseg, lo, hi, dout, lse, delta,
                              dk, dv, B, H, S, causal, scale, thresh,
                              keep_scale, seed, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/dout [B,H,S,D] contiguous in one type (dtype 0 = float32, 1 =
// bfloat16); qseg/kseg [B,S] int32; q_lo/q_hi [B,S/64] int32 (the
// query span of each 64-key tile, in 64-query units); lse and delta
// [B*H,S] float32; dk/dv like k. Self-attention only (Sq == Sk), a
// multiple of 64; D 32, 64, 128; every pointer 16-byte aligned.
extern "C" int splash_attention_bwd_dkv(void* q, void* k, void* v, void* qseg,
                                        void* kseg, void* q_lo, void* q_hi,
                                        void* dout, void* lse, void* delta,
                                        void* dk, void* dv, int B, int H,
                                        int Sq, int Sk, int D, int dtype,
                                        int causal, float scale,
                                        unsigned int thresh, float keep_scale,
                                        unsigned int seed, void* stream) {
  if (Sq != Sk || Sq % kBK != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sk <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* qs = (const int*)qseg;
  const int* ks = (const int*)kseg;
  const int* lo = (const int*)q_lo;
  const int* hi = (const int*)q_hi;
  cudaError_t e = dtype == 0
      ? launch<float>(q, k, v, qs, ks, lo, hi, dout, lse, delta, dk, dv, B, H,
                      Sq, D, causal, scale, thresh, keep_scale, seed, s)
      : launch<__nv_bfloat16>(q, k, v, qs, ks, lo, hi, dout, lse, delta, dk,
                              dv, B, H, Sq, D, causal, scale, thresh,
                              keep_scale, seed, s);
  return (int)e;
}

extern "C" const char* splash_bwd_dkv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
