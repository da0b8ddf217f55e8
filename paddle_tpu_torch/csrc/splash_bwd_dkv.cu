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
// (flash_mma.cuh): bf16 or fp16 operands on mma.sync m16n8k16 (989
// TFLOP/s peak), fp32 as 3xTF32 on mma.sync m16n8k8 (495 / 3 = 165 TFLOP/s
// of fp32-accurate products). Pd and dS are rounded to the operand type
// before the second products in bf16 and fp16, as the TPU kernel casts them
// (splash_ops.py:277, 281).
//
// Design: K4's (flash_bwd_dkv.cu). One block of 4 warps per (64-key tile,
// b*h) owns its dK and dV rows, each warp 16 keys, so the sums over queries
// stay in registers with no atomics and the result does not depend on
// scheduling. K, V and the key segment ids stay in shared memory; query
// tiles of Q, dO, LSE, delta and the query segment ids stream through,
// double-buffered with 16-byte cp.async, with the tile's dropout row
// hashes. Tiles are 64 queries; above D 64, 32 in the 16-bit types and 8
// in fp32, to keep the two D-wide accumulators free of spills (32 and 16
// spilled in fp32 at D 128, PERF.md §6); above D 128 a block owns one
// column half of its dK and dV rows, as in K4. Every D % 8 == 0 up to 256
// runs at a padded width (flash_mma.cuh, "Head dims").
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

// queries a tile, at the padded width DP: 64; above DP 64, 32 in the
// 16-bit types and 8 in fp32, to keep the two accumulators free of spills
template <typename T, int DP>
constexpr int kQueryTile =
    DP <= 64 ? 64 : (std::is_same<T, float>::value ? 8 : 32);

// Above DP 128 a block owns one of two column halves of its dK and dV rows
// (blockIdx.z), as K4 does
template <int DP>
constexpr int kParts = DP > 128 ? 2 : 1;

// Padded widths compute their global offsets at run time, and ptxas,
// aiming at 168 registers (3 blocks an SM) there, spilled at fp32 width
// 32; a floor of 2 blocks lets it take up to 255. The exact widths keep
// the bound they were tuned with.
constexpr int kMinBlocks = 2;

template <typename T, int DP>
constexpr int smem_bytes() {
  return (2 * kBK * DP + 4 * kQueryTile<T, DP> * DP) * (int)sizeof(T)
         + 8 * kQueryTile<T, DP> * 4 + kBK * 4;
}

// DP: the padded width of the tiles; with kPad the head dim is the
// run-time d (global row stride, d <= DP), else DP itself
template <typename T, int DP, bool kPad>
__device__ __forceinline__ void
splash_bwd_dkv_body(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ qseg,
                    const int* __restrict__ kseg, const int* __restrict__ q_lo,
                    const int* __restrict__ q_hi, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int H, int S, int d, int causal,
                    float scale, uint32_t thresh, float keep_scale,
                    uint32_t seed) {
  constexpr int BQ = kQueryTile<T, DP>;
  constexpr int NT = BQ / 8;   // score n-tiles (query groups) a warp
  constexpr int DC = DP / kParts<DP>;   // output columns a block
  const int D = kPad ? d : DP;
  // this block's first column (0 unless the outputs are split)
  const int c0 = kParts<DP> > 1 ? (int)blockIdx.z * DC : 0;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kBK * DP;
  T* Qs = Vs + kBK * DP;            // [2][BQ * DP]
  T* dOs = Qs + 2 * BQ * DP;        // [2][BQ * DP]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * DP);  // [2][BQ]
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
    fmma::load_tile_async<T, DP, BQ, kThreads, kPad>(
        Qs + buf * BQ * DP, qb + (size_t)qt * BQ * D, tid, D);
    fmma::load_tile_async<T, DP, BQ, kThreads, kPad>(
        dOs + buf * BQ * DP, ob + (size_t)qt * BQ * D, tid, D);
    fmma::load_vec_async<kThreads>(lse_s + buf * BQ, lb + qt * BQ, BQ, tid);
    fmma::load_vec_async<kThreads>(dl_s + buf * BQ, db + qt * BQ, BQ, tid);
    fmma::load_vec_async<kThreads>(qs_s + buf * BQ, qsrow + qt * BQ, BQ,
                                   tid);
    if (thresh)   // the dropout hash of each query row, once a tile
      for (int i = tid; i < BQ; i += kThreads)
        rh_s[buf * BQ + i] = flash::drop_row(seed, bh, qt * BQ + i);
  };
  fmma::load_tile_async<T, DP, kBK, kThreads, kPad>(Ks, k + koff, tid, D);
  fmma::load_tile_async<T, DP, kBK, kThreads, kPad>(Vs, v + koff, tid, D);
  fmma::load_vec_async<kThreads>(ks_s, kseg + (size_t)b * S + k0, kBK, tid);
  if (first < last) fetch(first);
  fmma::cp_async_commit();

  // this thread's two keys: rows g and g + 8 of its warp's 16, their ids
  // in the shared tile
  const int kr = 16 * warp + g;
  float acc_k[DC / 8][4], acc_v[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
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
    const T* Qt = Qs + buf * BQ * DP;
    const T* dOt = dOs + buf * BQ * DP;
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
    fmma::mma_abt<T, DP, NT>(s, Ks, 16 * warp, Qt, 0, lane);
    fmma::mma_abt<T, DP, NT>(dp, Vs, 16 * warp, dOt, 0, lane);

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
    fmma::mma_pb<T, DP, NT, DC>(acc_v, s, dOt, 0, lane, c0);
    fmma::mma_pb<T, DP, NT, DC>(acc_k, dp, Qt, 0, lane, c0);
    __syncthreads();   // this tile's Q/dO/LSE/delta/id/hash reads are done
  }
  fmma::cp_async_wait<0>();   // nothing left in flight (no query tile at all)

  const size_t wo = koff + (size_t)16 * warp * D + c0;
  fmma::store_rows<T, DC, kPad>(dk + wo, acc_k, scale, lane, D, D - c0);
  fmma::store_rows<T, DC, kPad>(dv + wo, acc_v, 1.f, lane, D, D - c0);
}

// Two entries over one body: the exact widths (kPad false) with the launch
// bound they were tuned with, the padded widths with kMinBlocks.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
splash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ qseg,
                      const int* __restrict__ kseg,
                      const int* __restrict__ q_lo,
                      const int* __restrict__ q_hi, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int S, int d, int causal,
                      float scale, uint32_t thresh, float keep_scale,
                      uint32_t seed) {
  splash_bwd_dkv_body<T, DP, false>(
      q, k, v, qseg, kseg, q_lo, q_hi, dout, lse, delta, dk, dv, H, S, d,
      causal, scale, thresh, keep_scale, seed);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
splash_bwd_dkv_kernel_pad(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ qseg,
                          const int* __restrict__ kseg,
                          const int* __restrict__ q_lo,
                          const int* __restrict__ q_hi,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int H, int S, int d, int causal,
                          float scale, uint32_t thresh, float keep_scale,
                          uint32_t seed) {
  splash_bwd_dkv_body<T, DP, true>(
      q, k, v, qseg, kseg, q_lo, q_hi, dout, lse, delta, dk, dv, H, S, d,
      causal, scale, thresh, keep_scale, seed);
}

// the entry of width DP: the exact one, or the padded one
template <typename T, int DP, bool kPad>
auto kernel_for() {
  if constexpr (kPad) return splash_bwd_dkv_kernel_pad<T, DP>;
  else return splash_bwd_dkv_kernel<T, DP>;
}

template <typename T, int DP, bool kPad>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* qseg, const int* kseg, const int* lo,
                     const int* hi, const void* dout, const void* lse,
                     const void* delta, void* dk, void* dv, int B, int H,
                     int S, int D, int causal, float scale, uint32_t thresh,
                     float keep_scale, uint32_t seed, cudaStream_t stream) {
  const int bytes = smem_bytes<T, DP>();
  auto* kernel = kernel_for<T, DP, kPad>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, S / kBK, kParts<DP>), block(kThreads);
  kernel<<<grid, block, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, qseg, kseg, lo, hi,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
      H, S, D, causal, scale, thresh, keep_scale, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* qseg, const int* kseg, const int* lo,
                   const int* hi, const void* dout, const void* lse,
                   const void* delta, void* dk, void* dv, int B, int H, int S,
                   int D, int causal, float scale, uint32_t thresh,
                   float keep_scale, uint32_t seed, cudaStream_t stream) {
  return fmma::dispatch_width<T>(D, [&](auto dp, auto pad) {
    return launch_d<T, decltype(dp)::value, decltype(pad)::value>(
        q, k, v, qseg, kseg, lo, hi, dout, lse, delta, dk, dv, B, H, S, D,
        causal, scale, thresh, keep_scale, seed, stream);
  });
}

}  // namespace

// q/k/v/dout [B,H,S,D] contiguous in one type (dtype 0 = float32, 1 =
// bfloat16, 2 = float16); qseg/kseg [B,S] int32; q_lo/q_hi [B,S/64]
// int32 (the query span of each 64-key tile, in 64-query units); lse and delta
// [B*H,S] float32; dk/dv like k. Self-attention only (Sq == Sk), a
// multiple of 64; D % 8 == 0, D <= 256; every pointer 16-byte aligned.
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
  switch (dtype) {
    case 0:
      return (int)launch<float>(q, k, v, qs, ks, lo, hi, dout, lse, delta, dk,
                                dv, B, H, Sq, D, causal, scale, thresh,
                                keep_scale, seed, s);
    case 1:
      return (int)launch<__nv_bfloat16>(q, k, v, qs, ks, lo, hi, dout, lse,
                                        delta, dk, dv, B, H, Sq, D, causal,
                                        scale, thresh, keep_scale, seed, s);
    case 2:
      return (int)launch<__half>(q, k, v, qs, ks, lo, hi, dout, lse, delta,
                                 dk, dv, B, H, Sq, D, causal, scale, thresh,
                                 keep_scale, seed, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* splash_bwd_dkv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
