// Flash-attention backward, dK and dV, for Hopper (sm_90a), plain C
// interface.
//
// Replaces: paddle_tpu/ops/pallas_ops.py:251 `_dkv_kernel` (launched by
// `_flash_bwd_call`, pallas_ops.py:385).
//
// Computes, per (b, h) and key tile, with the forward's LSE and
// delta = rowsum(dO * O) (O the dropped output, computed outside):
//
//     P  = exp(Q K^T * scale + bias - LSE)   (causal / -1e30 masking as K2)
//     dP = dO V^T;  dP = keep ? dP / (1-p) : 0;  Pd = keep ? P / (1-p) : 0
//     dS = P * (dP - delta)
//     dV = Pd^T dO;  dK = scale * dS^T Q      (dK, dV in q's type)
//
// the plain version `_dkv_reference` (paddle_tpu_torch/ops/flash_ops.py),
// with the forward's keep mask (the coordinate hash of flash_common.cuh).
//
// Bound: operations. Four products of 2*Sq*Sk*D flops (S, dP, dV, dK), half
// of that when causal, against inputs read once. They run on the tensor
// cores (flash_mma.cuh): bf16 or fp16 operands on mma.sync m16n8k16 (989
// TFLOP/s peak), fp32 as 3xTF32 on mma.sync m16n8k8 (495 / 3 = 165 TFLOP/s
// of fp32-accurate products). In bf16 and fp16, Pd and dS are rounded to
// the operands' type before the second products, as the TPU kernel casts
// them (pallas_ops.py:286, 290).
//
// Design: one block of 4 warps per (64-key tile, b*h). The block owns its
// dK and dV rows, each warp 16 keys, so the sums over queries stay in
// registers with no atomics and the result does not depend on scheduling.
// K and V stay in shared memory in their input type; query tiles (64
// queries; 32 at D 128, to keep the two D-wide accumulators free of spills)
// of Q, dO, LSE and delta stream through, double-buffered with 16-byte
// cp.async (with the tile's dropout row hashes, computed once a tile), starting at the diagonal tile when causal (the TPU kernel's
// range, pallas_ops.py:298-300). The kernel computes the TRANSPOSED scores,
// S^T = K Q^T and dP^T = V dO^T, so its own keys are the MMA rows: Pd^T and
// dS^T come out in accumulator fragments, which are the A operands of
// dV += Pd^T dO and dK += dS^T Q as they stand (dO and Q read transposed,
// ldmatrix.trans in bf16), and never go through shared memory. In this
// layout LSE, delta and the dropout row hash are per column (query); the
// key bias is per row and stays in registers. Tiles are XOR-swizzled so
// ldmatrix (bf16) and the 32-bit fragment loads (tf32) are free of bank
// conflicts. Warps whose keys lie wholly below the diagonal of a query
// tile skip the mask test. Key tile 0 has the most queries under causal
// masking and runs first (blockIdx.y is the key tile, b*h the fast index).
//
// Why mma.sync and not wgmma: the main path's type is fp32, and tf32 wgmma
// takes both operands K-major from shared memory only (its transpose bit is
// for 16-bit types). dO in Pd^T dO and Q in dS^T Q arrive MN-major, so fp32
// wgmma would need a transposing copy of every streamed tile; one mma.sync
// fragment path serves both types.
#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int kBK = 64;       // keys a block
constexpr int kWarps = 4;     // 16 keys a warp
constexpr int kThreads = 32 * kWarps;

template <int D>
constexpr int kQueryTile = D == 128 ? 32 : 64;   // queries a tile

template <typename T, int D>
constexpr int smem_bytes() {
  return (2 * kBK * D + 4 * kQueryTile<D> * D) * (int)sizeof(T)
         + 6 * kQueryTile<D> * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Sk, int causal,
                     float scale, uint32_t thresh, float keep_scale,
                     uint32_t seed) {
  constexpr int BQ = kQueryTile<D>;
  constexpr int NT = BQ / 8;   // score n-tiles (queries) a warp
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kBK * D;
  T* Qs = Vs + kBK * D;             // [2][BQ * D]
  T* dOs = Qs + 2 * BQ * D;         // [2][BQ * D]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * D);   // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                                // [2][BQ]
  uint32_t* rh_s = reinterpret_cast<uint32_t*>(dl_s + 2 * BQ);  // [2][BQ]

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = kt * kBK;
  const size_t koff = ((size_t)bh * Sk + k0) * D;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* ob = dout + (size_t)bh * Sq * D;
  const float* lb = lse + (size_t)bh * Sq;
  const float* db = delta + (size_t)bh * Sq;

  const int nqb = Sq / BQ;
  const int first = causal ? k0 / BQ : 0;
  auto fetch = [&](int qt, int buf) {
    fmma::load_tile_async<T, D, BQ, kThreads>(
        Qs + buf * BQ * D, qb + (size_t)qt * BQ * D, tid);
    fmma::load_tile_async<T, D, BQ, kThreads>(
        dOs + buf * BQ * D, ob + (size_t)qt * BQ * D, tid);
    fmma::load_vec_async<kThreads>(lse_s + buf * BQ, lb + qt * BQ, BQ, tid);
    fmma::load_vec_async<kThreads>(dl_s + buf * BQ, db + qt * BQ, BQ, tid);
    if (thresh)   // the dropout hash of each query row, once a tile
      for (int i = tid; i < BQ; i += kThreads)
        rh_s[buf * BQ + i] = flash::drop_row(seed, bh, qt * BQ + i);
  };
  fmma::load_tile_async<T, D, kBK, kThreads>(Ks, k + koff, tid);
  fmma::load_tile_async<T, D, kBK, kThreads>(Vs, v + koff, tid);
  if (first < nqb) fetch(first, 0);
  fmma::cp_async_commit();

  // this thread's two keys (rows g and g + 8 of its warp's 16): their bias
  // never changes
  const int r0 = 16 * warp + g;
  int kpos[2];
  float kbias[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kpos[h] = k0 + r0 + 8 * h;
    kbias[h] = bias != nullptr ? bias[(size_t)b * Sk + kpos[h]] : 0.f;
  }
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  for (int qt = first; qt < nqb; ++qt) {
    const int buf = (qt - first) & 1;
    if (qt + 1 < nqb) {
      fetch(qt + 1, buf ^ 1);   // its reads ended at the last iteration's sync
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

    // Pd^T in place of S^T and dS^T in place of dP^T: rows kpos[e / 2],
    // queries q0 + 8 j + 2 t4 + e % 2
    const bool mask = causal && k0 + 16 * warp + 15 > q0;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int c = 8 * j + 2 * t4 + cc;
        const int qpos = q0 + c;
        const float lse_c = lt[c], dl_c = dt[c];
        const uint32_t rh = thresh ? rht[c] : 0u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + cc;
          float x = s[j][e] * scale + kbias[h];
          if (mask && kpos[h] > qpos) x = flash::kNegInf;
          const float p = expf(x - lse_c);
          float gd = dp[j][e], pd = p;
          if (thresh) {
            const bool keep = flash::drop_keep(rh, kpos[h], thresh);
            gd = keep ? gd * keep_scale : 0.f;
            pd = keep ? p * keep_scale : 0.f;
          }
          s[j][e] = pd;
          dp[j][e] = p * (gd - dl_c);
        }
      }
    fmma::mma_pb<T, D, NT>(acc_v, s, dOt, 0, lane);
    fmma::mma_pb<T, D, NT>(acc_k, dp, Qt, 0, lane);
    __syncthreads();   // this tile's Q/dO/LSE/delta/hash reads are done
  }
  fmma::cp_async_wait<0>();   // nothing left in flight (no query tile at all)

  const size_t wo = koff + (size_t)16 * warp * D;
  fmma::store_rows<T, D>(dk + wo, acc_k, scale, lane);
  fmma::store_rows<T, D>(dv + wo, acc_v, 1.f, lane);
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* bias, const void* dout, const void* lse,
                     const void* delta, void* dk, void* dv, int B, int H,
                     int Sq, int Sk, int causal, float scale, uint32_t thresh,
                     float keep_scale, uint32_t seed, cudaStream_t stream) {
  const int bytes = smem_bytes<T, D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, Sk / kBK), block(kThreads);
  flash_bwd_dkv_kernel<T, D><<<grid, block, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
      H, Sq, Sk, causal, scale, thresh, keep_scale, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* dout, const void* lse,
                   const void* delta, void* dk, void* dv, int B, int H,
                   int Sq, int Sk, int D, int causal, float scale,
                   uint32_t thresh, float keep_scale, uint32_t seed,
                   cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, bias, dout, lse, delta, dk, dv, B, H,
                             Sq, Sk, causal, scale, thresh, keep_scale, seed,
                             stream);
    case 64:
      return launch_d<T, 64>(q, k, v, bias, dout, lse, delta, dk, dv, B, H,
                             Sq, Sk, causal, scale, thresh, keep_scale, seed,
                             stream);
    case 128:
      return launch_d<T, 128>(q, k, v, bias, dout, lse, delta, dk, dv, B, H,
                              Sq, Sk, causal, scale, thresh, keep_scale,
                              seed, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/dout [B,H,Sq,D], k/v [B,H,Sk,D] contiguous in one type (dtype 0 =
// float32, 1 = bfloat16, 2 = float16); bias [B,Sk] float32 or null; lse
// and delta [B*H,Sq] float32; dk/dv like k.
// Sq and Sk multiples of 64; D 32, 64, 128.
extern "C" int flash_attention_bwd_dkv(void* q, void* k, void* v, void* bias,
                                       void* dout, void* lse, void* delta,
                                       void* dk, void* dv, int B, int H,
                                       int Sq, int Sk, int D, int dtype,
                                       int causal, float scale,
                                       unsigned int thresh, float keep_scale,
                                       unsigned int seed, void* stream) {
  if (Sq % 64 != 0 || Sk % 64 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sk <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return (int)launch<float>(q, k, v, bias, dout, lse, delta, dk, dv, B, H,
                                Sq, Sk, D, causal, scale, thresh, keep_scale,
                                seed, s);
    case 1:
      return (int)launch<__nv_bfloat16>(q, k, v, bias, dout, lse, delta, dk,
                                        dv, B, H, Sq, Sk, D, causal, scale,
                                        thresh, keep_scale, seed, s);
    case 2:
      return (int)launch<__half>(q, k, v, bias, dout, lse, delta, dk, dv, B,
                                 H, Sq, Sk, D, causal, scale, thresh,
                                 keep_scale, seed, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_bwd_dkv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
