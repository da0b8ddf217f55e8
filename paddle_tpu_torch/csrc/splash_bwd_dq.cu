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
// dP, dS K), against inputs read once; run on the float32 CUDA cores (67
// TFLOP/s peak) in both input types, like K5.
//
// Design: K3's (flash_bwd_dq.cu): one block of 256 threads per (64-query
// tile, b*h), no atomics, the block owning its dQ rows; Q, dO, LSE, delta
// and the query ids in shared memory; per key tile S and dP out of one pass
// over D, dS to shared memory, dQ += dS K in a 4 x D/16 register tile. The
// key loop runs over the wrapper's [kv_lo, kv_hi) for this (b, query tile),
// the forward's span. Tensor cores and TMA are later work.
#include "splash_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr int smem_floats() {
  // Q, dO, K, V tiles; dS tile; LSE, delta; query and key segment ids
  return 4 * kBQ * (D + 1) + kBQ * (kBK + 1) + 2 * kBQ + kBQ + kBK;
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
  constexpr int DS = D + 1;
  constexpr int SS = kBK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBQ * DS;
  float* Ks = dOs + kBQ * DS;
  float* Vs = Ks + kBK * DS;
  float* Ss = Vs + kBK * DS;
  float* lse_s = Ss + kBQ * SS;
  float* dl_s = lse_s + kBQ;
  int* qs_s = reinterpret_cast<int*>(dl_s + kBQ);
  int* ks_s = qs_s + kBQ;

  const int qi = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int nt = S / kBK;
  const size_t qoff = ((size_t)bh * S + (size_t)qi * kBQ) * D;
  const T* kb = k + (size_t)bh * S * D;
  const T* vb = v + (size_t)bh * S * D;
  const int* ksrow = kseg + (size_t)b * S;

  load_tile<T, D>(Qs, q + qoff, kBQ, tid);
  load_tile<T, D>(dOs, dout + qoff, kBQ, tid);
  if (tid < kBQ) {
    lse_s[tid] = lse[(size_t)bh * S + (size_t)qi * kBQ + tid];
    dl_s[tid] = delta[(size_t)bh * S + (size_t)qi * kBQ + tid];
    qs_s[tid] = qseg[(size_t)b * S + (size_t)qi * kBQ + tid];
  }
  uint32_t row_hash[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    row_hash[i] = thresh ? drop_row(seed, bh, qi * kBQ + ty + 16 * i) : 0u;
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  int first, last;
  tile_span(kv_lo, kv_hi, b * (S / kBQ) + qi, nt, &first, &last);
  for (int t = first; t < last; ++t) {
    __syncthreads();  // the previous tile's K, dS and id reads are done
    load_tile<T, D>(Ks, kb + (size_t)t * kBK * D, kBK, tid);
    load_tile<T, D>(Vs, vb + (size_t)t * kBK * D, kBK, tid);
    if (tid < kBK) ks_s[tid] = ksrow[t * kBK + tid];
    __syncthreads();

    // S = Q K^T and dP = dO V^T: rows ty + 16 i, keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * DS + d];
        ov[i] = dOs[(ty + 16 * i) * DS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DS + d];
        vv[j] = Vs[(tx + 16 * j) * DS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += ov[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = qi * kBQ + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = t * kBK + c;
        const float p = seg_allowed(qs_s[r], ks_s[c], qpos, kpos, causal)
                            ? expf(s[i][j] * scale - lse_s[r])
                            : 0.f;
        float g = dp[i][j];
        if (thresh) g = drop_keep(row_hash[i], kpos, thresh) ? g * keep_scale
                                                             : 0.f;
        Ss[r * SS + c] = p * (g - dl_s[r]);
      }
    }
    __syncthreads();

    // dQ += dS K: rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float sv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty + 16 * i) * SS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[c * DS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += sv[i] * kv[j];
    }
  }

  T* ob = dq + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      store(ob + (size_t)(ty + 16 * i) * D + tx + 16 * j, acc[i][j] * scale);
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* qseg, const int* kseg, const int* lo,
                     const int* hi, const void* dout, const void* lse,
                     const void* delta, void* dq, int B, int H, int S,
                     int causal, float scale, uint32_t thresh,
                     float keep_scale, uint32_t seed, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      splash_bwd_dq_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(S / kBQ, B * H), block(kThreads);
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
// forward's key-tile spans); lse and delta [B*H,S] float32; dq like q.
// Self-attention only (Sq == Sk), a multiple of 64; D 32, 64 or 128.
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
