// Flash-attention backward, dQ, for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/ops/pallas_ops.py:207 `_dq_kernel` (launched by
// `_flash_bwd_call`, pallas_ops.py:366).
//
// Computes, per (b, h) and query tile, with the forward's LSE and
// delta = rowsum(dO * O) (O the dropped output, computed outside):
//
//     P  = exp(Q K^T * scale + bias - LSE)   (causal / -1e30 masking as K2)
//     dP = dO V^T;  dP = keep ? dP / (1-p) : 0
//     dS = P * (dP - delta)
//     dQ = scale * dS K                       (dQ in q's type)
//
// the plain version `_dq_reference` (paddle_tpu_torch/ops/flash_ops.py).
// The keep mask is the coordinate hash of flash_common.cuh, so it is the
// forward's mask whatever the tiles.
//
// Bound: operations. Three products of 2*Sq*Sk*D flops (S, dP, dS K), half
// of that when causal, against inputs read once; run on the float32 CUDA
// cores (67 TFLOP/s peak) in both input types, like K2.
//
// Design: one block of 256 threads per (64-query tile, b*h), no atomics: the
// block owns its dQ rows and loops over 64-key tiles, stopping at the
// diagonal tile when causal (the TPU kernel's range, pallas_ops.py:243-245,
// for any tile sizes). Q, dO, LSE and delta stay in shared memory; per key
// tile, S and dP come out of one pass over D (4x4 register tiles each), dS
// goes to shared memory, and dQ += dS K accumulates in a 4 x D/16 register
// tile per thread. Tensor cores and TMA are later work.
#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr int smem_floats() {
  return 4 * kBQ * (D + 1) + kBQ * (kBK + 1) + 2 * kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Sq, int Sk, int causal, float scale,
                    uint32_t thresh, float keep_scale, uint32_t seed) {
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

  const int qi = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t qoff = ((size_t)bh * Sq + (size_t)qi * kBQ) * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;
  const float* brow = bias != nullptr ? bias + (size_t)b * Sk : nullptr;

  load_tile<T, D>(Qs, q + qoff, kBQ, tid);
  load_tile<T, D>(dOs, dout + qoff, kBQ, tid);
  if (tid < kBQ) {
    lse_s[tid] = lse[(size_t)bh * Sq + (size_t)qi * kBQ + tid];
    dl_s[tid] = delta[(size_t)bh * Sq + (size_t)qi * kBQ + tid];
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

  const int nkb = Sk / kBK;
  int last = nkb;
  if (causal) {
    const int diag = ((qi + 1) * kBQ + kBK - 1) / kBK;
    last = diag < nkb ? diag : nkb;
  }
  for (int t = 0; t < last; ++t) {
    __syncthreads();  // the previous tile's K and dS reads are done
    load_tile<T, D>(Ks, kb + (size_t)t * kBK * D, kBK, tid);
    load_tile<T, D>(Vs, vb + (size_t)t * kBK * D, kBK, tid);
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
        float x = s[i][j] * scale;
        if (brow != nullptr) x += brow[kpos];
        if (causal && kpos > qpos) x = kNegInf;
        const float p = expf(x - lse_s[r]);
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
                     const void* bias, const void* dout, const void* lse,
                     const void* delta, void* dq, int B, int H, int Sq,
                     int Sk, int causal, float scale, uint32_t thresh,
                     float keep_scale, uint32_t seed, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(Sq / kBQ, B * H), block(kThreads);
  flash_bwd_dq_kernel<T, D><<<grid, block, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq, H, Sq,
      Sk, causal, scale, thresh, keep_scale, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* dout, const void* lse,
                   const void* delta, void* dq, int B, int H, int Sq, int Sk,
                   int D, int causal, float scale, uint32_t thresh,
                   float keep_scale, uint32_t seed, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, bias, dout, lse, delta, dq, B, H, Sq,
                             Sk, causal, scale, thresh, keep_scale, seed,
                             stream);
    case 64:
      return launch_d<T, 64>(q, k, v, bias, dout, lse, delta, dq, B, H, Sq,
                             Sk, causal, scale, thresh, keep_scale, seed,
                             stream);
    case 128:
      return launch_d<T, 128>(q, k, v, bias, dout, lse, delta, dq, B, H, Sq,
                              Sk, causal, scale, thresh, keep_scale, seed,
                              stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/dout [B,H,Sq,D], k/v [B,H,Sk,D] contiguous in one type (dtype 0 =
// float32, 1 = bfloat16); bias [B,Sk] float32 or null; lse and delta
// [B*H,Sq] float32; dq like q. Sq and Sk multiples of 64; D 32, 64 or 128.
extern "C" int flash_attention_bwd_dq(void* q, void* k, void* v, void* bias,
                                      void* dout, void* lse, void* delta,
                                      void* dq, int B, int H, int Sq, int Sk,
                                      int D, int dtype, int causal,
                                      float scale, unsigned int thresh,
                                      float keep_scale, unsigned int seed,
                                      void* stream) {
  if (Sq % kBQ != 0 || Sk % kBK != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = dtype == 0
      ? launch<float>(q, k, v, bias, dout, lse, delta, dq, B, H, Sq, Sk, D,
                      causal, scale, thresh, keep_scale, seed, s)
      : launch<__nv_bfloat16>(q, k, v, bias, dout, lse, delta, dq, B, H, Sq,
                              Sk, D, causal, scale, thresh, keep_scale, seed,
                              s);
  return (int)e;
}

extern "C" const char* flash_bwd_dq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
