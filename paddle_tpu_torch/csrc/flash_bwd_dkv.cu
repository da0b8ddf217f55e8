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
// of that when causal, against inputs read once; run on the float32 CUDA
// cores (67 TFLOP/s peak) in both input types, like K2.
//
// Design: one block of 256 threads per (64-key tile, b*h). The block owns
// its dK and dV rows, so the sums over queries stay in registers (a 4 x
// D/16 tile of each per thread) with no atomics, and the result does not
// depend on scheduling. K and V stay in shared memory; 64-query tiles of Q,
// dO, LSE and delta stream through, starting at the diagonal tile when
// causal (the TPU kernel's range, pallas_ops.py:298-300, for any tile
// sizes). Per query tile, S and dP come out of one pass over D, Pd and dS
// go to shared memory, and one pass over the queries accumulates both
// dV += Pd^T dO and dK += dS^T Q. Tensor cores and TMA are later work.
#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr int smem_floats() {
  return 4 * kBQ * (D + 1) + 2 * kBQ * (kBK + 1) + 2 * kBQ;
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
  constexpr int DS = D + 1;
  constexpr int SS = kBK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * DS;
  float* Qs = Vs + kBK * DS;
  float* dOs = Qs + kBQ * DS;
  float* Ps = dOs + kBQ * DS;   // [query][key] dropped probabilities
  float* Ds = Ps + kBQ * SS;    // [query][key] dS
  float* lse_s = Ds + kBQ * SS;
  float* dl_s = lse_s + kBQ;

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t koff = ((size_t)bh * Sk + (size_t)kt * kBK) * D;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* ob = dout + (size_t)bh * Sq * D;
  const float* brow = bias != nullptr ? bias + (size_t)b * Sk : nullptr;

  load_tile<T, D>(Ks, k + koff, kBK, tid);
  load_tile<T, D>(Vs, v + koff, kBK, tid);
  // this thread's score columns (keys tx + 16 j): their bias never changes
  float kbias[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    kbias[j] = brow != nullptr ? brow[kt * kBK + tx + 16 * j] : 0.f;
  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int nqb = Sq / kBQ;
  const int first = causal ? (kt * kBK) / kBQ : 0;
  for (int qt = first; qt < nqb; ++qt) {
    __syncthreads();  // the previous tile's Q/dO/Pd/dS reads are done
    load_tile<T, D>(Qs, qb + (size_t)qt * kBQ * D, kBQ, tid);
    load_tile<T, D>(dOs, ob + (size_t)qt * kBQ * D, kBQ, tid);
    if (tid < kBQ) {
      lse_s[tid] = lse[(size_t)bh * Sq + (size_t)qt * kBQ + tid];
      dl_s[tid] = delta[(size_t)bh * Sq + (size_t)qt * kBQ + tid];
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: queries ty + 16 i, keys tx + 16 j
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
      const int qpos = qt * kBQ + r;
      const uint32_t row_hash = thresh ? drop_row(seed, bh, qpos) : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = kt * kBK + c;
        float x = s[i][j] * scale + kbias[j];
        if (causal && kpos > qpos) x = kNegInf;
        const float p = expf(x - lse_s[r]);
        float g = dp[i][j], pd = p;
        if (thresh) {
          const bool keep = drop_keep(row_hash, kpos, thresh);
          g = keep ? g * keep_scale : 0.f;
          pd = keep ? p * keep_scale : 0.f;
        }
        Ps[r * SS + c] = pd;
        Ds[r * SS + c] = p * (g - dl_s[r]);
      }
    }
    __syncthreads();

    // dV += Pd^T dO and dK += dS^T Q: keys ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int c = 0; c < kBQ; ++c) {
      float pv[4], sv[4], ov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[c * SS + ty + 16 * i];
        sv[i] = Ds[c * SS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ov[j] = dOs[c * DS + tx + 16 * j];
        qv[j] = Qs[c * DS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          acc_v[i][j] += pv[i] * ov[j];
          acc_k[i][j] += sv[i] * qv[j];
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const size_t off = koff + (size_t)(ty + 16 * i) * D + tx + 16 * j;
      store(dk + off, acc_k[i][j] * scale);
      store(dv + off, acc_v[i][j]);
    }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* bias, const void* dout, const void* lse,
                     const void* delta, void* dk, void* dv, int B, int H,
                     int Sq, int Sk, int causal, float scale, uint32_t thresh,
                     float keep_scale, uint32_t seed, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(Sk / kBK, B * H), block(kThreads);
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
// float32, 1 = bfloat16); bias [B,Sk] float32 or null; lse and delta
// [B*H,Sq] float32; dk/dv like k. Sq and Sk multiples of 64; D 32, 64, 128.
extern "C" int flash_attention_bwd_dkv(void* q, void* k, void* v, void* bias,
                                       void* dout, void* lse, void* delta,
                                       void* dk, void* dv, int B, int H,
                                       int Sq, int Sk, int D, int dtype,
                                       int causal, float scale,
                                       unsigned int thresh, float keep_scale,
                                       unsigned int seed, void* stream) {
  if (Sq % kBQ != 0 || Sk % kBK != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sk <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = dtype == 0
      ? launch<float>(q, k, v, bias, dout, lse, delta, dk, dv, B, H, Sq, Sk,
                      D, causal, scale, thresh, keep_scale, seed, s)
      : launch<__nv_bfloat16>(q, k, v, bias, dout, lse, delta, dk, dv, B, H,
                              Sq, Sk, D, causal, scale, thresh, keep_scale,
                              seed, s);
  return (int)e;
}

extern "C" const char* flash_bwd_dkv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
