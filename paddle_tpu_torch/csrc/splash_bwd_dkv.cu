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
// dP, dV, dK), against inputs read once; run on the float32 CUDA cores (67
// TFLOP/s peak) in both input types, like K5.
//
// Design: K4's (flash_bwd_dkv.cu): one block of 256 threads per (64-key
// tile, b*h) that owns its dK and dV rows in registers, so there are no
// atomics and the result does not depend on scheduling; K, V and the key
// ids in shared memory; 64-query tiles of Q, dO, LSE, delta and their ids
// stream through. The query loop runs over the wrapper's transposed span
// [q_lo, q_hi) for this (b, key tile): the query tiles that hold the key
// tile's segments, from the diagonal tile on when causal. Tensor cores and
// TMA are later work.
#include "splash_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr int smem_floats() {
  // K, V, Q, dO tiles; Pd and dS tiles; LSE, delta; query and key ids
  return 4 * kBQ * (D + 1) + 2 * kBQ * (kBK + 1) + 2 * kBQ + kBQ + kBK;
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
  int* qs_s = reinterpret_cast<int*>(dl_s + kBQ);
  int* ks_s = qs_s + kBQ;

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int nt = S / kBQ;
  const size_t koff = ((size_t)bh * S + (size_t)kt * kBK) * D;
  const T* qb = q + (size_t)bh * S * D;
  const T* ob = dout + (size_t)bh * S * D;
  const int* qsrow = qseg + (size_t)b * S;

  load_tile<T, D>(Ks, k + koff, kBK, tid);
  load_tile<T, D>(Vs, v + koff, kBK, tid);
  if (tid < kBK) ks_s[tid] = kseg[(size_t)b * S + (size_t)kt * kBK + tid];
  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  int first, last;
  tile_span(q_lo, q_hi, b * (S / kBK) + kt, nt, &first, &last);
  for (int qt = first; qt < last; ++qt) {
    __syncthreads();  // the previous tile's Q/dO/Pd/dS/id reads are done
    load_tile<T, D>(Qs, qb + (size_t)qt * kBQ * D, kBQ, tid);
    load_tile<T, D>(dOs, ob + (size_t)qt * kBQ * D, kBQ, tid);
    if (tid < kBQ) {
      lse_s[tid] = lse[(size_t)bh * S + (size_t)qt * kBQ + tid];
      dl_s[tid] = delta[(size_t)bh * S + (size_t)qt * kBQ + tid];
      qs_s[tid] = qsrow[qt * kBQ + tid];
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
        const float p = seg_allowed(qs_s[r], ks_s[c], qpos, kpos, causal)
                            ? expf(s[i][j] * scale - lse_s[r])
                            : 0.f;
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
                     const int* qseg, const int* kseg, const int* lo,
                     const int* hi, const void* dout, const void* lse,
                     const void* delta, void* dk, void* dv, int B, int H,
                     int S, int causal, float scale, uint32_t thresh,
                     float keep_scale, uint32_t seed, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      splash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(S / kBK, B * H), block(kThreads);
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
// query-tile span of each key tile); lse and delta [B*H,S] float32; dk/dv
// like k. Self-attention only (Sq == Sk), a multiple of 64; D 32, 64, 128.
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
