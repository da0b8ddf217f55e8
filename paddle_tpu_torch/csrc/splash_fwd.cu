// Splash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: paddle_tpu/ops/splash_ops.py:139 `_fwd_kernel` (launched by
// `_splash_call`, splash_ops.py:326), dropout on the probabilities included.
//
// Computes, per (b, h), for packed rows with segment ids (q sees k iff
// qseg[i] == kseg[j], and j <= i when causal):
//
//     S = Q K^T * scale;  S[i,j] = -1e30 where masked
//     P = masked ? 0 : exp(S - m);  l = rowsum(P)   (l summed BEFORE dropout)
//     O = (keep ? P / (1-p) : 0) V / l_safe         (O in q's type)
//     LSE[i] = m_i + log(l_safe_i)                  (float32, [B*H, S])
//
// with l_safe = l, or 1 for a row with no visible key (its O is then 0), as
// the TPU kernel's `l_safe` (splash_ops.py:183); the plain version is
// `_splash_fwd_reference` (paddle_tpu_torch/ops/splash_ops.py). The keep
// mask is the coordinate hash of flash_common.cuh, `thresh == 0` skipping it.
//
// Bound: operations. S and O are two products of 2*D flops for each allowed
// (query, key) pair; the inputs are read once. This first design runs them
// on the float32 CUDA cores (67 TFLOP/s peak), in both input types, and
// pays for every pair of a visited 64x64 tile, allowed or not.
//
// Design: K2's (flash_fwd.cu): one block of 256 threads per (64-query tile,
// b*h), the Q tile and its segment ids in shared memory, 64-key K/V tiles
// and their ids streaming through, 4x4 score register tiles, the online
// softmax by 4 threads per row, O in a 4 x D/16 register tile per thread.
// What splash adds: the key loop runs only over the wrapper's [kv_lo, kv_hi)
// for this (b, query tile), so key tiles of other segments are never loaded;
// and the segment test is applied twice, to the scores (-1e30) and to P (0).
// Known gap: tensor cores (mma.sync / wgmma) and TMA are later work.
#include "splash_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr int smem_floats() {
  // Q, K, V tiles; S/P tile; m, l, alpha; query and key segment ids
  return 3 * kBQ * (D + 1) + kBQ * (kBK + 1) + 3 * kBQ + kBQ + kBK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
splash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ qseg,
                  const int* __restrict__ kseg,
                  const int* __restrict__ kv_lo,
                  const int* __restrict__ kv_hi, T* __restrict__ out,
                  float* __restrict__ lse, int H, int S, int causal,
                  float scale, uint32_t thresh, float keep_scale,
                  uint32_t seed) {
  constexpr int DS = D + 1;    // padded shared row stride of Q/K/V
  constexpr int SS = kBK + 1;  // padded shared row stride of S/P
  constexpr int DJ = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * DS;
  float* Vs = Ks + kBK * DS;
  float* Ss = Vs + kBK * DS;
  float* m_s = Ss + kBQ * SS;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;
  int* qs_s = reinterpret_cast<int*>(a_s + kBQ);
  int* ks_s = qs_s + kBQ;

  const int qi = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int nt = S / kBK;
  const T* kb = k + (size_t)bh * S * D;
  const T* vb = v + (size_t)bh * S * D;
  const int* ksrow = kseg + (size_t)b * S;

  load_tile<T, D>(Qs, q + ((size_t)bh * S + (size_t)qi * kBQ) * D, kBQ, tid);
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    qs_s[tid] = qseg[(size_t)b * S + (size_t)qi * kBQ + tid];
  }
  // the softmax below gives each thread one row: its dropout hash prefix
  const int srow_i = tid / 4, part = tid % 4;
  const int srow_pos = qi * kBQ + srow_i;
  const uint32_t row_hash = thresh ? drop_row(seed, bh, srow_pos) : 0u;
  float o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;

  int first, last;
  tile_span(kv_lo, kv_hi, b * (S / kBQ) + qi, nt, &first, &last);
  for (int t = first; t < last; ++t) {
    __syncthreads();  // the previous tile's K/V/P/id reads are done
    load_tile<T, D>(Ks, kb + (size_t)t * kBK * D, kBK, tid);
    load_tile<T, D>(Vs, vb + (size_t)t * kBK * D, kBK, tid);
    if (tid < kBK) ks_s[tid] = ksrow[t * kBK + tid];
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = qi * kBQ + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        Ss[r * SS + c] = seg_allowed(qs_s[r], ks_s[c], qpos, t * kBK + c,
                                     causal)
                             ? s[i][j] * scale
                             : kNegInf;
      }
    }
    __syncthreads();

    // online softmax over the tile: 4 neighbouring threads per row
    {
      float* srow = Ss + srow_i * SS + part * (kBK / 4);
      const int* ksp = ks_s + part * (kBK / 4);
      const int qs_row = qs_s[srow_i];
      const float m_old = m_s[srow_i];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kBK / 4; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kBK / 4; ++c) {
        const int kpos = t * kBK + part * (kBK / 4) + c;
        const float p = seg_allowed(qs_row, ksp[c], srow_pos, kpos, causal)
                            ? expf(srow[c] - m_new)
                            : 0.f;
        sum += p;
        srow[c] = (thresh == 0u || drop_keep(row_hash, kpos, thresh))
                      ? p * keep_scale : 0.f;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[srow_i] = alpha;
        l_s[srow_i] = alpha * l_s[srow_i] + sum;
        m_s[srow_i] = m_new;
      }
    }
    __syncthreads();

    // O = alpha O + P V: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * SS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * DS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) o[i][j] += pv[i] * vv[j];
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)bh * S + (size_t)qi * kBQ) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float l = l_s[r];
    const float inv = 1.f / (l > 0.f ? l : 1.f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(ob + (size_t)r * D + tx + 16 * j,
                                       o[i][j] * inv);
  }
  if (tid < kBQ) {
    const float l = l_s[tid];
    lse[(size_t)bh * S + (size_t)qi * kBQ + tid] =
        m_s[tid] + logf(l > 0.f ? l : 1.f);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* qseg, const int* kseg, const int* lo,
                     const int* hi, void* out, float* lse, int B, int H,
                     int S, int causal, float scale, uint32_t thresh,
                     float keep_scale, uint32_t seed, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      splash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(S / kBQ, B * H), block(kThreads);
  splash_fwd_kernel<T, D><<<grid, block, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, qseg, kseg, lo, hi, (T*)out,
      lse, H, S, causal, scale, thresh, keep_scale, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* qseg, const int* kseg, const int* lo,
                   const int* hi, void* out, float* lse, int B, int H, int S,
                   int D, int causal, float scale, uint32_t thresh,
                   float keep_scale, uint32_t seed, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, qseg, kseg, lo, hi, out, lse, B, H, S,
                             causal, scale, thresh, keep_scale, seed, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, qseg, kseg, lo, hi, out, lse, B, H, S,
                             causal, scale, thresh, keep_scale, seed, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, qseg, kseg, lo, hi, out, lse, B, H, S,
                              causal, scale, thresh, keep_scale, seed,
                              stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v [B,H,S,D] contiguous in one type (dtype 0 = float32, 1 = bfloat16);
// qseg/kseg [B,S] int32, non-decreasing per row; kv_lo/kv_hi [B,S/64] int32
// (the key-tile span of each query tile); out like q; lse [B*H,S] float32.
// Self-attention only (Sq == Sk), a multiple of 64; D one of 32, 64, 128.
// Dropout: keep where hash >= thresh (thresh 0 = no dropout), kept P scaled
// by keep_scale.
extern "C" int splash_attention_forward(void* q, void* k, void* v,
                                        void* qseg, void* kseg, void* kv_lo,
                                        void* kv_hi, void* out, void* lse,
                                        int B, int H, int Sq, int Sk, int D,
                                        int dtype, int causal, float scale,
                                        unsigned int thresh, float keep_scale,
                                        unsigned int seed, void* stream) {
  if (Sq != Sk || Sq % kBQ != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* qs = (const int*)qseg;
  const int* ks = (const int*)kseg;
  const int* lo = (const int*)kv_lo;
  const int* hi = (const int*)kv_hi;
  cudaError_t e = dtype == 0
      ? launch<float>(q, k, v, qs, ks, lo, hi, out, (float*)lse, B, H, Sq, D,
                      causal, scale, thresh, keep_scale, seed, s)
      : launch<__nv_bfloat16>(q, k, v, qs, ks, lo, hi, out, (float*)lse, B, H,
                              Sq, D, causal, scale, thresh, keep_scale, seed,
                              s);
  return (int)e;
}

extern "C" const char* splash_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
