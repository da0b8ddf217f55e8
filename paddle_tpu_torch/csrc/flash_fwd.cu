// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: paddle_tpu/ops/pallas_ops.py:143 `_fwd_kernel` (launched by
// `_flash_call`, pallas_ops.py:327), dropout on the probabilities included.
//
// Computes, per (b, h), with an optional additive key bias [B,Sk] and an
// optional causal mask (top-left aligned, query i sees keys j <= i):
//
//     S = Q K^T * scale + bias;  S[i,j] = -1e30 where causal and j > i
//     P = exp(S - m);  l = rowsum(P)          (l summed BEFORE dropout)
//     O = (keep ? P / (1-p) : 0) V / l        (O in q's type)
//     LSE[i] = m_i + log(l_i)                 (float32, [B*H, Sq])
//
// the plain version `_flash_fwd_reference` (paddle_tpu_torch/ops/
// flash_ops.py), as the TPU kernel does (pallas_ops.py:168-178). The keep
// mask is the coordinate hash of flash_common.cuh; `thresh == 0` (p = 0,
// the serving path) skips it, and then the arithmetic is unchanged. LSE is
// the row statistic the backward kernels (K3, K4) read.
//
// Bound: operations. S and O are two products of 2*Sq*Sk*D flops each (half
// of that when causal); the inputs are read once, (Sq + 2*Sk)*D elements per
// head, so at D=64 the work is ~2*Sk/3 flops a byte: far above the bytes
// ridge. This first design runs them on the float32 CUDA cores (67 TFLOP/s
// peak), not the tensor cores, in both input types: inputs are widened to
// float32 in shared memory.
//
// Design: one block of 256 threads per (64-query tile, b*h). The Q tile stays
// in shared memory; 64-key K/V tiles stream through it, the loop stopping at
// the diagonal tile when causal (cut-off computed for any tile sizes). Per
// tile: a 64x64 score tile by a 4x4 register tile per thread, an online
// softmax over it by 4 threads per row (f32 max/sum, -1e30 masking, the
// running max starting at -1e30 like the TPU kernel, so a row whose every
// score is -1e30 gives the uniform row of the plain version and never NaN),
// dropout applied to P after its row sum, then O += P V into a 4 x D/16
// register tile per thread. Shared rows are padded by one float to keep the
// column reads free of bank conflicts.
// Known gap: tensor cores (mma.sync / wgmma) and TMA are later work.
#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr int smem_floats() {
  return 3 * kBQ * (D + 1) + kBQ * (kBK + 1) + 3 * kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Sq,
                 int Sk, int causal, float scale, uint32_t thresh,
                 float keep_scale, uint32_t seed) {
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

  const int qi = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;
  const float* brow = bias != nullptr ? bias + (size_t)b * Sk : nullptr;

  load_tile<T, D>(Qs, q + ((size_t)bh * Sq + (size_t)qi * kBQ) * D, kBQ, tid);
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  // the softmax below gives each thread one row: its dropout hash prefix
  const int srow_i = tid / 4, part = tid % 4;
  const uint32_t row_hash =
      thresh ? drop_row(seed, bh, qi * kBQ + srow_i) : 0u;
  float o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;

  const int nkb = Sk / kBK;
  int last = nkb;
  if (causal) {
    const int diag = ((qi + 1) * kBQ + kBK - 1) / kBK;
    last = diag < nkb ? diag : nkb;
  }
  for (int t = 0; t < last; ++t) {
    __syncthreads();  // the previous tile's K/V/P reads are done
    load_tile<T, D>(Ks, kb + (size_t)t * kBK * D, kBK, tid);
    load_tile<T, D>(Vs, vb + (size_t)t * kBK * D, kBK, tid);
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
        const int kpos = t * kBK + c;
        float x = s[i][j] * scale;
        if (brow != nullptr) x += brow[kpos];
        if (causal && kpos > qpos) x = kNegInf;
        Ss[r * SS + c] = x;
      }
    }
    __syncthreads();

    // online softmax over the tile: 4 neighbouring threads per row
    {
      float* srow = Ss + srow_i * SS + part * (kBK / 4);
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
        const float p = expf(srow[c] - m_new);
        sum += p;
        const int kpos = t * kBK + part * (kBK / 4) + c;
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

  T* ob = out + ((size_t)bh * Sq + (size_t)qi * kBQ) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float inv = 1.f / l_s[r];
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(ob + (size_t)r * D + tx + 16 * j,
                                       o[i][j] * inv);
  }
  if (tid < kBQ)
    lse[(size_t)bh * Sq + (size_t)qi * kBQ + tid] = m_s[tid] + logf(l_s[tid]);
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* bias, void* out, float* lse, int B, int H,
                     int Sq, int Sk, int causal, float scale, uint32_t thresh,
                     float keep_scale, uint32_t seed, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(Sq / kBQ, B * H), block(kThreads);
  flash_fwd_kernel<T, D><<<grid, block, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)out,
      lse, H, Sq, Sk, causal, scale, thresh, keep_scale, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, float* lse, int B, int H,
                   int Sq, int Sk, int D, int causal, float scale,
                   uint32_t thresh, float keep_scale, uint32_t seed,
                   cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, bias, out, lse, B, H, Sq, Sk, causal,
                             scale, thresh, keep_scale, seed, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, bias, out, lse, B, H, Sq, Sk, causal,
                             scale, thresh, keep_scale, seed, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, bias, out, lse, B, H, Sq, Sk, causal,
                              scale, thresh, keep_scale, seed, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,Sq,D], k/v [B,H,Sk,D] contiguous in one type (dtype 0 = float32,
// 1 = bfloat16); bias [B,Sk] float32 or null; out like q; lse [B*H,Sq] f32.
// Sq and Sk must be multiples of 64; D one of 32, 64, 128. Dropout: keep
// where hash >= thresh (thresh 0 = no dropout), kept P scaled by keep_scale.
extern "C" int flash_attention_forward(void* q, void* k, void* v, void* bias,
                                       void* out, void* lse, int B, int H,
                                       int Sq, int Sk, int D, int dtype,
                                       int causal, float scale,
                                       unsigned int thresh, float keep_scale,
                                       unsigned int seed, void* stream) {
  if (Sq % kBQ != 0 || Sk % kBK != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = dtype == 0
      ? launch<float>(q, k, v, bias, out, (float*)lse, B, H, Sq, Sk, D,
                      causal, scale, thresh, keep_scale, seed, s)
      : launch<__nv_bfloat16>(q, k, v, bias, out, (float*)lse, B, H, Sq, Sk,
                              D, causal, scale, thresh, keep_scale, seed, s);
  return (int)e;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
