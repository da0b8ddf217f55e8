// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: the library Pallas kernel that paddle_tpu/ops/paged_ops.py:239-251
// dispatches on a TPU (jax/experimental/pallas/ops/tpu/paged_attention/
// paged_attention_kernel.py:376, `paged_attention`).
//
// Computes, for every (sequence b, head h), one query position of attention
// over the K/V pages named by row b of the page table:
//
//     out[b,h] = softmax_t(q[b,h] . k_t * scale) . v_t      for t <= pos[b]
//
// which is exactly the plain version `paged_gather` + `cached_attention`
// (paddle_tpu_torch/ops/paged_ops.py): the plain version masks t > pos[b] to
// -1e30 so those terms are exactly 0; this kernel never reads them at all, so
// junk on the scratch page or past the sequence's end cannot reach the sum.
//
// Layouts: q [B,H,D]; k_pages/v_pages [H,N,P,D] (one layer of the pools);
// page_table [B,PP] int32; pos [B] int32 (pos >= 0); out [B,H,D] in q's type.
// float32 or bfloat16 pools; all statistics and sums in float32.
//
// Bound: bytes. The work reads K and V once: 2*B*H*len*D*sizeof(T) bytes, at
// about 2 flops a byte, far below the card's ~20 flops/byte fp32 ridge. The
// kernel reads each K/V row once, a warp-wide coalesced row load (D*4 bytes
// for fp32). Design: one block per (b, h); 8 warps stride over the sequence's
// tokens, 4 tokens per warp per iteration so 4 row loads are in flight, each
// warp keeps its own online-softmax state (max, sum, D-wide accumulator, f32)
// and the warps are merged through shared memory at the end.
// Known gap: at 8 slots x 12 heads the grid is 96 blocks, fewer than the 132
// SMs, so a long context leaves SMs idle; splitting the sequence across blocks
// (flash-decoding) is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ pos, T* __restrict__ out,
                    int H, int N, int P, int PP, float scale) {
  constexpr int DPL = D / 32;  // head-dim elements per lane
  __shared__ float m_w[kWarps];
  __shared__ float l_w[kWarps];
  __shared__ float acc_w[kWarps][D];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int len = pos[b] + 1;
  if (len > PP * P) len = PP * P;

  float qr[DPL];
  const T* qp = q + ((size_t)b * H + h) * D + lane * DPL;
#pragma unroll
  for (int i = 0; i < DPL; ++i) qr[i] = to_f(qp[i]);

  const int32_t* row = page_table + (size_t)b * PP;
  const size_t head_base = (size_t)h * N * P * D;
  float m = kNegInf, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int t0 = warp * kUnroll; t0 < len; t0 += kWarps * kUnroll) {
    size_t base[kUnroll];
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      s[u] = kNegInf;
      base[u] = 0;
      if (t < len) {
        const int page = row[t / P];
        base[u] = head_base + ((size_t)page * P + (t % P)) * D + lane * DPL;
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) d += qr[i] * to_f(k_pages[base[u] + i]);
        s[u] = d;
      }
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < len) {
        s[u] = warp_sum(s[u]) * scale;
        m_new = fmaxf(m_new, s[u]);
      }
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < len) {
        const float p = expf(s[u] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc[i] += p * to_f(v_pages[base[u] + i]);
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    m_w[warp] = m;
    l_w[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc_w[warp][lane * DPL + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < D) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_w[w] - mx);  // 0 for a warp that saw no token
      lsum += l_w[w] * c;
      o += acc_w[w][threadIdx.x] * c;
    }
    store(out + ((size_t)b * H + h) * D + threadIdx.x, o / lsum);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* pt, const void* pos, void* out, int B, int H,
                   int N, int P, int PP, int D, float scale,
                   cudaStream_t stream) {
  dim3 grid(B * H), block(kWarps * 32);
#define PTT_LAUNCH(DIM)                                                    \
  paged_decode_kernel<T, DIM><<<grid, block, 0, stream>>>(                 \
      (const T*)q, (const T*)kp, (const T*)vp, (const int32_t*)pt,         \
      (const int32_t*)pos, (T*)out, H, N, P, PP, scale)
  switch (D) {
    case 32: PTT_LAUNCH(32); break;
    case 64: PTT_LAUNCH(64); break;
    case 128: PTT_LAUNCH(128); break;
    default: return cudaErrorInvalidValue;
  }
#undef PTT_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
extern "C" int paged_attention_decode(void* q, void* k_pages, void* v_pages,
                                      void* page_table, void* pos, void* out,
                                      int B, int H, int N, int P, int PP,
                                      int D, int dtype, float scale,
                                      void* stream) {
  if (B <= 0 || H <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = dtype == 0
      ? launch<float>(q, k_pages, v_pages, page_table, pos, out, B, H, N, P,
                      PP, D, scale, s)
      : launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, pos, out, B,
                              H, N, P, PP, D, scale, s);
  return (int)e;
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
