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
// of that when causal, against inputs read once. They run on the tensor
// cores (flash_mma.cuh): bf16 or fp16 operands on mma.sync m16n8k16 (989
// TFLOP/s peak), fp32 as 3xTF32 on mma.sync m16n8k8 (495 / 3 = 165 TFLOP/s
// of fp32-accurate products). In bf16 and fp16, dS is rounded to K's type
// before dS K, as the TPU kernel casts it (pallas_ops.py:238).
//
// Design: one block of 4 warps per (64-query tile, b*h), no atomics: the
// block owns its dQ rows, each warp 16 of them, and loops over key tiles
// (64 keys; 32 above D 64, to keep the registers free of spills, 16 in fp32
// above D 128, for shared memory; every D % 8 == 0 up to 256 at a padded
// width, flash_mma.cuh "Head dims"; in fp32 above D 192 two blocks share
// the rows, one column half each), stopping at
// the diagonal tile when causal (the TPU kernel's range,
// pallas_ops.py:243-245). Q and dO stay in shared memory in their input
// type; K, V and the bias tile are double-buffered with 16-byte cp.async,
// so the next tile's copy overlaps this tile's products. Tiles are XOR-
// swizzled so ldmatrix (bf16) and the 32-bit fragment loads (tf32) are free
// of bank conflicts. S and dP come out of mma in accumulator fragments
// (queries as rows), dS is formed there, and that fragment is the A operand
// of dQ += dS K with K's fragments read transposed (ldmatrix.trans in bf16):
// dS never goes through shared memory. Warps whose rows lie wholly below
// the diagonal skip the mask test; the query tiles run heaviest first
// (the last query tile has the most keys), so long blocks do not form the
// tail.
//
// Why mma.sync and not wgmma: the main path's type is fp32, and tf32 wgmma
// takes both operands K-major from shared memory only (its transpose bit is
// for 16-bit types). K in dS K arrives MN-major, so fp32 wgmma would need a
// transposing copy of every K tile; one mma.sync fragment path serves both
// types.
#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int kBQ = 64;       // query rows a block
constexpr int kWarps = 4;     // 16 query rows a warp
constexpr int kThreads = 32 * kWarps;

// keys a tile, at the padded width DP (K2's rule): 64; 32 above DP 64, to
// keep the registers free of spills; 16 in fp32 above DP 128, so that Q,
// dO and the double-buffered K and V tiles fit in shared memory
template <typename T, int DP>
constexpr int kKeyTile =
    DP <= 64 ? 64 : (std::is_same<T, float>::value && DP > 128) ? 16 : 32;

// In fp32 above DP 192 the [16, DP] accumulator and the streamed tiles'
// tf32 splits outgrow 255 registers: a block then owns one of two column
// halves of its dQ rows (blockIdx.z) and recomputes S and dP for it, as
// K4 splits dK and dV
template <typename T, int DP>
constexpr int kParts = std::is_same<T, float>::value && DP > 192 ? 2 : 1;

// Padded widths compute their global offsets at run time, and ptxas,
// aiming at 168 registers (3 blocks an SM) there, spilled at bf16 width 64
// and fp32 width 32; a floor of 2 blocks lets it take up to 255. The
// exact widths keep the bound they were tuned with.
constexpr int kMinBlocks = 2;

template <typename T, int DP>
constexpr int smem_bytes() {
  return (2 * kBQ * DP + 4 * kKeyTile<T, DP> * DP) * (int)sizeof(T)
         + 2 * kKeyTile<T, DP> * (int)sizeof(float);
}

// DP: the padded width of the tiles; with kPad the head dim is the
// run-time d (global row stride, d <= DP), else DP itself
template <typename T, int DP, bool kPad>
__device__ __forceinline__ void
flash_bwd_dq_body(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ bias,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int H,
                  int Sq, int Sk, int d, int causal, float scale,
                  uint32_t thresh, float keep_scale,
                  uint32_t seed, int hg, int hoff) {
  constexpr int BK = kKeyTile<T, DP>;
  constexpr int NT = BK / 8;   // score n-tiles a warp
  constexpr int DC = DP / kParts<T, DP>;   // output columns a block
  const int D = kPad ? d : DP;
  // this block's first column (0 unless the output is split)
  const int c0 = kParts<T, DP> > 1 ? (int)blockIdx.z * DC : 0;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kBQ * DP;
  T* Ks = dOs + kBQ * DP;           // [2][BK * DP]
  T* Vs = Ks + 2 * BK * DP;         // [2][BK * DP]
  float* bs = reinterpret_cast<float*>(Vs + 2 * BK * DP);   // [2][BK]

  const int bh = blockIdx.x;
  const int qi = gridDim.y - 1 - blockIdx.y;   // heaviest tile first
  const int b = bh / H;
  // the dropout key: the global head b*hg + hoff + h (see drop_row)
  const uint32_t dbh = bh + b * (hg - H) + hoff;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qi * kBQ;
  const size_t qoff = ((size_t)bh * Sq + q0) * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;
  const float* brow = bias != nullptr ? bias + (size_t)b * Sk : nullptr;

  const int nkb = Sk / BK;
  int last = nkb;
  if (causal) {
    const int diag = (q0 + kBQ + BK - 1) / BK;
    last = diag < nkb ? diag : nkb;
  }
  auto fetch = [&](int t) {
    const int buf = t & 1;
    fmma::load_tile_async<T, DP, BK, kThreads, kPad>(
        Ks + buf * BK * DP, kb + (size_t)t * BK * D, tid, D);
    fmma::load_tile_async<T, DP, BK, kThreads, kPad>(
        Vs + buf * BK * DP, vb + (size_t)t * BK * D, tid, D);
    if (brow != nullptr)
      fmma::load_vec_async<kThreads>(bs + buf * BK, brow + t * BK, BK, tid);
  };
  fmma::load_tile_async<T, DP, kBQ, kThreads, kPad>(Qs, q + qoff, tid, D);
  fmma::load_tile_async<T, DP, kBQ, kThreads, kPad>(dOs, dout + qoff, tid,
                                                    D);
  if (last > 0) fetch(0);
  fmma::cp_async_commit();

  // this thread's two query rows (g and g + 8 of its warp's 16)
  const int r0 = 16 * warp + g;
  int qpos[2];
  float lse_r[2], dl_r[2];
  uint32_t rh[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qpos[h] = q0 + r0 + 8 * h;
    lse_r[h] = lse[(size_t)bh * Sq + qpos[h]];
    dl_r[h] = delta[(size_t)bh * Sq + qpos[h]];
    rh[h] = thresh ? flash::drop_row(seed, dbh, qpos[h]) : 0u;
  }
  float acc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < last; ++t) {
    if (t + 1 < last) {
      fetch(t + 1);   // its buffer's reads ended at the last iteration's sync
      fmma::cp_async_commit();
      fmma::cp_async_wait<1>();
    } else {
      fmma::cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = t & 1;
    const T* Kt = Ks + buf * BK * DP;
    const T* Vt = Vs + buf * BK * DP;
    const float* bt = bs + buf * BK;
    const int k0 = t * BK;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    fmma::mma_abt<T, DP, NT>(s, Qs, 16 * warp, Kt, 0, lane);
    fmma::mma_abt<T, DP, NT>(dp, dOs, 16 * warp, Vt, 0, lane);

    // dS in place of S: rows qpos[e / 2], keys k0 + 8 j + 2 t4 + e % 2
    const bool mask = causal && k0 + BK - 1 > q0 + 16 * warp;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int c = 8 * j + 2 * t4 + (e & 1);
        float x = s[j][e] * scale;
        if (brow != nullptr) x += bt[c];
        if (mask && k0 + c > qpos[h]) x = flash::kNegInf;
        const float p = expf(x - lse_r[h]);
        float gd = dp[j][e];
        if (thresh)
          gd = flash::drop_keep(rh[h], k0 + c, thresh) ? gd * keep_scale
                                                        : 0.f;
        s[j][e] = p * (gd - dl_r[h]);
      }
    fmma::mma_pb<T, DP, NT, DC>(acc, s, Kt, 0, lane, c0);
    __syncthreads();   // this tile's K/V/bias reads are done
  }
  fmma::cp_async_wait<0>();   // nothing left in flight (no key tile at all)

  fmma::store_rows<T, DC, kPad>(dq + qoff + (size_t)16 * warp * D + c0,
                                acc, scale, lane, D, D - c0);
}

// Two entries over one body: the exact widths (kPad false) with the launch
// bound they were tuned with, the padded widths with kMinBlocks.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int H,
                    int Sq, int Sk, int d, int causal, float scale,
                    uint32_t thresh, float keep_scale,
                    uint32_t seed, int hg, int hoff) {
  flash_bwd_dq_body<T, DP, false>(
      q, k, v, bias, dout, lse, delta, dq, H, Sq, Sk, d, causal, scale, thresh,
      keep_scale, seed, hg, hoff);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dq_kernel_pad(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int H, int Sq, int Sk, int d, int causal, float scale,
                        uint32_t thresh, float keep_scale,
                        uint32_t seed, int hg, int hoff) {
  flash_bwd_dq_body<T, DP, true>(
      q, k, v, bias, dout, lse, delta, dq, H, Sq, Sk, d, causal, scale, thresh,
      keep_scale, seed, hg, hoff);
}

// the entry of width DP: the exact one, or the padded one
template <typename T, int DP, bool kPad>
auto kernel_for() {
  if constexpr (kPad) return flash_bwd_dq_kernel_pad<T, DP>;
  else return flash_bwd_dq_kernel<T, DP>;
}

template <typename T, int DP, bool kPad>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* bias, const void* dout, const void* lse,
                     const void* delta, void* dq, int B, int H, int Sq,
                     int Sk, int D, int causal, float scale, uint32_t thresh,
                     float keep_scale,
                     uint32_t seed, int hg, int hoff, cudaStream_t stream) {
  const int bytes = smem_bytes<T, DP>();
  auto* kernel = kernel_for<T, DP, kPad>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, Sq / kBQ, kParts<T, DP>), block(kThreads);
  kernel<<<grid, block, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq, H, Sq,
      Sk, D, causal, scale, thresh, keep_scale, seed, hg, hoff);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* dout, const void* lse,
                   const void* delta, void* dq, int B, int H, int Sq, int Sk,
                   int D, int causal, float scale, uint32_t thresh,
                   float keep_scale,
                   uint32_t seed, int hg, int hoff, cudaStream_t stream) {
  return fmma::dispatch_width<T>(D, [&](auto dp, auto pad) {
    return launch_d<T, decltype(dp)::value, decltype(pad)::value>(
        q, k, v, bias, dout, lse, delta, dq, B, H, Sq, Sk, D, causal, scale,
        thresh, keep_scale, seed, hg, hoff, stream);
  });
}

}  // namespace

// q/dout [B,H,Sq,D], k/v [B,H,Sk,D] contiguous in one type (dtype 0 =
// float32, 1 = bfloat16, 2 = float16); bias [B,Sk] float32 or null; lse
// and delta [B*H,Sq] float32; dq like q.
// Sq and Sk multiples of 64; D % 8 == 0, D <= 256.
// Dropout rows are keyed on the global head: this call holds H of hg
// heads, from head hoff (hg = H, hoff = 0 for all of them).
extern "C" int flash_attention_bwd_dq(void* q, void* k, void* v, void* bias,
                                      void* dout, void* lse, void* delta,
                                      void* dq, int B, int H, int Sq, int Sk,
                                      int D, int dtype, int causal,
                                      float scale, unsigned int thresh,
                                      float keep_scale,
                                      unsigned int seed, int hg, int hoff,
                                      void* stream) {
  if (Sq % 64 != 0 || Sk % 64 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return (int)launch<float>(q, k, v, bias, dout, lse, delta, dq, B, H, Sq,
                                Sk, D, causal, scale, thresh, keep_scale,
                                seed, hg, hoff, s);
    case 1:
      return (int)launch<__nv_bfloat16>(q, k, v, bias, dout, lse, delta, dq,
                                        B, H, Sq, Sk, D, causal, scale,
                                        thresh, keep_scale, seed, hg, hoff, s);
    case 2:
      return (int)launch<__half>(q, k, v, bias, dout, lse, delta, dq, B, H,
                                 Sq, Sk, D, causal, scale, thresh,
                                 keep_scale, seed, hg, hoff, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_bwd_dq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
