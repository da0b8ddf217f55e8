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
// `_splash_fwd_reference` (paddle_tpu_torch/ops/splash_ops.py). Masked
// entries get P = 0 from the segment test, never from exp(-1e30 - m), which
// is 1 while a row has seen no visible key. In bf16, P is rounded to bf16
// before P V, as the TPU kernel casts it to V's type (splash_ops.py:172-174).
// The keep mask is the coordinate hash of flash_common.cuh (K6 and K7
// replay it); `thresh == 0` skips it.
//
// Bound: operations. S and O are two products of 2*D flops for each allowed
// (query, key) pair, against inputs read once. They run on the tensor cores
// (flash_mma.cuh): bf16 operands on mma.sync m16n8k16 (989 TFLOP/s peak),
// fp32 as 3xTF32 on mma.sync m16n8k8 (495 / 3 = 165 TFLOP/s of
// fp32-accurate products). Beyond the bound, every pair of a visited tile
// is multiplied, allowed or not: the spans cut whole tiles of other
// segments, and the rest of the masked work stays (as in K6 and K7, where
// skipping it inside the products measured slower, PERF.md §6).
//
// Design: K2's block layout (flash_fwd.cu) walked over K6's spans
// (splash_bwd_dq.cu). One block of 4 warps per (64-query tile, b*h), each
// warp owning 16 query rows; query tiles run last first, as K6's do. Q
// stays in shared memory in its input type, XOR-swizzled, and its A
// fragments are formed once and held in registers, except in fp32 at D 128
// (128 registers of tf32 hi/lo), where they are formed from the shared tile
// at every key tile, as in K2. K, V and the key segment ids are
// double-buffered with 16-byte cp.async, so the next key tile's copy
// overlaps this tile's products. The key loop runs over the wrapper's
// [kv_lo, kv_hi) for this (b, query tile), counted in 64-key units and
// walked in tiles of 64 keys (32 at D 128, where the [16, 128] accumulator
// takes the registers); tiles outside the span are never loaded. S comes
// out of mma in accumulator fragments (thread (g, t) holds rows g and g+8,
// columns 2t, 2t+1 of each n-tile); the segment test, the online softmax
// (row max and sum over the quad's 4 lanes), dropout and the rescale of O
// all work there, and that fragment is the A operand of O += P V: S and P
// never go through shared memory. The query ids are per row and stay in
// registers; the key ids come from the shared id tile.
//
// One-segment tiles. The ids are non-decreasing, so a warp's 16 rows and a
// key tile lie in one segment exactly when four ids are equal: the warp's
// first and last query ids and the tile's first and last key ids. When they
// are, and under causal the tile's last key is at or before the warp's
// first query, every pair is allowed, and the warp runs the softmax step
// without the per-element test (`_uniform_tiles` in ops/splash_ops.py
// counts these pairs), as K2 skips the causal test below the diagonal. The
// branch is warp-uniform and lies outside the unrolled mma.sync loops.
//
// Why mma.sync and not wgmma: K2's reason. The main path's type is fp32,
// and tf32 wgmma takes B only K-major from shared memory; V in P V is
// MN-major, so fp32 wgmma would need a transposing copy of every V tile.
#include "flash_mma.cuh"
#include "splash_common.cuh"

namespace {

constexpr int kBQ = 64;       // query rows a block
constexpr int kUnit = 64;     // the wrapper's span unit, in keys
constexpr int kWarps = 4;     // 16 query rows a warp
constexpr int kThreads = 32 * kWarps;

template <int D>
constexpr int kKeyTile = D == 128 ? 32 : 64;   // keys a tile

// Q's A fragments stay in registers across the key tiles, but in fp32 at
// D 128 (K2's rule)
template <typename T, int D>
constexpr bool kQFrags = !(std::is_same<T, float>::value && D > 64);

template <typename T, int D>
constexpr int smem_bytes() {
  return (kBQ * D + 4 * kKeyTile<D> * D) * (int)sizeof(T)
         + 2 * kKeyTile<D> * (int)sizeof(int);
}

// One key tile's softmax step on a warp's scores s (rows qpos[e / 2], keys
// k0 + 8 j + 2 t4 + e % 2, as mma leaves them): scale; with kTest, masked
// scores to -1e30 and their P to 0 (without it, every pair of the tile is
// allowed); the rows' running max m and sum l (summed before dropout);
// dropout on P. s leaves as P, alpha as each row's rescale of O.
template <bool kTest, int NT>
__device__ __forceinline__ void softmax_tile(
    float (&s)[NT][4], float (&m_r)[2], float (&l_r)[2], float (&alpha)[2],
    const int (&qsg)[2], const int (&qpos)[2], const uint32_t (&rh)[2],
    const int* kst, int k0, int t4, int causal, float scale,
    uint32_t thresh, float keep_scale) {
  static_assert(4 * NT <= 32, "one bit a score in a 32-bit mask");
  uint32_t ok = 0u;   // bit 4 j + e: the pair is allowed
  float mx[2] = {flash::kNegInf, flash::kNegInf};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    int2 ks2 = make_int2(0, 0);
    if (kTest) ks2 = *reinterpret_cast<const int2*>(kst + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float x = s[j][e] * scale;
      if (kTest) {
        const int c = 8 * j + 2 * t4 + (e & 1);
        if (flash::seg_allowed(qsg[h], (e & 1) ? ks2.y : ks2.x, qpos[h],
                               k0 + c, causal))
          ok |= 1u << (4 * j + e);
        else
          x = flash::kNegInf;
      }
      s[j][e] = x;
      mx[h] = fmaxf(mx[h], x);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_r[h], mx[h]);
    alpha[h] = expf(m_r[h] - m_new);
    m_r[h] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float p = (!kTest || ((ok >> (4 * j + e)) & 1u))
                    ? expf(s[j][e] - m_r[h]) : 0.f;
      sum[h] += p;
      if (thresh)
        p = flash::drop_keep(rh[h], k0 + 8 * j + 2 * t4 + (e & 1), thresh)
                ? p * keep_scale : 0.f;
      s[j][e] = p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l_r[h] = alpha[h] * l_r[h] + sum[h];
  }
}

// Blocks an SM that ptxas must leave registers for: 3 where a Q row is
// 128 bytes or less (bf16 D 32 and 64, fp32 D 32), else 2. With no floor
// ptxas aimed at 128-197 registers and spilled at bf16 D 32 and at D 128;
// with 2 everywhere, bf16 D 64 took 208 registers, ran 2 blocks an SM and
// measured 7-21 % slower than at 3 (168 registers; kernel_ab.py's
// k5_no_floor and k5_two_blocks, PERF.md §6). No instantiation spills with
// these floors.
template <typename T, int D>
constexpr int kMinBlocks = sizeof(T) * D <= 128 ? 3 : 2;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, D>))
splash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ qseg,
                  const int* __restrict__ kseg,
                  const int* __restrict__ kv_lo,
                  const int* __restrict__ kv_hi, T* __restrict__ out,
                  float* __restrict__ lse, int H, int S, int causal,
                  float scale, uint32_t thresh, float keep_scale,
                  uint32_t seed) {
  constexpr int BK = kKeyTile<D>;
  constexpr int NT = BK / 8;    // score n-tiles a warp
  constexpr int KS = D / 16;    // k16 steps of Q K^T
  constexpr bool kHoldQ = kQFrags<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBQ * D;             // [2][BK * D]
  T* Vs = Ks + 2 * BK * D;          // [2][BK * D]
  int* ks_s = reinterpret_cast<int*>(Vs + 2 * BK * D);   // [2][BK]

  const int bh = blockIdx.x;
  const int qi = gridDim.y - 1 - blockIdx.y;   // last tile first, as K6
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qi * kBQ;
  const size_t qoff = ((size_t)bh * S + q0) * D;
  const T* kb = k + (size_t)bh * S * D;
  const T* vb = v + (size_t)bh * S * D;
  const int* ksrow = kseg + (size_t)b * S;
  const int* qsrow = qseg + (size_t)b * S;

  int first, last;
  flash::tile_span(kv_lo, kv_hi, b * (S / kBQ) + qi, S / kUnit, &first,
                   &last);
  first = first * (kUnit / BK);
  last = last * (kUnit / BK);
  auto fetch = [&](int t) {
    const int buf = t & 1;
    fmma::load_tile_async<T, D, BK, kThreads>(
        Ks + buf * BK * D, kb + (size_t)t * BK * D, tid);
    fmma::load_tile_async<T, D, BK, kThreads>(
        Vs + buf * BK * D, vb + (size_t)t * BK * D, tid);
    fmma::load_vec_async<kThreads>(ks_s + buf * BK, ksrow + t * BK, BK, tid);
  };
  fmma::load_tile_async<T, D, kBQ, kThreads>(Qs, q + qoff, tid);
  fmma::cp_async_commit();
  if (first < last) fetch(first);
  fmma::cp_async_commit();
  fmma::cp_async_wait<1>();   // Q has landed; the first key tile may not
  __syncthreads();

  // Q's A fragments, formed once
  fmma::AFrag<T> qf[kHoldQ ? KS : 1];
  if constexpr (kHoldQ) {
#pragma unroll
    for (int s = 0; s < KS; ++s)
      fmma::load_a<T, D>(qf[s], Qs, 16 * warp, 16 * s, lane);
  }

  // the warp's first query and its id range; this thread's two query rows
  // (g and g + 8 of the warp's 16)
  const int wq0 = q0 + 16 * warp;
  const int w_first = qsrow[wq0], w_last = qsrow[wq0 + 15];
  int qpos[2], qsg[2];
  float m_r[2], l_r[2];
  uint32_t rh[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qpos[h] = wq0 + g + 8 * h;
    qsg[h] = qsrow[qpos[h]];
    m_r[h] = flash::kNegInf;
    l_r[h] = 0.f;
    rh[h] = thresh ? flash::drop_row(seed, bh, qpos[h]) : 0u;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = first; t < last; ++t) {
    if (t + 1 < last) {
      fetch(t + 1);   // its buffer's reads ended at the last iteration's sync
      fmma::cp_async_commit();
      fmma::cp_async_wait<1>();
    } else {
      fmma::cp_async_wait<0>();
    }
    __syncthreads();   // tile t visible
    const int buf = t & 1;
    const T* Kt = Ks + buf * BK * D;
    const T* Vt = Vs + buf * BK * D;
    const int* kst = ks_s + buf * BK;
    const int k0 = t * BK;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (kHoldQ) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        fmma::mma_abt_step<T, D, NT>(s, qf[ks], Kt, 0, 16 * ks, lane);
    } else {
      fmma::mma_abt<T, D, NT>(s, Qs, 16 * warp, Kt, 0, lane);
    }

    // one segment over the warp's rows and the tile, wholly visible
    const bool one_seg = w_first == w_last && kst[0] == w_first
                         && kst[BK - 1] == w_first
                         && (!causal || k0 + BK - 1 <= wq0);
    float alpha[2];
    if (one_seg)
      softmax_tile<false, NT>(s, m_r, l_r, alpha, qsg, qpos, rh, kst, k0, t4,
                              causal, scale, thresh, keep_scale);
    else
      softmax_tile<true, NT>(s, m_r, l_r, alpha, qsg, qpos, rh, kst, k0, t4,
                             causal, scale, thresh, keep_scale);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    fmma::mma_pb<T, D, NT>(acc, s, Vt, 0, lane);
    __syncthreads();   // this tile's K/V/id reads are done
  }
  fmma::cp_async_wait<0>();   // nothing left in flight (no key tile at all)

  // l_safe: 1 for a row with no visible key, whose O is then 0
  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) l_safe[h] = l_r[h] > 0.f ? l_r[h] : 1.f;
  const float inv0 = 1.f / l_safe[0], inv1 = 1.f / l_safe[1];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] *= inv0;
    acc[j][1] *= inv0;
    acc[j][2] *= inv1;
    acc[j][3] *= inv1;
  }
  fmma::store_rows<T, D>(out + qoff + (size_t)16 * warp * D, acc, 1.f, lane);
  if (t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      lse[(size_t)bh * S + qpos[h]] = m_r[h] + logf(l_safe[h]);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* qseg, const int* kseg, const int* lo,
                     const int* hi, void* out, float* lse, int B, int H,
                     int S, int causal, float scale, uint32_t thresh,
                     float keep_scale, uint32_t seed, cudaStream_t stream) {
  const int bytes = smem_bytes<T, D>();
  cudaError_t e = cudaFuncSetAttribute(
      splash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, S / kBQ), block(kThreads);
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
// (the key span of each query tile, in 64-key units); out like q; lse
// [B*H,S] float32. Self-attention only (Sq == Sk), a multiple of 64; D one
// of 32, 64, 128; every pointer 16-byte aligned. Dropout: keep where hash
// >= thresh (thresh 0 = no dropout), kept P scaled by keep_scale.
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
