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
// mask is the coordinate hash of flash_common.cuh (K3 and K4 replay it);
// `thresh == 0` (p = 0, the serving path) skips it. LSE is the row
// statistic the backward kernels (K3, K4) read. The running max starts at
// -1e30, as the TPU kernel's does (pallas_ops.py:181), so a row whose every
// score is -1e30 gives a uniform row, never NaN; when causal, the loop stops
// at the diagonal key tile (pallas_ops.py:184-186), so such a row averages
// the keys up to the end of its 64-query tile.
//
// Bound: operations. S and O are two products of 2*Sq*Sk*D flops each (half
// of that when causal) against inputs read once, ~2*Sk/3 flops a byte at D
// 64. They run on the tensor cores (flash_mma.cuh): bf16 or fp16 operands
// on mma.sync m16n8k16 (989 TFLOP/s peak), fp32 as 3xTF32 on mma.sync m16n8k8
// (495 / 3 = 165 TFLOP/s of fp32-accurate products). In bf16 and fp16, P is
// rounded to V's type before P V, as the TPU kernel casts it
// (pallas_ops.py:175-176). The first design ran both products on the fp32
// CUDA cores with S through shared memory and synchronous loads.
//
// Design: K3's block layout (flash_bwd_dq.cu). One block of 4 warps per
// (64-query tile, b*h), each warp owning 16 query rows; query tiles run
// heaviest first (the last tile has the most keys under causal masking).
// Q stays in shared memory in its input type, XOR-swizzled; K, V and the
// bias tile are double-buffered with 16-byte cp.async, so the next key
// tile's copy overlaps this tile's products (key tiles of 64 rows; 32
// above D 64, where the [16, D] accumulator takes the registers, and 16 in
// fp32 above D 128, for shared memory). Every D % 8 == 0 up to 256 runs at
// a padded width (flash_mma.cuh, "Head dims"). Q's A
// fragments are the same for every key tile, so they are formed once and
// held in registers (ldmatrix fragments in bf16, tf32 hi/lo in fp32), and
// only the streamed K and V values are split inside the loop. In fp32 at
// D 128 they would take 128 registers, so there Q is read from its shared
// tile and split at every key tile, as K3 does (splitting Q once into
// shared hi/lo tiles spilled and ran 1.6x slower on the H100). S comes out
// of mma in accumulator fragments (thread (g, t) holds rows g and g+8,
// columns 2t, 2t+1 of each n-tile); scale, bias, the causal mask, the
// online softmax (row max and sum over the quad's 4 lanes with two
// __shfl_xor_sync), dropout and the rescale of O all work there, and that
// fragment is the A operand of O += P V with V's fragments read
// transposed (ldmatrix.trans in bf16): S and P never go through shared
// memory. Warps whose rows lie wholly below
// the diagonal skip the mask test. O goes out times 1/l per row.
//
// Why mma.sync and not wgmma: the main path's type is fp32, and tf32 wgmma
// takes B only K-major from shared memory; V in P V is MN-major, so fp32
// wgmma would need a transposing copy of every V tile (as K in K3's dS K).
#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int kBQ = 64;       // query rows a block
constexpr int kWarps = 4;     // 16 query rows a warp
constexpr int kThreads = 32 * kWarps;

// keys a tile, at the padded width DP: 64; 32 above DP 64, where the
// [16, DP] accumulator takes the registers; 16 in fp32 above DP 128, so
// that Q and the double-buffered K and V tiles fit in shared memory
template <typename T, int DP>
constexpr int kKeyTile =
    DP <= 64 ? 64 : (std::is_same<T, float>::value && DP > 128) ? 16 : 32;

// Q's A fragments stay in registers across the key tiles, except in fp32
// above DP 64 (128 registers of tf32 hi/lo at DP 128) and in the 16-bit
// types above DP 128, where they are formed from the shared Q tile at
// every key tile
template <typename T, int DP>
constexpr bool kQFrags = DP <= (std::is_same<T, float>::value ? 64 : 128);

template <typename T, int DP>
constexpr int smem_bytes() {
  return (kBQ * DP + 4 * kKeyTile<T, DP> * DP) * (int)sizeof(T)
         + 2 * kKeyTile<T, DP> * (int)sizeof(float);
}

// DP: the padded width of the tiles; with kPad the head dim is the
// run-time d (global row stride, d <= DP), else DP itself
template <typename T, int DP, bool kPad>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Sq,
                 int Sk, int d, int causal, float scale, uint32_t thresh,
                 float keep_scale, uint32_t seed, int hg, int hoff) {
  constexpr int BK = kKeyTile<T, DP>;
  constexpr int NT = BK / 8;    // score n-tiles a warp
  constexpr int KS = DP / 16;   // k16 steps of Q K^T
  constexpr bool kHoldQ = kQFrags<T, DP>;
  const int D = kPad ? d : DP;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBQ * DP;            // [2][BK * DP]
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
  fmma::cp_async_commit();
  if (last > 0) fetch(0);
  fmma::cp_async_commit();
  fmma::cp_async_wait<1>();   // Q has landed; key tile 0 may be in flight
  __syncthreads();

  // Q's A fragments, formed once
  fmma::AFrag<T> qf[kHoldQ ? KS : 1];
  if constexpr (kHoldQ) {
#pragma unroll
    for (int s = 0; s < KS; ++s)
      fmma::load_a<T, DP>(qf[s], Qs, 16 * warp, 16 * s, lane);
  }

  // this thread's two query rows (g and g + 8 of its warp's 16)
  const int r0 = 16 * warp + g;
  int qpos[2];
  float m_r[2], l_r[2];
  uint32_t rh[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qpos[h] = q0 + r0 + 8 * h;
    m_r[h] = flash::kNegInf;
    l_r[h] = 0.f;
    rh[h] = thresh ? flash::drop_row(seed, dbh, qpos[h]) : 0u;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
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
    __syncthreads();   // tile t visible
    const int buf = t & 1;
    const T* Kt = Ks + buf * BK * DP;
    const T* Vt = Vs + buf * BK * DP;
    const float* bt = bs + buf * BK;
    const int k0 = t * BK;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (kHoldQ) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        fmma::mma_abt_step<T, DP, NT>(s, qf[ks], Kt, 0, 16 * ks, lane);
    } else {
      fmma::mma_abt<T, DP, NT>(s, Qs, 16 * warp, Kt, 0, lane);
    }

    // scores, rows qpos[e / 2], keys k0 + 8 j + 2 t4 + e % 2
    const bool mask = causal && k0 + BK - 1 > q0 + 16 * warp;
    float mx[2] = {flash::kNegInf, flash::kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t4 + (e & 1);
        float x = s[j][e] * scale;
        if (brow != nullptr) x += bt[c];
        if (mask && k0 + c > qpos[e >> 1]) x = flash::kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      alpha[h] = expf(m_r[h] - m_new);
      m_r[h] = m_new;
    }
    // P, summed before dropout; kept P scaled by 1 / (1 - p)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = expf(s[j][e] - m_r[h]);
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
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    fmma::mma_pb<T, DP, NT>(acc, s, Vt, 0, lane);
    __syncthreads();   // this tile's K/V/bias reads are done
  }
  fmma::cp_async_wait<0>();   // nothing left in flight (no key tile at all)

  const float inv0 = 1.f / l_r[0], inv1 = 1.f / l_r[1];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    acc[j][0] *= inv0;
    acc[j][1] *= inv0;
    acc[j][2] *= inv1;
    acc[j][3] *= inv1;
  }
  fmma::store_rows<T, DP, kPad>(out + qoff + (size_t)16 * warp * D, acc,
                                1.f, lane, D, D);
  if (t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      lse[(size_t)bh * Sq + qpos[h]] = m_r[h] + logf(l_r[h]);
  }
}

template <typename T, int DP, bool kPad>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* bias, void* out, float* lse, int B, int H,
                     int Sq, int Sk, int D, int causal, float scale,
                     uint32_t thresh, float keep_scale,
                     uint32_t seed, int hg, int hoff,
                     cudaStream_t stream) {
  const int bytes = smem_bytes<T, DP>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP, kPad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, Sq / kBQ), block(kThreads);
  flash_fwd_kernel<T, DP, kPad><<<grid, block, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)out,
      lse, H, Sq, Sk, D, causal, scale, thresh, keep_scale, seed, hg, hoff);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, float* lse, int B, int H,
                   int Sq, int Sk, int D, int causal, float scale,
                   uint32_t thresh, float keep_scale,
                   uint32_t seed, int hg, int hoff,
                   cudaStream_t stream) {
  return fmma::dispatch_width<T>(D, [&](auto dp, auto pad) {
    return launch_d<T, decltype(dp)::value, decltype(pad)::value>(
        q, k, v, bias, out, lse, B, H, Sq, Sk, D, causal, scale, thresh,
        keep_scale, seed, hg, hoff, stream);
  });
}

}  // namespace

// q [B,H,Sq,D], k/v [B,H,Sk,D] contiguous in one type (dtype 0 = float32,
// 1 = bfloat16, 2 = float16); bias [B,Sk] float32 or null; out like q;
// lse [B*H,Sq] f32.
// Sq and Sk must be multiples of 64; D % 8 == 0, D <= 256. Dropout: keep
// where hash >= thresh (thresh 0 = no dropout), kept P scaled by keep_scale.
// Dropout rows are keyed on the global head: this call holds H of hg
// heads, from head hoff (hg = H, hoff = 0 for all of them).
extern "C" int flash_attention_forward(void* q, void* k, void* v, void* bias,
                                       void* out, void* lse, int B, int H,
                                       int Sq, int Sk, int D, int dtype,
                                       int causal, float scale,
                                       unsigned int thresh, float keep_scale,
                                       unsigned int seed, int hg, int hoff,
                                       void* stream) {
  if (Sq % kBQ != 0 || Sk % 64 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return (int)launch<float>(q, k, v, bias, out, (float*)lse, B, H, Sq,
                                Sk, D, causal, scale, thresh, keep_scale,
                                seed, hg, hoff, s);
    case 1:
      return (int)launch<__nv_bfloat16>(q, k, v, bias, out, (float*)lse, B,
                                        H, Sq, Sk, D, causal, scale, thresh,
                                        keep_scale, seed, hg, hoff, s);
    case 2:
      return (int)launch<__half>(q, k, v, bias, out, (float*)lse, B, H, Sq,
                                 Sk, D, causal, scale, thresh, keep_scale,
                                 seed, hg, hoff, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
