// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes:
// split-K (flash-decoding), two kernels behind one C entry.
//
// Replaces: the library Pallas kernel that paddle_tpu/ops/paged_ops.py:239-251
// dispatches on a TPU (jax/experimental/pallas/ops/tpu/paged_attention/
// paged_attention_kernel.py:376, `paged_attention`).
//
// Computes, for every (sequence b, head h), one query position of attention
// over the K/V pages named by row b of the page table:
//
//     out[b,h] = softmax_t(q[b,h] . k_t * scale) . v_t      for t < len
//     len = min(pos[b] + 1, PP * P)
//
// which is the plain version `paged_gather` + `cached_attention`
// (paddle_tpu_torch/ops/paged_ops.py): the plain version masks t > pos[b] to
// -1e30 so those terms are exactly 0; this kernel never reads them at all, so
// junk on the scratch page or past the sequence's end cannot reach the sum.
//
// Layouts: q [B,H,D]; k_pages/v_pages [H,N,P,D] (one layer of the pools);
// page_table [B,PP] int32; pos [B] int32 (pos >= 0); out [B,H,D] in q's type;
// workspace [B,H,nsplit,D+2] float32, nsplit = ceil(PP / pages_per_split).
// float32, bfloat16 or float16 pools (the JAX package's pools take any
// float type); all statistics and sums in float32, each 16-bit value widened
// to float as it is loaded (`Chunk<T>::widen`), the output rounded to
// nearest once.
//
// Bound: bytes. The work reads K and V once, 2*B*H*len*D*sizeof(T) bytes, at
// about 2 flops a byte, far below the card's ridge. What keeps a decode from
// the bandwidth is parallelism and bytes in flight: one block per (b, h) (the
// first design) gave 96 blocks for 132 SMs, and the longest sequence's block
// walked its 1024 tokens alone with 8 bytes a lane in flight.
//
// Design:
// - paged_split_kernel (paged_split_kernel_npow2 where a row's chunks are
//   not a power of two, see there): the sequence axis is cut into splits of
//   `pages_per_split` whole pages (the wrapper picks 16 tokens a split), one
//   warp a split, 4 warps a block, grid (splits / 4, B*H). A warp reads its
//   pages with 16-byte loads. A row of D values is C = D*sizeof(T)/16
//   chunks; it gets CP lanes, C rounded up to a power of two, so that a
//   row group is aligned for the shuffles (at most 32: where C > 32, as in
//   fp32 at D 256, each lane takes CP/32 chunks of the row). A lane whose
//   chunk is at or past C loads nothing and adds 0 to the dot product.
//   Each load instruction covers 32/CP rows, 512 contiguous bytes of a page
//   where C is CP (D 32, 64, 128); 4 chunks of K and 4 of V a lane make a
//   step, and the next step's loads are issued before this step is
//   computed (register prefetch). The q.k dot products reduce over the CP
//   lanes of a row with __shfl_xor_sync; the online softmax (max, sum,
//   D-wide accumulator, f32) runs warp-wide. A split at or past len is
//   skipped (no partial); rows past len are never loaded. Each live split
//   writes its partial (acc[D], m, l) to the workspace, acc relative to its
//   own max m.
// - paged_combine_kernel: one warp per (b, h) merges the live splits,
//   ceil(len / split tokens) of them: M = max m_s, out = sum_s acc_s
//   exp(m_s - M) / sum_s l_s exp(m_s - M), written in q's type; each lane
//   holds ceil(D / 32) columns, the tail past D masked.
// - Built for every D with D % 8 == 0 and D <= 256 (a 16-byte chunk of
//   any of the three types divides such a row), one instantiation each.
// - Any other D up to 512 (D % 8 != 0, or 256 < D <= 512) runs the same
//   two kernels at a padded width Dp, the least power of two >= max(D,
//   32), with the row stride D given at run time: a chunk is loaded one
//   value at a time, since a row no longer starts on a 16-byte boundary,
//   and the columns at or past D read as 0, so they add 0 to q.k and
//   their accumulators stay 0. The workspace rows are Dp + 2 wide
//   (`paged_attention_workspace_width`); the combine writes D columns.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // splits a block
constexpr int kLoads = 4;   // 16-byte K loads (and V loads) a lane a step
constexpr float kNegInf = -1e30f;

// 16 bytes of T, widened to float
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  using Raw = float4;
  static constexpr int kN = 4;
  __device__ __forceinline__ static void widen(const float4& r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int kN = 8;
  __device__ __forceinline__ static void widen(const uint4& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

template <>
struct Chunk<__half> {
  using Raw = uint4;
  static constexpr int kN = 8;
  __device__ __forceinline__ static void widen(const uint4& r, float* f) {
    const __half2* h = reinterpret_cast<const __half2*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __half22float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

__device__ __forceinline__ int seq_len(const int32_t* pos, int b, int cap) {
  const int len = pos[b] + 1;
  return len < cap ? len : cap;
}

// C rounded up to a power of two
__host__ __device__ constexpr int pow2_ceil(int x) {
  return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2);
}

// a row of D values in 16-byte chunks of T is a power of two of them
template <typename T, int D>
constexpr bool kPow2Row = pow2_ceil(D / Chunk<T>::kN) == D / Chunk<T>::kN;

// the chunk of E values at column col0 of a row of dr, one value at a time
// (any alignment); the columns at or past dr read as 0
template <typename T>
__device__ __forceinline__ typename Chunk<T>::Raw load_masked(
    const T* __restrict__ p, int col0, int dr) {
  typename Chunk<T>::Raw r{};
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < Chunk<T>::kN; ++i)
    if (col0 + i < dr) e[i] = p[i];
  return r;
}

// kExact: D is the head dim, rows of D values in 16-byte loads. Otherwise
// D is the padded width and dr (< D, or D % 8 != 0) the head dim and the
// row stride of q and the pools, loaded by `load_masked`.
template <typename T, int D, bool kExact>
__device__ __forceinline__ void split_body(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ pos, float* __restrict__ ws, int H, int N,
    int P, int PP, int pps, int nsplit, int dr, float scale) {
  using CT = Chunk<T>;
  using Raw = typename CT::Raw;
  constexpr int E = CT::kN;              // elements a chunk
  constexpr int C = D / E;               // chunks a row
  constexpr int CP = pow2_ceil(C);       // ... rounded up to a power of two
  constexpr int L = CP < 32 ? CP : 32;   // lanes a row
  constexpr int NC = CP / L;             // chunks a lane
  constexpr int R = 32 / L;              // rows a load instruction
  constexpr int NL = kLoads / NC;        // row loads a lane a step
  constexpr int RS = R * NL;             // rows a step
  static_assert(D % E == 0 && NL >= 1, "D % 8 == 0 and D <= 512");
  const int ld = kExact ? D : dr;        // a row's stride in q, the pools

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = blockIdx.x * kWarps + warp;
  const int len = seq_len(pos, b, PP * P);
  const int t_begin = split * pps * P;
  if (split >= nsplit || t_begin >= len) return;   // warp-uniform
  const int t_end = min(t_begin + pps * P, len);
  const int c = lane % L, r = lane / L;
  // chunk i of this lane is chunk c + L * i of the row; a lane at or past
  // C holds zeros (always live where C is a power of two)
  auto live = [&](int i) { return C == CP || c + L * i < C; };

  float qf[NC][E];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (live(i)) {
      const T* qc = q + (size_t)bh * ld + (c + L * i) * E;
      if constexpr (kExact)
        CT::widen(*reinterpret_cast<const Raw*>(qc), qf[i]);
      else
        CT::widen(load_masked<T>(qc, (c + L * i) * E, dr), qf[i]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qf[i][e] = 0.f;
    }
  }
  const int32_t* row = page_table + (size_t)b * PP;
  const size_t head = (size_t)h * N * P * ld;
  const T* kh = k_pages + head;
  const T* vh = v_pages + head;

  // the loads of the step at token t0: rows t0 + u * R + r, chunks c + L i
  auto fetch = [&](int t0, Raw (&kr)[NL][NC], Raw (&vr)[NL][NC]) {
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      const int t = t0 + u * R + r;
      if (t < t_end) {
        const size_t off = ((size_t)row[t / P] * P + t % P) * ld;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          if (live(i)) {
            const int col = (c + L * i) * E;
            if constexpr (kExact) {
              kr[u][i] = __ldg(reinterpret_cast<const Raw*>(kh + off + col));
              vr[u][i] = __ldg(reinterpret_cast<const Raw*>(vh + off + col));
            } else {
              kr[u][i] = load_masked<T>(kh + off + col, col, dr);
              vr[u][i] = load_masked<T>(vh + off + col, col, dr);
            }
          } else {
            kr[u][i] = vr[u][i] = Raw{};
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < NC; ++i) kr[u][i] = vr[u][i] = Raw{};
      }
    }
  };

  float m = kNegInf, l = 0.f, acc[NC][E];
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  Raw kc[NL][NC], vc[NL][NC], kn[NL][NC], vn[NL][NC];
  fetch(t_begin, kc, vc);
  for (int t0 = t_begin; t0 < t_end; t0 += RS) {
    const bool more = t0 + RS < t_end;
    if (more) fetch(t0 + RS, kn, vn);   // in flight while this step computes
    float s[NL];
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        float kf[E];
        CT::widen(kc[u][i], kf);
#pragma unroll
        for (int e = 0; e < E; ++e) d += qf[i][e] * kf[e];
      }
#pragma unroll
      for (int o = 1; o < L; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      s[u] = t0 + u * R + r < t_end ? d * scale : kNegInf;
      mx = fmaxf(mx, s[u]);
    }
#pragma unroll
    for (int o = L; o < 32; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
    float ps = 0.f;
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      const float p = t0 + u * R + r < t_end ? expf(s[u] - m_new) : 0.f;
      ps += p;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        float vf[E];
        CT::widen(vc[u][i], vf);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] += p * vf[e];
      }
    }
    // each row's p sits in its L lanes: sum over the row groups only
#pragma unroll
    for (int o = L; o < 32; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
    l = l * alpha + ps;
    m = m_new;
    if (more) {
#pragma unroll
      for (int u = 0; u < NL; ++u)
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          kc[u][i] = kn[u][i];
          vc[u][i] = vn[u][i];
        }
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int o = L; o < 32; o <<= 1)
        acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], o);
  float* part = ws + ((size_t)bh * nsplit + split) * (D + 2);
  if (r == 0) {
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (live(i)) {
#pragma unroll
        for (int e = 0; e < E; ++e) part[(c + L * i) * E + e] = acc[i][e];
      }
  }
  if (lane == 0) {
    part[D] = m;
    part[D + 1] = l;
  }
}

// Left to itself, ptxas gives the fp32 split kernel 96 registers; where a
// row's chunks are not a power of two (D 24, 40-56, 72-120) the lane tests
// then spill. The _npow2 kernel is compiled for 4 blocks an SM (128
// registers), which keeps them in registers; the others keep the default,
// and the code of D 32, 64 and 128.
template <typename T, int D, bool kExact>
__global__ void __launch_bounds__(kWarps * 32)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const int32_t* __restrict__ page_table,
                   const int32_t* __restrict__ pos, float* __restrict__ ws,
                   int H, int N, int P, int PP, int pps, int nsplit, int dr,
                   float scale) {
  split_body<T, D, kExact>(q, k_pages, v_pages, page_table, pos, ws, H, N,
                           P, PP, pps, nsplit, dr, scale);
}

template <typename T, int D, bool kExact>
__global__ void __launch_bounds__(kWarps * 32, 4)
paged_split_kernel_npow2(const T* __restrict__ q,
                         const T* __restrict__ k_pages,
                         const T* __restrict__ v_pages,
                         const int32_t* __restrict__ page_table,
                         const int32_t* __restrict__ pos,
                         float* __restrict__ ws, int H, int N, int P, int PP,
                         int pps, int nsplit, int dr, float scale) {
  split_body<T, D, kExact>(q, k_pages, v_pages, page_table, pos, ws, H, N,
                           P, PP, pps, nsplit, dr, scale);
}

// D the workspace's width (the head dim, or the padded width), dr the head
// dim: out rows are dr wide
template <typename T, int D>
__global__ void __launch_bounds__(128)
paged_combine_kernel(const float* __restrict__ ws,
                     const int32_t* __restrict__ pos, T* __restrict__ out,
                     int BH, int H, int P, int PP, int pps, int nsplit,
                     int dr) {
  constexpr int DL = (D + 31) / 32;   // columns a lane, the tail masked
  const int bh = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (bh >= BH) return;
  const int lane = threadIdx.x & 31;
  auto live = [&](int i) { return lane + 32 * i < dr; };
  const int span = pps * P;
  const int n = (seq_len(pos, bh / H, PP * P) + span - 1) / span;
  const float* part = ws + (size_t)bh * nsplit * (D + 2);
  // M and L with the lanes striding over the splits, then the columns
  // with every lane walking all splits, 4 splits' loads in flight
  float M = kNegInf;
  for (int s = lane; s < n; s += 32) M = fmaxf(M, part[s * (D + 2) + D]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  float L = 0.f, acc[DL];
  for (int s = lane; s < n; s += 32)
    L += part[s * (D + 2) + D + 1] * expf(part[s * (D + 2) + D] - M);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int s = 0; s < n; ++s) {
    const float* ps = part + s * (D + 2);
    const float w = expf(ps[D] - M);
#pragma unroll
    for (int i = 0; i < DL; ++i)
      if (live(i)) acc[i] += ps[lane + 32 * i] * w;
  }
#pragma unroll
  for (int i = 0; i < DL; ++i)
    if (live(i)) store(out + (size_t)bh * dr + lane + 32 * i, acc[i] / L);
}

template <typename T, int D, bool kExact>
cudaError_t launch_d(const void* q, const void* kp, const void* vp,
                     const void* pt, const void* pos, void* out, float* ws,
                     int B, int H, int N, int P, int PP, int pps, int dr,
                     float scale, cudaStream_t stream) {
  const int nsplit = (PP + pps - 1) / pps;
  dim3 grid((nsplit + kWarps - 1) / kWarps, B * H);
  if constexpr (kPow2Row<T, D>)
    paged_split_kernel<T, D, kExact><<<grid, kWarps * 32, 0, stream>>>(
        (const T*)q, (const T*)kp, (const T*)vp, (const int32_t*)pt,
        (const int32_t*)pos, ws, H, N, P, PP, pps, nsplit, dr, scale);
  else
    paged_split_kernel_npow2<T, D, kExact><<<grid, kWarps * 32, 0, stream>>>(
        (const T*)q, (const T*)kp, (const T*)vp, (const int32_t*)pt,
        (const int32_t*)pos, ws, H, N, P, PP, pps, nsplit, dr, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_combine_kernel<T, D><<<(B * H + 3) / 4, 128, 0, stream>>>(
      ws, (const int32_t*)pos, (T*)out, B * H, H, P, PP, pps, nsplit, dr);
  return cudaGetLastError();
}

constexpr int kMaxD = 256;         // the 16-byte-load instantiations
constexpr int kMaxPaddedD = 512;   // the padded ones

// the width a head dim d runs at: d itself where d % 8 == 0 and d <= kMaxD,
// else the least power of two >= max(d, 32) up to kMaxPaddedD; 0 when no
// instantiation serves d
__host__ __device__ constexpr int run_width(int d) {
  return d <= 0 ? 0
         : (d % 8 == 0 && d <= kMaxD) ? d
         : d <= kMaxPaddedD ? (d <= 32 ? 32 : pow2_ceil(d))
         : 0;
}

// the instantiation for head dim d: one for every multiple of 8 up to kMaxD
template <typename T, int D = 8>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* pt, const void* pos, void* out, float* ws,
                   int B, int H, int N, int P, int PP, int pps, int d,
                   float scale, cudaStream_t stream) {
  if (d == D)
    return launch_d<T, D, true>(q, kp, vp, pt, pos, out, ws, B, H, N, P, PP,
                                pps, d, scale, stream);
  if constexpr (D < kMaxD)
    return launch<T, D + 8>(q, kp, vp, pt, pos, out, ws, B, H, N, P, PP,
                            pps, d, scale, stream);
  return cudaErrorInvalidValue;
}

// the padded instantiation for head dim d: one for every power of two from
// 32 up to kMaxPaddedD
template <typename T, int D = 32>
cudaError_t launch_padded(const void* q, const void* kp, const void* vp,
                          const void* pt, const void* pos, void* out,
                          float* ws, int B, int H, int N, int P, int PP,
                          int pps, int d, float scale, cudaStream_t stream) {
  if (run_width(d) == D)
    return launch_d<T, D, false>(q, kp, vp, pt, pos, out, ws, B, H, N, P, PP,
                                 pps, d, scale, stream);
  if constexpr (D < kMaxPaddedD)
    return launch_padded<T, 2 * D>(q, kp, vp, pt, pos, out, ws, B, H, N, P,
                                   PP, pps, d, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const void* q, const void* kp, const void* vp,
                     const void* pt, const void* pos, void* out, float* ws,
                     int B, int H, int N, int P, int PP, int pps, int d,
                     float scale, cudaStream_t stream) {
  if (d % 8 == 0 && d <= kMaxD)
    return launch<T>(q, kp, vp, pt, pos, out, ws, B, H, N, P, PP, pps, d,
                     scale, stream);
  return launch_padded<T>(q, kp, vp, pt, pos, out, ws, B, H, N, P, PP, pps,
                          d, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, pools and out share
// it); any D up to 512. workspace: float32
// [B, H, ceil(PP / pages_per_split), paged_attention_workspace_width(D) + 2],
// written and read here.
extern "C" int paged_attention_decode(void* q, void* k_pages, void* v_pages,
                                      void* page_table, void* pos, void* out,
                                      void* workspace, int B, int H, int N,
                                      int P, int PP, int pages_per_split,
                                      int D, int dtype, float scale,
                                      void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (P <= 0 || PP <= 0 || pages_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* ws = (float*)workspace;
  switch (dtype) {
    case 0:
      return (int)dispatch<float>(q, k_pages, v_pages, page_table, pos, out,
                                  ws, B, H, N, P, PP, pages_per_split, D,
                                  scale, s);
    case 1:
      return (int)dispatch<__nv_bfloat16>(q, k_pages, v_pages, page_table,
                                          pos, out, ws, B, H, N, P, PP,
                                          pages_per_split, D, scale, s);
    case 2:
      return (int)dispatch<__half>(q, k_pages, v_pages, page_table, pos, out,
                                   ws, B, H, N, P, PP, pages_per_split, D,
                                   scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the width of a workspace row less its two statistics: D, or the padded
// width D runs at (0 where D is not served)
extern "C" int paged_attention_workspace_width(int D) { return run_width(D); }

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
