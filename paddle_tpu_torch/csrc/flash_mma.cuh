// Tensor-core pieces of the flash-attention kernels (flash_fwd.cu K2,
// flash_bwd_dq.cu K3, flash_bwd_dkv.cu K4) and of the splash backward
// kernels (splash_bwd_dq.cu K6, splash_bwd_dkv.cu K7): swizzled shared
// tiles fed by cp.async, and warp-level mma.sync products in every input
// type.
//
// - bfloat16 and float16 (the 16-bit types, `Half16<T>`): mma.sync
//   m16n8k16 with 16-bit operands and fp32 sums. The two differ only in
//   the instruction's operand type and in the rounding of packed fp32
//   values, so every tile, fragment and product below is written once
//   for both (only K2-K4 are instantiated in float16). A operands from
//   shared memory come through ldmatrix, B operands through ldmatrix (B
//   stored [n][k]) or ldmatrix.trans (B stored [k][n]).
// - float32: 3xTF32 on mma.sync m16n8k8. Each operand x splits into
//   hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and a product is
//   a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (small terms first): fp32 accuracy at
//   a third of the TF32 rate. Single-pass TF32 keeps ~3 digits and is not
//   used. Fragments are plain shared loads (tf32 has no ldmatrix.trans):
//   16 bytes a thread for both operands of A B^T (the k index permuted),
//   32 bits for the B operand of P B.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16 / k8"),
// lane = 4 * g + t:
//   accumulator C (16 x 8):   c0, c1 at (row g, cols 2t, 2t+1),
//                             c2, c3 at (row g+8, cols 2t, 2t+1)
//   16-bit A (16 x 16):       a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                             a3 (g+8, 2t+8..)
//   16-bit B (16 x 8):        b0 (rows 2t, 2t+1; col g), b1 (rows 2t+8, 2t+9)
//   tf32 A (16 x 8):          a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   tf32 B (8 x 8):           b0 (row t, col g), b1 (row t+4, col g)
// An accumulator is reused as the A operand of the next product in
// registers (FlashAttention-2): in a 16-bit type two n8 accumulators pack
// into one k16 A fragment as they stand. In tf32 the accumulator holds
// columns 2t and 2t+1 where A wants t and t+4, so the k index is
// permuted: slot t carries column 2t and slot t+4 column 2t+1, and the B
// fragment is read from rows 2t and 2t+1 to match (a sum over k does not
// depend on its order).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fmma {

// -- shared-memory tiles ------------------------------------------------------

// A [rows, D] tile of T kept in 16-byte chunks. Chunk c of row r lies in
// chunk slot `slot(r, c)`, XOR-swizzled so that the reads of one phase fall
// in 8 different 16-byte bank groups:
// - 16-bit: one ldmatrix phase reads one chunk of 8 consecutive rows, so
//   chunk c of row r goes to c ^ (r % 8). Rows of 64 bytes (D 32) swizzle
//   each 128-byte line of two rows instead.
// - float: a quarter-warp of 16-byte fragment loads (mma_abt) reads 4
//   consecutive chunks of 2 consecutive rows, and the 32-bit loads of
//   mma_pb read 2 neighbouring chunks of the rows 2t (or 2t + 1), t < 4.
//   c ^ h(r) with h = 0, 4, 2, 6, 4, 0, 6, 2 for r % 8 = 0..7 serves both:
//   h flips bit 2 between rows 2i and 2i + 1, and h / 2 differs among the
//   even rows and among the odd ones.
template <typename T, int D>
struct Tile {
  static constexpr int kEC = 16 / (int)sizeof(T);  // elements a chunk
  static constexpr int kRC = D / kEC;              // chunks a row
  __device__ __forceinline__ static int slot(int r, int c) {
    if constexpr (std::is_same<T, float>::value) {
      static_assert(kRC >= 8, "float rows of 32 bytes or more");
      return r * kRC + (c ^ ((r & 6) ^ ((r & 1) << 2)));
    } else if constexpr (kRC >= 8) {
      return r * kRC + (c ^ (r & 7));
    } else {
      const int l = r * kRC + c;
      return (l & ~7) | ((l & 7) ^ ((l >> 3) & 7));
    }
  }
  // element offset of (row r, column col)
  __device__ __forceinline__ static int at(int r, int col) {
    return slot(r, col / kEC) * kEC + col % kEC;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of a [ROWS, D] row-major tile at `src` into the swizzled
// tile `dst`, 16 bytes a copy, spread over NTHREADS threads.
template <typename T, int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                int tid) {
  using TL = Tile<T, D>;
  for (int i = tid; i < ROWS * TL::kRC; i += NTHREADS) {
    const int r = i / TL::kRC, c = i % TL::kRC;
    cp_async16(dst + TL::slot(r, c) * TL::kEC,
               src + (size_t)r * D + c * TL::kEC);
  }
}

// Start the copy of n 4-byte values (floats or int32 ids; n a multiple of
// 4, both ends 16-byte aligned).
template <int NTHREADS, typename U>
__device__ __forceinline__ void load_vec_async(U* dst, const U* src, int n,
                                               int tid) {
  static_assert(sizeof(U) == 4, "4-byte values");
  for (int i = tid; i < n / 4; i += NTHREADS) cp_async16(dst + 4 * i, src + 4 * i);
}

// -- fragments and products ---------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The 16-bit operand types: c += a * b on mma.sync m16n8k16 with fp32
// sums, two floats packed (rounded to nearest even) into one register of
// the type, and a pair of floats stored as the type.
template <typename T>
struct Half16;

template <>
struct Half16<__nv_bfloat16> {
  __device__ __forceinline__ static void mma(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ __forceinline__ static void store2(__nv_bfloat16* p, float x,
                                                float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
};

template <>
struct Half16<__half> {
  __device__ __forceinline__ static void mma(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ __forceinline__ static void store2(__half* p, float x,
                                                float y) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
  }
};

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cvt.rna.tf32.f32 (round to 10 mantissa bits, ties away from zero) in two
// integer instructions: add half a tf32 ulp to the magnitude, clear the 13
// bits tf32 drops. Bit-identical to the PTX conversion, which runs on the
// slower conversion pipe and held K3 + K4 back (PERF.md).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a tf32 value
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a * b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ah[4],
                                           const uint32_t al[4],
                                           const uint32_t bh[2],
                                           const uint32_t bl[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// The A operand of one k16 step of A B^T for one warp (rows ra .. ra+15):
// 16-bit one m16k16 ldmatrix fragment; fp32 two m16k8 fragments, each split
// into tf32 hi and lo. K2 keeps Q's fragments in registers across its key
// tiles (but fp32 at D 128); mma_abt loads them step by step.
template <typename T>
struct AFrag {
  uint32_t a[4];
};
template <>
struct AFrag<float> {
  uint32_t hi[2][4], lo[2][4];
};

// The k (d) index is permuted within each 16 columns in fp32: thread t
// holds d = kk + 4t .. kk + 4t + 3, one 16-byte load, as slots (t, t+4) of
// the step kk (d + 0, d + 1) and of the step kk + 8 (d + 2, d + 3); A and B
// use the same permutation, and the sum does not depend on it.
template <typename T, int D>
__device__ __forceinline__ void load_a(AFrag<T>& f, const T* As, int ra,
                                       int kk, int lane) {
  using TL = Tile<T, D>;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, c = kk / 4 + (lane & 3);
    const float4 x0 = *reinterpret_cast<const float4*>(
        As + TL::slot(ra + g, c) * 4);
    const float4 x1 = *reinterpret_cast<const float4*>(
        As + TL::slot(ra + g + 8, c) * 4);
    split_tf32(x0.x, f.hi[0][0], f.lo[0][0]);
    split_tf32(x1.x, f.hi[0][1], f.lo[0][1]);
    split_tf32(x0.y, f.hi[0][2], f.lo[0][2]);
    split_tf32(x1.y, f.hi[0][3], f.lo[0][3]);
    split_tf32(x0.z, f.hi[1][0], f.lo[1][0]);
    split_tf32(x1.z, f.hi[1][1], f.lo[1][1]);
    split_tf32(x0.w, f.hi[1][2], f.lo[1][2]);
    split_tf32(x1.w, f.hi[1][3], f.lo[1][3]);
  } else {
    ldsm_x4(f.a, As + TL::at(ra + (lane & 7) + ((lane >> 3) & 1) * 8,
                             kk + (lane >> 4) * 8));
  }
}

// acc[NT][4] += A_kk * B[rb : rb+8*NT, kk : kk+16]^T, one warp, for the k16
// step kk with A's fragment f; B a swizzled [rows, D] tile.
template <typename T, int D, int NT>
__device__ __forceinline__ void mma_abt_step(float (&acc)[NT][4],
                                             const AFrag<T>& f, const T* Bs,
                                             int rb, int kk, int lane) {
  using TL = Tile<T, D>;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, c = kk / 4 + (lane & 3);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 y = *reinterpret_cast<const float4*>(
          Bs + TL::slot(rb + 8 * j + g, c) * 4);
      uint32_t bh[2][2], bl[2][2];
      split_tf32(y.x, bh[0][0], bl[0][0]);
      split_tf32(y.y, bh[0][1], bl[0][1]);
      split_tf32(y.z, bh[1][0], bl[1][0]);
      split_tf32(y.w, bh[1][1], bl[1][1]);
      mma_3xtf32(acc[j], f.hi[0], f.lo[0], bh[0], bl[0]);
      mma_3xtf32(acc[j], f.hi[1], f.lo[1], bh[1], bl[1]);
    }
  } else {
    static_assert(NT % 2 == 0,
                  "16-bit B fragments come two n-tiles at a time");
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, Bs + TL::at(rb + 8 * j + (lane & 7) + (lane >> 4) * 8,
                             kk + ((lane >> 3) & 1) * 8));
      Half16<T>::mma(acc[j], f.a, b[0], b[1]);
      Half16<T>::mma(acc[j + 1], f.a, b[2], b[3]);
    }
  }
}

// acc[NT][4] += A[ra : ra+16, 0:D] * B[rb : rb+8*NT, 0:D]^T, one warp.
// A and B are swizzled [rows, D] tiles (Q K^T, dO V^T, K Q^T, V dO^T).
template <typename T, int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const T* As,
                                        int ra, const T* Bs, int rb,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    AFrag<T> f;
    load_a<T, D>(f, As, ra, kk, lane);
    mma_abt_step<T, D, NT>(acc, f, Bs, rb, kk, lane);
  }
}

// acc[D/8][4] += P * B[rb : rb+8*KT, 0:D], one warp, where P (16 x 8*KT)
// is held in accumulator fragments p[KT][4] and B is a swizzled [rows, D]
// tile read with its rows as the k index (dS K, Pd^T dO, dS^T Q). P is
// rounded to the tile's type for 16-bit tiles and split into tf32 pairs
// for float tiles.
// For float tiles the output columns are permuted so that a thread's B
// values come in 16-byte loads: column n of n-tile j is d = out_col<D>(j, n)
// (store_rows puts them back).
template <int D>
__device__ __forceinline__ int out_col(int j, int n) {
  return 32 * (j / 4) + 4 * n + j % 4;
}

template <typename T, int D, int KT>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4],
                                       float (&p)[KT][4], const T* Bs,
                                       int rb, int lane) {
  using TL = Tile<T, D>;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int kc = 0; kc < KT; ++kc) {
      // k slot t carries column 2t, slot t+4 column 2t+1
      uint32_t ah[4], al[4];
      split_tf32(p[kc][0], ah[0], al[0]);
      split_tf32(p[kc][2], ah[1], al[1]);
      split_tf32(p[kc][1], ah[2], al[2]);
      split_tf32(p[kc][3], ah[3], al[3]);
      const int r0 = rb + 8 * kc + 2 * t;
#pragma unroll
      for (int m = 0; m < D / 32; ++m) {
        // b0 (row 2t) and b1 (row 2t+1) of n-tiles 4m .. 4m+3: chunk g + 8m
        const float4 y0 = *reinterpret_cast<const float4*>(
            Bs + TL::slot(r0, g + 8 * m) * 4);
        const float4 y1 = *reinterpret_cast<const float4*>(
            Bs + TL::slot(r0 + 1, g + 8 * m) * 4);
        const float b0[4] = {y0.x, y0.y, y0.z, y0.w};
        const float b1[4] = {y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t bh[2], bl[2];
          split_tf32(b0[i], bh[0], bl[0]);
          split_tf32(b1[i], bh[1], bl[1]);
          mma_3xtf32(acc[4 * m + i], ah, al, bh, bl);
        }
      }
    }
  } else {
    static_assert(KT % 2 == 0, "a 16-bit k16 step takes two accumulators");
    using H = Half16<T>;
#pragma unroll
    for (int kc = 0; kc < KT / 2; ++kc) {
      const uint32_t a[4] = {H::pack(p[2 * kc][0], p[2 * kc][1]),
                             H::pack(p[2 * kc][2], p[2 * kc][3]),
                             H::pack(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                             H::pack(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, Bs + TL::at(rb + 16 * kc + (lane & 7)
                                         + ((lane >> 3) & 1) * 8,
                                     8 * j + (lane >> 4) * 8));
        H::mma(acc[j], a, b[0], b[1]);
        H::mma(acc[j + 1], a, b[2], b[3]);
      }
    }
  }
}

// Store a warp's [16, D] accumulator acc[D/8][4] from mma_pb times `mul`
// at `out` (row stride D).
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, float (&acc)[D / 8][4],
                                           float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
    // n-tiles 4m .. 4m+3 of one accumulator column are 4 neighbouring d
#pragma unroll
    for (int m = 0; m < D / 32; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e >> 1);
        *reinterpret_cast<float4*>(
            out + (size_t)row * D + out_col<D>(4 * m, 2 * t + (e & 1))) =
            make_float4(acc[4 * m][e] * mul, acc[4 * m + 1][e] * mul,
                        acc[4 * m + 2][e] * mul, acc[4 * m + 3][e] * mul);
      }
  } else {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t;
      Half16<T>::store2(out + (size_t)g * D + c, acc[j][0] * mul,
                        acc[j][1] * mul);
      Half16<T>::store2(out + (size_t)(g + 8) * D + c, acc[j][2] * mul,
                        acc[j][3] * mul);
    }
  }
}

}  // namespace fmma
