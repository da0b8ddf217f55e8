// Pieces shared by the flash-attention kernels (flash_fwd.cu K2,
// flash_bwd_dq.cu K3, flash_bwd_dkv.cu K4) and the splash kernels (K5-K7):
// the masked-score value and the dropout keep mask. Their tiles live in
// flash_mma.cuh.
//
// The dropout keep mask is keyed on ABSOLUTE coordinates, not on tiles:
//
//     keep(i, j) <=> hash(seed, b*H + h, i, j) >= thresh
//     thresh = min(floor(p * 2^32), 2^32 - 1)    (the JAX threshold rule,
//                                                 pallas_ops.py:135-136)
//
// hash is murmur3's 32-bit finalizer (fmix32) chained over the three
// coordinates. K2, K3 and K4 therefore regenerate the identical mask
// whatever their tile sizes, and `_keep_mask` in ops/flash_ops.py
// reproduces it bit for bit with int64 tensor ops. (The TPU kernel seeds
// its PRNG per (bh, q-tile, k-tile), pallas_ops.py:124-136; those bits
// depend on the TPU and on the tile size and are not reproduced.)
//
// K2-K4 key a row on the GLOBAL head: a tensor-parallel rank holds H of
// the model's hg heads, from head hoff, and hashes b*hg + hoff + h, so
// the ranks of tp n draw, together, the mask of tp 1 (hg == H, hoff 0 on
// one rank). The splash kernels keep b*H + h (a dp rank folds its rank
// into the seed instead).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The part of the hash that depends on (seed, bh, i) only: one per row.
__device__ __forceinline__ uint32_t drop_row(uint32_t seed, uint32_t bh,
                                             uint32_t i) {
  return fmix32(fmix32(seed ^ (bh * 0x9E3779B1u)) ^ (i * 0x85EBCA77u));
}

__device__ __forceinline__ bool drop_keep(uint32_t row, uint32_t j,
                                          uint32_t thresh) {
  return fmix32(row ^ (j * 0xC2B2AE3Du)) >= thresh;
}

}  // namespace flash
