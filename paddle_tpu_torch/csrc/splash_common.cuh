// Pieces shared by the splash-attention kernels (splash_fwd.cu K5,
// splash_bwd_dq.cu K6, splash_bwd_dkv.cu K7), on top of the dropout hash
// of flash_common.cuh; their tiles and loads are flash_mma.cuh's.
//
// Segment ids are int32 [B, S], non-decreasing along each row (the packing
// layout). The tile bounds are int32 [B, S / 64], computed by the wrapper
// (`_block_bounds` in ops/splash_ops.py): [lo, hi) is the range of key
// tiles a query tile visits (K5, K6), or of query tiles a key tile visits
// (K7). Tiles outside it hold no allowed pair, so they are skipped, not
// masked.
#pragma once

#include "flash_common.cuh"

namespace flash {

// Query i (segment qs) sees key j (segment ks) iff they lie in one segment
// and, under causal, j <= i. Masked entries get P = 0 through this test,
// never through exp(-1e30 - m), which is 1 when the whole row is masked.
__device__ __forceinline__ bool seg_allowed(int qs, int ks, int qpos,
                                            int kpos, int causal) {
  return qs == ks && (!causal || kpos <= qpos);
}

// This block's [lo, hi) from the wrapper's bounds, clamped to [0, n].
__device__ __forceinline__ void tile_span(const int* lo, const int* hi,
                                          int idx, int n, int* first,
                                          int* last) {
  const int a = lo[idx], b = hi[idx];
  *first = a < 0 ? 0 : a;
  *last = b > n ? n : b;
}

}  // namespace flash
