// Per-tile exact top-k shared by mips_topk.cu and mips_topk_int8.cu.
//
// Counterpart of the JAX package's kernels/mips_topk.py:tile_topk (with
// _chunk_topk / _merge_desc / _bitonic_merge_desc and the order _ge): the
// scores of one store tile sit in shared memory, one row of tile_n floats
// per query, and one warp selects a query's top k by k arg-max passes in the
// strict order (value desc, index asc). A selected entry is overwritten with
// -inf, below the -1e30 that marks store rows >= N, so those rows are still
// taken in index order when a tile holds fewer than k real rows - exactly
// the candidates the reference emits.
#pragma once

#include <math.h>

namespace storinfer {

constexpr float kNeg = -1e30f;

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// One warp: top-k of sc[0:tile_n] -> out_v[0:k], out_i[0:k] (+ row0).
__device__ __forceinline__ void warp_tile_topk(float* sc, int tile_n, int k,
                                               int row0, float* out_v,
                                               int* out_i) {
  const int lane = threadIdx.x & 31;
  for (int p = 0; p < k; ++p) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int c = lane; c < tile_n; c += 32) {
      const float v = sc[c];
      if (better(v, c, bv, bi)) {
        bv = v;
        bi = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      out_v[p] = bv;
      out_i[p] = row0 + bi;
      sc[bi] = -INFINITY;
    }
    __syncwarp();
  }
}

}  // namespace storinfer
