// Per-tile exact top-k of the search kernels' k > 1 path (mips_tc.cuh).
//
// Counterpart of the JAX package's kernels/mips_topk.py:tile_topk (with
// _chunk_topk / _merge_desc / _bitonic_merge_desc and the order _ge): the
// scores of one store tile sit in shared memory, one row of tile_n floats
// per query, and one warp selects a query's top k (two queries' at once) by
// k arg-max passes in the strict order (value desc, index asc). A selected
// entry is overwritten with -inf, below the -1e30 that marks store rows
// >= N, so those rows are still taken in index order when a tile holds
// fewer than k real rows - exactly the candidates the reference emits.
#pragma once

#include <math.h>

namespace storinfer {

constexpr float kNeg = -1e30f;

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// One warp: the top k of each of R score rows sc[r][0:tile_n] ->
// out_v[r][0:k], out_i[r][0:k] (+ row0). The R selections are independent,
// so their loads and shuffle chains overlap.
template <int R>
__device__ __forceinline__ void warp_tile_topk(float* const (&sc)[R],
                                               int tile_n, int k, int row0,
                                               float* const (&out_v)[R],
                                               int* const (&out_i)[R]) {
  const int lane = threadIdx.x & 31;
  for (int p = 0; p < k; ++p) {
    float bv[R];
    int bi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bv[r] = -INFINITY;
      bi[r] = 0x7fffffff;
    }
    for (int c = lane; c < tile_n; c += 32) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = sc[r][c];
        if (better(v, c, bv[r], bi[r])) {
          bv[r] = v;
          bi[r] = c;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv[r], off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi[r], off);
        if (better(ov, oi, bv[r], bi[r])) {
          bv[r] = ov;
          bi[r] = oi;
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        out_v[r][p] = bv[r];
        out_i[r][p] = row0 + bi[r];
        sc[r][bi[r]] = -INFINITY;
      }
    }
    __syncwarp();
  }
}

}  // namespace storinfer
