// B2 mips_topk_int8: MIPS of an int8 query block against an int8 store with
// exact int32 accumulation and fused per-row dequant, per-tile top-k, on
// the s8 tensor cores.
//
// Replaces the JAX package's kernels/mips_topk_int8.py:mips_topk_int8_pallas
// (_mips_int8_kernel + the shared tile_topk). Same contract, bit for bit
// against kernels/ref.py:mips_topk_int8_ref: s = sum q8*x8 in int32 (exact,
// |s| <= 127*127*D < 2^24 for D <= 1040), then (float)s * q_scale[r] and
// then * x_scale[c], each product rounded to f32 in that order; rows >= N
// score -1e30; every tile of tile_n rows emits its exact top k in
// (value desc, index asc) order. Ties are common on the int8 grid, so the
// order is part of the result.
//
// What bounds it on an H100: the store is read once, N*(D+4) bytes (58 MB at
// the paper's 150,000 x 384, 0.0174 ms at 3.35 TB/s). The 2*Q*N*D int8
// products (3.7 G at Q = 32) take 0.0019 ms at the tensor cores' 1,979
// TOP/s, so it is bound by bytes.
//
// Design (mips_tc.cuh, as mips_topk.cu): one block of four warps per (store
// tile, block of up to 32 queries), three blocks per SM, a three-stage
// cp.async ring of 64-byte depth chunks of 256 store rows and the queries,
// and mma.sync m16n8k32 s8 x s8 -> s32. ldmatrix.x4 of 16 rows x 32 bytes
// is exactly the MMA's A fragment (row g, bytes 4t..4t+3 and 16 + 4t..);
// the query fragment is two 4-byte loads (stride 20 words: free of bank
// conflicts). Depth past D is zero-filled in shared memory, so any D runs
// with no copy of the store.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mips_tc.cuh"

namespace {

using namespace storinfer::mips;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct StoreS8 {
  using Acc = int;
  static constexpr int kXBytes = 1;
  static constexpr int kQBytes = 1;
  static constexpr int kQChunk = kChunk;
  static constexpr int kQStride = kQChunk / 4 + 4;  // 4 mod 8 words
  // a stage: kChunk values of a row, k32 steps
  template <int NQ>
  static __device__ __forceinline__ void compute(int (&acc)[kMT][NQ][4],
                                                 const char* xs,
                                                 const uint32_t* qs,
                                                 int lane, int nmt) {
    const int lg = lane >> 2, lt = lane & 3;
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int s = 0; s < kChunk / 32; ++s) {
      uint32_t b[NQ][2];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const uint32_t* qr = qs + (j * 8 + lg) * kQStride + 8 * s + lt;
        b[j][0] = qr[0];
        b[j][1] = qr[4];
      }
      const int piece = 2 * s + (lane >> 4);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (mt >= nmt) break;
        const int r = mt * 16 + lrow;
        uint32_t a[4];
        ldmatrix_x4(a, xs + r * kChunk + (swz(r, piece) << 4));
#pragma unroll
        for (int j = 0; j < NQ; ++j) mma_s8(acc[mt][j], a, b[j][0], b[j][1]);
      }
    }
  }
  static __device__ __forceinline__ float row_scale(int64_t row,
                                                    const Params& p) {
    return __ldg(p.x_scale + row);
  }
  static __device__ __forceinline__ float query_scale(int q,
                                                      const Params& p) {
    return __ldg(p.q_scale + q);
  }
  // (acc -> f32) * q_scale, then * x_scale: each product rounded
  static __device__ __forceinline__ float score(int acc, float xsc,
                                                float qsc) {
    return __fmul_rn(__fmul_rn(__int2float_rn(acc), qsc), xsc);
  }
};

int entry(const int8_t* q, const float* q_scale, const int8_t* x,
          const float* x_scale, int Q, int D, int N, int k, int tile_n,
          int x_gran, int q_gran, float* out_v, int* out_i, int* config,
          void* stream) {
  const Params p{q, q_scale, x,      x_scale, Q,     D,     N,
                 k, tile_n,  x_gran, q_gran,  out_v, out_i};
  return run<StoreS8>(p, config, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Any D; x_gran / q_gran: the largest of 16, 8 and 4 that
// divides a row's bytes and the base address (0 if none). Returns a
// cudaError_t: cudaErrorInvalidValue also when k > 1 and the [32][tile_n]
// score table does not fit in shared memory.
extern "C" int mips_topk_int8(const int8_t* q, const float* q_scale,
                              const int8_t* x, const float* x_scale, int Q,
                              int D, int N, int k, int tile_n, int x_gran,
                              int q_gran, float* out_v, int* out_i,
                              void* stream) {
  return entry(q, q_scale, x, x_scale, Q, D, N, k, tile_n, x_gran, q_gran,
               out_v, out_i, nullptr, stream);
}

// The launch configuration the same arguments get (see mips_topk_config).
extern "C" int mips_topk_int8_config(int Q, int D, int N, int k, int tile_n,
                                     int* out) {
  return entry(nullptr, nullptr, nullptr, nullptr, Q, D, N, k, tile_n, 16,
               16, nullptr, nullptr, out, nullptr);
}
