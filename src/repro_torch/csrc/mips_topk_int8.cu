// B2 mips_topk_int8: MIPS of an int8 query block against an int8 store with
// exact int32 accumulation and fused per-row dequant, per-tile top-k.
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
// the paper's 150K x 384), a quarter of the fp32 bytes. The 2*Q*N*D int8
// operations are far below the card's int8 rate, so it is memory-bound.
//
// Design: as mips_topk.cu, one block per (store tile, block of up to 32
// queries), with depth chunks of 256 store rows and of the queries staged in
// shared memory as packed 4-byte words. Each thread keeps a 4 rows x
// 8 queries int32 register tile and accumulates with __dp4a (s8.s8 -> s32,
// four products per instruction, exact). D arrives padded to a multiple of 4
// with zeros (kernels/ops.py), which leaves the sums unchanged.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_topk.cuh"

namespace {

using storinfer::kNeg;

constexpr int kThreads = 256;
constexpr int kRows = 256;   // store rows staged per pass, one per thread
constexpr int kWords = 16;   // depth chunk: 16 words = 64 int8 values

template <int QB>
__global__ void __launch_bounds__(kThreads)
mips_topk_int8_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ q_scale,
                      const int8_t* __restrict__ x,
                      const float* __restrict__ x_scale, int Q, int D, int N,
                      int k, int tile_n, bool vec_ok,
                      float* __restrict__ out_v, int* __restrict__ out_i) {
  constexpr int TY = QB / 8;
  constexpr int TX = kThreads / TY;
  constexpr int RPT = kRows / TX;
  extern __shared__ float smem[];
  int* xs = reinterpret_cast<int*>(smem);     // [kWords][kRows]
  int* qs = xs + kWords * kRows;              // [kWords][QB]
  float* sc = reinterpret_cast<float*>(qs + kWords * QB);  // [QB][tile_n]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, Q - q0);
  const int W = D / 4;  // words per row
  const int64_t tile_row0 = static_cast<int64_t>(tile) * tile_n;
  const int* qw = reinterpret_cast<const int*>(q);

  for (int sub = 0; sub * kRows < tile_n; ++sub) {
    const int local0 = sub * kRows;
    const int64_t row = tile_row0 + local0 + tid;
    const bool row_valid = (local0 + tid < tile_n) && row < N;
    const int* xrow = reinterpret_cast<const int*>(x) + row * W;
    int acc[RPT][8];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0;

    for (int w0 = 0; w0 < W; w0 += kWords) {
      __syncthreads();  // previous chunk fully consumed
      if (row_valid && vec_ok && w0 + kWords <= W) {
#pragma unroll
        for (int g = 0; g < kWords / 4; ++g) {
          const int4 v = reinterpret_cast<const int4*>(xrow + w0)[g];
          xs[(4 * g + 0) * kRows + tid] = v.x;
          xs[(4 * g + 1) * kRows + tid] = v.y;
          xs[(4 * g + 2) * kRows + tid] = v.z;
          xs[(4 * g + 3) * kRows + tid] = v.w;
        }
      } else {
#pragma unroll 4
        for (int j = 0; j < kWords; ++j)
          xs[j * kRows + tid] = (row_valid && w0 + j < W) ? xrow[w0 + j] : 0;
      }
      for (int e = tid; e < kWords * QB; e += kThreads) {
        const int j = e / kWords, w = e % kWords;
        qs[w * QB + j] = (j < nq && w0 + w < W)
                             ? qw[static_cast<int64_t>(q0 + j) * W + w0 + w]
                             : 0;
      }
      __syncthreads();
#pragma unroll 4
      for (int w = 0; w < kWords; ++w) {
        const int4 qa = *reinterpret_cast<const int4*>(qs + w * QB + ty * 8);
        const int4 qb = *reinterpret_cast<const int4*>(qs + w * QB + ty * 8 + 4);
        const int qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int xv = xs[w * kRows + tx + TX * i];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(xv, qv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int c = local0 + tx + TX * i;
      if (c >= tile_n) continue;
      const int64_t r = tile_row0 + c;
      const bool valid = r < N;
      const float xsc = valid ? x_scale[r] : 1.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float s = kNeg;
        if (valid) {
          const float qsc = (ty * 8 + j < nq) ? q_scale[q0 + ty * 8 + j] : 1.f;
          // (acc -> f32) * q_scale, then * x_scale: each product rounded
          s = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), qsc), xsc);
        }
        sc[(ty * 8 + j) * tile_n + c] = s;
      }
    }
  }
  __syncthreads();

  const int warp = tid / 32;
  for (int j = warp; j < nq; j += kThreads / 32) {
    const int64_t o = (static_cast<int64_t>(tile) * Q + q0 + j) * k;
    storinfer::warp_tile_topk(sc + j * tile_n, tile_n, k,
                              static_cast<int>(tile_row0), out_v + o,
                              out_i + o);
  }
}

template <int QB>
cudaError_t launch(const int8_t* q, const float* qs, const int8_t* x,
                   const float* xs, int Q, int D, int N, int k, int tile_n,
                   int vec_ok, float* out_v, int* out_i, cudaStream_t stream) {
  const size_t smem =
      sizeof(int) * (static_cast<size_t>(kWords) * kRows + kWords * QB +
                     static_cast<size_t>(QB) * tile_n);
  cudaError_t err = cudaFuncSetAttribute(
      mips_topk_int8_kernel<QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nt = (N + tile_n - 1) / tile_n;
  const dim3 grid(nt, (Q + QB - 1) / QB);
  mips_topk_int8_kernel<QB><<<grid, kThreads, smem, stream>>>(
      q, qs, x, xs, Q, D, N, k, tile_n, vec_ok != 0, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace

// D must be a multiple of 4. Returns a cudaError_t.
extern "C" int mips_topk_int8(const int8_t* q, const float* q_scale,
                              const int8_t* x, const float* x_scale, int Q,
                              int D, int N, int k, int tile_n, int vec_ok,
                              float* out_v, int* out_i, void* stream) {
  if (D % 4 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q <= 8)
    return launch<8>(q, q_scale, x, x_scale, Q, D, N, k, tile_n, vec_ok, out_v,
                     out_i, s);
  return launch<32>(q, q_scale, x, x_scale, Q, D, N, k, tile_n, vec_ok, out_v,
                    out_i, s);
}
