// B1 mips_topk: exact MIPS of an f32 query block against a float store,
// per-tile top-k candidates.
//
// Replaces the JAX package's kernels/mips_topk.py:mips_topk_pallas
// (_mips_kernel + tile_topk). Same contract: scores are f32 sums of
// f32 query x store value (f32, f16 or bf16 upcast in registers), store rows
// >= N score -1e30, and every tile of tile_n rows emits its exact top k in
// (value desc, index asc) order as (nt, Q, k) candidates with global row
// ids; kernels/ops.py reduces them to the global top k.
//
// What bounds it on an H100: the store is read once (N*D*2 bytes in fp16,
// 115 MB at the paper's 150K x 384), but every byte feeds Q multiply-adds,
// and the f32 query with the 1e-5 contract rules out fp16/TF32 tensor cores
// for now. At Q = 32 the 2*Q*N*D f32 operations on CUDA cores (67 TFLOP/s)
// take longer than the bytes (3.35 TB/s), so the kernel is compute-bound
// there and memory-bound for small Q.
//
// Design: the sequential Pallas grid becomes a 2-D grid, one block per
// (store tile, block of up to 32 queries), run in any order. A block stages
// depth chunks of 256 store rows and of its queries in shared memory (f32),
// and each thread keeps a register tile of 4 rows x 8 queries, so one
// shared-memory read feeds 8 or 4 FMAs. The store tile is read from device
// memory once for up to 32 queries. Scores go to shared memory, where one
// warp per query runs the tile top-k. Rows >= N are skipped, not padded.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_topk.cuh"

namespace {

using storinfer::kNeg;

constexpr int kThreads = 256;
constexpr int kRows = 256;   // store rows staged per pass, one per thread
constexpr int kDepth = 32;   // depth chunk staged per step

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Stage x[row, d0:d0+kDepth] as f32 into dst[d * kRows] (zeros past D or N).
template <typename T>
__device__ __forceinline__ void stage_row(const T* __restrict__ x, int64_t row,
                                          bool valid, int D, int d0,
                                          bool vec_ok, float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  const T* src = x + row * D + d0;
  if (valid && vec_ok && d0 + kDepth <= D) {
#pragma unroll
    for (int g = 0; g < kDepth / kVec; ++g) {
      const uint4 w = reinterpret_cast<const uint4*>(src)[g];
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[(g * kVec + j) * kRows] = to_f32(e[j]);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < kDepth; ++j)
      dst[j * kRows] = (valid && d0 + j < D) ? to_f32(src[j]) : 0.f;
  }
}

// QB queries per block: TY groups of 8 queries x TX row lanes.
template <typename T, int QB>
__global__ void __launch_bounds__(kThreads)
mips_topk_kernel(const float* __restrict__ q, const T* __restrict__ x, int Q,
                 int D, int N, int k, int tile_n, bool vec_ok,
                 float* __restrict__ out_v, int* __restrict__ out_i) {
  constexpr int TY = QB / 8;
  constexpr int TX = kThreads / TY;
  constexpr int RPT = kRows / TX;
  extern __shared__ float smem[];
  float* xs = smem;                      // [kDepth][kRows]
  float* qs = xs + kDepth * kRows;       // [kDepth][QB]
  float* sc = qs + kDepth * QB;          // [QB][tile_n]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, Q - q0);
  const int64_t tile_row0 = static_cast<int64_t>(tile) * tile_n;

  for (int sub = 0; sub * kRows < tile_n; ++sub) {
    const int local0 = sub * kRows;
    const int64_t row = tile_row0 + local0 + tid;
    const bool row_valid = (local0 + tid < tile_n) && row < N;
    float acc[RPT][8];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kDepth) {
      __syncthreads();  // previous chunk fully consumed
      stage_row(x, row, row_valid, D, d0, vec_ok, xs + tid);
      for (int e = tid; e < kDepth * QB; e += kThreads) {
        const int j = e / kDepth, d = e % kDepth;
        qs[d * QB + j] =
            (j < nq && d0 + d < D) ? q[static_cast<int64_t>(q0 + j) * D + d0 + d]
                                   : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kDepth; ++d) {
        const float4 qa = *reinterpret_cast<const float4*>(qs + d * QB + ty * 8);
        const float4 qb =
            *reinterpret_cast<const float4*>(qs + d * QB + ty * 8 + 4);
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float xv = xs[d * kRows + tx + TX * i];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv, qv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int c = local0 + tx + TX * i;
      if (c >= tile_n) continue;
      const bool valid = tile_row0 + c < N;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sc[(ty * 8 + j) * tile_n + c] = valid ? acc[i][j] : kNeg;
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

template <typename T, int QB>
cudaError_t launch(const float* q, const void* x, int Q, int D, int N, int k,
                   int tile_n, int vec_ok, float* out_v, int* out_i,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kDepth) * kRows + kDepth * QB +
                       static_cast<size_t>(QB) * tile_n);
  cudaError_t err = cudaFuncSetAttribute(
      mips_topk_kernel<T, QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nt = (N + tile_n - 1) / tile_n;
  const dim3 grid(nt, (Q + QB - 1) / QB);
  mips_topk_kernel<T, QB><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(x), Q, D, N, k, tile_n, vec_ok != 0, out_v,
      out_i);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_qb(const float* q, const void* x, int Q, int D, int N,
                        int k, int tile_n, int vec_ok, float* out_v,
                        int* out_i, cudaStream_t stream) {
  if (Q <= 8)
    return launch<T, 8>(q, x, Q, D, N, k, tile_n, vec_ok, out_v, out_i, stream);
  return launch<T, 32>(q, x, Q, D, N, k, tile_n, vec_ok, out_v, out_i, stream);
}

}  // namespace

// x_dtype: 0 = f32, 1 = f16, 2 = bf16. Returns a cudaError_t.
extern "C" int mips_topk(const float* q, const void* x, int x_dtype, int Q,
                         int D, int N, int k, int tile_n, int vec_ok,
                         float* out_v, int* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      return dispatch_qb<float>(q, x, Q, D, N, k, tile_n, vec_ok, out_v, out_i,
                                s);
    case 1:
      return dispatch_qb<__half>(q, x, Q, D, N, k, tile_n, vec_ok, out_v,
                                 out_i, s);
    case 2:
      return dispatch_qb<__nv_bfloat16>(q, x, Q, D, N, k, tile_n, vec_ok,
                                        out_v, out_i, s);
    default:
      return cudaErrorInvalidValue;
  }
}
