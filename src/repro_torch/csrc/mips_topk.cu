// B1 mips_topk: exact MIPS of an f32 query block against a float store,
// per-tile top-k candidates, on the TF32 tensor cores.
//
// Replaces the JAX package's kernels/mips_topk.py:mips_topk_pallas
// (_mips_kernel + tile_topk). Same contract: scores are f32 sums of f32
// query x store value (f32, f16 or bf16), store rows >= N score -1e30, and
// every tile of tile_n rows emits its exact top k in (value desc, index
// asc) order as (nt, Q, k) candidates with global row ids; kernels/ops.py
// reduces them to the global top k.
//
// The products run on mma.sync m16n8k8 TF32, accumulating in f32, with the
// f32 query split once per chunk as q = q_big + q_small, q_big = tf32(q),
// q_small = tf32(q - q_big):
// - an fp16 or bf16 store value is exact in TF32 (11 and 8 significant
//   bits, f32's exponent range), so a score is q_small.x + q_big.x: two
//   MMAs per product (2xTF32), whose error is about 2^-22 relative against
//   one TF32 pass's 2^-11, which misses the 1e-5 contract at D = 384;
// - an f32 store value splits too, and a score is q_small.x_big +
//   q_big.x_small + q_big.x_big: three MMAs (3xTF32, as flash_attention.cu).
// tests/test_torch_kernels.py emulates the three schemes on the CPU.
//
// What bounds it on an H100: the store is read once, N*D*2 bytes in fp16
// (115.2 MB at the paper's 150,000 x 384, 0.0344 ms at 3.35 TB/s); its
// 2*Q*N*D products are two TF32 products each, 7.4 GFLOP at Q = 32 or
// 0.0149 ms at 495 TFLOP/s, so the kernel is bound by bytes.
//
// Design (mips_tc.cuh): one block of four warps per (store tile, block of
// up to 32 queries), three blocks per SM, so the paper's 293 tiles run in
// one wave; a three-stage cp.async ring of 64-byte depth chunks of 256
// store rows and of the queries; each warp owns 64 rows x 32 queries of
// accumulators. A 16-bit store tile is read with ldmatrix in its own
// layout: a lane gets values 2t and 2t+1 of a row, widened in registers,
// so each 8-deep k step is numbered (2t, 2t+1) -> (t, t+4), and the query
// fragment reads q[2t], q[2t+1] of the same step as one 8-byte load.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mips_tc.cuh"

namespace {

using namespace storinfer::mips;

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, on the bit pattern: cvt.rna.tf32.f32's rounding in two integer
// operations
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the two 16-bit values of a word as f32 bit patterns (exact)
template <typename T>
__device__ __forceinline__ void widen(uint32_t w, uint32_t& lo, uint32_t& hi);
template <>
__device__ __forceinline__ void widen<__half>(uint32_t w, uint32_t& lo,
                                              uint32_t& hi) {
  lo = __float_as_uint(__half2float(__ushort_as_half(
      static_cast<unsigned short>(w & 0xffffu))));
  hi = __float_as_uint(
      __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16))));
}
template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(uint32_t w,
                                                     uint32_t& lo,
                                                     uint32_t& hi) {
  lo = w << 16;
  hi = w & 0xffff0000u;
}

struct ScoreF32 {
  using Acc = float;
  static constexpr int kQBytes = 4;
  static __device__ __forceinline__ float row_scale(int64_t, const Params&) {
    return 1.f;
  }
  static __device__ __forceinline__ float query_scale(int, const Params&) {
    return 1.f;
  }
  static __device__ __forceinline__ float score(float acc, float, float) {
    return acc;
  }
};

// fp16 / bf16 store: a stage holds kChunk / 2 values of a row (ldmatrix
// steps of two k8 steps each) and as many query values per query row (a
// stride of 8 mod 32 words: the 8-byte fragment loads are free of bank
// conflicts)
template <typename T>
struct Store16 : ScoreF32 {
  static constexpr int kXBytes = 2;
  static constexpr int kQChunk = 2 * kChunk;
  static constexpr int kQStride = kQChunk / 4 + 8;
  template <int NQ>
  static __device__ __forceinline__ void compute(float (&acc)[kMT][NQ][4],
                                                 const char* xs,
                                                 const uint32_t* qs,
                                                 int lane, int nmt) {
    const int lg = lane >> 2, lt = lane & 3;
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int h = 0; h < kChunk / 32; ++h) {
      // query fragments of k steps 2h + e: slot t is depth 2t, t + 4 is
      // 2t + 1
      uint32_t bb[NQ][2][2], bs[NQ][2][2];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 qv = *reinterpret_cast<const float2*>(
              qs + (j * 8 + lg) * kQStride + 16 * h + 8 * e + 2 * lt);
          split(qv.x, bb[j][e][0], bs[j][e][0]);
          split(qv.y, bb[j][e][1], bs[j][e][1]);
        }
      const int piece = 2 * h + (lane >> 4);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (mt >= nmt) break;
        const int r = mt * 16 + lrow;
        uint32_t m[4];
        ldmatrix_x4(m, xs + r * kChunk + (swz(r, piece) << 4));
        uint32_t a[2][4];
        widen<T>(m[0], a[0][0], a[0][2]);
        widen<T>(m[1], a[0][1], a[0][3]);
        widen<T>(m[2], a[1][0], a[1][2]);
        widen<T>(m[3], a[1][1], a[1][3]);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            mma_tf32(acc[mt][j], a[e], bs[j][e][0], bs[j][e][1]);
            mma_tf32(acc[mt][j], a[e], bb[j][e][0], bb[j][e][1]);
          }
      }
    }
  }
};

// f32 store: kChunk / 4 values of a row (k8 steps, one ldmatrix each, in
// the natural numbering) and as many query values per query row (a stride
// of 4 mod 8 words)
struct StoreF32 : ScoreF32 {
  static constexpr int kXBytes = 4;
  static constexpr int kQChunk = kChunk;
  static constexpr int kQStride = kQChunk / 4 + 4;
  template <int NQ>
  static __device__ __forceinline__ void compute(float (&acc)[kMT][NQ][4],
                                                 const char* xs,
                                                 const uint32_t* qs,
                                                 int lane, int nmt) {
    const int lg = lane >> 2, lt = lane & 3;
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int s = 0; s < kChunk / 32; ++s) {
      uint32_t bb[NQ][2], bs[NQ][2];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const uint32_t* qr = qs + (j * 8 + lg) * kQStride + 8 * s + lt;
        split(__uint_as_float(qr[0]), bb[j][0], bs[j][0]);
        split(__uint_as_float(qr[4]), bb[j][1], bs[j][1]);
      }
      const int piece = 2 * s + (lane >> 4);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (mt >= nmt) break;
        const int r = mt * 16 + lrow;
        uint32_t m[4], ab[4], as[4];
        ldmatrix_x4(m, xs + r * kChunk + (swz(r, piece) << 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) split(__uint_as_float(m[i]), ab[i], as[i]);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          mma_tf32(acc[mt][j], as, bb[j][0], bb[j][1]);
          mma_tf32(acc[mt][j], ab, bs[j][0], bs[j][1]);
          mma_tf32(acc[mt][j], ab, bb[j][0], bb[j][1]);
        }
      }
    }
  }
};

template <typename P>
int dispatch(const float* q, const void* x, int Q, int D, int N, int k,
             int tile_n, int x_gran, int q_gran, float* out_v, int* out_i,
             int* config, void* stream) {
  const Params p{q,      nullptr, x,      nullptr, Q,     D,
                 N,      k,       tile_n, x_gran,  q_gran, out_v,
                 out_i};
  return run<P>(p, config, static_cast<cudaStream_t>(stream));
}

int entry(const float* q, const void* x, int x_dtype, int Q, int D, int N,
          int k, int tile_n, int x_gran, int q_gran, float* out_v,
          int* out_i, int* config, void* stream) {
  switch (x_dtype) {
    case 0:
      return dispatch<StoreF32>(q, x, Q, D, N, k, tile_n, x_gran, q_gran,
                                out_v, out_i, config, stream);
    case 1:
      return dispatch<Store16<__half>>(q, x, Q, D, N, k, tile_n, x_gran,
                                       q_gran, out_v, out_i, config, stream);
    case 2:
      return dispatch<Store16<__nv_bfloat16>>(q, x, Q, D, N, k, tile_n,
                                              x_gran, q_gran, out_v, out_i,
                                              config, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x_dtype: 0 = f32, 1 = f16, 2 = bf16; x_gran / q_gran: the largest of 16,
// 8 and 4 that divides a row's bytes and the base address (0 if none).
// Returns a cudaError_t: cudaErrorInvalidValue also when k > 1 and the
// [32][tile_n] score table does not fit in shared memory.
extern "C" int mips_topk(const float* q, const void* x, int x_dtype, int Q,
                         int D, int N, int k, int tile_n, int x_gran,
                         int q_gran, float* out_v, int* out_i, void* stream) {
  return entry(q, x, x_dtype, Q, D, N, k, tile_n, x_gran, q_gran, out_v,
               out_i, nullptr, stream);
}

// The launch configuration the same arguments get, into out[7]: grid x,
// grid y, threads, blocks per SM, registers, local (spilled) bytes per
// thread, dynamic shared memory bytes.
extern "C" int mips_topk_config(int x_dtype, int Q, int D, int N, int k,
                                int tile_n, int* out) {
  return entry(nullptr, nullptr, x_dtype, Q, D, N, k, tile_n, 16, 16,
               nullptr, nullptr, out, nullptr);
}
