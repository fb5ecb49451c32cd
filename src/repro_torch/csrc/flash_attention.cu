// B4 flash_attention: causal or non-causal grouped-query attention over a
// full sequence (prefill, and the MiniLM encoder's non-causal layers).
//
// Replaces the JAX package's kernels/flash_attention.py:
// flash_attention_pallas (_flash_kernel, wrapped by kernels/ops.py:
// flash_attention). Same contract: q (B, S, Hq, D), k and v (B, T, Hkv, D)
// in the model's layout (read through strides; the innermost dimension is
// contiguous), Hq = G * Hkv and query head h reads kv head h / G;
// s = (q . k) * D^-0.5 in f32, masked to the finite -1e30 where col >= T or,
// when causal, where col > row (offset 0); a running (acc, m, l) in f32 with
// m_new = max(m, max_t s), alpha = exp(m - m_new), p = exp(s - m_new),
// l = l * alpha + sum_t p, acc = acc * alpha + p.V where p is rounded to v's
// dtype before it multiplies v; o = acc / max(l, 1e-30) in q's dtype.
// Inputs are f32 or bf16; every product and sum is an f32 FMA on the CUDA
// cores: the f32 contract (2e-4 against the attention oracle) rules out the
// TF32 tensor cores.
//
// What bounds it on an H100 (chip_smoke.py's bound()): at the MiniLM encoder
// shape (B 256, S = T = 64, 6 heads, D 64, f32) q, k, v and o are 100.7 MB,
// 0.030 ms at 3.35 TB/s, over 1.61 GFLOP (0.024 ms at 67 TFLOP/s f32): bytes.
// At the qwen3-1.7b prefill shape (B 1, S = T = 160, 16/8 heads, D 128, f32,
// causal) 3.9 MB is 0.0012 ms and the 105 MFLOP of the unmasked half are
// 0.0016 ms: operations; real prompts are far shorter, so that launch is
// bound by the cost of launching it.
//
// Design: one block of 128 threads per (q tile of 64 rows, q head, batch
// row); a loop inside the block walks the 64-row K/V tiles in place of the
// TPU's sequential kv grid axis, and a causal block stops at the tile that
// holds its last row's diagonal (later tiles are fully masked, and skipping
// them changes nothing: their p is exactly 0). Q and K are staged in shared
// memory transposed (d-major, rows padded by one float against bank
// conflicts), V row-major. Thread (ty, tx) owns 4 query rows: it scores 8
// columns of the tile (tx + 8j), and holds 4 x D/8 output columns
// (tx*4 + 32j + c) of acc in registers; the row max and sum reduce over the
// 8 tx lanes of a warp with shuffles. p goes to shared memory over the K
// buffer, which is dead by then. Shared memory is dynamic, set with
// cudaFuncSetAttribute: 97 KB at D <= 128 (two blocks per SM), 50 KB at
// D <= 64. The score and P.V loops are scalar FMAs fed from shared memory,
// so the kernel runs well under the FMA peak; at B = 1 the prefill grid is
// only 16 heads x 1 to 3 q tiles on 132 SMs. Both are left for a redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // key/value rows per tile
constexpr int kQS = kBQ + 1;    // row stride of the transposed Q tile
constexpr int kKS = kBK + 1;    // row stride of the transposed K tile
constexpr int kPS = kBQ + 4;    // row stride of P (float4 reads over rows)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// p rounded to the dtype of v, back in f32 (identity for f32)
__device__ __forceinline__ float round_like(float p, const float*) { return p; }
__device__ __forceinline__ float round_like(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

struct Strides {  // element strides of the batch, sequence and head axes
  long long b, s, h;
};

__host__ __device__ constexpr int kp_floats(int dmax) {
  return dmax * kKS > kBK * kPS ? dmax * kKS : kBK * kPS;
}

template <typename E, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const E* __restrict__ q, const E* __restrict__ k,
                       const E* __restrict__ v, E* __restrict__ o, int S,
                       int T, int Hq, int Hkv, int D, int causal, float scale,
                       Strides qs, Strides ks, Strides vs) {
  constexpr int kDJ = DMAX / 32;  // 4-wide output column groups per thread
  extern __shared__ float smem[];
  float* Qt = smem;                        // [DMAX][kQS]
  float* KP = Qt + DMAX * kQS;             // K^T [DMAX][kKS], then P^T [kBK][kPS]
  float* Vs = KP + kp_floats(DMAX);        // [kBK][DMAX]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;

  const E* qb = q + b * qs.b + h * qs.h;
  const E* kb = k + b * ks.b + hk * ks.h;
  const E* vb = v + b * vs.b + hk * vs.h;

  // the Q tile; rows past S and columns past D are zero
  for (int e = tid; e < kBQ * DMAX; e += kThreads) {
    const int r = e / DMAX, d = e % DMAX, s = q0 + r;
    Qt[d * kQS + r] = (s < S && d < D) ? to_f32(qb[s * qs.s + d]) : 0.f;
  }

  float m[4], l[4], acc[4][kDJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  }

  int last = T - 1;  // the last key column any row of this block attends
  if (causal) last = min(last, min(q0 + kBQ, S) - 1);
  const int nk = last / kBK + 1;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // Q staged; the previous tile's P and V consumed
    for (int e = tid; e < kBK * DMAX; e += kThreads) {
      const int r = e / DMAX, d = e % DMAX, t = k0 + r;
      const bool ok = t < T && d < D;
      KP[d * kKS + r] = ok ? to_f32(kb[t * ks.s + d]) : 0.f;
      Vs[r * DMAX + d] = ok ? to_f32(vb[t * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qt[d * kQS + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = KP[d * kKS + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax per row; the 8 tx lanes of a row share a warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 8 * j;
        const bool valid = col < T && (!causal || col <= row);
        s[i][j] = valid ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading K^T: P overwrites it
    float* Pt = KP;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Pt[(tx + 8 * j) * kPS + ty * 4 + i] = round_like(s[i][j], v);
    __syncthreads();

    const int kn = min(kBK, T - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(Pt + kk * kPS + ty * 4);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int j = 0; j < kDJ; ++j) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(Vs + kk * DMAX + tx * 4 + 32 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j][0] = fmaf(pr[i], v4.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(pr[i], v4.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(pr[i], v4.z, acc[i][j][2]);
          acc[i][j][3] = fmaf(pr[i], v4.w, acc[i][j][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    E* orow = o + ((static_cast<long long>(b) * S + s) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < kDJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx * 4 + 32 * j + c;
        if (col < D) store(orow + col, acc[i][j][c] / den);
      }
  }
}

template <typename E, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int T, int Hq, int Hkv, int D, int causal,
                   float scale, Strides qs, Strides ks, Strides vs,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(DMAX) * kQS +
                                       kp_floats(DMAX) +
                                       static_cast<size_t>(kBK) * DMAX);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<E, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<E, DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(o), S, T, Hq, Hkv, D, causal,
      scale, qs, ks, vs);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int T, int Hq, int Hkv, int D,
                       int causal, float scale, Strides qs, Strides ks,
                       Strides vs, cudaStream_t stream) {
  if (D <= 64)
    return launch<E, 64>(q, k, v, o, B, S, T, Hq, Hkv, D, causal, scale, qs,
                         ks, vs, stream);
  return launch<E, 128>(q, k, v, o, B, S, T, Hq, Hkv, D, causal, scale, qs,
                        ks, vs, stream);
}

}  // namespace

// dtype: 0 = f32, 2 = bf16 (q, k, v and o alike); o is contiguous
// (B, S, Hq, D); the strides are in elements; scale = D^-0.5 rounded to f32
// by the caller, as the reference multiplies by it. Returns a cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int dtype, int B, int S, int T,
                               int Hq, int Hkv, int D, int causal, float scale,
                               long long q_sb, long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss, long long k_sh,
                               long long v_sb, long long v_ss, long long v_sh,
                               void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || T <= 0 || Hkv <= 0 || Hq <= 0 ||
      Hq > 65535 || Hq % Hkv != 0 || D <= 0 || D > 128)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, S, T, Hq, Hkv, D, causal, scale,
                             qs, ks, vs, s);
  if (dtype == 2)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, S, T, Hq, Hkv, D, causal,
                                     scale, qs, ks, vs, s);
  return cudaErrorInvalidValue;
}
