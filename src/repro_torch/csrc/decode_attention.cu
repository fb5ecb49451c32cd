// B3 decode_attention: split-KV flash decoding for one new token per row,
// grouped-query attention, per-split partials (o, m, l).
//
// Replaces the JAX package's kernels/decode_attention.py:
// decode_attention_pallas (_decode_kernel). Same contract: q (B, Hq, D) f32,
// k and v (B, T, Hkv, D) in the cache's dtype (bf16 or f32), Hq = G * Hkv;
// row b attends positions [0, lengths[b]] inclusive; the T axis splits into
// ns chunks of tc = ceil(T / ns) positions, and each chunk emits
// o = sum_t p_t v_t (unnormalised), m = max_t s_t, l = sum_t p_t with
// s = (q . k) * D^-0.5 and p = exp(s - m), all f32. As in the reference, p is
// rounded to the cache dtype before it multiplies v (p.astype(v.dtype)),
// while l sums the unrounded p. kernels/decode_attention.py:combine_splits
// does the max-rescale merge, outside the kernel as in the reference.
//
// What bounds it on an H100: it reads the cache once, 2*B*T*Hkv*D elements,
// with 4*B*Hq*T*D f32 operations; at the serving shapes (B = 4, T = 160,
// Hkv = 8, D = 128, bf16) that is 2.6 MB, under a microsecond of memory
// time, so one launch costs about what launching it costs.
//
// Design: one block per (kv head, split, row): the G query heads that share
// a kv head share each k and v row read. A warp scores one position at a
// time (lanes split D, shuffle reduction), the block then forms m, l and p
// in shared memory, and each thread accumulates the P.V sum for some of the
// D output columns, reading v rows coalesced. Positions past T are skipped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// p rounded to the dtype of v, back in f32 (identity for an f32 cache)
__device__ __forceinline__ float round_like(float p, const float*) { return p; }
__device__ __forceinline__ float round_like(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

template <typename KV>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v,
                        const int* __restrict__ lengths, int T, int Hq,
                        int Hkv, int D, int ns, int tc, float scale,
                        float* __restrict__ o, float* __restrict__ m_out,
                        float* __restrict__ l_out) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  float* qsh = smem;        // [G][D]
  float* s = qsh + G * D;   // [G][tc]

  const int h = blockIdx.x, sp = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const int len = lengths[b];
  const int t0 = sp * tc;

  const float* qb = q + (static_cast<int64_t>(b) * Hq + h * G) * D;
  for (int e = tid; e < G * D; e += kThreads) qsh[e] = qb[e];
  __syncthreads();

  // scores: one warp per position
  for (int tt = warp; tt < tc; tt += kWarps) {
    const int t = t0 + tt;
    const bool valid = t < T && t <= len;
    const KV* kr = k + ((static_cast<int64_t>(b) * T + t) * Hkv + h) * D;
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
      if (valid)
        for (int d = lane; d < D; d += 32)
          part = fmaf(qsh[g * D + d], to_f32(kr[d]), part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) s[g * tc + tt] = valid ? part * scale : kNeg;
    }
  }
  __syncthreads();

  // m, l and p (rounded like v) per query head: one warp per head
  const int64_t ml = (static_cast<int64_t>(b) * ns + sp) * Hq + h * G;
  for (int g = warp; g < G; g += kWarps) {
    float* sg = s + g * tc;
    float mx = -INFINITY;
    for (int tt = lane; tt < tc; tt += 32) mx = fmaxf(mx, sg[tt]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int tt = lane; tt < tc; tt += 32) {
      const float p = expf(sg[tt] - mx);
      sum += p;
      sg[tt] = round_like(p, k);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m_out[ml + g] = mx;
      l_out[ml + g] = sum;
    }
  }
  __syncthreads();

  // o = P.V for this split, four query heads at a time
  const int t_end = min(tc, T - t0);
  for (int g0 = 0; g0 < G; g0 += 4) {
    for (int d = tid; d < D; d += kThreads) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int tt = 0; tt < t_end; ++tt) {
        const float vv = to_f32(
            v[((static_cast<int64_t>(b) * T + t0 + tt) * Hkv + h) * D + d]);
#pragma unroll
        for (int gg = 0; gg < 4; ++gg)
          if (g0 + gg < G) acc[gg] = fmaf(s[(g0 + gg) * tc + tt], vv, acc[gg]);
      }
#pragma unroll
      for (int gg = 0; gg < 4; ++gg)
        if (g0 + gg < G) o[(ml + g0 + gg) * D + d] = acc[gg];
    }
  }
}

template <typename KV>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const int* lengths, int B, int T, int Hq, int Hkv, int D,
                   int ns, float scale, float* o, float* m, float* l,
                   cudaStream_t stream) {
  const int tc = (T + ns - 1) / ns;
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * (static_cast<size_t>(G) * D +
                                       static_cast<size_t>(G) * tc);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, ns, B);
  decode_attention_kernel<KV><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const KV*>(k), static_cast<const KV*>(v), lengths, T, Hq,
      Hkv, D, ns, tc, scale, o, m, l);
  return cudaGetLastError();
}

}  // namespace

// kv_dtype: 0 = f32, 2 = bf16; scale = D^-0.5 rounded to f32 by the caller,
// as the reference multiplies by it. Returns a cudaError_t.
extern "C" int decode_attention(const float* q, const void* k, const void* v,
                                const int* lengths, int kv_dtype, int B,
                                int T, int Hq, int Hkv, int D, int ns,
                                float scale, float* o, float* m, float* l,
                                void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || ns <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 0)
    return launch<float>(q, k, v, lengths, B, T, Hq, Hkv, D, ns, scale, o, m,
                         l, s);
  if (kv_dtype == 2)
    return launch<__nv_bfloat16>(q, k, v, lengths, B, T, Hq, Hkv, D, ns, scale,
                                 o, m, l, s);
  return cudaErrorInvalidValue;
}
