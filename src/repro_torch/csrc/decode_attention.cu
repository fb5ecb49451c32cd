// B3 decode_attention: split-KV flash decoding for one new token per row,
// grouped-query attention, with the merge of the splits in the same launch.
//
// Replaces the JAX package's kernels/decode_attention.py:
// decode_attention_pallas (_decode_kernel) together with combine_splits, as
// kernels/ops.py:decode_attention calls them. Same contract: q (B, Hq, D)
// f32, k and v (B, T, Hkv, D) in the cache's dtype (bf16 or f32), Hq = G *
// Hkv; row b attends positions [0, lengths[b]] inclusive; the T axis splits
// into ns chunks of tc = ceil(T / ns) positions, and each chunk forms
// o = sum_t p_t v_t (unnormalised), m = max_t s_t, l = sum_t p_t with
// s = (q . k) * D^-0.5 and p = exp(s - m), all f32. As in the reference, p
// is rounded to the cache dtype before it multiplies v (p.astype(v.dtype)),
// while l sums the unrounded p. The chunks then merge as combine_splits
// does: m_g = max m, o = sum o * exp(m - m_g) / max(sum l * exp(m - m_g),
// 1e-30). The output is (B, Hq, D) f32; no partial reaches device memory.
//
// What bounds it on an H100: the cache rows it must read, 2 * (attended
// positions) * Hkv * D elements; at the serving shapes (B = 4, T = 160,
// Hkv = 8, D = 128, bf16, lengths ~46-100) that is 0.4-1.7 MB, under a
// microsecond of memory time, so a launch costs about what launching it and
// one round trip to memory cost.
//
// Design: each split gets a block of four warps, which share its rows, and
// the blocks of a (kv head, row) form a thread block cluster of
// cs = min(ns, 16) blocks (16 is the largest cluster an H100 launches);
// block r takes the splits r, r + cs, ... and keeps each one's partial in
// its shared memory. After a cluster barrier each block merges a share of
// the outputs, reading its peers' partials through distributed shared
// memory. The G query heads of a kv head share each k and v row read, in
// groups of at most 8 (the heads a lane keeps in registers); a larger G
// gives each group of 8 clusters of its own, which read the rows again. A
// lane reads 16 bytes (8 bf16 or 4 f32); a row of D elements takes D / 8
// (bf16) or D / 4 (f32) lanes, so a warp reads 32 / that many rows at once
// and keeps a few row loads per lane in flight; an f32 row wider than 128
// (up to D = 256) takes 32 lanes of two 16-byte chunks each. A split reads
// only the positions [t0, min(t0 + tc, T, lengths[b] + 1)): no k or v row
// past the length, and nothing at all when it lies wholly past it (its
// merge weight exp(-1e30 - m_g) is exactly 0 in the reference, so it is
// left out). The
// v rows are loaded together with the k rows, so one round trip to memory
// serves both, and the shuffle sums of all rows and heads a lane holds are
// sent side by side.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;  // blocks of one cluster
constexpr int kWarps = 4;        // warps sharing a split
constexpr int kU = 4;            // row loads a lane keeps in flight
constexpr int kMaxSmem = 227 * 1024;

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const int* lengths;
  float* o;
  int T, Hq, Hkv, D, ns, tc;
  float scale;
};

// 16 bytes of the cache as floats
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// p rounded to the cache dtype, back in f32 (identity for an f32 cache)
template <typename KV>
__device__ __forceinline__ float round_like(float p) {
  if constexpr (sizeof(KV) == 2)
    return __bfloat162float(__float2bfloat16_rn(p));
  else
    return p;
}

// this lane's 16 bytes of rows j0 + u * step (u < kU) of a split; zero
// past its n attended rows
__device__ __forceinline__ void load_rows(const char* p, int64_t row_bytes,
                                          int j0, int step, int n, bool on,
                                          uint4 (&out)[kU]) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int i = j0 + u * step;
    out[u] = make_uint4(0u, 0u, 0u, 0u);
    if (on && i < n)
      out[u] = __ldg(reinterpret_cast<const uint4*>(p + i * row_bytes));
  }
}

// The block's warps form one split's partial [m (G)][l (G)][o (G x D)] of
// the n > 0 attended positions [t0, t0 + n) for the block's G <= GM query
// heads of kv head h in row b, into `part` (shared memory). A row's D / V
// 16-byte chunks take lpr lanes, CPL chunks a lane (lane c of a row holds
// chunks c, c + lpr, ...; CPL = 2 only for an f32 cache with D above 128).
// Warp wg reads rows wg * rpw + r, then every kWarps * rpw further ones. qs
// holds the G query rows; sc and ps are the block's [G][tc] scores and
// probabilities; red is [kWarps][G][D] for the sum over warps.
template <typename KV, int GM, int CPL>
__device__ __forceinline__ void split_partial(const Args& a, int b, int h,
                                              int G, int t0, int n,
                                              const float* qs, float* sc,
                                              float* ps, float* red,
                                              float* part) {
  constexpr int V = 16 / sizeof(KV);
  const int lane = threadIdx.x & 31, wg = threadIdx.x / 32;
  const int D = a.D, nch = D / V;
  float* pm = part;
  float* pl = part + G;
  float* po = part + 2 * G;
  int lpr = 1;  // lanes per row
  while (lpr * CPL < nch) lpr <<= 1;
  const int rpw = 32 / lpr, r = lane / lpr, c = lane % lpr;
  bool on[CPL];  // chunk c + cc * lpr lies inside the row
#pragma unroll
  for (int cc = 0; cc < CPL; ++cc) on[cc] = c + cc * lpr < nch;
  const int first = wg * rpw + r, step = kWarps * rpw;  // this lane's rows
  const int64_t row_bytes = static_cast<int64_t>(a.Hkv) * D * sizeof(KV);
  const int64_t off =
      (static_cast<int64_t>(b) * a.T + t0) * row_bytes +
      (static_cast<int64_t>(h) * D + c * V) * sizeof(KV);
  const int64_t cstep = static_cast<int64_t>(lpr) * 16;  // next chunk
  const char* kb = static_cast<const char*>(a.k) + off;
  const char* vb = static_cast<const char*>(a.v) + off;
  const int per = kU * step;  // rows of one batch

  uint4 vr[CPL][kU];
#pragma unroll
  for (int cc = 0; cc < CPL; ++cc)  // in flight with k
    load_rows(vb + cc * cstep, row_bytes, first, step, n, on[cc], vr[cc]);
  for (int j0 = first; j0 - first < n; j0 += per) {
    uint4 kr[CPL][kU];
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc)
      load_rows(kb + cc * cstep, row_bytes, j0, step, n, on[cc], kr[cc]);
    // every lane's share of the kU x G dot products first, then their
    // sums over the lpr lanes of a row, all kU x GM shuffles of a step
    // independent of each other
    float s[kU][GM];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int g = 0; g < GM; ++g) s[u][g] = 0.f;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        float kf[V];
        unpack(kr[cc][u], kf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (on[cc] && g < G) {
            const float* qg = qs + g * D + (c + cc * lpr) * V;
#pragma unroll
            for (int e = 0; e < V; ++e) s[u][g] = fmaf(qg[e], kf[e], s[u][g]);
          }
        }
      }
    }
    for (int o = lpr >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int g = 0; g < GM; ++g)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = j0 + u * step;
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G && c == 0 && i < n) sc[g * a.tc + i] = s[u][g] * a.scale;
    }
  }
  __syncthreads();

  // m, l and p (rounded like v) per query head, the G heads' reductions
  // side by side; every warp forms them over the whole split and writes
  // the same p, so each reads back what it needs unsynchronised
  float mx[GM], sum[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    mx[g] = -INFINITY;
    sum[g] = 0.f;
    if (g < G)
      for (int i = lane; i < n; i += 32) mx[g] = fmaxf(mx[g], sc[g * a.tc + i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g)
      mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G)
      for (int i = lane; i < n; i += 32) {
        const float p = expf(sc[g * a.tc + i] - mx[g]);
        sum[g] += p;
        ps[g * a.tc + i] = round_like<KV>(p);
      }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g)
      sum[g] += __shfl_xor_sync(0xffffffffu, sum[g], o);
  if (wg == 0 && lane == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) {
        pm[g] = mx[g];
        pl[g] = sum[g];
      }
  }
  __syncwarp();

  // o = P.V over this warp's rows of the split
  float acc[GM][CPL][V];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][cc][e] = 0.f;
  for (int j0 = first; j0 - first < n; j0 += per) {
    if (j0 > first) {
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc)
        load_rows(vb + cc * cstep, row_bytes, j0, step, n, on[cc], vr[cc]);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = j0 + u * step;
      if (i >= n) continue;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        float vf[V];
        unpack(vr[cc][u], vf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) break;
          const float p = ps[g * a.tc + i];
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[g][cc][e] = fmaf(p, vf[e], acc[g][cc][e]);
        }
      }
    }
  }
  // sum over the rpw rows a warp reads at once, then over the warps
  for (int o = lpr; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[g][cc][e] += __shfl_xor_sync(0xffffffffu, acc[g][cc][e], o);
  if (r == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        if (!on[cc]) continue;
#pragma unroll
        for (int e = 0; e < V; ++e)
          red[wg * G * D + g * D + (c + cc * lpr) * V + e] = acc[g][cc][e];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kWarps * 32) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w * G * D + i];
    po[i] = t;
  }
}

// combine_splits for outputs i0, i0 + step, ... of the block's G x D
// outputs ob; part(r, j) points at the [m][l][o] of split j * cs + r,
// which cluster block r keeps in its slot j
template <typename Part>
__device__ __forceinline__ void merge(const Args& a, float* ob, int G,
                                      int cs, int i0, int step, Part part) {
  for (int i = i0; i < G * a.D; i += step) {
    const int g = i / a.D;
    float mg = -INFINITY;
    for (int j = 0, s0 = 0; s0 < a.ns; ++j, s0 += cs)
      for (int r = 0; r < cs && s0 + r < a.ns; ++r)
        mg = fmaxf(mg, part(r, j)[g]);
    float L = 0.f, O = 0.f;
    for (int j = 0, s0 = 0; s0 < a.ns; ++j, s0 += cs)
      for (int r = 0; r < cs && s0 + r < a.ns; ++r) {
        const float* ps = part(r, j);
        const float m = ps[g];
        if (m == -INFINITY) continue;  // no attended position in the split
        const float w = expf(m - mg);
        L = fmaf(ps[G + g], w, L);
        O = fmaf(ps[2 * G + i], w, O);
      }
    ob[i] = O / fmaxf(L, 1e-30f);
  }
}

// splits a block of a cluster of cs keeps: ceil(ns / cs)
__host__ __device__ __forceinline__ int splits_per_block(int ns, int cs) {
  return (ns + cs - 1) / cs;
}

// grid (cs, Hkv * ng, B) for ng = ceil(Hq / Hkv / GM) groups of at most
// GM query heads per kv head, kWarps warps per block, the cs blocks of a
// (kv head, head group, row) one cluster; shared memory, for the block's G
// heads: [G][D] q, [ns / cs][2G + G D] partials, [2][G][tc] scores and
// probabilities, [kWarps][G][D] warp sums
template <typename KV, int GM, int CPL>
__global__ void __launch_bounds__(32 * kWarps)
decode_attention_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  cg::cluster_group cl = cg::this_cluster();
  const int Gkv = a.Hq / a.Hkv, ng = (Gkv + GM - 1) / GM;
  const int h = blockIdx.y / ng, g0 = blockIdx.y % ng * GM, b = blockIdx.z;
  const int G = min(GM, Gkv - g0);  // this block's query heads
  const int cs = gridDim.x;  // the cluster spans the grid's x
  const int rank = static_cast<int>(cl.block_rank());
  const int psz = 2 * G + G * a.D;  // one split's partial
  float* parts = qs + G * a.D;
  float* sc = parts + splits_per_block(a.ns, cs) * psz;
  float* red = sc + 2 * G * a.tc;
  const int last = min(a.lengths[b], a.T - 1);  // last attended position
  const int64_t row0 = (static_cast<int64_t>(b) * a.Hq + h * Gkv + g0) * a.D;
  const float4* qb = reinterpret_cast<const float4*>(a.q + row0);
  for (int e = threadIdx.x; e < G * a.D / 4; e += blockDim.x)
    reinterpret_cast<float4*>(qs)[e] = qb[e];
  __syncthreads();
#pragma unroll 1
  for (int sp = rank, j = 0; sp < a.ns; sp += cs, ++j) {
    const int t0 = sp * a.tc;
    const int n = min(min(a.tc, a.T - t0), last + 1 - t0);
    float* part = parts + j * psz;
    if (n <= 0) {  // m = -inf and no o: the merge leaves the split out
      for (int g = threadIdx.x; g < G; g += blockDim.x) part[g] = -INFINITY;
      continue;
    }
    split_partial<KV, GM, CPL>(a, b, h, G, t0, n, qs, sc, sc + G * a.tc, red,
                               part);
  }
  cl.sync();  // every partial written
  merge(a, a.o + row0, G, cs, rank * blockDim.x + threadIdx.x,
        cs * blockDim.x, [&](int r, int j) -> const float* {
          return cl.map_shared_rank(parts + j * psz,
                                    static_cast<unsigned>(r));
        });
  cl.sync();  // peers' shared memory stays until every block has read it
}

template <typename KV, int GM, int CPL>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  // the attributes once per instantiation, not per launch
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<KV, GM, CPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(decode_attention_kernel<KV, GM, CPL>,
                                cudaFuncAttributeNonPortableClusterSizeAllowed,
                                1);
  }();
  if (attr != cudaSuccess) return attr;
  const int Gkv = a.Hq / a.Hkv, ng = (Gkv + GM - 1) / GM;
  const int G = Gkv < GM ? Gkv : GM;  // query heads of the largest block
  const int cs = a.ns < kMaxCluster ? a.ns : kMaxCluster;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(G) * a.D +
       static_cast<size_t>(splits_per_block(a.ns, cs)) * (2 * G + G * a.D) +
       static_cast<size_t>(2) * G * a.tc +
       static_cast<size_t>(kWarps) * G * a.D);
  if (smem > kMaxSmem || static_cast<int64_t>(a.Hkv) * ng > 65535)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, a.Hkv * ng, B);
  cfg.blockDim = dim3(32 * kWarps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cs;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, decode_attention_kernel<KV, GM, CPL>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// GM: the query heads a lane keeps in registers; a G above 8 takes groups
// of 8 in blocks of their own
template <typename KV, int CPL>
cudaError_t dispatch_g(const Args& a, int B, cudaStream_t s) {
  const int G = a.Hq / a.Hkv;
  if (G <= 1) return launch<KV, 1, CPL>(a, B, s);
  if (G <= 2) return launch<KV, 2, CPL>(a, B, s);
  if (G <= 4) return launch<KV, 4, CPL>(a, B, s);
  return launch<KV, 8, CPL>(a, B, s);
}

}  // namespace

// q, k, v, lengths and o contiguous and 16-byte aligned; kv_dtype: 0 = f32,
// 2 = bf16; D a multiple of 8 up to 256; scale = D^-0.5 rounded to f32 by
// the caller, as the reference multiplies by it. o is (B, Hq, D) f32.
// Returns a cudaError_t: cudaErrorInvalidValue also when the shapes need
// more shared memory than a block has (a long split: raise ns).
extern "C" int decode_attention(const float* q, const void* k, const void* v,
                                const int* lengths, int kv_dtype, int B,
                                int T, int Hq, int Hkv, int D, int ns,
                                float scale, float* o, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || Hkv <= 0 || Hkv > 65535 ||
      Hq % Hkv != 0 || D <= 0 || D > 256 || D % 8 != 0 || ns <= 0)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, lengths, o, T, Hq, Hkv, D, ns, (T + ns - 1) / ns,
               scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte chunks of a row: D / 4 (f32) or D / 8 (bf16); a lane takes
  // two of them when a row has more than 32
  if (kv_dtype == 0)
    return D <= 128 ? dispatch_g<float, 1>(a, B, s)
                    : dispatch_g<float, 2>(a, B, s);
  if (kv_dtype == 2) return dispatch_g<__nv_bfloat16, 1>(a, B, s);
  return cudaErrorInvalidValue;
}
