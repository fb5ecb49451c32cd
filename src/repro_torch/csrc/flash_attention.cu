// B4 flash_attention: causal or non-causal grouped-query attention over a
// full sequence (prefill, and the MiniLM encoder's non-causal layers), on
// the tensor cores.
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
//
// Both products run on the tensor cores with mma.sync, accumulating in f32.
// bf16 inputs use the bf16 m16n8k16 MMA as they are (p rounded to bf16 is
// the operand of P.V). f32 inputs use the m16n8k8 TF32 MMA three times per
// product (3xTF32, the scheme of CUTLASS's OpMultiplyAddFastF32): with
// a = a_big + a_small, a_big = tf32(a), a_small = tf32(a - a_big), and the
// same for b, a.b ~ a_big.b_big + a_big.b_small + a_small.b_big, whose
// relative error is about 2^-21 against one TF32 product's 2^-11. One TF32
// pass would miss the f32 contract (2e-4 against the attention oracle) at
// D = 64 to 128; the split holds it (tests/test_torch_kernels.py emulates
// both on the CPU).
//
// What bounds it on an H100 (chip_smoke.py's bound()): at the MiniLM encoder
// shape (B 256, S = T = 64, 6 heads, D 64, f32) q, k, v and o are 100.7 MB,
// 0.030 ms at 3.35 TB/s: bytes. At the qwen3-1.7b prefill shape (B 1,
// S = T = 160, 16/8 heads, D 128, f32, causal) 3.9 MB is 0.0012 ms and the
// 105 MFLOP of the unmasked half are 0.0016 ms at the f32 CUDA-core rate
// the bound is stated in; real prompts are far shorter, so that launch is
// bound by the cost of launching it and a few round trips to memory.
//
// Design: the G query heads of a kv head are packed into one block's rows
// (packed row r = s * G + g: position s of head h = hk * G + g), so a K/V
// tile is read once per kv head. A block is 4 warps. Usually each warp owns
// 16 of the block's 64 packed rows and walks every K/V tile. For f32 inputs
// whose grid of 64-row blocks would not cover the SMs (a prefill at B = 1)
// and that span more than one tile, a block owns 16 rows and its 4 warps
// take a quarter of each tile's keys each, with their own (m, l, acc),
// merged through shared memory at the end: the serial walk a warp makes is
// a quarter as long, and a 160-token prefill runs 8 kv heads x 20 blocks.
// Blocks whose rows reach furthest along a causal sequence start first. Q
// and double-buffered K/V tiles are staged with cp.async (16 bytes per
// thread; the next tile loads while the current one is in the MMAs); rows
// are padded in shared memory so every fragment load is free of bank
// conflicts. The score accumulator is reused as P.V's A operand in
// registers: for bf16 directly (the m16n8k16 layouts coincide), for TF32 by
// numbering the keys of each 8-key step so that the accumulator's columns
// 2t, 2t+1 are the operand's t, t+4 and reading V's rows in that order. A
// causal warp skips the key columns past its last row. cudaFuncSetAttribute
// runs once per instantiation. Instances cover D up to 64, 128 and 256 (the
// widest head among the configs is deepseek-v2-lite's 192); at 256 a warp's
// 16 x 256 f32 output accumulator alone is 128 registers a thread, and the
// f32 tiles take 195 KB of shared memory (one block per SM).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kThreads = 128;

struct Strides {  // element strides of the batch, sequence and head axes
  long long b, s, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, Hq, Hkv, D, causal;
  float scale;
  Strides qs, ks, vs;
  int wk;  // warps sharing a row group: 1 or 4 (set by launch)
};

template <typename E>
struct Tile;
// f32: m16n8k8 TF32 steps; rows padded by 4 floats
template <>
struct Tile<float> {
  static constexpr int kPad = 4;
  static constexpr int kBK = 32;  // keys per tile
};
// bf16: m16n8k16 steps; rows padded by 8 elements
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kPad = 8;
  static constexpr int kBK = 64;
};

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, on the bit pattern: cvt.rna.tf32.f32's rounding in two integer
// operations, which run at a higher rate than the conversion
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
// 3xTF32: the two small cross terms first, then the big product
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes of each row [0, nrows) of a tile per cp.async: row r from
// src + (t0 + r) * st into dst + r * DS; rows at or past tmax and columns
// at or past D are zeros
template <typename E, int DMAX, int DS>
__device__ __forceinline__ void load_tile(E* dst, const E* src, long long st,
                                          int t0, int nrows, int tmax,
                                          int D) {
  constexpr int V = 16 / sizeof(E);
  constexpr int CPR = DMAX / V;          // chunks per row
  constexpr int RPP = kThreads / CPR;    // rows per pass
  const int c = threadIdx.x % CPR;
  const bool cok = c * V < D;
  for (int r = threadIdx.x / CPR; r < nrows; r += RPP) {
    const int t = t0 + r;
    const bool ok = cok && t < tmax;
    cp_async16(dst + r * DS + c * V, ok ? src + t * st + c * V : src, ok);
  }
}

// One block: 4 warps over BR = 64 / wk packed rows of kv head blockIdx.y in
// batch row blockIdx.z. Warp w takes the 16 rows (w / wk) * 16.. and, of
// each K/V tile, the BK / wk keys (w % wk) * BK / wk..; with wk = 4 the
// warps of the one row group merge their (m, l, o) at the end.
template <typename E, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(Args a) {
  using TL = Tile<E>;
  constexpr int BK = TL::kBK;
  constexpr int DS = DMAX + TL::kPad;    // shared row stride, elements
  constexpr int NT = DMAX / 8;           // n8 tiles of the output
  constexpr int SN = BK / 8;             // n8 tiles of a score tile
  constexpr bool kF32 = sizeof(E) == 4;
  extern __shared__ float4 smem4[];
  E* Qs = reinterpret_cast<E*>(smem4);

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int lg = lane >> 2, lt = lane & 3;
  const int wk = a.wk, BR = 64 / wk, KW = BK / wk;
  const int G = a.Hq / a.Hkv, R = G * a.S;  // packed rows of this kv head
  // the tile reaching furthest along the sequence first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int D = a.D;
  E* KV0 = Qs + BR * DS;                   // stage s: K at KV0 + s * 2 * BK * DS

  const E* qb = static_cast<const E*>(a.q) + b * a.qs.b + hk * G * a.qs.h;
  const E* kb = static_cast<const E*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const E* vb = static_cast<const E*>(a.v) + b * a.vs.b + hk * a.vs.h;

  // the last key column any row of this block, and of this warp, attends
  const int last = a.causal ? min(a.T - 1, (min(r0 + BR, R) - 1) / G)
                            : a.T - 1;
  const int ntiles = last / BK + 1;
  const int wr0 = r0 + (warp / wk) * 16, kofs = (warp % wk) * KW;
  const bool wactive = wr0 < R;
  const int wlast =
      a.causal ? min(a.T - 1, (min(wr0 + 16, R) - 1) / G) : a.T - 1;

  {  // Q rows, with K/V tile 0, in the first group
    constexpr int V = 16 / sizeof(E);
    constexpr int CPR = DMAX / V;
    const int c = threadIdx.x % CPR;
    const bool cok = c * V < D;
    for (int r = threadIdx.x / CPR; r < BR; r += kThreads / CPR) {
      const int pr = r0 + r, s = pr / G;
      const bool ok = cok && pr < R;
      cp_async16(Qs + r * DS + c * V,
                 ok ? qb + s * a.qs.s + (pr - s * G) * a.qs.h + c * V : qb,
                 ok);
    }
  }
  auto load_stage = [&](int kt) {
    E* Ks = KV0 + (kt & 1) * 2 * BK * DS;
    load_tile<E, DMAX, DS>(Ks, kb, a.ks.s, kt * BK, BK, a.T, D);
    load_tile<E, DMAX, DS>(Ks + BK * DS, vb, a.vs.s, kt * BK, BK, a.T, D);
    cp_async_commit();
  };
  load_stage(0);
  if (ntiles > 1) load_stage(1);

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float oacc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[nt][j] = 0.f;
  const int prow[2] = {(wr0 + lg) / G, (wr0 + lg + 8) / G};  // positions

  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt + 1 < ntiles)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int k0 = kt * BK + kofs;  // this warp's first key of the tile
    const int kmax = min(wlast - k0, KW - 1);  // its last, relative to k0
    if (wactive && kmax >= 0) {
      const E* Ks = KV0 + (kt & 1) * 2 * BK * DS + kofs * DS;
      const E* Vs = Ks + BK * DS;
      const E* Qw = Qs + (warp / wk) * 16 * DS;

      // ---- S = Q K^T for this warp's 16 rows x KW keys; f32 sums its even
      // and odd k steps apart (two chains of dependent MMAs, not one: with
      // wk = 4 a warp's 8 keys are one n8 tile)
      float sacc[SN][4], sodd[SN][4];
#pragma unroll
      for (int nt = 0; nt < SN; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[nt][j] = sodd[nt][j] = 0.f;
      if constexpr (kF32) {
        const float* Qf = reinterpret_cast<const float*>(Qw);
        const float* Kf = reinterpret_cast<const float*>(Ks);
#pragma unroll
        for (int ks = 0; ks < DMAX / 8; ++ks) {
          if (ks * 8 >= D) break;
          const int c0 = ks * 8 + lt;
          uint32_t ab[4], as[4];
          split(Qf[lg * DS + c0], ab[0], as[0]);
          split(Qf[(lg + 8) * DS + c0], ab[1], as[1]);
          split(Qf[lg * DS + c0 + 4], ab[2], as[2]);
          split(Qf[(lg + 8) * DS + c0 + 4], ab[3], as[3]);
#pragma unroll
          for (int nt = 0; nt < SN; ++nt) {
            if (nt * 8 > kmax) break;
            const float* kr = Kf + (nt * 8 + lg) * DS + c0;
            uint32_t bb0, bs0, bb1, bs1;
            split(kr[0], bb0, bs0);
            split(kr[4], bb1, bs1);
            mma_3xtf32(ks & 1 ? sodd[nt] : sacc[nt], ab, as, bb0, bb1, bs0,
                       bs1);
          }
        }
      } else {
        const uint32_t* Qw32 = reinterpret_cast<const uint32_t*>(Qw);
        const uint32_t* K32 = reinterpret_cast<const uint32_t*>(Ks);
        constexpr int DS2 = DS / 2;
#pragma unroll
        for (int ks = 0; ks < DMAX / 16; ++ks) {
          if (ks * 16 >= D) break;
          const int w0 = ks * 8 + lt;
          const uint32_t qa[4] = {Qw32[lg * DS2 + w0],
                                  Qw32[(lg + 8) * DS2 + w0],
                                  Qw32[lg * DS2 + w0 + 4],
                                  Qw32[(lg + 8) * DS2 + w0 + 4]};
#pragma unroll
          for (int nt = 0; nt < SN; ++nt) {
            if (nt * 8 > kmax) break;
            const uint32_t* kr = K32 + (nt * 8 + lg) * DS2 + w0;
            mma_bf16(sacc[nt], qa, kr[0], kr[4]);
          }
        }
      }
      if constexpr (kF32) {
#pragma unroll
        for (int nt = 0; nt < SN; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[nt][j] += sodd[nt][j];
      }

      // ---- online softmax; this thread holds rows lg and lg + 8, columns
      // nt * 8 + 2 lt + {0, 1}
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int nt = 0; nt < SN; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cr = nt * 8 + 2 * lt + (j & 1), col = k0 + cr;
          const int i = j >> 1;
          const bool ok = cr < KW && col < a.T &&
                          (!a.causal || col <= prow[i]);
          sacc[nt][j] = ok ? sacc[nt][j] * a.scale : kNeg;
          mx[i] = fmaxf(mx[i], sacc[nt][j]);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mn = fmaxf(m[i], mx[i]);
        alpha[i] = expf(m[i] - mn);
        m[i] = mn;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int nt = 0; nt < SN; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = j >> 1;
          sacc[nt][j] = expf(sacc[nt][j] - m[i]);
          l[i] += sacc[nt][j];  // this lane's share; summed at the end
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        oacc[nt][0] *= alpha[0];
        oacc[nt][1] *= alpha[0];
        oacc[nt][2] *= alpha[1];
        oacc[nt][3] *= alpha[1];
      }

      // ---- O += P V
      if constexpr (kF32) {
        const float* Vf = reinterpret_cast<const float*>(Vs);
#pragma unroll
        for (int kk = 0; kk < SN; ++kk) {
          if (kk * 8 > kmax) break;
          // operand column lt is key 2 lt, column lt + 4 is key 2 lt + 1
          uint32_t ab[4], as[4];
          split(sacc[kk][0], ab[0], as[0]);
          split(sacc[kk][2], ab[1], as[1]);
          split(sacc[kk][1], ab[2], as[2]);
          split(sacc[kk][3], ab[3], as[3]);
          const float* v0 = Vf + (kk * 8 + 2 * lt) * DS + lg;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt * 8 >= D) break;
            uint32_t bb0, bs0, bb1, bs1;
            split(v0[nt * 8], bb0, bs0);
            split(v0[DS + nt * 8], bb1, bs1);
            mma_3xtf32(oacc[nt], ab, as, bb0, bb1, bs0, bs1);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < SN / 2; ++kk) {
          if (kk * 16 > kmax) break;
          const uint32_t pa[4] = {
              pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
              pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
              pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
              pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
          // lanes 8j..8j+7 address matrix j: keys (j & 1) * 8 + (lane & 7)
          // of this step, columns (j >> 1) * 8 of the n8 pair
          const E* vrow = Vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7))
                                   * DS + (lane >> 4) * 8;
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            if (np * 16 >= D) break;
            uint32_t vb4[4];
            ldmatrix_x4_trans(vb4, vrow + np * 16);
            mma_bf16(oacc[2 * np], pa, vb4[0], vb4[1]);
            if (np * 16 + 8 < D) mma_bf16(oacc[2 * np + 1], pa, vb4[2], vb4[3]);
          }
        }
      }
    }
    __syncthreads();  // stage kt & 1 consumed
    if (kt + 2 < ntiles) load_stage(kt + 2);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  E* ob = static_cast<E*>(a.o);
  if (wk == 1) {
    if (!wactive) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pr = wr0 + lg + 8 * i;
      if (pr >= R) continue;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      E* orow = ob + ((static_cast<long long>(b) * a.S + pr / G) * a.Hq +
                      hk * G + pr % G) * static_cast<long long>(D);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt * 8 >= D) break;
        store2(orow + nt * 8 + 2 * lt, oacc[nt][2 * i] * inv,
               oacc[nt][2 * i + 1] * inv);
      }
    }
    return;
  }

  // the 4 warps (wk = 4: one row group) merge their partials through
  // shared memory; every tile is consumed, the loop ended on a barrier
  constexpr int PS = 16 * DMAX + 32;  // one warp's [o 16 x DMAX][m 16][l 16]
  float* part = reinterpret_cast<float*>(smem4);
  float* wgt = part + 4 * PS;         // [16][4]: exp(m_w - M) / L per row
  {
    float* po = part + warp * PS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = lg + 8 * i;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt * 8 >= D) break;
        *reinterpret_cast<float2*>(po + row * DMAX + nt * 8 + 2 * lt) =
            make_float2(oacc[nt][2 * i], oacc[nt][2 * i + 1]);
      }
      if (lt == 0) {
        po[16 * DMAX + row] = m[i];
        po[16 * DMAX + 16 + row] = l[i];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 64) {
    const int row = threadIdx.x >> 2, w = threadIdx.x & 3;
    const float* pm = part + 16 * DMAX + row;
    float M = kNeg;
#pragma unroll
    for (int x = 0; x < 4; ++x) M = fmaxf(M, pm[x * PS]);
    float L = 0.f;
#pragma unroll
    for (int x = 0; x < 4; ++x) L += pm[x * PS + 16] * expf(pm[x * PS] - M);
    wgt[threadIdx.x] = expf(pm[w * PS] - M) / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const long long bs = static_cast<long long>(b) * a.S;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    // packed row r0 + row is position s, head hk * G + g
    int s = r0 / G, g = r0 - s * G;
    for (int row = 0; row < 16 && r0 + row < R; ++row) {
      const float* po = part + row * DMAX + c;
      float O = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) O = fmaf(po[w * PS], wgt[row * 4 + w], O);
      store1(ob + ((bs + s) * a.Hq + hk * G + g) * static_cast<long long>(D) +
                 c,
             O);
      if (++g == G) {
        g = 0;
        ++s;
      }
    }
  }
}

template <typename E, int DMAX>
cudaError_t launch(const Args& a0, int B, cudaStream_t stream) {
  using TL = Tile<E>;
  constexpr int BK = TL::kBK;
  constexpr int DS = DMAX + TL::kPad;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<E, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  Args a = a0;
  const int R = a.Hq / a.Hkv * a.S;
  // 64-row blocks, one warp per 16 rows; 16-row blocks whose 4 warps split
  // each K/V tile's keys when f32's three MMAs per product make the serial
  // walk over the tiles the longest path: fewer 64-row blocks than SMs and
  // more than one tile. bf16's one MMA is faster unsplit (PERF.md).
  a.wk = sizeof(E) == 4 && a.T > BK &&
                 static_cast<long long>((R + 63) / 64) * a.Hkv * B < sms
             ? 4
             : 1;
  const int BR = 64 / a.wk;
  const int stages = a.T > BK ? 2 : 1;
  size_t smem = sizeof(E) * static_cast<size_t>(DS) * (BR + stages * 2 * BK);
  if (a.wk > 1) {
    const size_t merge = sizeof(float) * (4 * (16 * DMAX + 32) + 64);
    smem = smem > merge ? smem : merge;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid((R + BR - 1) / BR, a.Hkv, B);
  flash_attention_kernel<E, DMAX><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch_d(const Args& a, int B, cudaStream_t stream) {
  if (a.D <= 64) return launch<E, 64>(a, B, stream);
  if (a.D <= 128) return launch<E, 128>(a, B, stream);
  return launch<E, 256>(a, B, stream);
}

}  // namespace

// dtype: 0 = f32, 2 = bf16 (q, k, v and o alike); o is contiguous
// (B, S, Hq, D); the strides are in elements, each a multiple of 16 bytes,
// and the pointers 16-byte aligned; D a multiple of 8 up to 256; scale =
// D^-0.5 rounded to f32 by the caller, as the reference multiplies by it.
// Returns a cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int dtype, int B, int S, int T,
                               int Hq, int Hkv, int D, int causal, float scale,
                               long long q_sb, long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss, long long k_sh,
                               long long v_sb, long long v_ss, long long v_sh,
                               void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || T <= 0 || Hkv <= 0 || Hkv > 65535 ||
      Hq <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 || D % 8 != 0 ||
      static_cast<long long>(Hq / Hkv) * S > (1LL << 30))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, o, S, T, Hq, Hkv, D, causal, scale,
               Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
               Strides{v_sb, v_ss, v_sh}, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(a, B, s);
  if (dtype == 2) return dispatch_d<__nv_bfloat16>(a, B, s);
  return cudaErrorInvalidValue;
}
