// The tensor-core scan shared by the two search kernels, mips_topk.cu (B1,
// TF32) and mips_topk_int8.cu (B2, s8): store rows are the MMA's M, queries
// its N, and each block computes one store tile for one block of queries.
//
// Block: kWarps warps; a pass covers kBM = kWarps * kMT * 16 store rows of
// the tile (warp w the rows w * kMT * 16 ..), every query of the block in
// NQ n8 tiles, accumulated in registers. The depth is walked in chunks of
// 64 bytes of a store row (32 fp16/bf16, 16 f32 or 64 int8 values); each
// chunk of the pass's rows, with the block's queries over the same depth,
// is one stage of a kStages-deep ring in shared memory filled by cp.async,
// so the next chunks load while the current one is in the MMAs. The ring
// runs on across passes, with one barrier per chunk. Each 16-byte copy asks
// L2 to fetch the whole 128-byte line (.L2::128B): a stage reads 64 bytes
// from each of 256 rows, and the row's next chunk then comes from L2
// (PERF.md, PR 9). A store row's 64 bytes of a stage
// are four 16-byte pieces stored at piece ^ ((row >> 1) & 3), which keeps
// both the cp.async writes and the ldmatrix reads free of bank conflicts;
// ldmatrix.x4 of 16 rows x 32 bytes gives every lane its A fragment in the
// store's own layout (see the policies). Rows past N or past the tile and
// depth past D are zero-filled by the copies (src-size below 16), so the
// wrapper pads and copies nothing; rows whose bytes or address are not a
// multiple of 16 are copied in 8- or 4-byte pieces or byte by byte, by an
// instance of their own (W = false).
//
// After a pass each warp scores its rows: with k = 1 every thread keeps the
// best (value, row) of its accumulator entries per query in registers, and
// the block reduces them through shuffles and a 1 KB table at the end; with
// k > 1 the scores go to a [QB][tile_n] table in shared memory and one warp
// per query runs tile_topk.cuh's selection. Both keep the strict order
// (value desc, index asc), so rows >= N (score -1e30) are still taken in
// index order when a tile holds fewer than k real rows.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_topk.cuh"

namespace storinfer {
namespace mips {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 4;                    // m16 tiles of a warp
constexpr int kBM = kWarps * kMT * 16;    // store rows of a pass
constexpr int kChunk = 64;                // bytes of a store row per stage
constexpr int kPieces = kChunk / 16;      // 16-byte pieces of a stage row
constexpr int kStages = 3;
constexpr int kMinBlocks = 3;             // per SM: a 293-tile grid in a wave
constexpr int kMaxSmem = 227 * 1024;

struct Params {
  const void* q;
  const float* q_scale;  // B2 only
  const void* x;
  const float* x_scale;  // B2 only
  int Q, D, N, k, tile_n;
  int x_gran, q_gran;  // cp.async size that divides the row bytes and the
                       // base address: 16, 8, 4, or 0 for plain loads
  float* out_v;
  int* out_i;
};

// ---- copies ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
template <int SZ>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int nbytes) {
  if constexpr (SZ == 16)
    asm volatile(
        "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(
            smem_u32(dst)),
        "l"(src), "r"(nbytes)
        : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(SZ), "r"(nbytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// copy16 for rows whose bytes or base address are not a multiple of 16:
// pieces of `gran` bytes, or plain byte loads
__device__ __forceinline__ void copy16_narrow(void* dst, const char* src,
                                           int nbytes, int gran,
                                           const void* base) {
  if (gran == 8) {
#pragma unroll
    for (int p = 0; p < 16; p += 8) {
      const int n = max(0, min(8, nbytes - p));
      cp_async<8>(static_cast<char*>(dst) + p, n ? src + p : base, n);
    }
  } else if (gran == 4) {
#pragma unroll
    for (int p = 0; p < 16; p += 4) {
      const int n = max(0, min(4, nbytes - p));
      cp_async<4>(static_cast<char*>(dst) + p, n ? src + p : base, n);
    }
  } else {  // rows of an odd number of 16-bit words: plain byte loads
    const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * i + b < nbytes)
          w[i] |= static_cast<uint32_t>(__ldg(s + 4 * i + b)) << (8 * b);
    }
    *static_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// 16 bytes of a row at src (nbytes of them real, the rest zeros) into dst,
// in pieces of `gran` bytes; base is a valid address for an empty piece.
// W: every row is known to take 16-byte pieces, and the narrow path is not
// compiled in (in the same instance it costs the common case time even
// when not taken: the unrolled copy loops grow too large for the
// instruction cache)
template <bool W>
__device__ __forceinline__ void copy16(void* dst, const char* src,
                                       int nbytes, int gran,
                                       const void* base) {
  if (W || gran == 16)
    cp_async<16>(dst, nbytes ? src : base, nbytes);
  else
    copy16_narrow(dst, src, nbytes, gran, base);
}

// where 16-byte piece c of stage row r lies: c ^ ((r >> 1) & 3), so that
// the 8 rows an ldmatrix phase reads, and the pieces a cp.async phase
// writes, fall in distinct banks
static_assert(kPieces == 4, "the swizzle is for 64-byte stage rows");
__device__ __forceinline__ int swz(int r, int c) {
  return c ^ ((r >> 1) & 3);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// ---- the kernel ------------------------------------------------------------

// P, the policy of one store type, gives:
//   Acc                     accumulator type (float or int)
//   kXBytes, kQBytes        bytes of one store / query value
//   kQChunk                 bytes of a query row per stage
//   kQStride                32-bit words between query rows in a stage
//   compute<NQ>(acc, xs, qs, lane, nmt)
//                           the stage's MMAs for the warp's first nmt m16
//                           tiles; xs the warp's first row of the stage,
//                           qs the stage's queries
//   row_scale(row, p)       what score() needs of store row `row` (< N)
//   query_scale(q, p)       ... and of query q
//   score(acc, rs, qs)      the f32 score of one accumulator entry of that
//                           row and query
template <typename P, int NQ>
struct Layout {
  static constexpr int QB = 8 * NQ;
  static constexpr int kStageX = kBM * kChunk;
  static constexpr int kStageBytes = kStageX + QB * P::kQStride * 4;
  static size_t smem(int k, int tile_n) {
    return static_cast<size_t>(kStages) * kStageBytes +
           kWarps * QB * 8 +  // the k = 1 table
           (k > 1 ? sizeof(float) * QB * static_cast<size_t>(tile_n) : 0);
  }
};

// One thread's share of every stage's copies, fixed for the block: piece c
// of store rows r0, r0 + kRowStep, ... of a pass, and piece cq of query
// rows j0, j0 + kQRowStep, ...; a stage then costs a pointer step and a
// compare per copy
template <typename P, int NQ, bool W>
struct Copier {
  static constexpr int QB = 8 * NQ;
  static constexpr int kRowStep = kThreads / kPieces;
  static constexpr int kXCopies = kBM / kRowStep;
  static constexpr int kQPieces = P::kQChunk / 16;
  static constexpr int kQRowStep = kThreads / kQPieces;
  static constexpr int kQCopies = (QB + kQRowStep - 1) / kQRowStep;
  const char* x;     // piece c of row r0 of the tile
  const char* q;     // piece cq of query row q0 + j0
  int64_t xrb;       // bytes of a store row
  int qrb;           // bytes of a query row
  int r0, c, j0, cq;
  int lim;           // rows of the tile that exist
  int nq;            // queries of the block
  int xdst, qdst;    // this thread's first piece in a stage

  __device__ __forceinline__ Copier(const Params& p, int64_t tile_row0,
                                    int q0, int nq_) {
    r0 = threadIdx.x / kPieces;
    c = threadIdx.x % kPieces;
    j0 = threadIdx.x / kQPieces;
    cq = threadIdx.x % kQPieces;
    xrb = static_cast<int64_t>(p.D) * P::kXBytes;
    qrb = p.D * P::kQBytes;
    x = static_cast<const char*>(p.x) + (tile_row0 + r0) * xrb + c * 16;
    q = static_cast<const char*>(p.q) +
        static_cast<int64_t>(q0 + j0) * qrb + cq * 16;
    const int64_t left = p.N - tile_row0;
    lim = left < p.tile_n ? static_cast<int>(left) : p.tile_n;
    nq = nq_;
    xdst = r0 * kChunk + (swz(r0, c) << 4);  // kRowStep: a multiple of 8
    qdst = Layout<P, NQ>::kStageX + j0 * P::kQStride * 4 + cq * 16;
  }

  // depth chunk ch of pass `pass` into the stage at buf
  __device__ __forceinline__ void issue(const Params& p, char* buf, int pass,
                                        int ch) const {
    const int off = ch * kChunk + c * 16;
    const int64_t left = xrb - off;  // bytes of the row from this piece on
    const int nb = left >= 16 ? 16 : left > 0 ? static_cast<int>(left) : 0;
    const char* src = x + pass * kBM * xrb + ch * kChunk;
    const int row = pass * kBM + r0;
#pragma unroll
    for (int k = 0; k < kXCopies; ++k)
      copy16<W>(buf + xdst + k * kRowStep * kChunk, src + k * kRowStep * xrb,
             row + k * kRowStep < lim ? nb : 0, p.x_gran, p.x);
    const int qoff = ch * P::kQChunk + cq * 16;
    const int qnb = max(0, min(16, qrb - qoff));
#pragma unroll
    for (int k = 0; k < kQCopies; ++k) {
      const int j = j0 + k * kQRowStep;
      if (j < QB)
        copy16<W>(buf + qdst + k * kQRowStep * P::kQStride * 4,
               q + static_cast<int64_t>(k * kQRowStep) * qrb + ch * P::kQChunk,
               j < nq ? qnb : 0, p.q_gran, p.q);
    }
    cp_async_commit();
  }
};

template <typename P, int NQ, bool W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mips_tc_kernel(Params p) {
  using L = Layout<P, NQ>;
  using Acc = typename P::Acc;
  constexpr int QB = L::QB;
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);
  float* red_v = reinterpret_cast<float*>(ring + kStages * L::kStageBytes);
  int* red_i = reinterpret_cast<int*>(red_v + kWarps * QB);
  float* sc = reinterpret_cast<float*>(red_i + kWarps * QB);  // k > 1

  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int lg = lane >> 2, lt = lane & 3;
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * QB, nq = min(QB, p.Q - q0);
  const int64_t tile_row0 = static_cast<int64_t>(tile) * p.tile_n;
  const int nch = (p.D * P::kXBytes + kChunk - 1) / kChunk;
  const int passes = (p.tile_n + kBM - 1) / kBM;
  const int total = passes * nch;
  const bool top1 = p.k == 1;
  const Copier<P, NQ, W> cp(p, tile_row0, q0, nq);

  // what score() needs of this thread's queries j * 8 + 2 lt + c
  float qsc[NQ][2];
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      qsc[j][c] = P::query_scale(q0 + min(j * 8 + 2 * lt + c, nq - 1), p);

  // k = 1: the best (value, tile-local row) per accumulator column
  float bv[NQ][2];
  int bi[NQ][2];
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      bv[j][c] = -INFINITY;
      bi[j][c] = 0x7fffffff;
    }

  Acc acc[kMT][NQ][4];
  float rs[kMT][2];        // row_scale() of the thread's rows of the pass
  int ipass = 0, ich = 0;  // the next stage to issue
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) {
      cp.issue(p, ring + s * L::kStageBytes, ipass, ich);
      if (++ich == nch) {
        ich = 0;
        ++ipass;
      }
    } else {
      cp_async_commit();
    }
  }
  int pass = 0, ch = -1;
  for (int it = 0; it < total; ++it) {
    if (++ch == nch) {
      ch = 0;
      ++pass;
    }
    // the warp's rows of this pass start at wrow0
    const int wrow0 = pass * kBM + w * kMT * 16;
    if (ch == 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = Acc(0);
        // this thread's rows' share of the scores, read while the pass runs
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = tile_row0 + wrow0 + mt * 16 + lg + 8 * h;
          rs[mt][h] = row < p.N ? P::row_scale(row, p) : 0.f;
        }
      }
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage it landed for all; stage it - 1 consumed
    const int nx = it + kStages - 1;
    if (nx < total) {
      cp.issue(p, ring + (nx % kStages) * L::kStageBytes, ipass, ich);
      if (++ich == nch) {
        ich = 0;
        ++ipass;
      }
    } else {
      cp_async_commit();
    }

    // the warp's m16 tiles inside the tile
    const int nmt = max(0, min(kMT, (p.tile_n - wrow0 + 15) / 16));
    const char* st = ring + (it % kStages) * L::kStageBytes;
    if (nmt > 0)
      P::template compute<NQ>(acc, st + w * kMT * 16 * kChunk,
                              reinterpret_cast<const uint32_t*>(st +
                                                                L::kStageX),
                              lane, nmt);
    if (ch != nch - 1) continue;

    // ---- the pass's scores: accumulator entry e of (mt, j) is row
    // wrow0 + mt * 16 + lg + 8 (e >> 1), query j * 8 + 2 lt + (e & 1)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int local = wrow0 + mt * 16 + lg + 8 * h;
        if (local >= p.tile_n) continue;
        const int64_t row = tile_row0 + local;
        const bool real = row < p.N;
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qi = j * 8 + 2 * lt + c;
            const float s =
                real ? P::score(acc[mt][j][2 * h + c], rs[mt][h], qsc[j][c])
                     : kNeg;
            if (top1) {
              if (better(s, local, bv[j][c], bi[j][c])) {
                bv[j][c] = s;
                bi[j][c] = local;
              }
            } else if (qi < nq) {
              sc[qi * p.tile_n + local] = s;
            }
          }
      }
    }
  }
  cp_async_wait<0>();

  if (top1) {
    // over the 8 lanes that share lt, then over the warps
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv[j][c], off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi[j][c], off);
          if (better(ov, oi, bv[j][c], bi[j][c])) {
            bv[j][c] = ov;
            bi[j][c] = oi;
          }
        }
    if (lg == 0) {
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = j * 8 + 2 * lt + c;
          red_v[w * QB + qi] = bv[j][c];
          red_i[w * QB + qi] = bi[j][c];
        }
    }
    __syncthreads();
    if (threadIdx.x < nq) {
      float v = red_v[threadIdx.x];
      int i = red_i[threadIdx.x];
#pragma unroll
      for (int x = 1; x < kWarps; ++x) {
        const float ov = red_v[x * QB + threadIdx.x];
        const int oi = red_i[x * QB + threadIdx.x];
        if (better(ov, oi, v, i)) {
          v = ov;
          i = oi;
        }
      }
      const int64_t o = static_cast<int64_t>(tile) * p.Q + q0 + threadIdx.x;
      p.out_v[o] = v;
      p.out_i[o] = static_cast<int>(tile_row0) + i;
    }
    return;
  }
  __syncthreads();
  // a warp takes queries j and j + kWarps at once
  for (int j = w; j < nq; j += 2 * kWarps) {
    const int64_t o = (static_cast<int64_t>(tile) * p.Q + q0 + j) * p.k;
    const int j2 = j + kWarps;
    if (j2 < nq) {
      const int64_t o2 = o + static_cast<int64_t>(kWarps) * p.k;
      float* const rows[2] = {sc + j * p.tile_n, sc + j2 * p.tile_n};
      float* const ov[2] = {p.out_v + o, p.out_v + o2};
      int* const oi[2] = {p.out_i + o, p.out_i + o2};
      warp_tile_topk<2>(rows, p.tile_n, p.k, static_cast<int>(tile_row0), ov,
                        oi);
    } else {
      float* const rows[1] = {sc + j * p.tile_n};
      float* const ov[1] = {p.out_v + o};
      int* const oi[1] = {p.out_i + o};
      warp_tile_topk<1>(rows, p.tile_n, p.k, static_cast<int>(tile_row0), ov,
                        oi);
    }
  }
}

// the instance of NQ n8 tiles for the block's queries
template <typename P, int NQ, bool W>
struct Instance {
  static cudaError_t attr() {
    static const cudaError_t e = cudaFuncSetAttribute(
        mips_tc_kernel<P, NQ, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    return e;
  }
  static cudaError_t launch(const Params& p, cudaStream_t stream) {
    const cudaError_t e = attr();
    if (e != cudaSuccess) return e;
    const size_t smem = Layout<P, NQ>::smem(p.k, p.tile_n);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    const dim3 grid((p.N + p.tile_n - 1) / p.tile_n,
                    (p.Q + Layout<P, NQ>::QB - 1) / Layout<P, NQ>::QB);
    mips_tc_kernel<P, NQ, W><<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
  // out: [grid x, grid y, threads, blocks per SM, registers, local bytes
  // per thread (spills), dynamic shared memory per block]
  static cudaError_t config(const Params& p, int* out) {
    cudaError_t e = attr();
    if (e != cudaSuccess) return e;
    const size_t smem = Layout<P, NQ>::smem(p.k, p.tile_n);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, mips_tc_kernel<P, NQ, W>);
    if (e != cudaSuccess) return e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mips_tc_kernel<P, NQ, W>, kThreads, smem);
    if (e != cudaSuccess) return e;
    out[0] = (p.N + p.tile_n - 1) / p.tile_n;
    out[1] = (p.Q + Layout<P, NQ>::QB - 1) / Layout<P, NQ>::QB;
    out[2] = kThreads;
    out[3] = per_sm;
    out[4] = fa.numRegs;
    out[5] = static_cast<int>(fa.localSizeBytes);
    out[6] = static_cast<int>(smem);
    return cudaSuccess;
  }
};

// launch (out == nullptr) or report the configuration of the instance
template <typename P, int NQ, bool W>
cudaError_t run_instance(const Params& p, int* out, cudaStream_t stream) {
  return out ? Instance<P, NQ, W>::config(p, out)
             : Instance<P, NQ, W>::launch(p, stream);
}
template <typename P, int NQ>
cudaError_t run_nq(const Params& p, int* out, cudaStream_t stream) {
  return p.x_gran == 16 && p.q_gran == 16
             ? run_instance<P, NQ, true>(p, out, stream)
             : run_instance<P, NQ, false>(p, out, stream);
}
// ... for Q queries: 8, 16 or 32 per block
template <typename P>
cudaError_t run(const Params& p, int* out, cudaStream_t stream) {
  if (p.Q <= 0 || p.N <= 0 || p.D <= 0 || p.k < 1 || p.k > p.tile_n ||
      static_cast<int64_t>(p.N) + p.tile_n > 0x7fffffffLL ||
      (p.Q + 31) / 32 > 65535)
    return cudaErrorInvalidValue;
  if (p.Q <= 8) return run_nq<P, 1>(p, out, stream);
  if (p.Q <= 16) return run_nq<P, 2>(p, out, stream);
  return run_nq<P, 4>(p, out, stream);
}

}  // namespace mips
}  // namespace storinfer
