// The attention forward main loop for Hopper (sm_90a), shared by the flash
// forward (flash_attention.cu) and the ring step (ring_attention.cu).  Its
// PTX wrappers, load ring (Ring, produce, consume, release, load_rows,
// produce_kv), tensor maps and launcher also serve the backward
// (attn_bwd_sm90.cuh).
//
// One block of three warpgroups per (128-row q tile, q head, batch):
// - a producer warpgroup (registers cut to 24 with setmaxnreg) whose first
//   thread issues TMA loads: the q tile once, then the K/V tiles of 128
//   keys into a ring of 2 stages, each stage guarded by a "full" mbarrier
//   (arrives by TMA transaction bytes) and an "empty" one (one arrival per
//   consumer warp);
// - two consumer warpgroups (registers raised to 240) of 64 q rows each.
//   S = Q K^T runs as wgmma m64n128k16 with both operands in shared memory
//   and S in registers; the online softmax runs on the accumulator
//   fragment (each thread holds two rows; max over the thread quad by
//   shuffles; exp2 with scale * log2(e) folded in); P is rounded to bf16 in
//   registers and O += P V runs as wgmma with A = P from registers and B =
//   V (MN-major, the descriptor's transpose bit); O stays an f32
//   accumulator in registers for the whole loop.
//
// Global memory is read through 4-D tensor maps over the model's own
// layout [B, S, H, D] (dims D, H, S, B; boxes of 64 columns x 1 head x
// rows x 1 batch), 128-byte swizzled, so rows past a batch's S read as
// zeros and no transposes are needed.  A tile of D = 128 lands as two
// 64-column panels of rows x 128 bytes; the wgmma descriptors read those
// panels as TMA wrote them (K-major Q and K: 1024-byte stride between
// 8-row groups, k-steps of 32 bytes inside a swizzled row; MN-major V:
// 1024 bytes between 8-key groups, one panel (BK x 128 bytes) between
// 64-column halves).
//
// Masking: key j is visible to query row i when j < Skv and, with
// `causal`, j <= i + off (flash: off = Skv - Sq, bottom-right; ring: off =
// q_off - k_off, global positions).  The loop stops at the last tile the
// q tile's last row sees, so tiles that see nothing are never loaded; a
// warpgroup skips the tiles its own 64 rows cannot see; only tiles that
// the diagonal or the ragged edge cuts pay the per-element test.
//
// The caller supplies the prologue and epilogue (Epi::init, Epi::finish)
// on the register fragment: the flash forward starts empty and writes out
// and lse; the ring step reads and writes its f32 state.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace fwd90 {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;            // q rows a block: two warpgroups of 64
constexpr int BK = 128;            // keys a K/V tile
constexpr int STAGES = 2;          // K/V tiles in flight
constexpr int NT = 384;            // 2 consumer + 1 producer warpgroups
constexpr int CONSUMER_WARPS = 8;  // arrivals on an "empty" barrier
constexpr int ROW = 128;           // bytes of a swizzled box row (64 bf16)
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D> struct Smem {
  static constexpr int Q = BQ * D * 2;          // bytes of the q tile
  static constexpr int KV = BK * D * 2;         // bytes of a K or V tile
  static constexpr int BYTES = Q + 2 * STAGES * KV + 1024;  // + alignment
};

// The problem as the loop sees it; see the masking note above.
struct Tile {
  int Sq, Skv, Hq, Hkv, causal, off;
  float scale;
};

// K/V tiles of KT keys the q tile at q0 reads: up to the last key its
// last row sees.
template <int KT = BK>
__device__ __forceinline__ int kv_tiles(const Tile& t, int q0) {
  const int last_row = (q0 + BQ < t.Sq ? q0 + BQ : t.Sq) - 1;
  int end = t.Skv;
  if (t.causal) {
    const long long e = (long long)last_row + t.off + 1;
    end = e < end ? (int)(e < 0 ? 0 : e) : end;
  }
  return (end + KT - 1) / KT;
}

// ---------------------------------------------------------------- PTX --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset `lbo`, 1024 bytes between 8-row groups.  Adding n >> 4 moves
// the start by n bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving register reads or writes of an
// accumulator across the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FWD90_R8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FWD90_R32(i) \
  FWD90_R8(i), FWD90_R8(i + 8), FWD90_R8(i + 16), FWD90_R8(i + 24)

#define FWD90_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define FWD90_D64                                                          \
  FWD90_D32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "    \
            "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "  \
            "%55, %56, %57, %58, %59, %60, %61, %62, %63"

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128]: A and B from shared memory,
// both K-major; `accumulate` 0 overwrites d.
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FWD90_D64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FWD90_R32(0), FWD90_R32(32)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64]: as mma_ss_n128, 64 columns.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FWD90_D32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FWD90_R32(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x N] += A[64 x 16] . B[16 x N]: A from registers (four bf16 pairs
// a thread), B from shared memory, MN-major (transpose bit set).
__device__ __forceinline__ void mma_rs_t(float (&d)[64], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FWD90_D64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FWD90_R32(0), FWD90_R32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_rs_t(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FWD90_D32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FWD90_R32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef FWD90_R8
#undef FWD90_R32
#undef FWD90_D32
#undef FWD90_D64

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ----------------------------------------------------------- the ring --

// The barriers of a block's loads: `once` for the tiles loaded once, and a
// "full" and an "empty" barrier for each stage of the ring (8 bytes apart).
struct Ring {
  uint32_t once, full, empty;
};

// Thread 0 initialises the 1 + 2 * STAGES barriers at `bars`: `once` and
// each "full" complete on `full_count` arrivals and their transaction
// bytes, each "empty" on one arrival per consumer warp.  The caller syncs
// the block before any use.
__device__ __forceinline__ Ring ring_init(uint64_t* bars,
                                          uint32_t full_count) {
  const Ring r{smem_u32(&bars[0]), smem_u32(&bars[1]),
               smem_u32(&bars[1 + STAGES])};
  if (threadIdx.x == 0) {
    mbar_init(r.once, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(r.full + 8 * s, full_count);
      mbar_init(r.empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  return r;
}

// Producer side: for each of `n` tiles, waits until its stage is free, then
// calls fill(tile, stage, the stage's "full" barrier).
template <class Fill>
__device__ __forceinline__ void produce(const Ring& r, int n, Fill&& fill) {
  for (int it = 0; it < n; ++it) {
    const int s = it % STAGES;
    mbar_wait(r.empty + 8 * s, ((it / STAGES) & 1) ^ 1);
    fill(it, s, r.full + 8 * s);
  }
}

// Consumer side: waits until tile `it` has landed; returns its stage.
__device__ __forceinline__ int consume(const Ring& r, int it) {
  const int s = it % STAGES;
  mbar_wait(r.full + 8 * s, (it / STAGES) & 1);
  return s;
}

// Consumer side: this warp is done with tile `it`'s stage.
__device__ __forceinline__ void release(const Ring& r, int it) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(r.empty + 8 * (it % STAGES));
}

// Rows [r0, r0 + ROWS) of head h, batch b of a [B, S, H, D] map into `dst`
// as D / 64 panels of ROWS x 128 bytes, completing on `bar`.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap& map,
                                          uint32_t bar, int r0, int h,
                                          int b) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    tma_load(dst + p * ROWS * ROW, map, bar, 64 * p, h, r0, b);
}

// The K/V stream: `n` tiles of KT keys of kv head hk from key 0, K into
// sk and V into sv, one tile a stage.
template <int D, int KT>
__device__ __forceinline__ void produce_kv(const Ring& r,
                                           const CUtensorMap& kmap,
                                           const CUtensorMap& vmap,
                                           uint32_t sk, uint32_t sv, int hk,
                                           int b, int n) {
  constexpr int BYTES = KT * D * 2;
  produce(r, n, [&](int it, int s, uint32_t full) {
    mbar_expect_tx(full, 2 * BYTES);
    load_rows<D, KT>(sk + s * BYTES, kmap, full, it * KT, hk, b);
    load_rows<D, KT>(sv + s * BYTES, vmap, full, it * KT, hk, b);
  });
}

// ---------------------------------------------------------- the block --

// Where a consumer thread's accumulator elements sit: o[4j + e] (e = 0, 1)
// is row rows[0], column 8j + 2c + e; o[4j + 2 + e] is row rows[1], the
// same column.  Rows are absolute q rows (they may lie past Sq).
struct Frag {
  int rows[2];
  int c;
};

// The whole block: barriers, the producer, the consumers' loop.  `Epi`
// gives init(o, m, l, frag) (the state before the first tile: m and l per
// row in natural-log units, l as this thread's share of the quad's sum)
// and finish(o, m, l, frag) (l summed over the quad).
template <int D, class Epi>
__device__ __forceinline__ void fwd_block(const CUtensorMap& qmap,
                                          const CUtensorMap& kmap,
                                          const CUtensorMap& vmap,
                                          const Tile& t, int q0, int h, int b,
                                          int n_tiles, Epi& epi) {
  extern __shared__ uint8_t fwd90_smem[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  const uint32_t sq = (smem_u32(fwd90_smem) + 1023) & ~1023u;
  const uint32_t sk = sq + Smem<D>::Q;
  const uint32_t sv = sk + STAGES * Smem<D>::KV;
  const Ring ring = ring_init(bars, 1);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256 && n_tiles > 0) {
      mbar_expect_tx(ring.once, Smem<D>::Q);
      load_rows<D, BQ>(sq, qmap, ring.once, q0, h, b);
      produce_kv<D, BK>(ring, kmap, vmap, sk, sv, h / (t.Hq / t.Hkv), b,
                        n_tiles);
    }
  } else {
    // ---- consumers: 64 q rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    Frag f;
    f.rows[0] = q0 + 64 * wg + 16 * warp + lane / 4;
    f.rows[1] = f.rows[0] + 8;
    f.c = lane % 4;
    const int wg_first = q0 + 64 * wg;
    const int wg_last = min(wg_first + 63, t.Sq - 1);
    const float sl2 = t.scale * LOG2E;

    float o[D / 2], m[2], l[2];
    epi.init(o, m, l, f);

    const uint64_t dq = desc(sq + 64 * wg * ROW, 16);
    if (n_tiles > 0) mbar_wait(ring.once, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = consume(ring, it), kv0 = it * BK;
      if (wg_last >= wg_first && (!t.causal || kv0 <= wg_last + t.off)) {
        // S = Q K^T
        float sc[64];
        const uint64_t dk = desc(sk + s * Smem<D>::KV, 16);
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t qoff = (kk / 4) * BQ * ROW + (kk % 4) * 32;
          const uint32_t koff = (kk / 4) * BK * ROW + (kk % 4) * 32;
          mma_ss_n128(sc, dq + (qoff >> 4), dk + (koff >> 4), kk > 0);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);

        // Mask the tiles the diagonal or the ragged edge cuts.
        if (kv0 + BK > t.Skv || (t.causal && kv0 + BK - 1 > wg_first + t.off)) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = kv0 + 8 * j + 2 * f.c + (e & 1);
              const int row = f.rows[e >> 1];
              if (!(col < t.Skv && (!t.causal || col <= row + t.off)))
                sc[4 * j + e] = -INFINITY;
            }
        }

        // Online softmax on the fragment; P rounded to bf16 against the
        // running max.
        float corr[2], msc[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
          mx = quad_max(mx);
          const float m_new = fmaxf(m[r], mx * t.scale);
          corr[r] = exp2f((m[r] - m_new) * LOG2E);
          msc[r] = m_new * LOG2E;
          m[r] = m_new;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = (i >> 1) & 1;
          sc[i] = exp2f(fmaf(sc[i], sl2, -msc[r]));
          sum[r] += sc[i];
        }
        l[0] = l[0] * corr[0] + sum[0];
        l[1] = l[1] * corr[1] + sum[1];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);

        // O += P V
        const uint64_t dv = desc(sv + s * Smem<D>::KV, BK * ROW);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          mma_rs_t(o, pa[kk], dv + ((kk * 16 * ROW) >> 4));
        wgmma_commit();
        wgmma_wait();
        fence_regs(o);
      }
      release(ring, it);
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    epi.finish(o, m, l, f);
  }
}

// ------------------------------------------------------------- host --

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime at first
// use, so the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// A [B, S, H, D] bf16 tensor as a 4-D map (dims D, H, S, B), boxes of 64
// columns x 1 head x `rows` rows x 1 batch, 128-byte swizzle; reads past
// a batch's S give zeros.
inline bool bshd_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                     int D, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor maps of q [B, Sq, Hq, D] and k, v [B, Skv, Hkv, D].
struct Maps {
  CUtensorMap q, k, v;
};

inline bool make_maps(Maps* maps, const void* q, const void* k, const void* v,
                      int B, int Sq, int Skv, int Hq, int Hkv, int D) {
  return bshd_map(&maps->q, q, B, Sq, Hq, D, BQ) &&
         bshd_map(&maps->k, k, B, Skv, Hkv, D, BK) &&
         bshd_map(&maps->v, v, B, Skv, Hkv, D, BK);
}

// Grid: (q head, batch, q tile), the q tiles last-first so that the
// causal tiles with the most keys start in the first wave.
inline dim3 grid(int B, int Sq, int Hq) {
  return dim3(Hq, B, (Sq + BQ - 1) / BQ);
}

__device__ __forceinline__ int block_q0() {
  return (gridDim.z - 1 - blockIdx.z) * BQ;
}

// Sets the kernel's dynamic shared memory to `bytes`, launches NT threads
// a block and returns cudaGetLastError().
template <typename... P, typename... A>
int launch(void (*kernel)(P...), dim3 g, int bytes, void* stream,
           A... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<g, NT, bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

// The shared memory a block of `kernel` takes, as the runtime holds it:
// static plus the dynamic size launch() set (none before its first launch);
// -1 if the runtime refuses.
template <typename K>
int smem_bytes(K kernel) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, kernel) != cudaSuccess) return -1;
  return (int)a.sharedSizeBytes + a.maxDynamicSharedSizeBytes;
}

}  // namespace fwd90
