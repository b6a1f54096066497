// The attention forward main loop for Hopper (sm_90a), shared by the flash
// forward (flash_attention.cu: q tiles over one K/V block) and the ring
// forward (ring_attention.cu: q tiles over several K/V blocks, one a ring
// rank), both on a persistent grid of one block an SM that walks its
// schedule's q tiles.  Its PTX wrappers, load ring (Ring, produce, consume,
// release, load_rows, produce_kv), tensor maps and launcher also serve the
// backward (attn_bwd_sm90.cuh).
//
// A block is three warpgroups:
// - a producer warpgroup (registers cut to 40 with setmaxnreg: the ring's
//   persistent schedule spills at 24) whose first
//   thread issues TMA loads: for each q tile of the block's schedule the q
//   tile (once its buffer is free), then the tile's K/V blocks in order,
//   each in tiles of 128 keys through a ring of KV_STAGES stages, each
//   stage guarded by a "full" mbarrier (arrives by TMA transaction bytes)
//   and an "empty" one (one arrival per consumer warp).  Before a block's
//   first load it may wait for the block's arrival word (the ring);
// - two consumer warpgroups (registers raised to 232; 40 + 2 x 232 = 3 x
//   168, the launch's) of 64 q rows each.
//   S = Q K^T runs as wgmma m64n128k16 with both operands in shared memory
//   and S in registers; the online softmax runs on the accumulator
//   fragment (each thread holds two rows; max over the thread quad by
//   shuffles; exp2 with scale * log2(e) folded in); P is rounded to bf16 in
//   registers and O += P V runs as wgmma with A = P from registers and B =
//   V (MN-major, the descriptor's transpose bit); O stays an f32
//   accumulator in registers for the whole q tile, across K/V blocks.  At
//   the q tile's end the output goes through the last V tile's shared
//   memory (free once both warpgroups' last P V has read it) and a TMA
//   store, before that stage is released.
//
// Overlap (the products against the exp2 work):
// - inside a warpgroup, a round issues tile it's S = Q K^T and then tile
//   it-1's O += P V as two commit groups, waits for the first only
//   (wgmma_wait_n<1>) and runs tile it's softmax while P V is in flight; P
//   of it-1 stays pinned in its registers (fence_a) until that group is
//   waited for, and only then is tile it's P packed over it.  O is scaled
//   by a tile's correction right before that tile's P V is issued, so O
//   sees the same operations in the same order as a serial loop
//   (O *= corr_i; O += P_i V_i for each tile): the bits do not change;
// - across the two warpgroups, named barriers (ids 1 and 2, 256 threads)
//   take turns issuing: a warpgroup issues its round's products only after
//   the other has issued its own, so one warpgroup's exp2 work runs while
//   the other's products hold the tensor cores.  Warpgroup 1 arrives on
//   warpgroup 0's barrier once before a q tile's first round and skips its
//   arrival after the tile's last, so every barrier phase is matched
//   within the tile;
// - the release of a K/V stage waits for its P V, so the ring has 3 stages
//   (Q 32 KB + 3 x 64 KB at D 128: 230,400 bytes with alignment, under the
//   232,448 a block may hold) and the producer stays two tiles ahead.
//
// Global memory is read through 5-D tensor maps over [source, B, S, H, D]
// (dims D, H, S, B, source; boxes of 64 columns x 1 head x rows x 1 batch x
// 1 source; TMA's most dims), 128-byte swizzled, so rows past a batch's S
// read as zeros and no transposes are needed; the flash forward has one
// source, the ring's K/V one per rank and its q one per held rank.  A tile
// of D = 128 lands as two 64-column panels of rows x 128 bytes; the wgmma
// descriptors read those panels as TMA wrote them (K-major Q and K:
// 1024-byte stride between 8-row groups, k-steps of 32 bytes inside a
// swizzled row; MN-major V: 1024 bytes between 8-key groups, one panel (BK
// x 128 bytes) between 64-column halves).
//
// Masking: key j of a block is visible to query row i when j < Skv and,
// with `causal`, j <= i + off (flash: off = Skv - Sq, bottom-right; ring:
// off = q_off - k_off of the block, global positions).  A block's loop
// stops at the last tile the q tile's last row sees, so tiles that see
// nothing are never loaded; only tiles that the diagonal or the ragged
// edge cuts pay the per-element test.  Both warpgroups run every loaded
// tile (a tile one warpgroup's rows cannot see is masked whole and leaves
// its O, m and l as they were), so that no wgmma sits on a branch: ptxas
// serialises every wgmma of a kernel that has one there (C7518).
//
// The schedule (Sched) names a block's q tiles and each one's K/V blocks;
// every q tile starts from the empty state and ends by writing out = O / l
// (l == 0 -> 1) in bf16 and lse = m + log l.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tile.cuh"

namespace fwd90 {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;            // q rows a block: two warpgroups of 64
constexpr int BK = 128;            // keys a K/V tile
constexpr int STAGES = 2;          // the backward's tiles in flight
constexpr int KV_STAGES = 3;       // the forward's K/V tiles in flight
constexpr int NT = 384;            // 2 consumer + 1 producer warpgroups
constexpr int CONSUMER_WARPS = 8;  // arrivals on an "empty" barrier
constexpr int ROW = 128;           // bytes of a swizzled box row (64 bf16)
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D> struct Smem {
  static constexpr int Q = BQ * D * 2;          // bytes of the q tile
  static constexpr int KV = BK * D * 2;         // bytes of a K or V tile
  static constexpr int BYTES = Q + 2 * KV_STAGES * KV + 1024;  // + alignment
};

// The problem as the loop sees it; see the masking note above.
struct Tile {
  int Sq, Skv, Hq, Hkv, causal, off;
  float scale;
};

// K/V tiles of KT keys the q tile at q0 reads from a block at offset off:
// up to the last key its last row sees.
template <int KT = BK>
__device__ __forceinline__ int kv_tiles(const Tile& t, int q0, int off) {
  const int last_row = (q0 + BQ < t.Sq ? q0 + BQ : t.Sq) - 1;
  int end = t.Skv;
  if (t.causal) {
    const long long e = (long long)last_row + off + 1;
    end = e < end ? (int)(e < 0 ? 0 : e) : end;
  }
  return (end + KT - 1) / KT;
}

template <int KT = BK>
__device__ __forceinline__ int kv_tiles(const Tile& t, int q0) {
  return kv_tiles<KT>(t, q0, t.off);
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

// One box of a 5-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load5(uint32_t dst, const CUtensorMap& map,
                                          uint32_t bar, int c0, int c1, int c2,
                                          int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4) : "memory");
}

// Shared memory rows x 64 columns at `src` (128-byte swizzled, as TMA
// loads them) into a box of a 5-D tensor map, as one bulk group; rows past
// the map's extent are not written.
__device__ __forceinline__ void tma_store5(const CUtensorMap& map,
                                           uint32_t src, int c0, int c1,
                                           int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(&map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until this thread's bulk groups have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Waits until this thread's bulk groups have written global memory.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Named barriers over consumer threads: ids 1 and 2 for the warpgroups'
// turns and 3 for both (256 threads), 4 and 5 for one warpgroup each
// (128).  bar.sync waits for the phase, bar.arrive only counts towards it.
__device__ __forceinline__ void named_sync(uint32_t id, uint32_t n = 256) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(uint32_t id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A waiting block faults its launch after this many of its SM's clock
// cycles (5 s at the H100's 1.98 GHz) instead of holding the card: a word
// that is never set is a fault of the caller.
constexpr long long WAIT_CYCLES = 10000000000ll;

// Waits until *word is set, i.e. nonzero (an acquire at device scope: the
// word is written by a stream memory operation after the block's copy), then
// orders the TMA loads that follow, which read through the async proxy,
// after it.
__device__ __forceinline__ void wait_word(const int* word) {
  if (ld_acquire(word) == 0) {
    const long long t0 = clock64();
    do {
      __nanosleep(256);
      if (clock64() - t0 > WAIT_CYCLES) __trap();
    } while (ld_acquire(word) == 0);
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
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

// Keeps register-A operands alive, unmoved, until the wgmma reading them
// has been waited for.
template <int K>
__device__ __forceinline__ void fence_a(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
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

// The barriers of a block's loads: `once` for the tiles loaded once (a
// tile per phase), and a "full" and an "empty" barrier for each of the NS
// stages of the ring (8 bytes apart).
template <int NS = STAGES>
struct Ring {
  uint32_t once, full, empty;
};

// Thread 0 initialises the 1 + 2 * NS barriers at `bars`: `once` and each
// "full" complete on `full_count` arrivals and their transaction bytes,
// each "empty" on one arrival per consumer warp.  The caller syncs the
// block before any use.
template <int NS = STAGES>
__device__ __forceinline__ Ring<NS> ring_init(uint64_t* bars,
                                              uint32_t full_count) {
  const Ring<NS> r{smem_u32(&bars[0]), smem_u32(&bars[1]),
                   smem_u32(&bars[1 + NS])};
  if (threadIdx.x == 0) {
    mbar_init(r.once, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(r.full + 8 * s, full_count);
      mbar_init(r.empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  return r;
}

// Producer side: waits until tile `it`'s stage is free, then calls
// fill(stage, the stage's "full" barrier).
template <int NS, class Fill>
__device__ __forceinline__ void produce_at(const Ring<NS>& r, int it,
                                           Fill&& fill) {
  const int s = it % NS;
  mbar_wait(r.empty + 8 * s, ((it / NS) & 1) ^ 1);
  fill(s, r.full + 8 * s);
}

// Producer side: for each of `n` tiles, waits until its stage is free, then
// calls fill(tile, stage, the stage's "full" barrier).
template <int NS, class Fill>
__device__ __forceinline__ void produce(const Ring<NS>& r, int n,
                                        Fill&& fill) {
  for (int it = 0; it < n; ++it)
    produce_at(r, it, [&](int s, uint32_t full) { fill(it, s, full); });
}

// Consumer side: waits until tile `it` has landed; returns its stage.
template <int NS>
__device__ __forceinline__ int consume(const Ring<NS>& r, int it) {
  const int s = it % NS;
  mbar_wait(r.full + 8 * s, (it / NS) & 1);
  return s;
}

// Consumer side: this warp is done with tile `it`'s stage.
template <int NS>
__device__ __forceinline__ void release(const Ring<NS>& r, int it) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(r.empty + 8 * (it % NS));
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

// As load_rows, from source `src` of a [source, B, S, H, D] map.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows5(uint32_t dst,
                                           const CUtensorMap& map,
                                           uint32_t bar, int r0, int h, int b,
                                           int src) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    tma_load5(dst + p * ROWS * ROW, map, bar, 64 * p, h, r0, b, src);
}

// The K/V stream: `n` tiles of KT keys of kv head hk from key 0, K into
// sk and V into sv, one tile a stage.
template <int D, int KT, int NS>
__device__ __forceinline__ void produce_kv(const Ring<NS>& r,
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

// ---------------------------------------------------------- the loop --

// Where a consumer thread's accumulator elements sit: o[4j + e] (e = 0, 1)
// is row rows[0], column 8j + 2c + e; o[4j + 2 + e] is row rows[1], the
// same column.  Rows are absolute q rows (they may lie past Sq).
struct Frag {
  int rows[2];
  int c;
};

// One q tile of a schedule: rows q0.. of head h, batch b, held rank j (the
// q map's source), global rank r; out and lse row block bo.
struct Job {
  int q0, h, b, j, r, bo;
};

// One K/V block of a q tile: the K/V maps' source and the mask's offset.
struct Block {
  int src, off;
};

// A persistent grid's share of `total` tiles in a fixed order: block c of
// G takes positions c, 2G - 1 - c, 2G + c, ... (a snake), so that with
// the order largest work first the blocks' sums stay within one tile's
// work of each other.
__device__ __forceinline__ int snake_jobs(int total) {
  const int G = gridDim.x, c = blockIdx.x, full = total / G;
  const int pos = (full & 1) ? G - 1 - c : c;
  return full + (pos < total - full * G ? 1 : 0);
}

__device__ __forceinline__ int snake_index(int k) {
  const int G = gridDim.x, c = blockIdx.x;
  return k * G + ((k & 1) ? G - 1 - c : c);
}

// The flash forward's schedule: the B x Hq x q-tile tiles over one K/V
// block, the last q tiles (the most keys under the causal mask) first,
// heads fastest.
struct FlashPlan {
  Tile t;
  int B, total;
  __device__ __forceinline__ int jobs() const { return snake_jobs(total); }
  __device__ __forceinline__ Job job(int k) const {
    const int idx = snake_index(k), BH = B * t.Hq;
    const int qt = (t.Sq + BQ - 1) / BQ - 1 - idx / BH, bh = idx % BH;
    const int b = bh / t.Hq;
    return Job{qt * BQ, bh - b * t.Hq, b, 0, 0, b};
  }
  __device__ __forceinline__ int blocks(const Job&) const { return 1; }
  __device__ __forceinline__ Block block(const Job&, int) const {
    return Block{0, t.off};
  }
  __device__ __forceinline__ void wait(int) const {}
};

// Rounds P (the fragment after exp2) to bf16 as BK / 16 k-steps of
// register-A operands.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&sc)[64]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
}

// O *= corr (a tile's correction, per row), then O += P V from the V tile
// at `sv` as one commit group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         const float (&corr)[2],
                                         uint32_t sv) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
  const uint64_t dv = desc(sv, BK * ROW);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    mma_rs_t(o, pa[kk], dv + ((kk * 16 * ROW) >> 4));
  wgmma_commit();
}

// The q tile's result: out = O / l (l == 0 -> 1) in bf16 and lse = m + log
// l (at [bo, h, row] of [*, Hq, Sq], for the rows below Sq), l summed
// over the quad.  out goes through shared memory: each warpgroup writes
// its 64 rows into its half of `so` (a 128-row tile of D / 64 swizzled
// panels, as TMA lays out a K or V tile), and one thread stores them with
// TMA (rows past Sq are not written) and waits until they have been read.
// Against stores straight from the fragment (4 bytes a thread and row)
// this measured 1.8% faster on the flash forward at llama_1b's shape and
// 1.2% slower on the ring's longer q tiles.
template <int D>
__device__ __forceinline__ void store_out(const float (&o)[D / 2],
                                          const float (&m)[2], float (&l)[2],
                                          const Frag& f, const Tile& t,
                                          const Job& jb, uint32_t so,
                                          const CUtensorMap& omap,
                                          float* __restrict__ lse) {
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const uint32_t half = so + 64 * wg * ROW;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    const float lr = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / lr;
    const int row = f.rows[r] - jb.q0 - 64 * wg;   // of the warpgroup's 64
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t at = half + (j / 8) * BK * ROW + row * ROW +
                          (((j % 8) ^ (row % 8)) * 16) + 4 * f.c;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                   "r"(pack_bf16(o[4 * j + 2 * r] * inv,
                                 o[4 * j + 2 * r + 1] * inv))
                   : "memory");
    }
    if (f.c == 0 && f.rows[r] < t.Sq)
      lse[((size_t)jb.bo * t.Hq + jb.h) * t.Sq + f.rows[r]] = m[r] + logf(lr);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(4 + wg, 128);
  if (tid == 0) {
#pragma unroll
    for (int p = 0; p < D / 64; ++p)
      tma_store5(omap, half + p * BK * ROW, 64 * p, jb.h, jb.q0 + 64 * wg,
                 jb.b, jb.j);
    bulk_commit();
    bulk_wait_read();
  }
  named_sync(4 + wg, 128);
}

// The whole block: barriers, the producer, the consumers' loop over the
// schedule's q tiles.  `Sched` gives t (the Tile; its off unused), jobs()
// (q tiles this block takes), job(k), blocks(job), block(job, i) and
// wait(src) (the producer, before a block's first load).
template <int D, class Sched>
__device__ __forceinline__ void fwd_loop(const CUtensorMap& qmap,
                                         const CUtensorMap& kmap,
                                         const CUtensorMap& vmap,
                                         const CUtensorMap& omap,
                                         const Sched& sched,
                                         bf16* __restrict__ out,
                                         float* __restrict__ lse) {
  using Sm = Smem<D>;
  constexpr int NS = KV_STAGES;
  extern __shared__ uint8_t fwd90_smem[];
  __shared__ __align__(8) uint64_t bars[2 + 2 * NS];
  const uint32_t sq = (smem_u32(fwd90_smem) + 1023) & ~1023u;
  const uint32_t sk = sq + Sm::Q;
  const uint32_t sv = sk + NS * Sm::KV;
  // The q tile's buffer is free again once every consumer warp's last
  // S = Q K^T of the tile has completed.
  const uint32_t qfree = smem_u32(&bars[1 + 2 * NS]);
  if (threadIdx.x == 0) mbar_init(qfree, CONSUMER_WARPS);
  const Ring<NS> ring = ring_init<NS>(bars, 1);
  __syncthreads();
  const Tile& t = sched.t;
  const int jobs = sched.jobs();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int g = 0, qk = 0;                // K/V tiles, q tiles loaded
      for (int k = 0; k < jobs; ++k) {
        const Job jb = sched.job(k);
        const int nb = sched.blocks(jb), hk = jb.h / (t.Hq / t.Hkv);
        bool q_in = false;
        for (int bi = 0; bi < nb; ++bi) {
          const Block bl = sched.block(jb, bi);
          const int nt = kv_tiles(t, jb.q0, bl.off);
          if (nt == 0) continue;
          if (!q_in) {
            if (qk > 0) mbar_wait(qfree, (qk - 1) & 1);
            mbar_expect_tx(ring.once, Sm::Q);
            load_rows5<D, BQ>(sq, qmap, ring.once, jb.q0, jb.h, jb.b, jb.j);
            ++qk;
            q_in = true;
          }
          sched.wait(bl.src);
          for (int ti = 0; ti < nt; ++ti, ++g)
            produce_at(ring, g, [&](int s, uint32_t full) {
              mbar_expect_tx(full, 2 * Sm::KV);
              load_rows5<D, BK>(sk + s * Sm::KV, kmap, full, ti * BK, hk,
                                jb.b, bl.src);
              load_rows5<D, BK>(sv + s * Sm::KV, vmap, full, ti * BK, hk,
                                jb.b, bl.src);
            });
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const float sl2 = t.scale * LOG2E;
    const uint32_t turn = 1 + wg, other = 2 - wg;   // named barrier ids
    const uint64_t dq = desc(sq + 64 * wg * ROW, 16);
    int g = 0, qk = 0;                  // K/V tiles, q tiles consumed
    for (int k = 0; k < jobs; ++k) {
      const Job jb = sched.job(k);
      const int nb = sched.blocks(jb);
      int n = 0;
      for (int bi = 0; bi < nb; ++bi)
        n += kv_tiles(t, jb.q0, sched.block(jb, bi).off);
      Frag f;
      f.rows[0] = jb.q0 + 64 * wg + 16 * warp + lane / 4;
      f.rows[1] = f.rows[0] + 8;
      f.c = lane % 4;
      const int wg_first = jb.q0 + 64 * wg;

      float o[D / 2], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      if (n > 0) {
        mbar_wait(ring.once, qk & 1);
        ++qk;
        if (wg == 1) named_arrive(1);   // warpgroup 0 issues first
        uint32_t pa[BK / 16][4];
        float corr[2];
        int bi = 0, ti = 0, off = 0, nt = 0, ps = 0;

        // One round: tile it's S = Q K^T, then (after the first round) the
        // previous tile's P V; the softmax of S while P V is in flight.
        // Every tile of the q tile runs every product, so no wgmma sits on
        // a branch: a tile that a warpgroup's rows cannot see (only the
        // flash forward's last, at offsets that 64 does not divide) or
        // rows past Sq are masked whole, and a masked row leaves O, m and
        // l as they were.
        auto round = [&](int it, auto first) {
          constexpr bool FIRST = decltype(first)::value;
          while (ti == nt) {            // the next block with tiles
            off = sched.block(jb, bi++).off;
            nt = kv_tiles(t, jb.q0, off);
            ti = 0;
          }
          const int s = consume(ring, g + it), kv0 = ti++ * BK;
          const bool last = it == n - 1;
          float sc[64];
          named_sync(turn);
          const uint64_t dk = desc(sk + s * Sm::KV, 16);
          fence_regs(sc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t qoff = (kk / 4) * BQ * ROW + (kk % 4) * 32;
            const uint32_t koff = (kk / 4) * BK * ROW + (kk % 4) * 32;
            mma_ss_n128(sc, dq + (qoff >> 4), dk + (koff >> 4), kk > 0);
          }
          wgmma_commit();
          if constexpr (!FIRST) issue_pv<D>(o, pa, corr, sv + ps * Sm::KV);
          if (wg == 0 || !last) named_arrive(other);
          if constexpr (FIRST)
            wgmma_wait();
          else
            wgmma_wait_n<1>();
          fence_regs(sc);
          if (last) {
            __syncwarp();
            if (lane == 0) mbar_arrive(qfree);
          }

          // Mask the tiles the diagonal or the ragged edge cuts.
          if (kv0 + BK > t.Skv ||
              (t.causal && kv0 + BK - 1 > wg_first + off)) {
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int col = kv0 + 8 * j + 2 * f.c + (e & 1);
                const int row = f.rows[e >> 1];
                if (!(col < t.Skv && (!t.causal || col <= row + off)))
                  sc[4 * j + e] = -INFINITY;
              }
          }

          // Online softmax on the fragment; P rounded to bf16 against the
          // running max.
          float cn[2], msc[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 16; ++j)
              mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
            mx = quad_max(mx);
            const float m_new = fmaxf(m[r], mx * t.scale);
            cn[r] = exp2f((m[r] - m_new) * LOG2E);
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
          l[0] = l[0] * cn[0] + sum[0];
          l[1] = l[1] * cn[1] + sum[1];

          // Retire the previous P V; its operands may then be replaced.
          if constexpr (!FIRST) {
            wgmma_wait();
            fence_regs(o);
            fence_a(pa);
            release(ring, g + it - 1);
          }
          corr[0] = cn[0];
          corr[1] = cn[1];
          pack_p(pa, sc);
          ps = s;
        };
        round(0, std::true_type{});
        for (int it = 1; it < n; ++it) round(it, std::false_type{});
        issue_pv<D>(o, pa, corr, sv + ps * Sm::KV);
        wgmma_wait();
        fence_regs(o);
        fence_a(pa);
        // Once both warpgroups' last P V has read it, the last V tile
        // holds the output on its way to global memory.
        named_sync(3);
        store_out<D>(o, m, l, f, t, jb, sv + ps * Sm::KV, omap, lse);
        release(ring, g + n - 1);
        g += n;
      } else {
        // Rows that see no key (causal, Skv < Sq): out 0, lse -1e30.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (f.rows[r] >= t.Sq) continue;
          bf16* op = out + ((size_t)(jb.bo * t.Sq + f.rows[r]) * t.Hq + jb.h) *
                               D + 2 * f.c;
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(op + 8 * j) = 0u;
          if (f.c == 0)
            lse[((size_t)jb.bo * t.Hq + jb.h) * t.Sq + f.rows[r]] = NEG;
        }
      }
    }
    if (threadIdx.x % 128 == 0) bulk_wait();
  }
}

// ------------------------------------------------------------- host --

// A driver entry point looked up through the CUDA runtime, so the library
// needs no -lcuda; null if the driver lacks it.
inline void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
  cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  return q == cudaDriverEntryPointSuccess ? p : nullptr;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn =
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  return fn;
}

// A bf16 tensor of `rank` dims (innermost first) as a tensor map, boxes of
// 64 columns x 1 head x `rows` rows x 1 x 1, 128-byte swizzle; reads past a
// dim's extent give zeros.
inline bool tiled_map(CUtensorMap* map, const void* ptr, int rank,
                      const cuuint64_t* dims, const cuuint64_t* strides,
                      int rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint32_t box[5] = {64, 1, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [B, S, H, D] bf16 tensor as a 4-D map (dims D, H, S, B).
inline bool bshd_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                     int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  return tiled_map(map, ptr, 4, dims, strides, rows);
}

// n sources of [B, S, H, D] bf16, `stride` elements apart (at least
// B * S * H * D), as a 5-D map (dims D, H, S, B, source).
inline bool sbshd_map(CUtensorMap* map, const void* ptr, int n,
                      long long stride, int B, int S, int H, int D,
                      int rows) {
  const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B, (cuuint64_t)n};
  const cuuint64_t strides[4] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2,
                                 (cuuint64_t)stride * 2};
  return tiled_map(map, ptr, 5, dims, strides, rows);
}

// The forward's maps: q and out over R held ranks of [B, Sq, Hq, D]
// (contiguous; out in boxes of a warpgroup's 64 rows), k and v over n
// sources of [B, Skv, Hkv, D], `kv_stride` elements apart.
struct Maps {
  CUtensorMap q, k, v, o;
};

inline bool fwd_maps(Maps* maps, const void* q, const void* k, const void* v,
                     const void* o, int R, int n, long long kv_stride, int B,
                     int Sq, int Skv, int Hq, int Hkv, int D) {
  const long long q_stride = (long long)B * Sq * Hq * D;
  return sbshd_map(&maps->q, q, R, q_stride, B, Sq, Hq, D, BQ) &&
         sbshd_map(&maps->o, o, R, q_stride, B, Sq, Hq, D, 64) &&
         sbshd_map(&maps->k, k, n, kv_stride, B, Skv, Hkv, D, BK) &&
         sbshd_map(&maps->v, v, n, kv_stride, B, Skv, Hkv, D, BK);
}

// The SMs of the current device, or 0 if the runtime refuses.
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
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
