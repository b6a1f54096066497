// The flash-attention backward for Hopper (sm_90a): the dK/dV block and the
// dQ block, on the forward's machinery (attn_fwd_sm90.cuh: 4-D TMA tensor
// maps over [B, S, H, D], the mbarrier load ring, wgmma with operands in
// shared memory or A in registers, a producer warpgroup and two consumer
// warpgroups with setmaxnreg 24 / 240).
//
// Both mirror kuberay_tpu/ops/attention.py::_bwd_dkv_kernel and
// ::_bwd_dq_kernel: P = exp(S * scale - lse) with S in f32 from bf16
// operands, dS = P * (dP - delta) * scale, P rounded to bf16 before
// dV += P^T dO and dS before dK += dS^T Q and dQ += dS K, f32 accumulation
// throughout, key j visible to row i when j < Skv and, with `causal`,
// j <= i + off (off = Skv - Sq: bottom-right).
//
// dK/dV block: one per (kv tile of KV_TILE = 128 keys, kv head, batch),
// the kv tiles longest first (tile 0 is seen by every q row).  K and V are
// loaded once; Q and dO tiles of Q_STEP = 64 rows stream through the
// 2-stage ring over the group's q heads and the q tiles that see the kv
// tile.  Each consumer warpgroup owns 64 keys and computes the transposed
// scores directly, keys on wgmma's M: S^T = K Q^T and dP^T = V dO^T
// (m64n64k16, both operands K-major in shared memory), so P^T and dS^T are
// born in the accumulator fragment, are rounded there and feed
// dV += P^T dO and dK += dS^T Q as register-A wgmma with B = dO and B = Q
// MN-major (the transpose bit): no S, P or dS tile touches shared memory.
// Q and dO are one swizzled layout read two ways: K-major (N = q rows) for
// the scores, MN-major (K = q rows, LBO = one 64-column panel) for the
// gradients, the same two readings the forward makes of K and V.  dK and
// dV stay f32 in registers for the whole loop (2 x D / 2 a thread) and
// are written once in bf16, summed over the group inside the block (the
// TPU path wrote per-q-head f32 buffers and summed them afterwards).  The
// fragment's columns are q rows, so each thread reads the lse and delta of
// its 16 columns from shared memory once a q tile; a second producer warp
// copies them there for each stage (lse times log2 e; 0 past Sq), as TMA
// needs 16-byte aligned rows, which lse [B, Hq, Sq] has only when 4
// divides Sq.  Within a q tile the products run as commit groups waited
// for one at a time: P^T is formed while dP^T is in flight, dS^T while
// dV += P^T dO is (fence_a keeps a register-A operand in its registers
// until the group reading it has been waited for).
//
// dQ block: one per (128-row q tile, q head, batch), the forward's loop
// with another body and the same longest-first order: Q and dO loaded
// once, K/V tiles of DQ_KEYS = 64 keys (for register room: S 32 + dP 32 +
// dQ D / 2) through the forward's producer; S = Q K^T and dP = dO V^T as
// m64n64k16 with both operands in shared memory, P and dS formed on the
// fragment (rows = q rows, lse and delta two a thread; P while dP is in
// flight), dQ += dS K as register-A wgmma with K MN-major; dQ f32 in
// registers.
//
// Masking: TMA's zero fill past Sq or Skv does not make P zero
// (exp(0 - lse) != 0), so P and dS are set to 0 on every tile that the
// diagonal or a ragged edge cuts; a tile whose pairs are all visible pays
// no per-element test, a tile that nothing sees is never loaded (the loop
// bounds) or, for one consumer warpgroup's half, skipped.
//
// Deterministic: no float atomics, so repeats are bit for bit.  That keeps
// two kernels (7 products: S, dP for each, dV, dK, dQ) rather than
// FlashAttention-3's one (5 products, dQ summed across kv tiles by
// atomics): at llama_1b's shape (B 4, S 2048, 16/8 heads of 128, causal)
// the bound is 0.139 ms (dK/dV, 4 products) + 0.104 ms (dQ, 3) of
// operations at 989 TFLOP/s, 0.243 ms, against 0.174 ms for 5.

#pragma once

#include "attn_fwd_sm90.cuh"

namespace bwd90 {

using namespace fwd90;

// Tile sizes; ops/attention.py's BWD_KV_TILE, BWD_Q_STEP, BWD_DQ_Q_TILE
// (fwd90::BQ) and BWD_DQ_KV_TILE give the same numbers to the CPU tile
// model in tests/test_torch_flash_bwd_tiles.py.
constexpr int KV_TILE = 128;   // dK/dV: keys a block, 64 a consumer warpgroup
constexpr int Q_STEP = 64;     // dK/dV: q rows a ring stage
constexpr int DQ_KEYS = 64;    // dQ: keys a K/V tile
constexpr int ROWS_WARP = 9;   // dK/dV: the producer warp copying lse, delta

template <int D> struct DkvSmem {
  static constexpr int KV = KV_TILE * D * 2;     // K or V
  static constexpr int QS = Q_STEP * D * 2;      // a stage's Q or dO
  static constexpr int ROWS = 2 * Q_STEP * 4;    // a stage's lse and delta
  static constexpr int BYTES = 2 * KV + STAGES * (2 * QS + ROWS) + 1024;
};

template <int D> struct DqSmem {
  static constexpr int Q = BQ * D * 2;           // Q or dO
  static constexpr int KV = DQ_KEYS * D * 2;     // a stage's K or V
  static constexpr int BYTES = 2 * Q + STAGES * 2 * KV + 1024;
};

// The q tiles a kv tile at kv0 reads, for each q head of the group: from
// the first that holds a row seeing key kv0 to the last.
struct QSteps {
  int first, per_head;
};

__device__ __forceinline__ QSteps q_steps(const Tile& t, int kv0) {
  long long row_min = t.causal ? (long long)kv0 - t.off : 0;
  row_min = row_min < 0 ? 0 : row_min;
  const int nq = (t.Sq + Q_STEP - 1) / Q_STEP;
  const long long first = row_min / Q_STEP;
  return {(int)(first < nq ? first : nq), first < nq ? nq - (int)first : 0};
}

__device__ __forceinline__ bool visible(const Tile& t, int row, int key) {
  return row < t.Sq && key < t.Skv && (!t.causal || key <= row + t.off);
}

// Stores a consumer thread's accumulator rows (those below S) into a
// [B, S, H, D] bf16 tensor at head h, batch b: acc[4j + 2r + e] is row
// rows[r], column 8j + 2c + e.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const float (&acc)[D / 2],
                                           const int (&rows)[2], int c,
                                           int S, int H, int h, int b) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    bf16* p = dst + ((size_t)(b * S + rows[r]) * H + h) * D + 2 * c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// Rounds a 64 x 64 fragment to bf16 as four k-steps of register-A operands.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// ------------------------------------------------------------- dK/dV --

template <int D>
__device__ __forceinline__ void dkv_block(
    const CUtensorMap& qmap, const CUtensorMap& kmap, const CUtensorMap& vmap,
    const CUtensorMap& domap, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, const Tile& t, int kv0, int hk, int b) {
  using Sm = DkvSmem<D>;
  extern __shared__ uint8_t bwd90_smem[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  const uint32_t base = smem_u32(bwd90_smem);
  const uint32_t sk = (base + 1023) & ~1023u;
  const uint32_t sv = sk + Sm::KV;
  const uint32_t sq = sv + Sm::KV;                 // + stage * Sm::QS
  const uint32_t sdo = sq + STAGES * Sm::QS;       // + stage * Sm::QS
  // lse * log2 e, then delta, Q_STEP of each a stage.
  float* rows = reinterpret_cast<float*>(bwd90_smem + (sdo - base) +
                                         STAGES * Sm::QS);
  const int G = t.Hq / t.Hkv;
  const QSteps qs = q_steps(t, kv0);
  const int n = G * qs.per_head;
  // A stage is full when the TMA thread's bytes and the 32 row copies
  // have landed.
  const Ring<> ring = ring_init(bars, 1 + 32);
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256 && n > 0) {
      mbar_expect_tx(ring.once, 2 * Sm::KV);
      load_rows<D, KV_TILE>(sk, kmap, ring.once, kv0, hk, b);
      load_rows<D, KV_TILE>(sv, vmap, ring.once, kv0, hk, b);
      produce(ring, n, [&](int it, int s, uint32_t full) {
        const int h = hk * G + it / qs.per_head;
        const int q0 = (qs.first + it % qs.per_head) * Q_STEP;
        mbar_expect_tx(full, 2 * Sm::QS);
        load_rows<D, Q_STEP>(sq + s * Sm::QS, qmap, full, q0, h, b);
        load_rows<D, Q_STEP>(sdo + s * Sm::QS, domap, full, q0, h, b);
      });
    } else if (threadIdx.x / 32 == ROWS_WARP) {
      produce(ring, n, [&](int it, int s, uint32_t full) {
        const int h = hk * G + it / qs.per_head;
        const int q0 = (qs.first + it % qs.per_head) * Q_STEP;
        const size_t at = ((size_t)b * t.Hq + h) * t.Sq;
        float* dst = rows + s * 2 * Q_STEP;
        for (int r = lane; r < Q_STEP; r += 32) {
          const bool in = q0 + r < t.Sq;
          dst[r] = in ? lse[at + q0 + r] * LOG2E : 0.f;
          dst[Q_STEP + r] = in ? delta[at + q0 + r] : 0.f;
        }
        mbar_arrive(full);
      });
    }
  } else {
    // ---- consumers: 64 keys each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x % 128) / 32, c = lane % 4;
    const int key0 = kv0 + 64 * wg;              // this warpgroup's keys
    int keys[2];
    keys[0] = key0 + 16 * warp + lane / 4;
    keys[1] = keys[0] + 8;
    const float sl2 = t.scale * LOG2E;

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    const uint64_t kd = desc(sk + 64 * wg * ROW, 16);
    const uint64_t vd = desc(sv + 64 * wg * ROW, 16);
    if (n > 0) mbar_wait(ring.once, 0);
    for (int it = 0; it < n; ++it) {
      const int s = consume(ring, it);
      const int q0 = (qs.first + it % qs.per_head) * Q_STEP;
      const int q_last = (q0 + Q_STEP < t.Sq ? q0 + Q_STEP : t.Sq) - 1;
      if (key0 < t.Skv && (!t.causal || key0 <= q_last + t.off)) {
        // S^T = K Q^T and dP^T = V dO^T, keys on M, as two groups: P^T
        // is formed while dP^T runs, and dS^T while dV runs.
        float st[32], dpt[32];
        const uint32_t qst = sq + s * Sm::QS, dost = sdo + s * Sm::QS;
        const uint64_t qd = desc(qst, 16), dod = desc(dost, 16);
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t a = (kk / 4) * KV_TILE * ROW + (kk % 4) * 32;
          const uint32_t bo = (kk / 4) * Q_STEP * ROW + (kk % 4) * 32;
          mma_ss_n64(st, kd + (a >> 4), qd + (bo >> 4), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t a = (kk / 4) * KV_TILE * ROW + (kk % 4) * 32;
          const uint32_t bo = (kk / 4) * Q_STEP * ROW + (kk % 4) * 32;
          mma_ss_n64(dpt, vd + (a >> 4), dod + (bo >> 4), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_n<1>();
        fence_regs(st);

        // P^T on the fragment: column 8j + 2c + e is q row
        // q0 + 8j + 2c + e, whose lse and delta sit in this stage's rows.
        const float* lr = rows + s * 2 * Q_STEP;
        const bool cut = q0 + Q_STEP > t.Sq || key0 + 64 > t.Skv ||
                         (t.causal && key0 + 63 > q0 + t.off);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * c;
          const float2 l2 = *reinterpret_cast<const float2*>(lr + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const float p = exp2f(fmaf(st[i], sl2, -((e & 1) ? l2.y : l2.x)));
            st[i] = cut && !visible(t, q0 + col + (e & 1), keys[e >> 1])
                        ? 0.f : p;
          }
        }
        uint32_t pa[4][4], da[4][4];
        pack_a(pa, st);

        // dV += P^T dO, B MN-major (K = q rows).
        const uint64_t dob = desc(dost, Q_STEP * ROW);
        const uint64_t qb = desc(qst, Q_STEP * ROW);
        fence_regs(dva);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_rs_t(dva, pa[kk], dob + ((kk * 16 * ROW) >> 4));
        wgmma_commit();

        // dS^T = P^T (dP^T - delta) scale; 0 where P^T is.
        wgmma_wait_n<1>();
        fence_regs(dpt);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(lr + Q_STEP + 8 * j + 2 * c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            dpt[i] = st[i] * (dpt[i] - ((e & 1) ? d2.y : d2.x)) * t.scale;
          }
        }
        pack_a(da, dpt);

        // dK += dS^T Q.
        fence_regs(dka);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_rs_t(dka, da[kk], qb + ((kk * 16 * ROW) >> 4));
        wgmma_commit();
        wgmma_wait();
        fence_regs(dva);
        fence_regs(dka);
        fence_a(pa);
        fence_a(da);
      }
      release(ring, it);
    }
    store_rows<D>(dk, dka, keys, c, t.Skv, t.Hkv, hk, b);
    store_rows<D>(dv, dva, keys, c, t.Skv, t.Hkv, hk, b);
  }
}

// ---------------------------------------------------------------- dQ --

template <int D>
__device__ __forceinline__ void dq_block(
    const CUtensorMap& qmap, const CUtensorMap& kmap, const CUtensorMap& vmap,
    const CUtensorMap& domap, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, const Tile& t,
    int q0, int h, int b) {
  using Sm = DqSmem<D>;
  extern __shared__ uint8_t bwd90_smem[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  const uint32_t sq = (smem_u32(bwd90_smem) + 1023) & ~1023u;
  const uint32_t sdo = sq + Sm::Q;
  const uint32_t sk = sdo + Sm::Q;                 // + stage * Sm::KV
  const uint32_t sv = sk + STAGES * Sm::KV;        // + stage * Sm::KV
  const int n = kv_tiles<DQ_KEYS>(t, q0);
  const Ring<> ring = ring_init(bars, 1);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256 && n > 0) {
      mbar_expect_tx(ring.once, 2 * Sm::Q);
      load_rows<D, BQ>(sq, qmap, ring.once, q0, h, b);
      load_rows<D, BQ>(sdo, domap, ring.once, q0, h, b);
      produce_kv<D, DQ_KEYS>(ring, kmap, vmap, sk, sv, h / (t.Hq / t.Hkv), b,
                             n);
    }
  } else {
    // ---- consumers: 64 q rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int c = lane % 4;
    int rows[2];
    rows[0] = q0 + 64 * wg + 16 * warp + lane / 4;
    rows[1] = rows[0] + 8;
    const int wg_first = q0 + 64 * wg;
    const int wg_last = min(wg_first + 63, t.Sq - 1);
    const float sl2 = t.scale * LOG2E;
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t at = ((size_t)b * t.Hq + h) * t.Sq + rows[r];
      l2[r] = rows[r] < t.Sq ? lse[at] * LOG2E : 0.f;
      dl[r] = rows[r] < t.Sq ? delta[at] : 0.f;
    }

    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

    const uint64_t qd = desc(sq + 64 * wg * ROW, 16);
    const uint64_t dod = desc(sdo + 64 * wg * ROW, 16);
    if (n > 0) mbar_wait(ring.once, 0);
    for (int it = 0; it < n; ++it) {
      const int s = consume(ring, it), kv0 = it * DQ_KEYS;
      if (wg_last >= wg_first && (!t.causal || kv0 <= wg_last + t.off)) {
        // S = Q K^T and dP = dO V^T as two groups: P is formed while dP
        // runs.
        float sc[32], dp[32];
        const uint32_t kst = sk + s * Sm::KV, vst = sv + s * Sm::KV;
        const uint64_t kd = desc(kst, 16), vd = desc(vst, 16);
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t a = (kk / 4) * BQ * ROW + (kk % 4) * 32;
          const uint32_t bo = (kk / 4) * DQ_KEYS * ROW + (kk % 4) * 32;
          mma_ss_n64(sc, qd + (a >> 4), kd + (bo >> 4), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t a = (kk / 4) * BQ * ROW + (kk % 4) * 32;
          const uint32_t bo = (kk / 4) * DQ_KEYS * ROW + (kk % 4) * 32;
          mma_ss_n64(dp, dod + (a >> 4), vd + (bo >> 4), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_n<1>();
        fence_regs(sc);

        // P, then dS, on the fragment (rows = q rows, columns = keys).
        const bool cut = kv0 + DQ_KEYS > t.Skv ||
                         (t.causal && kv0 + DQ_KEYS - 1 > wg_first + t.off);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const float p = exp2f(fmaf(sc[i], sl2, -l2[r]));
          sc[i] = cut && !visible(t, rows[r],
                                  kv0 + 8 * (i >> 2) + 2 * c + (i & 1))
                      ? 0.f : p;
        }
        wgmma_wait();
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]) * t.scale;
        uint32_t da[4][4];
        pack_a(da, dp);

        // dQ += dS K, K MN-major (K = keys).
        const uint64_t kb = desc(kst, DQ_KEYS * ROW);
        fence_regs(dqa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_rs_t(dqa, da[kk], kb + ((kk * 16 * ROW) >> 4));
        wgmma_commit();
        wgmma_wait();
        fence_regs(dqa);
        fence_a(da);
      }
      release(ring, it);
    }
    store_rows<D>(dq, dqa, rows, c, t.Sq, t.Hq, h, b);
  }
}

// Grid of the dK/dV kernel: (kv head, batch, kv tile), the kv tiles in
// order, so the causal tiles that the most q rows see start first.
inline dim3 dkv_grid(int B, int Skv, int Hkv) {
  return dim3(Hkv, B, (Skv + KV_TILE - 1) / KV_TILE);
}

}  // namespace bwd90
