// Causal GQA flash attention for training: forward, dK/dV and dQ kernels.
//
// Replaces kuberay_tpu/ops/attention.py::_fwd_kernel (via _flash_fwd),
// ::_bwd_dkv_kernel and ::_bwd_dq_kernel (via _flash_bwd).
//
//   q    [B, Sq,  Hq,  D]  bf16      (the model's layout; no transposes)
//   k, v [B, Skv, Hkv, D]  bf16
//   o    [B, Sq,  Hq,  D]  bf16
//   lse  [B, Hq, Sq]       f32       (log-sum-exp of each score row)
//   do   [B, Sq,  Hq,  D]  bf16      (output cotangent)
//   delta[B, Hq, Sq]       f32       (rowsum(dO * O), computed by the caller)
//   dq, dk, dv             bf16, the shapes of q, k, v
//
// Semantics, as the TPU kernels: scores in f32 from bf16 operands, times
// `scale`; causal alignment bottom-right (query row r sees keys
// <= r + Skv - Sq); the probabilities are rounded to bf16 before P @ V and
// dS before dS @ K / dS^T @ Q, with f32 accumulation throughout.  A row
// that sees no key gives out 0 and lse -1e30 (the l == 0 -> 1 guard).
// Rows past Sq and keys past Skv are masked, so any length works (the TPU
// path fell back to XLA for lengths no block divided).
//
// Bound on an H100: operations.  At llama_1b's training shape (B 4,
// S 2048, Hq 16, Hkv 8, D 128, causal) one causal product Q K^T is
// 2 * B * Hq * S^2 / 2 * D = 34.4 GFLOP, so the forward (2 products) needs
// 69 us at 989 TFLOP/s, dK/dV (4 products) 139 us and dQ (3 products)
// 104 us; their bytes (q, k, v, o, dO: about 50 MB) take 15 us at 3.35 TB/s.
//
// Design.  Every kernel is one block of 4 warps over a 64-row tile; each
// warp owns 16 rows.  The TPU kernels' sequential kv (or q) grid axis, with
// its VMEM accumulators, becomes a loop inside the block.  Tiles are staged
// in shared memory with 16-byte loads; the products run on the tensor cores
// through nvcuda::wmma bf16 16x16x16 fragments with f32 accumulators; the
// softmax and the dS arithmetic run on f32 rows in shared memory.  Causal
// tiles that see nothing are skipped by the loop bounds.
// - forward: one block per (q tile, q head, batch); online softmax with a
//   running max and sum per row; O accumulates in f32 shared memory.
// - dK/dV: one block per (kv tile, kv head, batch); it loops over the
//   group's q heads and the q tiles that see the tile, so dK and dV
//   accumulate in f32 once per kv head and are written once (the TPU path
//   wrote per-q-head f32 [B, Hq, Skv, D] buffers and summed the group).
// - dQ: one block per (q tile, q head, batch); it loops over the visible
//   kv tiles.
// Not used yet: wgmma, TMA, cp.async pipelining, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;            // q rows per tile
constexpr int BK = 64;            // kv rows per tile
constexpr int NT = 128;           // threads: 4 warps x 16 rows
constexpr float NEG = -1e30f;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Shared-memory row strides (elements), padded against bank conflicts and
// kept multiples of 8 (bf16) / 4 (f32) with 32-byte aligned fragments.
template <int D> struct Ld {
  static constexpr int T = D + 8;    // bf16 [rows][D] tiles
  static constexpr int S = BK + 4;   // f32 [64][64] scores
  static constexpr int P = BK + 8;   // bf16 [64][64] probabilities / dS
  static constexpr int A = D + 4;    // f32 [64][D] accumulators
};

// Rows [r0, r0 + 64) of a [rows, stride] bf16 matrix into smem; rows at or
// past `limit` are zero-filled.
template <int D>
__device__ void load_tile(bf16* dst, const bf16* src, size_t stride, int r0,
                          int limit) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < 64 * CH; c += NT) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * stride + col);
    *reinterpret_cast<uint4*>(dst + r * Ld<D>::T + col) = val;
  }
}

template <int D>
__device__ void zero_acc(float* acc) {
  for (int c = threadIdx.x; c < 64 * Ld<D>::A; c += NT) acc[c] = 0.f;
}

// out[16 rows of this warp][64] = a[16 rows][D] . b[64 rows][D]^T  (f32)
template <int D>
__device__ void rows_times_tile_t(float* out, const bf16* a, const bf16* b) {
  const int w = threadIdx.x / 32;
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBT fb;
      wmma::load_matrix_sync(fa, a + (16 * w) * Ld<D>::T + kk * 16, Ld<D>::T);
      wmma::load_matrix_sync(fb, b + (n * 16) * Ld<D>::T + kk * 16, Ld<D>::T);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(out + (16 * w) * Ld<D>::S + n * 16, c, Ld<D>::S,
                            wmma::mem_row_major);
  }
}

// acc[16 rows of this warp][D] += p[16 rows][64] . t[64][D]
template <int D>
__device__ void acc_rows(float* acc, const bf16* p, const bf16* t) {
  const int w = threadIdx.x / 32;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    FragC c;
    float* cp = acc + (16 * w) * Ld<D>::A + n * 16;
    wmma::load_matrix_sync(c, cp, Ld<D>::A, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, p + (16 * w) * Ld<D>::P + kk * 16, Ld<D>::P);
      wmma::load_matrix_sync(fb, t + (kk * 16) * Ld<D>::T + n * 16, Ld<D>::T);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(cp, c, Ld<D>::A, wmma::mem_row_major);
  }
}

// acc[16 kv rows of this warp][D] += p[64 q][64 kv]^T . t[64 q][D]
template <int D>
__device__ void acc_cols(float* acc, const bf16* p, const bf16* t) {
  const int w = threadIdx.x / 32;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    FragC c;
    float* cp = acc + (16 * w) * Ld<D>::A + n * 16;
    wmma::load_matrix_sync(c, cp, Ld<D>::A, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      FragAT fa;
      FragB fb;
      wmma::load_matrix_sync(fa, p + (kk * 16) * Ld<D>::P + 16 * w, Ld<D>::P);
      wmma::load_matrix_sync(fb, t + (kk * 16) * Ld<D>::T + n * 16, Ld<D>::T);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(cp, c, Ld<D>::A, wmma::mem_row_major);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Shape {
  int Sq, Skv, Hq, Hkv, causal;
  float scale;
};

// Does query row `row` see key `col`?
__device__ __forceinline__ bool visible(const Shape& s, int row, int col) {
  return row < s.Sq && col < s.Skv && (!s.causal || col <= row + s.Skv - s.Sq);
}

// End (exclusive) of the keys that q rows [q0, q0 + 64) can see.
__device__ __forceinline__ int kv_end(const Shape& s, int q0) {
  if (!s.causal) return s.Skv;
  const int e = q0 + BQ + s.Skv - s.Sq;
  return e < s.Skv ? e : s.Skv;
}

template <int D>
constexpr size_t fwd_smem() {
  return (size_t)3 * 64 * Ld<D>::T * 2 + 64 * Ld<D>::S * 4 + 64 * Ld<D>::P * 2 +
         64 * Ld<D>::A * 4 + 2 * 64 * 4;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + 64 * Ld<D>::T;
  bf16* v_s = k_s + 64 * Ld<D>::T;
  float* s_s = reinterpret_cast<float*>(v_s + 64 * Ld<D>::T);
  bf16* p_s = reinterpret_cast<bf16*>(s_s + 64 * Ld<D>::S);
  float* o_s = reinterpret_cast<float*>(p_s + 64 * Ld<D>::P);
  float* m_s = o_s + 64 * Ld<D>::A;
  float* l_s = m_s + 64;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (s.Hq / s.Hkv);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qstride = (size_t)s.Hq * D, kstride = (size_t)s.Hkv * D;
  const bf16* qb = q + ((size_t)b * s.Sq * s.Hq + h) * D;
  const bf16* kb = k + ((size_t)b * s.Skv * s.Hkv + hk) * D;
  const bf16* vb = v + ((size_t)b * s.Skv * s.Hkv + hk) * D;

  load_tile<D>(q_s, qb, qstride, q0, s.Sq);
  zero_acc<D>(o_s);
  if (threadIdx.x < 64) {
    m_s[threadIdx.x] = NEG;
    l_s[threadIdx.x] = 0.f;
  }
  const int end = kv_end(s, q0);
  for (int kv0 = 0; kv0 < end; kv0 += BK) {
    __syncthreads();                       // k_s / v_s free; q_s, o_s ready
    load_tile<D>(k_s, kb, kstride, kv0, s.Skv);
    load_tile<D>(v_s, vb, kstride, kv0, s.Skv);
    __syncthreads();
    rows_times_tile_t<D>(s_s, q_s, k_s);
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = 16 * w + rr, row = q0 + r;
      float x[2];
      bool ok[2];
      float mx = NEG;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = lane + 32 * e;
        ok[e] = visible(s, row, kv0 + c);
        x[e] = s_s[r * Ld<D>::S + c] * s.scale;
        if (ok[e]) mx = fmaxf(mx, x[e]);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ok[e] ? expf(x[e] - m_new) : 0.f;
        sum += p;
        p_s[r * Ld<D>::P + lane + 32 * e] = __float2bfloat16(p);
      }
      sum = warp_sum(sum);
      const float corr = expf(m_old - m_new);
      for (int d = lane; d < D; d += 32) o_s[r * Ld<D>::A + d] *= corr;
      __syncwarp();
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncwarp();
    acc_rows<D>(o_s, p_s, v_s);
  }
  __syncthreads();                       // also when no tile was visible
  for (int rr = 0; rr < 16; ++rr) {
    const int r = 16 * w + rr, row = q0 + r;
    if (row >= s.Sq) break;
    float l = l_s[r];
    l = l == 0.f ? 1.f : l;
    const float inv = 1.f / l;
    bf16* op = o + ((size_t)b * s.Sq + row) * qstride + (size_t)h * D;
    for (int d = lane; d < D; d += 32)
      op[d] = __float2bfloat16(o_s[r * Ld<D>::A + d] * inv);
    if (lane == 0) lse[((size_t)b * s.Hq + h) * s.Sq + row] = m_s[r] + logf(l);
  }
}

// P and dS of this warp's 16 q rows against one kv tile, from the scores
// (s_s) and dO . V^T (dp_s); rows/keys that are not visible give 0.
template <int D>
__device__ void p_and_ds(const Shape& s, const float* s_s, const float* dp_s,
                         const float* lse_s, const float* dl_s, bf16* p_b,
                         bf16* ds_b, int q0, int kv0) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = 16 * w + rr, row = q0 + r;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = lane + 32 * e;
      float p = 0.f, ds = 0.f;
      if (visible(s, row, kv0 + c)) {
        p = expf(s_s[r * Ld<D>::S + c] * s.scale - lse_s[r]);
        ds = p * (dp_s[r * Ld<D>::S + c] - dl_s[r]) * s.scale;
      }
      if (p_b) p_b[r * Ld<D>::P + c] = __float2bfloat16(p);
      ds_b[r * Ld<D>::P + c] = __float2bfloat16(ds);
    }
  }
}

template <int D>
constexpr size_t dkv_smem() {
  return (size_t)4 * 64 * Ld<D>::T * 2 + 2 * 64 * Ld<D>::S * 4 +
         2 * 64 * Ld<D>::P * 2 + 2 * 64 * Ld<D>::A * 4 + 2 * 64 * 4;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + 64 * Ld<D>::T;
  bf16* q_s = v_s + 64 * Ld<D>::T;
  bf16* do_s = q_s + 64 * Ld<D>::T;
  float* s_s = reinterpret_cast<float*>(do_s + 64 * Ld<D>::T);
  float* dp_s = s_s + 64 * Ld<D>::S;
  bf16* p_b = reinterpret_cast<bf16*>(dp_s + 64 * Ld<D>::S);
  bf16* ds_b = p_b + 64 * Ld<D>::P;
  float* dk_s = reinterpret_cast<float*>(ds_b + 64 * Ld<D>::P);
  float* dv_s = dk_s + 64 * Ld<D>::A;
  float* lse_s = dv_s + 64 * Ld<D>::A;
  float* dl_s = lse_s + 64;

  const int kv0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = s.Hq / s.Hkv;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qstride = (size_t)s.Hq * D, kstride = (size_t)s.Hkv * D;
  const size_t koff = ((size_t)b * s.Skv * s.Hkv + hk) * D;

  load_tile<D>(k_s, k + koff, kstride, kv0, s.Skv);
  load_tile<D>(v_s, v + koff, kstride, kv0, s.Skv);
  zero_acc<D>(dk_s);
  zero_acc<D>(dv_s);
  // The first q tile holding a row that sees key kv0.
  int row_min = s.causal ? kv0 - (s.Skv - s.Sq) : 0;
  row_min = row_min < 0 ? 0 : row_min;
  const int i0 = row_min / BQ * BQ;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t qoff = ((size_t)b * s.Sq * s.Hq + h) * D;
    const float* lse_h = lse + ((size_t)b * s.Hq + h) * s.Sq;
    const float* dl_h = delta + ((size_t)b * s.Hq + h) * s.Sq;
    for (int q0 = i0; q0 < s.Sq; q0 += BQ) {
      __syncthreads();                     // tiles of the last pass consumed
      load_tile<D>(q_s, q + qoff, qstride, q0, s.Sq);
      load_tile<D>(do_s, dO + qoff, qstride, q0, s.Sq);
      if (threadIdx.x < 64) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < s.Sq ? lse_h[row] : 0.f;
        dl_s[threadIdx.x] = row < s.Sq ? dl_h[row] : 0.f;
      }
      __syncthreads();
      rows_times_tile_t<D>(s_s, q_s, k_s);
      rows_times_tile_t<D>(dp_s, do_s, v_s);
      __syncwarp();
      p_and_ds<D>(s, s_s, dp_s, lse_s, dl_s, p_b, ds_b, q0, kv0);
      __syncthreads();                     // P, dS of all 64 q rows
      acc_cols<D>(dv_s, p_b, do_s);
      acc_cols<D>(dk_s, ds_b, q_s);
    }
  }
  __syncthreads();                       // also when no tile was visible
  for (int rr = 0; rr < 16; ++rr) {
    const int r = 16 * w + rr, row = kv0 + r;
    if (row >= s.Skv) break;
    const size_t off = koff + (size_t)row * kstride;
    for (int d = lane; d < D; d += 32) {
      dk[off + d] = __float2bfloat16(dk_s[r * Ld<D>::A + d]);
      dv[off + d] = __float2bfloat16(dv_s[r * Ld<D>::A + d]);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return (size_t)4 * 64 * Ld<D>::T * 2 + 2 * 64 * Ld<D>::S * 4 +
         64 * Ld<D>::P * 2 + 64 * Ld<D>::A * 4 + 2 * 64 * 4;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + 64 * Ld<D>::T;
  bf16* k_s = do_s + 64 * Ld<D>::T;
  bf16* v_s = k_s + 64 * Ld<D>::T;
  float* s_s = reinterpret_cast<float*>(v_s + 64 * Ld<D>::T);
  float* dp_s = s_s + 64 * Ld<D>::S;
  bf16* ds_b = reinterpret_cast<bf16*>(dp_s + 64 * Ld<D>::S);
  float* dq_s = reinterpret_cast<float*>(ds_b + 64 * Ld<D>::P);
  float* lse_s = dq_s + 64 * Ld<D>::A;
  float* dl_s = lse_s + 64;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (s.Hq / s.Hkv);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qstride = (size_t)s.Hq * D, kstride = (size_t)s.Hkv * D;
  const size_t qoff = ((size_t)b * s.Sq * s.Hq + h) * D;
  const size_t koff = ((size_t)b * s.Skv * s.Hkv + hk) * D;

  load_tile<D>(q_s, q + qoff, qstride, q0, s.Sq);
  load_tile<D>(do_s, dO + qoff, qstride, q0, s.Sq);
  zero_acc<D>(dq_s);
  if (threadIdx.x < 64) {
    const int row = q0 + threadIdx.x;
    const size_t base = ((size_t)b * s.Hq + h) * s.Sq;
    lse_s[threadIdx.x] = row < s.Sq ? lse[base + row] : 0.f;
    dl_s[threadIdx.x] = row < s.Sq ? delta[base + row] : 0.f;
  }
  const int end = kv_end(s, q0);
  for (int kv0 = 0; kv0 < end; kv0 += BK) {
    __syncthreads();
    load_tile<D>(k_s, k + koff, kstride, kv0, s.Skv);
    load_tile<D>(v_s, v + koff, kstride, kv0, s.Skv);
    __syncthreads();
    rows_times_tile_t<D>(s_s, q_s, k_s);
    rows_times_tile_t<D>(dp_s, do_s, v_s);
    __syncwarp();
    p_and_ds<D>(s, s_s, dp_s, lse_s, dl_s, nullptr, ds_b, q0, kv0);
    __syncwarp();
    acc_rows<D>(dq_s, ds_b, k_s);
  }
  __syncthreads();                       // also when no tile was visible
  for (int rr = 0; rr < 16; ++rr) {
    const int r = 16 * w + rr, row = q0 + r;
    if (row >= s.Sq) break;
    const size_t off = qoff + (size_t)row * qstride;
    for (int d = lane; d < D; d += 32)
      dq[off + d] = __float2bfloat16(dq_s[r * Ld<D>::A + d]);
  }
}

bool shape_ok(int B, int Sq, int Skv, int Hq, int Hkv, int D) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0) return false;
  const int G = Hq / Hkv;
  return (D == 64 || D == 128) && (G == 1 || G == 2 || G == 4 || G == 8);
}

// Sets the kernel's dynamic shared memory, launches it with NT threads a
// block and returns cudaGetLastError().
template <typename... P, typename... A>
int launch(void (*kernel)(P...), size_t smem, dim3 grid, void* stream,
           A... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

// Calls f with std::integral_constant<int, D> for D = 128 or 64, so each
// entry point names its kernel and shared memory once for both head dims.
template <typename F>
int with_head_dim(int D, F f) {
  return D == 128 ? f(std::integral_constant<int, 128>{})
                  : f(std::integral_constant<int, 64>{});
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 =
// launched), or cudaErrorInvalidValue for a shape without an instantiation
// (head_dim 64 or 128; group 1, 2, 4 or 8).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Sq, int Skv,
                              int Hq, int Hkv, int D, int causal, float scale,
                              void* stream) {
  if (!shape_ok(B, Sq, Skv, Hq, Hkv, D)) return (int)cudaErrorInvalidValue;
  const Shape s{Sq, Skv, Hq, Hkv, causal, scale};
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  return with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return launch(flash_fwd_kernel<DD>, fwd_smem<DD>(), grid, stream,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
                  (float*)lse, s);
  });
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dO, const void* lse,
                                  const void* delta, void* dk, void* dv, int B,
                                  int Sq, int Skv, int Hq, int Hkv, int D,
                                  int causal, float scale, void* stream) {
  if (!shape_ok(B, Sq, Skv, Hq, Hkv, D)) return (int)cudaErrorInvalidValue;
  const Shape s{Sq, Skv, Hq, Hkv, causal, scale};
  const dim3 grid((Skv + BK - 1) / BK, Hkv, B);
  return with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return launch(flash_bwd_dkv_kernel<DD>, dkv_smem<DD>(), grid, stream,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v,
                  (const bf16*)dO, (const float*)lse, (const float*)delta,
                  (bf16*)dk, (bf16*)dv, s);
  });
}

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dO, const void* lse,
                                 const void* delta, void* dq, int B, int Sq,
                                 int Skv, int Hq, int Hkv, int D, int causal,
                                 float scale, void* stream) {
  if (!shape_ok(B, Sq, Skv, Hq, Hkv, D)) return (int)cudaErrorInvalidValue;
  const Shape s{Sq, Skv, Hq, Hkv, causal, scale};
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  return with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return launch(flash_bwd_dq_kernel<DD>, dq_smem<DD>(), grid, stream,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v,
                  (const bf16*)dO, (const float*)lse, (const float*)delta,
                  (bf16*)dq, s);
  });
}
