// The tile loop shared by the one-token decode kernels
// (decode_attention.cu: dense bf16 and int8 caches; paged_attention.cu:
// the head-major block pool).
//
// Each kernel runs one block of D threads per (slot, kv head) and computes
// the G = Hq / Hkv query heads of the group together, so each K/V row is
// read from device memory once.  It walks the slot's live positions in
// tiles of TILE rows: it stages a tile's K and V rows (and, for the int8
// cache, their per-position scales) in shared memory, then calls
// Decoder::attend, which
//   - computes the G scores of each row (one warp per row, lanes split the
//     head dimension, a shuffle reduction),
//   - updates the online softmax (one warp per head: running max m and
//     sum l in float32),
//   - accumulates P @ V (thread tid owns output column tid of every head
//     of the group, in float32 registers).
// For the int8 cache (QUANT) the key scale ks[t] * scale multiplies score
// column t, and the probability p is added to l BEFORE it is multiplied by
// the value scale vs[t] for the P @ V product, as the TPU kernel folds
// them (kuberay_tpu/ops/decode_attention.py::_decode_kernel, quant=True).
// int8 values convert to float exactly; no dequantised row is ever
// written.  A slot of length 0 gives 0 (the TPU kernel's l == 0 guard).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace decode {

constexpr int TILE = 64;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <int D, int G, typename KV>
struct Smem {
  alignas(16) KV k[TILE][D];
  alignas(16) KV v[TILE][D];
  float ks[TILE], vs[TILE];          // per-position scales (int8 only)
  float p[G][TILE];
  float m[G], l[G], corr[G];
};

// Copy chunk c (16 bytes) of a tile's rows: row c / CH, column block c % CH.
template <int D, typename KV>
struct Rows {
  static constexpr int EPC = 16 / sizeof(KV);    // elements per chunk
  static constexpr int CH = D / EPC;             // chunks per row
  __device__ __forceinline__ static void copy(KV (*dst)[D], int r, int col,
                                              const KV* src) {
    *reinterpret_cast<uint4*>(&dst[r][col]) =
        *reinterpret_cast<const uint4*>(src);
  }
};

template <int D, int G, typename KV, bool QUANT>
struct Decoder {
  static constexpr int NT = D;        // threads: one per output column
  static constexpr int NW = NT / 32;  // warps
  static constexpr int DL = D / 32;   // columns per lane in the score dot

  float qr[G][DL];                    // this lane's slice of each q head
  float acc[G];                       // output column tid of each head

  // q points at the group's first head: G rows of D bf16 values.
  __device__ __forceinline__ void init(const __nv_bfloat16* q,
                                       Smem<D, G, KV>& sm) {
    const int tid = threadIdx.x, lane = tid % 32;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < DL; ++i)
        qr[g][i] = __bfloat162float(q[g * D + lane * DL + i]);
      acc[g] = 0.f;
    }
    if (tid < G) {
      sm.m[tid] = -INFINITY;
      sm.l[tid] = 0.f;
    }
  }

  // The caller has staged n rows (and their scales) and synchronised.
  // Ends synchronised, so the caller may stage the next tile.
  __device__ __forceinline__ void attend(Smem<D, G, KV>& sm, int n,
                                         float scale) {
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < n; r += NW) {
      float kf[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) kf[i] = to_f32(sm.k[r][lane * DL + i]);
      const float sc = QUANT ? scale * sm.ks[r] : scale;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DL; ++i) part += qr[g][i] * kf[i];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if (lane == 0) sm.p[g][r] = part * sc;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += NW) {
      float mx = -INFINITY;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, sm.p[g][r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sm.m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float p = __expf(sm.p[g][r] - m_new);
        sum += p;                                  // l sums p unscaled ...
        sm.p[g][r] = QUANT ? p * sm.vs[r] : p;     // ... P @ V takes p * vs
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float corr = __expf(m_old - m_new);  // 0 on the first tile
        sm.corr[g] = corr;
        sm.l[g] = sm.l[g] * corr + sum;
        sm.m[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= sm.corr[g];
    for (int r = 0; r < n; ++r) {
      const float v = to_f32(sm.v[r][tid]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += sm.p[g][r] * v;
    }
    __syncthreads();
  }

  // out points at the group's first head.
  __device__ __forceinline__ void finish(__nv_bfloat16* out,
                                         const Smem<D, G, KV>& sm, int len) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float l = len > 0 ? sm.l[g] : 0.f;
      const float o = l > 0.f ? acc[g] / l : 0.f;
      out[g * D + threadIdx.x] = __float2bfloat16(o);
    }
  }
};

// Calls f(integral_constant<D>, integral_constant<G>) for head_dim 64 or
// 128 and group 1, 2, 4 or 8; false for any other pair.
template <int D, typename F>
bool with_group(int G, F& f) {
  using std::integral_constant;
  switch (G) {
    case 1: f(integral_constant<int, D>{}, integral_constant<int, 1>{}); return true;
    case 2: f(integral_constant<int, D>{}, integral_constant<int, 2>{}); return true;
    case 4: f(integral_constant<int, D>{}, integral_constant<int, 4>{}); return true;
    case 8: f(integral_constant<int, D>{}, integral_constant<int, 8>{}); return true;
    default: return false;
  }
}

template <typename F>
bool with_head_dim_and_group(int D, int G, F&& f) {
  if (D == 128) return with_group<128>(G, f);
  if (D == 64) return with_group<64>(G, f);
  return false;
}

}  // namespace decode
