// Tiles and tensor-core fragments of the flash backward kernels
// (flash_attention.cu: dK/dV, dQ), and the shape checks and head-dim
// dispatch that every training attention kernel shares (the forward's
// Hopper main loop is attn_fwd_sm90.cuh).
//
// Every backward kernel runs one block of 4 warps (NT threads) over a
// 64-row tile; each warp owns 16 rows.  Tiles are staged in shared memory
// with 16-byte loads; the products run on the tensor cores through
// nvcuda::wmma bf16 16x16x16 fragments with f32 accumulators.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace attn {

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

// Head dims 64 and 128; GQA groups 1, 2, 4 and 8.
inline bool shape_ok(int B, int Sq, int Skv, int Hq, int Hkv, int D) {
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

}  // namespace attn
