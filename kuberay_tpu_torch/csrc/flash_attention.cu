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
// Design.
// - forward: the Hopper main loop of attn_fwd_sm90.cuh (TMA into a 2-stage
//   K/V ring guarded by mbarriers, a producer warpgroup and two consumer
//   warpgroups running wgmma with S, P and O in registers), one block per
//   (128-row q tile, q head, batch), the longest causal tiles first; its
//   epilogue here normalises O in registers and writes out and lse.  The
//   tensor maps over q, k, v are built on the host at every call.
// - backward: one block of 4 warps over a 64-row tile; each warp owns 16
//   rows.  The TPU kernels' sequential kv (or q) grid axis, with its VMEM
//   accumulators, becomes a loop inside the block.  Tiles are staged in
//   shared memory with 16-byte loads; the products run on the tensor cores
//   through nvcuda::wmma bf16 16x16x16 fragments with f32 accumulators
//   (attn_tile.cuh); the dS arithmetic runs on f32 rows in shared memory.
//   Causal tiles that see nothing are skipped by the loop bounds.
//   - dK/dV: one block per (kv tile, kv head, batch); it loops over the
//     group's q heads and the q tiles that see the tile, so dK and dV
//     accumulate in f32 once per kv head and are written once (the TPU path
//     wrote per-q-head f32 [B, Hq, Skv, D] buffers and summed the group).
//   - dQ: one block per (q tile, q head, batch); it loops over the visible
//     kv tiles.
//   Not used yet in the backward: wgmma, TMA, warp specialisation.

#include "attn_fwd_sm90.cuh"
#include "attn_tile.cuh"

using namespace attn;

namespace {

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

// The forward's prologue and epilogue on the register fragment: the state
// starts empty; out = O / l (l == 0 -> 1) in bf16 and lse = m + log l.
template <int D>
struct FwdOut {
  bf16* o;
  float* lse;
  int Sq, Hq, h, b;

  __device__ __forceinline__ void init(float (&acc)[D / 2], float (&m)[2],
                                       float (&l)[2], const fwd90::Frag&) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    m[0] = m[1] = fwd90::NEG;
    l[0] = l[1] = 0.f;
  }

  __device__ __forceinline__ void finish(const float (&acc)[D / 2],
                                         const float (&m)[2],
                                         const float (&l)[2],
                                         const fwd90::Frag& f) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = f.rows[r];
      if (row >= Sq) continue;
      const float lr = l[r] == 0.f ? 1.f : l[r];
      const float inv = 1.f / lr;
      bf16* op = o + ((size_t)(b * Sq + row) * Hq + h) * D + 2 * f.c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(op + 8 * j) = fwd90::pack_bf16(
            acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      if (f.c == 0) lse[((size_t)b * Hq + h) * Sq + row] = m[r] + logf(lr);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(fwd90::NT, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qm,
                 const __grid_constant__ CUtensorMap km,
                 const __grid_constant__ CUtensorMap vm, bf16* __restrict__ o,
                 float* __restrict__ lse, fwd90::Tile t) {
  const int q0 = fwd90::block_q0(), h = blockIdx.x, b = blockIdx.y;
  FwdOut<D> epi{o, lse, t.Sq, t.Hq, h, b};
  fwd90::fwd_block<D>(qm, km, vm, t, q0, h, b, fwd90::kv_tiles(t, q0), epi);
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

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 =
// launched), or cudaErrorInvalidValue for a shape without an instantiation
// (head_dim 64 or 128; group 1, 2, 4 or 8) or, for the forward, tensor
// maps cuTensorMapEncodeTiled refuses.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Sq, int Skv,
                              int Hq, int Hkv, int D, int causal, float scale,
                              void* stream) {
  fwd90::Maps maps;
  if (!shape_ok(B, Sq, Skv, Hq, Hkv, D) ||
      !fwd90::make_maps(&maps, q, k, v, B, Sq, Skv, Hq, Hkv, D))
    return (int)cudaErrorInvalidValue;
  const fwd90::Tile t{Sq, Skv, Hq, Hkv, causal, Skv - Sq, scale};
  return with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return fwd90::launch<DD>(flash_fwd_kernel<DD>, fwd90::grid(B, Sq, Hq),
                             stream, maps.q, maps.k, maps.v, (bf16*)o,
                             (float*)lse, t);
  });
}

// The forward kernel's shared memory a block at head dim D (64 or 128), as
// the runtime holds it after a launch at D; -1 for another D.
extern "C" int flash_fwd_smem_bytes(int D) {
  if (D != 64 && D != 128) return -1;
  return with_head_dim(D, [](auto d) {
    return fwd90::smem_bytes(flash_fwd_kernel<decltype(d)::value>);
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
