// The split loop and the merge shared by the one-token decode kernels
// (decode_attention.cu: dense bf16 and int8 caches; paged_attention.cu:
// the head-major block pool).  The kernels differ only in how a position's
// row is found (RowOf below); everything else lives here.
//
// Flash-decoding.  The TPU kernels walk a slot's KV blocks on a sequential
// grid axis and carry (m, l, acc) in scratch.  Here a slot's positions
// [0, cap) are cut into nsplit chunks of `chunk` positions (nsplit =
// ceil(cap / chunk), from the cache capacity the host knows, never from
// lens, which lives on the device).  One block of NW = 4 warps runs each
// (slot, kv head, split) and computes the G = Hq / Hkv query heads of the
// group together, so each K/V row is read from device memory once:
//   - a split that starts at or past lens[s] marks its partial empty
//     (m = -inf, l = 0) and exits;
//   - otherwise each warp streams its own 16-row slices of the chunk
//     (rows t0 + 16 w, t0 + 64 + 16 w, ...) through a 2-stage ring of
//     shared memory, filled by cp.async 16-byte copies (the int8 cache's
//     scales by 4-byte copies; rows past lens[s] are zero-filled, never
//     read), so the next slice's copy is in flight while the warp computes;
//   - per slice, WarpDecoder::attend computes the scores and P @ V on the
//     tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulators) and
//     updates the warp's online softmax (running max m and sum l per head,
//     float32); P is rounded to bf16 for the product, as the flash kernels
//     and the TPU kernel round it;
//   - the warps' (m, l, acc) are combined through shared memory and the
//     block writes its float32 partial (m, l, acc[G][D], acc unnormalised)
//     to the workspace.
// merge_kernel then combines the nsplit partials of each (slot, q head) in
// split order, weighting each by exp(m_i - max m): no atomics, so two
// calls on the same inputs give the same bits.  Empty partials (l == 0)
// are skipped; a slot of length 0 has only empty partials and gives
// exactly 0 (the TPU kernel's l == 0 guard).
//
// For the int8 cache (QUANT) the key scale ks[t] * scale multiplies score
// column t, and the probability p is added to l BEFORE it is multiplied by
// the value scale vs[t] for the P @ V product, as the TPU kernel folds
// them (kuberay_tpu/ops/decode_attention.py::_decode_kernel, quant=True);
// the merge's rescale applies to l and acc alike, so the fold survives it.
// int8 values convert to bf16 exactly; no dequantised row is written.
//
// Workspace (float32, allocated by the wrapper with torch.empty; every
// value the merge reads is written first): acc [S * Hq, nsplit, D], then
// ml [S * Hq, nsplit, 2] holding (m, l).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace decode {

constexpr int ROWS = 16;          // rows of a warp's slice: one mma m-tile
constexpr int NW = 4;             // warps a block
constexpr int NT = NW * 32;       // threads a block
constexpr int STAGES = 2;         // depth of each warp's cp.async ring
constexpr int TILE = NW * ROWS;   // rows the block's warps take a round;
                                  // a chunk is a multiple of it
constexpr int HPAD = 8;           // heads of the mma's n: G padded to 8

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from src, or 16 zero bytes when !full (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c += a b: m16n8k16, bf16 inputs, float32 accumulator.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&r);
}
// The int8 stored as byte b, as a float: (2^23 + (b ^ 0x80)) - (2^23 +
// 128), exact, on the float pipe instead of the slower int-to-float
// converter.
__device__ __forceinline__ float i8_to_f32(uint32_t b) {
  return __uint_as_float(0x4B000000u | (b ^ 0x80u)) - 8388736.f;
}
// Two int8 values (the lower address in the low byte) as two bf16, exact.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t v) {
  return pack_bf16(i8_to_f32(v & 0xffu), i8_to_f32(v >> 8));
}

template <int D, typename KV>
struct Smem {
  // Bytes a staged row takes: padded by 16 so that the 8 rows an
  // ldmatrix reads start in 8 different groups of 4 banks.
  static constexpr int RS = D * (int)sizeof(KV) + 16;
  struct Stages {
    alignas(16) unsigned char k[NW][STAGES][ROWS][RS];
    alignas(16) unsigned char v[NW][STAGES][ROWS][RS];
  };
  struct Combine {                 // the warps' results, after the loop
    float o[NW][HPAD][D];
    float m[NW][HPAD], l[NW][HPAD];
  };
  union {
    Stages st;
    Combine cb;
  };
  float ks[NW][STAGES][ROWS], vs[NW][STAGES][ROWS];   // int8 scales
  alignas(16) __nv_bfloat16 pt[NW][HPAD][ROWS];       // P^T of a slice
};

// One warp's share of a split: it streams its own 16-row slices and
// keeps its own online softmax, with the tensor cores (mma.sync
// m16n8k16) doing both products.  Rows sit on the mma's m, the G heads
// of the group (padded to 8) on its n:
//   S^T [16 rows x 8 heads] = K [16 x D] . Q^T [D x 8]   (D / 16 k-steps)
//   O^T [D x 8 heads]      += V^T [D x 16] . P^T [16 x 8] (D / 16 m-tiles)
// Lane (g = lane / 4, t = lane % 4) holds rows g and g + 8 of S^T, and
// columns g and g + 8 of each 16-column m-tile of O^T, both for heads 2t
// and 2t + 1, so the rescale by exp(m_old - m_new) stays in the lane.  P
// goes through shared memory (bf16, [head][row]) to become the B operand.
template <int D, int G, typename KV, bool QUANT>
struct WarpDecoder {
  static constexpr int KS = D / 16;  // k-steps of S, m-tiles of O
  static constexpr int RS = Smem<D, KV>::RS;
  uint32_t qb[KS][2];   // Q^T as B fragments (heads >= G are 0)
  float o[KS][4];       // O^T accumulators
  float m[2], l[2];     // heads 2t, 2t + 1: running max (warp-uniform) and
                        // this lane's rows' share of the sum

  // q points at the group's first head: G rows of D bf16 values.
  __device__ __forceinline__ void init(const __nv_bfloat16* q) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const __nv_bfloat16* qr = q + g * D + i * 16 + 2 * t;
      qb[i][0] = g < G ? *reinterpret_cast<const uint32_t*>(qr) : 0u;
      qb[i][1] = g < G ? *reinterpret_cast<const uint32_t*>(qr + 8) : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
    }
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  // K as the A operand of k-step i: rows 0-15, columns 16i .. 16i + 15.
  __device__ __forceinline__ void load_k(uint32_t (&a)[4],
                                         const unsigned char* ks_, int i) {
    const int lane = threadIdx.x % 32;
    if constexpr (std::is_same<KV, int8_t>::value) {
      const int g = lane / 4, t = lane % 4, c = i * 16 + 2 * t;
      auto at = [&](int r, int col) {
        return i8x2_to_bf16x2(
            *reinterpret_cast<const uint16_t*>(ks_ + r * RS + col));
      };
      a[0] = at(g, c);
      a[1] = at(g + 8, c);
      a[2] = at(g, c + 8);
      a[3] = at(g + 8, c + 8);
    } else {
      const int mi = lane / 8, r = lane % 8;
      ldmatrix_x4(a, ks_ + (r + (mi & 1) * 8) * RS +
                         (i * 16 + (mi >> 1) * 8) * 2);
    }
  }

  // V^T as the A operand of m-tile i: columns 16i .. 16i + 15 of V (the
  // mma's m), rows 0-15 (its k).
  __device__ __forceinline__ void load_vt(uint32_t (&a)[4],
                                          const unsigned char* vs_, int i) {
    const int lane = threadIdx.x % 32;
    if constexpr (std::is_same<KV, int8_t>::value) {
      const int g = lane / 4, t = lane % 4, c = i * 16 + g;
      auto at = [&](int r, int col) {
        return pack_bf16(i8_to_f32(vs_[r * RS + col]),
                         i8_to_f32(vs_[(r + 1) * RS + col]));
      };
      a[0] = at(2 * t, c);
      a[1] = at(2 * t, c + 8);
      a[2] = at(2 * t + 8, c);
      a[3] = at(2 * t + 8, c + 8);
    } else {
      const int mi = lane / 8, r = lane % 8;
      ldmatrix_x4_trans(a, vs_ + (r + (mi >> 1) * 8) * RS +
                               (i * 16 + (mi & 1) * 8) * 2);
    }
  }

  // One staged slice of n live rows (rows n..15 are zeros).  ksc/vsc are
  // its int8 scales; pt the warp's P^T buffer.
  __device__ __forceinline__ void attend(const unsigned char* kst,
                                         const unsigned char* vst,
                                         const float* ksc, const float* vsc,
                                         __nv_bfloat16 (*pt)[ROWS], int n,
                                         float scale) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      uint32_t a[4];
      load_k(a, kst, i);
      mma(s, a, qb[i][0], qb[i][1]);
    }
    const float sc0 = QUANT ? scale * ksc[g] : scale;
    const float sc1 = QUANT ? scale * ksc[g + 8] : scale;
    // s[0], s[1]: row g, heads 2t, 2t + 1; s[2], s[3]: row g + 8.
    s[0] = g < n ? s[0] * sc0 : -INFINITY;
    s[1] = g < n ? s[1] * sc0 : -INFINITY;
    s[2] = g + 8 < n ? s[2] * sc1 : -INFINITY;
    s[3] = g + 8 < n ? s[3] * sc1 : -INFINITY;
    float mx0 = fmaxf(s[0], s[2]), mx1 = fmaxf(s[1], s[3]);
#pragma unroll
    for (int o_ = 4; o_ < 32; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    // Row 0 of a slice is live, so the new maxima are finite.
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float c0 = __expf(m[0] - mn0), c1 = __expf(m[1] - mn1);
    m[0] = mn0;
    m[1] = mn1;
    float p0 = __expf(s[0] - mn0), p1 = __expf(s[1] - mn1);
    float p2 = __expf(s[2] - mn0), p3 = __expf(s[3] - mn1);
    l[0] = l[0] * c0 + p0 + p2;        // l sums p unscaled ...
    l[1] = l[1] * c1 + p1 + p3;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      o[i][0] *= c0;
      o[i][1] *= c1;
      o[i][2] *= c0;
      o[i][3] *= c1;
    }
    if constexpr (QUANT) {             // ... P @ V takes p * vs
      p0 *= vsc[g];
      p1 *= vsc[g];
      p2 *= vsc[g + 8];
      p3 *= vsc[g + 8];
    }
    __syncwarp();                      // the last slice's reads are done
    pt[2 * t][g] = __float2bfloat16(p0);
    pt[2 * t + 1][g] = __float2bfloat16(p1);
    pt[2 * t][g + 8] = __float2bfloat16(p2);
    pt[2 * t + 1][g + 8] = __float2bfloat16(p3);
    __syncwarp();
    // P^T as the B operand: rows 2t, 2t + 1 (and + 8) of head g.
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&pt[g][2 * t]);
    const uint32_t b1 =
        *reinterpret_cast<const uint32_t*>(&pt[g][2 * t + 8]);
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      uint32_t a[4];
      load_vt(a, vst, i);
      mma(o[i], a, b0, b1);
    }
  }

  // The warp's sum over its lanes' rows, then its results into the
  // block's Combine area (which the caller has made free).
  __device__ __forceinline__ void store(typename Smem<D, KV>::Combine& cb,
                                        int w) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int o_ = 4; o_ < 32; o_ <<= 1) {
      l[0] += __shfl_xor_sync(0xffffffffu, l[0], o_);
      l[1] += __shfl_xor_sync(0xffffffffu, l[1], o_);
    }
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      cb.o[w][2 * t][i * 16 + g] = o[i][0];
      cb.o[w][2 * t + 1][i * 16 + g] = o[i][1];
      cb.o[w][2 * t][i * 16 + g + 8] = o[i][2];
      cb.o[w][2 * t + 1][i * 16 + g + 8] = o[i][3];
    }
    if (g == 0) {
      cb.m[w][2 * t] = m[0];
      cb.m[w][2 * t + 1] = m[1];
      cb.l[w][2 * t] = l[0];
      cb.l[w][2 * t + 1] = l[1];
    }
  }
};

// The (slot, kv head, split) a block runs, from blockIdx.x = (slot * Hkv +
// h) * nsplit + split, and where its partials go.
struct Split {
  int slot, h, split;
  size_t row0;          // (slot * Hkv + h) * G: its first (slot, q head)
  __device__ Split(int Hkv, int nsplit, int G) {
    split = blockIdx.x % nsplit;
    const int sh = blockIdx.x / nsplit;
    slot = sh / Hkv;
    h = sh % Hkv;
    row0 = (size_t)sh * G;
  }
};

// One block's split: positions [t0, t1) of its slot, t1 <= lens[s].
// row(t) is the element offset of position t's K (and V) row from kbase
// (vbase); ks/vs (QUANT only) point at the scales of (slot, kv head),
// indexed by position.  Marks the partial empty when t0 >= t1.  Warp w
// takes the slices that start at t0 + (j * NW + w) * ROWS, j = 0, 1, ...,
// through a ring of STAGES stages of its own: the copy of slice j + 2
// starts as soon as slice j is done, so copies stay in flight while the
// warp computes, and no barrier joins the warps until the end.
template <int D, int G, typename KV, bool QUANT, typename RowOf>
__device__ __forceinline__ void split_attend(
    Smem<D, KV>& sm, const __nv_bfloat16* q, const KV* kbase,
    const KV* vbase, const float* ks, const float* vs, RowOf row, int t0,
    int t1, float scale, const Split& sp, int nsplit, float* ws_acc,
    float* ws_ml) {
  constexpr int EPC = 16 / sizeof(KV);   // elements per 16-byte chunk
  constexpr int CH = D / EPC;            // chunks per row
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  if (t0 >= t1) {                        // nothing live: an empty partial
    if (tid < G) {
      float* ml = ws_ml + ((sp.row0 + tid) * nsplit + sp.split) * 2;
      ml[0] = -INFINITY;
      ml[1] = 0.f;
    }
    return;
  }
  WarpDecoder<D, G, KV, QUANT> dec;
  dec.init(q + sp.row0 * D);
  const int first = t0 + w * ROWS;
  const int nslices = first < t1 ? (t1 - first + TILE - 1) / TILE : 0;

  auto issue = [&](int j) {
    const int base = first + j * TILE, st = j % STAGES;
    const int n = min(ROWS, t1 - base);
    for (int c = lane; c < ROWS * CH; c += 32) {
      const int r = c / CH, col = (c % CH) * EPC;
      const bool live = r < n;
      const size_t off = live ? row(base + r) + col : 0;
      cp_async16(&sm.st.k[w][st][r][col * sizeof(KV)], kbase + off, live);
      cp_async16(&sm.st.v[w][st][r][col * sizeof(KV)], vbase + off, live);
    }
    if constexpr (QUANT) {
      const int r = lane % ROWS;
      const bool live = r < n;
      const float* src = lane < ROWS ? ks : vs;
      float* dst = lane < ROWS ? &sm.ks[w][st][r] : &sm.vs[w][st][r];
      cp_async4(dst, src + (live ? base + r : 0), live);
    }
  };

#pragma unroll
  for (int j = 0; j < STAGES; ++j) {
    if (j < nslices) issue(j);
    cp_async_commit();                   // empty groups keep the count
  }
  for (int j = 0; j < nslices; ++j) {
    const int st = j % STAGES;
    cp_async_wait<STAGES - 1>();         // slice j has landed (this lane)
    __syncwarp();                        // ... and every lane's copies
    dec.attend(sm.st.k[w][st][0], sm.st.v[w][st][0], sm.ks[w][st],
               sm.vs[w][st], sm.pt[w],
               min(ROWS, t1 - first - j * TILE), scale);
    __syncwarp();                        // the stage is read
    if (j + STAGES < nslices) issue(j + STAGES);
    cp_async_commit();
  }

  __syncthreads();                       // every warp is off the stages
  dec.store(sm.cb, w);
  __syncthreads();
  // Combine the warps (warp 0 has rows, so the max is finite; a warp
  // without rows has m = -inf, l = 0, o = 0 and adds nothing).
  for (int idx = tid; idx < G * D; idx += NT) {
    const int h = idx / D, c = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int v = 0; v < NW; ++v) mx = fmaxf(mx, sm.cb.m[v][h]);
    float acc = 0.f, l = 0.f;
#pragma unroll
    for (int v = 0; v < NW; ++v) {
      const float wgt = __expf(sm.cb.m[v][h] - mx);
      acc += wgt * sm.cb.o[v][h][c];
      l += wgt * sm.cb.l[v][h];
    }
    const size_t i = (sp.row0 + h) * nsplit + sp.split;
    ws_acc[i * D + c] = acc;
    if (c == 0) {
      ws_ml[i * 2] = mx;
      ws_ml[i * 2 + 1] = l;
    }
  }
}

// One block of D threads per (slot, q head): combines its nsplit partials
// in split order.  out[row][tid] = sum_i w_i acc_i / sum_i w_i l_i with
// w_i = exp(m_i - max m), over the partials with l_i > 0; 0 if none.  The
// (m, l) pairs are staged in shared memory (2 * nsplit floats, dynamic)
// first, so the loop over splits waits on no global load but acc's.
template <int D>
__global__ void __launch_bounds__(D)
merge_kernel(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
             __nv_bfloat16* __restrict__ out, int nsplit) {
  extern __shared__ float ml[];
  const size_t row = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * nsplit; i += D)
    ml[i] = ws_ml[row * nsplit * 2 + i];
  __syncthreads();
  float mx = -INFINITY;
  for (int i = 0; i < nsplit; ++i)
    if (ml[2 * i + 1] > 0.f) mx = fmaxf(mx, ml[2 * i]);
  float l = 0.f, o = 0.f;
  const float* acc = ws_acc + row * nsplit * D + tid;
#pragma unroll 4
  for (int i = 0; i < nsplit; ++i) {
    const float li = ml[2 * i + 1];
    if (li > 0.f) {
      const float w = __expf(ml[2 * i] - mx);
      l += w * li;
      o += w * acc[(size_t)i * D];
    }
  }
  out[row * D + tid] = __float2bfloat16(l > 0.f ? o / l : 0.f);
}

// The checks every entry point makes on the split plan: a chunk that is a
// positive multiple of TILE and nsplit = ceil(cap / chunk), at most
// MAX_SPLITS (the merge stages 2 * nsplit floats in shared memory).
constexpr int MAX_SPLITS = 4096;
inline bool plan_ok(int cap, int chunk, int nsplit) {
  return cap > 0 && chunk > 0 && chunk % TILE == 0 &&
         nsplit == (cap + chunk - 1) / chunk && nsplit <= MAX_SPLITS;
}

constexpr int MAX_DEVICES = 64;

// Sets the kernel's dynamic shared memory limit to `bytes` the first time
// it is asked on the current device (`set`: one flag a device, owned by
// the caller's instantiation), so that a decode step's calls pay for it
// once; returns the cudaError.
template <typename... P>
int allow_smem(void (*kernel)(P...), int bytes, bool (&set)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES && set[dev]) return 0;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) set[dev] = true;
  return (int)e;
}

// Shared memory a block of the kernel holds, static and dynamic, as the
// runtime reports it (the dynamic part once allow_smem has run).
template <typename... P>
int smem_bytes(void (*kernel)(P...)) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return -(int)e;
  return (int)(a.sharedSizeBytes + a.maxDynamicSharedSizeBytes);
}

// Launches the merge after a split kernel: rows = S * Hq blocks of D
// threads.  Returns cudaGetLastError() after it.
inline int launch_merge(const float* ws, __nv_bfloat16* out, int rows,
                        int nsplit, int D, cudaStream_t st) {
  const float* ws_ml = ws + (size_t)rows * nsplit * D;
  const size_t smem = 2 * sizeof(float) * nsplit;
  if (D == 128)
    merge_kernel<128><<<rows, 128, smem, st>>>(ws, ws_ml, out, nsplit);
  else if (D == 64)
    merge_kernel<64><<<rows, 64, smem, st>>>(ws, ws_ml, out, nsplit);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

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
