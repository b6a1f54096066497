// One-token GQA decode attention over a dense per-slot bf16 KV cache.
//
// Replaces kuberay_tpu/ops/decode_attention.py::_decode_kernel (quant=False,
// reached through decode_attention_pallas).
//
//   q    [S, Hq, D]        bf16
//   ck   [S, M, Hkv, D]    bf16   (cache keys; rows >= lens[s] are stale)
//   cv   [S, M, Hkv, D]    bf16
//   lens [S]               int32  (live positions of each slot)
//   out  [S, Hq, D]        bf16   (0 where lens[s] == 0)
//
// Bound on an H100: bytes.  The live cache, sum_s lens[s] * Hkv * D * 2 B
// for each of K and V, streams once per call; at 8 slots x 2048 positions,
// 8 kv heads of 128, that is 67 MB, about 20 us at 3.35 TB/s, against
// 4 * sum(lens) * Hq * D flops that the tensor cores would finish in under
// 0.1 us.
//
// Design.  One block per (slot, kv head); its G = Hq / Hkv query heads are
// computed together so each K/V row is read from device memory once.  The
// block walks only the slot's live positions, in tiles of TILE rows (the
// loop bound is lens[s], not M: the live-length skip that is the point of
// the TPU kernel).  Each tile's K and V rows are staged in shared memory
// with 16-byte loads; one warp per position computes the G scores with a
// shuffle reduction; the online softmax keeps a running max and sum per
// head in float32; each thread owns one of the D output columns and keeps
// its G float32 accumulators in registers.  Rows past lens[s] are never
// read, so a cache length that no tile divides needs no padding.
// Split-K across blocks, cp.async/TMA pipelining and wgmma are not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;

template <int D, int G>
__global__ void __launch_bounds__(D)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ ck,
                        const __nv_bfloat16* __restrict__ cv,
                        const int* __restrict__ lens,
                        __nv_bfloat16* __restrict__ out,
                        int M, int Hkv, float scale) {
  constexpr int NT = D;              // threads: one per output column
  constexpr int NW = NT / 32;        // warps
  constexpr int DL = D / 32;         // columns per lane in the score dot
  constexpr int CH = D / 8;          // 16-byte chunks per row

  __shared__ __align__(16) __nv_bfloat16 k_s[TILE][D];
  __shared__ __align__(16) __nv_bfloat16 v_s[TILE][D];
  __shared__ float p_s[G][TILE];
  __shared__ float m_s[G], l_s[G], corr_s[G];

  const int slot = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int Hq = Hkv * G;

  int len = lens[slot];
  len = len < 0 ? 0 : (len > M ? M : len);

  // This lane's slice of every query head of the group, in float32.
  float qr[G][DL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const __nv_bfloat16* qp =
        q + ((size_t)slot * Hq + (size_t)h * G + g) * D + lane * DL;
#pragma unroll
    for (int i = 0; i < DL; ++i) qr[g][i] = __bfloat162float(qp[i]);
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  const size_t row_stride = (size_t)Hkv * D;          // elements per position
  const __nv_bfloat16* kbase = ck + (size_t)slot * M * row_stride + (size_t)h * D;
  const __nv_bfloat16* vbase = cv + (size_t)slot * M * row_stride + (size_t)h * D;

  for (int t0 = 0; t0 < len; t0 += TILE) {
    const int n = min(TILE, len - t0);
    // Stage the tile's live K/V rows, 16 bytes a load.
    for (int c = tid; c < n * CH; c += NT) {
      const int r = c / CH, col = (c % CH) * 8;
      const size_t off = (size_t)(t0 + r) * row_stride + col;
      *reinterpret_cast<uint4*>(&k_s[r][col]) =
          *reinterpret_cast<const uint4*>(kbase + off);
      *reinterpret_cast<uint4*>(&v_s[r][col]) =
          *reinterpret_cast<const uint4*>(vbase + off);
    }
    __syncthreads();

    // Scores: one warp per position, lanes split the head dimension.
    for (int r = warp; r < n; r += NW) {
      float kf[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) kf[i] = __bfloat162float(k_s[r][lane * DL + i]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DL; ++i) part += qr[g][i] * kf[i];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        if (lane == 0) p_s[g][r] = part * scale;
      }
    }
    __syncthreads();

    // Online softmax: one warp per head.
    for (int g = warp; g < G; g += NW) {
      float mx = -INFINITY;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, p_s[g][r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float p = __expf(p_s[g][r] - m_new);
        p_s[g][r] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float corr = __expf(m_old - m_new);   // 0 on the first tile
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P @ V: thread tid owns output column tid for every head of the group.
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= corr_s[g];
    for (int r = 0; r < n; ++r) {
      const float v = __bfloat162float(v_s[r][tid]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += p_s[g][r] * v;
    }
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float l = len > 0 ? l_s[g] : 0.f;
    const float o = l > 0.f ? acc[g] / l : 0.f;
    out[((size_t)slot * Hq + (size_t)h * G + g) * D + tid] = __float2bfloat16(o);
  }
}

template <int D, int G>
void launch(const void* q, const void* ck, const void* cv, const void* lens,
            void* out, int S, int M, int Hkv, float scale, cudaStream_t stream) {
  decode_attention_kernel<D, G><<<S * Hkv, D, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(ck),
      static_cast<const __nv_bfloat16*>(cv), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), M, Hkv, scale);
}

template <int D>
bool launch_group(int G, const void* q, const void* ck, const void* cv,
                  const void* lens, void* out, int S, int M, int Hkv,
                  float scale, cudaStream_t stream) {
  switch (G) {
    case 1: launch<D, 1>(q, ck, cv, lens, out, S, M, Hkv, scale, stream); return true;
    case 2: launch<D, 2>(q, ck, cv, lens, out, S, M, Hkv, scale, stream); return true;
    case 4: launch<D, 4>(q, ck, cv, lens, out, S, M, Hkv, scale, stream); return true;
    case 8: launch<D, 8>(q, ck, cv, lens, out, S, M, Hkv, scale, stream); return true;
    default: return false;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head_dim / group size without an
// instantiation (head_dim 64 or 128; group 1, 2, 4 or 8).
extern "C" int decode_attention_bf16(const void* q, const void* ck,
                                     const void* cv, const void* lens,
                                     void* out, int S, int M, int Hq, int Hkv,
                                     int D, float scale, void* stream) {
  if (S <= 0 || M <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok;
  if (D == 128)
    ok = launch_group<128>(G, q, ck, cv, lens, out, S, M, Hkv, scale, st);
  else if (D == 64)
    ok = launch_group<64>(G, q, ck, cv, lens, out, S, M, Hkv, scale, st);
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
