// One-token GQA decode attention over a dense per-slot KV cache, bf16 or
// int8.
//
// Replaces kuberay_tpu/ops/decode_attention.py::_decode_kernel, both its
// forms: quant=False (decode_attention_pallas) and quant=True
// (decode_attention_quant_pallas).
//
//   q    [S, Hq, D]        bf16
//   bf16 cache:  ck, cv [S, M, Hkv, D] bf16
//   int8 cache:  kq, vq [S, M, Hkv, D] int8, ks, vs [S, Hkv, M] float32
//                (one absmax scale per slot, head and position; positions
//                on the last axis, the JAX package's layout)
//   lens [S]               int32  (live positions of each slot)
//   out  [S, Hq, D]        bf16   (0 where lens[s] == 0)
//
// Bound on an H100: bytes.  The live cache streams once per call: for
// bf16, sum_s lens[s] * Hkv * D * 2 B for each of K and V; at 8 slots x
// 2048 positions, 8 kv heads of 128, that is 67 MB, about 20 us at
// 3.35 TB/s.  The int8 cache moves half the payload plus 4 B of scale per
// position and head for each of K and V: 33.6 + 1.05 MB, about 10.3 us.
// The 4 * sum(lens) * Hq * D flops would take the tensor cores under
// 0.1 us.
//
// Design (decode_tile.cuh has the tile loop).  One block per (slot, kv
// head) walks only the slot's live positions, in tiles of 64 rows: the
// loop bound is lens[s], not M, which is the live-length skip the TPU
// kernel exists for; rows past lens[s] are never read, so a cache length
// that no tile divides needs no padding.  Rows are staged in shared memory
// with 16-byte loads (8 bf16 or 16 int8 values); the int8 kernel also
// stages the tile's key and value scales, folds the key scale into the
// score column and the value scale into the probability row after the
// row's sum, so no dequantised copy of the cache is written.  Split-K
// across blocks, cp.async/TMA pipelining and wgmma are not used.

#include "decode_tile.cuh"

namespace {

using decode::TILE;

template <int D, int G, typename KV, bool QUANT>
__global__ void __launch_bounds__(D)
dense_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const KV* __restrict__ ck, const KV* __restrict__ cv,
                    const float* __restrict__ ks, const float* __restrict__ vs,
                    const int* __restrict__ lens,
                    __nv_bfloat16* __restrict__ out, int M, int Hkv,
                    float scale) {
  using Rows = decode::Rows<D, KV>;
  __shared__ decode::Smem<D, G, KV> sm;
  decode::Decoder<D, G, KV, QUANT> dec;

  const int slot = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const size_t head0 = ((size_t)slot * Hkv + h) * G;   // first q head
  int len = lens[slot];
  len = len < 0 ? 0 : (len > M ? M : len);
  dec.init(q + head0 * D, sm);

  const size_t row_stride = (size_t)Hkv * D;          // elements per position
  const KV* kbase = ck + (size_t)slot * M * row_stride + (size_t)h * D;
  const KV* vbase = cv + (size_t)slot * M * row_stride + (size_t)h * D;
  const size_t sbase = ((size_t)slot * Hkv + h) * M;  // scales of (slot, h)

  for (int t0 = 0; t0 < len; t0 += TILE) {
    const int n = min(TILE, len - t0);
    for (int c = tid; c < n * Rows::CH; c += D) {
      const int r = c / Rows::CH, col = (c % Rows::CH) * Rows::EPC;
      const size_t off = (size_t)(t0 + r) * row_stride + col;
      Rows::copy(sm.k, r, col, kbase + off);
      Rows::copy(sm.v, r, col, vbase + off);
    }
    if constexpr (QUANT) {
      for (int r = tid; r < n; r += D) {
        sm.ks[r] = ks[sbase + t0 + r];
        sm.vs[r] = vs[sbase + t0 + r];
      }
    }
    __syncthreads();
    dec.attend(sm, n, scale);
  }
  dec.finish(out + head0 * D, sm, len);
}

template <typename KV, bool QUANT>
int launch(const void* q, const void* ck, const void* cv, const void* ks,
           const void* vs, const void* lens, void* out, int S, int M, int Hq,
           int Hkv, int D, float scale, void* stream) {
  if (S <= 0 || M <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ok = decode::with_head_dim_and_group(
      D, Hq / Hkv, [&](auto d, auto g) {
        constexpr int DD = decltype(d)::value, GG = decltype(g)::value;
        dense_decode_kernel<DD, GG, KV, QUANT><<<S * Hkv, DD, 0, st>>>(
            static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(ck),
            static_cast<const KV*>(cv), static_cast<const float*>(ks),
            static_cast<const float*>(vs), static_cast<const int*>(lens),
            static_cast<__nv_bfloat16*>(out), M, Hkv, scale);
      });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head_dim / group size without an
// instantiation (head_dim 64 or 128; group 1, 2, 4 or 8).
extern "C" int decode_attention_bf16(const void* q, const void* ck,
                                     const void* cv, const void* lens,
                                     void* out, int S, int M, int Hq, int Hkv,
                                     int D, float scale, void* stream) {
  return launch<__nv_bfloat16, false>(q, ck, cv, nullptr, nullptr, lens, out,
                                      S, M, Hq, Hkv, D, scale, stream);
}

extern "C" int decode_attention_int8(const void* q, const void* kq,
                                     const void* ks, const void* vq,
                                     const void* vs, const void* lens,
                                     void* out, int S, int M, int Hq, int Hkv,
                                     int D, float scale, void* stream) {
  return launch<int8_t, true>(q, kq, vq, ks, vs, lens, out, S, M, Hq, Hkv, D,
                              scale, stream);
}
