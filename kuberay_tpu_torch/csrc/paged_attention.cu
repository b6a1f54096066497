// One-token GQA decode attention straight from the paged KV pool, through
// each slot's block table.
//
// Replaces kuberay_tpu/ops/paged_attention.py::_paged_kernel (reached
// through paged_decode_attention_pallas).
//
//   q      [S, Hq, D]            bf16
//   pk, pv [Hkv, P, D]           bf16   (head-major pool, P = blocks * bs:
//                                        one page of one head is one
//                                        contiguous run of bs * D values)
//   tables [S, max_blocks]       int32  (physical block of each logical
//                                        block; entries past the live
//                                        length are never read)
//   lens   [S]                   int32
//   out    [S, Hq, D]            bf16   (0 where lens[s] == 0)
//
// Bound on an H100: bytes, as the dense decode kernel's.  The live K and
// V rows stream once: at 8 slots x 2048 positions, 8 kv heads of 128,
// 67.1 MB, about 20.0 us at 3.35 TB/s.  The table adds 4 B per live page.
//
// Design.  The TPU kernel resolves the indirection in its BlockSpec index
// map, from tables brought in by scalar prefetch.  Here each block, one per
// (slot, kv head) as in decode_attention.cu, loads its own table entries:
// for a tile of 64 live positions it writes the pool row of each position
// (tables[s, t / bs] * bs + t % bs) to shared memory, then stages the rows
// with 16-byte loads and runs the shared tile loop (decode_tile.cuh).  A
// tile may span several pages and any page size works; the last page is
// cut at lens[s], and pages and table entries past the live length are
// never read (they may name blocks of other requests).  Nothing is
// gathered into a per-request copy of the cache.

#include "decode_tile.cuh"

namespace {

using decode::TILE;
using bf16 = __nv_bfloat16;

template <int D, int G>
__global__ void __launch_bounds__(D)
paged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ pk,
                    const bf16* __restrict__ pv, const int* __restrict__ tables,
                    const int* __restrict__ lens, bf16* __restrict__ out,
                    int P, int max_blocks, int bs, int Hkv, float scale) {
  using Rows = decode::Rows<D, bf16>;
  __shared__ decode::Smem<D, G, bf16> sm;
  __shared__ int row_s[TILE];              // pool row of each tile position
  decode::Decoder<D, G, bf16, false> dec;

  const int slot = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const size_t head0 = ((size_t)slot * Hkv + h) * G;
  const int cap = max_blocks * bs;
  int len = lens[slot];
  len = len < 0 ? 0 : (len > cap ? cap : len);
  dec.init(q + head0 * D, sm);

  const bf16* kbase = pk + (size_t)h * P * D;
  const bf16* vbase = pv + (size_t)h * P * D;
  const int* table = tables + (size_t)slot * max_blocks;

  for (int t0 = 0; t0 < len; t0 += TILE) {
    const int n = min(TILE, len - t0);
    for (int r = tid; r < n; r += D) {
      const int t = t0 + r;
      row_s[r] = table[t / bs] * bs + t % bs;
    }
    __syncthreads();
    for (int c = tid; c < n * Rows::CH; c += D) {
      const int r = c / Rows::CH, col = (c % Rows::CH) * Rows::EPC;
      const size_t off = (size_t)row_s[r] * D + col;
      Rows::copy(sm.k, r, col, kbase + off);
      Rows::copy(sm.v, r, col, vbase + off);
    }
    __syncthreads();
    dec.attend(sm, n, scale);
  }
  dec.finish(out + head0 * D, sm, len);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head_dim / group size without an
// instantiation (head_dim 64 or 128; group 1, 2, 4 or 8) or a bad size.
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* pk, const void* pv, const void* tables,
    const void* lens, void* out, int S, int P, int max_blocks, int bs,
    int Hq, int Hkv, int D, float scale, void* stream) {
  if (S <= 0 || P <= 0 || max_blocks <= 0 || bs <= 0 || P % bs != 0 ||
      Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ok = decode::with_head_dim_and_group(
      D, Hq / Hkv, [&](auto d, auto g) {
        constexpr int DD = decltype(d)::value, GG = decltype(g)::value;
        paged_decode_kernel<DD, GG><<<S * Hkv, DD, 0, st>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(pk),
            static_cast<const bf16*>(pv), static_cast<const int*>(tables),
            static_cast<const int*>(lens), static_cast<bf16*>(out), P,
            max_blocks, bs, Hkv, scale);
      });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
