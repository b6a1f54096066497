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
//   ws                           float32 workspace, S * Hq * nsplit * (D + 2)
//   out    [S, Hq, D]            bf16   (0 where lens[s] == 0)
//
// Bound on an H100: bytes, as the dense decode kernel's.  The live K and
// V rows stream once: at 8 slots, lens 0..2048 (5242 live positions), 8 kv
// heads of 128, 21.5 MB, 6.4 us at 3.35 TB/s.  The table adds 4 B per live
// page; the split partials' float32 write and read add 0.80 MB, as in
// decode_attention.cu.
//
// Design.  The TPU kernel resolves the indirection in its BlockSpec index
// map, from tables brought in by scalar prefetch.  Here the split loop of
// decode_attention.cu (decode_tile.cuh: a block per (slot, kv head,
// split), each warp's 16-row slices through a 2-stage cp.async ring, the
// tensor cores, the merge kernel) runs with a row address that goes
// through the table: each 16-byte copy of position t reads
// tables[s, t / bs] and copies from pool row tables[s, t / bs] * bs + t %
// bs.  A page of 16 rows of one head is one contiguous 4 KB run, so
// neighbouring lanes copy neighbouring bytes.  A slice may span several
// pages and any page size works; the last page is cut at lens[s], and
// pages and table entries past the live length are never read (they may
// name blocks of other requests).  Nothing is gathered into a per-request
// copy of the cache.

#include "decode_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <int D, int G>
__global__ void __launch_bounds__(decode::NT)
paged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ pk,
                    const bf16* __restrict__ pv, const int* __restrict__ tables,
                    const int* __restrict__ lens, float* __restrict__ ws_acc,
                    float* __restrict__ ws_ml, int P, int max_blocks, int bs,
                    int Hkv, int chunk, int nsplit, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<decode::Smem<D, bf16>*>(smem_raw);
  const decode::Split sp(Hkv, nsplit, G);
  const int cap = max_blocks * bs;
  int len = lens[sp.slot];
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int t0 = sp.split * chunk;
  const int t1 = min(t0 + chunk, len);

  const size_t head = (size_t)sp.h * P * D;
  const int* table = tables + (size_t)sp.slot * max_blocks;
  decode::split_attend<D, G, bf16, false>(
      sm, q, pk + head, pv + head, nullptr, nullptr,
      [table, bs](int t) {
        return ((size_t)table[t / bs] * bs + t % bs) * D;
      },
      t0, t1, scale, sp, nsplit, ws_acc, ws_ml);
}

}  // namespace

// Returns cudaGetLastError() after the split kernel and after the merge
// (0 = both launched), or cudaErrorInvalidValue for a head_dim / group
// size without an instantiation (head_dim 64 or 128; group 1, 2, 4 or 8),
// a bad size, or a split plan other than a chunk that is a positive
// multiple of 64 with nsplit = ceil(max_blocks * bs / chunk) <= 4096.
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* pk, const void* pv, const void* tables,
    const void* lens, void* out, void* ws, int S, int P, int max_blocks,
    int bs, int Hq, int Hkv, int D, int chunk, int nsplit, float scale,
    void* stream) {
  if (S <= 0 || P <= 0 || max_blocks <= 0 || bs <= 0 || P % bs != 0 ||
      Hkv <= 0 || Hq % Hkv != 0 ||
      !decode::plan_ok(max_blocks * bs, chunk, nsplit))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws_acc = static_cast<float*>(ws);
  float* ws_ml = ws_acc + (size_t)S * Hq * nsplit * D;
  int err = 0;
  const bool ok = decode::with_head_dim_and_group(
      D, Hq / Hkv, [&](auto d, auto g) {
        constexpr int DD = decltype(d)::value, GG = decltype(g)::value;
        constexpr int smem = sizeof(decode::Smem<DD, bf16>);
        static bool set[decode::MAX_DEVICES] = {};
        err = decode::allow_smem(paged_decode_kernel<DD, GG>, smem, set);
        if (err) return;
        paged_decode_kernel<DD, GG>
            <<<S * Hkv * nsplit, decode::NT, smem, st>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(pk),
            static_cast<const bf16*>(pv), static_cast<const int*>(tables),
            static_cast<const int*>(lens), ws_acc, ws_ml, P, max_blocks, bs,
            Hkv, chunk, nsplit, scale);
        err = (int)cudaGetLastError();
      });
  if (!ok) return (int)cudaErrorInvalidValue;
  if (err) return err;
  return decode::launch_merge(ws_acc, static_cast<bf16*>(out), S * Hq,
                              nsplit, D, st);
}

// Shared memory a block of the split kernel holds at (D, G), as the
// runtime reports it once that instantiation has launched; -1 for a pair
// without one.
extern "C" int paged_decode_attention_smem_bytes(int D, int G) {
  int got = -1;
  decode::with_head_dim_and_group(D, G, [&](auto d, auto g) {
    got = decode::smem_bytes(
        paged_decode_kernel<decltype(d)::value, decltype(g)::value>);
  });
  return got;
}
