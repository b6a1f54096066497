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
//   ws                     float32 workspace, S * Hq * nsplit * (D + 2)
//   out  [S, Hq, D]        bf16   (0 where lens[s] == 0)
//
// Bound on an H100: bytes.  The live cache streams once per call: for
// bf16, sum_s lens[s] * Hkv * D * 2 B for each of K and V; the int8 cache
// half that payload plus 4 B of scale per position and head for each of K
// and V.  At the serving shape (8 slots, M 2048, 8 kv heads of 128, lens
// 0..2048 with 5242 live positions) that is 21.5 MB bf16, 11.2 MB int8:
// 6.4 and 3.3 us at 3.35 TB/s.  The split partials add their float32 write
// and read, 2 * (D + 2) * 4 B per live (split, q head): 0.80 MB there at
// chunk 256 (0.24 us).  The 4 * sum(lens) * Hq * D flops take well under
// 0.1 us.
//
// Design (decode_tile.cuh has the loop and the merge).  The bound is
// bytes, so the kernel's job is to keep the memory busy.  The first design
// (one block per (slot, kv head) walking every live tile alone, with
// synchronous loads) ran as long as the longest slot, at 3-4% of the
// memory rate.  Now:
//   - flash-decoding: the grid is (slot, kv head, split), each split owning
//     `chunk` positions, and the merge kernel combines the float32 partials
//     in a fixed order (no atomics).  The split count comes from M, so a
//     CUDA graph captures the call and no lens value reaches the host; a
//     split past lens[s] exits at once.  The wrappers' chunk is 256: at the
//     serving shape (192 of the 512 blocks have live rows), on an H100
//     80GB HBM3 at 700 W, 3-12% faster than 128 for all three kernels;
//     512 was 7% faster for bf16 but 20-45% slower for int8 and paged
//     (a sweep of the chunk on the card; PERF.md's kernel table);
//   - each of a block's 4 warps streams its own 16-row slices through a
//     2-stage ring of cp.async.cg 16-byte copies, so copies stay in flight
//     while it computes and no block barrier stands in the loop; rows past
//     lens[s] are zero-filled, never read, so a cache length that no chunk
//     divides needs no padding;
//   - the scores and P @ V run on the tensor cores (mma.sync m16n8k16, the
//     group's heads on n): a first version on CUDA cores (shuffle
//     reductions, three block barriers a 32-row tile) was bound by that
//     serial work, not by bytes;
//   - the int8 kernel converts K and V to bf16 in registers (exact), copies
//     each slice's key and value scales beside it, folds the key scale into
//     the score column and the value scale into the probability row after
//     the row's sum.
// What is left between the kernel and its bound: about 4 us a call of two
// launches, the empty splits and the merge (measured with every lens 0;
// merging in each group's last block instead, behind an integer counter,
// measured slower), and, for int8, the conversions.

#include "decode_tile.cuh"

namespace {

template <int D, int G, typename KV, bool QUANT>
__global__ void __launch_bounds__(decode::NT)
dense_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const KV* __restrict__ ck, const KV* __restrict__ cv,
                    const float* __restrict__ ks, const float* __restrict__ vs,
                    const int* __restrict__ lens, float* __restrict__ ws_acc,
                    float* __restrict__ ws_ml, int M, int Hkv, int chunk,
                    int nsplit, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<decode::Smem<D, KV>*>(smem_raw);
  const decode::Split sp(Hkv, nsplit, G);
  int len = lens[sp.slot];
  len = len < 0 ? 0 : (len > M ? M : len);
  const int t0 = sp.split * chunk;
  const int t1 = min(t0 + chunk, len);

  const size_t row_stride = (size_t)Hkv * D;          // elements per position
  const size_t kv0 = (size_t)sp.slot * M * row_stride + (size_t)sp.h * D;
  const size_t sbase = ((size_t)sp.slot * Hkv + sp.h) * M;  // scales
  decode::split_attend<D, G, KV, QUANT>(
      sm, q, ck + kv0, cv + kv0, QUANT ? ks + sbase : nullptr,
      QUANT ? vs + sbase : nullptr,
      [row_stride](int t) { return (size_t)t * row_stride; }, t0, t1, scale,
      sp, nsplit, ws_acc, ws_ml);
}

template <typename KV, bool QUANT>
int launch(const void* q, const void* ck, const void* cv, const void* ks,
           const void* vs, const void* lens, void* out, void* ws, int S,
           int M, int Hq, int Hkv, int D, int chunk, int nsplit, float scale,
           void* stream) {
  if (S <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      !decode::plan_ok(M, chunk, nsplit))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws_acc = static_cast<float*>(ws);
  float* ws_ml = ws_acc + (size_t)S * Hq * nsplit * D;
  int err = 0;
  const bool ok = decode::with_head_dim_and_group(
      D, Hq / Hkv, [&](auto d, auto g) {
        constexpr int DD = decltype(d)::value, GG = decltype(g)::value;
        constexpr int smem = sizeof(decode::Smem<DD, KV>);
        static bool set[decode::MAX_DEVICES] = {};
        err = decode::allow_smem(dense_decode_kernel<DD, GG, KV, QUANT>,
                                 smem, set);
        if (err) return;
        dense_decode_kernel<DD, GG, KV, QUANT>
            <<<S * Hkv * nsplit, decode::NT, smem, st>>>(
            static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(ck),
            static_cast<const KV*>(cv), static_cast<const float*>(ks),
            static_cast<const float*>(vs), static_cast<const int*>(lens),
            ws_acc, ws_ml, M, Hkv, chunk, nsplit, scale);
        err = (int)cudaGetLastError();
      });
  if (!ok) return (int)cudaErrorInvalidValue;
  if (err) return err;
  return decode::launch_merge(ws_acc, static_cast<__nv_bfloat16*>(out),
                              S * Hq, nsplit, D, st);
}

}  // namespace

// Both return cudaGetLastError() after the split kernel and after the
// merge (0 = both launched), or cudaErrorInvalidValue for a head_dim /
// group size without an instantiation (head_dim 64 or 128; group 1, 2, 4
// or 8) or a split plan other than a chunk that is a positive multiple of
// 64 with nsplit = ceil(M / chunk) <= 4096.
extern "C" int decode_attention_bf16(const void* q, const void* ck,
                                     const void* cv, const void* lens,
                                     void* out, void* ws, int S, int M,
                                     int Hq, int Hkv, int D, int chunk,
                                     int nsplit, float scale, void* stream) {
  return launch<__nv_bfloat16, false>(q, ck, cv, nullptr, nullptr, lens, out,
                                      ws, S, M, Hq, Hkv, D, chunk, nsplit,
                                      scale, stream);
}

extern "C" int decode_attention_int8(const void* q, const void* kq,
                                     const void* ks, const void* vq,
                                     const void* vs, const void* lens,
                                     void* out, void* ws, int S, int M,
                                     int Hq, int Hkv, int D, int chunk,
                                     int nsplit, float scale, void* stream) {
  return launch<int8_t, true>(q, kq, vq, ks, vs, lens, out, ws, S, M, Hq, Hkv,
                              D, chunk, nsplit, scale, stream);
}

// The merge alone, over a workspace of `rows` (slot, q head) rows of
// nsplit partials (for timing it and checking it against its plain
// version).  Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_merge(const void* ws, void* out, int rows,
                                      int nsplit, int D, void* stream) {
  if (rows <= 0 || nsplit <= 0 || nsplit > decode::MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  return decode::launch_merge(static_cast<const float*>(ws),
                              static_cast<__nv_bfloat16*>(out), rows, nsplit,
                              D, static_cast<cudaStream_t>(stream));
}

// Shared memory a block of the split kernel holds at (D, G), bf16 (quant
// 0) or int8 (quant 1), as the runtime reports it once that
// instantiation has launched; -1 for a pair without one.
extern "C" int decode_attention_smem_bytes(int D, int G, int quant) {
  int got = -1;
  decode::with_head_dim_and_group(D, G, [&](auto d, auto g) {
    constexpr int DD = decltype(d)::value, GG = decltype(g)::value;
    got = quant ? decode::smem_bytes(dense_decode_kernel<DD, GG, int8_t, true>)
                : decode::smem_bytes(
                      dense_decode_kernel<DD, GG, __nv_bfloat16, false>);
  });
  return got;
}
