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
// Design: the Hopper machinery of attn_fwd_sm90.cuh for all three (TMA
// into a ring of stages guarded by mbarriers, a producer warpgroup and two
// consumer warpgroups running wgmma with every score, probability and
// accumulator in registers); the tensor maps over q, k, v (and dO) are
// built on the host at every call.
// - forward: a persistent grid of one block per SM over the (128-row q
//   tile, q head, batch) tiles, the longest causal tiles first, dealt out
//   in a snake, on the shared loop (fwd_loop: a 3-stage K/V ring,
//   each tile's softmax overlapped with the products in flight, the two
//   consumer warpgroups taking turns on the tensor cores), which
//   normalises O in registers and writes out and lse.
// - dK/dV and dQ (attn_bwd_sm90.cuh, which holds the design): one block
//   per (128-key kv tile, kv head, batch) looping over the group's q heads
//   and the 64-row q tiles that see it, with S^T and dP^T computed keys-on-
//   M so that P^T and dS^T feed dV and dK from registers; one block per
//   (128-row q tile, q head, batch) over 64-key K/V tiles for dQ.  No float
//   atomics, so repeats are bit for bit: 7 products against the 5 of a
//   fused kernel that sums dQ by atomics (0.243 ms of operations at
//   llama_1b's shape against 0.174).

#include "attn_bwd_sm90.cuh"
#include "attn_fwd_sm90.cuh"
#include "attn_tile.cuh"

using namespace attn;

namespace {

using bf16 = __nv_bfloat16;

// The forward: a persistent grid over the q tiles (fwd90::FlashPlan).
template <int D>
__global__ void __launch_bounds__(fwd90::NT, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qm,
                 const __grid_constant__ CUtensorMap km,
                 const __grid_constant__ CUtensorMap vm,
                 const __grid_constant__ CUtensorMap om, bf16* __restrict__ o,
                 float* __restrict__ lse, const fwd90::FlashPlan plan) {
  fwd90::fwd_loop<D>(qm, km, vm, om, plan, o, lse);
}

template <int D>
__global__ void __launch_bounds__(fwd90::NT, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qm,
                     const __grid_constant__ CUtensorMap km,
                     const __grid_constant__ CUtensorMap vm,
                     const __grid_constant__ CUtensorMap dom,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, fwd90::Tile t) {
  bwd90::dkv_block<D>(qm, km, vm, dom, lse, delta, dk, dv, t,
                      blockIdx.z * bwd90::KV_TILE, blockIdx.x, blockIdx.y);
}

template <int D>
__global__ void __launch_bounds__(fwd90::NT, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qm,
                    const __grid_constant__ CUtensorMap km,
                    const __grid_constant__ CUtensorMap vm,
                    const __grid_constant__ CUtensorMap dom,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    fwd90::Tile t) {
  bwd90::dq_block<D>(qm, km, vm, dom, lse, delta, dq, t, fwd90::block_q0(),
                     blockIdx.x, blockIdx.y);
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 =
// launched), or cudaErrorInvalidValue for a shape without an instantiation
// (head_dim 64 or 128; group 1, 2, 4 or 8) or tensor maps
// cuTensorMapEncodeTiled refuses.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Sq, int Skv,
                              int Hq, int Hkv, int D, int causal, float scale,
                              void* stream) {
  fwd90::Maps maps;
  const int sms = fwd90::sm_count();
  if (!shape_ok(B, Sq, Skv, Hq, Hkv, D) || sms <= 0 ||
      !fwd90::fwd_maps(&maps, q, k, v, o, 1, 1, (long long)B * Skv * Hkv * D,
                       B, Sq, Skv, Hq, Hkv, D))
    return (int)cudaErrorInvalidValue;
  const int total = B * Hq * ((Sq + fwd90::BQ - 1) / fwd90::BQ);
  const fwd90::FlashPlan plan{{Sq, Skv, Hq, Hkv, causal, Skv - Sq, scale}, B,
                              total};
  return with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return fwd90::launch(flash_fwd_kernel<DD>,
                         dim3(total < sms ? total : sms),
                         fwd90::Smem<DD>::BYTES, stream, maps.q, maps.k,
                         maps.v, maps.o, (bf16*)o, (float*)lse, plan);
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

// The backward's tensor maps: q and dO in boxes of `q_rows`, k and v of
// `kv_rows`.
struct BwdMaps {
  CUtensorMap q, k, v, dO;
};

static bool bwd_maps(BwdMaps* m, const void* q, const void* k, const void* v,
                     const void* dO, int B, int Sq, int Skv, int Hq, int Hkv,
                     int D, int q_rows, int kv_rows) {
  return fwd90::bshd_map(&m->q, q, B, Sq, Hq, D, q_rows) &&
         fwd90::bshd_map(&m->dO, dO, B, Sq, Hq, D, q_rows) &&
         fwd90::bshd_map(&m->k, k, B, Skv, Hkv, D, kv_rows) &&
         fwd90::bshd_map(&m->v, v, B, Skv, Hkv, D, kv_rows);
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dO, const void* lse,
                                  const void* delta, void* dk, void* dv, int B,
                                  int Sq, int Skv, int Hq, int Hkv, int D,
                                  int causal, float scale, void* stream) {
  BwdMaps maps;
  if (!shape_ok(B, Sq, Skv, Hq, Hkv, D) ||
      !bwd_maps(&maps, q, k, v, dO, B, Sq, Skv, Hq, Hkv, D, bwd90::Q_STEP,
                bwd90::KV_TILE))
    return (int)cudaErrorInvalidValue;
  const fwd90::Tile t{Sq, Skv, Hq, Hkv, causal, Skv - Sq, scale};
  return with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return fwd90::launch(flash_bwd_dkv_kernel<DD>,
                         bwd90::dkv_grid(B, Skv, Hkv),
                         bwd90::DkvSmem<DD>::BYTES, stream, maps.q, maps.k,
                         maps.v, maps.dO, (const float*)lse,
                         (const float*)delta, (bf16*)dk, (bf16*)dv, t);
  });
}

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dO, const void* lse,
                                 const void* delta, void* dq, int B, int Sq,
                                 int Skv, int Hq, int Hkv, int D, int causal,
                                 float scale, void* stream) {
  BwdMaps maps;
  if (!shape_ok(B, Sq, Skv, Hq, Hkv, D) ||
      !bwd_maps(&maps, q, k, v, dO, B, Sq, Skv, Hq, Hkv, D, fwd90::BQ,
                bwd90::DQ_KEYS))
    return (int)cudaErrorInvalidValue;
  const fwd90::Tile t{Sq, Skv, Hq, Hkv, causal, Skv - Sq, scale};
  return with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return fwd90::launch(flash_bwd_dq_kernel<DD>, fwd90::grid(B, Sq, Hq),
                         bwd90::DqSmem<DD>::BYTES, stream, maps.q, maps.k,
                         maps.v, maps.dO, (const float*)lse,
                         (const float*)delta, (bf16*)dq, t);
  });
}

// The backward kernels' shared memory a block at head dim D (64 or 128), as
// the runtime holds it after a launch at D; -1 for another D.
extern "C" int flash_bwd_dkv_smem_bytes(int D) {
  if (D != 64 && D != 128) return -1;
  return with_head_dim(D, [](auto d) {
    return fwd90::smem_bytes(flash_bwd_dkv_kernel<decltype(d)::value>);
  });
}

extern "C" int flash_bwd_dq_smem_bytes(int D) {
  if (D != 64 && D != 128) return -1;
  return with_head_dim(D, [](auto d) {
    return fwd90::smem_bytes(flash_bwd_dq_kernel<decltype(d)::value>);
  });
}
