// One step of sequence-parallel ring attention: a q shard against one K/V
// block, merged online into f32 state.
//
// Replaces kuberay_tpu/parallel/ring_pallas.py::_ring_kernel (reached
// through _ring_attention_fwd_sharded and ring_attention_rdma): the block
// attention and online merge of one ring step (:130-158) and, at the last
// step, the normalisation (:179).  The TPU kernel's remote DMAs, semaphores
// and capacity token become the exchange in parallel/ring_kernel.py: NCCL
// send/recv (or a device copy for ranks on one card) on a side stream,
// ordered against this kernel by CUDA events.
//
//   q      [B, Sq,  Hq,  D]  bf16   this rank's queries, global rows q_off + i
//   k, v   [B, Skv, Hkv, D]  bf16   one K/V block, global rows k_off + j
//   acc    [B, Sq,  Hq,  D]  f32    unnormalised output       (state)
//   m, l   [B, Hq, Sq]       f32    running max and sum of each score row
//   out    [B, Sq,  Hq,  D]  bf16   with `last`: acc / l (l == 0 -> 1)
//   lse    [B, Hq, Sq]       f32    with `last`: m + log l
//
// Semantics, as the TPU kernel: f32 scores from bf16 operands times
// `scale`; with `causal`, key j is visible to row i when k_off + j <=
// q_off + i (global positions, any integers); probabilities rounded to bf16
// before P @ V; f32 (acc, m, l).  Without `last` the state is updated in
// place; with `last` the merged state is normalised into out and lse and
// the state is not written back.  A row or block that sees no key leaves
// the state as it was; a block that sees nothing does not touch it.  The
// TPU kernel rounds P against the block's max, this kernel against the
// running max of its 128-key tiles: the two differ by bf16 rounding only.
//
// Bound on an H100: operations, nearly balanced with bytes.  At the ring
// smoke's shape (llama_1b heads: 16 q / 8 kv of 128; B 2; shards of 1024)
// a step over a past block is 2 products of 8.6 GFLOP, 17.4 us at 989
// TFLOP/s, and moves 51 MB (q, k, v and the f32 state read and written,
// 34 MB of it), 15.2 us at 3.35 TB/s; a diagonal step does half the
// products.  The state's round trip through device memory is what carrying
// it in registers across steps (one kernel per ring) would remove.
//
// Design: the flash forward's Hopper main loop (attn_fwd_sm90.cuh: TMA
// into a 2-stage K/V ring, a producer warpgroup, two consumer warpgroups
// running wgmma with S, P and O in registers), one block per (128-row q
// tile, q head, batch), with the global-offset mask (off = q_off - k_off):
// past blocks are wholly visible and never pay the per-element test.  Its
// prologue here reads the tile's state (acc into the O accumulator
// fragment with 8-byte loads, m and l per row); its epilogue writes the
// state back or, with `last`, normalises into out and lse.  A block that
// sees nothing returns before touching the state.

#include "attn_fwd_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The step's prologue and epilogue on the register fragment.
template <int D>
struct StepState {
  float* acc;
  float* m;
  float* l;
  bf16* out;
  float* lse;
  int Sq, Hq, h, b, last;

  __device__ __forceinline__ size_t at(int row) const {   // acc, out
    return ((size_t)(b * Sq + row) * Hq + h) * D;
  }
  __device__ __forceinline__ size_t at_row(int row) const {  // m, l, lse
    return ((size_t)b * Hq + h) * Sq + row;
  }

  // The state of the fragment's rows (rows past Sq: empty); l as the quad
  // leader's share, so the quad's sum gives it back.
  __device__ __forceinline__ void init(float (&o)[D / 2], float (&mr)[2],
                                       float (&lr)[2],
                                       const fwd90::Frag& f) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = f.rows[r];
      const bool in = row < Sq;
      const float* ap = acc + (in ? at(row) : 0) + 2 * f.c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 v = in ? *reinterpret_cast<const float2*>(ap + 8 * j)
                            : make_float2(0.f, 0.f);
        o[4 * j + 2 * r] = v.x;
        o[4 * j + 2 * r + 1] = v.y;
      }
      mr[r] = in ? m[at_row(row)] : fwd90::NEG;
      lr[r] = in && f.c == 0 ? l[at_row(row)] : 0.f;
    }
  }

  __device__ __forceinline__ void finish(const float (&o)[D / 2],
                                         const float (&mr)[2],
                                         const float (&lr)[2],
                                         const fwd90::Frag& f) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = f.rows[r];
      if (row >= Sq) continue;
      if (last) {
        const float ls = lr[r] == 0.f ? 1.f : lr[r];
        const float inv = 1.f / ls;
        bf16* op = out + at(row) + 2 * f.c;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(op + 8 * j) = fwd90::pack_bf16(
              o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
        if (f.c == 0) lse[at_row(row)] = mr[r] + logf(ls);
      } else {
        float* ap = acc + at(row) + 2 * f.c;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(ap + 8 * j) =
              make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
        if (f.c == 0) {
          m[at_row(row)] = mr[r];
          l[at_row(row)] = lr[r];
        }
      }
    }
  }
};

template <int D>
__global__ void __launch_bounds__(fwd90::NT, 1)
ring_step_kernel(const __grid_constant__ CUtensorMap qm,
                 const __grid_constant__ CUtensorMap km,
                 const __grid_constant__ CUtensorMap vm,
                 float* __restrict__ acc, float* __restrict__ m,
                 float* __restrict__ l, bf16* __restrict__ out,
                 float* __restrict__ lse, fwd90::Tile t, int last) {
  const int q0 = fwd90::block_q0(), h = blockIdx.x, b = blockIdx.y;
  const int n_tiles = fwd90::kv_tiles(t, q0);
  if (n_tiles == 0 && !last) return;     // nothing to merge
  StepState<D> epi{acc, m, l, out, lse, t.Sq, t.Hq, h, b, last};
  fwd90::fwd_block<D>(qm, km, vm, t, q0, h, b, n_tiles, epi);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape without an instantiation (head_dim 64
// or 128; group 1, 2, 4 or 8), `last` without out and lse, or tensor maps
// cuTensorMapEncodeTiled refuses.
extern "C" int ring_attention_step_bf16(const void* q, const void* k,
                                        const void* v, void* acc, void* m,
                                        void* l, void* out, void* lse, int B,
                                        int Sq, int Skv, int Hq, int Hkv,
                                        int D, int q_off, int k_off,
                                        int causal, int last, float scale,
                                        void* stream) {
  fwd90::Maps maps;
  if (!attn::shape_ok(B, Sq, Skv, Hq, Hkv, D) || (last && (!out || !lse)) ||
      !fwd90::make_maps(&maps, q, k, v, B, Sq, Skv, Hq, Hkv, D))
    return (int)cudaErrorInvalidValue;
  const fwd90::Tile t{Sq, Skv, Hq, Hkv, causal, q_off - k_off, scale};
  return attn::with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return fwd90::launch(ring_step_kernel<DD>, fwd90::grid(B, Sq, Hq),
                         fwd90::Smem<DD>::BYTES, stream, maps.q, maps.k,
                         maps.v, (float*)acc, (float*)m, (float*)l,
                         (bf16*)out, (float*)lse, t, last);
  });
}

// The step kernel's shared memory a block at head dim D (64 or 128), as the
// runtime holds it after a launch at D; -1 for another D.
extern "C" int ring_attention_step_smem_bytes(int D) {
  if (D != 64 && D != 128) return -1;
  return attn::with_head_dim(D, [](auto d) {
    return fwd90::smem_bytes(ring_step_kernel<decltype(d)::value>);
  });
}
