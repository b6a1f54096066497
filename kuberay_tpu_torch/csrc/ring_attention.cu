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
// running max of its 64-key tiles: the two differ by bf16 rounding only.
//
// Bound on an H100: operations, nearly balanced with bytes.  At the ring
// smoke's shape (llama_1b heads: 16 q / 8 kv of 128; B 2; shards of 1024)
// a step over a past block is 2 products of 8.6 GFLOP, 17.4 us at 989
// TFLOP/s, and moves 51 MB (q, k, v and the f32 state read and written,
// 34 MB of it), 15.2 us at 3.35 TB/s; a diagonal step does half the
// products.  The state's round trip through device memory is what carrying
// it in registers across steps (one kernel per ring) would remove.
//
// Design, simple first, as flash_attention.cu's forward: one block of 4
// warps per (64-row q tile, q head, batch).  The block reads its rows of
// the state (acc with 16-byte loads), loops over the 64-key tiles its rows
// can see (the causal bound ends the loop early; a block that sees nothing
// returns at once unless it must normalise), staging K and V in shared
// memory and running both products on wmma bf16 fragments with f32
// accumulators, updates the running max and sum per row, and writes the
// state (or out and lse) back once.

#include "attn_tile.cuh"

using namespace attn;

namespace {

struct Step {
  int Sq, Skv, Hq, Hkv, causal, last, q_off, k_off;
  float scale;
};

// Does local query row `row` see local key `col`?
__device__ __forceinline__ bool sees(const Step& s, int row, int col) {
  return row < s.Sq && col < s.Skv &&
         (!s.causal || s.k_off + col <= s.q_off + row);
}

template <int D>
constexpr size_t step_smem() {
  return (size_t)3 * 64 * Ld<D>::T * 2 + 64 * Ld<D>::S * 4 + 64 * Ld<D>::P * 2 +
         64 * Ld<D>::A * 4 + 2 * 64 * 4;
}

template <int D>
__global__ void __launch_bounds__(NT)
ring_step_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, float* __restrict__ acc,
                 float* __restrict__ m, float* __restrict__ l,
                 bf16* __restrict__ out, float* __restrict__ lse, Step s) {
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  // End (exclusive) of the keys this tile's rows can see.
  int end = s.Skv;
  if (s.causal) {
    const int last_row = (q0 + BQ < s.Sq ? q0 + BQ : s.Sq) - 1;
    const int e = s.q_off + last_row + 1 - s.k_off;
    end = e < end ? e : end;
  }
  if (end <= 0 && !s.last) return;       // nothing to merge

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + 64 * Ld<D>::T;
  bf16* v_s = k_s + 64 * Ld<D>::T;
  float* s_s = reinterpret_cast<float*>(v_s + 64 * Ld<D>::T);
  bf16* p_s = reinterpret_cast<bf16*>(s_s + 64 * Ld<D>::S);
  float* o_s = reinterpret_cast<float*>(p_s + 64 * Ld<D>::P);
  float* m_s = o_s + 64 * Ld<D>::A;
  float* l_s = m_s + 64;

  const int hk = h / (s.Hq / s.Hkv);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qstride = (size_t)s.Hq * D, kstride = (size_t)s.Hkv * D;
  const size_t qoff = ((size_t)b * s.Sq * s.Hq + h) * D;     // q, acc, out
  const size_t koff = ((size_t)b * s.Skv * s.Hkv + hk) * D;
  const size_t roff = ((size_t)b * s.Hq + h) * s.Sq;         // m, l, lse

  // The state of this tile's rows (rows past Sq: empty).
  constexpr int CH = D / 4;
  for (int c = threadIdx.x; c < 64 * CH; c += NT) {
    const int r = c / CH, col = (c % CH) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < s.Sq)
      val = *reinterpret_cast<const float4*>(acc + qoff + (size_t)(q0 + r) * qstride + col);
    *reinterpret_cast<float4*>(o_s + r * Ld<D>::A + col) = val;
  }
  if (threadIdx.x < 64) {
    const int row = q0 + threadIdx.x;
    m_s[threadIdx.x] = row < s.Sq ? m[roff + row] : NEG;
    l_s[threadIdx.x] = row < s.Sq ? l[roff + row] : 0.f;
  }
  if (end > 0) load_tile<D>(q_s, q + qoff, qstride, q0, s.Sq);

  for (int kv0 = 0; kv0 < end; kv0 += BK) {
    __syncthreads();                       // k_s / v_s free; q_s, o_s ready
    load_tile<D>(k_s, k + koff, kstride, kv0, s.Skv);
    load_tile<D>(v_s, v + koff, kstride, kv0, s.Skv);
    __syncthreads();
    rows_times_tile_t<D>(s_s, q_s, k_s);
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = 16 * w + rr, row = q0 + r;
      float x[2];
      bool ok[2];
      float mx = NEG;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = lane + 32 * e;
        ok[e] = sees(s, row, kv0 + c);
        x[e] = s_s[r * Ld<D>::S + c] * s.scale;
        if (ok[e]) mx = fmaxf(mx, x[e]);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ok[e] ? expf(x[e] - m_new) : 0.f;
        sum += p;
        p_s[r * Ld<D>::P + lane + 32 * e] = __float2bfloat16(p);
      }
      sum = warp_sum(sum);
      const float corr = expf(m_old - m_new);
      for (int d = lane; d < D; d += 32) o_s[r * Ld<D>::A + d] *= corr;
      __syncwarp();
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncwarp();
    acc_rows<D>(o_s, p_s, v_s);
  }
  __syncthreads();                       // also when no tile was visible

  if (s.last) {
    for (int rr = 0; rr < 16; ++rr) {
      const int r = 16 * w + rr, row = q0 + r;
      if (row >= s.Sq) break;
      float lr = l_s[r];
      lr = lr == 0.f ? 1.f : lr;
      const float inv = 1.f / lr;
      bf16* op = out + qoff + (size_t)row * qstride;
      for (int d = lane; d < D; d += 32)
        op[d] = __float2bfloat16(o_s[r * Ld<D>::A + d] * inv);
      if (lane == 0) lse[roff + row] = m_s[r] + logf(lr);
    }
    return;
  }
  for (int c = threadIdx.x; c < 64 * CH; c += NT) {
    const int r = c / CH, col = (c % CH) * 4;
    if (q0 + r < s.Sq)
      *reinterpret_cast<float4*>(acc + qoff + (size_t)(q0 + r) * qstride + col) =
          *reinterpret_cast<const float4*>(o_s + r * Ld<D>::A + col);
  }
  if (threadIdx.x < 64 && q0 + threadIdx.x < s.Sq) {
    m[roff + q0 + threadIdx.x] = m_s[threadIdx.x];
    l[roff + q0 + threadIdx.x] = l_s[threadIdx.x];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape without an instantiation (head_dim 64
// or 128; group 1, 2, 4 or 8) or `last` without out and lse.
extern "C" int ring_attention_step_bf16(const void* q, const void* k,
                                        const void* v, void* acc, void* m,
                                        void* l, void* out, void* lse, int B,
                                        int Sq, int Skv, int Hq, int Hkv,
                                        int D, int q_off, int k_off,
                                        int causal, int last, float scale,
                                        void* stream) {
  if (!shape_ok(B, Sq, Skv, Hq, Hkv, D) || (last && (!out || !lse)))
    return (int)cudaErrorInvalidValue;
  const Step s{Sq, Skv, Hq, Hkv, causal, last, q_off, k_off, scale};
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  return with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return launch(ring_step_kernel<DD>, step_smem<DD>(), grid, stream,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v, (float*)acc,
                  (float*)m, (float*)l, (bf16*)out, (float*)lse, s);
  });
}
