// Sequence-parallel ring attention's forward: every ring step of every
// rank held here, in one persistent kernel.
//
// Replaces kuberay_tpu/parallel/ring_pallas.py::_ring_kernel (reached
// through _ring_attention_fwd_sharded and ring_attention_rdma), whole: as
// the TPU kernel loops over the n ring steps inside one call with its
// state (acc, m, l) on chip, this kernel runs each q tile over every K/V
// block its rank sees, in the ring's order, with O, m and l in registers,
// and writes out and lse once.  The TPU kernel's remote DMAs, semaphores
// and capacity token become the caller's exchange into an n-slot buffer
// (parallel/ring_kernel.py) and an arrival word per slot that this kernel
// waits on.
//
//   q      [R, B, Sl, Hq, D]   bf16  the R held ranks' queries; held rank j
//                                    is global rank rank0 + j, its rows are
//                                    global positions (rank0 + j) * Sl + i
//   k, v   [n, B, Sl, Hkv, D]  bf16  the n ranks' blocks, `kv_stride`
//                                    elements apart (B * Sl * Hkv * D
//                                    stacked; twice that in the n-slot
//                                    buffer [n, 2, B, Sl, Hkv, D])
//   out    [R, B, Sl, Hq, D]   bf16
//   lse    [R, B, Hq, Sl]      f32
//   words  [n]                 int32 arrival word of each source, or null
//
// Semantics, as the TPU kernel: f32 scores from bf16 operands times
// `scale`; rank r sees, in order, the blocks src = r, r - 1, ... (mod n):
// with `causal` only those with src <= r, key j of block src visible to
// row i when src * Sl + j <= r * Sl + i; probabilities rounded to bf16
// before P @ V; f32 (O, m, l); out = O / l (l == 0 -> 1), lse = m + log l.
// The TPU kernel rounds P against each block's max, this kernel against
// the running max of its 128-key tiles: the two differ by bf16 rounding
// only.
//
// Bound on an H100: operations.  At the long-context smoke's shape
// (LocalRing(4), B 2, S 4096 in shards of 1024, 16 q / 8 kv heads of 128,
// causal) the ring computes 2 products over 268 M visible (q, k) pairs,
// 137 GFLOP, 0.139 ms at 989 TFLOP/s; its 101 MB of q, k, v and out take
// 0.030 ms at 3.35 TB/s.  The one-launch-a-step kernel it replaces read and
// wrote the f32 state through device memory at every step (34 MB of a past
// step's 51 MB) and paid ten launches a ring.
//
// Design: the Hopper main loop of attn_fwd_sm90.cuh (TMA, a 3-stage K/V
// ring, a producer and two consumer warpgroups, wgmma, softmax overlapped
// with the products) over a persistent grid:
// - the unit of work is a q tile (held rank, batch, q head, 128 rows); its
//   K/V stream runs through all of its blocks back to back, each block's
//   tiles masked only where the diagonal or the ragged edge cuts them (off
//   = (r - src) * Sl);
// - the tiles are ordered largest work first (global q tile descending:
//   under the causal mask a tile of rank r row q0 sees r full blocks and
//   the diagonal's first q0 + 128 keys, so work grows with the global
//   row), heads fastest, so the blocks that read one kv head run side by
//   side; block c of a grid of G takes tiles c, 2G - 1 - c, 2G + c, ...
//   (a snake over the order), which evens the causal ring's imbalance
//   (rank 3's tiles see 4 blocks, rank 0's one) without a counter;
// - q, k and v are read through 5-D tensor maps over [source, B, S, H, D]:
//   the held rank is q's source coordinate and the K/V rank k's and v's,
//   so a tile addresses any block without pointer tables.
//
// Arrival.  With `words` null every block is already in k and v (a
// LocalRing: all ranks on this card), and the kernel reads them in place.
// Otherwise (a DeviceRing: one rank per card) k and v are the n-slot buffer
// that the exchange fills while the kernel runs: slot src holds block src
// once words[src] is set (nonzero: the ring's epoch is 1,
// parallel/ring_kernel.py zeroing the words at each forward), by a stream
// memory operation (ring_arrival_write) after the block's copy.  The
// producer waits for the word with an acquire load before a block's first
// TMA load and then fences the async proxy (the data was written by another
// engine); a word that never arrives faults the launch after about 5 s
// instead of hanging. The buffer holds the whole sequence's K/V of one layer
// while the forward runs (33.5 MB at the smoke's shape, against the old
// double buffer's 2 slots).  Every kernel that delivers blocks must have
// been launched once before this kernel waits: CUDA loads a module at a
// kernel's first launch (lazy loading) only once the running kernels have
// ended (measured on the H100: a fill kernel first launched on the side
// stream never ran beside a waiting grid, with 4 to 66 SMs free; copies and
// the word writes did).  parallel/ring_kernel.py queues the first rotation,
// and with it NCCL's kernel, before the launch.  A waiting grid leaves
// RESERVED_SMS of the card's SMs free: a block of this kernel fills an SM's
// registers (2 x 128 x 232 + 128 x 40 of 65,536), so the copies or NCCL
// kernels that deliver the blocks could otherwise find no SM while every
// block spins.

#include "attn_fwd_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// SMs left free while the kernel may wait for arrivals (3% of an H100's
// 132): enough for the delivering copies' or NCCL's blocks to make
// progress; 0 when every block is already on the card.
constexpr int RESERVED_SMS = 4;

// The persistent grid's schedule (fwd90::fwd_loop's Sched).
struct RingPlan {
  fwd90::Tile t;      // Sq = Skv = Sl; off unused
  const int* words;   // arrival word of each source, or null
  int R, rank0, n, B, total;

  __device__ __forceinline__ int jobs() const {
    return fwd90::snake_jobs(total);
  }

  __device__ __forceinline__ fwd90::Job job(int k) const {
    const int idx = fwd90::snake_index(k);
    const int BH = B * t.Hq, nqt = (t.Sq + fwd90::BQ - 1) / fwd90::BQ;
    const int gq = R * nqt - 1 - idx / BH, bh = idx % BH;
    const int j = gq / nqt, b = bh / t.Hq;
    return fwd90::Job{(gq - j * nqt) * fwd90::BQ, bh - b * t.Hq, b, j,
                      rank0 + j, j * B + b};
  }

  __device__ __forceinline__ int blocks(const fwd90::Job& jb) const {
    return t.causal ? jb.r + 1 : n;
  }

  __device__ __forceinline__ fwd90::Block block(const fwd90::Job& jb,
                                                int i) const {
    const int src = jb.r - i < 0 ? jb.r - i + n : jb.r - i;
    return fwd90::Block{src, (jb.r - src) * t.Sq};
  }

  __device__ __forceinline__ void wait(int src) const {
    if (words) fwd90::wait_word(words + src);
  }
};

template <int D>
__global__ void __launch_bounds__(fwd90::NT, 1)
ring_fwd_kernel(const __grid_constant__ CUtensorMap qm,
                const __grid_constant__ CUtensorMap km,
                const __grid_constant__ CUtensorMap vm,
                const __grid_constant__ CUtensorMap om, bf16* __restrict__ out,
                float* __restrict__ lse, const RingPlan plan) {
  fwd90::fwd_loop<D>(qm, km, vm, om, plan, out, lse);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape without an instantiation (head_dim 64
// or 128; group 1, 2, 4 or 8), held ranks outside the ring, a K/V stride
// below a block or not 16-byte aligned, or tensor maps
// cuTensorMapEncodeTiled refuses.
extern "C" int ring_attention_fwd_bf16(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       const void* words, int R, int rank0,
                                       int n, int B, int Sl, int Hq, int Hkv,
                                       int D, int kv_stride, int causal,
                                       float scale, void* stream) {
  fwd90::Maps maps;
  const int sms = fwd90::sm_count();
  if (!attn::shape_ok(B, Sl, Sl, Hq, Hkv, D) || R < 1 || rank0 < 0 ||
      rank0 + R > n || (long long)kv_stride < (long long)B * Sl * Hkv * D ||
      kv_stride % 8 != 0 || sms <= RESERVED_SMS ||
      !fwd90::fwd_maps(&maps, q, k, v, out, R, n, kv_stride, B, Sl, Sl, Hq,
                       Hkv, D))
    return (int)cudaErrorInvalidValue;
  const int total = R * ((Sl + fwd90::BQ - 1) / fwd90::BQ) * B * Hq;
  const int cap = sms - (words ? RESERVED_SMS : 0);
  const RingPlan plan{{Sl, Sl, Hq, Hkv, causal, 0, scale},
                      static_cast<const int*>(words), R, rank0, n, B, total};
  const dim3 grid(total < cap ? total : cap);
  return attn::with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return fwd90::launch(ring_fwd_kernel<DD>, grid, fwd90::Smem<DD>::BYTES,
                         stream, maps.q, maps.k, maps.v, maps.o,
                         (bf16*)out, (float*)lse, plan);
  });
}

// The kernel's shared memory a block at head dim D (64 or 128), as the
// runtime holds it after a launch at D; -1 for another D.
extern "C" int ring_attention_fwd_smem_bytes(int D) {
  if (D != 64 && D != 128) return -1;
  return attn::with_head_dim(D, [](auto d) {
    return fwd90::smem_bytes(ring_fwd_kernel<decltype(d)::value>);
  });
}

// Sets the int32 arrival word at `word` (to 1) on `stream`, after the
// stream's earlier work and its memory (cuStreamWriteValue32, default
// flags).  Returns the CUresult (0 = enqueued), or cudaErrorNotSupported
// without the driver entry point.
extern "C" int ring_arrival_write(void* word, void* stream) {
  using WriteValue32 =
      CUresult (*)(CUstream, CUdeviceptr, cuuint32_t, unsigned int);
  static const WriteValue32 fn = reinterpret_cast<WriteValue32>(
      fwd90::driver_entry("cuStreamWriteValue32"));
  if (!fn) return (int)cudaErrorNotSupported;
  return (int)fn(static_cast<CUstream>(stream),
                 reinterpret_cast<CUdeviceptr>(word), 1u,
                 CU_STREAM_WRITE_VALUE_DEFAULT);
}
