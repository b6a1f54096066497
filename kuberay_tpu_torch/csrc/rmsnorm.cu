// RMSNorm forward over the last axis: out = (x * rsqrt(mean(x^2) + eps)) * w,
// float32 math, out in x's dtype.
//
// Replaces kuberay_tpu/ops/rmsnorm.py::_rmsnorm_kernel (through
// rmsnorm_pallas).
//
//   x    [rows, d]  bf16, f16 or f32, rows d apart
//   w    [d]        bf16, f16 or f32 (its own dtype, read as float32)
//   out  [rows, d]  x's dtype
//
// The math in the reference's order: the sum of x^2 in float32 divided by
// d, rsqrt(var + eps), then (x * r) * w in float32, then the cast.
//
// What bounds it on an H100.  Bytes at the training shape: llama_1b's
// 8192 x 2048 bf16 reads and writes 67 MB, 0.020 ms at 3.35 TB/s.  At the
// serving shape (8 rows of 4096, 131 KB) the bytes take 0.04 us: a call
// costs its launch and one memory round trip (x's load, the row's sum,
// out's store), so the design shortens that chain and the host's work
// around the launch, not bytes.
//
// Design.  A row's columns are cut in 16-byte units (8 bf16 values; one
// value where x, out or w is not aligned for it, or d is not a multiple,
// in the same kernel).  One CTA of T threads (a power of two, 32-512) a
// row: thread t loads the units t + j T, j < nv, of x and w, sums its
// squares, and the CTA sums the row; then each thread scales and stores
// its units.  The plan (T, nv) is computed by the wrapper
// (ops/rmsnorm.py::fwd_plan, modelled by the CPU tests) and checked here.
//
// What measurement on the card decided (tools/rmsnorm_fwd_probe.py on an
// H100 80GB HBM3 at 700 W; the numbers are in PERF.md):
//   - about 2 units a thread (256 threads at d 4096, 128 at 2048): at the
//     training shape a row a CTA keeps enough rows in flight once the
//     registers are few (40 at 2 units: the pairwise sum of squares below
//     lets ptxas drop the float copies of x); 1 or 4 units a thread
//     measured no faster;
//   - a thread block cluster splitting a row over 2-8 CTAs (the partial
//     sums read through distributed shared memory), and CTAs that walk a
//     run of rows with the next row loaded before this row's sum, both
//     measured slower at the main shapes: the cluster barrier costs more
//     than the SMs it adds at 8 rows, and a run holds fewer rows in flight
//     than the CTA scheduler does;
//   - programmatic dependent launch: launched with the stream
//     serialisation attribute, the grid may start while the kernel before
//     it drains; griddepcontrol.wait comes before every global read and
//     write (the weight too: the kernel before may be the cast that writes
//     it), so only the launch and the CTAs' set-up overlap it.  Without
//     the attribute the wait returns at once.
//
// The sum: each thread sums its values in one fixed order, a warp sums its
// lanes by an xor butterfly (every lane ends with the same bits), each
// warp's sum goes to shared memory, and after one barrier every warp sums
// the T / 32 partials by a butterfly over the same order.  So every
// thread scales by the same r and a call gives the same bits on every
// repeat: no atomics.
//
// Rows of more than MAX_NV = 2 units a thread (past 8192 bf16 values at
// 512 threads: llama3_70b's d 8192 stays in registers) loop over the row
// twice, in the same kernel.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace rmsnorm {

constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_NV = 2;  // units a thread holds in registers

// dtype codes, as ops/rmsnorm.py's _DTYPES: 0 bf16, 1 f16, 2 f32.
template <int CODE> struct Type;
template <> struct Type<0> { using T = __nv_bfloat16; };
template <> struct Type<1> { using T = __half; };
template <> struct Type<2> { using T = float; };

__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

// N values loaded and stored as one access (16 bytes of x at full width).
template <typename T, int N> struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// The sum of a unit's squares, pairwise.
template <typename T, int N>
__device__ __forceinline__ float sq_sum(const Pack<T, N>& p) {
  float s[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float f = to_f(p.v[k]);
    s[k] = f * f;
  }
#pragma unroll
  for (int h = 1; h < N; h <<= 1)
#pragma unroll
    for (int k = 0; k + h < N; k += 2 * h) s[k] += s[k + h];
  return s[0];
}

__device__ __forceinline__ float butterfly(float s, int width) {
  for (int m = width >> 1; m > 0; m >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

// The row's sum of squares from each thread's part, the same bits in
// every thread; blockDim.x is a power of two.
__device__ __forceinline__ float row_sum(float part) {
  __shared__ float red[MAX_WARPS];
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  part = butterfly(part, 32);
  if (lane == 0) red[threadIdx.x >> 5] = part;
  __syncthreads();
  return butterfly(red[lane & (nw - 1)], nw);
}

}  // namespace rmsnorm

using namespace rmsnorm;

// XT, WT: dtype codes of x (and out) and w; VEC: values a unit; NV: units
// a thread holds in registers (the register path runs where nv <= NV).
// One CTA a row.
template <int XT, int WT, int VEC, int NV>
__global__ void __launch_bounds__(MAX_THREADS, 1)
rmsnorm_fwd_kernel(const typename Type<XT>::T* __restrict__ x,
                   const typename Type<WT>::T* __restrict__ w,
                   typename Type<XT>::T* __restrict__ out, int d, int nv,
                   float eps) {
  using TX = typename Type<XT>::T;
  using XP = Pack<TX, VEC>;
  using WP = Pack<typename Type<WT>::T, VEC>;
  const int T = blockDim.x, tid = threadIdx.x;
  const int units = d / VEC;
  const XP* xr = reinterpret_cast<const XP*>(x + (size_t)blockIdx.x * d);
  const WP* wp = reinterpret_cast<const WP*>(w);
  XP* o = reinterpret_cast<XP*>(out + (size_t)blockIdx.x * d);

  asm volatile("griddepcontrol.wait;" ::: "memory");

  if (nv <= NV) {
    XP v[NV] = {};
    WP wr[NV] = {};
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int u = tid + j * T;
      if (j < nv && u < units) {
        v[j] = xr[u];
        wr[j] = wp[u];
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (j < nv && tid + j * T < units) ss += sq_sum(v[j]);
    const float r = rsqrtf(__fdividef(row_sum(ss), (float)d) + eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int u = tid + j * T;
      if (j < nv && u < units) {
        XP y;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          y.v[k] = from_f<TX>((to_f(v[j].v[k]) * r) * to_f(wr[j].v[k]));
        o[u] = y;
      }
    }
  } else {
    float ss = 0.f;
    for (int u = tid; u < units; u += T) ss += sq_sum(xr[u]);
    const float r = rsqrtf(__fdividef(row_sum(ss), (float)d) + eps);
    for (int u = tid; u < units; u += T) {
      const XP v = xr[u];
      const WP wv = wp[u];
      XP y;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        y.v[k] = from_f<TX>((to_f(v.v[k]) * r) * to_f(wv.v[k]));
      o[u] = y;
    }
  }
}

namespace {

// One launch: grid CTAs of T threads, programmatic dependent launch where
// pdl is set.
template <typename... Params, typename... Args>
cudaError_t launch_ex(void (*kernel)(Params...), int grid, int T, int pdl,
                      cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(T);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <int XT, int WT, int VEC>
cudaError_t with_nv(int nv, const void* x, const void* w, void* out,
                    int rows, int d, int T, int pdl, float eps,
                    cudaStream_t s) {
  using TX = typename Type<XT>::T;
  using TW = typename Type<WT>::T;
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* op = static_cast<TX*>(out);
  if (nv <= 1)
    return launch_ex(rmsnorm_fwd_kernel<XT, WT, VEC, 1>, rows, T, pdl, s, xp,
                     wp, op, d, nv, eps);
  return launch_ex(rmsnorm_fwd_kernel<XT, WT, VEC, MAX_NV>, rows, T, pdl, s,
                   xp, wp, op, d, nv, eps);
}

template <int XT, int WT>
cudaError_t with_vec(int vec, int nv, const void* x, const void* w,
                     void* out, int rows, int d, int T, int pdl, float eps,
                     cudaStream_t s) {
  constexpr int FULL = 16 / sizeof(typename Type<XT>::T);
  if (vec == FULL)
    return with_nv<XT, WT, FULL>(nv, x, w, out, rows, d, T, pdl, eps, s);
  if (vec == 1)
    return with_nv<XT, WT, 1>(nv, x, w, out, rows, d, T, pdl, eps, s);
  return cudaErrorInvalidValue;
}

template <int XT>
cudaError_t with_w(int wt, int vec, int nv, const void* x, const void* w,
                   void* out, int rows, int d, int T, int pdl, float eps,
                   cudaStream_t s) {
  switch (wt) {
    case 0:
      return with_vec<XT, 0>(vec, nv, x, w, out, rows, d, T, pdl, eps, s);
    case 1:
      return with_vec<XT, 1>(vec, nv, x, w, out, rows, d, T, pdl, eps, s);
    case 2:
      return with_vec<XT, 2>(vec, nv, x, w, out, rows, d, T, pdl, eps, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// One launch of the plan (threads, nv) over x [rows, d] into out, a CTA a
// row; x_dtype and w_dtype are dtype codes, vec the values a unit (16
// bytes of x, or 1), pdl 1 for programmatic dependent launch.  Returns
// cudaErrorInvalidValue for a plan that does not cover every column once,
// else cudaGetLastError() after the launch.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out, int rows,
                           int d, int x_dtype, int w_dtype, int vec,
                           int threads, int nv, int pdl, float eps,
                           void* stream) {
  if (rows < 1 || d < 1 || vec < 1 || d % vec || threads < 32 ||
      threads > MAX_THREADS || (threads & (threads - 1)) || nv < 1 ||
      (long long)threads * nv < d / vec)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      return (int)with_w<0>(w_dtype, vec, nv, x, w, out, rows, d, threads,
                            pdl, eps, s);
    case 1:
      return (int)with_w<1>(w_dtype, vec, nv, x, w, out, rows, d, threads,
                            pdl, eps, s);
    case 2:
      return (int)with_w<2>(w_dtype, vec, nv, x, w, out, rows, d, threads,
                            pdl, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// An empty kernel of one warp, launched as rmsnorm_fwd launches (the
// launch floor beside the forward's time).
__global__ void empty_kernel() {}

extern "C" int rmsnorm_empty(void* stream) {
  return (int)launch_ex(empty_kernel, 1, 32, 0,
                        static_cast<cudaStream_t>(stream));
}
