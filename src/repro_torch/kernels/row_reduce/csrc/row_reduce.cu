// Row reductions of the engine path for Hopper, written by hand in CUDA
// C++: RMSNorm (`rms_norm_rows`) and the log-sum-exp of a row of logits
// (`logsumexp_rows`), one CTA a row.
//
// They replace no Pallas kernel: the JAX package leaves both to XLA
// (repro/models/common.py `rms_norm`, repro/engine/sampling.py
// `token_logprobs_at`).  The port adds them for the property
// row_gemm.cu states: a row's result depends only on that row.  PyTorch's
// reductions on the card (torch.mean, torch.logsumexp) choose their
// threads per row from the number of rows, and so sum a row in another
// order in a decode of 8 slots than in a verify of 9 tokens or a step of
// one slot.  Here every row, whatever the call, is summed by 256 threads:
// thread t takes elements t, t + 256, ... in order, then the threads'
// sums meet in a fixed tree (a warp's butterfly, then the 8 warps' sums in
// warp order).
//
//   rms_norm_rows:  out = (x * rsqrt(mean(x^2) + eps)) * w, in f32, cast
//                   to x's type (RMSNorm of common.py, op for op);
//   logsumexp_rows: m + log(sum exp(x - m)), m the row's max (0 where it
//                   is infinite, as torch.logsumexp), on f32 logits.
//
// What bounds them: bytes (a row of d or V values read once, RMSNorm's
// written once); a row is a few KB, so at the engine's 8 to 264 rows the
// launch and the row's latency dominate.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   -shared -Xcompiler -fPIC; bound to PyTorch through a plain C
//   interface (ctypes), see ops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// the block's sum (or max) of each thread's v, in a fixed tree; every
// thread gets it
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_rows(const T* __restrict__ x, const float* __restrict__ w,
              T* __restrict__ out, int d, long long ld_x, float eps) {
  __shared__ float red[kWarps];
  const T* xr = x + blockIdx.x * ld_x;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    s = fmaf(v, v, s);
  }
  s = block_reduce<false>(s, red);
  const float r = rsqrtf(s * (1.f / (float)d) + eps);
  T* o = out + (long long)blockIdx.x * d;
  for (int i = threadIdx.x; i < d; i += kThreads)
    store(o + i, (to_f32(xr[i]) * r) * w[i]);
}

__global__ void __launch_bounds__(kThreads)
logsumexp_rows(const float* __restrict__ x, float* __restrict__ out, int V,
               long long ld_x) {
  __shared__ float red[kWarps];
  const float* xr = x + blockIdx.x * ld_x;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < V; i += kThreads) m = fmaxf(m, xr[i]);
  m = block_reduce<true>(m, red);
  const float mu = isinf(m) ? 0.f : m;
  float s = 0.f;
  for (int i = threadIdx.x; i < V; i += kThreads) s += expf(xr[i] - mu);
  s = block_reduce<false>(s, red);
  if (threadIdx.x == 0) out[blockIdx.x] = logf(s) + mu;
}

}  // namespace

// out (rows, d) contiguous = RMSNorm of x's rows (row stride ld_x, d
// contiguous values each) with the f32 weight w (d,).  dtype: 0 =
// float32, 1 = bfloat16 (x and out).  Returns the cudaError_t of the
// launch.
extern "C" int rms_norm_launch(int dtype, const void* x, const void* w,
                               void* out, int rows, int d, long long ld_x,
                               float eps, void* stream) {
  if (rows == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    rms_norm_rows<float><<<rows, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), d, ld_x, eps);
  else if (dtype == 1)
    rms_norm_rows<__nv_bfloat16><<<rows, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<__nv_bfloat16*>(out), d, ld_x, eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// out (rows,) f32 = the log-sum-exp of each row of x (f32, row stride
// ld_x, V contiguous values each).
extern "C" int logsumexp_launch(const void* x, void* out, int rows, int V,
                                long long ld_x, void* stream) {
  if (rows == 0) return cudaSuccess;
  logsumexp_rows<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), V, ld_x);
  return cudaGetLastError();
}

extern "C" const char* row_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
