// Row-invariant matrix product for Hopper, written by hand in CUDA C++:
// C = A @ W, A (M, K) activations, W (K, N) weights, and a batched form
// (E, M, K) x (E, K, N) for a MoE layer's experts.
//
// It replaces no Pallas kernel: the JAX package leaves its products to
// XLA (repro/models/common.py `lin`, `x @ w.astype(x.dtype)`).  The port
// adds it for one property the reference asserts of itself: the
// arithmetic that produces one output row depends only on that row's
// inputs and on K, never on M, N, the batch, the columns a rank holds or
// the call's route.  A library GEMM picks its tile, its split of K and
// (in bf16) a reduced-precision reduction from M and N, so one request's
// logits change with the rows it shares a step with; with this kernel a
// decode of 8 slots, a verify of 9 tokens, a mixed chunk and a rank's
// half of the columns all give each row the bits it gets alone.
//
// How each output element is computed, whatever the shape:
//   * K is cut into splits of a fixed number of columns, kChunk (2048 in
//     bf16, 512 in f32): n_split = ceil(K / kChunk), a function of K and
//     the dtype alone.  Within a split the K tiles run in ascending
//     order; the splits' f32 partials are summed in split order by a
//     second launch (reduce_splits), which also rounds once to C's type.
//     With one split the product kernel writes C itself.
//   * bf16 (gemm_bf16): one CTA tile of 64 x 64 outputs for every M and
//     N, K tiles of 64, four warps of 32 x 32, mma.sync m16n8k16 with f32
//     accumulators (each k16 step one instruction per 16 x 8 block, in
//     ascending k); operands staged by cp.async in a ring of 4 stages and
//     read by ldmatrix (.trans where W's columns are contiguous).
//   * f32 (gemm_f32): the CUDA cores, never TF32: one CTA tile of 64 x 64,
//     K tiles of 16, each thread 4 x 4 outputs, every output an fmaf
//     chain over k in ascending order.
//   * Edge tiles (rows past M, columns past N, k past K) are loaded as
//     zeros: no remainder row or column takes another code path, and a
//     zero product leaves an accumulator unchanged.
//
// What bounds it: at decode (M = 8) the weights' bytes (granite's wg
// streams 104.9 MB, 31 us at 3.35 TB/s); at the production prefill
// (M = 2048) the operations (2.15e11 for wg, 0.217 ms at 989 TFLOP/s).
// The 4-stage ring keeps 32 KB of W in flight a CTA for the former; the
// latter runs mma.sync, not wgmma, a simple kernel first (wgmma and TMA
// are later work).  The splits' partials cost 8 bytes an output and
// split (f32 written and read back).
//
// W may be laid out with its columns (N) contiguous, or its rows (K)
// contiguous (the tied unembedding's W = embed^T); A and C have
// contiguous rows; batch and row strides are arguments.  Rows of 16 bytes
// that are aligned and wholly inside the matrix go by cp.async, the rest
// element by element (zero outside): the values, and so the arithmetic,
// are the same either way.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   -shared -Xcompiler -fPIC; bound to PyTorch through a plain C
//   interface (ctypes), see ops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunkBf16 = 2048;  // K columns of a split, bf16
constexpr int kChunkF32 = 512;    // K columns of a split, f32

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 64, kStages = 4, kThreads = 128;
constexpr int LDS = BK + 8;  // a staged row: 64 values + 8 of padding
constexpr int kTileElems = 64 * LDS;  // every staged tile is 64 x LDS
constexpr int kSmemBf16 = 2 * kStages * kTileElems * (int)sizeof(bf16);

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8; with .trans each is delivered transposed
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// Stage a 64 x 64 block of a matrix whose second index is contiguous
// (row r at src + r * ld) into a [64][LDS] tile: row r valid below
// n_rows, column c below n_cols; 16-byte pieces wholly inside and
// aligned by cp.async, the others element by element, zero outside.
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      long long ld, int n_rows, int n_cols) {
#pragma unroll
  for (int i = 0; i < 64 * 8 / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e >> 3, c = (e & 7) * 8;
    bf16* d = dst + r * LDS + c;
    const bf16* s = src + r * ld + c;
    if (r < n_rows && c + 8 <= n_cols &&
        (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = (r < n_rows && c + j < n_cols) ? s[j] : __float2bfloat16(0.f);
    }
  }
}

struct Args {
  const void* a;
  const void* w;
  void* c;
  float* ws;  // the splits' partials [split][e][m][n] (n_split > 1)
  int M, N, K, n_split;
  long long sa_b, sa_m;        // A: batch and row strides (k contiguous)
  long long sw_b, sw_k, sw_n;  // W: batch stride; sw_k == 1 or sw_n == 1
  long long sc_b, sc_m;        // C: batch and row strides (n contiguous)
};

// One CTA per (64 rows, 64 columns, batch * n_split + split).  kKMajor:
// W's k index is contiguous (staged as [n][k], read by ldmatrix); else
// its n index is (staged as [k][n], read by ldmatrix.trans).
template <bool kKMajor>
__global__ void __launch_bounds__(kThreads)
gemm_bf16(const Args g) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);  // [stage][64][LDS]
  bf16* sw = sa + kStages * kTileElems;          // [stage][64][LDS]

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int E = gridDim.z / g.n_split;
  const int e = blockIdx.z / g.n_split, split = blockIdx.z % g.n_split;
  const int chunk = kChunkBf16;
  const int k_lo = split * chunk;
  const int k_hi = min(g.K, k_lo + chunk);
  const int n_tiles = (k_hi - k_lo + BK - 1) / BK;

  const bf16* A = static_cast<const bf16*>(g.a) + e * g.sa_b +
                  (long long)m0 * g.sa_m;
  const bf16* W = static_cast<const bf16*>(g.w) + e * g.sw_b;
  const int m_rows = g.M - m0;

  auto issue = [&](int t) {
    const int s = t % kStages, k0 = k_lo + t * BK;
    stage(sa + s * kTileElems, A + k0, g.sa_m, m_rows, k_hi - k0);
    if (kKMajor)
      stage(sw + s * kTileElems, W + (long long)n0 * g.sw_n + k0, g.sw_n,
            g.N - n0, k_hi - k0);
    else
      stage(sw + s * kTileElems, W + (long long)k0 * g.sw_k + n0, g.sw_k,
            k_hi - k0, g.N - n0);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int r8 = lane & 7, mi = lane >> 3;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + kStages - 1 < n_tiles) issue(t + kStages - 1);
    cp_async_commit();
    const bf16* ta = sa + (t % kStages) * kTileElems;
    const bf16* tw = sw + (t % kStages) * kTileElems;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm(af[i], ta + (wm + i * 16 + r8 + 8 * (mi & 1)) * LDS + ks * 16 +
                        8 * (mi >> 1));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        if (kKMajor)
          ldsm(r, tw + (wn + p * 16 + r8 + 8 * (mi >> 1)) * LDS + ks * 16 +
                      8 * (mi & 1));
        else
          ldsm_t(r, tw + (ks * 16 + r8 + 8 * (mi & 1)) * LDS + wn + p * 16 +
                        8 * (mi >> 1));
        bfr[2 * p][0] = r[0];
        bfr[2 * p][1] = r[1];
        bfr[2 * p + 1][0] = r[2];
        bfr[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

  // accumulator (i, j, q): row wm + 16 i + lane / 4 + 8 (q / 2), column
  // wn + 8 j + 2 (lane % 4) + q % 2
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + wm + 16 * i + (lane >> 2) + 8 * (q >> 1);
        const int n = n0 + wn + 8 * j + 2 * (lane & 3) + (q & 1);
        if (m >= g.M || n >= g.N) continue;
        if (g.n_split == 1) {
          static_cast<bf16*>(g.c)[e * g.sc_b + (long long)m * g.sc_m + n] =
              __float2bfloat16(acc[i][j][q]);
        } else {
          g.ws[(((long long)split * E + e) * g.M + m) * g.N + n] =
              acc[i][j][q];
        }
      }
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int FK = 16;           // K tile
constexpr int kF32Threads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kF32Threads)
gemm_f32(const Args g) {
  __shared__ float sa[FK][BM + 4];  // [k][m]
  __shared__ float sw[FK][BN + 4];  // [k][n]
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int E = gridDim.z / g.n_split;
  const int e = blockIdx.z / g.n_split, split = blockIdx.z % g.n_split;
  const int k_lo = split * kChunkF32;
  const int k_hi = min(g.K, k_lo + kChunkF32);
  const float* A = static_cast<const float*>(g.a) + e * g.sa_b;
  const float* W = static_cast<const float*>(g.w) + e * g.sw_b;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += FK) {
    // 64 x 16 of A and 16 x 64 of W, 4 values each a thread, zero outside
#pragma unroll
    for (int i = 0; i < BM * FK / kF32Threads; ++i) {
      const int idx = threadIdx.x + i * kF32Threads;
      const int r = idx / FK, kk = idx % FK;
      const int m = m0 + r, k = k0 + kk;
      sa[kk][r] = (m < g.M && k < k_hi) ? A[(long long)m * g.sa_m + k] : 0.f;
      const int kr = idx / BN, c = idx % BN;
      const int kw = k0 + kr, n = n0 + c;
      sw[kr][c] = (kw < k_hi && n < g.N)
                      ? W[(long long)kw * g.sw_k + (long long)n * g.sw_n]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sa[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = sw[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m >= g.M || n >= g.N) continue;
      if (g.n_split == 1)
        static_cast<float*>(g.c)[e * g.sc_b + (long long)m * g.sc_m + n] =
            acc[i][j];
      else
        g.ws[(((long long)split * E + e) * g.M + m) * g.N + n] = acc[i][j];
    }
}

// ---------------------------------------------------------------------------
// the splits' partials, summed in split order, rounded once into C
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(256)
reduce_splits(const float* __restrict__ ws, T* __restrict__ c, int E, int M,
              int N, int n_split, long long sc_b, long long sc_m) {
  const long long per = (long long)E * M * N;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < per;
       i += (long long)gridDim.x * 256) {
    float s = ws[i];
    for (int p = 1; p < n_split; ++p) s += ws[p * per + i];
    const long long e = i / ((long long)M * N);
    const long long rem = i - e * M * N;
    const long long m = rem / N, n = rem - m * N;
    store(c + e * sc_b + m * sc_m + n, s);
  }
}

int splits_of(int dtype, int K) {
  const int chunk = dtype == 1 ? kChunkBf16 : kChunkF32;
  return K <= 0 ? 1 : (K + chunk - 1) / chunk;
}

}  // namespace

// n_split of a product with reduction length K (0 = float32, 1 =
// bfloat16): a function of K and the dtype alone
extern "C" int row_gemm_splits(int dtype, int K) {
  return splits_of(dtype, K);
}

// C[e] = A[e] @ W[e] for e < E.  dtype: 0 = float32, 1 = bfloat16 (A, W
// and C alike).  Strides in elements: A (sa_b, sa_m, 1), W (sw_b, sw_k,
// sw_n) with sw_k == 1 or sw_n == 1, C (sc_b, sc_m, 1).  `ws`: when
// row_gemm_splits(dtype, K) > 1, a workspace of n_split * E * M * N
// floats.  Returns the cudaError_t of the launches (0 = launched).
extern "C" int row_gemm_launch(int dtype, const void* a, const void* w,
                               void* c, void* ws, int E, int M, int N,
                               int K, long long sa_b, long long sa_m,
                               long long sw_b, long long sw_k,
                               long long sw_n, long long sc_b,
                               long long sc_m, void* stream) {
  if (E == 0 || M == 0 || N == 0) return cudaSuccess;
  if (K <= 0 || (sw_k != 1 && sw_n != 1) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int n_split = splits_of(dtype, K);
  if (n_split > 1 && ws == nullptr) return cudaErrorInvalidValue;
  const Args g{a, w, c, static_cast<float*>(ws), M, N, K, n_split,
               sa_b, sa_m, sw_b, sw_k, sw_n, sc_b, sc_m};
  const long long z = (long long)E * n_split;
  if (z > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, (unsigned)z);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    const bool k_major = sw_k == 1 && sw_n != 1;
    auto kern = k_major ? gemm_bf16<true> : gemm_bf16<false>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBf16);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, kSmemBf16, st>>>(g);
  } else {
    gemm_f32<<<grid, kF32Threads, 0, st>>>(g);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const long long per = (long long)E * M * N;
  const unsigned blocks =
      (unsigned)(per / 256 + 1 < 132 * 16 ? per / 256 + 1 : 132 * 16);
  if (dtype == 1)
    reduce_splits<bf16><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(ws), static_cast<bf16*>(c), E, M, N,
        n_split, sc_b, sc_m);
  else
    reduce_splits<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(ws), static_cast<float*>(c), E, M, N,
        n_split, sc_b, sc_m);
  return cudaGetLastError();
}

extern "C" const char* row_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
