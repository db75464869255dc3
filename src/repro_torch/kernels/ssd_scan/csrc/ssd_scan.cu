// SSD chunk scan (K4) of Mamba2 for Hopper, written by hand in CUDA C++.
//
// K4 replaces the Pallas TPU kernel repro/kernels/ssd_scan/kernel.py
// (ssd_intra_chunk_pallas -> pl.pallas_call, body _ssd_kernel) together
// with the inter-chunk recurrence that its wrapper,
// repro/kernels/ssd_scan/ops.py (ssd_chunk_scan), runs as a lax.scan.
// Same function as repro.models.mamba2.ssd: for x (b,T,nh,P), dt (b,T,nh),
// A (nh,), B and C (b,T,G,N) (head h reads group h / (nh/G)) and an
// initial state S (b,nh,P,N), in chunks of Q = min(chunk, T) tokens
// (the last one padded with dt = 0, x = B = C = 0):
//   cs_i     = sum_{k<=i} dt_k A                      (inclusive, in-chunk)
//   y_i      = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//            + exp(cs_i) (C_i S^T)                    (S: the chunk's input)
//   S       <- exp(cs_Q) S + sum_j exp(cs_Q - cs_j) dt_j x_j (x) B_j
// All arithmetic is f32; y has x's dtype, the final state is f32.  A row
// whose dt is 0 throughout keeps its state bit for bit (exp(0) = 1, every
// added term 0): inactive engine slots and padded tokens rely on it.
//
// What bounds it: on the serving path every call is one chunk (Q = T <=
// 65 against a chunk of 256) over 8 slots, and the work is small next to
// the state, which must be read once and written once: 8 x nh x P x N x 4
// bytes each way (8.4 MB for zamba2-1.2b and for mamba2-370m), about 5 us
// at 3.35 TB/s.  The design:
//   * One CTA per (batch, head).  The state S (P x N f32: 16 KiB for
//     zamba2-1.2b, 32 KiB for mamba2-370m) lives in shared memory for the
//     whole chunk loop, so the recurrence never leaves the CTA: the kernel
//     reads the initial state and writes the final one once (the two may
//     be the same buffer: each CTA reads its slice before it writes it).
//   * Per chunk, one thread forms the inclusive cumsum of dt*A in order;
//     then tiles of 32 query rows: C S^T scaled by exp(cs), then for key
//     tiles at or below the diagonal the weights (C.B) exp(cs_i - cs_j)
//     dt_j, computed only where j <= i (the masked half is 0, never
//     exp(-inf) arithmetic), applied to x.  Then the state update over
//     key tiles.  Rows of S, B and C are padded by one float in shared
//     memory so the column walks hit distinct banks.
//   * Every output element is owned by one thread and summed in a fixed
//     order: no atomics, repeated runs are bitwise equal.
// Later work (not here): wgmma for the Q x Q and Q x N products, TMA for
// the tiles, splitting P across CTAs when b x nh underfills the card.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   -shared -Xcompiler -fPIC; bound to PyTorch through a plain C
//   interface (ctypes), see ops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;    // query / key rows per tile
constexpr int kMaxQ = 256;   // largest chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Everything a launch needs besides the element type.
struct Args {
  const void *x, *B, *C;
  const float *dt, *A, *init;  // init: null for a zero initial state
  void* y;
  float* state_out;
  int b, T, nh, P, G, N, Q;
  long long x_sb, x_st, x_sh;  // element strides of x (P contiguous)
  long long dt_sb, dt_st;      // of dt (nh contiguous)
  long long b_sb, b_st, b_sg;  // of B (N contiguous)
  long long c_sb, c_st, c_sg;  // of C (N contiguous)
};

// rows [t, t + n) of a (T, width) operand with row stride `st`, as f32
// into shared rows of stride `ld`; rows at or past T (chunk padding) and
// rows n..kTile-1 are zero
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* src, long long st,
                                          int t, int n, int T_len,
                                          int width) {
  for (int e = threadIdx.x; e < kTile * width; e += kThreads) {
    const int r = e / width, col = e - r * width;
    float v = 0.f;
    if (r < n && t + r < T_len) v = to_f32(src[(t + r) * st + col]);
    dst[r * ld + col] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Args a) {
  extern __shared__ float smem[];
  const int P = a.P, N = a.N, Q = a.Q, T_len = a.T;
  const int ldS = N + 1, ldN = N + 1;
  float* sS = smem;                  // P x (N+1): the carried state
  float* sCs = sS + P * ldS;         // kMaxQ: cumsum of dt*A in the chunk
  float* sDt = sCs + kMaxQ;          // kMaxQ: dt of the chunk
  float* sC = sDt + kMaxQ;           // kTile x (N+1): query rows of C
  float* sB = sC + kTile * ldN;      // kTile x (N+1): key rows of B
  float* sX = sB + kTile * ldN;      // kTile x P: key rows of x
  float* sW = sX + kTile * P;        // kTile x kTile weights (or kTile)
  float* sAcc = sW + kTile * kTile;  // kTile x P: output rows

  const int h = blockIdx.x, bb = blockIdx.y, tid = threadIdx.x;
  const int g = h / (a.nh / a.G);
  const T* x = static_cast<const T*>(a.x) + bb * a.x_sb + h * a.x_sh;
  const T* Bm = static_cast<const T*>(a.B) + bb * a.b_sb + g * a.b_sg;
  const T* Cm = static_cast<const T*>(a.C) + bb * a.c_sb + g * a.c_sg;
  const float* dt = a.dt + bb * a.dt_sb + h;
  T* y = static_cast<T*>(a.y) + ((long long)bb * T_len * a.nh + h) * P;
  const long long y_st = (long long)a.nh * P;
  const float Ah = a.A[h];
  const long long s0 = ((long long)bb * a.nh + h) * P * N;

  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    sS[p * ldS + n] = a.init ? a.init[s0 + e] : 0.f;
  }

  const int n_chunks = (T_len + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    for (int i = tid; i < Q; i += kThreads)
      sDt[i] = t0 + i < T_len ? dt[(t0 + i) * a.dt_st] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int i = 0; i < Q; ++i) {
        s += sDt[i] * Ah;
        sCs[i] = s;
      }
    }
    __syncthreads();

    // ---- outputs, one tile of query rows at a time ----
    for (int i0 = 0; i0 < Q && t0 + i0 < T_len; i0 += kTile) {
      const int ni = min(kTile, Q - i0);
      load_rows(sC, ldN, Cm, a.c_st, t0 + i0, ni, T_len, N);
      __syncthreads();
      // carried-state term: exp(cs_i) * (C_i . S_p)
      for (int e = tid; e < kTile * P; e += kThreads) {
        const int i = e / P, p = e - i * P;
        float acc = 0.f;
        if (i < ni) {
          const float* cr = sC + i * ldN;
          const float* sr = sS + p * ldS;
          for (int n = 0; n < N; ++n) acc += cr[n] * sr[n];
          acc *= expf(sCs[i0 + i]);
        }
        sAcc[e] = acc;
      }
      // intra-chunk term over the key tiles at or below the diagonal
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        const int nj = min(kTile, Q - j0);
        __syncthreads();
        load_rows(sB, ldN, Bm, a.b_st, t0 + j0, nj, T_len, N);
        load_rows(sX, P, x, a.x_st, t0 + j0, nj, T_len, P);
        __syncthreads();
        for (int e = tid; e < kTile * kTile; e += kThreads) {
          const int i = e / kTile, j = e - i * kTile;
          float w = 0.f;
          if (i < ni && j < nj && j0 + j <= i0 + i) {
            const float* cr = sC + i * ldN;
            const float* br = sB + j * ldN;
            float dot = 0.f;
            for (int n = 0; n < N; ++n) dot += cr[n] * br[n];
            w = dot * expf(sCs[i0 + i] - sCs[j0 + j]) * sDt[j0 + j];
          }
          sW[e] = w;
        }
        __syncthreads();
        for (int e = tid; e < kTile * P; e += kThreads) {
          const int i = e / P, p = e - i * P;
          float acc = sAcc[e];
          for (int j = 0; j < nj; ++j) acc += sW[i * kTile + j] * sX[j * P + p];
          sAcc[e] = acc;
        }
      }
      __syncthreads();
      for (int e = tid; e < kTile * P; e += kThreads) {
        const int i = e / P, p = e - i * P;
        if (i < ni && t0 + i0 + i < T_len)
          store_out(y + (t0 + i0 + i) * y_st + p, sAcc[e]);
      }
      __syncthreads();
    }

    // ---- state update: S <- exp(cs_Q) S + sum_j w_j x_j (x) B_j ----
    const float total = sCs[Q - 1];
    const float decay = expf(total);
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      sS[p * ldS + n] *= decay;
    }
    for (int j0 = 0; j0 < Q && t0 + j0 < T_len; j0 += kTile) {
      const int nj = min(kTile, Q - j0);
      __syncthreads();
      load_rows(sB, ldN, Bm, a.b_st, t0 + j0, nj, T_len, N);
      load_rows(sX, P, x, a.x_st, t0 + j0, nj, T_len, P);
      for (int j = tid; j < kTile; j += kThreads)
        sW[j] = j < nj ? sDt[j0 + j] * expf(total - sCs[j0 + j]) : 0.f;
      __syncthreads();
      for (int e = tid; e < P * N; e += kThreads) {
        const int p = e / N, n = e - p * N;
        float acc = sS[p * ldS + n];
        for (int j = 0; j < nj; ++j)
          acc += sB[j * ldN + n] * sW[j] * sX[j * P + p];
        sS[p * ldS + n] = acc;
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    a.state_out[s0 + e] = sS[p * ldS + n];
  }
}

size_t smem_bytes(int P, int N) {
  return sizeof(float) * ((size_t)P * (N + 1) + 2 * kMaxQ +
                          2 * kTile * (N + 1) + kTile * P + kTile * kTile +
                          kTile * P);
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.P, a.N);
  auto kern = ssd_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.nh, a.b);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt, A, init_state and
// state_out are float32.  x (b,T,nh,P), dt (b,T,nh), B and C (b,T,G,N)
// with the given element strides and a contiguous last dim; y contiguous
// (b,T,nh,P); init_state (null: zeros) and state_out contiguous
// (b,nh,P,N), possibly the same buffer.  Q = min(chunk, T) <= 256.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* dt,
                               const void* A, const void* B, const void* C,
                               const void* init_state, void* y,
                               void* state_out, int b, int T, int nh, int P,
                               int G, int N, int Q, long long x_sb,
                               long long x_st, long long x_sh,
                               long long dt_sb, long long dt_st,
                               long long b_sb, long long b_st,
                               long long b_sg, long long c_sb,
                               long long c_st, long long c_sg,
                               void* stream) {
  if (Q < 1 || Q > kMaxQ || nh % G) return cudaErrorInvalidValue;
  const Args a{x, B, C, static_cast<const float*>(dt),
               static_cast<const float*>(A),
               static_cast<const float*>(init_state), y,
               static_cast<float*>(state_out), b, T, nh, P, G, N, Q,
               x_sb, x_st, x_sh, dt_sb, dt_st, b_sb, b_st, b_sg, c_sb, c_st,
               c_sg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
