// Backward of the SSD chunk scan (K4) for Hopper, written by hand in CUDA
// C++.
//
// It replaces no TPU kernel: the JAX package's Pallas K4
// (repro/kernels/ssd_scan/kernel.py, ssd_intra_chunk_pallas) has no
// backward, and the package trains Mamba2 by autodiff of its plain
// repro.models.mamba2.ssd under jax.checkpoint.  The port runs K4's
// forward in training, so it needs this backward: the gradients of
// (y, final state) = ssd(x, dt, A, B, C, S0) for x (b,T,nh,P), dt
// (b,T,nh), A (nh,), B and C (b,T,G,N) (head h reads group h / (nh/G))
// and S0 (b,nh,P,N) or none, in chunks of Q = min(chunk, T) tokens (the
// last one padded with dt = 0, x = B = C = dy = 0, as the forward pads
// it).  Per chunk, with a_k = dt_k A, cs_i = sum_{k<=i} a_k, S the
// chunk's input state and dS the gradient of its output state:
//
//   states   S_{c+1} = exp(cs_Q) S_c + sum_j exp(cs_Q - cs_j) dt_j x_j (x) B_j
//   reverse  dS_{c-1} = exp(cs_Q) dS_c + sum_i exp(cs_i) dy_i (x) C_i
//   E_ij = exp(cs_i - cs_j) [j <= i],   W = (C B^T) o E dt_j,
//   M = (dy x^T) o E dt_j,   G = (C B^T) o (dy x^T) o E
//   dx_j = sum_i W_ij dy_i + e2_j dt_j dS B_j            e2_j = exp(cs_Q - cs_j)
//   dB_j = sum_i M_ij C_i + e2_j dt_j x_j^T dS
//   dC_i = sum_j M_ij B_j + exp(cs_i) dy_i^T S
//   ddt_j = sum_i G_ij + e2_j u_j + da_j A               u_j = x_j^T dS B_j
//   dcs_i = sum_j dt_j G_ij - dt_i sum_k G_ki + exp(cs_i) dy_i . (S C_i)
//           - e2_i dt_i u_i  [+ exp(cs_Q) <dS, S> + sum_j e2_j dt_j u_j at
//           the chunk's last step]
//   da_k = sum_{i>=k} dcs_i,   dA = sum over (b, T) of da_k dt_k
//
// (ref.ssd_bwd_ref is the same computation in PyTorch, the kernel's
// oracle.)  Every sum is f32; dx has x's dtype, every other gradient is
// f32.
//
// Design: a simple one that is right; making it fast is later work.  Four
// launches on the caller's stream:
//   1. states:  one CTA per (head, batch row) walks the chunks forward and
//      writes each chunk's input state S_c (K4's forward keeps only the
//      final state, so the backward recomputes them);
//   2. dstates: one CTA per (head, batch row) walks them in reverse,
//      writing each chunk's output-state gradient dS_c (and dS0 when the
//      forward had an initial state);
//   3. intra:   one CTA per (chunk, head, batch row) forms the chunk's
//      Q x Q matrices W, M, G in a workspace and every gradient of the
//      chunk from them: dx, ddt, per-head dB and dC, and its dA share;
//   4. reduce:  dB and dC summed over the heads of each group, dA over
//      (batch, chunk), each in a fixed order.
// Every product is one CTA-wide tiled loop (cta_gemm: 64 x 64 output
// tiles, 4 x 4 per thread, 16-deep slices of the operands through shared
// memory) over operands read by functors, so a transpose, a mask or a
// concatenated reduction (dx sums over the chunk's Q queries and then
// over the state's N columns in one loop) is an index, not a copy.
//
// Determinism: no atomics.  Each output is summed by one thread or in a
// fixed tree, and the cross-CTA sums (dB and dC over heads, dA over batch
// rows and chunks) go through per-CTA partials and the fourth launch, so
// repeated calls are bitwise equal.
//
// What bounds it on this card: at the training shapes (mamba2-370m: nh
// 32, P 64, N 128; zamba2-1.2b: nh 64, P 64, N 64; one chunk of ~100-200
// tokens) the Q x Q products are a few GFLOP a call on the CUDA cores in
// f32, and the bytes moved (the inputs once, the gradients once) are a
// few MB: operations bound it.  This first kernel stays off the tensor
// cores and keeps the Q x Q matrices in a device workspace.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   -shared -Xcompiler -fPIC; bound to PyTorch through a plain C
//   interface (ctypes), see ops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 256;
constexpr int kTile = 64;   // output tile of cta_gemm
constexpr int kDepth = 16;  // reduction slice of cta_gemm

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Args {
  const void *x, *B, *C, *dy;   // x's dtype
  const float *dt, *A;
  const float *init, *dstate;   // null: zero initial state / state grad
  void* dx;                     // (b,T,nh,P) contiguous, x's dtype
  float *ddt;                   // (b,T,nh)
  float *dA;                    // (nh,)
  float *dB, *dC;               // (b,T,G,N)
  float *dinit;                 // (b,nh,P,N) or null
  float *S, *dS;                // (b,nc,nh,P,N) workspaces
  float *qq;                    // (b,nc,nh,3,Q,Q) workspace: W, M, G
  float *qp;                    // (b,nc,nh,2,Q,P) workspace: r, s
  float *dBh, *dCh;             // (b,T,nh,N) workspaces: per-head dB, dC
  float *dA_part;               // (b,nc,nh) workspace
  int b, T, nh, P, G, N, Q, nc;
  long long x_sb, x_st, x_sh;   // element strides (last dim contiguous)
  long long dy_sb, dy_st, dy_sh;
  long long dt_sb, dt_st;
  long long b_sb, b_st, b_sg;
  long long c_sb, c_st, c_sg;
};

// out(r, c) for r < M, c < Nc gets sum_{k<K} fa(r, k) fb(k, c), in k's
// order, by the CTA's 256 threads: 64 x 64 output tiles, each thread a
// 4 x 4 block of rows tr + 16 m and columns tc + 16 n, the operands in
// 16-deep slices through shared memory (``sm``: 2 x 16 x 64 floats).
// Every thread of the CTA must call it; it ends on a barrier.
template <class FA, class FB, class FO>
__device__ void cta_gemm(int M, int Nc, int K, FA fa, FB fb, FO fo,
                         float* sm) {
  float* As = sm;
  float* Bs = sm + kDepth * kTile;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  for (int r0 = 0; r0 < M; r0 += kTile) {
    for (int c0 = 0; c0 < Nc; c0 += kTile) {
      float acc[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
      for (int k0 = 0; k0 < K; k0 += kDepth) {
        for (int e = tid; e < kDepth * kTile; e += kThreads) {
          const int kk = e / kTile, rr = e % kTile, k = k0 + kk;
          As[e] = (r0 + rr < M && k < K) ? fa(r0 + rr, k) : 0.f;
          Bs[e] = (c0 + rr < Nc && k < K) ? fb(k, c0 + rr) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kDepth; ++kk) {
          float av[4], bv[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) av[m] = As[kk * kTile + tr + 16 * m];
#pragma unroll
          for (int n = 0; n < 4; ++n) bv[n] = Bs[kk * kTile + tc + 16 * n];
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int n = 0; n < 4; ++n)
              acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int r = r0 + tr + 16 * m, c = c0 + tc + 16 * n;
          if (r < M && c < Nc) fo(r, c, acc[m][n]);
        }
    }
  }
  __syncthreads();
}

// cs[i] = sum_{k<=i} dt_k A_h over the chunk starting at t0 and dts[i] =
// dt_i (0 past T), i < Q: warp 0 scans 32 steps at a time.  Ends on a
// barrier.
__device__ void chunk_cumsum(const Args& a, int bi, int h, int t0,
                             float* cs, float* dts) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float Ah = a.A[h];
    float carry = 0.f;
    for (int base = 0; base < a.Q; base += 32) {
      const int i = base + lane;
      const float d = (i < a.Q && t0 + i < a.T)
          ? a.dt[bi * a.dt_sb + (long long)(t0 + i) * a.dt_st + h] : 0.f;
      float v = d * Ah;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += n;
      }
      v += carry;
      if (i < a.Q) {
        cs[i] = v;
        dts[i] = d;
      }
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
}

// Readers of one batch row's operands at a chunk's local step (0 past
// T), with the pointers and strides copied out of Args.
template <typename TT>
struct Rows {
  const TT *px, *pdy, *pB, *pC;   // at (batch row, step 0, head or group)
  long long x_st, dy_st, b_st, c_st;
  int T, t0;
  __device__ Rows(const Args& a, int bi, int h, int t0_)
      : px(static_cast<const TT*>(a.x) + bi * a.x_sb + h * a.x_sh),
        pdy(static_cast<const TT*>(a.dy) + bi * a.dy_sb + h * a.dy_sh),
        pB(static_cast<const TT*>(a.B) + bi * a.b_sb +
           (h / (a.nh / a.G)) * a.b_sg),
        pC(static_cast<const TT*>(a.C) + bi * a.c_sb +
           (h / (a.nh / a.G)) * a.c_sg),
        x_st(a.x_st), dy_st(a.dy_st), b_st(a.b_st), c_st(a.c_st), T(a.T),
        t0(t0_) {}
  __device__ float x(int j, int p) const {
    const int t = t0 + j;
    return t < T ? ld(px + t * x_st + p) : 0.f;
  }
  __device__ float dy(int i, int p) const {
    const int t = t0 + i;
    return t < T ? ld(pdy + t * dy_st + p) : 0.f;
  }
  __device__ float B(int j, int n) const {
    const int t = t0 + j;
    return t < T ? ld(pB + t * b_st + n) : 0.f;
  }
  __device__ float C(int i, int n) const {
    const int t = t0 + i;
    return t < T ? ld(pC + t * c_st + n) : 0.f;
  }
};

__device__ __forceinline__ size_t state_at(const Args& a, int bi, int c,
                                           int h) {
  return ((size_t(bi) * a.nc + c) * a.nh + h) * size_t(a.P) * a.N;
}

// 1. Each chunk's input state S_c, chunk 0's the initial state (or 0).
template <typename TT>
__global__ void __launch_bounds__(kThreads) states_kernel(Args a) {
  __shared__ float cs[kMaxQ], dts[kMaxQ], sm[2 * kDepth * kTile];
  const int h = blockIdx.x, bi = blockIdx.y, N = a.N;
  const int PN = a.P * N;
  float* S0 = a.S + state_at(a, bi, 0, h);
  for (int e = threadIdx.x; e < PN; e += kThreads)
    S0[e] = a.init ? a.init[(size_t(bi) * a.nh + h) * PN + e] : 0.f;
  __syncthreads();
  for (int c = 0; c + 1 < a.nc; ++c) {
    const int t0 = c * a.Q;
    chunk_cumsum(a, bi, h, t0, cs, dts);
    const Rows<TT> r(a, bi, h, t0);
    const float last = cs[a.Q - 1], decay = expf(last);
    const float* Sc = a.S + state_at(a, bi, c, h);
    float* Sn = a.S + state_at(a, bi, c + 1, h);
    cta_gemm(a.P, a.N, a.Q,
        [&](int p, int j) { return expf(last - cs[j]) * dts[j] * r.x(j, p); },
        [&](int j, int n) { return r.B(j, n); },
        [&](int p, int n, float acc) {
          Sn[p * N + n] = decay * Sc[p * N + n] + acc;
        }, sm);
  }
}

// 2. dS_c, the gradient of chunk c's output state, walking back from the
// final state's (or 0); the gradient of the initial state when asked.
template <typename TT>
__global__ void __launch_bounds__(kThreads) dstates_kernel(Args a) {
  __shared__ float cs[kMaxQ], dts[kMaxQ], sm[2 * kDepth * kTile];
  const int h = blockIdx.x, bi = blockIdx.y, N = a.N;
  const int PN = a.P * N;
  float* dSl = a.dS + state_at(a, bi, a.nc - 1, h);
  for (int e = threadIdx.x; e < PN; e += kThreads)
    dSl[e] = a.dstate ? a.dstate[(size_t(bi) * a.nh + h) * PN + e] : 0.f;
  __syncthreads();
  for (int c = a.nc - 1; c >= (a.dinit ? 0 : 1); --c) {
    const int t0 = c * a.Q;
    chunk_cumsum(a, bi, h, t0, cs, dts);
    const Rows<TT> r(a, bi, h, t0);
    const float decay = expf(cs[a.Q - 1]);
    const float* dSc = a.dS + state_at(a, bi, c, h);
    float* out = c > 0 ? a.dS + state_at(a, bi, c - 1, h)
                       : a.dinit + (size_t(bi) * a.nh + h) * PN;
    cta_gemm(a.P, a.N, a.Q,
        [&](int p, int i) { return expf(cs[i]) * r.dy(i, p); },
        [&](int i, int n) { return r.C(i, n); },
        [&](int p, int n, float acc) {
          out[p * N + n] = decay * dSc[p * N + n] + acc;
        }, sm);
  }
}

// 3. Everything inside one chunk of one head of one batch row.
template <typename TT>
__global__ void __launch_bounds__(kThreads) intra_kernel(Args a) {
  __shared__ float cs[kMaxQ], dts[kMaxQ], rs[kMaxQ], cl[kMaxQ], u[kMaxQ],
      v[kMaxQ], dcs[kMaxQ], red[kThreads], sm[2 * kDepth * kTile];
  const int c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int Q = a.Q, P = a.P, N = a.N, t0 = c * Q, tid = threadIdx.x;
  const int T = a.T, nh = a.nh;
  const Rows<TT> r(a, bi, h, t0);
  const size_t cta = (size_t(bi) * a.nc + c) * nh + h;
  const size_t QQ = size_t(Q) * Q;
  float* W = a.qq + cta * 3 * QQ;
  float* Mm = W + QQ;
  float* Gm = Mm + QQ;
  float* rr = a.qp + cta * 2 * size_t(Q) * P;   // r_j = dS B_j
  float* ss = rr + size_t(Q) * P;               // s_i = S C_i
  const float* S0 = a.S + state_at(a, bi, c, h);
  const float* dS1 = a.dS + state_at(a, bi, c, h);
  chunk_cumsum(a, bi, h, t0, cs, dts);
  const float last = cs[Q - 1];

  // C B^T, then with dy x^T: W, M and G
  cta_gemm(Q, Q, N, [&](int i, int n) { return r.C(i, n); },
           [&](int n, int j) { return r.B(j, n); },
           [&](int i, int j, float acc) { W[i * Q + j] = acc; }, sm);
  cta_gemm(Q, Q, P, [&](int i, int p) { return r.dy(i, p); },
           [&](int p, int j) { return r.x(j, p); },
           [&](int i, int j, float acc) {
             const float cb = W[i * Q + j];
             const float e = j <= i ? expf(cs[i] - cs[j]) : 0.f;
             W[i * Q + j] = cb * e * dts[j];
             Mm[i * Q + j] = acc * e * dts[j];
             Gm[i * Q + j] = cb * acc * e;
           }, sm);
  cta_gemm(Q, P, N, [&](int j, int n) { return r.B(j, n); },
           [&](int n, int p) { return dS1[p * N + n]; },
           [&](int j, int p, float acc) { rr[j * P + p] = acc; }, sm);
  cta_gemm(Q, P, N, [&](int i, int n) { return r.C(i, n); },
           [&](int n, int p) { return S0[p * N + n]; },
           [&](int i, int p, float acc) { ss[i * P + p] = acc; }, sm);

  // per step: G's row and column sums, u and v
  for (int t = tid; t < Q; t += kThreads) {
    float rsum = 0.f, csum = 0.f, uu = 0.f, vv = 0.f;
    for (int j = 0; j <= t; ++j) rsum += dts[j] * Gm[t * Q + j];
    for (int i = t; i < Q; ++i) csum += Gm[i * Q + t];
    for (int p = 0; p < P; ++p) {
      uu += r.x(t, p) * rr[t * P + p];
      vv += r.dy(t, p) * ss[t * P + p];
    }
    rs[t] = rsum;
    cl[t] = csum;
    u[t] = uu;
    v[t] = vv;
  }
  // <dS, S> in a fixed tree
  float part = 0.f;
  for (int e = tid; e < P * N; e += kThreads) part += dS1[e] * S0[e];
  red[tid] = part;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  for (int t = tid; t < Q; t += kThreads) {
    const float e2 = expf(last - cs[t]);
    dcs[t] = rs[t] - dts[t] * cl[t] + expf(cs[t]) * v[t] - e2 * dts[t] * u[t];
  }
  __syncthreads();
  const float Ah = a.A[h];
  if (tid == 0) {
    float tail = expf(last) * red[0];
    for (int j = 0; j < Q; ++j) tail += expf(last - cs[j]) * dts[j] * u[j];
    dcs[Q - 1] += tail;
    float acc = 0.f, dAh = 0.f;
    for (int k = Q - 1; k >= 0; --k) {
      acc += dcs[k];
      dcs[k] = acc;
      dAh += acc * dts[k];
    }
    a.dA_part[cta] = dAh;
  }
  __syncthreads();
  for (int t = tid; t < Q; t += kThreads) {
    if (t0 + t < T)
      a.ddt[(size_t(bi) * T + t0 + t) * nh + h] =
          cl[t] + expf(last - cs[t]) * u[t] + dcs[t] * Ah;
  }

  // dx_j = sum_i W_ij dy_i + e2_j dt_j sum_n B_j[n] dS[:, n]
  TT* dx = static_cast<TT*>(a.dx);
  cta_gemm(Q, P, Q + N,
      [&](int j, int k) {
        return k < Q ? W[k * Q + j]
                     : expf(last - cs[j]) * dts[j] * r.B(j, k - Q);
      },
      [&](int k, int p) { return k < Q ? r.dy(k, p) : dS1[p * N + k - Q]; },
      [&](int j, int p, float acc) {
        if (t0 + j < T)
          st(dx + ((size_t(bi) * T + t0 + j) * nh + h) * P + p, acc);
      }, sm);
  // per-head dB_j = sum_i M_ij C_i + e2_j dt_j sum_p x_j[p] dS[p, :]
  cta_gemm(Q, N, Q + P,
      [&](int j, int k) {
        return k < Q ? Mm[k * Q + j]
                     : expf(last - cs[j]) * dts[j] * r.x(j, k - Q);
      },
      [&](int k, int n) { return k < Q ? r.C(k, n) : dS1[(k - Q) * N + n]; },
      [&](int j, int n, float acc) {
        if (t0 + j < T)
          a.dBh[((size_t(bi) * T + t0 + j) * nh + h) * N + n] = acc;
      }, sm);
  // per-head dC_i = sum_j M_ij B_j + exp(cs_i) sum_p dy_i[p] S[p, :]
  cta_gemm(Q, N, Q + P,
      [&](int i, int k) {
        return k < Q ? Mm[i * Q + k] : expf(cs[i]) * r.dy(i, k - Q);
      },
      [&](int k, int n) { return k < Q ? r.B(k, n) : S0[(k - Q) * N + n]; },
      [&](int i, int n, float acc) {
        if (t0 + i < T)
          a.dCh[((size_t(bi) * T + t0 + i) * nh + h) * N + n] = acc;
      }, sm);
}

// 4. dB and dC over each group's heads, dA over (batch row, chunk), in
// order.
__global__ void __launch_bounds__(kThreads) reduce_kernel(Args a) {
  const int Hg = a.nh / a.G;
  const size_t total = size_t(a.b) * a.T * a.G * a.N;
  for (size_t e = blockIdx.x * size_t(kThreads) + threadIdx.x; e < total;
       e += size_t(gridDim.x) * kThreads) {
    const int n = e % a.N;
    const int g = (e / a.N) % a.G;
    const size_t bt = e / (size_t(a.N) * a.G);
    const size_t base = (bt * a.nh + size_t(g) * Hg) * a.N + n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < Hg; ++k) {
      sb += a.dBh[base + size_t(k) * a.N];
      sc += a.dCh[base + size_t(k) * a.N];
    }
    a.dB[e] = sb;
    a.dC[e] = sc;
  }
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h < a.nh) {
    float s = 0.f;
    for (int i = 0; i < a.b * a.nc; ++i) s += a.dA_part[size_t(i) * a.nh + h];
    a.dA[h] = s;
  }
}

template <typename TT>
cudaError_t launch_all(const Args& a, cudaStream_t s) {
  states_kernel<TT><<<dim3(a.nh, a.b), kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dstates_kernel<TT><<<dim3(a.nh, a.b), kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  intra_kernel<TT><<<dim3(a.nc, a.nh, a.b), kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t total = size_t(a.b) * a.T * a.G * a.N;
  size_t blocks = (total + kThreads - 1) / kThreads;
  const size_t for_heads = (size_t(a.nh) + kThreads - 1) / kThreads;
  if (blocks < for_heads) blocks = for_heads;
  if (blocks > 65535) blocks = 65535;
  reduce_kernel<<<unsigned(blocks), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The backward of one ssd_chunk_scan call.  dtype: 0 float32, 1 bfloat16
// (x, B, C, dy and dx); dt, A, the states and every other gradient f32.
// init / dstate / dinit may be null (zero initial state, zero final-state
// gradient, no initial-state gradient); the workspaces are the caller's
// (ops.py sizes them).  Returns the cudaError_t of the launches.
extern "C" int ssd_scan_bwd_launch(
    int dtype, const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* init, const void* dy, const void* dstate,
    void* dx, void* ddt, void* dA, void* dB, void* dC, void* dinit,
    void* S, void* dS, void* qq, void* qp, void* dBh, void* dCh,
    void* dA_part, int b, int T, int nh, int P, int G, int N, int Q,
    long long x_sb, long long x_st, long long x_sh, long long dy_sb,
    long long dy_st, long long dy_sh, long long dt_sb, long long dt_st,
    long long b_sb, long long b_st, long long b_sg, long long c_sb,
    long long c_st, long long c_sg, void* stream) {
  if (Q < 1 || Q > kMaxQ || G < 1 || nh % G || T < 1 || b < 1 ||
      b > 65535 || nh > 65535)
    return cudaErrorInvalidValue;
  Args a;
  a.x = x; a.B = B; a.C = C; a.dy = dy;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.init = static_cast<const float*>(init);
  a.dstate = static_cast<const float*>(dstate);
  a.dx = dx;
  a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA);
  a.dB = static_cast<float*>(dB);
  a.dC = static_cast<float*>(dC);
  a.dinit = static_cast<float*>(dinit);
  a.S = static_cast<float*>(S);
  a.dS = static_cast<float*>(dS);
  a.qq = static_cast<float*>(qq);
  a.qp = static_cast<float*>(qp);
  a.dBh = static_cast<float*>(dBh);
  a.dCh = static_cast<float*>(dCh);
  a.dA_part = static_cast<float*>(dA_part);
  a.b = b; a.T = T; a.nh = nh; a.P = P; a.G = G; a.N = N; a.Q = Q;
  a.nc = (T + Q - 1) / Q;
  a.x_sb = x_sb; a.x_st = x_st; a.x_sh = x_sh;
  a.dy_sb = dy_sb; a.dy_st = dy_st; a.dy_sh = dy_sh;
  a.dt_sb = dt_sb; a.dt_st = dt_st;
  a.b_sb = b_sb; a.b_st = b_st; a.b_sg = b_sg;
  a.c_sb = c_sb; a.c_st = c_st; a.c_sg = c_sg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_all<float>(a, s) : launch_all<bf16>(a, s);
}

extern "C" const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
