// SSD chunk scan (K4) of Mamba2 for Hopper, written by hand in CUDA C++:
// three routes, chosen by a table of the shape alone.
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
// All sums are f32; y has x's dtype, the state is f32.  A row whose dt is
// 0 throughout keeps its state bit for bit (exp(0) = 1, every added term
// 0): inactive engine slots and padded tokens rely on it.
//
// What bounds it on this card.  The serving path calls K4 once per
// Mamba2 block and forward with T = the step's width (1 at decode, 2-9 at
// verify, up to 64 in a prefill chunk) over 8 slots, so every call is one
// chunk and must read the state once and write it once: 8 x nh x P x N x
// 4 bytes each way (8.4 MB for zamba2-1.2b and for mamba2-370m), 5.0 us
// at 3.35 TB/s, beside which x, B, C and y are small.  So the floor is
// the state's traffic, and what keeps a kernel from it is latency: how
// many of the state's bytes are in flight at once, and how many dependent
// round trips (a load waited for, a barrier) a CTA makes before it can
// store.  The route is a table of (dtype, T, P, N) alone (route_of):
//
//   Recurrent (T <= 16, every dtype; decode is T = 1): T steps of the
//   one-pass form
//       S <- exp(dt_t A) S + (dt_t x_t) (x) B_t,   y_t = S . C_t
//   on the state held in registers.  A row of the state is N floats over
//   N/16 lanes, four 16-byte vectors each; every thread issues all its
//   state loads, and x, B, C and dt of every step go to shared memory by
//   cp.async, before anything is waited for (at T = 1 the step's operands
//   go straight to registers, with no barrier at all); the dot with C is
//   a shuffle reduction inside the row's few lanes; the state leaves with
//   16-byte streaming stores.  Its work grows with T at ~3 FMAs per state
//   element and step, about 0.5 us a step at these shapes, so it is the
//   route up to T = 16; the chunked form on the tensor cores takes over
//   above (measured: recurrent faster at T = 1-9 for both models, the
//   tensor cores at T = 64).
//
//   Tensor cores (bf16, T > 16): the chunked form, its four products on
//   mma.sync m16n8k16 (f32 accumulate) over query tiles of 16 or 32 rows,
//   one 16-row strip per warp: C B^T (C, B are bf16: exact inputs),
//   masked to j <= i and weighted into W in registers, whose accumulator
//   fragment is the next product's A fragment; W x; C S^T; and the state
//   update (B o w)^T x, accumulated onto exp(cs_Q) S in registers.  The
//   f32 operands (W, B o w, S) go in as hi/lo bf16 pairs (v = hi + lo,
//   two products each), about 16 bits of mantissa: plain bf16 for them
//   comes close to the 3e-2 tolerance near y = 0 and compounds in the
//   carried state.  x, B and C stay in shared memory as they lie in
//   device memory, and ldmatrix (with .trans where the product wants the
//   transpose) forms every fragment, so nothing is transposed by hand;
//   the first tiles, dt and the state are all in flight before the first
//   wait.  mma.sync rather than wgmma: a 16-row strip pads far less than
//   wgmma's 64 rows at these widths.  The cumsum is a warp scan.
//
//   CUDA cores (f32 from T = 17, and what the others cannot take): the
//   chunk loop on f32 with the state in shared memory, each product
//   register-tiled (a thread owns a 2 x 2, 2 x 4 or 4 x 4 block of
//   outputs and reads each operand once per step as a vector), 16-byte
//   state loads and stores, the cumsum by warp scan.
//
// Every route splits the state's P rows over n_split CTAs (a grid of
// (nh, b, n_split)), n_split a function of the shape (splits_of): a state
// row p depends only on x[:, p], S[p, :] and the chunk's weights, which
// each CTA recomputes, so the split is exact with no merge, each CTA
// reads and writes only its own rows (the in-place update stays safe),
// and a row's arithmetic is the same whatever n_split is: the results are
// bitwise independent of it.  Every output is summed in a fixed order
// with no atomics, so repeated runs are bitwise equal; two routes agree
// only to the tolerance, and a shape always takes the same route.  A
// launch the card refuses returns its error; nothing falls back.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   -shared -Xcompiler -fPIC; bound to PyTorch through a plain C
//   interface (ctypes), see ops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxQ = 256;       // largest chunk
constexpr int kTargetCtas = 264; // a grid of two CTAs per SM of 132
constexpr int kMaxSmem = 232448; // dynamic shared memory a block may use

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
// component q of a float4 (q a constant after unrolling)
__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// Everything a launch needs besides the element type.
struct Args {
  const void *x, *B, *C;
  const float *dt, *A, *init;  // init: null for a zero initial state
  void* y;
  float* state_out;
  int b, T, nh, P, G, N, Q;
  int p_tile;                  // state rows per CTA: P / n_split
  long long x_sb, x_st, x_sh;  // element strides of x (P contiguous)
  long long dt_sb, dt_st;      // of dt (nh contiguous)
  long long b_sb, b_st, b_sg;  // of B (N contiguous)
  long long c_sb, c_st, c_sg;  // of C (N contiguous)
};

// Inclusive cumsum of dt_i * A over the chunk's Q <= 256 steps by one warp:
// each lane sums its ceil(Q/32) consecutive steps in order, a shuffle scan
// adds the lanes before it.  The order is a function of Q alone.
__device__ __forceinline__ void warp_cumsum(const float* dt, float* cs,
                                            int Q, float A) {
  const int lane = threadIdx.x & 31;
  const int per = (Q + 31) / 32;
  const int i0 = lane * per;
  float run = 0.f;
  for (int k = 0; k < per; ++k)
    if (i0 + k < Q) {
      run += dt[i0 + k] * A;
      cs[i0 + k] = run;
    }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const float before = incl - run;
  for (int k = 0; k < per; ++k)
    if (i0 + k < Q) cs[i0 + k] += before;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying `rows` rows of `row_bytes` bytes each (row stride
// `st_bytes` in the source, `ld_bytes` in shared memory): rows below
// n_real by cp.async, 16 bytes at a time, when the source and the row
// allow it (else synchronously, two bytes at a time), the rest zero.
// `ld_bytes` is a multiple of 16 and `dst` 16-byte aligned.
template <int kThreads>
__device__ __forceinline__ void issue_rows(void* dst, int ld_bytes,
                                           const void* src,
                                           long long st_bytes, int n_real,
                                           int rows, int row_bytes) {
  uint8_t* d = static_cast<uint8_t*>(dst);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  if (((reinterpret_cast<uintptr_t>(src) | (uintptr_t)st_bytes |
        (uintptr_t)row_bytes) & 15) == 0) {
    const int V = row_bytes / 16;
    for (int e = threadIdx.x; e < rows * V; e += kThreads) {
      const int r = e / V, c = e - r * V;
      if (r < n_real)
        cp_async16(d + r * ld_bytes + c * 16, s + r * st_bytes + c * 16);
      else
        *reinterpret_cast<uint4*>(d + r * ld_bytes + c * 16) =
            make_uint4(0, 0, 0, 0);
    }
  } else {
    const int V = row_bytes / 2;
    for (int e = threadIdx.x; e < rows * V; e += kThreads) {
      const int r = e / V, c = e - r * V;
      *reinterpret_cast<uint16_t*>(d + r * ld_bytes + c * 2) =
          r < n_real
              ? *reinterpret_cast<const uint16_t*>(s + r * st_bytes + c * 2)
              : (uint16_t)0;
    }
  }
}

// ===========================================================================
// recurrent route: T <= kRecMaxT steps of the one-pass form, the state in
// registers
// ===========================================================================
namespace recurrent {

constexpr int kThreads = 128;

// A row of N state floats is spread over LANES lanes (one for each 16
// columns, at most 32), VPT 16-byte vectors each: lane l holds columns
// 4 (v LANES + l) .. + 3.  A CTA covers ROWS rows per pass and PASSES
// passes.  Few lanes a row keep the shuffle reduction of y short.
template <int N>
struct Shape {
  static constexpr int LANES = N / 16 < 1 ? 1 : N / 16 > 32 ? 32 : N / 16;
  static constexpr int VPT = N / 4 / LANES;
  static constexpr int ROWS = kThreads / LANES;
};

// shared memory: x (T rows of the slice's pt columns), B and C (T rows of
// N), each row padded to 16 bytes, then dt (T floats)
struct Layout {
  int ldX, ldN, X, B, C, DT, end;   // in bytes
  __host__ __device__ Layout(int T, int pt, int N, int es) {
    ldX = (pt * es + 15) / 16 * 16;
    ldN = N * es;
    X = 0;
    B = X + T * ldX;
    C = B + T * ldN;
    DT = C + T * ldN;
    end = DT + T * 4;
  }
};

// four consecutive values from shared memory as f32: one vector load
__device__ __forceinline__ void ld4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void ld4(const bf16* p, float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// T steps of S <- exp(dt_t A) S + (dt_t x_t) (x) B_t, y_t = S . C_t, for
// one (head, batch row, P-slice).  Every load is issued before the first
// is waited for: the state slice into registers, and x, B, C, dt of every
// step into shared memory by cp.async (at T = 1, straight into registers,
// with no barrier).  The dot with C is a shuffle reduction inside the
// row's lanes; the state leaves with 16-byte streaming stores.
template <typename T, int N, int PASSES>
__global__ void __launch_bounds__(kThreads) ssd_recurrent(Args a) {
  using S_ = Shape<N>;
  constexpr int LANES = S_::LANES, VPT = S_::VPT, ROWS = S_::ROWS;
  const int tid = threadIdx.x;
  const int col = tid % LANES, rsub = tid / LANES;
  const int h = blockIdx.x, bb = blockIdx.y;
  const int pt = a.p_tile, p0 = blockIdx.z * pt;
  const int g = h / (a.nh / a.G);
  const int T_len = a.T;
  const bool staged = T_len > 1;
  const long long s0 = (((long long)bb * a.nh + h) * a.P + p0) * N;
  const Layout L(T_len, pt, N, (int)sizeof(T));
  extern __shared__ __align__(16) uint8_t smem[];

  const T* x = static_cast<const T*>(a.x) + bb * a.x_sb + h * a.x_sh + p0;
  const T* Bm = static_cast<const T*>(a.B) + bb * a.b_sb + g * a.b_sg;
  const T* Cm = static_cast<const T*>(a.C) + bb * a.c_sb + g * a.c_sg;
  const float* dtp = a.dt + bb * a.dt_sb + h;
  float* sdt = reinterpret_cast<float*>(smem + L.DT);
  if (staged) {
    issue_rows<kThreads>(smem + L.X, L.ldX, x, a.x_st * sizeof(T), T_len,
                         T_len, pt * (int)sizeof(T));
    issue_rows<kThreads>(smem + L.B, L.ldN, Bm, a.b_st * sizeof(T), T_len,
                         T_len, L.ldN);
    issue_rows<kThreads>(smem + L.C, L.ldN, Cm, a.c_st * sizeof(T), T_len,
                         T_len, L.ldN);
    for (int t = tid; t < T_len; t += kThreads) sdt[t] = dtp[t * a.dt_st];
  }
  float4 s[PASSES][VPT];
  const float4* src = reinterpret_cast<const float4*>(a.init + s0);
#pragma unroll
  for (int k = 0; k < PASSES; ++k) {
    const int r = k * ROWS + rsub;
#pragma unroll
    for (int v = 0; v < VPT; ++v)
      s[k][v] = (a.init && r < pt)
                    ? __ldcs(src + r * (N / 4) + v * LANES + col)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float A = a.A[h];
  // decode: the step's operands straight from device memory
  float bv[VPT][4], cv[VPT][4], xv[PASSES], dt0 = 0.f;
  if (!staged) {
    dt0 = dtp[0];
#pragma unroll
    for (int v = 0; v < VPT; ++v)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bv[v][c] = to_f32(Bm[4 * (v * LANES + col) + c]);
        cv[v][c] = to_f32(Cm[4 * (v * LANES + col) + c]);
      }
#pragma unroll
    for (int k = 0; k < PASSES; ++k) {
      const int r = k * ROWS + rsub;
      xv[k] = r < pt ? to_f32(x[r]) : 0.f;
    }
  } else {
    cp_async_wait_all();
    __syncthreads();
  }

  T* y = static_cast<T*>(a.y) + ((long long)bb * T_len * a.nh + h) * a.P +
         p0;
  const long long y_st = (long long)a.nh * a.P;
  for (int t = 0; t < T_len; ++t) {
    const float dt = staged ? sdt[t] : dt0;
    const float decay = expf(dt * A);
    if (staged) {
      const T* xs = reinterpret_cast<const T*>(smem + L.X + t * L.ldX);
      const T* bs = reinterpret_cast<const T*>(smem + L.B + t * L.ldN);
      const T* cs = reinterpret_cast<const T*>(smem + L.C + t * L.ldN);
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        ld4(bs + 4 * (v * LANES + col), bv[v]);
        ld4(cs + 4 * (v * LANES + col), cv[v]);
      }
#pragma unroll
      for (int k = 0; k < PASSES; ++k) {
        const int r = k * ROWS + rsub;
        xv[k] = r < pt ? to_f32(xs[r]) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < PASSES; ++k) {
      const int r = k * ROWS + rsub;
      const float u = dt * xv[k];
      float acc = 0.f;
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        float4& n = s[k][v];
        n.x = __fmaf_rn(u, bv[v][0], __fmul_rn(decay, n.x));
        n.y = __fmaf_rn(u, bv[v][1], __fmul_rn(decay, n.y));
        n.z = __fmaf_rn(u, bv[v][2], __fmul_rn(decay, n.z));
        n.w = __fmaf_rn(u, bv[v][3], __fmul_rn(decay, n.w));
        acc = __fmaf_rn(n.x, cv[v][0], acc);
        acc = __fmaf_rn(n.y, cv[v][1], acc);
        acc = __fmaf_rn(n.z, cv[v][2], acc);
        acc = __fmaf_rn(n.w, cv[v][3], acc);
      }
      // the row's lanes are LANES consecutive lanes of one warp
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (col == 0 && r < pt) store_out(y + t * y_st + r, acc);
    }
  }
  float4* dst = reinterpret_cast<float4*>(a.state_out + s0);
#pragma unroll
  for (int k = 0; k < PASSES; ++k) {
    const int r = k * ROWS + rsub;
    if (r < pt)
#pragma unroll
      for (int v = 0; v < VPT; ++v)
        __stcs(dst + r * (N / 4) + v * LANES + col, s[k][v]);
  }
}

}  // namespace recurrent

// ===========================================================================
// tensor-core route: bf16, mma.sync m16n8k16
// ===========================================================================
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory, each lane giving one row
// address (lane l: matrix l / 8, row l % 8); with .trans each is
// delivered transposed
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

// The lane's row address for each fragment, with r8 = lane % 8 and
// mi = lane / 8 (every tile below has rows a multiple of 16 bytes apart):
//   A (16 x 16 at m0, k0) of a row-major [m][k] tile:
//     row m0 + r8 + 8 (mi & 1), column k0 + 8 (mi >> 1)    -> ldsm
//   A of the transpose of a row-major [k][m] tile:
//     row k0 + r8 + 8 (mi >> 1), column m0 + 8 (mi & 1)    -> ldsm_t
//   B of two n-tiles (k0, n0 .. n0 + 15) of a row-major [n][k] tile:
//     row n0 + r8 + 8 (mi >> 1), column k0 + 8 (mi & 1)    -> ldsm
//   B of two n-tiles of a row-major [k][n] tile:
//     row k0 + r8 + 8 (mi & 1), column n0 + 8 (mi >> 1)    -> ldsm_t
// giving {a0, a1, a2, a3} or {b0, b1} of n-tile 0 then of n-tile 1.

__device__ __forceinline__ uint32_t pack(bf16 lo_col, bf16 hi_col) {
  return (uint32_t)__bfloat16_as_ushort(lo_col) |
         ((uint32_t)__bfloat16_as_ushort(hi_col) << 16);
}

// v = hi + lo in bf16, two values of adjacent columns packed per register
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const bf16 h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
  hi = pack(h0, h1);
  lo = pack(__float2bfloat16_rn(v0 - __bfloat162float(h0)),
            __float2bfloat16_rn(v1 - __bfloat162float(h1)));
}

// Shared memory of a chunk of Q rows, in tiles of R rows (16 up to Q = 16,
// else 32), in bf16 elements up to the f32 arrays at `end`; every array is
// natural (rows as they lie in device memory), so the operands that need a
// transpose get it from ldmatrix.
struct Layout {
  int R, ldN, ldX, nq;
  int C, B, X, BW_HI, BW_LO, S_HI, S_LO, end;
  __host__ __device__ Layout(int N, int PT, int Q) {
    R = Q <= 16 ? 16 : 32;
    ldN = N + 8;                 // rows of N: C, B, B o w, S
    ldX = PT + 8;                // rows of x
    nq = max((Q + 3) / 4 * 4, R);  // floats of each per-step array
    C = 0;                       // [R][N+8]
    B = C + R * ldN;             // [R][N+8]
    X = B + R * ldN;             // [R][PT+8]
    BW_HI = X + R * ldX;         // [R][N+8]
    BW_LO = BW_HI + R * ldN;     // [R][N+8]
    S_HI = BW_LO + R * ldN;      // [PT][N+8]
    S_LO = S_HI + PT * ldN;      // [PT][N+8]
    end = S_LO + PT * ldN;       // then dt, cumsum, state weights
  }
  __host__ __device__ size_t bytes() const {
    return (size_t)end * 2 + 3 * nq * sizeof(float);
  }
};

// One CTA per (head, batch row, P-split).  The state slice PT x N lives in
// the warps' accumulator registers across chunks (warp w: p-strip w % MT,
// NTW n-tiles of 8 from nt0, NTW even).  For y, warp w takes the 16-row
// strip w % strips of each query tile and pnw consecutive n-tiles of 8
// columns of p from (w / strips) pnw (strips = R / 16, groups of p-tiles
// min(4 / strips, PT / 16), so 2 <= pnw <= max(2, PT / 16); a warp past
// the last group has no y to compute).
template <int N, int PT>
__global__ void __launch_bounds__(kThreads, 1) ssd_tensor_cores(Args a) {
  constexpr int MT = PT / 16;                  // p-strips of the slice
  constexpr int NTW = (N / 8) * MT / kWarps;   // n-tiles of a warp's state
  constexpr int KN = N / 16;                   // k-steps over N
  constexpr int PN = PT / 8;                   // n-tiles over p
  constexpr int PW = PN / 2 < 2 ? 2 : PN / 2;  // most n-tiles of p a warp
  static_assert(NTW % 2 == 0, "state n-tiles come in pairs");

  const int Q = a.Q, T_len = a.T;
  const Layout L(N, PT, Q);
  const int R = L.R, ldN = L.ldN, ldX = L.ldX;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16 *sC = sm + L.C, *sB = sm + L.B, *sX = sm + L.X;
  bf16 *sBwHi = sm + L.BW_HI, *sBwLo = sm + L.BW_LO;
  bf16 *sSHi = sm + L.S_HI, *sSLo = sm + L.S_LO;
  float* sDt = reinterpret_cast<float*>(sm + L.end);
  float* sCs = sDt + L.nq;      // inclusive cumsum of dt A
  float* sWst = sCs + L.nq;     // dt_j exp(cs_Q - cs_j)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row / column pair
  const int r8 = lane & 7, mlo = (lane >> 3) & 1, mhi = lane >> 4;
  const int strips = R / 16;
  const int groups = min(kWarps / strips, PN / 2);
  const int ws = warp % strips, wg = warp / strips;
  const int pnw = PN / groups;              // the warp's n-tiles of p
  const int pw0 = wg * pnw * 8;             // its first column of p
  const int h = blockIdx.x, bb = blockIdx.y;
  const int p0 = blockIdx.z * PT;
  const int grp = h / (a.nh / a.G);
  const bf16* x = static_cast<const bf16*>(a.x) + bb * a.x_sb + h * a.x_sh +
                  p0;
  const bf16* Bm = static_cast<const bf16*>(a.B) + bb * a.b_sb +
                   grp * a.b_sg;
  const bf16* Cm = static_cast<const bf16*>(a.C) + bb * a.c_sb +
                   grp * a.c_sg;
  const float* dtp = a.dt + bb * a.dt_sb + h;
  bf16* y = static_cast<bf16*>(a.y) + ((long long)bb * T_len * a.nh + h) *
                                          a.P + p0;
  const long long y_st = (long long)a.nh * a.P;
  const float Ah = a.A[h];
  const long long s0 = (((long long)bb * a.nh + h) * a.P + p0) * N;

  // tiles in shared memory, as chunk * 8 + tile
  int c_tile = 0, kv_tile = 0;
  auto issue_c = [&](int t0, int i0, int n_real) {
    issue_rows<kThreads>(sC, 2 * ldN, Cm + (t0 + i0) * a.c_st, 2 * a.c_st,
                         n_real - i0, R, 2 * N);
  };
  auto issue_kv = [&](int t0, int j0, int n_real) {
    issue_rows<kThreads>(sB, 2 * ldN, Bm + (t0 + j0) * a.b_st, 2 * a.b_st,
                         n_real - j0, R, 2 * N);
    issue_rows<kThreads>(sX, 2 * ldX, x + (t0 + j0) * a.x_st, 2 * a.x_st,
                         n_real - j0, R, 2 * PT);
  };

  // every load of the first chunk's first tiles, dt and the state slice is
  // in flight before any is waited for
  {
    const int n_real = min(Q, T_len);
    issue_c(0, 0, n_real);
    issue_kv(0, 0, n_real);
    for (int i = tid; i < Q; i += kThreads)
      sDt[i] = i < n_real ? dtp[i * a.dt_st] : 0.f;
  }
  const int ms = warp % MT, nt0 = (warp / MT) * NTW;
  float st[NTW][4];
  {
    const int r0 = ms * 16 + gq;
#pragma unroll
    for (int t = 0; t < NTW; ++t) {
      const int n = (nt0 + t) * 8 + 2 * tq;
      float2 lo = make_float2(0.f, 0.f), hi = lo;
      if (a.init) {
        lo = __ldcs(reinterpret_cast<const float2*>(a.init + s0 + r0 * N + n));
        hi = __ldcs(reinterpret_cast<const float2*>(a.init + s0 +
                                                    (r0 + 8) * N + n));
      }
      st[t][0] = lo.x; st[t][1] = lo.y; st[t][2] = hi.x; st[t][3] = hi.y;
    }
  }
  cp_async_wait_all();

  const int n_chunks = (T_len + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int n_real = min(Q, T_len - t0);   // rows of the chunk with data
    __syncthreads();   // the tiles have landed; the last chunk is done
    if (c > 0)
      for (int i = tid; i < Q; i += kThreads)
        sDt[i] = i < n_real ? dtp[(t0 + i) * a.dt_st] : 0.f;
    // the chunk's input state, hi / lo, for C S^T
#pragma unroll
    for (int t = 0; t < NTW; ++t) {
      const int n = (nt0 + t) * 8 + 2 * tq, r = ms * 16 + gq;
      uint32_t hi, lo;
      split2(st[t][0], st[t][1], hi, lo);
      *reinterpret_cast<uint32_t*>(sSHi + r * ldN + n) = hi;
      *reinterpret_cast<uint32_t*>(sSLo + r * ldN + n) = lo;
      split2(st[t][2], st[t][3], hi, lo);
      *reinterpret_cast<uint32_t*>(sSHi + (r + 8) * ldN + n) = hi;
      *reinterpret_cast<uint32_t*>(sSLo + (r + 8) * ldN + n) = lo;
    }
    __syncthreads();
    if (warp == 0) {
      warp_cumsum(sDt, sCs, Q, Ah);
      __syncwarp();
      const float tot = sCs[Q - 1];
      for (int i = lane; i < Q; i += 32)
        sWst[i] = __fmul_rn(sDt[i], expf(tot - sCs[i]));
    }
    __syncthreads();
    const float decay = expf(sCs[Q - 1]);
#pragma unroll
    for (int t = 0; t < NTW; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[t][e] = __fmul_rn(decay, st[t][e]);

    for (int i0 = 0; i0 < n_real; i0 += R) {
      const int ti = c * 8 + i0 / R;
      if (c_tile != ti) {
        __syncthreads();
        issue_c(t0, i0, n_real);
        cp_async_wait_all();
        __syncthreads();
        c_tile = ti;
      }
      const int r_lo = i0 + ws * 16;        // the warp's strip, in-chunk
      const bool live = r_lo < n_real && wg < groups;
      // the strip's A fragments of C come from these rows
      const bf16* a_c = sC + (ws * 16 + r8 + 8 * mlo) * ldN + 8 * mhi;
      float acc[PW][4];
#pragma unroll
      for (int q = 0; q < PW; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
      if (live) {
        // carried-state term: exp(cs_i) (C_i S^T), S as hi + lo
        const int so = (pw0 + r8 + 8 * mhi) * ldN + 8 * mlo;
#pragma unroll 1
        for (int k = 0; k < KN; ++k) {
          uint32_t af[4];
          ldsm(af, a_c + k * 16);
#pragma unroll
          for (int q = 0; q < PW; q += 2) {
            if (q >= pnw) break;
            uint32_t bh[4], bl[4];
            ldsm(bh, sSHi + so + q * 8 * ldN + k * 16);
            ldsm(bl, sSLo + so + q * 8 * ldN + k * 16);
            mma(acc[q], af, bh[0], bh[1]);
            mma(acc[q], af, bl[0], bl[1]);
            mma(acc[q + 1], af, bh[2], bh[3]);
            mma(acc[q + 1], af, bl[2], bl[3]);
          }
        }
        const float e0 = expf(sCs[r_lo + gq]), e1 = expf(sCs[r_lo + gq + 8]);
#pragma unroll
        for (int q = 0; q < PW; ++q) {
          acc[q][0] = __fmul_rn(acc[q][0], e0);
          acc[q][1] = __fmul_rn(acc[q][1], e0);
          acc[q][2] = __fmul_rn(acc[q][2], e1);
          acc[q][3] = __fmul_rn(acc[q][3], e1);
        }
      }
      // intra-chunk term over key tiles 0 .. i0
      for (int j0 = 0; j0 <= i0; j0 += R) {
        const int tj = c * 8 + j0 / R;
        if (kv_tile != tj) {
          __syncthreads();
          issue_kv(t0, j0, n_real);
          cp_async_wait_all();
          __syncthreads();
          kv_tile = tj;
        }
        if (!live) continue;
        const int i_a = r_lo + gq, i_b = i_a + 8;   // the fragment's rows
        for (int kb = 0; kb * 16 < R; ++kb) {
          const int jb = j0 + kb * 16;
          if (jb > r_lo + 15 || jb >= n_real) break;
          // C B^T for a 16 x 16 block: two n-tiles of 8 keys
          float cb[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          const bf16* b_b = sB + (kb * 16 + r8 + 8 * mhi) * ldN + 8 * mlo;
#pragma unroll 1
          for (int k = 0; k < KN; ++k) {
            uint32_t af[4], bf[4];
            ldsm(af, a_c + k * 16);
            ldsm(bf, b_b + k * 16);
            mma(cb[0], af, bf[0], bf[1]);
            mma(cb[1], af, bf[2], bf[3]);
          }
          // W = (C.B) exp(cs_i - cs_j) dt_j on j <= i as hi + lo A
          // fragments, in register order (row g, k 0-7), (row g+8, k 0-7),
          // (row g, k 8-15), (row g+8, k 8-15): n-tile 0 holds k 0-7
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int j = jb + nt * 8 + 2 * tq;
            float w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ii = e < 2 ? i_a : i_b, jj = j + (e & 1);
              w[e] = (jj <= ii && jj < n_real)
                         ? __fmul_rn(__fmul_rn(cb[nt][e],
                                               expf(sCs[ii] - sCs[jj])),
                                     sDt[jj])
                         : 0.f;
            }
            split2(w[0], w[1], ahi[2 * nt], alo[2 * nt]);
            split2(w[2], w[3], ahi[2 * nt + 1], alo[2 * nt + 1]);
          }
          // W x: x's key rows kb*16.. are the product's k
          const bf16* b_x = sX + (kb * 16 + r8 + 8 * mlo) * ldX + pw0 +
                            8 * mhi;
#pragma unroll
          for (int q = 0; q < PW; q += 2) {
            if (q >= pnw) break;
            uint32_t xf[4];
            ldsm_t(xf, b_x + q * 8);
            mma(acc[q], ahi, xf[0], xf[1]);
            mma(acc[q], alo, xf[0], xf[1]);
            mma(acc[q + 1], ahi, xf[2], xf[3]);
            mma(acc[q + 1], alo, xf[2], xf[3]);
          }
        }
      }
      // store the strip's rows of y
      if (live) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = r_lo + gq + 8 * half;
          if (i < n_real) {
            bf16* yr = y + (t0 + i) * y_st + pw0 + 2 * tq;
#pragma unroll
            for (int q = 0; q < PW; ++q) {
              if (q >= pnw) break;
              *reinterpret_cast<__nv_bfloat162*>(yr + q * 8) =
                  __floats2bfloat162_rn(acc[q][2 * half],
                                        acc[q][2 * half + 1]);
            }
          }
        }
      }
      // state update with this tile's keys (in sB / sX):
      // S += x^T (B o w), w_j = dt_j exp(cs_Q - cs_j), B o w as hi + lo
      for (int e = tid; e < R * (N / 8); e += kThreads) {
        const int j = e / (N / 8), c8 = (e - j * (N / 8)) * 8;
        const float w = i0 + j < n_real ? sWst[i0 + j] : 0.f;
        const uint4 v = *reinterpret_cast<const uint4*>(sB + j * ldN + c8);
        const uint32_t* vb = reinterpret_cast<const uint32_t*>(&v);
        uint4 hi, lo;
        uint32_t* hp = reinterpret_cast<uint32_t*>(&hi);
        uint32_t* lp = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vb + k));
          split2(__fmul_rn(f.x, w), __fmul_rn(f.y, w), hp[k], lp[k]);
        }
        *reinterpret_cast<uint4*>(sBwHi + j * ldN + c8) = hi;
        *reinterpret_cast<uint4*>(sBwLo + j * ldN + c8) = lo;
      }
      __syncthreads();
      const int kmax = min(R, n_real - i0);
      const bf16* a_x = sX + (r8 + 8 * mhi) * ldX + ms * 16 + 8 * mlo;
      const int bo = (r8 + 8 * mlo) * ldN + nt0 * 8 + 8 * mhi;
      for (int kb = 0; kb * 16 < kmax; ++kb) {
        uint32_t af[4];
        ldsm_t(af, a_x + kb * 16 * ldX);
#pragma unroll
        for (int t = 0; t < NTW; t += 2) {
          uint32_t bh[4], bl[4];
          ldsm_t(bh, sBwHi + bo + kb * 16 * ldN + t * 8);
          ldsm_t(bl, sBwLo + bo + kb * 16 * ldN + t * 8);
          mma(st[t], af, bh[0], bh[1]);
          mma(st[t], af, bl[0], bl[1]);
          mma(st[t + 1], af, bh[2], bh[3]);
          mma(st[t + 1], af, bl[2], bl[3]);
        }
      }
    }
  }

  const int r0 = ms * 16 + gq;
#pragma unroll
  for (int t = 0; t < NTW; ++t) {
    const int n = (nt0 + t) * 8 + 2 * tq;
    __stcs(reinterpret_cast<float2*>(a.state_out + s0 + r0 * N + n),
           make_float2(st[t][0], st[t][1]));
    __stcs(reinterpret_cast<float2*>(a.state_out + s0 + (r0 + 8) * N + n),
           make_float2(st[t][2], st[t][3]));
  }
}

}  // namespace tc

// ===========================================================================
// CUDA-core route: any dtype, register-tiled products
// ===========================================================================
namespace cores {

constexpr int kThreads = 256;
constexpr int kTile = 32;          // query / key rows per tile
constexpr int kLdT = kTile + 2;    // row stride of the i- / j-major tiles

// shared memory (floats) for a slice of pt rows at N columns
struct Layout {
  int ldS, ldX, ldBw;
  int ST, CT, BT, X, WT, BW, CS, DT, end;
  __host__ __device__ Layout(int pt, int N) {
    ldS = pt + 4;                 // ST[N][pt+4]: the state, n-major
    ldX = pt + 4;                 // X[32][pt+4]: a key tile of x
    ldBw = N + 4;                 // BW[32][N+4]: B o w of a key tile
    ST = 0;
    CT = ST + N * ldS;            // CT[N][34]: C^T of a query tile
    BT = CT + N * kLdT;           // BT[N][34]: B^T of a key tile
    X = BT + N * kLdT;
    WT = X + kTile * ldX;         // WT[32][34]: weights, j-major
    BW = WT + kTile * kLdT;
    CS = BW + kTile * ldBw;       // cumsum and dt of the chunk
    DT = CS + kMaxQ;
    end = DT + kMaxQ;
  }
};

// rows [t, t + 32) of a (T, width) operand, transposed into dst[col][r]
// (stride kLdT) as f32; rows at or past n_real are zero
template <typename T>
__device__ __forceinline__ void load_t(float* dst, const T* src, long long st,
                                       int n_real, int width) {
  for (int e = threadIdx.x; e < kTile * width; e += kThreads) {
    const int r = e / width, c = e - r * width;
    dst[c * kLdT + r] = r < n_real ? to_f32(src[r * st + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_cores(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int P_t = a.p_tile, N = a.N, Q = a.Q, T_len = a.T;
  const Layout L(P_t, N);
  float *sST = smem + L.ST, *sCT = smem + L.CT, *sBT = smem + L.BT;
  float *sX = smem + L.X, *sWT = smem + L.WT, *sBw = smem + L.BW;
  float *sCs = smem + L.CS, *sDt = smem + L.DT;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, bb = blockIdx.y, p0 = blockIdx.z * P_t;
  const int g = h / (a.nh / a.G);
  const T* x = static_cast<const T*>(a.x) + bb * a.x_sb + h * a.x_sh + p0;
  const T* Bm = static_cast<const T*>(a.B) + bb * a.b_sb + g * a.b_sg;
  const T* Cm = static_cast<const T*>(a.C) + bb * a.c_sb + g * a.c_sg;
  const float* dt = a.dt + bb * a.dt_sb + h;
  T* y = static_cast<T*>(a.y) + ((long long)bb * T_len * a.nh + h) * a.P +
         p0;
  const long long y_st = (long long)a.nh * a.P;
  const float Ah = a.A[h];
  const long long s0 = (((long long)bb * a.nh + h) * a.P + p0) * N;
  const int N4 = N / 4;

  // the state, 16-byte loads, stored n-major
  for (int e = tid; e < P_t * N4; e += kThreads) {
    const int p = e / N4, n = (e - p * N4) * 4;
    const float4 v = a.init
                         ? *reinterpret_cast<const float4*>(a.init + s0 +
                                                            p * N + n)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    sST[n * L.ldS + p] = v.x;
    sST[(n + 1) * L.ldS + p] = v.y;
    sST[(n + 2) * L.ldS + p] = v.z;
    sST[(n + 3) * L.ldS + p] = v.w;
  }

  const int PB = (P_t + 3) / 4;   // 4-column blocks of p
  const int n_chunks = (T_len + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int n_real = min(Q, T_len - t0);
    __syncthreads();
    for (int i = tid; i < Q; i += kThreads)
      sDt[i] = i < n_real ? dt[(t0 + i) * a.dt_st] : 0.f;
    __syncthreads();
    if (tid < 32) warp_cumsum(sDt, sCs, Q, Ah);
    __syncthreads();

    // ---- outputs, one tile of 32 query rows at a time ----
    for (int i0 = 0; i0 < n_real; i0 += kTile) {
      __syncthreads();
      load_t(sCT, Cm + (t0 + i0) * a.c_st, a.c_st, n_real - i0, N);
      __syncthreads();
      // each thread a 2 x 4 block (rows bi, bi+1; columns bp..bp+3) of y
      const int nblk = (kTile / 2) * PB;
      const bool mine = tid < nblk;
      const int bi = (tid / PB) * 2, bp = (tid % PB) * 4;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      if (mine) {
        // carried-state term: exp(cs_i) (C_i S^T)
        for (int n = 0; n < N; ++n) {
          const float2 cv =
              *reinterpret_cast<const float2*>(sCT + n * kLdT + bi);
          const float4 sv =
              *reinterpret_cast<const float4*>(sST + n * L.ldS + bp);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[0][q] = __fmaf_rn(cv.x, comp(sv, q), acc[0][q]);
            acc[1][q] = __fmaf_rn(cv.y, comp(sv, q), acc[1][q]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float e = expf(sCs[i0 + bi + r]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = __fmul_rn(acc[r][q], e);
        }
      }
      // intra-chunk term over the key tiles at or below the diagonal
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        __syncthreads();
        load_t(sBT, Bm + (t0 + j0) * a.b_st, a.b_st, n_real - j0, N);
        for (int e = tid; e < kTile * P_t; e += kThreads) {
          const int j = e / P_t, p = e - j * P_t;
          sX[j * L.ldX + p] =
              j0 + j < n_real ? to_f32(x[(t0 + j0 + j) * a.x_st + p]) : 0.f;
        }
        __syncthreads();
        // weights, each thread a 2 x 2 block (i, i+1) x (j, j+1)
        {
          const int i = (tid / 16) * 2, j = (tid % 16) * 2;
          float cb[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
          for (int n = 0; n < N; ++n) {
            const float2 cv =
                *reinterpret_cast<const float2*>(sCT + n * kLdT + i);
            const float2 bv =
                *reinterpret_cast<const float2*>(sBT + n * kLdT + j);
            cb[0][0] = __fmaf_rn(cv.x, bv.x, cb[0][0]);
            cb[0][1] = __fmaf_rn(cv.x, bv.y, cb[0][1]);
            cb[1][0] = __fmaf_rn(cv.y, bv.x, cb[1][0]);
            cb[1][1] = __fmaf_rn(cv.y, bv.y, cb[1][1]);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int ii = i0 + i + r, jj = j0 + j + q;
              sWT[(j + q) * kLdT + i + r] =
                  (jj <= ii && jj < n_real)
                      ? __fmul_rn(__fmul_rn(cb[r][q],
                                            expf(sCs[ii] - sCs[jj])),
                                  sDt[jj])
                      : 0.f;
            }
        }
        __syncthreads();
        const int nj = min(kTile, n_real - j0);
        if (mine)
          for (int j = 0; j < nj; ++j) {
            const float2 wv =
                *reinterpret_cast<const float2*>(sWT + j * kLdT + bi);
            const float4 xv =
                *reinterpret_cast<const float4*>(sX + j * L.ldX + bp);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[0][q] = __fmaf_rn(wv.x, comp(xv, q), acc[0][q]);
              acc[1][q] = __fmaf_rn(wv.y, comp(xv, q), acc[1][q]);
            }
          }
      }
      if (mine)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i0 + bi + r;
          if (i < n_real)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              store_out(y + (t0 + i) * y_st + bp + q, acc[r][q]);
        }
    }

    // ---- state update: S <- exp(cs_Q) S + sum_j (B_j w_j) (x) x_j ----
    const float total = sCs[Q - 1];
    const float decay = expf(total);
    const int NB = N / 4;
    for (int e = tid; e < NB * PB; e += kThreads) {
      const int n = (e / PB) * 4, p = (e % PB) * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (p + q < P_t)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            sST[(n + r) * L.ldS + p + q] =
                __fmul_rn(decay, sST[(n + r) * L.ldS + p + q]);
    }
    for (int j0 = 0; j0 < n_real; j0 += kTile) {
      __syncthreads();
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int j = e / N, n = e - j * N;
        const int jj = j0 + j;
        sBw[j * L.ldBw + n] =
            jj < n_real
                ? __fmul_rn(to_f32(Bm[(t0 + jj) * a.b_st + n]),
                            __fmul_rn(sDt[jj], expf(total - sCs[jj])))
                : 0.f;
      }
      for (int e = tid; e < kTile * P_t; e += kThreads) {
        const int j = e / P_t, p = e - j * P_t;
        sX[j * L.ldX + p] =
            j0 + j < n_real ? to_f32(x[(t0 + j0 + j) * a.x_st + p]) : 0.f;
      }
      __syncthreads();
      const int nj = min(kTile, n_real - j0);
      // each thread a 4 x 4 block (n..n+3) x (p..p+3) of the state
      for (int e = tid; e < NB * PB; e += kThreads) {
        const int n = (e / PB) * 4, p = (e % PB) * 4;
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 v =
              *reinterpret_cast<const float4*>(sST + (n + r) * L.ldS + p);
          s[r][0] = v.x; s[r][1] = v.y; s[r][2] = v.z; s[r][3] = v.w;
        }
        for (int j = 0; j < nj; ++j) {
          const float4 bw =
              *reinterpret_cast<const float4*>(sBw + j * L.ldBw + n);
          const float4 xv =
              *reinterpret_cast<const float4*>(sX + j * L.ldX + p);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              s[r][q] = __fmaf_rn(comp(bw, r), comp(xv, q), s[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float4*>(sST + (n + r) * L.ldS + p) =
              make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < P_t * N4; e += kThreads) {
    const int p = e / N4, n = (e - p * N4) * 4;
    *reinterpret_cast<float4*>(a.state_out + s0 + p * N + n) = make_float4(
        sST[n * L.ldS + p], sST[(n + 1) * L.ldS + p],
        sST[(n + 2) * L.ldS + p], sST[(n + 3) * L.ldS + p]);
  }
}

}  // namespace cores

// ===========================================================================
// host: routes, splits, launches
// ===========================================================================

enum Route { kNoRoute = 0, kRecurrent = 1, kTensorCores = 2, kCudaCores = 3 };
// the widest step the recurrent route takes (forced), and the widest the
// table sends it (measured on the H100: recurrent faster at T = 1-9, the
// tensor cores at T = 64, the two close at T = 33)
constexpr int kRecMaxT = 64;
constexpr int kRecTableT = 16;

// the state widths the models use (16 in the tiny configs, 64, 128) and
// 32; wider ones take the CUDA cores
bool recurrent_n(int N) {
  return N == 16 || N == 32 || N == 64 || N == 128;
}
bool tc_n(int N) { return N == 16 || N == 32 || N == 64 || N == 128; }
int elem_bytes(int dtype) { return dtype == 0 ? 4 : 2; }

// the recurrent route's passes for a slice of pt rows: a power of two >=
// ceil(pt / ROWS), at most 16 vectors a thread, so at most 4 (0: none)
int recurrent_passes(int N, int pt) {
  const int lanes = N / 16 < 1 ? 1 : N / 16 > 32 ? 32 : N / 16;
  const int vpt = N / 4 / lanes, rows = recurrent::kThreads / lanes;
  int need = (pt + rows - 1) / rows, passes = 1;
  while (passes < need) passes *= 2;
  return passes * vpt <= 16 ? passes : 0;
}

size_t recurrent_smem(int dtype, int T, int pt, int N) {
  return (size_t)recurrent::Layout(T, pt, N, elem_bytes(dtype)).end;
}

size_t cores_smem(int pt, int N) {
  return sizeof(float) * (size_t)cores::Layout(pt, N).end;
}

// can `route` take this shape with P split into n slices?
bool split_ok(int route, int dtype, int T, int P, int N, int n) {
  if (n < 1 || P % n) return false;
  const int pt = P / n;
  switch (route) {
    case kRecurrent:
      return recurrent_passes(N, pt) > 0 &&
             recurrent_smem(dtype, T, pt, N) <= kMaxSmem;
    case kTensorCores:  // the state's n-tiles in pairs on each warp
      return (pt == 16 || pt == 32 || pt == 64) &&
             (N / 8) * (pt / 16) % 8 == 0;
    case kCudaCores:  // one 2 x 4 block of each y tile a thread
      return pt % 4 == 0 && pt <= 64 && cores_smem(pt, N) <= kMaxSmem;
  }
  return false;
}

bool route_fits(int route, int dtype, int T, int P, int N) {
  if (P < 1 || N < 4 || N % 4 || T < 1) return false;
  bool shape = false;
  switch (route) {
    case kRecurrent: shape = T <= kRecMaxT && recurrent_n(N); break;
    case kTensorCores: shape = dtype == 1 && tc_n(N) && P % 16 == 0; break;
    case kCudaCores: shape = true; break;
    default: return false;
  }
  if (!shape) return false;
  for (int n = 1; n <= P; n *= 2)
    if (split_ok(route, dtype, T, P, N, n)) return true;
  return false;
}

// The route of each shape, and nothing else decides it:
//   T <= kRecTableT -> the recurrent route (every dtype; T = 1 is decode);
//   bf16 wider -> the tensor cores;
//   the rest (f32 wider, shapes the others cannot take) -> the CUDA cores.
Route route_of(int dtype, int T, int P, int N) {
  if (dtype != 0 && dtype != 1) return kNoRoute;
  if (T <= kRecTableT && route_fits(kRecurrent, dtype, T, P, N))
    return kRecurrent;
  if (route_fits(kTensorCores, dtype, T, P, N)) return kTensorCores;
  if (route_fits(kCudaCores, dtype, T, P, N)) return kCudaCores;
  return kNoRoute;
}

// `want` 0: the table's route; 1-3: that route, where the shape fits it
Route resolve_route(int dtype, int T, int P, int N, int want) {
  if (want == 0) return route_of(dtype, T, P, N);
  if ((dtype == 0 || dtype == 1) && route_fits(want, dtype, T, P, N))
    return static_cast<Route>(want);
  return kNoRoute;
}

// n_split of a route, a function of the shape only: on the recurrent
// route the smallest power of two it can take whose grid reaches
// kTargetCtas (else the largest it can take); on the others the smallest
// it can take (each split recomputes the chunk's weights; measured: one
// slice of up to 64 rows is the fastest at both models' shapes)
int splits_of(int route, int dtype, int b, int T, int nh, int P, int N) {
  int best = 0;
  for (int n = 1; n <= P; n *= 2) {
    if (!split_ok(route, dtype, T, P, N, n)) continue;
    best = n;
    if (route != kRecurrent || (long long)b * nh * n >= kTargetCtas) break;
  }
  return best;
}

// The dynamic shared memory each kernel instance may use is allowed once
// per load of the library, not on every call: each launch template below
// is one instance, and its function-local static is set on its first call.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int N, int PASSES>
cudaError_t launch_recurrent(const Args& a, int n_split, cudaStream_t s) {
  auto kern = recurrent::ssd_recurrent<T, N, PASSES>;
  static const cudaError_t err = allow_smem(kern, kMaxSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.nh, a.b, n_split);
  kern<<<grid, recurrent::kThreads,
         recurrent::Layout(a.T, a.p_tile, N, (int)sizeof(T)).end, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_recurrent_p(const Args& a, int n_split, cudaStream_t s) {
  switch (recurrent_passes(N, a.p_tile)) {
    case 1: return launch_recurrent<T, N, 1>(a, n_split, s);
    case 2: return launch_recurrent<T, N, 2>(a, n_split, s);
    case 4: return launch_recurrent<T, N, 4>(a, n_split, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_recurrent_any(const Args& a, int n_split,
                                 cudaStream_t s) {
  switch (a.N) {
    case 16: return launch_recurrent_p<T, 16>(a, n_split, s);
    case 32: return launch_recurrent_p<T, 32>(a, n_split, s);
    case 64: return launch_recurrent_p<T, 64>(a, n_split, s);
    case 128: return launch_recurrent_p<T, 128>(a, n_split, s);
  }
  return cudaErrorInvalidValue;
}

template <int N, int PT>
cudaError_t launch_tc(const Args& a, cudaStream_t s) {
  auto kern = tc::ssd_tensor_cores<N, PT>;
  static const cudaError_t err =
      allow_smem(kern, tc::Layout(N, PT, kMaxQ).bytes());
  if (err != cudaSuccess) return err;
  dim3 grid(a.nh, a.b, a.P / PT);
  kern<<<grid, tc::kThreads, tc::Layout(N, PT, a.Q).bytes(), s>>>(a);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_tc_p(const Args& a, cudaStream_t s) {
  switch (a.p_tile) {
    case 16:
      if constexpr (N >= 64) return launch_tc<N, 16>(a, s);
      break;
    case 32:
      if constexpr (N >= 32) return launch_tc<N, 32>(a, s);
      break;
    case 64: return launch_tc<N, 64>(a, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_tc_any(const Args& a, cudaStream_t s) {
  switch (a.N) {
    case 16: return launch_tc_p<16>(a, s);
    case 32: return launch_tc_p<32>(a, s);
    case 64: return launch_tc_p<64>(a, s);
    case 128: return launch_tc_p<128>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_cores(const Args& a, int n_split, cudaStream_t s) {
  auto kern = cores::ssd_cores<T>;
  static const cudaError_t err = allow_smem(kern, kMaxSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.nh, a.b, n_split);
  kern<<<grid, cores::kThreads, cores_smem(a.p_tile, a.N), s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// the route of a shape (dtype 0 = float32, 1 = bfloat16): 0 none, 1 the
// recurrent route, 2 the tensor cores, 3 the CUDA cores; `route` 0 asks
// the table, 1-3 whether that route can take the shape
extern "C" int ssd_scan_route(int dtype, int T, int P, int N, int route) {
  return resolve_route(dtype, T, P, N, route);
}

// n_split of a shape on its route (0: no route)
extern "C" int ssd_scan_splits(int dtype, int b, int T, int nh, int P, int N,
                               int route) {
  const Route r = resolve_route(dtype, T, P, N, route);
  return r == kNoRoute ? 0 : splits_of(r, dtype, b, T, nh, P, N);
}

// whether route 1-3 can take this shape with P split into n_split slices
extern "C" int ssd_scan_split_ok(int route, int dtype, int T, int P, int N,
                                 int n_split) {
  return split_ok(route, dtype, T, P, N, n_split);
}

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt, A, init_state and
// state_out are float32.  x (b,T,nh,P), dt (b,T,nh), B and C (b,T,G,N)
// with the given element strides and a contiguous last dim; y contiguous
// (b,T,nh,P); init_state (null: zeros) and state_out contiguous
// (b,nh,P,N), possibly the same buffer.  Q = min(chunk, T) <= 256.
// `route` 0 takes the table's route, 1-3 that route; `n_split` 0 the
// route's own split, else that split.  Returns the cudaError_t of the
// launch (0 = launched); a shape the route cannot take is refused, never
// sent elsewhere.
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* dt,
                               const void* A, const void* B, const void* C,
                               const void* init_state, void* y,
                               void* state_out, int b, int T, int nh, int P,
                               int G, int N, int Q, long long x_sb,
                               long long x_st, long long x_sh,
                               long long dt_sb, long long dt_st,
                               long long b_sb, long long b_st,
                               long long b_sg, long long c_sb,
                               long long c_st, long long c_sg, int route,
                               int n_split, void* stream) {
  if (Q < 1 || Q > kMaxQ || G < 1 || nh % G) return cudaErrorInvalidValue;
  const Route r = resolve_route(dtype, T, P, N, route);
  if (r == kNoRoute) return cudaErrorInvalidValue;
  if (n_split == 0) n_split = splits_of(r, dtype, b, T, nh, P, N);
  if (!split_ok(r, dtype, T, P, N, n_split)) return cudaErrorInvalidValue;
  const Args a{x, B, C, static_cast<const float*>(dt),
               static_cast<const float*>(A),
               static_cast<const float*>(init_state), y,
               static_cast<float*>(state_out), b, T, nh, P, G, N, Q,
               P / n_split, x_sb, x_st, x_sh, dt_sb, dt_st, b_sb, b_st, b_sg,
               c_sb, c_st, c_sg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case kRecurrent:
      return dtype == 0 ? launch_recurrent_any<float>(a, n_split, s)
                        : launch_recurrent_any<bf16>(a, n_split, s);
    case kTensorCores: return launch_tc_any(a, s);
    case kCudaCores:
      return dtype == 0 ? launch_cores<float>(a, n_split, s)
                        : launch_cores<bf16>(a, n_split, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
