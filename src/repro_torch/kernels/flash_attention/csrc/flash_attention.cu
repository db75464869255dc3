// Flash attention (K3) for Hopper, written by hand in CUDA C++: the
// forward and the FlashAttention-2 backward (dQ, and dK/dV), three entry
// points of one file.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas -> pl.pallas_call, body _flash_kernel), which
// is forward-only: the JAX package differentiates its XLA attention by
// autodiff, while on the card the port's training attention *is* this
// kernel, so its gradient is a kernel too.  Same function: for q
// (B,Tq,Hq,D) and k, v (B,Tk,Hk,D), query i at position q_offset + i and
// key j at j, softmax(q k^T / sqrt(D)) v under the mask
//   (key <= query, if causal) & (key > query - window, if window)
// with query head h reading KV head h / (Hq/Hk); a row that sees no key
// gives 0 (the Pallas kernel's l == 0 -> 1).  The forward also writes
// each row's log-sum-exp (f32, (B,Hq,Tq); -inf for a row that sees
// nothing), from which the backward rebuilds P without the softmax:
//   P = exp(S*scale - LSE), dV = P^T dO, dP = dO V^T,
//   dS = P * (dP - Delta), Delta = rowsum(dO * O),
//   dQ = dS K * scale, dK = dS^T Q * scale,
// dK and dV summing the G = Hq/Hk query heads of their KV head.
//
// What bounds it on this card: at the training shape (T = 512, D = 128,
// causal, bf16) a row does 2*D flops per visible key and product, about
// 256 per byte it must read or write: near the card's ~295 flops per byte
// for bf16 on the tensor cores, so the forward and dQ are bound (just) by
// bytes there and dK/dV by operations.  Only the tensor cores come near
// either bound, so the route is a table of (dtype, D) (route_of):
//
//   bf16, D 64 / 128 (every config of the port: granite 128, zamba2 64):
//     the tensor cores.  Every product is a wgmma: m64n64k16 for S, dP
//     and their transposes with both operands in shared memory,
//     m64nDk16 for P V, dS K, P^T dO and dS^T Q with P or dS as the
//     register A operand (converted from the f32 accumulator of the
//     product before it) and V, K, dO or Q read MN-major.  Tiles of 64
//     rows are staged by TMA from tensor maps encoded on the host,
//     128-byte swizzled, in a ring of 2-4 stages that a producer warp
//     keeps filled, completing on mbarriers; consumers release a stage
//     after their last product on it.  The forward and dQ run one
//     consumer warpgroup of 64 packed query rows and two CTAs per SM;
//     the forward issues S of tile t together with P V of tile t-1 and
//     runs the online softmax while P V does.  dK/dV runs two consumer
//     warpgroups of 64 keys sharing each Q/dO tile, their two 64 x D f32
//     accumulators fed by setmaxnreg from the producer's warpgroup.  The
//     softmax (forward) and P, dS (backward) are f32 on the accumulator
//     fragments, each row's reduction a quad shuffle; a tile on the
//     diagonal or a window edge masks each row by one span of columns.
//     Query rows are packed (position, head) pairs of one KV head (see
//     namespace tc), so one K/V tile serves several heads.
//   f32 (any D), bf16 at D 32 / 256: the CUDA cores, f32 products with
//     32-row tiles held one tile ahead in registers.  On the tensor cores
//     f32 would be TF32, outside the f32 tolerance; D 32 and 256 belong
//     to no config of the port, and at D 256 the dK/dV accumulators alone
//     would take 256 registers a thread.
//
// On both routes only the key tiles a row can see are walked (the Pallas
// kernel's `run` predicate: Mask::key_lo / key_hi).  No atomics:
// dQ is one CTA per query tile looping over key tiles, dK/dV one CTA per
// (b, KV head, key tile) looping over the query heads and query tiles,
// each output written once in a fixed order, so repeated runs are bitwise
// equal.  A launch that the card refuses returns its error; there is no
// second route to fall back on.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   -shared -Xcompiler -fPIC; bound to PyTorch through a plain C
//   interface (ctypes), see ops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../csrc/hopper.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerWarp = 4;                 // rows (or keys) per warp
constexpr int kTile = kWarps * kPerWarp;    // 32: rows per CTA, keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// a 16-byte vector of T -> 16 / sizeof(T) floats
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const float2 x = __bfloat1622float2(h);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Positions and mask of the contiguous layout; a row past the end of
// the queries gets position -1 and sees nothing.
struct Mask {
  int Tk, q_offset, causal, window;
  __device__ __forceinline__ bool visible(int qp, int kp) const {
    return qp >= 0 && kp < Tk && (!causal || kp <= qp) &&
           (window == 0 || kp > qp - window);
  }
  // key range [lo, hi) some query in [q_lo, q_hi] may see
  __device__ __forceinline__ int key_lo(int q_lo) const {
    return window ? max(0, q_lo - window + 1) : 0;
  }
  __device__ __forceinline__ int key_hi(int q_hi) const {
    return causal ? min(Tk, q_hi + 1) : Tk;
  }
};

// kTile rows of D elements of T on their way from device memory to shared
// memory, as 16-byte vectors in registers.  Row r of a tile lives at
// base + (r / G) * t_stride + (r % G) * D (G = 1 for K/V rows; for query
// rows the G heads of one position are adjacent), and exists if 0 <= r <
// n; a missing row loads as zeros.
template <typename T, int D>
struct TileRegs {
  static constexpr int kVec = 16 / sizeof(T);      // elements per vector
  static constexpr int kRowVecs = D / kVec;        // vectors per row
  static constexpr int kVecs = kTile * kRowVecs;   // vectors per tile
  static constexpr int kPer = (kVecs + kThreads - 1) / kThreads;
  uint4 x[kPer];

  __device__ __forceinline__ void load(const T* base, int r0, int n, int G,
                                       long long t_stride, int tid) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * kThreads;
      const int j = c / kRowVecs, d = (c % kRowVecs) * kVec;
      const int r = r0 + j;
      if (c < kVecs && r >= 0 && r < n) {
        const long long off = (long long)(r / G) * t_stride +
                              (long long)(r % G) * D + d;
        x[i] = *reinterpret_cast<const uint4*>(base + off);
      } else {
        x[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  // into s[kTile][LD] as f32, times `scale` (1 for all but the query)
  template <int LD>
  __device__ __forceinline__ void store(float* s, float scale,
                                        int tid) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * kThreads;
      if (c >= kVecs) continue;
      const int j = c / kRowVecs, d = (c % kRowVecs) * kVec;
      float f[kVec];
      unpack(x[i], f, T());
#pragma unroll
      for (int e = 0; e < kVec; ++e) s[j * LD + d + e] = f[e] * scale;
    }
  }
};

// ---------------------------------------------------------------------------
// forward: one CTA per (b, KV head, 32 packed query rows); lane j of a warp
// scores key j of the tile against the warp's 4 rows
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (kTile * D + kTile * (D + 1) + kTile * D +
                          kTile * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Tq, int Hq, int Hk, Mask mk,
                 float scale) {
  constexpr int NDW = D / 32;  // output dims owned by each lane
  extern __shared__ float smem[];
  float* qs = smem;                    // [kTile][D], scaled
  float* ks = qs + kTile * D;          // [kTile][D+1]
  float* vs = ks + kTile * (D + 1);    // [kTile][D]
  float* ps = vs + kTile * D;          // [kTile rows][kTile keys]

  const int G = Hq / Hk;
  const int b = blockIdx.y / Hk;
  const int kvh = blockIdx.y % Hk;
  const int row0 = blockIdx.x * kTile;
  const int n_rows = Tq * G;
  const int Tk = mk.Tk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wrow = warp * kPerWarp;

  const long long q_t_stride = (long long)Hq * D;
  const long long kv_t_stride = (long long)Hk * D;
  const T* qb = q + (long long)b * Tq * q_t_stride + (long long)kvh * G * D;
  const T* kb = k + (long long)b * Tk * kv_t_stride + (long long)kvh * D;
  const T* vb = v + (long long)b * Tk * kv_t_stride + (long long)kvh * D;

  {
    TileRegs<T, D> qr;
    qr.load(qb, row0, n_rows, G, q_t_stride, tid);
    qr.template store<D>(qs, scale, tid);
  }
  const int last_row = min(row0 + kTile, n_rows) - 1;
  const int k_lo = mk.key_lo(mk.q_offset + row0 / G);
  const int k_hi = mk.key_hi(mk.q_offset + last_row / G);
  const int tile_lo = k_lo / kTile;
  const int tile_hi = k_hi > k_lo ? (k_hi + kTile - 1) / kTile : tile_lo;

  int qp[kPerWarp];
  float acc[kPerWarp][NDW];
  float m_run[kPerWarp], l_run[kPerWarp];
#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr) {
    const int r = row0 + wrow + rr;
    qp[rr] = r < n_rows ? mk.q_offset + r / G : -1;
    m_run[rr] = kNegInf;
    l_run[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < NDW; ++i) acc[rr][i] = 0.f;
  }
  const bool warp_has_rows = row0 + wrow < n_rows;  // uniform over the warp

  TileRegs<T, D> kr, vr;
  if (tile_lo < tile_hi) {
    kr.load(kb, tile_lo * kTile, Tk, 1, kv_t_stride, tid);
    vr.load(vb, tile_lo * kTile, Tk, 1, kv_t_stride, tid);
  }
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    kr.template store<D + 1>(ks, 1.f, tid);
    vr.template store<D>(vs, 1.f, tid);
    __syncthreads();  // tile is in shared memory (and qs, the first time)
    if (tile + 1 < tile_hi) {  // in flight while this tile is computed
      kr.load(kb, (tile + 1) * kTile, Tk, 1, kv_t_stride, tid);
      vr.load(vb, (tile + 1) * kTile, Tk, 1, kv_t_stride, tid);
    }
    if (warp_has_rows) {
      float sc[kPerWarp];
#pragma unroll
      for (int rr = 0; rr < kPerWarp; ++rr) sc[rr] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kx = ks[lane * (D + 1) + d];
#pragma unroll
        for (int rr = 0; rr < kPerWarp; ++rr)
          sc[rr] = fmaf(qs[(wrow + rr) * D + d], kx, sc[rr]);
      }
      const int kp = tile * kTile + lane;
#pragma unroll
      for (int rr = 0; rr < kPerWarp; ++rr) {
        const bool ok = mk.visible(qp[rr], kp);
        const float s = ok ? sc[rr] : kNegInf;
        const float m_new = fmaxf(m_run[rr], warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float corr = expf(m_run[rr] - m_new);
        l_run[rr] = corr * l_run[rr] + warp_sum(p);
        m_run[rr] = m_new;
        ps[(wrow + rr) * kTile + lane] = p;
#pragma unroll
        for (int i = 0; i < NDW; ++i) acc[rr][i] *= corr;
      }
      __syncwarp();
      // acc += p @ v: lane owns output dims lane + 32*i
      for (int j = 0; j < kTile; ++j) {
        float vx[NDW];
#pragma unroll
        for (int i = 0; i < NDW; ++i) vx[i] = vs[j * D + lane + 32 * i];
#pragma unroll
        for (int rr = 0; rr < kPerWarp; ++rr) {
          const float p = ps[(wrow + rr) * kTile + j];
#pragma unroll
          for (int i = 0; i < NDW; ++i) acc[rr][i] = fmaf(p, vx[i], acc[rr][i]);
        }
      }
    }
    __syncthreads();  // the next store overwrites ks / vs / ps
  }

#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr) {
    const int r = row0 + wrow + rr;
    if (r >= n_rows) continue;
    const int t = r / G, h = kvh * G + r % G;
    const float l = l_run[rr];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* o = out + (((long long)b * Tq + t) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < NDW; ++i) store_out(o + lane + 32 * i, acc[rr][i] * inv);
    if (lane == 0)
      lse[((long long)b * Hq + h) * Tq + t] =
          l > 0.f ? m_run[rr] + logf(l) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (b, KV head, 32 packed query rows), looping over the key
// tiles the rows can see; lane j scores key j, then dq += dS @ K with lane
// owning output dims
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kTile * D + 2 * kTile * (D + 1) +
                          kTile * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Tq,
                int Hq, int Hk, Mask mk, float scale) {
  constexpr int NDW = D / 32;
  extern __shared__ float smem[];
  float* qs = smem;                    // [kTile][D], scaled
  float* dos = qs + kTile * D;         // [kTile][D]
  float* ks = dos + kTile * D;         // [kTile][D+1]
  float* vs = ks + kTile * (D + 1);    // [kTile][D+1]
  float* dss = vs + kTile * (D + 1);   // [kTile rows][kTile keys]

  const int G = Hq / Hk;
  const int b = blockIdx.y / Hk;
  const int kvh = blockIdx.y % Hk;
  const int row0 = blockIdx.x * kTile;
  const int n_rows = Tq * G;
  const int Tk = mk.Tk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wrow = warp * kPerWarp;

  const long long q_t_stride = (long long)Hq * D;
  const long long kv_t_stride = (long long)Hk * D;
  const long long q_off = (long long)b * Tq * q_t_stride + (long long)kvh * G * D;
  const T* kb = k + (long long)b * Tk * kv_t_stride + (long long)kvh * D;
  const T* vb = v + (long long)b * Tk * kv_t_stride + (long long)kvh * D;

  {
    TileRegs<T, D> qr, dr;
    qr.load(q + q_off, row0, n_rows, G, q_t_stride, tid);
    dr.load(dout + q_off, row0, n_rows, G, q_t_stride, tid);
    qr.template store<D>(qs, scale, tid);
    dr.template store<D>(dos, 1.f, tid);
  }
  const int last_row = min(row0 + kTile, n_rows) - 1;
  const int k_lo = mk.key_lo(mk.q_offset + row0 / G);
  const int k_hi = mk.key_hi(mk.q_offset + last_row / G);
  const int tile_lo = k_lo / kTile;
  const int tile_hi = k_hi > k_lo ? (k_hi + kTile - 1) / kTile : tile_lo;

  int qp[kPerWarp];
  float row_lse[kPerWarp], row_delta[kPerWarp];
  float acc[kPerWarp][NDW];
#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr) {
    const int r = row0 + wrow + rr;
    qp[rr] = -1;  // a row past the end sees nothing
    row_lse[rr] = row_delta[rr] = 0.f;
    if (r < n_rows) {
      const int t = r / G, h = kvh * G + r % G;
      qp[rr] = mk.q_offset + t;
      row_lse[rr] = lse[((long long)b * Hq + h) * Tq + t];
      row_delta[rr] = delta[((long long)b * Hq + h) * Tq + t];
    }
#pragma unroll
    for (int i = 0; i < NDW; ++i) acc[rr][i] = 0.f;
  }
  const bool warp_has_rows = row0 + wrow < n_rows;

  TileRegs<T, D> kr, vr;
  if (tile_lo < tile_hi) {
    kr.load(kb, tile_lo * kTile, Tk, 1, kv_t_stride, tid);
    vr.load(vb, tile_lo * kTile, Tk, 1, kv_t_stride, tid);
  }
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    kr.template store<D + 1>(ks, 1.f, tid);
    vr.template store<D + 1>(vs, 1.f, tid);
    __syncthreads();
    if (tile + 1 < tile_hi) {
      kr.load(kb, (tile + 1) * kTile, Tk, 1, kv_t_stride, tid);
      vr.load(vb, (tile + 1) * kTile, Tk, 1, kv_t_stride, tid);
    }
    if (warp_has_rows) {
      float sc[kPerWarp], dp[kPerWarp];
#pragma unroll
      for (int rr = 0; rr < kPerWarp; ++rr) sc[rr] = dp[rr] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kx = ks[lane * (D + 1) + d];
        const float vx = vs[lane * (D + 1) + d];
#pragma unroll
        for (int rr = 0; rr < kPerWarp; ++rr) {
          sc[rr] = fmaf(qs[(wrow + rr) * D + d], kx, sc[rr]);
          dp[rr] = fmaf(dos[(wrow + rr) * D + d], vx, dp[rr]);
        }
      }
      const int kp = tile * kTile + lane;
#pragma unroll
      for (int rr = 0; rr < kPerWarp; ++rr) {
        const bool ok = mk.visible(qp[rr], kp);
        const float p = ok ? expf(sc[rr] - row_lse[rr]) : 0.f;
        dss[(wrow + rr) * kTile + lane] = p * (dp[rr] - row_delta[rr]);
      }
      __syncwarp();
      for (int j = 0; j < kTile; ++j) {
        float kx[NDW];
#pragma unroll
        for (int i = 0; i < NDW; ++i) kx[i] = ks[j * (D + 1) + lane + 32 * i];
#pragma unroll
        for (int rr = 0; rr < kPerWarp; ++rr) {
          const float ds = dss[(wrow + rr) * kTile + j];
#pragma unroll
          for (int i = 0; i < NDW; ++i) acc[rr][i] = fmaf(ds, kx[i], acc[rr][i]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr) {
    const int r = row0 + wrow + rr;
    if (r >= n_rows) continue;
    const int t = r / G, h = kvh * G + r % G;
    T* o = dq + (((long long)b * Tq + t) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < NDW; ++i) store_out(o + lane + 32 * i, acc[rr][i] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one CTA per (b, KV head, 32 keys), looping over the packed query
// rows (G heads x positions) that can see them; warp w owns keys 4w..4w+3,
// lane i scores query row i of the tile, then dv += P^T dO and
// dk += dS^T (Q*scale) with lane owning output dims
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * kTile * (D + 1) + 2 * kTile * D +
                          2 * kTile * kTile + 2 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int Tq, int Hq, int Hk, Mask mk,
                  float scale) {
  constexpr int NDW = D / 32;
  extern __shared__ float smem[];
  float* qs = smem;                      // [kTile rows][D+1], scaled
  float* dos = qs + kTile * (D + 1);     // [kTile rows][D+1]
  float* ks = dos + kTile * (D + 1);     // [kTile keys][D]
  float* vs = ks + kTile * D;            // [kTile keys][D]
  float* ps = vs + kTile * D;            // [kTile keys][kTile rows]
  float* dss = ps + kTile * kTile;       // [kTile keys][kTile rows]
  float* lse_s = dss + kTile * kTile;    // [kTile rows]
  float* delta_s = lse_s + kTile;        // [kTile rows]

  const int G = Hq / Hk;
  const int b = blockIdx.y / Hk;
  const int kvh = blockIdx.y % Hk;
  const int key0 = blockIdx.x * kTile;
  const int n_rows = Tq * G;
  const int Tk = mk.Tk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wkey = warp * kPerWarp;

  const long long q_t_stride = (long long)Hq * D;
  const long long kv_t_stride = (long long)Hk * D;
  const long long q_off = (long long)b * Tq * q_t_stride + (long long)kvh * G * D;
  const long long kv_off = (long long)b * Tk * kv_t_stride + (long long)kvh * D;

  {
    TileRegs<T, D> kr, vr;
    kr.load(k + kv_off, key0, Tk, 1, kv_t_stride, tid);
    vr.load(v + kv_off, key0, Tk, 1, kv_t_stride, tid);
    kr.template store<D>(ks, 1.f, tid);
    vr.template store<D>(vs, 1.f, tid);
  }
  // query positions that can see a key of [key0, last_key]: causal needs
  // query >= key0, a window query < last_key + window
  const int last_key = min(key0 + kTile, Tk) - 1;
  int t_lo = 0, t_hi = Tq;  // [t_lo, t_hi)
  if (mk.causal) t_lo = max(0, key0 - mk.q_offset);
  if (mk.window) t_hi = min(Tq, last_key + mk.window - mk.q_offset);
  const int r_lo = t_lo * G;
  const int r_hi = t_hi > t_lo ? t_hi * G : r_lo;

  float acc_k[kPerWarp][NDW], acc_v[kPerWarp][NDW];
#pragma unroll
  for (int kk = 0; kk < kPerWarp; ++kk)
#pragma unroll
    for (int i = 0; i < NDW; ++i) acc_k[kk][i] = acc_v[kk][i] = 0.f;

  TileRegs<T, D> qr, dr;
  float lse_n = 0.f, delta_n = 0.f;  // row r0 + tid of the next tile
  auto load_rows = [&](int r0) {
    qr.load(q + q_off, r0, n_rows, G, q_t_stride, tid);
    dr.load(dout + q_off, r0, n_rows, G, q_t_stride, tid);
    if (tid < kTile) {
      const int r = r0 + tid;
      lse_n = delta_n = 0.f;
      if (r < r_hi) {
        const int t = r / G, h = kvh * G + r % G;
        lse_n = lse[((long long)b * Hq + h) * Tq + t];
        delta_n = delta[((long long)b * Hq + h) * Tq + t];
      }
    }
  };
  if (r_lo < r_hi) load_rows(r_lo);
  for (int r0 = r_lo; r0 < r_hi; r0 += kTile) {
    qr.template store<D + 1>(qs, scale, tid);
    dr.template store<D + 1>(dos, 1.f, tid);
    if (tid < kTile) {
      lse_s[tid] = lse_n;
      delta_s[tid] = delta_n;
    }
    __syncthreads();  // the rows and the K/V tile are in shared memory
    if (r0 + kTile < r_hi) load_rows(r0 + kTile);

    const int r = r0 + lane;
    const int qp = r < r_hi ? mk.q_offset + r / G : -1;
    const float row_lse = lse_s[lane], row_delta = delta_s[lane];
    float sc[kPerWarp], dp[kPerWarp];
#pragma unroll
    for (int kk = 0; kk < kPerWarp; ++kk) sc[kk] = dp[kk] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qx = qs[lane * (D + 1) + d];
      const float dx = dos[lane * (D + 1) + d];
#pragma unroll
      for (int kk = 0; kk < kPerWarp; ++kk) {
        sc[kk] = fmaf(qx, ks[(wkey + kk) * D + d], sc[kk]);
        dp[kk] = fmaf(dx, vs[(wkey + kk) * D + d], dp[kk]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kPerWarp; ++kk) {
      const bool ok = mk.visible(qp, key0 + wkey + kk);
      const float p = ok ? expf(sc[kk] - row_lse) : 0.f;
      ps[(wkey + kk) * kTile + lane] = p;
      dss[(wkey + kk) * kTile + lane] = p * (dp[kk] - row_delta);
    }
    __syncwarp();
    for (int j = 0; j < kTile; ++j) {
      float dx[NDW], qx[NDW];
#pragma unroll
      for (int i = 0; i < NDW; ++i) {
        dx[i] = dos[j * (D + 1) + lane + 32 * i];
        qx[i] = qs[j * (D + 1) + lane + 32 * i];
      }
#pragma unroll
      for (int kk = 0; kk < kPerWarp; ++kk) {
        const float p = ps[(wkey + kk) * kTile + j];
        const float ds = dss[(wkey + kk) * kTile + j];
#pragma unroll
        for (int i = 0; i < NDW; ++i) {
          acc_v[kk][i] = fmaf(p, dx[i], acc_v[kk][i]);
          acc_k[kk][i] = fmaf(ds, qx[i], acc_k[kk][i]);
        }
      }
    }
    __syncthreads();  // the next store overwrites qs / dos / ps / dss
  }

#pragma unroll
  for (int kk = 0; kk < kPerWarp; ++kk) {
    const int key = key0 + wkey + kk;
    if (key >= Tk) continue;
    const long long off = kv_off + (long long)key * kv_t_stride;
#pragma unroll
    for (int i = 0; i < NDW; ++i) {
      store_out(dk + off + lane + 32 * i, acc_k[kk][i]);
      store_out(dv + off + lane + 32 * i, acc_v[kk][i]);
    }
  }
}

// ===========================================================================
// tensor-core route: bf16 at D = 64 and 128
// ===========================================================================
//
// Every product is a wgmma on tiles that TMA stages in shared memory; one
// producer warp keeps the loads in flight, the consumer warpgroups compute.
// A consumer warpgroup owns 64 packed query rows (forward, dQ) or 64 keys
// (dK/dV).  Packed rows: the CTA's heads are Gt (the largest power of two
// dividing G, at most 64) adjacent query heads of one KV head, and its
// rows are (position, head) pairs, row r <-> position r / Gt, head r % Gt,
// so that a 64-row tile is one TMA box (64 columns, Gt heads, 64 / Gt
// positions) and each K/V tile serves Gt heads.

namespace tc {

using namespace hopper;

constexpr int kRows = 64;                // rows of one consumer warpgroup
constexpr int kKeys = 64;                // keys of one K/V tile
constexpr int kBox = kRows * kRowBytes;  // one box: 64 rows x 128 bytes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// ring stages of each kernel, and dK/dV's consumer warpgroups: the
// forward and dQ (one consumer warpgroup, ~150-165 registers) keep two
// CTAs on an SM within 228 KB of shared memory; dK/dV's two warpgroups
// take 240 registers each (setmaxnreg), one CTA per SM
constexpr int kFwdStages = 3;
constexpr int kDqStages = 2;
constexpr int kDkdvWG = 2, kDkdvStages = 4;

// is any key of [k0, k1] visible to a query of [q_lo, q_hi]; are all of
// them visible to all of those queries (no element mask needed)
__device__ __forceinline__ bool tile_any(const Mask& mk, int q_lo, int q_hi,
                                        int k0, int k1) {
  return k0 < mk.Tk && mk.key_lo(q_lo) <= k1 && k0 < mk.key_hi(q_hi);
}
__device__ __forceinline__ bool tile_all(const Mask& mk, int q_lo, int q_hi,
                                         int k0, int k1) {
  return k1 < mk.Tk && (!mk.causal || k1 <= q_lo) &&
         (!mk.window || k0 > q_hi - mk.window);
}

// The element mask of an edge tile as one span of visible columns per
// accumulator row: a thread's column 8 j + c (+ 2 (lane % 4)) of row i is
// visible iff lo[i] <= 8 j + c <= hi[i].  Computed once per tile, so an
// element costs two compares; tiles wholly visible skip it.
struct Spans {
  int lo[2], hi[2];
  __device__ __forceinline__ bool has(int i, int col) const {
    return col >= lo[i] && col <= hi[i];
  }
};
constexpr int kFar = 1 << 29;  // beyond any column

// rows are queries at positions qp[i] (-1: past the end), columns the
// keys key0 + ...: keys (qp - window, qp] (causal) that exist
__device__ __forceinline__ Spans key_spans(const Mask& mk, const int (&qp)[2],
                                           int key0, int quad) {
  Spans sp;
  const int base = key0 + 2 * quad;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int lo = mk.window ? qp[i] - mk.window + 1 : -kFar;
    const int hi = qp[i] < 0 ? -kFar
                             : min(mk.causal ? qp[i] : kFar, mk.Tk - 1);
    sp.lo[i] = max(lo, -kFar) - base;
    sp.hi[i] = hi - base;
  }
  return sp;
}

// rows are keys kp[i], columns packed query rows from position pos0
// (row r <-> position pos0 + r / Gt): the queries that exist and see
// the key (kp <= query < kp + window, as positions)
__device__ __forceinline__ Spans query_spans(const Mask& mk, int Tq,
                                             const int (&kp)[2], int pos0,
                                             int Gt, int quad) {
  Spans sp;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int d0 = kp[i] - mk.q_offset - pos0;  // the key, from pos0
    const int lo = mk.causal ? max(d0, -kFar / 64) * Gt : -kFar;
    int hi = (Tq - pos0) * Gt - 1;
    if (mk.window) hi = min(hi, (d0 + mk.window) * Gt - 1);
    if (kp[i] >= mk.Tk) hi = -kFar;
    sp.lo[i] = lo - 2 * quad;
    sp.hi[i] = hi - 2 * quad;
  }
  return sp;
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// bf16 pairs of rows `row` (+ 8 i) of an m64nD accumulator, times `mul`,
// to dst + 8 j (dst already at the row and at column 2 * (lane % 4))
template <int D>
__device__ __forceinline__ void store_row(__nv_bfloat16* dst,
                                          const float (&d)[D / 2], int i,
                                          float mul) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<uint32_t*>(dst + 8 * j) =
        pack_bf16(d[4 * j + 2 * i] * mul, d[4 * j + 2 * i + 1] * mul);
}

template <int D, int kStages>
struct FwdLayout {  // byte offsets in shared memory
  static constexpr int kChunks = D / kBoxCols;
  static constexpr int q = 0;                                // [chunk]
  static constexpr int k = q + kChunks * kBox;               // [stage][chunk]
  static constexpr int v = k + kStages * kChunks * kBox;     // [stage][chunk]
  static constexpr int bars = v + kStages * kChunks * kBox;  // q, full, empty
  static constexpr int bytes = bars + 8 * (1 + 2 * kStages);
};

// max (or sum) of the 16 values of accumulator row i (+ 8 i) a thread
// holds, as a tree (loops of fixed trip count: fully unrolled, so the
// values stay in registers)
template <bool kMax>
__device__ __forceinline__ float reduce_row16(const float (&d)[32], int i) {
  auto op = [](float a, float b) { return kMax ? fmaxf(a, b) : a + b; };
  float v8[8], v4[4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v8[j] = op(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) v4[j] = op(v8[2 * j], v8[2 * j + 1]);
  return op(op(v4[0], v4[1]), op(v4[2], v4[3]));
}

// One tile of the online softmax in the log2 domain: raw scores sc (64
// rows x 64 keys) -> P (f32, in x); m carries each row's running max of
// score * scale * log2(e), l its running sum of exp2(that - m), corr is
// the factor the output accumulator takes for the new max.  With kMask a
// score outside the row's span is -inf; a row with no key seen yet keeps
// m = -inf and gets p = 0.  It runs while the previous tile's P V is in
// flight, so it defines no register that product reads: sc is only read,
// and P becomes A fragments (pack_a) only after that product's wait
// (ptxas serializes the wgmma pipeline otherwise).
template <bool kMask>
__device__ __forceinline__ void online_softmax(
    const float (&sc)[32], float (&x)[32], float (&m)[2], float (&l)[2],
    float (&corr)[2], const Spans& sp, float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        x[e] = (!kMask || sp.has(i, 8 * j + c)) ? sc[e] : -INFINITY;
      }
  float mu[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = reduce_row16<true>(x, i);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[i], mx * scale_log2);
    mu[i] = mn == -INFINITY ? 0.f : mn;
    corr[i] = exp2_approx(m[i] - mu[i]);
    m[i] = mn;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        x[e] = exp2_approx(fmaf(x[e], scale_log2, -mu[i]));
      }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l[i] = l[i] * corr[i] + reduce_row16<false>(x, i);
}

__device__ __forceinline__ void online_softmax(
    bool edge, const float (&sc)[32], float (&x)[32], float (&m)[2],
    float (&l)[2], float (&corr)[2], const Mask& mk, const int (&qp)[2],
    int key0, int quad, float scale_log2) {
  if (edge)
    online_softmax<true>(sc, x, m, l, corr, key_spans(mk, qp, key0, quad),
                         scale_log2);
  else
    online_softmax<false>(sc, x, m, l, corr, Spans{}, scale_log2);
}

// S = Q K^T over D (both K-major in shared memory), issued and committed;
// the same shape gives dP = dO V^T, S^T = K Q^T and dP^T = V dO^T
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[32], const uint8_t* q_s,
                                         const uint8_t* k_s) {
  wgmma_ss_n64_first(sc, desc_k(q_s, 0, kBox), desc_k(k_s, 0, kBox));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss_n64(sc, desc_k(q_s, kk, kBox), desc_k(k_s, kk, kBox));
  wgmma_commit();
}

// O += P V over 64 keys (P from registers, V MN-major), issued and
// committed
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[4][4],
                                         const uint8_t* v_s) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<D>(o, pa[kk], desc_mn(v_s, kk, kBox));
  wgmma_commit();
}

// does key tile `tile` need the element mask for queries [q_lo, q_hi]
__device__ __forceinline__ bool edge_of(const Mask& mk, int q_lo, int q_hi,
                                        int tile) {
  return !tile_all(mk, q_lo, q_hi, tile * kKeys, tile * kKeys + kKeys - 1);
}

// forward: one CTA per (tile of 64 packed rows, b * Hk + KV head, head
// group), one consumer warpgroup.  The products of two tiles overlap the
// softmax: S of tile t and O += P V of tile t-1 are issued together, the
// softmax of tile t runs while P V does, then O takes the new max.
template <int D, int kStages>
__global__ void __launch_bounds__(160, 2)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int Tq, int Hq, int Hk, int gshift, Mask mk,
                float scale_log2) {
  using L = FwdLayout<D, kStages>;
  constexpr int kChunks = L::kChunks;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_base(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int Gt = 1 << gshift, P = kRows >> gshift;
  const int b = blockIdx.y / Hk, kvh = blockIdx.y % Hk;
  const int h0 = kvh * (Hq / Hk) + blockIdx.z * Gt;
  // the latest positions (the most keys under a causal mask) start first
  const int p0 = (gridDim.x - 1 - blockIdx.x) * P;
  const int q_lo = mk.q_offset + p0;
  const int q_hi = mk.q_offset + min(p0 + P, Tq) - 1;
  const int k_lo = mk.key_lo(q_lo), k_hi = mk.key_hi(q_hi);
  const int t_lo = k_lo / kKeys;
  const int n_tiles = k_hi > k_lo ? (k_hi + kKeys - 1) / kKeys - t_lo : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer warp: lane 0 issues every load
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, kChunks * kBox);
      for (int c = 0; c < kChunks; ++c)
        tma_load_4d(sm + L::q + c * kBox, &tm_q, q_full, c * kBoxCols, h0,
                    p0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages, key0 = (t_lo + t) * kKeys;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kChunks * kBox);
        for (int c = 0; c < kChunks; ++c) {
          tma_load_4d(sm + L::k + (s * kChunks + c) * kBox, &tm_k, &full[s],
                      c * kBoxCols, kvh, key0, b);
          tma_load_4d(sm + L::v + (s * kChunks + c) * kBox, &tm_v, &full[s],
                      c * kBoxCols, kvh, key0, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup: rows row + 8 i of the 64
  const int quad = lane % 4, row = 16 * warp + lane / 4;
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = p0 + ((row + 8 * i) >> gshift);
    qp[i] = pos < Tq ? mk.q_offset + pos : -1;
  }
  const uint8_t* q_s = sm + L::q;
  const uint8_t* k_s = sm + L::k;
  const uint8_t* v_s = sm + L::v;
  constexpr int kStageBytes = kChunks * kBox;

  float o[D / 2], sc[32], pf[32], corr[2];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t pa[4][4];
  zero(o);
  mbar_wait(q_full, 0);
  if (n_tiles > 0) {
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_qk<D>(sc, q_s, k_s);
    wgmma_wait<0>();
    fence_regs(sc);
    online_softmax(edge_of(mk, q_lo, q_hi, t_lo), sc, pf, m, l, corr, mk, qp,
                   t_lo * kKeys, quad, scale_log2);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(pf, kk, pa[kk]);
  }
  for (int t = 1; t < n_tiles; ++t) {
    const int s = t % kStages, s_prev = (t - 1) % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    wgmma_fence();
    issue_qk<D>(sc, q_s, k_s + s * kStageBytes);
    issue_pv<D>(o, pa, v_s + s_prev * kStageBytes);
    wgmma_wait<1>();  // S of tile t; P V of tile t-1 may still run
    fence_regs(sc);
    online_softmax(edge_of(mk, q_lo, q_hi, t_lo + t), sc, pf, m, l, corr, mk,
                   qp, (t_lo + t) * kKeys, quad, scale_log2);
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s_prev]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * j + 2 * i] *= corr[i];
        o[4 * j + 2 * i + 1] *= corr[i];
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(pf, kk, pa[kk]);
  }
  if (n_tiles > 0) {
    const int s_last = (n_tiles - 1) % kStages;
    wgmma_fence();
    issue_pv<D>(o, pa, v_s + s_last * kStageBytes);
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s_last]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = row + 8 * i, pos = p0 + (r >> gshift);
    if (pos >= Tq) continue;
    const int h = h0 + (r & (Gt - 1));
    store_row<D>(out + (((long long)b * Tq + pos) * Hq + h) * D + 2 * quad, o,
                 i, lt > 0.f ? 1.f / lt : 0.f);
    if (quad == 0)
      lse[((long long)b * Hq + h) * Tq + pos] =
          lt > 0.f ? (m[i] + log2f(lt)) * kLn2 : -INFINITY;
  }
}

template <int D, int kStages>
struct DqLayout {
  static constexpr int kChunks = D / kBoxCols;
  static constexpr int q = 0;                                // [chunk]
  static constexpr int dout = q + kChunks * kBox;            // [chunk]
  static constexpr int k = dout + kChunks * kBox;            // [stage][chunk]
  static constexpr int v = k + kStages * kChunks * kBox;     // [stage][chunk]
  static constexpr int bars = v + kStages * kChunks * kBox;  // q, full, empty
  static constexpr int bytes = bars + 8 * (1 + 2 * kStages);
};

// lse * log2(e) of a row, +inf for a row that sees nothing or is past the
// end (its P is then exp2(x - inf) = 0)
__device__ __forceinline__ float lse_log2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kLog2e;
}

// dS = P * (dP - Delta) of one tile of dQ, P = exp2(S * scale * log2(e)
// - lse * log2(e)); with kMask, 0 outside each row's span
template <bool kMask>
__device__ __forceinline__ void dq_scores(const float (&sc)[32],
                                          const float (&dp)[32],
                                          float (&ds)[32],
                                          const float (&lse2)[2],
                                          const float (&dl)[2],
                                          const Spans& sp, float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        const float p = (!kMask || sp.has(i, 8 * j + c))
                            ? exp2_approx(fmaf(sc[e], scale_log2, -lse2[i]))
                            : 0.f;
        ds[e] = p * (dp[e] - dl[i]);
      }
}

// dQ: the forward's tiling (one consumer warpgroup of 64 packed rows);
// per K/V tile S = Q K^T and dP = dO V^T, then dS = P * (dP - Delta) in
// registers and dQ += dS K
template <int D, int kStages>
__global__ void __launch_bounds__(160, 2)
flash_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int Tq, int Hq, int Hk,
               int gshift, Mask mk, float scale_log2, float scale) {
  using L = DqLayout<D, kStages>;
  constexpr int kChunks = L::kChunks;
  constexpr int kStageBytes = kChunks * kBox;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_base(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int Gt = 1 << gshift, P = kRows >> gshift;
  const int b = blockIdx.y / Hk, kvh = blockIdx.y % Hk;
  const int h0 = kvh * (Hq / Hk) + blockIdx.z * Gt;
  const int p0 = (gridDim.x - 1 - blockIdx.x) * P;
  const int q_lo = mk.q_offset + p0;
  const int q_hi = mk.q_offset + min(p0 + P, Tq) - 1;
  const int k_lo = mk.key_lo(q_lo), k_hi = mk.key_hi(q_hi);
  const int t_lo = k_lo / kKeys;
  const int n_tiles = k_hi > k_lo ? (k_hi + kKeys - 1) / kKeys - t_lo : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer warp: lane 0 issues every load
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * kChunks * kBox);
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(sm + L::q + c * kBox, &tm_q, q_full, c * kBoxCols, h0, p0,
                    b);
        tma_load_4d(sm + L::dout + c * kBox, &tm_do, q_full, c * kBoxCols, h0,
                    p0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages, key0 = (t_lo + t) * kKeys;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kChunks * kBox);
        for (int c = 0; c < kChunks; ++c) {
          tma_load_4d(sm + L::k + (s * kChunks + c) * kBox, &tm_k, &full[s],
                      c * kBoxCols, kvh, key0, b);
          tma_load_4d(sm + L::v + (s * kChunks + c) * kBox, &tm_v, &full[s],
                      c * kBoxCols, kvh, key0, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup: rows row + 8 i of the 64
  const int quad = lane % 4, row = 16 * warp + lane / 4;
  int qp[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i, pos = p0 + (r >> gshift);
    qp[i] = -1;
    lse2[i] = INFINITY;
    dl[i] = 0.f;
    if (pos < Tq) {
      const long long x =
          ((long long)b * Hq + h0 + (r & (Gt - 1))) * Tq + pos;
      qp[i] = mk.q_offset + pos;
      lse2[i] = lse_log2(lse[x]);
      dl[i] = delta[x];
    }
  }
  const uint8_t* q_s = sm + L::q;
  const uint8_t* do_s = sm + L::dout;

  float acc[D / 2], sc[32], dp[32];
  zero(acc);
  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages, key0 = (t_lo + t) * kKeys;
    const uint8_t* k_s = sm + L::k + s * kStageBytes;
    const uint8_t* v_s = sm + L::v + s * kStageBytes;
    mbar_wait(&full[s], (t / kStages) & 1);
    const bool edge = edge_of(mk, q_lo, q_hi, t_lo + t);
    wgmma_fence();
    issue_qk<D>(sc, q_s, k_s);
    issue_qk<D>(dp, do_s, v_s);  // dP = dO V^T: the same product shape
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    float ds[32];
    if (edge)
      dq_scores<true>(sc, dp, ds, lse2, dl, key_spans(mk, qp, key0, quad),
                      scale_log2);
    else
      dq_scores<false>(sc, dp, ds, lse2, dl, Spans{}, scale_log2);
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(ds, kk, da[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc, da[kk], desc_mn(k_s, kk, kBox));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i, pos = p0 + (r >> gshift);
    if (pos >= Tq) continue;
    const int h = h0 + (r & (Gt - 1));
    store_row<D>(dq + (((long long)b * Tq + pos) * Hq + h) * D + 2 * quad,
                 acc, i, scale);
  }
}

template <int D, int kStages>
struct DkdvLayout {  // k, v: [W][chunk]; q, dout: [stage][chunk]; rows:
                     // [stage][lse, Delta][64] f32; bars: kv, full, empty
  static constexpr int W = kDkdvWG, kChunks = D / kBoxCols;
  static constexpr int k = 0;
  static constexpr int v = k + W * kChunks * kBox;
  static constexpr int q = v + W * kChunks * kBox;
  static constexpr int dout = q + kStages * kChunks * kBox;
  static constexpr int rows = dout + kStages * kChunks * kBox;
  static constexpr int bars = rows + kStages * 2 * kRows * 4;
  static constexpr int bytes = bars + 8 * (1 + 2 * kStages);
};

// P^T and dS^T = P^T * (dP^T - Delta) of one tile of dK/dV: rows are
// keys, columns the query rows 8 j + 2 quad + c, whose lse * log2(e) and
// Delta are rv[r] and rv[64 + r]; 0 outside each key's span
__device__ __forceinline__ void dkdv_scores(
    const float (&st)[32], const float (&dpt)[32], float (&pt)[32],
    float (&dst)[32], const float* rv, int quad, const Spans& sp,
    float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(rv + 8 * j + 2 * quad);
    const float2 dl =
        *reinterpret_cast<const float2*>(rv + kRows + 8 * j + 2 * quad);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        const float p =
            sp.has(i, 8 * j + c)
                ? exp2_approx(fmaf(st[e], scale_log2, -(c ? l2.y : l2.x)))
                : 0.f;
        pt[e] = p;
        dst[e] = p * (dpt[e] - (c ? dl.y : dl.x));
      }
  }
}

// dK/dV: one CTA per (b * Hk + KV head, W tiles of 64 keys) looping over
// the head groups and the packed query tiles that can see its keys.  W
// consumer warpgroups, one per key tile, share each Q/dO tile; a producer
// warpgroup (one warp working) hands them its registers (setmaxnreg), as
// the two 64 x D accumulators take 128 a thread.  Per tile S^T = K Q^T
// and dP^T = V dO^T, then P^T and dS^T in registers, dV += P^T dO and
// dK += dS^T Q.
template <int D, int kStages>
__global__ void __launch_bounds__(128 * (kDkdvWG + 1), 1)
flash_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int Tq, int Hq, int Hk,
                 int gshift, Mask mk, float scale_log2, float scale) {
  using L = DkdvLayout<D, kStages>;
  constexpr int W = kDkdvWG;
  constexpr int kChunks = L::kChunks;
  constexpr int kStageBytes = kChunks * kBox;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_base(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  float* row_vals = reinterpret_cast<float*>(sm + L::rows);

  const int Gt = 1 << gshift, P = kRows >> gshift, G = Hq / Hk;
  const int b = blockIdx.x / Hk, kvh = blockIdx.x % Hk;
  const int Tk = mk.Tk;
  // the first key tiles (the most queries under a causal mask) start first
  const int key0 = blockIdx.y * W * kKeys;
  const int key_last = min(key0 + W * kKeys, Tk) - 1;
  // positions that can see a key of [key0, key_last]
  int t_lo = 0, t_hi = Tq;
  if (mk.causal) t_lo = max(0, key0 - mk.q_offset);
  if (mk.window) t_hi = min(Tq, key_last + mk.window - mk.q_offset);
  const int pt_lo = t_lo / P;
  const int n_pt = t_hi > t_lo ? (t_hi + P - 1) / P - pt_lo : 0;
  const int n_it = n_pt * (G >> gshift);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // every producer lane, after its row values
      mbar_init(&empty[s], 4 * W);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * W) {  // producer warpgroup: its first warp works
    setmaxnreg_dec<24>();
    if (warp != 4 * W) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * W * kChunks * kBox);
      for (int w = 0; w < W; ++w)
        for (int c = 0; c < kChunks; ++c) {
          tma_load_4d(sm + L::k + (w * kChunks + c) * kBox, &tm_k, kv_full,
                      c * kBoxCols, kvh, key0 + w * kKeys, b);
          tma_load_4d(sm + L::v + (w * kChunks + c) * kBox, &tm_v, kv_full,
                      c * kBoxCols, kvh, key0 + w * kKeys, b);
        }
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const int hg = kvh * G + (it / n_pt) * Gt, pos0 = (pt_lo + it % n_pt) * P;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      // lse * log2(e) and Delta of the tile's 64 rows, by the whole warp
      float* rv = row_vals + s * 2 * kRows;
      for (int r = lane; r < kRows; r += 32) {
        const int pos = pos0 + (r >> gshift);
        float l2 = INFINITY, dl = 0.f;
        if (pos < Tq) {
          const long long x =
              ((long long)b * Hq + hg + (r & (Gt - 1))) * Tq + pos;
          l2 = lse_log2(lse[x]);
          dl = delta[x];
        }
        rv[r] = l2;
        rv[kRows + r] = dl;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * kChunks * kBox);
        for (int c = 0; c < kChunks; ++c) {
          tma_load_4d(sm + L::q + (s * kChunks + c) * kBox, &tm_q, &full[s],
                      c * kBoxCols, hg, pos0, b);
          tma_load_4d(sm + L::dout + (s * kChunks + c) * kBox, &tm_do,
                      &full[s], c * kBoxCols, hg, pos0, b);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // consumer warpgroup wg: keys kw0 + key + 8 i
  const int wg = warp / 4, quad = lane % 4, key = 16 * (warp % 4) + lane / 4;
  const int kw0 = key0 + wg * kKeys;
  const int kp[2] = {kw0 + key, kw0 + key + 8};
  const uint8_t* k_s = sm + L::k + wg * kChunks * kBox;
  const uint8_t* v_s = sm + L::v + wg * kChunks * kBox;

  float dk_acc[D / 2], dv_acc[D / 2], st[32], dpt[32];
  zero(dk_acc);
  zero(dv_acc);
  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages, pos0 = (pt_lo + it % n_pt) * P;
    mbar_wait(&full[s], (it / kStages) & 1);
    const int q_lo = mk.q_offset + pos0;
    const int q_hi = mk.q_offset + min(pos0 + P, Tq) - 1;
    // a query tile of the CTA's range may still miss every key of this
    // warpgroup (causal: rows before kw0)
    if (tile_any(mk, q_lo, q_hi, kw0, kw0 + kKeys - 1)) {
      const uint8_t* q_s = sm + L::q + s * kStageBytes;
      const uint8_t* do_s = sm + L::dout + s * kStageBytes;
      const float* rv = row_vals + s * 2 * kRows;
      wgmma_fence();
      issue_qk<D>(st, k_s, q_s);   // S^T = K Q^T
      issue_qk<D>(dpt, v_s, do_s); // dP^T = V dO^T
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      float pt[32], dst[32];
      // every tile takes the span mask: a branch to an unmasked copy
      // measured slower here (not so in the forward and dQ)
      dkdv_scores(st, dpt, pt, dst, rv, quad,
                  query_spans(mk, Tq, kp, pos0, Gt, quad), scale_log2);
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pack_a(pt, kk, pa[kk]);
        pack_a(dst, kk, da[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(dv_acc, pa[kk], desc_mn(do_s, kk, kBox));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(dk_acc, da[kk], desc_mn(q_s, kk, kBox));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kp[i] >= Tk) continue;
    const long long off = (((long long)b * Tk + kp[i]) * Hk + kvh) * D +
                          2 * quad;
    store_row<D>(dk + off, dk_acc, i, scale);
    store_row<D>(dv + off, dv_acc, i, 1.f);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse_in, *delta;
  void *out, *lse_out, *dq, *dk, *dv;
  int B, Tq, Tk, Hq, Hk;
  Mask mk;
  float scale;
  cudaStream_t stream;
};

enum Which { kFwd = 0, kDq = 1, kDkdv = 2 };

// The route of each (dtype, D), and nothing else decides it:
//   bf16, D 64 and 128 -> the tensor cores (wgmma on TMA-staged tiles);
//   f32, any D         -> the CUDA cores (on the tensor cores f32 would be
//                         TF32, outside the f32 tolerance of 2e-5);
//   bf16, D 32 and 256 -> the CUDA cores (no config of the port has these
//                         head dims; at D 256 the dK/dV accumulators alone
//                         would take 256 registers a thread).
enum Route { kNoRoute = 0, kCudaCores = 1, kTensorCores = 2 };

Route route_of(int dtype, int D) {
  if (D != 32 && D != 64 && D != 128 && D != 256) return kNoRoute;
  if (dtype == 0) return kCudaCores;
  if (dtype == 1) return (D == 64 || D == 128) ? kTensorCores : kCudaCores;
  return kNoRoute;
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
cudaError_t launch_cuda_cores(Which which, const Args& a) {
  const int rows = a.Tq * (a.Hq / a.Hk);
  const dim3 grid_q((rows + kTile - 1) / kTile, a.B * a.Hk);
  const dim3 grid_k((a.Tk + kTile - 1) / kTile, a.B * a.Hk);
  cudaError_t err;
  if (which == kFwd) {
    constexpr size_t smem = fwd_smem<D>();
    auto kern = flash_fwd_kernel<T, D>;
    if ((err = allow_smem(kern, (int)smem)) != cudaSuccess) return err;
    kern<<<grid_q, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.out),
        static_cast<float*>(a.lse_out), a.Tq, a.Hq, a.Hk, a.mk, a.scale);
  } else if (which == kDq) {
    constexpr size_t smem = dq_smem<D>();
    auto kern = flash_dq_kernel<T, D>;
    if ((err = allow_smem(kern, (int)smem)) != cudaSuccess) return err;
    kern<<<grid_q, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.Tq,
        a.Hq, a.Hk, a.mk, a.scale);
  } else {
    constexpr size_t smem = dkdv_smem<D>();
    auto kern = flash_dkdv_kernel<T, D>;
    if ((err = allow_smem(kern, (int)smem)) != cudaSuccess) return err;
    kern<<<grid_k, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.Tq, a.Hq, a.Hk, a.mk, a.scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tensor_cores(Which which, const Args& a) {
  using namespace tc;
  using bf16 = __nv_bfloat16;
  const int G = a.Hq / a.Hk;
  int gshift = 0;  // Gt = 2^gshift: the largest power of two dividing G, <= 64
  while (gshift < 6 && (G >> gshift) % 2 == 0) ++gshift;
  const int Gt = 1 << gshift, P = kRows / Gt;
  // Q and dO: boxes of (64 columns, Gt heads, P positions); K and V: boxes
  // of (64 columns, 1 head, 64 keys)
  CUtensorMap tq, tk, tv, tdo;
  bool ok =
      hopper::encode_bf16_4d(&tq, a.q, D, a.Hq, a.Tq, a.B, kBoxCols, Gt, P,
                             1) &&
      hopper::encode_bf16_4d(&tk, a.k, D, a.Hk, a.Tk, a.B, kBoxCols, 1, kKeys,
                             1) &&
      hopper::encode_bf16_4d(&tv, a.v, D, a.Hk, a.Tk, a.B, kBoxCols, 1, kKeys,
                             1);
  if (which != kFwd)
    ok = ok && hopper::encode_bf16_4d(&tdo, a.dout, D, a.Hq, a.Tq, a.B,
                                      kBoxCols, Gt, P, 1);
  if (!ok) return cudaErrorInvalidValue;
  const float scale_log2 = a.scale * kLog2e;
  cudaError_t err;
  if (which == kFwd) {
    constexpr int smem = FwdLayout<D, kFwdStages>::bytes;
    auto kern = flash_fwd_wgmma<D, kFwdStages>;
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return err;
    const dim3 grid((a.Tq + P - 1) / P, a.B * a.Hk, G / Gt);
    kern<<<grid, 160, smem, a.stream>>>(
        tq, tk, tv, static_cast<bf16*>(a.out), static_cast<float*>(a.lse_out),
        a.Tq, a.Hq, a.Hk, gshift, a.mk, scale_log2);
  } else if (which == kDq) {
    constexpr int smem = DqLayout<D, kDqStages>::bytes;
    auto kern = flash_dq_wgmma<D, kDqStages>;
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return err;
    const dim3 grid((a.Tq + P - 1) / P, a.B * a.Hk, G / Gt);
    kern<<<grid, 160, smem, a.stream>>>(
        tq, tk, tv, tdo, static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.delta), static_cast<bf16*>(a.dq), a.Tq,
        a.Hq, a.Hk, gshift, a.mk, scale_log2, a.scale);
  } else {
    constexpr int W = kDkdvWG, smem = DkdvLayout<D, kDkdvStages>::bytes;
    auto kern = flash_dkdv_wgmma<D, kDkdvStages>;
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return err;
    const dim3 grid(a.B * a.Hk, (a.Tk + W * kKeys - 1) / (W * kKeys));
    kern<<<grid, 128 * (W + 1), smem, a.stream>>>(
        tq, tk, tv, tdo, static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.delta), static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.Tq, a.Hq, a.Hk, gshift, a.mk, scale_log2,
        a.scale);
  }
  return cudaGetLastError();
}

// the CUDA-core body is instantiated only where route_of sends it: f32 at
// every D, bf16 at D 32 and 256
cudaError_t launch_cuda_cores_any(int dtype, int D, Which which,
                                  const Args& a) {
  using bf16 = __nv_bfloat16;
  if (dtype == 1)
    return D == 32 ? launch_cuda_cores<bf16, 32>(which, a)
                   : launch_cuda_cores<bf16, 256>(which, a);
  switch (D) {
    case 32: return launch_cuda_cores<float, 32>(which, a);
    case 64: return launch_cuda_cores<float, 64>(which, a);
    case 128: return launch_cuda_cores<float, 128>(which, a);
    default: return launch_cuda_cores<float, 256>(which, a);
  }
}

int launch_any(int dtype, int D, Which which, const Args& a) {
  if (a.B == 0 || a.Tq == 0 || a.Tk == 0) return cudaSuccess;
  switch (route_of(dtype, D)) {
    case kTensorCores:
      return D == 64 ? launch_tensor_cores<64>(which, a)
                     : launch_tensor_cores<128>(which, a);
    case kCudaCores:
      return launch_cuda_cores_any(dtype, D, which, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, out, dout, dq contiguous
// (B,Tq,Hq,D); k, v, dk, dv contiguous (B,Tk,Hk,D); lse and delta
// contiguous (B,Hq,Tq) float32; every pointer 16-byte aligned.  Each
// returns the cudaError_t of its launch (0 = launched).

// the route of (dtype, D): 0 none, 1 the CUDA cores, 2 the tensor cores
extern "C" int flash_attention_route(int dtype, int D) {
  return route_of(dtype, D);
}

// forward: out = attention(q, k, v), lse = each row's log-sum-exp
extern "C" int flash_attention_fwd_launch(
    int dtype, const void* q, const void* k, const void* v, void* out,
    void* lse, int B, int Tq, int Tk, int Hq, int Hk, int D, int q_offset,
    int causal, int window, float scale, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, out, lse, nullptr,
               nullptr, nullptr, B, Tq, Tk, Hq, Hk,
               Mask{Tk, q_offset, causal, window}, scale,
               static_cast<cudaStream_t>(stream)};
  return launch_any(dtype, D, kFwd, a);
}

// dq from dout, the forward's lse and delta = rowsum(dout * out)
extern "C" int flash_attention_dq_launch(
    int dtype, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, void* dq, int B,
    int Tq, int Tk, int Hq, int Hk, int D, int q_offset, int causal,
    int window, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, nullptr, dq, nullptr,
               nullptr, B, Tq, Tk, Hq, Hk,
               Mask{Tk, q_offset, causal, window}, scale,
               static_cast<cudaStream_t>(stream)};
  return launch_any(dtype, D, kDq, a);
}

// dk and dv, summed over the query heads of each KV head
extern "C" int flash_attention_dkdv_launch(
    int dtype, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, void* dk,
    void* dv, int B, int Tq, int Tk, int Hq, int Hk, int D, int q_offset,
    int causal, int window, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, nullptr, nullptr, dk,
               dv, B, Tq, Tk, Hq, Hk, Mask{Tk, q_offset, causal, window},
               scale, static_cast<cudaStream_t>(stream)};
  return launch_any(dtype, D, kDkdv, a);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
