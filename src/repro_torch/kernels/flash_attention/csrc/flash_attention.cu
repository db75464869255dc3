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
// bytes there and dK/dV by operations.  This first version computes on
// the CUDA cores in f32 (67 TFLOP/s peak, not the tensor cores' 989), so
// it is bound by operations and runs far above that bound; wgmma on
// tiles staged by TMA is later work.  What the design does:
//   * The G query heads x query positions that share a KV head are
//     packed into a CTA's 32 rows (row r <-> position r / G, head r % G),
//     so each K/V tile read from device memory serves G heads (the Pallas
//     grid re-reads it once per query head).
//   * Tiles of 32 rows stream through shared memory as 16-byte vector
//     loads, held in registers one tile ahead: the loads of tile i+1 are
//     in flight while the CTA computes on tile i.  Scores, the online
//     softmax (m, l, acc) and every sum are f32 in registers.
//   * Tiles wholly above the diagonal or outside the window are never
//     loaded (the Pallas kernel's `run` predicate): the forward and dQ
//     walk only the key tiles their rows can see, dK/dV only the query
//     tiles that can see their keys.
//   * No atomics: dQ is one CTA per query tile looping over key tiles,
//     dK/dV one CTA per (b, KV head, key tile) looping over the query
//     heads and query tiles, each output written once in a fixed order,
//     so repeated runs are bitwise equal.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   -shared -Xcompiler -fPIC; bound to PyTorch through a plain C
//   interface (ctypes), see ops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename T, int D>
cudaError_t launch(Which which, const Args& a) {
  const int rows = a.Tq * (a.Hq / a.Hk);
  const dim3 grid_q((rows + kTile - 1) / kTile, a.B * a.Hk);
  const dim3 grid_k((a.Tk + kTile - 1) / kTile, a.B * a.Hk);
  cudaError_t err;
  if (which == kFwd) {
    constexpr size_t smem = fwd_smem<D>();
    auto kern = flash_fwd_kernel<T, D>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid_q, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.out),
        static_cast<float*>(a.lse_out), a.Tq, a.Hq, a.Hk, a.mk, a.scale);
  } else if (which == kDq) {
    constexpr size_t smem = dq_smem<D>();
    auto kern = flash_dq_kernel<T, D>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid_q, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.Tq,
        a.Hq, a.Hk, a.mk, a.scale);
  } else {
    constexpr size_t smem = dkdv_smem<D>();
    auto kern = flash_dkdv_kernel<T, D>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid_k, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.Tq, a.Hq, a.Hk, a.mk, a.scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, Which which, const Args& a) {
  switch (D) {
    case 32: return launch<T, 32>(which, a);
    case 64: return launch<T, 64>(which, a);
    case 128: return launch<T, 128>(which, a);
    case 256: return launch<T, 256>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

int launch_any(int dtype, int D, Which which, const Args& a) {
  if (a.B == 0 || a.Tq == 0 || a.Tk == 0) return cudaSuccess;
  if (dtype == 0) return launch_d<float>(D, which, a);
  if (dtype == 1) return launch_d<__nv_bfloat16>(D, which, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, out, dout, dq contiguous
// (B,Tq,Hq,D); k, v, dk, dv contiguous (B,Tk,Hk,D); lse and delta
// contiguous (B,Hq,Tq) float32; every pointer 16-byte aligned.  Each
// returns the cudaError_t of its launch (0 = launched).

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
