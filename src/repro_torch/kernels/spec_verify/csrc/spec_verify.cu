// Spec-verify (K1) and tree-verify (K2) attention for Hopper, written by
// hand in CUDA C++: one kernel body, with the tree mask as an optional
// operand, as in the Pallas version.
//
// K1 replaces the Pallas TPU kernel repro/kernels/spec_verify/kernel.py
// (spec_verify_pallas -> _verify_call -> pl.pallas_call, body
// _verify_kernel).  Same function: for q (B,T,Hq,D) over a slot cache
// k,v (B,S,Hk,D), softmax(q k^T / sqrt(D)) v under the mask
//   (k_pos >= 0) & (k_pos <= q_pos) & (k_pos > q_pos - window, if window)
// with query head h reading KV head h / (Hq/Hk); rows with no visible key
// give 0.  Scores, softmax and the accumulator are f32; the output has
// q's dtype.  It is the attention of every cached forward of the port's
// linear path: decode (T=1), linear speculative verify (T=gamma+1) and
// mixed prefill chunks (T <= prefill_chunk).
//
// K2 replaces tree_verify_pallas (same file, body _tree_kernel): K1 with
// a (B,T,S) byte mask ANDed into the positional mask, so a draft-tree
// node sees the committed prefix and its own ancestors but not a sibling
// at the same position.  It is the attention of every forward of the
// tree-speculation path (decode, tree verify and prefill chunks alike).
// Row r of a CTA reads mask row t(r) = r / (Hq/Hk) at the slot its lane
// scores; the bytes of the next tile are loaded with its K/V, one tile
// ahead.  The arithmetic is K1's, in K1's order: with an all-true mask
// K2's output is bitwise K1's.
//
// What bounds them: at the engine's shapes (a few query rows per KV head,
// a cache of thousands of slots) they are bound by memory.  A call must
// read the K/V rows of the live slots once (B*S_live*Hk*D*2 elements),
// plus B*T*S mask bytes for K2, and does 4*B*T*Hq*S_live*D flops, far
// below the card's ratio of ~295 flops per byte.  What the design does
// about it:
//   * One CTA per (b, KV head, tile of 32 query rows).  The Hq/Hk query
//     heads x T positions that share a KV head are packed into the CTA's
//     rows, so each K/V tile is read from device memory once per KV head
//     (the Pallas grid re-streams it once per query head).
//   * K/V stream through shared memory in tiles of 32 slots, loaded as
//     16-byte vectors into registers one tile ahead: the loads of tile
//     i+1 are in flight while the CTA computes on tile i, so a tile costs
//     its arithmetic, not a round trip to device memory.  The online
//     softmax (m, l, acc) stays in registers, in f32, and the output is
//     written once.
//   * Before the loop the CTA marks which tiles any of its rows can see
//     (empty slots, slots in the future or outside the window are not),
//     and loads only those, so a half-empty cache costs what its live
//     slots cost.  Skipping a fully masked tile leaves (m, l, acc)
//     bit-identical.  The test is positional for K2 too: the tree mask
//     only narrows what a row sees, so the marked tiles stay a superset.
//   * No atomics and a fixed reduction order: repeated runs are bitwise
//     deterministic.
// Later work (not here): split S across CTAs when B*Hk underfills the 132
// SMs, TMA for the tiles, wgmma for T*G >= 64.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   -shared -Xcompiler -fPIC; bound to PyTorch through a plain C
//   interface (ctypes), see ops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kBlockK = 32;                   // slots per tile, one per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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

__device__ __forceinline__ bool visible(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window == 0 || kp > qp - window);
}

// Registers holding one K/V tile (and its slot positions) on its way from
// device memory to shared memory.
template <typename T, int D>
struct TileRegs {
  static constexpr int kVec = 16 / sizeof(T);      // elements per vector
  static constexpr int kRowVecs = D / kVec;        // vectors per slot
  static constexpr int kVecs = kBlockK * kRowVecs; // vectors per tile
  static constexpr int kPer = (kVecs + kThreads - 1) / kThreads;
  uint4 k[kPer], v[kPer];
  int kp;

  __device__ __forceinline__ void load(const T* kb, const T* vb,
                                       const int* kpb, int s0, int S,
                                       long long key_stride, int tid) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * kThreads;
      const int j = c / kRowVecs, d = (c % kRowVecs) * kVec;
      if (c < kVecs && s0 + j < S) {
        const long long off = (s0 + j) * key_stride + d;
        k[i] = *reinterpret_cast<const uint4*>(kb + off);
        v[i] = *reinterpret_cast<const uint4*>(vb + off);
      } else {
        k[i] = v[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (tid < kBlockK) kp = s0 + tid < S ? kpb[s0 + tid] : -1;
  }

  // ks is [kBlockK][D+1] (padded: no bank conflicts when lane = slot),
  // vs is [kBlockK][D]
  __device__ __forceinline__ void store(float* ks, float* vs, int* kps,
                                        int tid) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * kThreads;
      if (c >= kVecs) continue;
      const int j = c / kRowVecs, d = (c % kRowVecs) * kVec;
      float f[kVec];
      unpack(k[i], f, T());
#pragma unroll
      for (int e = 0; e < kVec; ++e) ks[j * (D + 1) + d + e] = f[e];
      unpack(v[i], f, T());
#pragma unroll
      for (int e = 0; e < kVec; e += 4)
        *reinterpret_cast<float4*>(vs + j * D + d + e) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
    if (tid < kBlockK) kps[tid] = kp;
  }
};

__device__ __forceinline__ int next_tile(const int* need, int t, int n) {
  while (t < n && !need[t]) ++t;
  return t;
}

template <int D>
size_t smem_bytes(int S) {
  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  return sizeof(float) * (kRows * D + kBlockK * (D + 1) + kBlockK * D +
                          kRows * kBlockK) +
         sizeof(int) * (kBlockK + kRows + n_tiles);
}

// kTree = false: K1 (tree_mask unused); true: K2.
template <typename T, int D, bool kTree>
__global__ void __launch_bounds__(kThreads)
spec_verify_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ q_pos,
                   const int* __restrict__ k_pos,
                   const unsigned char* __restrict__ tree_mask,
                   T* __restrict__ out, int n_t, int S, int Hq, int Hk,
                   long long kv_b_stride, long long kpos_b_stride,
                   long long tm_b_stride, long long tm_t_stride, int window,
                   float scale) {
  constexpr int NDW = D / 32;  // output dims owned by each lane
  extern __shared__ float smem[];
  float* qs = smem;                        // [kRows][D], scaled f32
  float* ks = qs + kRows * D;              // [kBlockK][D+1]
  float* vs = ks + kBlockK * (D + 1);      // [kBlockK][D]
  float* ps = vs + kBlockK * D;            // [kRows][kBlockK] probabilities
  int* kps = reinterpret_cast<int*>(ps + kRows * kBlockK);  // [kBlockK]
  int* qps = kps + kBlockK;                                 // [kRows]
  int* need = qps + kRows;                                  // [n_tiles]

  const int G = Hq / Hk;
  const int b = blockIdx.y / Hk;
  const int kvh = blockIdx.y % Hk;
  const int row0 = blockIdx.x * kRows;  // row r <-> (t = r / G, g = r % G)
  const int n_rows = n_t * G;
  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

#pragma unroll
  for (int i = 0; i < kRows * D / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = row0 + e / D;
    float x = 0.f;
    if (r < n_rows) {
      const int t = r / G, h = kvh * G + r % G;
      x = to_f32(q[(((long long)b * n_t + t) * Hq + h) * D + e % D]) * scale;
    }
    qs[e] = x;
  }
  for (int i = tid; i < kRows; i += kThreads) {
    const int r = row0 + i;
    qps[i] = r < n_rows ? q_pos[(long long)b * n_t + r / G] : -1;
  }
  __syncthreads();

  // position range of the CTA's rows: a tile is loaded only if one of its
  // slots may be visible to one of them (a superset test, never a miss)
  int q_lo = 0x7fffffff, q_hi = -1;
  for (int i = 0; i < kRows; ++i) {
    if (row0 + i < n_rows) {
      q_lo = min(q_lo, qps[i]);
      q_hi = max(q_hi, qps[i]);
    }
  }
  const int* kpb = k_pos + (long long)b * kpos_b_stride;
  // each warp marks 4 tiles per pass, their positions loaded together
  for (int t0 = warp * 4; t0 < n_tiles; t0 += kWarps * 4) {
    int kp[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int s = (t0 + u) * kBlockK + lane;
      kp[u] = s < S ? kpb[s] : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool ok = kp[u] >= 0 && kp[u] <= q_hi &&
                      (window == 0 || kp[u] > q_lo - window);
      const unsigned any = __ballot_sync(0xffffffffu, ok);
      if (lane == 0 && t0 + u < n_tiles) need[t0 + u] = any != 0u;
    }
  }
  __syncthreads();

  float acc[kRowsPerWarp][NDW];
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_run[rr] = kNegInf;
    l_run[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < NDW; ++i) acc[rr][i] = 0.f;
  }

  const long long key_stride = (long long)Hk * D;
  const T* kb = k + (long long)b * kv_b_stride + (long long)kvh * D;
  const T* vb = v + (long long)b * kv_b_stride + (long long)kvh * D;
  const int wrow = warp * kRowsPerWarp;
  const bool warp_has_rows = row0 + wrow < n_rows;  // uniform over the warp

  // K2: the mask row of each of the warp's query rows, and this lane's
  // mask bytes (slot tile*kBlockK + lane) of the current / next tile
  const unsigned char* tmr[kRowsPerWarp];
  unsigned char m_cur[kRowsPerWarp], m_nxt[kRowsPerWarp];
  if constexpr (kTree) {
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = row0 + wrow + rr;
      tmr[rr] = tree_mask + (long long)b * tm_b_stride +
                (long long)(r < n_rows ? r / G : 0) * tm_t_stride;
      m_cur[rr] = m_nxt[rr] = 0;
    }
  }
  auto load_mask = [&](int tile, unsigned char* m) {
    const int s = tile * kBlockK + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
      m[rr] = (s < S && row0 + wrow + rr < n_rows) ? tmr[rr][s] : 0;
  };

  TileRegs<T, D> regs;
  int cur = next_tile(need, 0, n_tiles);
  if (cur < n_tiles) {
    regs.load(kb, vb, kpb, cur * kBlockK, S, key_stride, tid);
    if constexpr (kTree)
      if (warp_has_rows) load_mask(cur, m_cur);
  }
  while (cur < n_tiles) {
    regs.store(ks, vs, kps, tid);
    const int nxt = next_tile(need, cur + 1, n_tiles);
    __syncthreads();  // tile cur is in shared memory
    if (nxt < n_tiles) {  // in flight while this tile is computed
      regs.load(kb, vb, kpb, nxt * kBlockK, S, key_stride, tid);
      if constexpr (kTree)
        if (warp_has_rows) load_mask(nxt, m_nxt);
    }

    if (warp_has_rows) {
      // scores: lane j scores slot j of the tile against the warp's rows
      float sc[kRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) sc[rr] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kx = ks[lane * (D + 1) + d];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr)
          sc[rr] = fmaf(qs[(wrow + rr) * D + d], kx, sc[rr]);
      }

      const int kpj = kps[lane];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        if (row0 + wrow + rr >= n_rows) continue;  // uniform over the warp
        bool ok = visible(kpj, qps[wrow + rr], window);
        if constexpr (kTree) ok = ok && m_cur[rr] != 0;
        const float s = ok ? sc[rr] : kNegInf;
        const float m_new = fmaxf(m_run[rr], warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float corr = expf(m_run[rr] - m_new);
        l_run[rr] = corr * l_run[rr] + warp_sum(p);
        m_run[rr] = m_new;
        ps[(wrow + rr) * kBlockK + lane] = p;
#pragma unroll
        for (int i = 0; i < NDW; ++i) acc[rr][i] *= corr;
      }
      __syncwarp();

      // acc += p @ v: lane owns output dims lane + 32*i
      for (int j = 0; j < kBlockK; ++j) {
        float vx[NDW];
#pragma unroll
        for (int i = 0; i < NDW; ++i) vx[i] = vs[j * D + lane + 32 * i];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const float p = ps[(wrow + rr) * kBlockK + j];
#pragma unroll
          for (int i = 0; i < NDW; ++i)
            acc[rr][i] = fmaf(p, vx[i], acc[rr][i]);
        }
      }
    }
    __syncthreads();  // the next store overwrites ks / vs / kps / ps
    if constexpr (kTree) {
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) m_cur[rr] = m_nxt[rr];
    }
    cur = nxt;
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = row0 + wrow + rr;
    if (r >= n_rows) continue;
    const int t = r / G, h = kvh * G + r % G;
    const float l = fmaxf(l_run[rr], 1e-30f);
    T* o = out + (((long long)b * n_t + t) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < NDW; ++i) store_out(o + lane + 32 * i, acc[rr][i] / l);
  }
}

// Everything a launch needs besides the element type and head dim.
struct Args {
  const void *q, *k, *v, *q_pos, *k_pos;
  const unsigned char* tree_mask;  // null for K1
  void* out;
  int B, n_t, S, Hq, Hk;
  long long kv_b_stride, kpos_b_stride, tm_b_stride, tm_t_stride;
  int window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool kTree>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes<D>(a.S);
  auto kern = spec_verify_kernel<T, D, kTree>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = a.n_t * (a.Hq / a.Hk);
  dim3 grid((rows + kRows - 1) / kRows, a.B * a.Hk);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.q_pos),
      static_cast<const int*>(a.k_pos), a.tree_mask, static_cast<T*>(a.out),
      a.n_t, a.S, a.Hq, a.Hk, a.kv_b_stride, a.kpos_b_stride, a.tm_b_stride,
      a.tm_t_stride, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, bool kTree>
cudaError_t launch_d(int D, const Args& a) {
  switch (D) {
    case 32: return launch<T, 32, kTree>(a);
    case 64: return launch<T, 64, kTree>(a);
    case 128: return launch<T, 128, kTree>(a);
    case 256: return launch<T, 256, kTree>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kTree>
int launch_any(int dtype, int D, const Args& a) {
  if (dtype == 0) return launch_d<float, kTree>(D, a);
  if (dtype == 1) return launch_d<__nv_bfloat16, kTree>(D, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out contiguous (B,T,Hq,D); k/v
// (B,S,Hk,D) with contiguous (S,Hk,D) rows, batch stride kv_b_stride and
// 16-byte aligned rows; q_pos contiguous (B,T) int32; k_pos (B,S) int32
// with batch stride kpos_b_stride.  Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int spec_verify_launch(int dtype, const void* q, const void* k,
                                  const void* v, const void* q_pos,
                                  const void* k_pos, void* out, int B,
                                  int n_t, int S, int Hq, int Hk, int D,
                                  long long kv_b_stride,
                                  long long kpos_b_stride, int window,
                                  float scale, void* stream) {
  const Args a{q, k, v, q_pos, k_pos, nullptr, out, B, n_t, S, Hq, Hk,
               kv_b_stride, kpos_b_stride, 0, 0, window, scale,
               static_cast<cudaStream_t>(stream)};
  return launch_any<false>(dtype, D, a);
}

// K2: spec_verify_launch's arguments plus tree_mask, (B,T,S) bytes (0 =
// hidden) with contiguous rows, batch stride tm_b_stride and row stride
// tm_t_stride.
extern "C" int tree_verify_launch(int dtype, const void* q, const void* k,
                                  const void* v, const void* q_pos,
                                  const void* k_pos, const void* tree_mask,
                                  void* out, int B, int n_t, int S, int Hq,
                                  int Hk, int D, long long kv_b_stride,
                                  long long kpos_b_stride,
                                  long long tm_b_stride,
                                  long long tm_t_stride, int window,
                                  float scale, void* stream) {
  const Args a{q, k, v, q_pos, k_pos,
               static_cast<const unsigned char*>(tree_mask), out, B, n_t, S,
               Hq, Hk, kv_b_stride, kpos_b_stride, tm_b_stride, tm_t_stride,
               window, scale, static_cast<cudaStream_t>(stream)};
  return launch_any<true>(dtype, D, a);
}

extern "C" const char* spec_verify_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
