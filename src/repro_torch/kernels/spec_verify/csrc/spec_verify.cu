// Spec-verify (K1) and tree-verify (K2) attention for Hopper, written by
// hand in CUDA C++: one templated body per route, with the tree mask as
// an optional operand (kTree), as in the Pallas version.
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
// The arithmetic is K1's, in K1's order, on the same route: with an
// all-true mask K2's output is bitwise K1's.
//
// What bounds them: at the engine's shapes (a few query rows per KV head,
// a cache of thousands of slots) they are bound by memory.  A call must
// read the K/V rows of the live slots once (B*S_live*Hk*D*2 elements),
// plus B*T*S mask bytes for K2, and does 4*B*T*Hq*S_live*D flops, far
// below the card's ~295 flops per byte.  What keeps them from that bound
// differs with the width of the step, but a row's arithmetic must not
// (the row-invariance rule of row_gemm.cu: one request's logits may not
// change with the rows it shares a step with, a decode's T = 1 against
// the first position of a verify, 8 slots against one), so the route is
// a fixed table of (dtype, D) alone (route_of), the same at every T and
// B, and a shape always takes the same route for K1 and K2:
//
//   Tensor cores: bf16 at D 64 / 128, every T (decode, verify steps,
//   trees, mixed prefill chunks).  On the CUDA cores every score and P.V
//   term is an f32 FMA with a shared-memory read, ~30x the bound at
//   T = 64; a 64-row tile, padded where T * Hq/Hk is smaller, beat them
//   at every width measured, decode too (VLM self, T = 1: 0.0181 against
//   0.0224 ms).  Here one CTA per (64 packed rows, b, KV
//   head) runs one consumer warpgroup of wgmma products (S = Q K^T from
//   shared memory, O += P V with P as the register A operand) on 64-slot
//   K/V tiles that a producer warp stages by TMA in a ring completed on
//   mbarriers.  Rows are (position, head) pairs of one KV head, as K3
//   packs them, so a 64-row Q tile is one TMA box and each K/V tile serves
//   the heads of its KV head.  Before warp specialisation the CTA scans
//   k_pos once: a tile is listed only if some row may see one of its
//   slots, and it is unmasked when every slot is live, none lies past the
//   earliest row and all are inside the window; producer and consumer walk
//   that list in order.  Each tile branches once, to the unmasked softmax
//   or to the masked one (per element: k_pos from shared memory, staged
//   by the producer warp beside the tile, so the ring of a sliding window
//   with non-monotone positions is handled; K2's mask bytes arrive by TMA
//   with the tile, and every K2 tile takes the masked copy).  Softmax, the
//   accumulator and the row sums stay f32; the output is written once.
//   TMA asks of the operands: K/V base and batch stride in bytes multiples
//   of 16 (the engine's cache views, one scratch slot wider, are: S+1
//   slots of Hk*D*2 bytes), q contiguous with a 16-byte-aligned base, and
//   for K2 the mask's base, batch and row strides multiples of 16 bytes
//   (the engine's S = 2048 is); ops.check_inputs / check_tree_mask refuse
//   the rest, nothing is routed elsewhere.
//
//   CUDA cores: f32 (tensor cores would be TF32, outside the f32 2e-5
//   tolerance) and bf16 at D 32 / 256.  At decode the cost is latency and
//   idle warps, not arithmetic: with 4 query rows per KV head, warps that
//   divided the rows would leave 7 of 8 idle, and one CTA per (b, KV
//   head) would walk every live tile in series, 64 CTAs on 132 SMs.  So:
//     * a CTA holds R = 4 query rows (8 from 5 rows up) and its 8 warps
//       divide the slots: warp w walks the 32-slot tiles t_lo + w,
//       t_lo + w + 8, ... of its share that some row of the CTA may see,
//       lane j scoring slot j from its K row read straight from device
//       memory, P V reading each V row as one coalesced warp load; each
//       warp keeps its own online softmax and the 8 states are merged in
//       shared memory in a fixed order;
//     * the cache is cut into n_split shares of a fixed number of slots
//       (kSplitKeys, at most kMaxSplits shares: n_split a function of S
//       alone), one CTA each, which write (m, l, unnormalised acc) in f32
//       to a workspace; a second launch merges the splits in split order.
//       A row that sees nothing merges to exactly 0.
//     A tile's warp and share follow from its index and S alone, and a
//     tile a row cannot see (listed for another row of the CTA) leaves
//     that row's state unchanged (max kept, factor 1, p = 0), so a row's
//     arithmetic does not depend on T, B or the heads of the call.  A
//     caller may name n_split instead (a tensor-parallel rank's shard of
//     the heads asks for the unsharded call's, which is the same).
//
// Partials (`lse` given): every route also writes each row's f32
// log-sum-exp of its visible scores, lse = m + log l (-inf for a row that
// sees no key, whose output is 0), and writes the output in f32: a
// caller that holds only a share of the slots (a rank of the production
// layout's sequence-split cache) merges the shares' (o, lse) itself.
//
// Both routes: only tiles some row may see are loaded (empty slots, slots
// in the future or outside the window are not), so a half-empty cache
// costs what its live slots cost; no atomics and a fixed reduction order,
// so repeated runs are bitwise deterministic; on the tensor cores as on
// the CUDA cores a tile that one row cannot see but another row of the
// CTA can is an exact no-op for the first (its max kept, the factor
// 2^0 = 1, p = 0), so the rows a call holds change no row's bits.  A
// launch the card refuses returns its error; nothing falls back to
// another route.
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
constexpr int kBlockK = 32;  // slots per tile of the CUDA-core route
constexpr float kNegInf = -1e30f;
// the CUDA-core route cuts the cache into shares of kSplitKeys slots (one
// tile a warp), at most kMaxSplits of them: n_split depends on S alone
constexpr int kSplitKeys = kWarps * kBlockK;
constexpr int kMaxSplits = 8;

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

// One warp lists, in order, the tiles whose need[t] is nonzero as
// list[i] = t * 2 + (need[t] == 2); list[n_tiles] is their count.
__device__ __forceinline__ void list_tiles(const int* need, int n_tiles,
                                           int lane, int* list) {
  int cnt = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += 32) {
    const int t = t0 + lane;
    const int f = t < n_tiles ? need[t] : 0;
    const unsigned bal = __ballot_sync(0xffffffffu, f != 0);
    if (f) list[cnt + __popc(bal & ((1u << lane) - 1u))] = t * 2 + (f == 2);
    cnt += __popc(bal);
  }
  if (lane == 0) list[n_tiles] = cnt;
}

// ===========================================================================
// CUDA-core route
// ===========================================================================
//
// One CTA per (R query rows, b * Hk + KV head, split).  Every warp holds
// all R rows and walks its own 32-slot tiles of the CTA's share (warp w:
// tiles t_lo + w, t_lo + w + 8, ... that a row may see), so the 8 warps
// divide the slots, not the rows.  Lane j scores slot j against the R
// rows, its K row read straight from device memory as 16-byte vectors (q
// from shared memory, broadcast); P V reads each V row of the tile as one
// coalesced warp load, lane owning D/32 contiguous dims.  Each warp keeps
// its own online softmax; the warps' states merge in shared memory in a
// fixed tree (4-7 into 0-3, 2-3 into 0-1, 1 into 0).

// query rows of a CTA: 4 (decode at G <= 4), else 8
int rows_per_cta(int rows) { return rows <= 4 ? 4 : 8; }

template <int R, int D>
size_t cores_smem(int S) {
  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  return sizeof(float) * (R * D + kWarps * kBlockK * R +
                          (kWarps / 2) * R * (D + 2)) +
         sizeof(int) * (R + n_tiles);
}

// N contiguous elements of T at p (aligned to their size) as floats
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      unpack(u, f + i * (16 / (int)sizeof(T)), T());
    }
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(p[i]);
  } else if constexpr (N == 1) {
    f[0] = to_f32(p[0]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 x = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(p)[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
}

// kTree = false: K1 (tree_mask unused); true: K2.  With n_split == 1 the
// CTA writes `out` (T, or f32 with `lse`, which it writes too); otherwise
// its share's (acc, m, l) go to `part` for merge_splits.
template <typename T, int D, bool kTree, int R>
__global__ void __launch_bounds__(kThreads, R <= 4 ? 2 : 1)
verify_cores(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ q_pos,
             const int* __restrict__ k_pos,
             const unsigned char* __restrict__ tree_mask,
             void* __restrict__ out, float* __restrict__ lse,
             float* __restrict__ part, int n_t, int S,
             int Hq, int Hk, long long kv_b_stride, long long kpos_b_stride,
             long long tm_b_stride, long long tm_t_stride, int window,
             float scale) {
  constexpr int NDW = D / 32;                 // P V dims of each lane
  constexpr int kVec = 16 / (int)sizeof(T);   // elements per 16-byte vector
  constexpr int kRowVecs = D / kVec;          // vectors per K row
  // vectors of a K row in flight at once: the whole row of a bf16 head of
  // 128 or less (64 registers), else 8 (the R = 4 instances keep to 128
  // registers, two CTAs an SM)
  constexpr int kChunk = sizeof(T) == 2 && kRowVecs <= 16 ? kRowVecs : 8;
  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  extern __shared__ float smem[];
  float* qs = smem;                           // [R][D], scaled f32
  float* ps = qs + R * D;                     // [warp][slot][R]
  float* mrg = ps + kWarps * kBlockK * R;     // [kWarps / 2][R][D + 2]
  int* qps = reinterpret_cast<int*>(mrg + (kWarps / 2) * R * (D + 2));
  int* need = qps + R;                        // [n_tiles]

  const int G = Hq / Hk;
  const int B = gridDim.y / Hk;
  const int b = blockIdx.y / Hk;
  const int kvh = blockIdx.y % Hk;
  const int split = blockIdx.z, n_split = gridDim.z;
  const int row0 = blockIdx.x * R;  // row r <-> (t = r / G, g = r % G)
  const int n_rows = n_t * G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the slot positions of the first pass of the tile scan below, loaded
  // before q so that both are in flight together
  const int* kpb = k_pos + (long long)b * kpos_b_stride;
  constexpr int kScan = 8;  // tiles each warp marks per pass
  int kps[kScan];
  auto load_scan = [&](int t0) {
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int s = (t0 + u) * kBlockK + lane;
      kps[u] = s < S ? kpb[s] : -1;
    }
  };
  load_scan(warp * kScan);

#pragma unroll
  for (int i = 0; i < (R * D + kThreads - 1) / kThreads; ++i) {
    const int e = tid + i * kThreads;
    if (e >= R * D) break;
    const int r = row0 + e / D;
    float x = 0.f;
    if (r < n_rows) {
      const int t = r / G, h = kvh * G + r % G;
      x = to_f32(q[(((long long)b * n_t + t) * Hq + h) * D + e % D]) * scale;
    }
    qs[e] = x;
  }
  if (tid < R) {
    const int r = row0 + tid;
    qps[tid] = r < n_rows ? q_pos[(long long)b * n_t + r / G] : -1;
  }
  __syncthreads();

  // position range of the CTA's rows; the tiles one of them may see; this
  // CTA's share of the cache's tiles
  int q_lo = 0x7fffffff, q_hi = -1;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (row0 + i < n_rows) {
      q_lo = min(q_lo, qps[i]);
      q_hi = max(q_hi, qps[i]);
    }
  }
  // need[t]: may a row see a slot of tile t (a superset test, never a
  // miss: the tree mask only narrows what a row sees)
  for (int t0 = warp * kScan; t0 < n_tiles; t0 += kWarps * kScan) {
    if (t0 != warp * kScan) load_scan(t0);
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const bool ok = kps[u] >= 0 && kps[u] <= q_hi &&
                      (window == 0 || kps[u] > q_lo - window);
      const unsigned any = __ballot_sync(0xffffffffu, ok);
      if (lane == 0 && t0 + u < n_tiles) need[t0 + u] = any != 0u;
    }
  }
  __syncthreads();
  const int t_lo = (int)((long long)n_tiles * split / n_split);
  const int t_hi = (int)((long long)n_tiles * (split + 1) / n_split);

  // this warp's online softmax: m_run the warp's running max, l_run this
  // lane's share of the running sum (summed over the warp after the loop)
  float acc[R][NDW], m_run[R], l_run[R];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    m_run[rr] = kNegInf;
    l_run[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < NDW; ++e) acc[rr][e] = 0.f;
  }
  int qpr[R];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) qpr[rr] = qps[rr];  // -1 past the rows

  const long long key_stride = (long long)Hk * D;
  const T* kb = k + (long long)b * kv_b_stride + (long long)kvh * D;
  const T* vb = v + (long long)b * kv_b_stride + (long long)kvh * D;
  const unsigned char* tmr[R];  // K2: each row's mask row
  if constexpr (kTree) {
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int r = row0 + rr;
      tmr[rr] = tree_mask + (long long)b * tm_b_stride +
                (long long)(r < n_rows ? r / G : 0) * tm_t_stride;
    }
  }
  float* psw = ps + warp * kBlockK * R;

  for (int t = t_lo + warp; t < t_hi; t += kWarps) {
    if (!need[t]) continue;  // uniform over the warp
    const int s0 = t * kBlockK;
    const int s = s0 + lane;
    const bool in = s < S;
    const int kp = in ? kpb[s] : -1;
    unsigned char mk[R];
    if constexpr (kTree) {
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
        mk[rr] = (in && qpr[rr] >= 0) ? tmr[rr][s] : 0;
    }

    // scores: lane j's K row (slot s0 + j; slot s0 for a lane past S)
    // against the R rows, over the dims in order
    float sc[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) sc[rr] = 0.f;
    const T* krow = kb + (long long)(in ? s : s0) * key_stride;
#pragma unroll
    for (int c0 = 0; c0 < kRowVecs; c0 += kChunk) {
      uint4 kv[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        kv[c] = reinterpret_cast<const uint4*>(krow)[c0 + c];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        float f[kVec];
        unpack(kv[c], f, T());
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const int d = (c0 + c) * kVec + e;
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            const float4 q4 = *reinterpret_cast<const float4*>(qs + rr * D + d);
            sc[rr] = fmaf(q4.x, f[e], sc[rr]);
            sc[rr] = fmaf(q4.y, f[e + 1], sc[rr]);
            sc[rr] = fmaf(q4.z, f[e + 2], sc[rr]);
            sc[rr] = fmaf(q4.w, f[e + 3], sc[rr]);
          }
        }
      }
    }

#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      bool ok = visible(kp, qpr[rr], window);
      if constexpr (kTree) ok = ok && mk[rr] != 0;
      const float sv = ok ? sc[rr] : kNegInf;
      const float m_new = fmaxf(m_run[rr], warp_max(sv));
      const float p = ok ? expf(sv - m_new) : 0.f;
      const float corr = expf(m_run[rr] - m_new);
      l_run[rr] = corr * l_run[rr] + p;
      m_run[rr] = m_new;
      psw[lane * R + rr] = p;
#pragma unroll
      for (int e = 0; e < NDW; ++e) acc[rr][e] *= corr;
    }
    __syncwarp();

    // acc += p @ v over the tile's slots, in order
    const T* vt = vb + (long long)s0 * key_stride + lane * NDW;
#pragma unroll 8
    for (int j = 0; j < kBlockK; ++j) {
      if (s0 + j >= S) break;  // uniform over the warp
      float vx[NDW];
      load_vec<T, NDW>(vt + (long long)j * key_stride, vx);
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const float p = psw[j * R + rr];
#pragma unroll
        for (int e = 0; e < NDW; ++e) acc[rr][e] = fmaf(p, vx[e], acc[rr][e]);
      }
    }
    __syncwarp();  // psw is rewritten by the next tile
  }

#pragma unroll
  for (int rr = 0; rr < R; ++rr) l_run[rr] = warp_sum(l_run[rr]);

  // merge the warps' states, in a fixed order
  for (int half = kWarps / 2; half >= 1; half >>= 1) {
    if (warp >= half && warp < 2 * half) {
      float* w = mrg + (warp - half) * R * (D + 2);
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
#pragma unroll
        for (int e = 0; e < NDW; ++e)
          w[rr * (D + 2) + lane * NDW + e] = acc[rr][e];
        if (lane == 0) {
          w[rr * (D + 2) + D] = m_run[rr];
          w[rr * (D + 2) + D + 1] = l_run[rr];
        }
      }
    }
    __syncthreads();
    if (warp < half) {
      const float* w = mrg + warp * R * (D + 2);
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const float m2 = w[rr * (D + 2) + D];
        const float l2 = w[rr * (D + 2) + D + 1];
        const float mn = fmaxf(m_run[rr], m2);
        const float c1 = expf(m_run[rr] - mn), c2 = expf(m2 - mn);
        l_run[rr] = l_run[rr] * c1 + l2 * c2;
#pragma unroll
        for (int e = 0; e < NDW; ++e)
          acc[rr][e] = acc[rr][e] * c1 + w[rr * (D + 2) + lane * NDW + e] * c2;
        m_run[rr] = mn;
      }
    }
    __syncthreads();
  }
  if (warp != 0) return;

  const long long n_all = (long long)B * n_t * Hq;  // rows of the call
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int r = row0 + rr;
    if (r >= n_rows) continue;
    const int t = r / G, h = kvh * G + r % G;
    const long long row = ((long long)b * n_t + t) * Hq + h;
    if (n_split == 1) {
      const float l = fmaxf(l_run[rr], 1e-30f);
      if (lse != nullptr) {
        float* o = static_cast<float*>(out) + row * D + lane * NDW;
#pragma unroll
        for (int e = 0; e < NDW; ++e) o[e] = acc[rr][e] / l;
        if (lane == 0)
          lse[row] = l_run[rr] > 0.f ? m_run[rr] + logf(l_run[rr]) : -INFINITY;
      } else {
        T* o = static_cast<T*>(out) + row * D + lane * NDW;
#pragma unroll
        for (int e = 0; e < NDW; ++e) store_out(o + e, acc[rr][e] / l);
      }
    } else {
      const long long pr = split * n_all + row;
      float* pa = part + pr * D + lane * NDW;
#pragma unroll
      for (int e = 0; e < NDW; ++e) pa[e] = acc[rr][e];
      if (lane == 0) {
        float* ml = part + (long long)n_split * n_all * D;  // [split][row][2]
        ml[2 * pr] = m_run[rr];
        ml[2 * pr + 1] = l_run[rr];
      }
    }
  }
}

// The splits of each row, in split order: out = sum_s acc_s e^(m_s - M) /
// sum_s l_s e^(m_s - M), M = max_s m_s; 0 where no split saw a key (every
// l_s = 0).  With `lse`: out in f32, and lse = M + log sum_s l_s e^(m_s -
// M) (-inf where no split saw a key).  One warp per row, four rows per CTA.
template <typename T, int D>
__global__ void __launch_bounds__(128)
merge_splits(const float* __restrict__ part, void* __restrict__ out,
             float* __restrict__ lse, long long n_all, int n_split) {
  constexpr int NDW = D / 32;
  const long long row = (long long)blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n_all) return;
  const float* ml = part + (long long)n_split * n_all * D;
  float m = kNegInf;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, ml[2 * (s * n_all + row)]);
  float l = 0.f, acc[NDW];
#pragma unroll
  for (int i = 0; i < NDW; ++i) acc[i] = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const long long pr = s * n_all + row;
    const float c = expf(ml[2 * pr] - m);
    l += ml[2 * pr + 1] * c;
#pragma unroll
    for (int i = 0; i < NDW; ++i) acc[i] += part[pr * D + lane + 32 * i] * c;
  }
  if (lse != nullptr && lane == 0)
    lse[row] = l > 0.f ? m + logf(l) : -INFINITY;
  l = fmaxf(l, 1e-30f);
  if (lse != nullptr) {
    float* o = static_cast<float*>(out) + row * D;
#pragma unroll
    for (int i = 0; i < NDW; ++i) o[lane + 32 * i] = acc[i] / l;
    return;
  }
#pragma unroll
  for (int i = 0; i < NDW; ++i)
    store_out(static_cast<T*>(out) + row * D + lane + 32 * i, acc[i] / l);
}

// ===========================================================================
// tensor-core route: bf16 at D = 64 and 128, every T
// ===========================================================================
//
// One CTA per (64 packed rows, b * Hk + KV head, head group): a consumer
// warpgroup (warps 0-3) and a producer warp (warp 4).  The CTA's heads
// are Gt (the largest power of two dividing G, at most 64) adjacent query
// heads of one KV head; row r <-> position p0 + r / Gt, head h0 + r % Gt.

namespace tc {

using namespace hopper;

constexpr int kRows = 64;                // rows of the consumer warpgroup
constexpr int kKeys = 64;                // slots of one K/V tile
constexpr int kBox = kRows * kRowBytes;  // one box: 64 rows x 128 bytes
constexpr int kMaskBox = kKeys * 64;     // K2: (64 slots, <= 64 positions)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// byte offsets in shared memory; two stages at D 128, four at D 64, so
// that two CTAs fit on an SM
template <int D, bool kTree>
struct Layout {
  static constexpr int kChunks = D / kBoxCols;
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr int kStageBytes = kChunks * kBox;
  static constexpr int q = 0;                                   // [chunk]
  static constexpr int k = q + kStageBytes;                     // [stage][chunk]
  static constexpr int v = k + kStages * kStageBytes;           // [stage][chunk]
  static constexpr int mask = v + kStages * kStageBytes;        // [stage]
  static constexpr int kp = mask + (kTree ? kStages * kMaskBox : 0);
  static constexpr int bars = kp + kStages * kKeys * 4;         // q, full, empty
  static constexpr int need = bars + 8 * (1 + 2 * kStages);     // [n64]
  static size_t bytes(int S) {
    const int n64 = (S + kKeys - 1) / kKeys;
    return need + 4 * (2 * n64 + 1);                            // need, list
  }
};

// max (or sum) of the 16 values of accumulator row i (+ 8 i) a thread
// holds, as a tree (fixed trip counts: the values stay in registers)
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

// One tile of the online softmax in the log2 domain, as K3's forward
// runs it: raw scores sc (64 rows x 64 slots) -> P (f32, in x); m is each
// row's running max of score * scale * log2(e), l its running sum, corr
// the factor the accumulator takes for the new max.  With kMask, element
// e (= 4 j + 2 i + c) is a key only if bit e of `vis` is set.  It only
// reads sc, which the P V product in flight does not touch.
template <bool kMask>
__device__ __forceinline__ void online_softmax(
    const float (&sc)[32], float (&x)[32], float (&m)[2], float (&l)[2],
    float (&corr)[2], uint32_t vis, float scale_log2) {
#pragma unroll
  for (int e = 0; e < 32; ++e)
    x[e] = (!kMask || ((vis >> e) & 1u)) ? sc[e] : -INFINITY;
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
  for (int e = 0; e < 32; ++e)
    x[e] = exp2_approx(fmaf(x[e], scale_log2, -mu[(e >> 1) & 1]));
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l[i] = fmaf(l[i], corr[i], reduce_row16<false>(x, i));
}

// S = Q K^T over D (both K-major in shared memory), issued and committed
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[32], const uint8_t* q_s,
                                         const uint8_t* k_s) {
  wgmma_ss_n64_first(sc, desc_k(q_s, 0, kBox), desc_k(k_s, 0, kBox));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss_n64(sc, desc_k(q_s, kk, kBox), desc_k(k_s, kk, kBox));
  wgmma_commit();
}

// O += P V over 64 slots (P from registers, V MN-major), issued and
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

template <int D>
__device__ __forceinline__ void store_row(__nv_bfloat16* dst,
                                          const float (&d)[D / 2], int i,
                                          float mul) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<uint32_t*>(dst + 8 * j) =
        pack_bf16(d[4 * j + 2 * i] * mul, d[4 * j + 2 * i + 1] * mul);
}

// store_row in f32 (the partials' output)
template <int D>
__device__ __forceinline__ void store_row_f32(float* dst,
                                              const float (&d)[D / 2], int i,
                                              float mul) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<float2*>(dst + 8 * j) =
        make_float2(d[4 * j + 2 * i] * mul, d[4 * j + 2 * i + 1] * mul);
}

// the visible elements of a masked tile as bits e = 4 j + 2 i + c: row
// row + 8 i (position qp[i]) against slot 8 j + 2 quad + c of the tile
// (positions kps, -1 for empty slots and slots past S), and for K2 the
// mask bytes of the row's position (mrow[i]: the tile's mask box row)
template <bool kTree>
__device__ __forceinline__ uint32_t visible_bits(const int* kps,
                                                 const uint8_t* const* mrow,
                                                 const int (&qp)[2], int quad,
                                                 int window) {
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 8 * j + 2 * quad + c;
      const int kp = kps[col];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        bool ok = visible(kp, qp[i], window);
        if constexpr (kTree) ok = ok && mrow[i][col] != 0;
        bits |= (ok ? 1u : 0u) << (4 * j + 2 * i + c);
      }
    }
  return bits;
}

template <int D, bool kTree>
__global__ void __launch_bounds__(160, 2)
verify_wgmma(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_mask,
             const int* __restrict__ q_pos, const int* __restrict__ k_pos,
             void* __restrict__ out, float* __restrict__ lse, int n_t, int S,
             int Hq, int Hk, int gshift, long long kpos_b_stride, int window,
             float scale_log2) {
  using L = Layout<D, kTree>;
  constexpr int kChunks = L::kChunks, kStages = L::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_base(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  int* need = reinterpret_cast<int*>(sm + L::need);

  const int Gt = 1 << gshift, P = kRows >> gshift;
  const int b = blockIdx.y / Hk, kvh = blockIdx.y % Hk;
  const int h0 = kvh * (Hq / Hk) + blockIdx.z * Gt;
  const int p0 = blockIdx.x * P;
  const int n64 = (S + kKeys - 1) / kKeys;
  int* list = need + n64;  // [n64 + 1]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* qpb = q_pos + (long long)b * n_t;
  const int* kpb = k_pos + (long long)b * kpos_b_stride;

  // the slot positions of the first pass of the tile scan below (two
  // slots of each tile a lane), loaded before the rows' positions so that
  // both are in flight together
  constexpr int kScan = 8;  // tiles each warp marks per pass
  int kp[2 * kScan];
  auto load_scan = [&](int t0) {
#pragma unroll
    for (int u = 0; u < 2 * kScan; ++u) {
      const int s = (t0 + u / 2) * kKeys + (u % 2) * 32 + lane;
      kp[u] = s < S ? kpb[s] : -1;
    }
  };
  load_scan(warp * kScan);

  // the positions of the CTA's rows: [q_lo, q_hi]
  int q_lo = 0x7fffffff, q_hi = -1;
  for (int i = lane; i < P; i += 32)
    if (p0 + i < n_t) {
      const int qp = qpb[p0 + i];
      q_lo = min(q_lo, qp);
      q_hi = max(q_hi, qp);
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    q_lo = min(q_lo, __shfl_xor_sync(0xffffffffu, q_lo, o));
    q_hi = max(q_hi, __shfl_xor_sync(0xffffffffu, q_hi, o));
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 2);   // the producer's expect_tx and its kp stores
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
    // the Q tile, in flight during the scan
    mbar_arrive_expect_tx(q_full, kChunks * kBox);
    for (int c = 0; c < kChunks; ++c)
      tma_load_4d(sm + L::q + c * kBox, &tm_q, q_full, c * kBoxCols, h0, p0,
                  b);
  }
  // need[t]: 0 no row sees a slot of tile t, 1 masked, 2 unmasked (every
  // slot live, none past the earliest row, all in the window; never K2)
  auto any_of = [&](int kp) {
    return kp >= 0 && kp <= q_hi && (window == 0 || kp > q_lo - window);
  };
  auto all_of = [&](int kp) {
    return kp >= 0 && kp <= q_lo && (window == 0 || kp > q_hi - window);
  };
  for (int t0 = warp * kScan; t0 < n64; t0 += 5 * kScan) {
    if (t0 != warp * kScan) load_scan(t0);
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const unsigned any = __ballot_sync(
          0xffffffffu, any_of(kp[2 * u]) || any_of(kp[2 * u + 1]));
      const unsigned all = __ballot_sync(
          0xffffffffu, all_of(kp[2 * u]) && all_of(kp[2 * u + 1]));
      if (lane == 0 && t0 + u < n64)
        need[t0 + u] = any == 0u ? 0 : (!kTree && all == 0xffffffffu) ? 2 : 1;
    }
  }
  __syncthreads();
  if (warp == 0) list_tiles(need, n64, lane, list);
  __syncthreads();
  const int n_list = list[n64];

  if (warp == 4) {  // producer warp: lane 0 issues the K/V (and mask)
                    // loads, every lane stages two slot positions a tile
    for (int i = 0; i < n_list; ++i) {
      const int s = i % kStages, key0 = (list[i] >> 1) * kKeys;
      const int ka = key0 + lane < S ? kpb[key0 + lane] : -1;
      const int kb = key0 + 32 + lane < S ? kpb[key0 + 32 + lane] : -1;
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * L::kStageBytes +
                                            (kTree ? kKeys * P : 0));
        for (int c = 0; c < kChunks; ++c) {
          tma_load_4d(sm + L::k + s * L::kStageBytes + c * kBox, &tm_k,
                      &full[s], c * kBoxCols, kvh, key0, b);
          tma_load_4d(sm + L::v + s * L::kStageBytes + c * kBox, &tm_v,
                      &full[s], c * kBoxCols, kvh, key0, b);
        }
        if constexpr (kTree)
          tma_load_3d(sm + L::mask + s * kMaskBox, &tm_mask, &full[s], key0,
                      p0, b);
      }
      int* kps = reinterpret_cast<int*>(sm + L::kp) + s * kKeys;
      kps[lane] = ka;
      kps[lane + 32] = kb;
      __threadfence_block();
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
    }
    return;
  }

  // consumer warpgroup: rows row + 8 i of the 64
  const int quad = lane % 4, row = 16 * warp + lane / 4;
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = p0 + ((row + 8 * i) >> gshift);
    qp[i] = pos < n_t ? qpb[pos] : -1;
  }
  const uint8_t* q_s = sm + L::q;
  const uint8_t* k_s = sm + L::k;
  const uint8_t* v_s = sm + L::v;
  const int* kp_s = reinterpret_cast<const int*>(sm + L::kp);

  float o[D / 2], sc[32], pf[32], corr[2];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  // the softmax of list entry i, in stage s: unmasked or masked, once
  auto softmax = [&](int i, int s) {
    if (list[i] & 1) {
      online_softmax<false>(sc, pf, m, l, corr, 0u, scale_log2);
    } else {
      const uint8_t* mrow[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mrow[r] = sm + L::mask + s * kMaskBox + ((row + 8 * r) >> gshift) * kKeys;
      online_softmax<true>(
          sc, pf, m, l, corr,
          visible_bits<kTree>(kp_s + s * kKeys, mrow, qp, quad, window),
          scale_log2);
    }
  };

  mbar_wait(q_full, 0);
  if (n_list > 0) {
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_qk<D>(sc, q_s, k_s);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0, 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(pf, kk, pa[kk]);
  }
  for (int i = 1; i < n_list; ++i) {
    const int s = i % kStages, s_prev = (i - 1) % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    wgmma_fence();
    issue_qk<D>(sc, q_s, k_s + s * L::kStageBytes);
    issue_pv<D>(o, pa, v_s + s_prev * L::kStageBytes);
    wgmma_wait<1>();  // S of tile i; P V of tile i-1 may still run
    fence_regs(sc);
    softmax(i, s);
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s_prev]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        o[4 * j + 2 * r] *= corr[r];
        o[4 * j + 2 * r + 1] *= corr[r];
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(pf, kk, pa[kk]);
  }
  if (n_list > 0) {
    const int s_last = (n_list - 1) % kStages;
    wgmma_fence();
    issue_pv<D>(o, pa, v_s + s_last * L::kStageBytes);
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
    if (pos >= n_t) continue;
    const int h = h0 + (r & (Gt - 1));
    const long long orow = ((long long)b * n_t + pos) * Hq + h;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    if (lse != nullptr) {
      // m is in the log2 domain of the scaled scores
      store_row_f32<D>(static_cast<float*>(out) + orow * D + 2 * quad, o, i,
                       inv);
      if (quad == 0) lse[orow] = lt > 0.f ? m[i] * kLn2 + logf(lt) : -INFINITY;
    } else {
      store_row<D>(static_cast<__nv_bfloat16*>(out) + orow * D + 2 * quad, o,
                   i, inv);
    }
  }
}

}  // namespace tc

// ===========================================================================
// host: routes, tensor maps, launches
// ===========================================================================

// Everything a launch needs besides the element type and head dim.
struct Args {
  const void *q, *k, *v, *q_pos, *k_pos;
  const unsigned char* tree_mask;  // null for K1
  void* out;    // q's dtype, or f32 when lse is given
  float* lse;   // (B, T, Hq) f32 log-sum-exp, or null
  float* part;  // the split workspace (null when n_split == 1)
  int B, n_t, S, Hq, Hk;
  long long kv_b_stride, kpos_b_stride, tm_b_stride, tm_t_stride;
  int window;
  float scale;
  cudaStream_t stream;
};

// The route of each shape, (dtype, D) and nothing else, at every T:
//   bf16, D 64 / 128 -> the tensor cores;
//   f32 (every D; on the tensor cores it would be TF32, outside the f32
//   tolerance of 2e-5) and bf16 at D 32 / 256 -> the CUDA cores, the
//   cache in shares of kSplitKeys slots.
enum Route { kNoRoute = 0, kCudaCores = 1, kTensorCores = 2 };

bool head_dim_ok(int D) { return D == 32 || D == 64 || D == 128 || D == 256; }

bool tc_eligible(int dtype, int D) {
  return dtype == 1 && (D == 64 || D == 128);
}

Route route_of(int dtype, int D, int n_t, int Hq, int Hk) {
  if (!head_dim_ok(D) || Hk <= 0 || Hq % Hk || (dtype != 0 && dtype != 1))
    return kNoRoute;
  if (tc_eligible(dtype, D)) return kTensorCores;
  return kCudaCores;
}

// `want` 0: the table's route; 1 / 2: that route, where the shape can
// take it (the chip check runs both routes of a shape)
Route resolve_route(int dtype, int D, int n_t, int Hq, int Hk, int want) {
  const Route r = route_of(dtype, D, n_t, Hq, Hk);
  if (r == kNoRoute || want == 0) return r;
  if (want == kCudaCores) return kCudaCores;
  if (want == kTensorCores && tc_eligible(dtype, D)) return kTensorCores;
  return kNoRoute;
}

// splits of the CUDA-core route: a function of the cache's length only
int splits_of(int S) {
  const int n = (S + kSplitKeys - 1) / kSplitKeys;
  return n < 1 ? 1 : n < kMaxSplits ? n : kMaxSplits;
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D, bool kTree, int R>
cudaError_t launch_cores(const Args& a, int n_split) {
  const size_t smem = cores_smem<R, D>(a.S);
  auto kern = verify_cores<T, D, kTree, R>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int rows = a.n_t * (a.Hq / a.Hk);
  dim3 grid((rows + R - 1) / R, a.B * a.Hk, n_split);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.q_pos),
      static_cast<const int*>(a.k_pos), a.tree_mask, a.out, a.lse,
      a.part, a.n_t, a.S, a.Hq, a.Hk, a.kv_b_stride, a.kpos_b_stride,
      a.tm_b_stride, a.tm_t_stride, a.window, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const long long n_all = (long long)a.B * a.n_t * a.Hq;
  merge_splits<T, D><<<(unsigned)((n_all + 3) / 4), 128, 0, a.stream>>>(
      a.part, a.out, a.lse, n_all, n_split);
  return cudaGetLastError();
}

template <typename T, int D, bool kTree>
cudaError_t launch_cores_r(const Args& a, int n_split) {
  return rows_per_cta(a.n_t * (a.Hq / a.Hk)) == 4
             ? launch_cores<T, D, kTree, 4>(a, n_split)
             : launch_cores<T, D, kTree, 8>(a, n_split);
}

template <typename T, bool kTree>
cudaError_t launch_cores_d(int D, const Args& a, int n_split) {
  switch (D) {
    case 32: return launch_cores_r<T, 32, kTree>(a, n_split);
    case 64: return launch_cores_r<T, 64, kTree>(a, n_split);
    case 128: return launch_cores_r<T, 128, kTree>(a, n_split);
    default: return launch_cores_r<T, 256, kTree>(a, n_split);
  }
}

template <int D, bool kTree>
cudaError_t launch_tc(const Args& a) {
  using namespace tc;
  using L = Layout<D, kTree>;
  const int G = a.Hq / a.Hk;
  int gshift = 0;  // Gt = 2^gshift: the largest power of two dividing G, <= 64
  while (gshift < 6 && (G >> gshift) % 2 == 0) ++gshift;
  const int Gt = 1 << gshift, P = kRows / Gt;
  // Q: boxes of (64 columns, Gt heads, P positions); K and V: (64 columns,
  // 1 head, 64 slots) of the cache view with its own batch stride; K2's
  // mask: (64 slots, P positions) bytes
  CUtensorMap tq, tk, tv, tm;
  bool ok =
      hopper::encode_bf16_4d(&tq, a.q, D, a.Hq, a.n_t, a.B, kBoxCols, Gt, P,
                             1) &&
      hopper::encode_bf16_4d(&tk, a.k, D, a.Hk, a.S, a.B, kBoxCols, 1, kKeys,
                             1, (uint64_t)a.kv_b_stride * 2) &&
      hopper::encode_bf16_4d(&tv, a.v, D, a.Hk, a.S, a.B, kBoxCols, 1, kKeys,
                             1, (uint64_t)a.kv_b_stride * 2);
  if (kTree) {
    const cuuint64_t dims[3] = {(cuuint64_t)a.S, (cuuint64_t)a.n_t,
                                (cuuint64_t)a.B};
    const cuuint64_t strides[2] = {(cuuint64_t)a.tm_t_stride,
                                   (cuuint64_t)a.tm_b_stride};
    const cuuint32_t box[3] = {kKeys, (cuuint32_t)P, 1};
    ok = ok && hopper::encode_tiled(&tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                                    a.tree_mask, dims, strides, box,
                                    CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    tm = tq;  // unused by K1
  }
  if (!ok) return cudaErrorInvalidValue;
  const size_t smem = L::bytes(a.S);
  auto kern = verify_wgmma<D, kTree>;
  const cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_t + P - 1) / P, a.B * a.Hk, G / Gt);
  kern<<<grid, 160, smem, a.stream>>>(
      tq, tk, tv, tm, static_cast<const int*>(a.q_pos),
      static_cast<const int*>(a.k_pos), a.out, a.lse, a.n_t, a.S, a.Hq,
      a.Hk, gshift, a.kpos_b_stride, a.window, a.scale * kLog2e);
  return cudaGetLastError();
}

template <bool kTree>
int launch_any(int dtype, int D, int want, int want_split, const Args& a) {
  if (a.B == 0 || a.n_t == 0) return cudaSuccess;
  switch (resolve_route(dtype, D, a.n_t, a.Hq, a.Hk, want)) {
    case kTensorCores:
      if (want_split > 1) return cudaErrorInvalidValue;
      return D == 64 ? launch_tc<64, kTree>(a) : launch_tc<128, kTree>(a);
    case kCudaCores: {
      const int n_split = want_split > 0
                              ? want_split
                              : splits_of(a.S);
      if (n_split > kMaxSplits) return cudaErrorInvalidValue;
      if (n_split > 1 && a.part == nullptr) return cudaErrorInvalidValue;
      return dtype == 0 ? launch_cores_d<float, kTree>(D, a, n_split)
                        : launch_cores_d<__nv_bfloat16, kTree>(D, a, n_split);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `route`: 0 the table's, 1 the CUDA
// cores, 2 the tensor cores.  `n_split`: 0 the table's shares of the
// cache on the CUDA cores, else that many (1..kMaxSplits; 1 on the tensor
// cores): a rank's shard of a layer's heads asks for the unsharded
// layer's n_split, since a head's shares depend only on its row tile, the
// cache and n_split.

// the route of a shape: 0 none, 1 the CUDA cores, 2 the tensor cores
extern "C" int spec_verify_route(int dtype, int D, int T, int Hq, int Hk,
                                 int route) {
  return resolve_route(dtype, D, T, Hq, Hk, route);
}

// n_split of a shape on its route (1 on the tensor cores); the caller
// passes a workspace of n_split * B*T*Hq * (D + 2) floats when it is > 1
extern "C" int spec_verify_splits(int dtype, int D, int B, int T, int Hq,
                                  int Hk, int S, int route) {
  if (resolve_route(dtype, D, T, Hq, Hk, route) != kCudaCores) return 1;
  return splits_of(S);
}

// q/out contiguous (B,T,Hq,D); k/v (B,S,Hk,D) with contiguous (S,Hk,D)
// rows, batch stride kv_b_stride and 16-byte aligned rows; q_pos
// contiguous (B,T) int32; k_pos (B,S) int32 with batch stride
// kpos_b_stride.  `lse`: null, or a contiguous (B,T,Hq) f32 buffer for the
// rows' log-sum-exp, and then out is f32.  Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int spec_verify_launch(int dtype, const void* q, const void* k,
                                  const void* v, const void* q_pos,
                                  const void* k_pos, void* out, void* lse,
                                  void* part, int B, int n_t, int S, int Hq,
                                  int Hk, int D, long long kv_b_stride,
                                  long long kpos_b_stride, int window,
                                  float scale, int route, int n_split,
                                  void* stream) {
  const Args a{q, k, v, q_pos, k_pos, nullptr, out, static_cast<float*>(lse),
               static_cast<float*>(part), B, n_t, S, Hq, Hk, kv_b_stride,
               kpos_b_stride, 0, 0, window, scale,
               static_cast<cudaStream_t>(stream)};
  return launch_any<false>(dtype, D, route, n_split, a);
}

// K2: spec_verify_launch's arguments plus tree_mask, (B,T,S) bytes (0 =
// hidden) with contiguous rows, batch stride tm_b_stride and row stride
// tm_t_stride.
extern "C" int tree_verify_launch(int dtype, const void* q, const void* k,
                                  const void* v, const void* q_pos,
                                  const void* k_pos, const void* tree_mask,
                                  void* out, void* lse, void* part, int B,
                                  int n_t, int S, int Hq, int Hk, int D,
                                  long long kv_b_stride,
                                  long long kpos_b_stride,
                                  long long tm_b_stride,
                                  long long tm_t_stride, int window,
                                  float scale, int route, int n_split,
                                  void* stream) {
  const Args a{q, k, v, q_pos, k_pos,
               static_cast<const unsigned char*>(tree_mask), out,
               static_cast<float*>(lse), static_cast<float*>(part), B, n_t,
               S, Hq, Hk, kv_b_stride,
               kpos_b_stride, tm_b_stride, tm_t_stride, window, scale,
               static_cast<cudaStream_t>(stream)};
  return launch_any<true>(dtype, D, route, n_split, a);
}

extern "C" const char* spec_verify_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
