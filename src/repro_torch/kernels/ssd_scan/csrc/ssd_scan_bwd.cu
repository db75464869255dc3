// Backward of the SSD chunk scan (K4) for Hopper, written by hand in CUDA
// C++: two routes, chosen by a table of the shape.
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
//   ddt_j = sum_i G_ij + e2_j u_j + da_j A               u_j = B_j . (x_j^T dS)
//   dcs_i = sum_j dt_j G_ij - dt_i sum_k G_ki + exp(cs_i) v_i - e2_i dt_i u_i
//           [+ exp(cs_Q) <dS, S> + sum_j e2_j dt_j u_j at the chunk's last
//           step]                                        v_i = C_i . (dy_i^T S)
//   da_k = sum_{i>=k} dcs_i,   dA = sum over (b, T) of da_k dt_k
//
// (ref.ssd_bwd_ref is the same computation in PyTorch, the kernel's
// oracle; ref.ssd_bwd_split_ref follows this file's decomposition.)  Every
// sum is f32; dx has x's dtype, every other gradient is f32.
//
// What bounds it on this card.  The trainers call it once per Mamba2 block
// at 16 rows of 448 tokens (a chunk of 256 and a ragged one of 192;
// mamba2-370m: nh 32, P 64, N 128; zamba2-1.2b: nh 64, P 64, N 64; one
// group).  The bytes (the inputs once, the gradients once) are a few MB;
// the products over a chunk's causal pairs, C.B once per group and dy.x,
// W.dy per head, are a few GFLOP: operations bound it, and bf16 operands
// put those products on the tensor cores.  What keeps a kernel from that
// bound: work the group's heads could share, the square's empty half, and
// Q x Q matrices moved through device memory.  The design:
//
//   * Group-level products.  B and C are per group, so C B^T is formed
//     once per tile of a (batch row, chunk, group), and M is summed over
//     the group's heads in head order before its two products with B and
//     C (dB_j = sum_i M_g,ij C_i, dC_i = sum_j M_g,ij B_j).
//   * Causal, in-range tiles only.  A chunk's steps are cut into blocks of
//     64; only tiles (I, J) with J <= I whose rows hold steps before T run
//     (10 tiles of a chunk of 256, 6 of the ragged one of 192).
//   * No Q x Q matrix in device memory.  W, M and G live in registers and
//     shared memory; what leaves a CTA is per tile and per row: G's row
//     and column sums, and Mg's products with B and C (64 x N).
//
// Seven launches on the caller's stream:
//   prep:    cs and dt of each (batch row, chunk, head), once;
//   states:  one CTA per (head, batch row, 64 rows of the state) walks the
//            chunks forward (S_c), then back (dS_c, dS0), the state block
//            in registers, each chunk's weighted x (dy) rows against B (C)
//            on the products below; the states are stored in the route's
//            staged form, ready for cp.async;
//   tiles:   one CTA per (tile, group, batch row): C B^T once, then for
//            each head in order dy x^T, M (summed into Mg in registers)
//            and G's row and column sums; then Mg B_J and Mg^T C_I;
//   rows:    one CTA per (block, group and slice of heads, batch row,
//            pass): the boundary terms summed over the slice's heads in
//            order, exp(cs_i) dy_i^T S for dC and e2_j dt_j x_j^T dS for
//            dB, with v and u on the way;
//   cols:    one CTA per (block J, group and slice of heads, batch row): C
//            B^T of the block's column tiles once (in shared memory), then
//            for each head dx_J = sum_I W^T(J, I) dy_I + e2 dt (dS B_J),
//            8 warps (two column halves);
//   finish:  one CTA per (batch row, chunk, head): dcs from the sums, da's
//            suffix sum, ddt and the head's dA share;
//   reduce:  dB and dC from the tiles' and rows' parts (the slices in
//            order), dA over (batch row, chunk), each in a fixed order.
// The (batch row, chunk, group) grid holds only 32 CTAs at the trainers'
// shape, so the work is cut finer: tiles by causal tile, rows and cols by
// block and by slice of heads (ops.heads_per_cta: the group's heads,
// halved while the grid would not fill the card twice over; at the
// trainers' shape 4 slices, of 8 heads (mamba2) or 16 (zamba2), each cols
// CTA recomputing its column tiles of C B^T).  M's sum over heads is not
// cut: one tiles CTA sums a tile's M over every head of its group.  E_ij =
// exp(cs_i - cs_j) is formed as f_i g_j against a step between j and i (the
// note on E): 18 exponentials a lane and tile instead of 32, and on a
// diagonal tile 8 more for the elements beside the diagonal.
// Every product runs through one routine (gemm: each warp a 16-row strip
// of a 64-row output), whose two bodies are the routes:
//
//   Tensor cores (bf16): mma.sync m16n8k16 with f32 accumulation.  x, dy,
//   B and C enter exactly as bf16; the f32 operands (W^T, Mg, S, dS) as
//   hi/lo bf16 pairs (v = hi + lo, two products each), as K4's forward
//   does.  Operand rows are staged in shared memory by 16-byte cp.async
//   (the next head's while this one computes) and every fragment is
//   formed with ldmatrix (.trans where the product wants the transpose).
//   mma.sync rather than wgmma: the strips are 16 rows and the widths 64.
//   CUDA cores (f32, and bf16 when forced): the same kernels, the same
//   element ownership, each product an f32 FMA loop over shared memory.
//
// Determinism: no atomics.  Each output is summed by one thread, a fixed
// butterfly, or a fixed loop over per-CTA parts in the finish and reduce
// kernels, so repeated calls are bitwise equal.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   -shared -Xcompiler -fPIC; bound to PyTorch through a plain C
//   interface (ctypes), see ops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;   // finish, reduce
constexpr int kMaxQ = 256;
constexpr int kTh = 128;        // the chunk kernels: 4 warps
constexpr int kColsTh = 256;    // ... but cols: 8
constexpr int kBlk = 64;        // a block of a chunk's steps, a tile's side
constexpr int kLdT = kBlk + 8;  // row stride of a staged 64-wide tile
constexpr int kMaxW = 128;      // the most P or N
constexpr int kWide = kMaxW / 8;   // n-tiles of the widest accumulator
constexpr int kNarrow = kBlk / 8;  // n-tiles of a tile's accumulator
constexpr int kHalf = kNarrow / 2;  // ... of half a tile's
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use

// route codes (as K4's forward names them)
constexpr int kTensorCores = 2, kCudaCores = 3;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

struct Args {
  const void *x, *B, *C, *dy;   // x's dtype
  const float *dt, *A;
  const float *init, *dstate;   // null: zero initial state / state grad
  void* dx;                     // (b,T,nh,P) contiguous, x's dtype
  float *ddt;                   // (b,T,nh)
  float *dA;                    // (nh,)
  float *dB, *dC;               // (b,T,G,N)
  float *dinit;                 // (b,nh,P,N) or null
  // scratch (the wrapper's), every per-chunk vector padded to Qs steps
  float *S, *dS;                // (b,nc,nh,P,N): S_c, dS_c, staged
  bool tc;                      // staged as hi / lo bf16 (else f32)
  float *cs, *dtc;              // (b,nc,nh,Qs): cumsum of dt A, dt
  float *rs, *cl;               // (b,nc,nh,ntq,64): G's row / col sums
  float *dBp, *dCp;             // (b,nc,G,ntq,64,N): Mg^T C_I, Mg B_J
  float *bnd;                   // (b,nc,G,nbq,2,64,N): boundary terms
  float *uv;                    // (b,nc,nh,2,Qs): v, u
  float *dA_part;               // (b,nc,nh)
  int b, T, nh, P, G, N, Q, nc;
  int nbq, ntq, Qs, hs;         // blocks and tiles of a chunk, Qs = 64 nbq,
                                // heads of a cols CTA
  long long x_sb, x_st, x_sh;   // element strides (last dim contiguous)
  long long dy_sb, dy_st, dy_sh;
  long long dt_sb, dt_st;
  long long b_sb, b_st, b_sg;
  long long c_sb, c_st, c_sg;
};

__device__ __forceinline__ int rows_of(const Args& a, int c) {
  return min(a.Q, a.T - c * a.Q);   // steps of chunk c before T
}
// per (batch row, chunk, head) and per (batch row, chunk, group)
__device__ __forceinline__ size_t bch(const Args& a, int bi, int c, int h) {
  return (size_t(bi) * a.nc + c) * a.nh + h;
}
__device__ __forceinline__ size_t bcg(const Args& a, int bi, int c, int g) {
  return (size_t(bi) * a.nc + c) * a.G + g;
}
__device__ __forceinline__ int tile_of(int I, int J) {
  return I * (I + 1) / 2 + J;
}
__device__ __forceinline__ size_t state_at(const Args& a, int bi, int c,
                                           int h) {
  return bch(a, bi, c, h) * size_t(a.P) * a.N;
}

// ---------------------------------------------------------------------------
// 0. prep: cs (inclusive cumsum of dt A) and dt of each (chunk, head, batch
// row) over Qs steps, 0 past T (so cs stays at the chunk's last value):
// one warp scans 32 steps at a time.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(32) ssd_bwd_prep(Args a) {
  const int c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int lane = threadIdx.x, t0 = c * a.Q, nr = rows_of(a, c);
  const float Ah = a.A[h];
  float* cs = a.cs + bch(a, bi, c, h) * a.Qs;
  float* dts = a.dtc + bch(a, bi, c, h) * a.Qs;
  float carry = 0.f;
  for (int base = 0; base < a.Qs; base += 32) {
    const int i = base + lane;
    const float d = i < nr
        ? a.dt[bi * a.dt_sb + (long long)(t0 + i) * a.dt_st + h] : 0.f;
    float v = d * Ah;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += n;
    }
    v += carry;
    cs[i] = v;
    dts[i] = d;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// ===========================================================================
// the chunk kernels' products: 4 warps, warp w a full-width strip of rows
// 16 w .. 16 w + 15 of a 64-row output; lane (g, t) = (lane / 4, lane % 4)
// owns rows 16 w + g and + 8 and, of each 8-column n-tile nt, columns
// 8 nt + 2 t and + 1: element e of acc[nt] is row + 8 (e / 2), column
// + (e % 2) (mma.sync's accumulator layout; the CUDA-core route keeps it)
// ===========================================================================

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (not volatile: it touches registers only, so the compiler may schedule
// it among the fragment loads)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
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

// v = hi + lo in bf16, two values of adjacent columns packed per register
// (one paired conversion each)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <class T>
struct Id { using type = T; };

// acc (the warp's strip, nts <= NT n-tiles) += A B over K.  A is the
// 64-row operand: [m][k] at `a` with row stride lda, or with AT its
// transpose stored [k][m]; B is [k][n], or with BNK stored [n][k].  On the
// tensor cores (TC) every operand is bf16 and `alo` / `blo`, where not
// null, are the lo halves of an f32 operand (hi + lo: two products); K is
// a multiple of 16, nts even.  The lane's ldmatrix row address, with
// r8 = lane % 8 and mi = lane / 8:
//   A [m][k]:   row m0 + r8 + 8 (mi & 1), column k0 + 8 (mi >> 1)   ldsm
//   A [k][m]:   row k0 + r8 + 8 (mi >> 1), column m0 + 8 (mi & 1)   ldsm_t
//   B [n][k]:   row n0 + r8 + 8 (mi >> 1), column k0 + 8 (mi & 1)   ldsm
//   B [k][n]:   row k0 + r8 + 8 (mi & 1), column n0 + 8 (mi >> 1)   ldsm_t
// (B: two n-tiles n0 .. n0 + 15 at a time).  On the CUDA cores the same
// elements are summed by FMAs in k's order.
template <bool TC, int NT, bool AT, bool BNK, typename SA, typename SB>
__device__ __forceinline__ void gemm(float (&acc)[NT][4], int nts,
                                     const SA* a,
                                     typename Id<const SA*>::type alo,
                                     int lda, const SB* b,
                                     typename Id<const SB*>::type blo,
                                     int ldb, int K) {
  const int lane = threadIdx.x & 31, m0 = 16 * ((threadIdx.x >> 5) & 3);
  if constexpr (TC) {
    static_assert(std::is_same<SA, bf16>::value &&
                  std::is_same<SB, bf16>::value, "bf16 operands");
    const int r8 = lane & 7, mlo = (lane >> 3) & 1, mhi = lane >> 4;
    const int ao = AT ? (r8 + 8 * mhi) * lda + m0 + 8 * mlo
                      : (m0 + r8 + 8 * mlo) * lda + 8 * mhi;
    const int ak = AT ? 16 * lda : 16;
    const int bo = BNK ? (r8 + 8 * mhi) * ldb + 8 * mlo
                       : (r8 + 8 * mlo) * ldb + 8 * mhi;
    const int bk = BNK ? 16 : 16 * ldb;
    const int bn = BNK ? 16 * ldb : 16;
    // per k-step, the fragments of up to 8 n-tiles are all loaded before
    // their products, so one load latency is paid per group, not per pair
#pragma unroll 1
    for (int k = 0; k < K / 16; ++k) {
      uint32_t af[4], al[4];
      if (AT) ldsm_t(af, a + ao + k * ak); else ldsm(af, a + ao + k * ak);
      if (alo) {
        if (AT) ldsm_t(al, alo + ao + k * ak);
        else ldsm(al, alo + ao + k * ak);
      }
#pragma unroll
      for (int q0 = 0; q0 < NT; q0 += 8) {
        if (q0 >= nts) break;
        uint32_t bf[4][4], bl[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (q0 + 2 * u >= nts || q0 + 2 * u >= NT) break;
          const int o = bo + k * bk + (q0 / 2 + u) * bn;
          if (BNK) ldsm(bf[u], b + o); else ldsm_t(bf[u], b + o);
          if (blo) {
            if (BNK) ldsm(bl[u], blo + o); else ldsm_t(bl[u], blo + o);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = q0 + 2 * u;
          if (q >= nts || q >= NT) break;
          mma(acc[q], af, bf[u][0], bf[u][1]);
          mma(acc[q + 1], af, bf[u][2], bf[u][3]);
          if (alo) {
            mma(acc[q], al, bf[u][0], bf[u][1]);
            mma(acc[q + 1], al, bf[u][2], bf[u][3]);
          }
          if (blo) {
            mma(acc[q], af, bl[u][0], bl[u][1]);
            mma(acc[q + 1], af, bl[u][2], bl[u][3]);
          }
        }
      }
    }
  } else {
    const int ra = m0 + (lane >> 2), rb = ra + 8, c0 = 2 * (lane & 3);
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      const float a0 = to_f32(AT ? a[k * lda + ra] : a[ra * lda + k]);
      const float a1 = to_f32(AT ? a[k * lda + rb] : a[rb * lda + k]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= nts) break;
        const int c = 8 * nt + c0;
        const float b0 = to_f32(BNK ? b[c * ldb + k] : b[k * ldb + c]);
        const float b1 =
            to_f32(BNK ? b[(c + 1) * ldb + k] : b[k * ldb + c + 1]);
        acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
        acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
        acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
        acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// bytes of a staged rows x ld f32 operand
__host__ __device__ constexpr size_t staged_bytes(int rows, int ld) {
  return size_t(rows) * ld * 4;   // hi + lo bf16, or f32
}
__host__ __device__ constexpr size_t al16(size_t v) {
  return (v + 15) & ~size_t(15);
}

// `rows` rows of W elements (W a multiple of 16) from `src` (row stride
// `st`) into `dst` (row stride ld, 16-byte aligned rows): rows below nr by
// cp.async, 16 bytes at a time, when the source allows it (else
// synchronously), the rest zero.
template <typename E>
__device__ __forceinline__ void load_rows(E* dst, int ld, const E* src,
                                          long long st, int nr, int W,
                                          int rows = kBlk) {
  constexpr int V = 16 / sizeof(E);
  const int cpr = W / V, sh = __ffs(cpr) - 1;
  const bool pow2 = (cpr & (cpr - 1)) == 0;
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     (uintptr_t)(st * (long long)sizeof(E))) & 15) == 0;
  for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
    const int r = pow2 ? e >> sh : e / cpr, c = (e - r * cpr) * V;
    E* d = dst + r * ld + c;
    if (r >= nr) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    } else if (vec) {
      cp_async16(d, src + r * st + c);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) d[k] = src[r * st + c + k];
    }
  }
}

// the staged form of an f32 operand: hi / lo bf16 arrays (tensor cores) or
// one f32 array; in shared memory, or in device memory (the chunk states)
template <bool TC>
struct Staged {
  using E = typename std::conditional<TC, bf16, float>::type;
  E *hi, *lo;
  // lo `elems` elements past hi
  __device__ Staged(void* p, size_t elems)
      : hi(static_cast<E*>(p)),
        lo(TC ? static_cast<E*>(p) + elems : nullptr) {}
  __device__ Staged(E* h, E* l) : hi(h), lo(l) {}
  __device__ Staged offset(size_t o) const {
    return Staged(hi + o, TC ? lo + o : nullptr);
  }
  // two values of adjacent columns c, c + 1 of row r
  __device__ __forceinline__ void put2(int ld, int r, int c, float v0,
                                       float v1) const {
    if constexpr (TC) {
      uint32_t h, l;
      split2(v0, v1, h, l);
      *reinterpret_cast<uint32_t*>(hi + r * ld + c) = h;
      *reinterpret_cast<uint32_t*>(lo + r * ld + c) = l;
    } else {
      *reinterpret_cast<float2*>(hi + r * ld + c) = make_float2(v0, v1);
    }
  }
  // a strip accumulator, as the owner's elements, rows below `rows`
  template <int NT>
  __device__ __forceinline__ void put(int ld, const float (&acc)[NT][4],
                                      int nts, int rows = kBlk) const {
    const int lane = threadIdx.x & 31;
    const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= nts) break;
      if (r < rows) put2(ld, r, 8 * nt + c0, acc[nt][0], acc[nt][1]);
      if (r + 8 < rows) put2(ld, r + 8, 8 * nt + c0, acc[nt][2], acc[nt][3]);
    }
  }
  // `rows` rows of W elements (rows of stride ld) into `dst` (rows of stride
  // dld), 16 bytes at a time: shared memory to device memory, coalesced
  __device__ __forceinline__ void copy_rows(const Staged& dst, int dld,
                                            int ld, int rows, int W) const {
    constexpr int V = 16 / sizeof(E);
    const int cpr = W / V;
    for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
      const int r = e / cpr, c = (e - r * cpr) * V;
      *reinterpret_cast<uint4*>(dst.hi + r * dld + c) =
          *reinterpret_cast<const uint4*>(hi + r * ld + c);
      if constexpr (TC)
        *reinterpret_cast<uint4*>(dst.lo + r * dld + c) =
            *reinterpret_cast<const uint4*>(lo + r * ld + c);
    }
  }
  // a staged P x N state in device memory (row-major) into rows of stride
  // ld, by cp.async
  __device__ __forceinline__ void load_state(int ld, const Staged& src, int P,
                                             int N) const {
    load_rows(hi, ld, src.hi, N, P, N, P);
    if constexpr (TC) load_rows(lo, ld, src.lo, N, P, N, P);
  }
};

// the staged chunk state (S or dS) of (batch row, chunk, head): each of
// the two scratch regions holds the states' hi halves, then their lo
// halves (tensor cores), or the f32 states
template <bool TC>
__device__ __forceinline__ Staged<TC> state_of(const Args& a, float* base,
                                               int bi, int c, int h) {
  return Staged<TC>(base, size_t(a.b) * a.nc * a.nh * a.P * a.N)
      .offset(state_at(a, bi, c, h));
}

// n floats (a multiple of 4, 16-byte aligned) by cp.async
__device__ __forceinline__ void load_vec(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n / 4; e += blockDim.x)
    cp_async16(dst + 4 * e, src + 4 * e);
}

// store a strip accumulator to a row-major f32 [64][W] block, rows below
// `rows`
template <int NT>
__device__ __forceinline__ void store_acc(float* dst, int W,
                                          const float (&acc)[NT][4],
                                          int nts, int rows = kBlk) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= nts) break;
    if (r < rows)
      *reinterpret_cast<float2*>(dst + r * W + 8 * nt + c0) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (r + 8 < rows)
      *reinterpret_cast<float2*>(dst + (r + 8) * W + 8 * nt + c0) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

// E_ij = exp(cs_i - cs_j), j <= i.  cs does not increase (dt >= 0, A <= 0:
// Mamba2's A is -exp(A_log)), so for any step r with j <= r <= i, E = f_i
// g_j with f_i = exp(cs_i - cs_r) and g_j = exp(cs_r - cs_j), both <= 1:
// neither overflows, and where one underflows so does E.  A lane takes
// one r for its warp's 16-row strip (on a 64 x 64 tile: rows i from step
// ib, or in cols' transposed tile rows j up to step jb): every 8-column
// n-tile wholly on the far side of r is split (f once per row, g once per
// column, not one exponential per element); the n-tiles that meet the
// strip on a diagonal tile take exp(cs_i - cs_j) directly under the mask;
// those past it are 0.  (A reference outside [j, i], such as a diagonal
// tile's first step, gives g_j >= 1, which overflows once the decay
// within the block passes ~88.)  Every tile forms the factors; a
// diagonal tile runs an element body of its own that replaces them
// where they do not hold, so that off-diagonal tiles pay nothing for it
// (one body choosing per element cost 9-15%).

// ---------------------------------------------------------------------------
// shared memory of each chunk kernel (bytes; every region 16-byte aligned).
// es: bytes of an input element (x's dtype)
// ---------------------------------------------------------------------------

struct StatesLayout {   // B or C rows; x or dy rows; the weighted rows
  size_t raw, x, wt, end;          // staged; the weights; the state block
  __host__ __device__ StatesLayout(int N, int es) {   // staged over them
    raw = al16(size_t(kBlk) * (N + 8) * es);
    x = raw + al16(size_t(kBlk) * kLdT * es);
    wt = x + staged_bytes(kBlk, kLdT);
    end = wt + kBlk * 4;
    if (end < staged_bytes(kBlk, N + 8)) end = staged_bytes(kBlk, N + 8);
  }
};

constexpr int kTileStages = 3;   // heads in flight in the tiles kernel

struct TilesLayout {   // C_I, B_J; kTileStages stages of (dy_I, x_J, cs_I,
  size_t B, reg, stage, dyx, red, end;   // cs_J, dt_J); Mg over the stages
  __host__ __device__ TilesLayout(int P, int N, int es) {
    const size_t rowsN = al16(size_t(kBlk) * (N + 8) * es);
    B = rowsN;
    reg = 2 * rowsN;
    dyx = al16(size_t(kBlk) * (P + 8) * es);
    stage = 2 * dyx + 3 * kBlk * 4;
    const size_t mg = staged_bytes(kBlk, kLdT);
    red = reg + (kTileStages * stage > mg ? kTileStages * stage : mg);
    end = red + 4 * kBlk * 4;
  }
};

struct RowsLayout {    // the group's rows; two stages of (head rows, state,
  size_t reg, stage, st, cs, end;        // cs, dt)
  __host__ __device__ RowsLayout(int P, int N, int es) {
    reg = al16(size_t(kBlk) * (N + 8) * es);
    st = al16(size_t(kBlk) * (P + 8) * es);
    cs = st + al16(staged_bytes(P, N + 8));
    stage = cs + 2 * kBlk * 4;
    end = reg + 2 * stage;
  }
};

struct ColsLayout {    // C B^T of the block's tiles; B_J; C_I (first) or
  size_t B, r1, ds, dy, dyb, w, csb, end;   // dS by head parity; two
  __host__ __device__ ColsLayout(int P, int N, int es, int nbq, int Qs) {
    B = size_t(nbq) * kBlk * kBlk * 4;      // stages of dy_I; W^T; cs, dt
    const size_t rowsN = al16(size_t(kBlk) * (N + 8) * es);
    r1 = B + rowsN;
    ds = al16(staged_bytes(P, N + 8));
    dy = r1 + (2 * rowsN > 2 * ds ? 2 * rowsN : 2 * ds);
    dyb = al16(size_t(kBlk) * (P + 8) * es);
    w = dy + 2 * dyb;
    csb = w + staged_bytes(kBlk, kLdT);
    end = csb + 2 * 2 * size_t(Qs) * 4;
  }
};

// ---------------------------------------------------------------------------
// 1-2. states: one CTA per (head, batch row, block of 64 state rows) walks
// the chunks forward (S_{c+1} = exp(cs_Q) S_c + (w x)^T B, w_j = dt_j
// exp(cs_Q - cs_j), every chunk but the last) or, with REV, back (dS_{c-1}
// = exp(cs_Q) dS_c + (w dy)^T C, w_i = exp(cs_i), down to chunk 1, or to
// chunk 0 for dinit), the block of the state in the warps' registers.  The
// weighted rows are the product's f32 operand, B and C its exact one; the
// chunk's steps go in blocks of 64.
// ---------------------------------------------------------------------------
template <typename TT, bool TC, bool REV>
__global__ void __launch_bounds__(kTh) ssd_bwd_states(Args a) {
  const int h = blockIdx.x, bi = blockIdx.y, p0 = blockIdx.z * kBlk;
  const int P = a.P, N = a.N, ldN = N + 8, np = min(kBlk, P - p0);
  const StatesLayout L(N, sizeof(TT));
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* const smem = smem_raw;
  const Staged<TC> sX(smem + L.x, size_t(kBlk) * kLdT);
  float* wt = reinterpret_cast<float*>(smem + L.wt);
  const int tid = threadIdx.x, lane = tid & 31, grp = h / (a.nh / a.G);
  const int r0 = 16 * (tid >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
  const size_t PN = size_t(P) * N, own = (size_t(bi) * a.nh + h) * PN;
  const float* first = REV ? a.dstate : a.init;
  float acc[kWide][4];
#pragma unroll
  for (int nt = 0; nt < kWide; ++nt) {
    if (nt >= N / 8) break;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = r0 + 8 * q;
      const float2 v = first && r < np
          ? *reinterpret_cast<const float2*>(first + own + (p0 + r) * N +
                                             8 * nt + c0)
          : make_float2(0.f, 0.f);
      acc[nt][2 * q] = v.x;
      acc[nt][2 * q + 1] = v.y;
    }
  }
  // a state block to device memory in the staged form, through shared
  // memory so that the rows leave in 16-byte vectors
  float* region = REV ? a.dS : a.S;
  auto store_state = [&](int slot) {
    const Staged<TC> so(smem, size_t(kBlk) * ldN);
    so.put(ldN, acc, N / 8, np);
    __syncthreads();
    so.copy_rows(state_of<TC>(a, region, bi, slot, h).offset(size_t(p0) * N),
                 N, ldN, np, N);
    __syncthreads();
  };
  // a zero first state is never read (rows, cols and finish skip it)
  if (first) store_state(REV ? a.nc - 1 : 0);
  // B or C rows (exact) and x or dy rows of the state block's columns
  const TT* gr = REV ? static_cast<const TT*>(a.C) + bi * a.c_sb +
                           grp * a.c_sg
                     : static_cast<const TT*>(a.B) + bi * a.b_sb +
                           grp * a.b_sg;
  const long long gst = REV ? a.c_st : a.b_st;
  const TT* hr = REV ? static_cast<const TT*>(a.dy) + bi * a.dy_sb +
                           h * a.dy_sh + p0
                     : static_cast<const TT*>(a.x) + bi * a.x_sb +
                           h * a.x_sh + p0;
  const long long hst = REV ? a.dy_st : a.x_st;
  TT* rows = reinterpret_cast<TT*>(smem);
  const TT* rw = reinterpret_cast<const TT*>(smem + L.raw);
  const int c_end = REV ? (a.dinit ? -1 : 0) : a.nc - 1;
  for (int c = REV ? a.nc - 1 : 0; c != c_end; c += REV ? -1 : 1) {
    const float* cs = a.cs + bch(a, bi, c, h) * a.Qs;
    const float* dt = a.dtc + bch(a, bi, c, h) * a.Qs;
    const float last = cs[a.Qs - 1], decay = expf(last);
#pragma unroll
    for (int nt = 0; nt < kWide; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= decay;
    const int t0 = c * a.Q, nr = rows_of(a, c), nb = (nr + kBlk - 1) / kBlk;
    for (int k = 0; k < nb; ++k) {
      const long long t = t0 + k * kBlk;
      const int nk = nr - k * kBlk;
      load_rows(rows, ldN, gr + t * gst, gst, nk, N);
      load_rows(const_cast<TT*>(rw), kLdT, hr + t * hst, hst, nk, np);
      cp_commit();
      cp_wait<0>();
      if (tid < kBlk) {
        const int i = k * kBlk + tid;
        wt[tid] = tid >= nk ? 0.f
                  : REV ? __expf(cs[i]) : __expf(last - cs[i]) * dt[i];
      }
      __syncthreads();
      // the weighted rows, staged
      for (int e = tid; e < kBlk * kBlk / 2; e += kTh) {
        const int r = e / (kBlk / 2), cc = 2 * (e - r * (kBlk / 2));
        float v0 = 0.f, v1 = 0.f;
        if (r < nk && cc < np) {
          v0 = to_f32(rw[r * kLdT + cc]) * wt[r];
          v1 = to_f32(rw[r * kLdT + cc + 1]) * wt[r];
        }
        sX.put2(kLdT, r, cc, v0, v1);
      }
      __syncthreads();
      gemm<TC, kWide, true, false>(acc, N / 8, sX.hi, sX.lo, kLdT, rows,
                                   nullptr, ldN, kBlk);
      __syncthreads();
    }
    if (REV && c == 0)
      store_acc(a.dinit + own + size_t(p0) * N, N, acc, N / 8, np);
    else
      store_state(REV ? c - 1 : c + 1);
  }
}

// ---------------------------------------------------------------------------
// 3. tiles: one CTA per causal tile (I, J) of a (chunk, group, batch row)
// ---------------------------------------------------------------------------
template <typename TT, bool TC>
__global__ void __launch_bounds__(kTh) ssd_bwd_tiles(Args a) {
  const int c = blockIdx.x / a.ntq, tile = blockIdx.x - c * a.ntq;
  const int g = blockIdx.y, bi = blockIdx.z;
  int I = 0;
  while (tile_of(I + 1, 0) <= tile) ++I;
  const int J = tile - tile_of(I, 0);
  const int t0 = c * a.Q, nr = rows_of(a, c);
  if (I * kBlk >= nr) return;               // wholly past T
  const int P = a.P, N = a.N, ldP = P + 8, ldN = N + 8, Hg = a.nh / a.G;
  const TilesLayout L(P, N, sizeof(TT));
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* const smem = smem_raw;
  TT* sC = reinterpret_cast<TT*>(smem);
  TT* sB = reinterpret_cast<TT*>(smem + L.B);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int nI = nr - I * kBlk, nJ = nr - J * kBlk;

  load_rows(sC, ldN, static_cast<const TT*>(a.C) + bi * a.c_sb +
            g * a.c_sg + (long long)(t0 + I * kBlk) * a.c_st, a.c_st, nI, N);
  load_rows(sB, ldN, static_cast<const TT*>(a.B) + bi * a.b_sb +
            g * a.b_sg + (long long)(t0 + J * kBlk) * a.b_st, a.b_st, nJ, N);
  auto stage = [&](int s) { return smem + L.reg + s * L.stage; };
  auto load_head = [&](int k, int s) {
    const int h = g * Hg + k;
    uint8_t* p = stage(s);
    load_rows(reinterpret_cast<TT*>(p), ldP, static_cast<const TT*>(a.dy) +
              bi * a.dy_sb + h * a.dy_sh +
              (long long)(t0 + I * kBlk) * a.dy_st, a.dy_st, nI, P);
    load_rows(reinterpret_cast<TT*>(p + L.dyx), ldP,
              static_cast<const TT*>(a.x) + bi * a.x_sb + h * a.x_sh +
              (long long)(t0 + J * kBlk) * a.x_st, a.x_st, nJ, P);
    float* v = reinterpret_cast<float*>(p + 2 * L.dyx);
    const float* cs = a.cs + bch(a, bi, c, h) * a.Qs;
    load_vec(v, cs + I * kBlk, kBlk);
    load_vec(v + kBlk, cs + J * kBlk, kBlk);
    load_vec(v + 2 * kBlk, a.dtc + bch(a, bi, c, h) * a.Qs + J * kBlk, kBlk);
  };
  // heads k + 1 and k + 2 in flight while head k computes (a group is
  // committed every time, empty past the last head)
  load_head(0, 0);
  cp_commit();
  if (Hg > 1) load_head(1, 1);
  cp_commit();
  cp_wait<1>();
  __syncthreads();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  // C B^T of the tile, once for the group's heads
  float cb[kNarrow][4], mg[kNarrow][4];
  zero(cb);
  zero(mg);
  gemm<TC, kNarrow, false, true>(cb, kNarrow, sC, nullptr, ldN, sB, nullptr,
                                 ldN, N);
  for (int k = 0; k < Hg; ++k) {
    if (k + 2 < Hg) load_head(k + 2, (k + 2) % kTileStages);
    cp_commit();
    cp_wait<kTileStages - 1>();
    __syncthreads();
    const int h = g * Hg + k;
    uint8_t* p = stage(k % kTileStages);
    const TT* sdy = reinterpret_cast<const TT*>(p);
    const TT* sx = reinterpret_cast<const TT*>(p + L.dyx);
    const float* csI = reinterpret_cast<const float*>(p + 2 * L.dyx);
    const float* csJ = csI + kBlk;
    const float* dtJ = csJ + kBlk;
    float d[kNarrow][4];
    zero(d);
    gemm<TC, kNarrow, false, true>(d, kNarrow, sdy, nullptr, ldP, sx,
                                   nullptr, ldP, P);
    // M into Mg; G's row sums (weighted by dt_j) and column sums.  E_ij
    // against the warp's first row (see the note on E): on a diagonal
    // tile only the n-tiles before the warp's rows split, the next two
    // direct, the rest 0 (a body of its own, so that the others pay
    // nothing for it)
    const float ref = csI[16 * warp];
    float ci[2], fi[2], cj[kNarrow][2], gj[kNarrow][2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      ci[q] = csI[r0 + 8 * q];
      fi[q] = I * kBlk + r0 + 8 * q < nr ? __expf(ci[q] - ref) : 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < kNarrow; ++nt)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        cj[nt][q] = csJ[8 * nt + c0 + q];
        gj[nt][q] = __expf(ref - cj[nt][q]);
      }
    float rsum[2] = {0.f, 0.f}, csum[kNarrow][2];
    auto elements = [&](auto diagonal) {
#pragma unroll
      for (int nt = 0; nt < kNarrow; ++nt) {
        csum[nt][0] = csum[nt][1] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = r0 + 8 * (e >> 1), jl = 8 * nt + c0 + (e & 1);
          float E = fi[e >> 1] * gj[nt][e & 1];
          if constexpr (decltype(diagonal)::value)
            E = nt < 2 * warp ? E
                : (nt < 2 * warp + 2 && jl <= il && I * kBlk + il < nr)
                    ? __expf(ci[e >> 1] - cj[nt][e & 1])
                    : 0.f;
          const float de = d[nt][e] * E;
          mg[nt][e] += de * dtJ[jl];
          const float gv = cb[nt][e] * de;
          rsum[e >> 1] += dtJ[jl] * gv;
          csum[nt][e & 1] += gv;
        }
      }
    };
    if (I > J)
      elements(std::false_type());
    else
      elements(std::true_type());
    const size_t part = (bch(a, bi, c, h) * a.ntq + tile) * kBlk;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      rsum[q] += __shfl_xor_sync(0xffffffffu, rsum[q], 1);
      rsum[q] += __shfl_xor_sync(0xffffffffu, rsum[q], 2);
    }
    if ((lane & 3) == 0) {
      a.rs[part + r0] = rsum[0];
      a.rs[part + r0 + 8] = rsum[1];
    }
#pragma unroll
    for (int nt = 0; nt < kNarrow; ++nt)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float v = csum[nt][q];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4) red[warp * kBlk + 8 * nt + c0 + q] = v;
      }
    __syncthreads();
    if (tid < kBlk)
      a.cl[part + tid] = ((red[tid] + red[kBlk + tid]) + red[2 * kBlk + tid])
                         + red[3 * kBlk + tid];
    __syncthreads();
  }

  // Mg B_J (dC's part, rows i) and Mg^T C_I (dB's part, rows j)
  const Staged<TC> sMg(smem + L.reg, size_t(kBlk) * kLdT);
  sMg.put(kLdT, mg, kNarrow);
  __syncthreads();
  const size_t out = (bcg(a, bi, c, g) * a.ntq + tile) * kBlk * size_t(N);
  float o[kWide][4];
  zero(o);
  gemm<TC, kWide, false, false>(o, N / 8, sMg.hi, sMg.lo, kLdT, sB, nullptr,
                                ldN, kBlk);
  store_acc(a.dCp + out, N, o, N / 8);
  zero(o);
  gemm<TC, kWide, true, false>(o, N / 8, sMg.hi, sMg.lo, kLdT, sC, nullptr,
                               ldN, kBlk);
  store_acc(a.dBp + out, N, o, N / 8);
}

// ---------------------------------------------------------------------------
// 4. rows: the boundary terms of one block K of a (chunk, group, batch row),
// summed over a slice of the group's heads in order (reduce adds the
// slices in order).  pass 0: z = dy_K S (v = C . z, dC's term exp(cs_i)
// z); pass 1: z = x_K dS (u = B . z, dB's term e2_j dt_j z).  A pass whose
// state is 0 writes zeros.
// ---------------------------------------------------------------------------
template <typename TT, bool TC>
__global__ void __launch_bounds__(kTh) ssd_bwd_rows(Args a) {
  const int c = blockIdx.x / a.nbq, K = blockIdx.x - c * a.nbq;
  const int Hg = a.nh / a.G, slices = Hg / a.hs, pass = blockIdx.y & 1;
  const int g = (blockIdx.y >> 1) / slices, sl = (blockIdx.y >> 1) % slices;
  const int bi = blockIdx.z;
  const int t0 = c * a.Q, nr = rows_of(a, c);
  if (K * kBlk >= nr) return;
  const int P = a.P, N = a.N, ldP = P + 8, ldN = N + 8, h0 = sl * a.hs;
  const int nK = nr - K * kBlk, tid = threadIdx.x;
  float* bnd = a.bnd + (((bcg(a, bi, c, g) * a.nbq + K) * 2 + pass) *
                        slices + sl) * kBlk * size_t(N);
  const bool need = pass == 0 ? (c > 0 || a.init != nullptr)
                              : (c + 1 < a.nc || a.dstate != nullptr);
  if (!need) {
    for (int e = tid; e < kBlk * N; e += kTh) bnd[e] = 0.f;
    for (int e = tid; e < a.hs * kBlk; e += kTh)
      a.uv[(bch(a, bi, c, g * Hg + h0 + e / kBlk) * 2 + pass) * a.Qs +
           K * kBlk + e % kBlk] = 0.f;
    return;
  }
  const RowsLayout L(P, N, sizeof(TT));
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* const smem = smem_raw;
  TT* sG = reinterpret_cast<TT*>(smem);
  const TT* grows = pass == 0
      ? static_cast<const TT*>(a.C) + bi * a.c_sb + g * a.c_sg +
            (long long)(t0 + K * kBlk) * a.c_st
      : static_cast<const TT*>(a.B) + bi * a.b_sb + g * a.b_sg +
            (long long)(t0 + K * kBlk) * a.b_st;
  load_rows(sG, ldN, grows, pass == 0 ? a.c_st : a.b_st, nK, N);
  auto stage = [&](int s) { return smem + L.reg + s * L.stage; };
  auto load_head = [&](int k, int s) {
    const int h = g * Hg + h0 + k;
    uint8_t* p = stage(s);
    if (pass == 0)
      load_rows(reinterpret_cast<TT*>(p), ldP, static_cast<const TT*>(a.dy) +
                bi * a.dy_sb + h * a.dy_sh +
                (long long)(t0 + K * kBlk) * a.dy_st, a.dy_st, nK, P);
    else
      load_rows(reinterpret_cast<TT*>(p), ldP, static_cast<const TT*>(a.x) +
                bi * a.x_sb + h * a.x_sh +
                (long long)(t0 + K * kBlk) * a.x_st, a.x_st, nK, P);
    float* v = reinterpret_cast<float*>(p + L.cs);
    load_vec(v, a.cs + bch(a, bi, c, h) * a.Qs + K * kBlk, kBlk);
    load_vec(v + kBlk, a.dtc + bch(a, bi, c, h) * a.Qs + K * kBlk, kBlk);
    Staged<TC>(p + L.st, size_t(P) * ldN).load_state(
        ldN, state_of<TC>(a, pass == 0 ? a.S : a.dS, bi, c, h), P, N);
  };
  load_head(0, 0);
  cp_commit();

  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
  float acc[kWide][4];
  zero(acc);
  for (int k = 0; k < a.hs; ++k) {
    if (k + 1 < a.hs) {
      load_head(k + 1, (k + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int h = g * Hg + h0 + k;
    uint8_t* p = stage(k & 1);
    const Staged<TC> st(p + L.st, size_t(P) * ldN);
    const float* cs = reinterpret_cast<const float*>(p + L.cs);
    const float* dt = cs + kBlk;
    float z[kWide][4];
    zero(z);
    gemm<TC, kWide, false, false>(z, N / 8, reinterpret_cast<const TT*>(p),
                                  nullptr, ldP, st.hi, st.lo, ldN, P);
    // v_i = C_i . z_i or u_j = B_j . z_j
    float w[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kWide; ++nt) {
      if (nt >= N / 8) break;
      const int col = 8 * nt + c0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e >> 1] = fmaf(to_f32(sG[(r0 + 8 * (e >> 1)) * ldN + col + (e & 1)]),
                         z[nt][e], w[e >> 1]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      w[q] += __shfl_xor_sync(0xffffffffu, w[q], 1);
      w[q] += __shfl_xor_sync(0xffffffffu, w[q], 2);
    }
    if ((lane & 3) == 0) {
      float* uv = a.uv + (bch(a, bi, c, h) * 2 + pass) * a.Qs + K * kBlk;
      uv[r0] = w[0];
      uv[r0 + 8] = w[1];
    }
    const float last = a.cs[bch(a, bi, c, h) * a.Qs + a.Qs - 1];
    float sc[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = r0 + 8 * q;
      sc[q] = pass == 0 ? __expf(cs[r]) : __expf(last - cs[r]) * dt[r];
    }
#pragma unroll
    for (int nt = 0; nt < kWide; ++nt) {
      if (nt >= N / 8) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += sc[e >> 1] * z[nt][e];
    }
    __syncthreads();
  }
  store_acc(bnd, N, acc, N / 8);
}

// ---------------------------------------------------------------------------
// 5. cols: dx of one block J of a (chunk, group, batch row) for a slice of
// the group's heads.  8 warps: warp w takes the strip w % 4 of every
// product and its column half w / 4 (of a tile's 64 columns, of dx's P).
// ---------------------------------------------------------------------------
template <typename TT, bool TC>
__global__ void __launch_bounds__(kColsTh) ssd_bwd_cols(Args a) {
  const int c = blockIdx.x / a.nbq, J = blockIdx.x - c * a.nbq;
  const int Hg = a.nh / a.G, slices = Hg / a.hs;
  const int g = blockIdx.y / slices, sl = blockIdx.y - g * slices;
  const int bi = blockIdx.z;
  const int t0 = c * a.Q, nr = rows_of(a, c);
  if (J * kBlk >= nr) return;
  const int P = a.P, N = a.N, ldP = P + 8, ldN = N + 8, Qs = a.Qs;
  const int nb = (nr + kBlk - 1) / kBlk, nI = nb - J, nJ = nr - J * kBlk;
  const bool need_r = c + 1 < a.nc || a.dstate != nullptr;
  const ColsLayout L(P, N, sizeof(TT), a.nbq, Qs);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* const smem = smem_raw;
  float4* cache = reinterpret_cast<float4*>(smem);
  TT* sB = reinterpret_cast<TT*>(smem + L.B);
  const int tid = threadIdx.x, lane = tid & 31, half = tid >> 7;
  const int r0 = 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int c0 = 32 * half + 2 * (lane & 3);   // the lane's tile columns
  const int pq = P / 16, p0 = half * (P / 2);  // its n-tiles of dx and first

  // C B^T's transpose over the block's column tiles, (J, I) for I >= J,
  // kept in shared memory as the owners' elements
  load_rows(sB, ldN, static_cast<const TT*>(a.B) + bi * a.b_sb +
            g * a.b_sg + (long long)(t0 + J * kBlk) * a.b_st, a.b_st, nJ, N);
  const size_t rowsN = al16(size_t(kBlk) * (N + 8) * sizeof(TT));
  auto crow = [&](int s) { return reinterpret_cast<TT*>(smem + L.r1 +
                                                         s * rowsN); };
  auto load_c = [&](int I, int s) {
    load_rows(crow(s), ldN, static_cast<const TT*>(a.C) + bi * a.c_sb +
              g * a.c_sg + (long long)(t0 + I * kBlk) * a.c_st, a.c_st,
              nr - I * kBlk, N);
  };
  load_c(J, 0);
  cp_commit();
  for (int s = 0; s < nI; ++s) {
    if (s + 1 < nI) {
      load_c(J + s + 1, (s + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float cb[kHalf][4];
    zero(cb);
    gemm<TC, kHalf, false, true>(cb, kHalf, sB, nullptr, ldN,
                                 crow(s & 1) + 32 * half * ldN, nullptr, ldN,
                                 N);
#pragma unroll
    for (int nt = 0; nt < kHalf; ++nt)
      cache[(s * kHalf + nt) * kColsTh + tid] =
          make_float4(cb[nt][0], cb[nt][1], cb[nt][2], cb[nt][3]);
    __syncthreads();
  }

  // per head: dx_J = e2 dt (dS B_J) + sum_I W^T(J, I) dy_I; steps over
  // (head of the slice, I)
  const Staged<TC> sW(smem + L.w, size_t(kBlk) * kLdT);
  auto dsb = [&](int k) { return Staged<TC>(smem + L.r1 + (k & 1) * L.ds,
                                            size_t(P) * ldN); };
  auto csb = [&](int k) { return reinterpret_cast<float*>(
      smem + L.csb + (k & 1) * 2 * size_t(Qs) * 4); };
  auto dyb = [&](int s) { return reinterpret_cast<TT*>(smem + L.dy +
                                                       (s & 1) * L.dyb); };
  const int h0 = g * Hg + sl * a.hs, steps = a.hs * nI;
  auto load_step = [&](int s) {
    const int k = s / nI, I = J + s - k * nI, h = h0 + k;
    load_rows(dyb(s), ldP, static_cast<const TT*>(a.dy) + bi * a.dy_sb +
              h * a.dy_sh + (long long)(t0 + I * kBlk) * a.dy_st, a.dy_st,
              nr - I * kBlk, P);
    if (I == J) {
      load_vec(csb(k), a.cs + bch(a, bi, c, h) * Qs, Qs);
      load_vec(csb(k) + Qs, a.dtc + bch(a, bi, c, h) * Qs, Qs);
      if (need_r)
        dsb(k).load_state(ldN, state_of<TC>(a, a.dS, bi, c, h), P, N);
    }
  };
  load_step(0);
  cp_commit();
  float dx[kWide / 2][4];
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load_step(s + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int k = s / nI, I = J + s - k * nI, h = h0 + k;
    const float* cs = csb(k);
    const float* dt = cs + Qs;
    if (I == J) {
      zero(dx);
      if (need_r) {
        // r = B_J dS^T; dx starts at e2_j dt_j r_j
        const Staged<TC> ds = dsb(k).offset(size_t(p0) * ldN);
        gemm<TC, kWide / 2, false, true>(dx, pq, sB, nullptr, ldN, ds.hi,
                                         ds.lo, ldN, N);
        const float last = cs[Qs - 1];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int jj = J * kBlk + r0 + 8 * q;
          const float w = __expf(last - cs[jj]) * dt[jj];
#pragma unroll
          for (int nt = 0; nt < kWide / 2; ++nt) {
            if (nt >= pq) break;
            dx[nt][2 * q] *= w;
            dx[nt][2 * q + 1] *= w;
          }
        }
      }
    }
    // W^T(J, I) = C B^T's transpose o E^T dt_j, staged; E_ij against the
    // last step jb of the warp's 16 rows j (see the note on E): n-tiles of
    // columns past jb split, those that meet the rows direct, those
    // before them 0
    const int jb = J * kBlk + (r0 & ~15) + 15;
    const float ref = cs[jb];
    float cj[2], dj[2], gj[2], ci[kHalf][2], fi[kHalf][2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int jj = J * kBlk + r0 + 8 * q;
      cj[q] = cs[jj];
      dj[q] = dt[jj];
      gj[q] = __expf(ref - cj[q]) * dj[q];
    }
#pragma unroll
    for (int nt = 0; nt < kHalf; ++nt)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int ii = I * kBlk + c0 + 8 * nt + q;
        ci[nt][q] = cs[ii];
        fi[nt][q] = ii < nr ? __expf(ci[nt][q] - ref) : 0.f;
      }
    auto stage = [&](auto diagonal) {
#pragma unroll
      for (int nt = 0; nt < kHalf; ++nt) {
        const float4 v = cache[((I - J) * kHalf + nt) * kColsTh + tid];
        const float cv[4] = {v.x, v.y, v.z, v.w};
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          w[e] = cv[e] * fi[nt][e & 1] * gj[e >> 1];
          if constexpr (decltype(diagonal)::value) {
            const int jl = r0 + 8 * (e >> 1), il = 8 * nt + c0 + (e & 1);
            const int first = J * kBlk + (c0 & ~7) + 8 * nt;  // n-tile's
            w[e] = first > jb ? w[e]
                   : (first + 8 > jb - 15 && jl <= il &&
                      J * kBlk + il < nr)
                       ? cv[e] * __expf(ci[nt][e & 1] - cj[e >> 1]) *
                             dj[e >> 1]
                       : 0.f;
          }
        }
        sW.put2(kLdT, r0, 8 * nt + c0, w[0], w[1]);
        sW.put2(kLdT, r0 + 8, 8 * nt + c0, w[2], w[3]);
      }
    };
    if (I > J)
      stage(std::false_type());
    else
      stage(std::true_type());
    __syncthreads();
    gemm<TC, kWide / 2, false, false>(dx, pq, sW.hi, sW.lo, kLdT,
                                      dyb(s) + p0, nullptr, ldP, kBlk);
    if (I == nb - 1) {
      TT* out = static_cast<TT*>(a.dx) +
                ((size_t(bi) * a.T + t0 + J * kBlk) * a.nh + h) * P + p0;
      const size_t st = size_t(a.nh) * P;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = r0 + 8 * q;
        if (r >= nJ) continue;
#pragma unroll
        for (int nt = 0; nt < kWide / 2; ++nt) {
          if (nt >= pq) break;
          TT* o = out + r * st + 8 * nt + 2 * (lane & 3);
          if constexpr (std::is_same<TT, bf16>::value)
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(dx[nt][2 * q], dx[nt][2 * q + 1]);
          else
            *reinterpret_cast<float2*>(o) =
                make_float2(dx[nt][2 * q], dx[nt][2 * q + 1]);
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 6. finish: dcs, da, ddt and dA's share of one (chunk, head, batch row)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) ssd_bwd_finish(Args a) {
  __shared__ float dcs[kMaxQ], eu[kMaxQ], red[kThreads];
  const int c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int t0 = c * a.Q, nr = rows_of(a, c), tid = threadIdx.x;
  const int nb = (nr + kBlk - 1) / kBlk;
  const size_t o = bch(a, bi, c, h);
  const float* cs = a.cs + o * a.Qs;
  const float* dts = a.dtc + o * a.Qs;
  const float* v = a.uv + o * 2 * a.Qs;
  const float* u = v + a.Qs;
  const float last = cs[a.Qs - 1];
  float cl = 0.f, ue = 0.f;
  if (tid < nr) {
    const int I = tid / kBlk, row = tid - I * kBlk;
    float rs = 0.f;
    for (int J = 0; J <= I; ++J)
      rs += a.rs[(o * a.ntq + tile_of(I, J)) * kBlk + row];
    for (int I2 = I; I2 < nb; ++I2)
      cl += a.cl[(o * a.ntq + tile_of(I2, I)) * kBlk + row];
    const float e2 = expf(last - cs[tid]), d = dts[tid];
    ue = e2 * u[tid];
    eu[tid] = e2 * d * u[tid];
    dcs[tid] = rs - d * cl + expf(cs[tid]) * v[tid] - e2 * d * u[tid];
  }
  // <dS, S> in a fixed tree, where both are nonzero
  float part = 0.f;
  if ((c > 0 || a.init) && (c + 1 < a.nc || a.dstate)) {
    if (a.tc) {
      const Staged<true> S0 = state_of<true>(a, a.S, bi, c, h);
      const Staged<true> dS1 = state_of<true>(a, a.dS, bi, c, h);
      for (int e = tid; e < a.P * a.N; e += kThreads)
        part += (to_f32(dS1.hi[e]) + to_f32(dS1.lo[e])) *
                (to_f32(S0.hi[e]) + to_f32(S0.lo[e]));
    } else {
      const float* S0 = a.S + state_at(a, bi, c, h);
      const float* dS1 = a.dS + state_at(a, bi, c, h);
      for (int e = tid; e < a.P * a.N; e += kThreads) part += dS1[e] * S0[e];
    }
  }
  red[tid] = part;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) {
    float tail = expf(last) * red[0];
    for (int j = 0; j < nr; ++j) tail += eu[j];
    dcs[nr - 1] += tail;
    float acc = 0.f, dAh = 0.f;
    for (int k = nr - 1; k >= 0; --k) {
      acc += dcs[k];
      dcs[k] = acc;
      dAh += acc * dts[k];
    }
    a.dA_part[o] = dAh;
  }
  __syncthreads();
  if (tid < nr)
    a.ddt[(size_t(bi) * a.T + t0 + tid) * a.nh + h] =
        cl + ue + dcs[tid] * a.A[h];
}

// ---------------------------------------------------------------------------
// 7. reduce: dB and dC from the tiles' and rows' parts, dA over (batch row,
// chunk), in order
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce(Args a) {
  const size_t total = size_t(a.b) * a.T * a.G * a.N;
  for (size_t e = blockIdx.x * size_t(kThreads) + threadIdx.x; e < total;
       e += size_t(gridDim.x) * kThreads) {
    const int n = e % a.N;
    const int g = (e / a.N) % a.G;
    const size_t bt = e / (size_t(a.N) * a.G);
    const int t = bt % a.T, bi = bt / a.T;
    const int c = t / a.Q, loc = t - c * a.Q;
    const int K = loc / kBlk, row = loc - K * kBlk;
    const int nb = (rows_of(a, c) + kBlk - 1) / kBlk;
    const size_t base = bcg(a, bi, c, g);
    auto part = [&](const float* p, int tile) {
      return p[((base * a.ntq + tile) * kBlk + row) * a.N + n];
    };
    float sc = 0.f, sb = 0.f;
    for (int J = 0; J <= K; ++J) sc += part(a.dCp, tile_of(K, J));
    for (int I = K; I < nb; ++I) sb += part(a.dBp, tile_of(I, K));
    const int slices = a.nh / a.G / a.hs;
    const float* bn = a.bnd + (base * a.nbq + K) * 2 * slices * kBlk *
                                  size_t(a.N) + row * a.N + n;
    for (int sl = 0; sl < slices; ++sl)
      sc += bn[sl * kBlk * size_t(a.N)];
    for (int sl = 0; sl < slices; ++sl)
      sb += bn[(slices + sl) * kBlk * size_t(a.N)];
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

// ---------------------------------------------------------------------------
// the routes
// ---------------------------------------------------------------------------

// shared memory of the widest chunk kernel of a shape
size_t smem_of(int P, int N, int es, int nbq) {
  size_t most = StatesLayout(N, es).end;
  for (size_t v : {TilesLayout(P, N, es).end, RowsLayout(P, N, es).end,
                   ColsLayout(P, N, es, nbq, nbq * kBlk).end})
    most = v > most ? v : most;
  return most;
}

// the route of a shape (dtype 0 = float32, 1 = bfloat16): 0 none, 2 the
// tensor cores (bf16), 3 the CUDA cores; `want` 0 asks the table, 2-3
// whether that route can take the shape.  Every route needs P a multiple
// of 32 and N of 16, both up to 128, and its kernels within shared
// memory.
int route_of(int dtype, int P, int N, int Q, int want) {
  if (P < 32 || N < 16 || P > kMaxW || N > kMaxW || P % 32 || N % 16 ||
      Q < 1 || Q > kMaxQ)
    return 0;
  if (smem_of(P, N, dtype == 0 ? 4 : 2, (Q + kBlk - 1) / kBlk) > kMaxSmem)
    return 0;
  if (want == 0) return dtype == 1 ? kTensorCores : kCudaCores;
  if (want == kTensorCores) return dtype == 1 ? kTensorCores : 0;
  return want == kCudaCores ? kCudaCores : 0;
}

// The dynamic shared memory each kernel instance may use is allowed once
// per load of the library: each instance's function-local static is set on
// its first call.
template <typename Kern>
cudaError_t allow_smem(Kern kern) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

template <typename TT, bool TC>
cudaError_t launch_chunks(const Args& a, cudaStream_t s) {
  static const cudaError_t e0 = allow_smem(ssd_bwd_states<TT, TC, false>);
  static const cudaError_t e4 = allow_smem(ssd_bwd_states<TT, TC, true>);
  static const cudaError_t e1 = allow_smem(ssd_bwd_tiles<TT, TC>);
  static const cudaError_t e2 = allow_smem(ssd_bwd_rows<TT, TC>);
  static const cudaError_t e3 = allow_smem(ssd_bwd_cols<TT, TC>);
  for (cudaError_t e : {e0, e4, e1, e2, e3})
    if (e != cudaSuccess) return e;
  const int es = sizeof(TT);
  const dim3 sgrid(a.nh, a.b, (a.P + kBlk - 1) / kBlk);
  const size_t sbytes = StatesLayout(a.N, es).end;
  ssd_bwd_states<TT, TC, false><<<sgrid, kTh, sbytes, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_states<TT, TC, true><<<sgrid, kTh, sbytes, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_tiles<TT, TC><<<dim3(a.nc * a.ntq, a.G, a.b), kTh,
                          TilesLayout(a.P, a.N, es).end, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_rows<TT, TC><<<dim3(a.nc * a.nbq, 2 * a.G * (a.nh / a.G / a.hs),
                             a.b), kTh,
                         RowsLayout(a.P, a.N, es).end, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_cols<TT, TC><<<dim3(a.nc * a.nbq, a.G * (a.nh / a.G / a.hs), a.b),
                         kColsTh, ColsLayout(a.P, a.N, es, a.nbq, a.Qs).end,
                         s>>>(a);
  return cudaGetLastError();
}

template <typename TT>
cudaError_t launch_all(const Args& a, int route, cudaStream_t s) {
  ssd_bwd_prep<<<dim3(a.nc, a.nh, a.b), 32, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<TT, bf16>::value)
    err = route == kTensorCores ? launch_chunks<TT, true>(a, s)
                                : launch_chunks<TT, false>(a, s);
  else
    err = launch_chunks<TT, false>(a, s);
  if (err != cudaSuccess) return err;
  ssd_bwd_finish<<<dim3(a.nc, a.nh, a.b), kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t total = size_t(a.b) * a.T * a.G * a.N;
  size_t blocks = (total + kThreads - 1) / kThreads;
  const size_t for_heads = (size_t(a.nh) + kThreads - 1) / kThreads;
  if (blocks < for_heads) blocks = for_heads;
  if (blocks > 65535) blocks = 65535;
  ssd_bwd_reduce<<<unsigned(blocks), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// the route of a shape: see route_of
extern "C" int ssd_scan_bwd_route(int dtype, int P, int N, int Q, int want) {
  return route_of(dtype, P, N, Q, want);
}

// The backward of one ssd_chunk_scan call on `route` (0: the table's).
// dtype: 0 float32, 1 bfloat16 (x, B, C, dy and dx); dt, A, the states and
// every other gradient f32.  init / dstate / dinit may be null (zero
// initial state, zero final-state gradient, no initial-state gradient);
// `hs` heads a rows or cols CTA takes (a divisor of nh / G); `scratch` the
// caller's f32 workspace of ops.bwd_scratch_floats elements.  Returns the
// cudaError_t of the launches; a shape the route cannot take is refused,
// never sent elsewhere.
extern "C" int ssd_scan_bwd_launch(
    int dtype, const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* init, const void* dy, const void* dstate,
    void* dx, void* ddt, void* dA, void* dB, void* dC, void* dinit,
    void* scratch, int b, int T, int nh, int P, int G, int N, int Q,
    long long x_sb, long long x_st, long long x_sh, long long dy_sb,
    long long dy_st, long long dy_sh, long long dt_sb, long long dt_st,
    long long b_sb, long long b_st, long long b_sg, long long c_sb,
    long long c_st, long long c_sg, int hs, int route, void* stream) {
  if (G < 1 || nh % G || T < 1 || b < 1 || b > 65535 || nh > 65535 ||
      hs < 1 || (nh / G) % hs)
    return cudaErrorInvalidValue;
  const int r = route_of(dtype, P, N, Q, route);
  if (r == 0) return cudaErrorInvalidValue;
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
  a.b = b; a.T = T; a.nh = nh; a.P = P; a.G = G; a.N = N; a.Q = Q;
  a.nc = (T + Q - 1) / Q;
  a.nbq = (Q + kBlk - 1) / kBlk;
  a.ntq = a.nbq * (a.nbq + 1) / 2;
  a.Qs = a.nbq * kBlk;
  a.hs = hs;
  a.tc = r == kTensorCores;
  // the workspace, in ops.bwd_scratch's order
  float* w = static_cast<float*>(scratch);
  const size_t bc = size_t(b) * a.nc, bch_ = bc * nh, bcg_ = bc * G;
  a.S = w; w += bch_ * P * N;
  a.dS = w; w += bch_ * P * N;
  a.cs = w; w += bch_ * a.Qs;
  a.dtc = w; w += bch_ * a.Qs;
  a.rs = w; w += bch_ * a.ntq * kBlk;
  a.cl = w; w += bch_ * a.ntq * kBlk;
  a.dBp = w; w += bcg_ * a.ntq * kBlk * N;
  a.dCp = w; w += bcg_ * a.ntq * kBlk * N;
  a.bnd = w; w += bcg_ * a.nbq * 2 * (nh / G / hs) * kBlk * N;
  a.uv = w; w += bch_ * 2 * a.Qs;
  a.dA_part = w;
  a.x_sb = x_sb; a.x_st = x_st; a.x_sh = x_sh;
  a.dy_sb = dy_sb; a.dy_st = dy_st; a.dy_sh = dy_sh;
  a.dt_sb = dt_sb; a.dt_st = dt_st;
  a.b_sb = b_sb; a.b_st = b_st; a.b_sg = b_sg;
  a.c_sb = c_sb; a.c_st = c_st; a.c_sg = c_sg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_all<float>(a, r, s) : launch_all<bf16>(a, r, s);
}

extern "C" const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
