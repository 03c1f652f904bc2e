// Backward of the GQA flash attention on Hopper (sm_90a): kernel K7.
//
// Replaces no Pallas kernel: the JAX package takes the gradient of its
// attention by differentiating jnp_flash (repro/models/attention.py:28)
// with jax.value_and_grad in its train step (repro/launch/steps.py:188),
// and the Pallas forward (repro/kernels/flash_attention.py:77) has no
// backward. This is the port's counterpart of that derived gradient, so
// that the train path runs no plain attention on the card. For query
// head h (KV head h / G, G = H / Hkv), query row i at absolute position
// q_offset + i and key j, with the forward's contract (K5,
// flash_attention.cu):
//
//     s_ij = (q_i . k_j) D^-1/2, masked where j >= T or, under causal,
//            j > q_offset + i;  p_ij = exp(s_ij - m_i) / max(l_i, 1e-30)
//     dv_j = sum_i p_ij do_i          dp_ij = do_i . v_j
//     delta_i = do_i . o_i            ds_ij = p_ij (dp_ij - delta_i)
//     dq_i = D^-1/2 sum_j ds_ij k_j   dk_j = D^-1/2 sum_i ds_ij q_i
//
// with dk and dv summed over the G query heads of their KV head. Inputs
// q, k, v, o and do and outputs dq, dk and dv are (B, heads, rows,
// width) tensors given by their (batch, head, row) strides, last axis
// contiguous, the inputs' bases 16-byte aligned and their strides
// multiples of 16 bytes (the wrapper copies any other view), all f32 or
// all bf16; sums in f32, outputs in the inputs' type. (D, DV) one of
// (16, 16), (32, 32), (64, 64), (128, 128) and (192, 128), the
// forward's pairs. Every query row sees key 0 (T >= 1, q_offset >= 0),
// so l >= 1 and p = exp2(s D^-1/2 log2 e - lse2) with lse2 = m D^-1/2
// log2 e + log2 l, the row's log-sum-exp in base 2.
//
// Bound on this card: at StarCoder2-3B's train shape (B 4, H 24, Hkv 2,
// S = T = 2048, D = DV = 128, causal) the function needs 3 D + 2 DV
// multiply-adds for each of the 201 M unmasked pairs (q . k, do . v,
// p do, ds q, ds k), 0.26 TFLOP: 0.26 ms at the bf16 tensor-core rate
// (989 TFLOP/s), 3.85 ms at the f32 rate of the CUDA cores (67); its
// bytes (0.17 GB in bf16) take 0.05 ms. So it is bound by its products.
// This design recomputes the scores in each of its three launches and
// forms do . v twice: 5 D + 3 DV multiply-adds a pair, 0.41 TFLOP (0.42
// ms in bf16, 6.2 ms in f32).
//
// Three launches, no atomics (every gradient element has one owner and
// a fixed order of sums, so two calls give the same bits), and a fourth
// when the heads are split:
//   1. stats: per query row lse2 (from S = Q K^T up to the row's causal
//      limit, online max and sum) and delta = rowsum(do o) from 16-byte
//      loads, into an f32 workspace of (B H, Sp) each, Sp = S rounded
//      up to 128; rows past S get lse2 = +inf and delta = 0, so their p
//      and ds are 0.
//   2. dk, dv: one block per (batch, KV head, key tile, split of the G
//      query heads), the lowest key tiles (the heaviest under causal)
//      first. The block holds its K and V tiles and loops over its
//      G / splits heads and their query tiles from the first one its
//      keys can see: S^T = K Q^T and dP^T = V dO^T, P^T = exp2(S^T
//      D^-1/2 log2 e - lse2), dS^T = P^T (dP^T - delta), dV += P^T dO
//      and dK += dS^T Q. With one split it writes dk and dv; with more
//      (the grid under 4 x 132 blocks: the largest divisor of G up to
//      4) each split writes its f32 partials to (B, Hkv, splits, T, D +
//      DV) and
//   2b. sum: one thread per 4 columns sums the splits in order 0, 1, ...,
//      scales dk by D^-1/2 and casts. At the train shape with 4 splits
//      the partials take 4 x 2 x 4 x 2048 x 256 floats, 67 MB.
//   3. dq: one block per (batch, head, query tile), the last tiles (the
//      heaviest under causal) first, looping over the key tiles up to
//      its causal limit: S = Q K^T, dP = dO V^T, dS as in 2, dQ += dS K.
//
// bf16 (hopper::, the 2e-2 bar admits bf16 products with f32 sums): every
// product on wgmma, fed by TMA, as K5's flash_fwd_sm90. A block is a
// producer warpgroup (setmaxnreg 24; one thread issues every TMA load)
// and two consumer warpgroups (setmaxnreg 240) of 64 rows each (query
// rows in 1 and 3, keys in 2), tiles swizzled over their widest box
// (128 B at D >= 64) as in K5; rings of 2 stages, each a "full" mbarrier
// (expect-tx bytes) and an "empty" one (one arrival per consumer warp).
//   1: 128 query rows a block, K tiles of 128 keys through the ring; S
//      m64n128k16, both operands K-major.
//   2: 128 keys a block (64 a consumer), K and V loaded once; Q, dO, lse2
//      and delta tiles of BQ = 64 query rows (32 at (192, 128)) through
//      the ring (lse2 and delta by 1-D bulk copies). S^T and dP^T are
//      m64nBQk16 SS products (A = the key rows, B = the query tile, both
//      K-major); P^T and dS^T are rounded to bf16 in registers and are
//      the A operands of dV += P^T dO and dK += dS^T Q (m64n{DV}k16 and
//      m64n{D}k16 RS products: dO and Q, the same swizzled tiles, read as
//      MN-major B). Registers a consumer thread at (128, 128): dK 64, dV
//      64, S^T 32, dP^T 32, P^T 16.
//   3: 128 query rows a block, Q and dO loaded once, K and V tiles of 64
//      keys through the ring: S and dP m64n64k16 SS, dS in registers as
//      the A operand of dQ += dS K (m64n{D}k16 RS, K read as MN-major
//      B). Registers: dQ 64 (96 at D = 192), S 32, dP 32.
//   Dynamic shared memory at (128, 128) / (192, 128), with 1 KB of
//   alignment slack: 1: 97 / 145 KB; 2: 130 / 121.5 KB; 3: 129 / 161 KB;
//   one block an SM. ptxas allocates 168 registers a thread for the
//   block; setmaxnreg moves them to the consumers (240) from the
//   producer (24), and nothing spills.
//   Rounding against the contract: P^T and dS^T are rounded to bf16
//   before their products (ROADMAP C14), as K5 rounds P (C8).
//
// f32 (the 1e-5 bar keeps the products on the CUDA cores; no TF32):
// the same launches and split, register-tiled. Tiles are f32 rows in
// shared memory padded by 4 floats (16-byte cp.async loads, zeros past
// the extent), so that 8 lanes' float4 reads of 8 different rows hit
// distinct banks. A thread (ty, tx) of a 16-wide grid forms a 4 x 4 (4 x
// 2 at (192, 128)) micro-tile of S / dP from float4 reads of its rows
// (the same for the 16 lanes of a half-warp: a broadcast) and of 16
// lanes' rows: 8 float4 reads feed 64 multiply-adds. P and dS go to
// shared memory transposed, and a thread adds 4 rows x (width / 16)
// columns of dK / dV (dQ) from one float4 of P (dS) and width / 64
// float4 of the operand per step. Blocks of 256 threads on 64 x 64
// tiles: at (128, 128) 66 KB and 96 registers a thread (1, two blocks
// an SM), 166.5 KB and 210 (2) and 149.5 KB and 168 (3), one block an
// SM; at (192, 128) 128 threads on 32 x 32 tiles, 91 KB and 194
// registers (2) and 87 KB and 156 (3), two blocks an SM.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int SM_COUNT = 132;
constexpr int ROW_PAD = 128;      // Sp: S rounded up to this

// (batch, head, row) strides of one tensor, in elements
struct Str {
  long long b, h, s;
};

// one call's pointers, shapes and strides
struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float* lse;     // (B H, Sp): lse2 of each query row, +inf past S
  float* delta;   // (B H, Sp): rowsum(do o), 0 past S
  float* part;    // (B, Hkv, splits, T, D + DV) f32 partials, or null
  int B, H, Hkv, G, S, Tk, Sp, splits;
  Str qs, ks, vs, os, dos, dqs, dks, dvs;
  float scale, scale_log2;
  int causal, q_offset;
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// x . y over 16 bytes of each
__device__ __forceinline__ float dot16(const float* x, const float* y) {
  const float4 a = *reinterpret_cast<const float4*>(x);
  const float4 b = *reinterpret_cast<const float4*>(y);
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* x,
                                       const __nv_bfloat16* y) {
  const uint4 a = *reinterpret_cast<const uint4*>(x);
  const uint4 b = *reinterpret_cast<const uint4*>(y);
  const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 u = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&aw[e]));
    const float2 w = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&bw[e]));
    s = fmaf(u.x, w.x, fmaf(u.y, w.y, s));
  }
  return s;
}

// delta = rowsum(do o) of rows [r0, r0 + n) of head (b, h) into a.delta
// (0 past S), by the `nthr` threads from thread `t` (whole warps): DV /
// (16 / sizeof(T)) lanes a row, 16 bytes a lane, summed by shuffles
template <typename T, int DV>
__device__ void delta_rows(const Args& a, int b, int h, int r0, int n,
                           int t, int nthr) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int LPR = DV / VEC;
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "lanes a row");
  const T* ob = static_cast<const T*>(a.o) + b * a.os.b + h * a.os.h;
  const T* db = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
  float* out = a.delta + ((size_t)b * a.H + h) * a.Sp;
  for (int base = 0; base < n * LPR; base += nthr) {
    const int idx = base + t, r = idx / LPR, c = idx % LPR;
    const int row = r0 + r;
    float sum = 0.f;
    if (r < n && row < a.S)
      sum = dot16(db + (long long)row * a.dos.s + c * VEC,
                  ob + (long long)row * a.os.s + c * VEC);
#pragma unroll
    for (int w = LPR / 2; w >= 1; w /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, w);
    if (r < n && c == 0) out[row] = sum;
  }
}

// 2b. the splits' partials summed in order, dk scaled, both cast
template <typename T, int D, int DV>
__global__ void __launch_bounds__(256)
bwd_sum(const Args a) {
  constexpr int W = D + DV, W4 = W / 4;
  const long long rows = (long long)a.B * a.Hkv * a.Tk;
  for (long long idx = blockIdx.x * 256ll + threadIdx.x; idx < rows * W4;
       idx += (long long)gridDim.x * 256) {
    const int c = (int)(idx % W4) * 4;
    const long long row = idx / W4;
    const int key = (int)(row % a.Tk);
    const long long bk = row / a.Tk;        // b Hkv + kvh
    const float* p = a.part + (bk * a.splits * a.Tk + key) * W + c;
    float4 s = *reinterpret_cast<const float4*>(p);
    for (int sp = 1; sp < a.splits; ++sp) {
      const float4 x = *reinterpret_cast<const float4*>(
          p + (long long)sp * a.Tk * W);
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    const int b = (int)(bk / a.Hkv), kvh = (int)(bk % a.Hkv);
    T* dst;
    float f = 1.f;
    if (c < D) {
      dst = static_cast<T*>(a.dk) + b * a.dks.b + kvh * a.dks.h +
            (long long)key * a.dks.s + c;
      f = a.scale;
    } else {
      dst = static_cast<T*>(a.dv) + b * a.dvs.b + kvh * a.dvs.h +
            (long long)key * a.dvs.s + (c - D);
    }
    dst[0] = from_f<T>(s.x * f);
    dst[1] = from_f<T>(s.y * f);
    dst[2] = from_f<T>(s.z * f);
    dst[3] = from_f<T>(s.w * f);
  }
}

// ---- the f32 instance: register-tiled products on the CUDA cores ------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// rows [r0, r0 + n) of a strided (rows x W) f32 matrix into shared
// memory as rows of W + 4 floats, zeros past `rows` (16-byte copies;
// the caller waits with cp_async_wait and a barrier)
template <int W>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ss, int r0, int n,
                                          int rows, int t, int nthr) {
  constexpr int C = W / 4;
  for (int idx = t; idx < n * C; idx += nthr) {
    const int r = idx / C, c = idx % C;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * (W + 4) + 4 * c,
               ok ? src + (long long)(r0 + r) * ss + 4 * c : src, ok);
  }
}

// acc[r][c] = A[a0 + as r] . B[b0 + 16 c] over W columns (rows W + 4
// floats apart): float4 reads, RM + RN of them for RM RN 4 multiply-adds
template <int W, int RM, int RN>
__device__ __forceinline__ void dots(float (&acc)[RM][RN], const float* A,
                                     int a0, int as, const float* B,
                                     int b0) {
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < W; d += 4) {
    float4 x[RM], y[RN];
#pragma unroll
    for (int r = 0; r < RM; ++r)
      x[r] = *reinterpret_cast<const float4*>(A + (a0 + as * r) * (W + 4) +
                                              d);
#pragma unroll
    for (int c = 0; c < RN; ++c)
      y[c] = *reinterpret_cast<const float4*>(B + (b0 + 16 * c) * (W + 4) +
                                              d);
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        acc[r][c] = fmaf(x[r].x, y[c].x, acc[r][c]);
        acc[r][c] = fmaf(x[r].y, y[c].y, acc[r][c]);
        acc[r][c] = fmaf(x[r].z, y[c].z, acc[r][c]);
        acc[r][c] = fmaf(x[r].w, y[c].w, acc[r][c]);
      }
  }
}

// the columns of a W-wide accumulator that lane cx of 16 owns: NJ
// groups of VEC, group g at g 16 VEC + cx VEC
template <int W>
struct Cols {
  static constexpr int VEC = W >= 64 ? 4 : W / 16;
  static constexpr int NJ = W / (16 * VEC);
};

// acc[r][j] += w_r row[column j] for the 4 rows of w and the columns lane
// cx owns
template <int W>
__device__ __forceinline__ void axpy4(float (&acc)[4][W / 16], float4 w,
                                      const float* row, int cx) {
  using C = Cols<W>;
  const float wr[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int g = 0; g < C::NJ; ++g) {
    const float* p = row + g * 16 * C::VEC + cx * C::VEC;
    float x[C::VEC];
    if constexpr (C::VEC == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      x[0] = t.x;
      x[1] = t.y;
      x[2] = t.z;
      x[3] = t.w;
    } else if constexpr (C::VEC == 2) {
      const float2 t = *reinterpret_cast<const float2*>(p);
      x[0] = t.x;
      x[1] = t.y;
    } else {
      x[0] = p[0];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e)
        acc[r][g * C::VEC + e] = fmaf(wr[r], x[e], acc[r][g * C::VEC + e]);
  }
}

// 4 rows x the lane's columns of acc, times f, to row0.. of a strided
// (rows x W) matrix (rows past `rows` skipped)
template <typename T, int W>
__device__ __forceinline__ void store4(T* base, long long ss, int row0,
                                       int rows, const float (&acc)[4][W / 16],
                                       int cx, float f) {
  using C = Cols<W>;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (row0 + r >= rows) continue;
    T* p = base + (long long)(row0 + r) * ss;
#pragma unroll
    for (int g = 0; g < C::NJ; ++g)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e)
        p[g * 16 * C::VEC + cx * C::VEC + e] =
            from_f<T>(acc[r][g * C::VEC + e] * f);
  }
}

// 1. lse2 and delta: 64 query rows a block, 256 threads, key tiles of 64;
// thread (ty, tx) scores rows ty + 16 r against keys tx + 16 c
template <int D, int DV>
__global__ void __launch_bounds__(256)
bwd_stats_f32(const Args a) {
  constexpr int BQ = 64, BK = 64;
  extern __shared__ float smem[];
  float* Qs = smem;                   // BQ x (D + 4)
  float* Ks = Qs + BQ * (D + 4);      // BK x (D + 4)
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* qb = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b +
                    (h / a.G) * a.ks.h;
  load_tile<D>(Qs, qb, a.qs.s, q0, BQ, a.S, tid, 256);
  cp_async_wait();
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  const int q_last = min(q0 + BQ, a.S) - 1;
  const int kend = q0 >= a.S ? 0
                   : a.causal ? min(a.Tk, a.q_offset + q_last + 1)
                              : a.Tk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();   // the last tile read
    load_tile<D>(Ks, kb, a.ks.s, k0, BK, a.Tk, tid, 256);
    cp_async_wait();
    __syncthreads();
    float s[4][4];
    dots<D, 4, 4>(s, Qs, ty, 16, Ks, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = a.q_offset + q0 + ty + 16 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx + 16 * c;
        if (key >= a.Tk || (a.causal && key > qpos)) s[r][c] = -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int w = 8; w >= 1; w /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mn = fmaxf(m[r], mx);
      const float mu = mn == -INFINITY ? 0.f : mn;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sum += sm90::ex2((s[r][c] - mu) * a.scale_log2);
      l[r] = l[r] * sm90::ex2((m[r] - mu) * a.scale_log2) + sum;
      m[r] = mn;
    }
  }
  float* lse = a.lse + ((size_t)b * a.H + h) * a.Sp;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int w = 8; w >= 1; w /= 2)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], w);
    const int row = q0 + ty + 16 * r;
    if (tx == 0)
      lse[row] = row < a.S && l[r] > 0.f
                     ? fmaf(m[r], a.scale_log2, log2f(l[r]))
                     : INFINITY;
  }
  delta_rows<float, DV>(a, b, h, q0, BQ, tid, 256);
}

// tiles of the f32 dk/dv and dq launches: 256 threads on 64 x 64 tiles,
// or 128 threads on 32 x 32 at D = 192 (two blocks an SM); a thread's
// micro-tile is 4 rows (TY apart) x RN columns (16 apart)
template <int D>
struct TileF32 {
  static constexpr int THREADS = D > 128 ? 128 : 256;
  static constexpr int TY = THREADS / 16;
  static constexpr int BR = 4 * TY;          // rows of the block's tile
  static constexpr int BC = D > 128 ? 32 : 64;  // the streamed tile
  static constexpr int RN = BC / 16;
  // blocks an SM the register budget is set for (one at D = 128, where
  // the tiles' 153-170 KB of shared memory leave room for no second)
  static constexpr int PER_SM = D == 128 ? 1 : 2;
};

template <int D, int DV>
constexpr size_t dkdv_f32_floats() {
  using C = TileF32<D>;
  return (size_t)(C::BR + C::BC) * (D + 4 + DV + 4) +
         2 * C::BC * (C::BR + 4) + 2 * C::BC;
}

// 2. dk and dv: BR keys a block against query tiles of BC rows
template <int D, int DV>
__global__ void __launch_bounds__(TileF32<D>::THREADS, TileF32<D>::PER_SM)
bwd_dkdv_f32(const Args a) {
  using C = TileF32<D>;
  constexpr int BR = C::BR, BC = C::BC, TY = C::TY, NT = C::THREADS;
  constexpr int PP = BR + 4;
  extern __shared__ float smem[];
  float* Ks = smem;                      // BR x (D + 4)
  float* Vs = Ks + BR * (D + 4);         // BR x (DV + 4)
  float* Qs = Vs + BR * (DV + 4);        // BC x (D + 4)
  float* dOs = Qs + BC * (D + 4);        // BC x (DV + 4)
  float* Pt = dOs + BC * (DV + 4);       // BC x PP: P^T by query
  float* dSt = Pt + BC * PP;             // BC x PP
  float* st = dSt + BC * PP;             // lse2, delta: 2 x BC
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int per = a.B * a.Hkv * a.splits, id = blockIdx.x;
  const int kt = id / per, rem = id % per;
  const int split = rem % a.splits, kvh = (rem / a.splits) % a.Hkv;
  const int b = rem / (a.splits * a.Hkv);
  const int k0 = kt * BR, Gs = a.G / a.splits, h0 = kvh * a.G + split * Gs;
  load_tile<D>(Ks, static_cast<const float*>(a.k) + b * a.ks.b +
                       kvh * a.ks.h, a.ks.s, k0, BR, a.Tk, tid, NT);
  load_tile<DV>(Vs, static_cast<const float*>(a.v) + b * a.vs.b +
                        kvh * a.vs.h, a.vs.s, k0, BR, a.Tk, tid, NT);

  float acc_k[4][D / 16], acc_v[4][DV / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc_k[r][c] = 0.f;
#pragma unroll
    for (int c = 0; c < DV / 16; ++c) acc_v[r][c] = 0.f;
  }
  const int qs0 = a.causal ? max(0, k0 - a.q_offset) / BC : 0;
  for (int g = 0; g < Gs; ++g) {
    const int h = h0 + g;
    const float* qb =
        static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
    const float* db =
        static_cast<const float*>(a.dout) + b * a.dos.b + h * a.dos.h;
    const float* lse = a.lse + ((size_t)b * a.H + h) * a.Sp;
    const float* dl = a.delta + ((size_t)b * a.H + h) * a.Sp;
    for (int q0 = qs0 * BC; q0 < a.S; q0 += BC) {
      __syncthreads();   // the last tile's Qs, dOs, Pt and dSt read
      load_tile<D>(Qs, qb, a.qs.s, q0, BC, a.S, tid, NT);
      load_tile<DV>(dOs, db, a.dos.s, q0, BC, a.S, tid, NT);
      if (tid < BC) {
        st[tid] = lse[q0 + tid];
        st[BC + tid] = dl[q0 + tid];
      }
      cp_async_wait();
      __syncthreads();
      // S^T and dP^T: keys ty + TY r, queries tx + 16 c
      float s[4][C::RN], dp[4][C::RN];
      dots<D, 4, C::RN>(s, Ks, ty, TY, Qs, tx);
      dots<DV, 4, C::RN>(dp, Vs, ty, TY, dOs, tx);
#pragma unroll
      for (int c = 0; c < C::RN; ++c) {
        const int qi = tx + 16 * c;
        const float ls = st[qi], de = st[BC + qi];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = k0 + ty + TY * r;
          float p = sm90::ex2(fmaf(s[r][c], a.scale_log2, -ls));
          if (a.causal && key > a.q_offset + q0 + qi) p = 0.f;
          Pt[qi * PP + ty + TY * r] = p;
          dSt[qi * PP + ty + TY * r] = p * (dp[r][c] - de);
        }
      }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: keys 4 ty .. 4 ty + 3
#pragma unroll 2
      for (int i = 0; i < BC; ++i) {
        const float4 pw = *reinterpret_cast<const float4*>(Pt + i * PP +
                                                           4 * ty);
        const float4 sw = *reinterpret_cast<const float4*>(dSt + i * PP +
                                                           4 * ty);
        axpy4<DV>(acc_v, pw, dOs + i * (DV + 4), tx);
        axpy4<D>(acc_k, sw, Qs + i * (D + 4), tx);
      }
    }
  }

  const int key0 = k0 + 4 * ty;
  if (a.splits == 1) {
    store4<float, D>(static_cast<float*>(a.dk) + b * a.dks.b +
                         kvh * a.dks.h, a.dks.s, key0, a.Tk, acc_k, tx,
                     a.scale);
    store4<float, DV>(static_cast<float*>(a.dv) + b * a.dvs.b +
                          kvh * a.dvs.h, a.dvs.s, key0, a.Tk, acc_v, tx,
                      1.f);
  } else {
    float* p = a.part + ((size_t)(b * a.Hkv + kvh) * a.splits + split) *
                            a.Tk * (D + DV);
    store4<float, D>(p, D + DV, key0, a.Tk, acc_k, tx, 1.f);
    store4<float, DV>(p + D, D + DV, key0, a.Tk, acc_v, tx, 1.f);
  }
}

template <int D, int DV>
constexpr size_t dq_f32_floats() {
  using C = TileF32<D>;
  return (size_t)(C::BR + C::BC) * (D + 4 + DV + 4) +
         C::BC * (C::BR + 4) + 2 * C::BR;
}

// 3. dq: BR query rows a block against key tiles of BC keys
template <int D, int DV>
__global__ void __launch_bounds__(TileF32<D>::THREADS, TileF32<D>::PER_SM)
bwd_dq_f32(const Args a) {
  using C = TileF32<D>;
  constexpr int BR = C::BR, BC = C::BC, TY = C::TY, NT = C::THREADS;
  constexpr int PP = BR + 4;
  extern __shared__ float smem[];
  float* Qs = smem;                      // BR x (D + 4)
  float* dOs = Qs + BR * (D + 4);        // BR x (DV + 4)
  float* Ks = dOs + BR * (DV + 4);       // BC x (D + 4)
  float* Vs = Ks + BC * (D + 4);         // BC x (DV + 4)
  float* dSt = Vs + BC * (DV + 4);       // BC x PP: dS by key
  float* st = dSt + BC * PP;             // lse2, delta: 2 x BR
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  load_tile<D>(Qs, static_cast<const float*>(a.q) + b * a.qs.b +
                       h * a.qs.h, a.qs.s, q0, BR, a.S, tid, NT);
  load_tile<DV>(dOs, static_cast<const float*>(a.dout) + b * a.dos.b +
                         h * a.dos.h, a.dos.s, q0, BR, a.S, tid, NT);
  if (tid < BR) {
    st[tid] = a.lse[((size_t)b * a.H + h) * a.Sp + q0 + tid];
    st[BR + tid] = a.delta[((size_t)b * a.H + h) * a.Sp + q0 + tid];
  }
  const float* kb =
      static_cast<const float*>(a.k) + b * a.ks.b + kvh * a.ks.h;
  const float* vb =
      static_cast<const float*>(a.v) + b * a.vs.b + kvh * a.vs.h;
  float acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[r][c] = 0.f;
  const int q_last = min(q0 + BR, a.S) - 1;
  const int kend = a.causal ? min(a.Tk, a.q_offset + q_last + 1) : a.Tk;
  for (int k0 = 0; k0 < kend; k0 += BC) {
    __syncthreads();   // the last tile's Ks, Vs and dSt read
    load_tile<D>(Ks, kb, a.ks.s, k0, BC, a.Tk, tid, NT);
    load_tile<DV>(Vs, vb, a.vs.s, k0, BC, a.Tk, tid, NT);
    cp_async_wait();
    __syncthreads();
    // S and dP: queries ty + TY r, keys tx + 16 c
    float s[4][C::RN], dp[4][C::RN];
    dots<D, 4, C::RN>(s, Qs, ty, TY, Ks, tx);
    dots<DV, 4, C::RN>(dp, dOs, ty, TY, Vs, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = ty + TY * r;
      const float ls = st[qi], de = st[BR + qi];
#pragma unroll
      for (int c = 0; c < C::RN; ++c) {
        const int key = k0 + tx + 16 * c;
        float p = sm90::ex2(fmaf(s[r][c], a.scale_log2, -ls));
        if (key >= a.Tk || (a.causal && key > a.q_offset + q0 + qi))
          p = 0.f;
        dSt[(tx + 16 * c) * PP + qi] = p * (dp[r][c] - de);
      }
    }
    __syncthreads();
    // dQ += dS K: query rows 4 ty .. 4 ty + 3
#pragma unroll 2
    for (int j = 0; j < BC; ++j) {
      const float4 w = *reinterpret_cast<const float4*>(dSt + j * PP +
                                                        4 * ty);
      axpy4<D>(acc, w, Ks + j * (D + 4), tx);
    }
  }
  store4<float, D>(static_cast<float*>(a.dq) + b * a.dqs.b + h * a.dqs.h,
                   a.dqs.s, q0 + 4 * ty, a.S, acc, tx, a.scale);
}

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D, int DV>
int launch_sum(const Args& a, cudaStream_t stream) {
  if (a.splits == 1) return 0;
  const long long n = (long long)a.B * a.Hkv * a.Tk * ((D + DV) / 4);
  const int blocks = (int)min((n + 255) / 256, (long long)SM_COUNT * 8);
  bwd_sum<T, D, DV><<<blocks, 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_f32(const Args& a, cudaStream_t stream) {
  using C = TileF32<D>;
  const size_t sb = (size_t)2 * 64 * (D + 4) * sizeof(float);
  const size_t kb = dkdv_f32_floats<D, DV>() * sizeof(float);
  const size_t qb = dq_f32_floats<D, DV>() * sizeof(float);
  cudaError_t e;
  if ((e = allow_smem(bwd_stats_f32<D, DV>, sb)) ||
      (e = allow_smem(bwd_dkdv_f32<D, DV>, kb)) ||
      (e = allow_smem(bwd_dq_f32<D, DV>, qb)))
    return (int)e;
  bwd_stats_f32<D, DV><<<dim3(a.Sp / 64, a.H, a.B), 256, sb, stream>>>(a);
  if ((e = cudaGetLastError())) return (int)e;
  const int k_tiles = (a.Tk + C::BR - 1) / C::BR;
  bwd_dkdv_f32<D, DV><<<k_tiles * a.B * a.Hkv * a.splits, C::THREADS, kb,
                        stream>>>(a);
  if ((e = cudaGetLastError())) return (int)e;
  int err = launch_sum<float, D, DV>(a, stream);
  if (err) return err;
  bwd_dq_f32<D, DV><<<dim3((a.S + C::BR - 1) / C::BR, a.H, a.B),
                      C::THREADS, qb, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- the bf16 instance: wgmma tensor cores fed by TMA rings -------------

namespace hopper {

using namespace sm90;

constexpr int THREADS = 384;       // a producer and two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int STAGES = 2;

// shared-memory geometry of a tile of ROWS rows of width D: NB column
// blocks of INNER columns (one TMA box each), rows of ROWB bytes,
// swizzled over ROWB (the widest swizzle a box can take)
template <int D, int ROWS>
struct Geo {
  static constexpr int INNER = D < 64 ? D : 64;
  static constexpr int ROWB = 2 * INNER;               // 32, 64 or 128
  static constexpr int NB = D / INNER;
  static constexpr int BLOCK = ROWS * ROWB;            // bytes a column block
  static constexpr int TILE = NB * BLOCK;              // bytes a tile
  static constexpr uint32_t SWZ = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
};

// d (64 x N) = A (64 x W) B^T (W x N): A the 64 rows at `sa` of an
// RA-row tile, B the N rows of an RB-row tile at `sb`, both K-major; W /
// 16 k-steps of 32 bytes along a swizzled row, then the next column block
template <int W, int N, int RA, int RB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint32_t sa,
                                       uint32_t sb) {
  using GA = Geo<W, RA>;
  using GB = Geo<W, RB>;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const int cb = kk / (GA::INNER / 16), in = (kk % (GA::INNER / 16)) * 32;
    wgmma_ss<N>(d, desc(sa + cb * GA::BLOCK + in, 16, 8 * GA::ROWB, GA::SWZ),
                desc(sb + cb * GB::BLOCK + in, 16, 8 * GB::ROWB, GB::SWZ),
                kk > 0);
  }
}

// d (64 x W) += A (64 x K) B (K x W): A bf16 fragments in registers, B
// the K rows of a tile at `sb` read MN-major (16 rows a step; its column
// blocks LBO apart)
template <int W, int K>
__device__ __forceinline__ void mma_rs(float (&d)[W / 2],
                                       const uint32_t (&a)[K / 16][4],
                                       uint32_t sb) {
  using G = Geo<W, K>;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<W>(d, a[kk],
                desc(sb + kk * 16 * G::ROWB, G::BLOCK, 8 * G::ROWB, G::SWZ), 1);
}

// an m64nN f32 fragment rounded to bf16 as the A operand of N / 16 k-steps
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&p)[N / 16][4],
                                     const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// TMA boxes of one tile: NB boxes of (INNER, ROWS) at row r of head h
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* m,
                                         uint32_t bar, int r, int h, int b) {
  using G = Geo<D, ROWS>;
#pragma unroll
  for (int c = 0; c < G::NB; ++c)
    tma_load_4d(dst + c * G::BLOCK, m, bar, c * G::INNER, r, h, b);
}

// the element (row, column) of fragment index i for thread t of a
// warpgroup (PTX's wgmma D layout)
__device__ __forceinline__ int frag_row(int t, int i) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int frag_col(int t, int i) {
  return 8 * (i / 4) + 2 * (t % 4) + i % 2;
}

// ---- 1. lse2 and delta -------------------------------------------------

template <int D, int DV>
struct StatsSm {
  using G = Geo<D, 128>;
  static constexpr int SK = G::TILE;                       // after Q
  static constexpr int BAR = SK + STAGES * G::TILE;
  static constexpr size_t BYTES = 1024 + BAR + (1 + 2 * STAGES) * 8;
};

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
bwd_stats_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk, const Args a,
               int q_tiles) {
  using G = Geo<D, 128>;
  using Sm = StatsSm<D, DV>;
  constexpr int BK = 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + Sm::SK;
  const uint32_t bar_q = base + Sm::BAR, full = bar_q + 8,
                 empty = full + 8 * STAGES;
  const int id = blockIdx.x, bh = a.B * a.H;
  const int q0 = (q_tiles - 1 - id / bh) * 128;
  const int h = id % a.H, b = (id % bh) / a.H;
  const int q_last = min(q0 + 128, a.S) - 1;
  const int kend = a.causal ? min(a.Tk, a.q_offset + q_last + 1) : a.Tk;
  const int n = (kend + BK - 1) / BK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    setmaxnreg_dec<24>();
    if (tid == 0 && n > 0) {
      mbar_expect_tx(bar_q, G::TILE);
      tma_tile<D, 128>(sQ, &tq, bar_q, q0, h, b);
      for (int j = 0; j < n; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty + 8 * s, ((j / STAGES) - 1) & 1);
        mbar_expect_tx(full + 8 * s, G::TILE);
        tma_tile<D, 128>(sK + s * G::TILE, &tk, full + 8 * s, j * BK,
                         h / a.G, b);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int cw = tid / 128 - 1, t = tid % 128, lane = t % 32;
    const int row0 = q0 + 64 * cw + frag_row(t, 0);
    const uint32_t sq = sQ + 64 * cw * G::ROWB;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float s[64];
    if (n > 0) mbar_wait(bar_q, 0);
    for (int j = 0; j < n; ++j) {
      const int st = j % STAGES, k0 = j * BK;
      mbar_wait(full + 8 * st, (j / STAGES) & 1);
      wgmma_fence();
      mma_ss<D, 128, 128, 128>(s, sq, sK + st * G::TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(s);
      if (lane == 0) mbar_arrive(empty + 8 * st);
      if (k0 + BK > a.Tk ||
          (a.causal && k0 + BK - 1 > a.q_offset + q0 + 64 * cw)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = k0 + frag_col(t, i);
          const int qpos = a.q_offset + row0 + 8 * ((i / 2) % 2);
          if (key >= a.Tk || (a.causal && key > qpos)) s[i] = -INFINITY;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if ((i / 2) % 2 == r) mx = fmaxf(mx, s[i]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mu = mx == -INFINITY ? 0.f : mx;
        const float neg = -mu * a.scale_log2;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if ((i / 2) % 2 == r) sum += ex2(fmaf(s[i], a.scale_log2, neg));
        l[r] = l[r] * ex2((m[r] - mu) * a.scale_log2) + sum;
        m[r] = mx;
      }
    }
    float* lse = a.lse + ((size_t)b * a.H + h) * a.Sp;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (lane % 4 == 0)
        lse[row] = row < a.S && l[r] > 0.f
                       ? fmaf(m[r], a.scale_log2, log2f(l[r]))
                       : INFINITY;
    }
    delta_rows<__nv_bfloat16, DV>(a, b, h, q0 + 64 * cw, 64, t, 128);
  }
}

// ---- 2. dk and dv ------------------------------------------------------

template <int D, int DV>
struct DkdvSm {
  static constexpr int BQ = D > 128 ? 32 : 64;     // query rows a stage
  using GK = Geo<D, 128>;
  using GV = Geo<DV, 128>;
  using GQ = Geo<D, BQ>;
  using GO = Geo<DV, BQ>;
  static constexpr int SV = GK::TILE;
  static constexpr int SQ = SV + GV::TILE;                 // the ring
  static constexpr int STAGE = GQ::TILE + GO::TILE;        // Q, then dO
  static constexpr int SL = SQ + STAGES * STAGE;           // lse2, delta
  static constexpr int BAR = SL + STAGES * 2 * BQ * 4;
  static constexpr size_t BYTES = 1024 + BAR + (1 + 2 * STAGES) * 8;
};

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo, const Args a) {
  using Sm = DkdvSm<D, DV>;
  using GK = typename Sm::GK;
  using GV = typename Sm::GV;
  using GQ = typename Sm::GQ;
  using GO = typename Sm::GO;
  constexpr int BQ = Sm::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* lsd = reinterpret_cast<const float*>(smem_raw + (base - raw) +
                                                    Sm::SL);
  const uint32_t sK = base, sV = base + Sm::SV, sQ = base + Sm::SQ,
                 sL = base + Sm::SL;
  const uint32_t bar_kv = base + Sm::BAR, full = bar_kv + 8,
                 empty = full + 8 * STAGES;
  const int per = a.B * a.Hkv * a.splits, id = blockIdx.x;
  const int kt = id / per, rem = id % per;
  const int split = rem % a.splits, kvh = (rem / a.splits) % a.Hkv;
  const int b = rem / (a.splits * a.Hkv);
  const int k0 = kt * 128, Gs = a.G / a.splits, h0 = kvh * a.G + split * Gs;
  const int qs0 = a.causal ? max(0, k0 - a.q_offset) / BQ : 0;
  const int nq = max(0, (a.S + BQ - 1) / BQ - qs0), n = Gs * nq;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    setmaxnreg_dec<24>();
    if (tid == 0 && n > 0) {
      mbar_expect_tx(bar_kv, GK::TILE + GV::TILE);
      tma_tile<D, 128>(sK, &tk, bar_kv, k0, kvh, b);
      tma_tile<DV, 128>(sV, &tv, bar_kv, k0, kvh, b);
      for (int it = 0; it < n; ++it) {
        const int h = h0 + it / nq, q0 = (qs0 + it % nq) * BQ;
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * s, ((it / STAGES) - 1) & 1);
        const uint32_t f = full + 8 * s, dst = sQ + s * Sm::STAGE;
        mbar_expect_tx(f, Sm::STAGE + 2 * BQ * 4);
        tma_tile<D, BQ>(dst, &tq, f, q0, h, b);
        tma_tile<DV, BQ>(dst + GQ::TILE, &tdo, f, q0, h, b);
        const size_t row = ((size_t)b * a.H + h) * a.Sp + q0;
        bulk_load(sL + s * 2 * BQ * 4, a.lse + row, BQ * 4, f);
        bulk_load(sL + s * 2 * BQ * 4 + BQ * 4, a.delta + row, BQ * 4, f);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int cw = tid / 128 - 1, t = tid % 128, lane = t % 32;
    const int kw0 = k0 + 64 * cw;
    const uint32_t sk = sK + 64 * cw * GK::ROWB, sv = sV + 64 * cw * GV::ROWB;
    float dk[D / 2], dv[DV / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;
    if (n > 0) mbar_wait(bar_kv, 0);
    for (int it = 0; it < n; ++it) {
      const int q0 = (qs0 + it % nq) * BQ, st = it % STAGES;
      const uint32_t sq = sQ + st * Sm::STAGE, so = sq + GQ::TILE;
      const float* lse = lsd + st * 2 * BQ;
      const float* dl = lse + BQ;
      mbar_wait(full + 8 * st, (it / STAGES) & 1);
      float s[BQ / 2], dp[BQ / 2];
      wgmma_fence();
      mma_ss<D, BQ, 128, BQ>(s, sk, sq);
      mma_ss<DV, BQ, 128, BQ>(dp, sv, so);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(s);
      fence_operand(dp);
      const bool edge = a.causal && kw0 + 63 > a.q_offset + q0;
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int col = frag_col(t, i);
        float p = ex2(fmaf(s[i], a.scale_log2, -lse[col]));
        if (edge && kw0 + frag_row(t, i) > a.q_offset + q0 + col) p = 0.f;
        s[i] = p;
        dp[i] = p * (dp[i] - dl[col]);
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      to_a<BQ>(pa, s);
      to_a<BQ>(da, dp);
      fence_operand(dk);
      fence_operand(dv);
      wgmma_fence();
      mma_rs<DV, BQ>(dv, pa, so);
      mma_rs<D, BQ>(dk, da, sq);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dk);
      fence_operand(dv);
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }

    // rows kw0 + frag_row: to dk and dv, or to this split's partials
    if (a.splits == 1) {
      __nv_bfloat16* kb = static_cast<__nv_bfloat16*>(a.dk) + b * a.dks.b +
                          kvh * a.dks.h;
      __nv_bfloat16* vb = static_cast<__nv_bfloat16*>(a.dv) + b * a.dvs.b +
                          kvh * a.dvs.h;
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int key = kw0 + frag_row(t, i);
        if (key < a.Tk)
          *reinterpret_cast<__nv_bfloat162*>(kb + key * a.dks.s +
                                             frag_col(t, i)) =
              __floats2bfloat162_rn(dk[i] * a.scale, dk[i + 1] * a.scale);
      }
#pragma unroll
      for (int i = 0; i < DV / 2; i += 2) {
        const int key = kw0 + frag_row(t, i);
        if (key < a.Tk)
          *reinterpret_cast<__nv_bfloat162*>(vb + key * a.dvs.s +
                                             frag_col(t, i)) =
              __floats2bfloat162_rn(dv[i], dv[i + 1]);
      }
    } else {
      float* p = a.part + ((size_t)(b * a.Hkv + kvh) * a.splits + split) *
                              a.Tk * (D + DV);
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int key = kw0 + frag_row(t, i);
        if (key < a.Tk)
          *reinterpret_cast<float2*>(p + (size_t)key * (D + DV) +
                                     frag_col(t, i)) =
              make_float2(dk[i], dk[i + 1]);
      }
#pragma unroll
      for (int i = 0; i < DV / 2; i += 2) {
        const int key = kw0 + frag_row(t, i);
        if (key < a.Tk)
          *reinterpret_cast<float2*>(p + (size_t)key * (D + DV) + D +
                                     frag_col(t, i)) =
              make_float2(dv[i], dv[i + 1]);
      }
    }
  }
}

// ---- 3. dq ---------------------------------------------------------------

template <int D, int DV>
struct DqSm {
  static constexpr int BK = 64;                     // keys a stage
  using GQ = Geo<D, 128>;
  using GO = Geo<DV, 128>;
  using GK = Geo<D, BK>;
  using GV = Geo<DV, BK>;
  static constexpr int SO = GQ::TILE;
  static constexpr int SK = SO + GO::TILE;                 // the ring
  static constexpr int STAGE = GK::TILE + GV::TILE;        // K, then V
  static constexpr int BAR = SK + STAGES * STAGE;
  static constexpr size_t BYTES = 1024 + BAR + (1 + 2 * STAGES) * 8;
};

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo, const Args a,
            int q_tiles) {
  using Sm = DqSm<D, DV>;
  using GQ = typename Sm::GQ;
  using GO = typename Sm::GO;
  using GK = typename Sm::GK;
  constexpr int BK = Sm::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sO = base + Sm::SO, sK = base + Sm::SK;
  const uint32_t bar_q = base + Sm::BAR, full = bar_q + 8,
                 empty = full + 8 * STAGES;
  const int id = blockIdx.x, bh = a.B * a.H;
  const int q0 = (q_tiles - 1 - id / bh) * 128;
  const int h = id % a.H, b = (id % bh) / a.H;
  const int q_last = min(q0 + 128, a.S) - 1;
  const int kend = a.causal ? min(a.Tk, a.q_offset + q_last + 1) : a.Tk;
  const int n = (kend + BK - 1) / BK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    setmaxnreg_dec<24>();
    if (tid == 0 && n > 0) {
      mbar_expect_tx(bar_q, GQ::TILE + GO::TILE);
      tma_tile<D, 128>(sQ, &tq, bar_q, q0, h, b);
      tma_tile<DV, 128>(sO, &tdo, bar_q, q0, h, b);
      for (int j = 0; j < n; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty + 8 * s, ((j / STAGES) - 1) & 1);
        const uint32_t f = full + 8 * s, dst = sK + s * Sm::STAGE;
        mbar_expect_tx(f, Sm::STAGE);
        tma_tile<D, BK>(dst, &tk, f, j * BK, h / a.G, b);
        tma_tile<DV, BK>(dst + GK::TILE, &tv, f, j * BK, h / a.G, b);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int cw = tid / 128 - 1, t = tid % 128, lane = t % 32;
    const int row0 = q0 + 64 * cw + frag_row(t, 0);
    const uint32_t sq = sQ + 64 * cw * GQ::ROWB, so = sO + 64 * cw * GO::ROWB;
    const float* lse = a.lse + ((size_t)b * a.H + h) * a.Sp;
    const float* dlt = a.delta + ((size_t)b * a.H + h) * a.Sp;
    const float ls[2] = {lse[row0], lse[row0 + 8]};
    const float de[2] = {dlt[row0], dlt[row0 + 8]};
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    if (n > 0) mbar_wait(bar_q, 0);
    for (int j = 0; j < n; ++j) {
      const int st = j % STAGES, k0 = j * BK;
      const uint32_t sk = sK + st * Sm::STAGE, sv = sk + GK::TILE;
      mbar_wait(full + 8 * st, (j / STAGES) & 1);
      float s[BK / 2], dp[BK / 2];
      wgmma_fence();
      mma_ss<D, BK, 128, BK>(s, sq, sk);
      mma_ss<DV, BK, 128, BK>(dp, so, sv);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(s);
      fence_operand(dp);
      const bool edge = k0 + BK > a.Tk ||
                        (a.causal && k0 + BK - 1 > a.q_offset + q0 + 64 * cw);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i / 2) % 2;
        float p = ex2(fmaf(s[i], a.scale_log2, -ls[r]));
        if (edge) {
          const int key = k0 + frag_col(t, i);
          if (key >= a.Tk || (a.causal && key > a.q_offset + row0 + 8 * r))
            p = 0.f;
        }
        dp[i] = p * (dp[i] - de[r]);
      }
      uint32_t da[BK / 16][4];
      to_a<BK>(da, dp);
      fence_operand(dq);
      wgmma_fence();
      mma_rs<D, BK>(dq, da, sk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dq);
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
    __nv_bfloat16* qb = static_cast<__nv_bfloat16*>(a.dq) + b * a.dqs.b +
                        h * a.dqs.h;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int row = row0 + 8 * ((i / 2) % 2);
      if (row < a.S)
        *reinterpret_cast<__nv_bfloat162*>(qb + row * a.dqs.s +
                                           frag_col(t, i)) =
            __floats2bfloat162_rn(dq[i] * a.scale, dq[i + 1] * a.scale);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the CUDA driver's cuTensorMapEncodeTiled (its 12.0 form), found
// through the runtime, so the library links no -lcuda (needs CUDA 12.5+)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult res;
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &res);
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a 4-D map (D, rows, heads, batch) over a bf16 tensor with the (batch,
// head, row) strides `st` in elements, boxes of (INNER, ROWS, 1, 1), rows
// past `rows` read as zero
template <int D, int ROWS>
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int heads,
                int batch, const Str& st) {
  using G = Geo<D, ROWS>;
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(rows > 0 ? rows : 1),
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {G::INNER, ROWS, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = G::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : G::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DV>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int BQ = DkdvSm<D, DV>::BQ, BK = DqSm<D, DV>::BK;
  CUtensorMap q128, qbq, k128, kbk, v128, vbk, do128, dobq;
  if (!tensor_map<D, 128>(&q128, a.q, a.S, a.H, a.B, a.qs) ||
      !tensor_map<D, BQ>(&qbq, a.q, a.S, a.H, a.B, a.qs) ||
      !tensor_map<D, 128>(&k128, a.k, a.Tk, a.Hkv, a.B, a.ks) ||
      !tensor_map<D, BK>(&kbk, a.k, a.Tk, a.Hkv, a.B, a.ks) ||
      !tensor_map<DV, 128>(&v128, a.v, a.Tk, a.Hkv, a.B, a.vs) ||
      !tensor_map<DV, BK>(&vbk, a.v, a.Tk, a.Hkv, a.B, a.vs) ||
      !tensor_map<DV, 128>(&do128, a.dout, a.S, a.H, a.B, a.dos) ||
      !tensor_map<DV, BQ>(&dobq, a.dout, a.S, a.H, a.B, a.dos))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = allow_smem(bwd_stats_sm90<D, DV>, StatsSm<D, DV>::BYTES)) ||
      (e = allow_smem(bwd_dkdv_sm90<D, DV>, DkdvSm<D, DV>::BYTES)) ||
      (e = allow_smem(bwd_dq_sm90<D, DV>, DqSm<D, DV>::BYTES)))
    return (int)e;
  const int q_tiles = (a.S + 127) / 128, k_tiles = (a.Tk + 127) / 128;
  bwd_stats_sm90<D, DV><<<q_tiles * a.H * a.B, THREADS,
                          StatsSm<D, DV>::BYTES, stream>>>(q128, k128, a,
                                                           q_tiles);
  if ((e = cudaGetLastError())) return (int)e;
  bwd_dkdv_sm90<D, DV><<<k_tiles * a.B * a.Hkv * a.splits, THREADS,
                         DkdvSm<D, DV>::BYTES, stream>>>(qbq, k128, v128,
                                                         dobq, a);
  if ((e = cudaGetLastError())) return (int)e;
  int err = launch_sum<__nv_bfloat16, D, DV>(a, stream);
  if (err) return err;
  bwd_dq_sm90<D, DV><<<q_tiles * a.H * a.B, THREADS, DqSm<D, DV>::BYTES,
                       stream>>>(q128, kbk, vbk, do128, a, q_tiles);
  return (int)cudaGetLastError();
}

}  // namespace hopper

constexpr int widths(int D, int DV) { return D * 1024 + DV; }

// keys a dk/dv block takes: 128 in bf16; the f32 tile's rows
int key_tile(int D, int bf16) {
  return bf16 ? 128 : (D > 128 ? TileF32<192>::BR : TileF32<128>::BR);
}

// splits of the G query heads of a KV head: the largest divisor of G up
// to 4 while the dk/dv grid has fewer than 4 x 132 blocks, else 1
int splits_for(int B, int Hkv, int G, int Tk, int kt) {
  const long long base = (long long)B * Hkv * ((Tk + kt - 1) / kt);
  if (base >= 4 * SM_COUNT) return 1;
  for (int s = 4; s > 1; --s)
    if (G % s == 0) return s;
  return 1;
}

// floats of the workspace: lse2 and delta (2 B H Sp), then the partials
long long workspace_floats(int B, int H, int Hkv, int S, int Tk, int D,
                           int Dv, int bf16, int* splits, int* Sp) {
  *Sp = (S + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  *splits = splits_for(B, Hkv, H / Hkv, Tk, key_tile(D, bf16));
  long long n = 2ll * B * H * *Sp;
  if (*splits > 1) n += (long long)B * Hkv * *splits * Tk * (D + Dv);
  return n;
}

// the registers a thread, dynamic shared memory and resident blocks an
// SM of the instance's stats, dk/dv and dq kernels (9 values) at (D, Dv);
// the bf16 kernels' count is the block's allocation, of which setmaxnreg
// hands the consumer warpgroups 240 a thread and the producer 24
template <typename K>
cudaError_t resources_of(K* kernel, size_t smem, int threads, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e;
  if ((e = allow_smem(kernel, smem)) ||
      (e = cudaFuncGetAttributes(&fa, kernel)) ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                         threads, smem)))
    return e;
  out[0] = fa.numRegs;
  out[1] = (int)smem;
  return cudaSuccess;
}

template <int D, int DV>
int resources(int bf16, int* out) {
  using C = TileF32<D>;
  cudaError_t e;
  if (bf16) {
    using namespace hopper;
    if ((e = resources_of(bwd_stats_sm90<D, DV>, StatsSm<D, DV>::BYTES,
                          THREADS, out)) ||
        (e = resources_of(bwd_dkdv_sm90<D, DV>, DkdvSm<D, DV>::BYTES,
                          THREADS, out + 3)) ||
        (e = resources_of(bwd_dq_sm90<D, DV>, DqSm<D, DV>::BYTES, THREADS,
                          out + 6)))
      return (int)e;
    return 0;
  }
  if ((e = resources_of(bwd_stats_f32<D, DV>,
                        (size_t)2 * 64 * (D + 4) * sizeof(float), 256,
                        out)) ||
      (e = resources_of(bwd_dkdv_f32<D, DV>,
                        dkdv_f32_floats<D, DV>() * sizeof(float), C::THREADS,
                        out + 3)) ||
      (e = resources_of(bwd_dq_f32<D, DV>,
                        dq_f32_floats<D, DV>() * sizeof(float), C::THREADS,
                        out + 6)))
    return (int)e;
  return 0;
}

}  // namespace

extern "C" int saath_flash_attention_bwd_resources(int D, int Dv, int bf16,
                                                   int* out) {
  switch (widths(D, Dv)) {
    case widths(16, 16): return resources<16, 16>(bf16, out);
    case widths(32, 32): return resources<32, 32>(bf16, out);
    case widths(64, 64): return resources<64, 64>(bf16, out);
    case widths(128, 128): return resources<128, 128>(bf16, out);
    case widths(192, 128): return resources<192, 128>(bf16, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// floats of the workspace saath_flash_attention_bwd takes as `stats`
extern "C" long long saath_flash_attention_bwd_workspace(int B, int H,
                                                         int Hkv, int S,
                                                         int Tk, int D,
                                                         int Dv, int bf16) {
  int splits, Sp;
  return workspace_floats(B, H, Hkv, S, Tk, D, Dv, bf16, &splits, &Sp);
}

// the whole backward of one attention call: three launches on `stream`
// (four when the heads are split); stats is an f32 workspace of
// saath_flash_attention_bwd_workspace(...) floats, 16-byte aligned.
// strides: the (batch, head, row) strides of q, k, v, o, do, dq, dk and
// dv in elements (24 values). Returns the first CUDA error (0 on
// success; cudaErrorInvalidValue for a (D, Dv) it is not built for or a
// bf16 tensor that TMA cannot map).
extern "C" int saath_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* stats, int B,
    int H, int Hkv, int S, int Tk, int D, int Dv, const long long* st,
    float scale, int causal, int q_offset, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.G = H / Hkv;
  a.S = S;
  a.Tk = Tk;
  workspace_floats(B, H, Hkv, S, Tk, D, Dv, bf16, &a.splits, &a.Sp);
  a.lse = stats;
  a.delta = stats + (size_t)B * H * a.Sp;
  a.part = a.splits > 1 ? stats + 2 * (size_t)B * H * a.Sp : nullptr;
  Str* strs[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos, &a.dqs, &a.dks, &a.dvs};
  for (int i = 0; i < 8; ++i) *strs[i] = Str{st[3 * i], st[3 * i + 1],
                                             st[3 * i + 2]};
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  a.causal = causal;
  a.q_offset = q_offset;
#define K7_CASE(d, dv)                                              \
  case widths(d, dv):                                               \
    return bf16 ? hopper::launch<d, dv>(a, s) : launch_f32<d, dv>(a, s);
  switch (widths(D, Dv)) {
    K7_CASE(16, 16)
    K7_CASE(32, 32)
    K7_CASE(64, 64)
    K7_CASE(128, 128)
    K7_CASE(192, 128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K7_CASE
}
