// Backward of the Mamba-2 SSD chunked scan on Hopper (sm_90a): kernel K8.
//
// The JAX package's train step differentiates the chunked scan
// (repro/models/mamba.py:18, ssd_chunked_jnp) with jax.value_and_grad;
// its Pallas forward (repro/kernels/ssd_scan.py:73), which K4 replaces,
// has no backward. K8 is the port's counterpart of that derived gradient:
// given the forward's inputs x (B, L, H, Dh), dt (B, L, H), a (H,) f32,
// b and c (B, L, G, N) and the gradient dy of y, it returns dx, ddt, db,
// dc in the inputs' type and da in f32, with no initial state and no
// gradient of the final state (a train step has neither). Per chunk of
// lc rows, with cum the inclusive cumsum of dt a, L_tu = exp(cum_t -
// cum_u) [u <= t], G = c b^T, M = G * L * dt_u, w = exp(cl - cum) dt,
// e = exp(cum), cl = cum's last, S the state at the chunk's start and dS
// the gradient of the state at its end:
//
//     dM = dY X^T (lower half),  dG = dM * L * dt_u
//     dX = M^T dY + diag(w) B dS^T
//     dC = dG B + diag(e) dY S,  dB = dG^T C + diag(w) X dS
//     dS(previous chunk) = exp(cl) dS + (diag(e) dY)^T C
//
// and dt, a through cum, M and w (ref.ssd_chunked_bwd_ref spells it out).
//
// Bound on this card (67 TFLOP/s f32, 989 bf16 on the tensor cores, 3.35
// TB/s): the function's multiply-adds are, per (batch, group, chunk), the
// causal halves (lc^2 / 2 x N each) of G = c b^T and of dG B and dG^T C
// (B and C belong to the group, so dC's and dB's dG terms are products of
// the heads' dG sum), and per (batch, head, chunk) the causal halves of
// dM and M^T dY (lc^2 / 2 x Dh each) and five lc x Dh x N products: the
// chunk's state update (x w)^T b, its state-gradient update (e dY)^T c,
// B dS^T, dY S and X dS. At Mamba2-1.3B's train shape (B 4, L 2048, H
// 64, G 1, Dh 64, N 128, lc 128) that is 26.0 G multiply-adds: 0.71 ms in
// bf16 (G and dM, products of the inputs alone, at the tensor-core rate;
// the rest, with f32 operands, at 67 TFLOP/s), 0.78 ms in f32; its bytes
// (inputs and outputs once, bf16) about 0.08 ms. At Jamba's microbatch
// shape (1, 1024, 128, 1, 64, 16, 128) 0.037 ms in bf16.
// `chip_smoke.ssd_bwd_bound_ms` counts them from the inputs.
//
// Design. Every product is f32 on the CUDA cores (ROADMAP's float policy:
// M, dG, S, dS and the weighted rows are f32; G and dM could go onto the
// tensor cores in bf16, but they are 9% of the work). Four launches:
//
//  1. ssd_bwd_states: one block per (batch, chunk, head, 64 head columns)
//     forms the chunk's own state update sum_u w_u x_u b_u^T and its
//     state-gradient update sum_t e_t dy_t c_t^T, stacked as one 128-row
//     output (rows 0..63 read the b panel, rows 64..127 the c panel), into
//     f32 workspaces (B, nch, H, Dh, N), and exp(cl); further blocks form
//     G = c b^T once per (batch, chunk, group) into an f32 scratch that
//     stays in L2 (its strictly upper quarter skipped).
//  2. ssd_bwd_pass: the state pass, element-wise and sequential over the
//     chunks (S' = exp(cl) S + update, in place: each slot ends holding
//     the state at its chunk's start; dS likewise in reverse, each slot
//     ending with the gradient of its chunk's end state), one thread per
//     4 state elements running both directions, so that it also sums
//     each chunk's <dS, S> (a term of dcum) over its block. Bandwidth
//     only: the decomposition of Mamba-2's own published backward (chunk
//     state, state passing, chunk scan).
//  3. ssd_bwd_chunk: one block per (batch, chunk, group, split of the
//     group's heads), at most HS = 8 heads a block. dG B and dG^T C are
//     formed once per block from the heads' sum of dG (B and C belong to
//     the group), and the heads' X dS terms are one product over the
//     stacked heads, so db and dc come out summed over the block's heads.
//     Per head: dM = dY X^T (the strictly upper quarter skipped; G comes
//     from L2 by cp.async into the thread's own slots while it runs),
//     then M, dG (added into the block's sum) and the dcum row and column
//     sums in its epilogue; dX = w * (B dS^T) + M^T dY (a thread's row
//     group skips the k-panels wholly before its rows). Then per head dY
//     S (rows scaled by e) for dc and the e term of dcum; each head's
//     reverse cumsum, ddt and da's partial are one warp's fixed-order
//     scan, the block's heads on parallel warps. Last dC = sum(e dY S) +
//     dG_sum B and dB = dG_sum^T C + sum_h (w X_h) dS_h (causal k-panels
//     skipped likewise). The launches issue more than the bound counts:
//     dG B and dG^T C once per split, not per group, the causal skips by
//     16-row panels and 4-row groups, the first and last chunks' empty
//     state products. The two lc x lc f32 matrices (M of the head, the
//     heads' dG sum; 128 KB of the block's 200 KB) hold one block an SM,
//     255 registers a thread.
//  4. ssd_bwd_reduce sums the splits' f32 db and dc partials in split
//     order (when a group has more than one split) and da's partials in
//     (batch, chunk) order, and casts.
//
// The products run on one engine: a 128 x NW output tile, 256 threads
// with register tiles of 8 x 8 (NW 128), 8 x 4 (NW 64) or 2 x 4 (NW 16),
// over k-panels of KP = 16 rows in double-buffered shared memory. Operand
// loads are 16-byte vectors (a scalar fallback for an unaligned view or a
// ragged edge) issued into registers before the current panel is
// multiplied and stored, converted once to f32 (and transposed or scaled
// where the product wants it), after it: the next panel's loads are in
// flight during the products, and one barrier a panel hands the buffers
// over. The panels are staged through registers, not by cp.async or TMA,
// because most of them must be transposed (an operand whose k is its
// contiguous axis) or converted from bf16 on the way into shared memory,
// which a copy engine cannot do; G, which needs neither, comes by
// cp.async. State tiles are chosen by N: instances at N <= 16 (NW 16) and
// N <= 128 (NW 128).
//
// No float atomics: every output element has one owner and one order of
// sums, so two calls give the same bits. Rows past L read as zeros (the
// forward's zero padding: dt = 0 there) and are not written.
//
// Workspaces (f32, allocated by the caller, `saath_ssd_scan_bwd_workspace`):
// the state updates and their gradients (B, nch, H, Dh, N) each, G (B,
// nch, G, 128, 128), exp's argument cl (B, nch, H), da's partials (B,
// nch, H), the state pass's parts of each <dS, S> (B, nch, H, parts), and
// with more than one split a group the splits' db and dc (nsp, B, L, G,
// N) each: 134 + 134 + 4.2 + 67 MB at Mamba2-1.3B's train shape (340 MB
// in all), 17 MB at Jamba's.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LCMAX = 128;   // chunk rows
constexpr int NMAX = 128;    // state columns
constexpr int KP = 16;       // k rows of one staged panel
constexpr int PW = 128;      // row stride of panels and lc x lc tiles (floats)
constexpr int HS = 8;        // heads of one group a chunk block owns, at most
constexpr int DTILE = 64;    // head columns of a dX tile and of a state tile
// chunk blocks aimed at (about four waves of one block an SM)
constexpr int TARGET_BLOCKS = 512;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The raw bits of one element, and element e of a 16-byte vector as f32
// (a bf16 is the upper half of an f32)
__device__ __forceinline__ unsigned bits_of(const float* p) {
  return __float_as_uint(*p);
}
__device__ __forceinline__ unsigned bits_of(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}
__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
template <typename S> __device__ __forceinline__ float unpack(const uint4& v,
                                                             int e);
template <> __device__ __forceinline__ float unpack<float>(const uint4& v,
                                                          int e) {
  return __uint_as_float(word(v, e));
}
template <>
__device__ __forceinline__ float unpack<__nv_bfloat16>(const uint4& v,
                                                       int e) {
  const unsigned w = word(v, e >> 1);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// 16 bytes from p, of which the first n elements (n < 16 / sizeof(S)
// included) are data and the rest read as 0: one vector load where all
// are data and p is 16-byte aligned, else element by element.
template <typename S>
__device__ __forceinline__ uint4 load16(const S* p, int n) {
  constexpr int VW = 16 / sizeof(S);
  if (n >= VW && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return __ldg(reinterpret_cast<const uint4*>(p));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < VW; ++e)
    if (e < n) {
      if constexpr (sizeof(S) == 4)
        w[e] = bits_of(p + e);
      else
        w[e >> 1] |= bits_of(p + e) << (16 * (e & 1));
    }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 4 consecutive elements from p as f32, the first n of them data
template <typename S>
__device__ __forceinline__ float4 load4(const S* p, int n) {
  float v[4];
  if constexpr (sizeof(S) == 4) {
    if (n >= 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
      return *reinterpret_cast<const float4*>(p);
  } else {
    if (n >= 4 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      return make_float4(__uint_as_float(u.x << 16),
                         __uint_as_float(u.x & 0xffff0000u),
                         __uint_as_float(u.y << 16),
                         __uint_as_float(u.y & 0xffff0000u));
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = e < n ? to_f(p[e]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// v's first n (of 4) elements to p, in T
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v, int n) {
  if constexpr (sizeof(T) == 4) {
    if (n >= 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      *reinterpret_cast<float4*>(p) = v;
      return;
    }
  } else {
    if (n >= 4 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
      *reinterpret_cast<uint2*>(p) =
          make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
      return;
    }
  }
  const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < n) p[e] = from_f<T>(f[e]);
}

// One operand's k-panel (KP k-rows x PWL columns, row stride PW in shared
// memory), staged through registers: load(k0) issues the 16-byte global
// loads of the panel that starts at k-row k0 and holds their raw bits;
// store(P, k0) converts them to f32, times the optional scale, into P.
// TRANS: the global matrix is (column r, k) with k contiguous (element at
// p[r ld + k]), so the panel is its transpose; else (k, column r) with
// the columns contiguous (p[k ld + r]). Columns r >= R and k-rows k >= K
// read as 0. scale (shared memory): by column when TRANS, else by k-row.
template <typename S, bool TRANS, int PWL>
struct Panel {
  static constexpr int VW = 16 / sizeof(S);
  static constexpr int NJOB = KP * PWL / VW;
  static constexpr int NREG = (NJOB + THREADS - 1) / THREADS;
  const S* p;
  long long ld;
  int R, K;
  const float* scale;
  uint4 raw[NREG];

  __device__ __forceinline__ Panel(const S* p_, long long ld_, int R_, int K_,
                                   const float* scale_)
      : p(p_), ld(ld_), R(R_), K(K_), scale(scale_) {}

  __device__ __forceinline__ void load(int k0) {
#pragma unroll
    for (int s = 0; s < NREG; ++s) {
      const int q = threadIdx.x + s * THREADS;
      raw[s] = make_uint4(0u, 0u, 0u, 0u);
      if (q < NJOB) {
        if (TRANS) {
          const int r = q % PWL, k = k0 + (q / PWL) * VW;
          if (r < R && k < K) raw[s] = load16(p + r * ld + k, K - k);
        } else {
          const int k = k0 + q / (PWL / VW), r = (q % (PWL / VW)) * VW;
          if (k < K && r < R) raw[s] = load16(p + k * ld + r, R - r);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* P, int k0) const {
#pragma unroll
    for (int s = 0; s < NREG; ++s) {
      const int q = threadIdx.x + s * THREADS;
      if (q < NJOB) {
        if (TRANS) {
          const int r = q % PWL, kk = (q / PWL) * VW;
          const float f = scale ? scale[r] : 1.f;
#pragma unroll
          for (int e = 0; e < VW; ++e)
            P[(kk + e) * PW + r] = f * unpack<S>(raw[s], e);
        } else {
          const int kk = q / (PWL / VW), r = (q % (PWL / VW)) * VW;
          const float f = scale ? scale[k0 + kk] : 1.f;
#pragma unroll
          for (int e = 0; e < VW; e += 4)
            *reinterpret_cast<float4*>(P + kk * PW + r + e) = make_float4(
                f * unpack<S>(raw[s], e), f * unpack<S>(raw[s], e + 1),
                f * unpack<S>(raw[s], e + 2), f * unpack<S>(raw[s], e + 3));
        }
      }
    }
  }
};

// The threads' register tiles of a 128 x NW output: TX threads along the
// columns, each owning TM rows (row groups of RG: rows 4 ty .. 4 ty + 3
// and 64 + the same for TM 8, rows 2 ty and 2 ty + 1 for TM 2) and TN
// columns (groups of 4: 4 tx .. 4 tx + 3, and 64 + the same for TN 8).
template <int NW>
struct Lay {
  static constexpr int TX = NW == 16 ? 4 : 16;
  static constexpr int TM = NW == 16 ? 2 : 8;
  static constexpr int TN = NW == 128 ? 8 : 4;
  static constexpr int RG = TM == 8 ? 4 : 2;
  static constexpr int NG = TM / RG;
  static constexpr int NC = TN / 4;
  __device__ static __forceinline__ int ty() { return threadIdx.x / TX; }
  __device__ static __forceinline__ int tx() { return threadIdx.x % TX; }
  __device__ static __forceinline__ int row0(int g) {
    return TM == 8 ? 4 * ty() + 64 * g : 2 * ty();
  }
  __device__ static __forceinline__ int row(int i) {
    return row0(i / RG) + i % RG;
  }
  __device__ static __forceinline__ int col0(int c) {
    return 4 * tx() + 64 * c;
  }
};

template <int NW>
__device__ __forceinline__ void zero(float (&acc)[Lay<NW>::TM][Lay<NW>::TN]) {
#pragma unroll
  for (int i = 0; i < Lay<NW>::TM; ++i)
#pragma unroll
    for (int j = 0; j < Lay<NW>::TN; ++j) acc[i][j] = 0.f;
}

// the sum of v over the TX lanes that share a row (fixed order)
template <int NW>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = Lay<NW>::TX / 2; o >= 1; o >>= 1)
    v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// acc += A B over one panel of KP k-rows. AM 0: A[k][m] at A + k lda (a
// panel or a resident matrix); AM 1: A[m][k] at A + m lda (a resident
// matrix read along its rows). B[k][n] at B0 + k PW; with DUAL the rows
// from 64 on read B1 instead. live[g]: row group g takes part. TRI: the
// rows below 64 skip the columns from 64 on (the strictly upper quarter
// of a causal lc x lc product).
template <int NW, int AM, bool DUAL, bool TRI>
__device__ __forceinline__ void mma_panel(
    float (&acc)[Lay<NW>::TM][Lay<NW>::TN], const float* A, int lda,
    const float* B0, const float* B1, const bool (&live)[Lay<NW>::NG]) {
  using Ly = Lay<NW>;
  constexpr int TM = Ly::TM, TN = Ly::TN, RG = Ly::RG, NG = Ly::NG;
  constexpr int NC = Ly::NC;
#pragma unroll
  for (int k4 = 0; k4 < KP; k4 += 4) {
    float a4[TM][4];
    if (AM == 1) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(A + Ly::row(i) * lda + k4);
        a4[i][0] = v.x;
        a4[i][1] = v.y;
        a4[i][2] = v.z;
        a4[i][3] = v.w;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k4 + q;
      float a[TM];
      if (AM == 0) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float* pa = A + k * lda + Ly::row0(g);
          if (RG == 4) {
            const float4 v = *reinterpret_cast<const float4*>(pa);
            a[RG * g] = v.x;
            a[RG * g + 1] = v.y;
            a[RG * g + 2] = v.z;
            a[RG * g + 3] = v.w;
          } else {
            const float2 v = *reinterpret_cast<const float2*>(pa);
            a[RG * g] = v.x;
            a[RG * g + 1] = v.y;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = a4[i][q];
      }
      float b[NG][TN];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (g == 0 || DUAL) {
          const float* pb =
              (DUAL && Ly::row0(g) >= 64 ? B1 : B0) + k * PW;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float4 v =
                *reinterpret_cast<const float4*>(pb + Ly::col0(c));
            b[g][4 * c] = v.x;
            b[g][4 * c + 1] = v.y;
            b[g][4 * c + 2] = v.z;
            b[g][4 * c + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j) b[g][j] = b[0][j];
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int g = i / RG;
        if (!live[g]) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if (TRI && g == 0 && j >= 4) continue;
          acc[i][j] = fmaf(a[i], b[g][j], acc[i][j]);
        }
      }
    }
  }
}

// acc += A B with both operands staged from global memory (A: columns =
// output rows, B: columns = output columns), over K k-rows: the
// double-buffered pipeline of panels (sa, sb: 2 x KP x PW each). loaded:
// the caller has issued both operands' load(0) already. Ends with a
// barrier.
template <int NW, bool TRI, class PA, class PB>
__device__ __forceinline__ void gemm_ss(
    float (&acc)[Lay<NW>::TM][Lay<NW>::TN], PA& pa, PB& pb, int K, float* sa,
    float* sb, bool loaded = false) {
  bool live[Lay<NW>::NG];
#pragma unroll
  for (int g = 0; g < Lay<NW>::NG; ++g) live[g] = true;
  const int np = (K + KP - 1) / KP;
  if (!loaded) {
    pa.load(0);
    pb.load(0);
  }
  pa.store(sa, 0);
  pb.store(sb, 0);
  __syncthreads();
  for (int p = 0; p < np; ++p) {
    const int cur = p & 1, k1 = (p + 1) * KP;
    if (p + 1 < np) {
      pa.load(k1);
      pb.load(k1);
    }
    mma_panel<NW, 0, false, TRI>(acc, sa + cur * KP * PW, PW,
                                 sb + cur * KP * PW, nullptr, live);
    if (p + 1 < np) {
      pa.store(sa + (cur ^ 1) * KP * PW, k1);
      pb.store(sb + (cur ^ 1) * KP * PW, k1);
    }
    __syncthreads();
  }
}

// acc += A B with A a resident lc x lc matrix in shared memory (row
// stride PW; AM as in mma_panel) and B staged from global memory, over K
// k-rows. CAUS 1: only k >= the output row contributes (row groups whose
// first row is past the panel's last k skip it); CAUS 2: only k <= the
// row. Ends with a barrier.
template <int NW, int AM, int CAUS, class PB>
__device__ __forceinline__ void gemm_rs(
    float (&acc)[Lay<NW>::TM][Lay<NW>::TN], const float* A, PB& pb, int K,
    float* sb) {
  using Ly = Lay<NW>;
  const int np = (K + KP - 1) / KP;
  pb.load(0);
  pb.store(sb, 0);
  __syncthreads();
  for (int p = 0; p < np; ++p) {
    const int cur = p & 1, k0 = p * KP, k1 = k0 + KP;
    if (p + 1 < np) pb.load(k1);
    bool live[Ly::NG];
#pragma unroll
    for (int g = 0; g < Ly::NG; ++g)
      live[g] = CAUS == 0 ||
                (CAUS == 1 ? Ly::row0(g) <= k1 - 1
                           : Ly::row0(g) + Ly::RG - 1 >= k0);
    mma_panel<NW, AM, false, false>(acc, AM == 0 ? A + k0 * PW : A + k0, PW,
                                    sb + cur * KP * PW, nullptr, live);
    if (p + 1 < np) pb.store(sb + (cur ^ 1) * KP * PW, k1);
    __syncthreads();
  }
}

// One warp: dt of the chunk's rows (0 past nv), the inclusive cumsum of
// dt a (lane-serial over four rows, then a scan of the lane totals), w =
// exp(cl - cum) dt and e = exp(cum) (0 past lc). Ends with __syncwarp.
template <typename T>
__device__ __forceinline__ void head_scan(const T* dtb, int H, float ah,
                                          int lc, int nv, float* cum,
                                          float* dtv, float* wv, float* ev) {
  const int lane = threadIdx.x & 31;
  float d[4], v[4], run = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = 4 * lane + i;
    d[i] = u < nv ? to_f(dtb[(long long)u * H]) : 0.f;
    run += d[i] * ah;
    v[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += up;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    cum[4 * lane + i] = incl - run + v[i];
    dtv[4 * lane + i] = d[i];
  }
  __syncwarp();
  const float cl = cum[lc - 1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = 4 * lane + i;
    wv[u] = u < lc ? expf(cl - cum[u]) * d[i] : 0.f;
    ev[u] = u < lc ? expf(cum[u]) : 0.f;
  }
  __syncwarp();
}

constexpr size_t states_smem_floats() {
  return 6 * (size_t)KP * PW + 4 * (size_t)LCMAX;
}

// Launch 1. Blocks [0, nsb): (batch, chunk, head, DTILE head columns):
// the chunk's state update DS[d][n] = sum_u w_u x[u][d] b[u][n] (output
// rows 0..63) and state-gradient update DdS[d][n] = sum_t e_t dy[t][d]
// c[t][n] (rows 64..127) into WS and WdS, and cl into clw. Blocks from
// nsb on: (batch, chunk, group): G[t][u] = c_t . b_u into gram (128 x
// PW a (batch, chunk, group); the strictly upper quarter not written).
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_states(const T* __restrict__ x, const T* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ b,
               const T* __restrict__ c, const T* __restrict__ dy,
               float* __restrict__ WS, float* __restrict__ WdS,
               float* __restrict__ gram, float* __restrict__ clw, int L,
               int H, int Dh, int G, int N, int lc, int nch, int ndt,
               long long nsb, long long sxb, long long sxl, long long sbb,
               long long sbl, long long scb, long long scl, long long syb,
               long long syl) {
  extern __shared__ float4 smem4[];
  float* sa = reinterpret_cast<float*>(smem4);   // 2 x KP x PW each
  float* sb = sa + 2 * KP * PW;
  float* sc = sb + 2 * KP * PW;
  float* cum = sc + 2 * KP * PW;                  // LCMAX each
  float* dtv = cum + LCMAX;
  float* wv = dtv + LCMAX;
  float* ev = wv + LCMAX;
  const int tid = threadIdx.x;

  if ((long long)blockIdx.x >= nsb) {   // G of one (batch, chunk, group)
    using Ly = Lay<128>;
    const long long j = blockIdx.x - nsb;
    const int g = (int)(j % G), ch = (int)((j / G) % nch);
    const int bi = (int)(j / ((long long)G * nch));
    const int t0 = ch * lc, nv = min(lc, L - t0);
    Panel<T, true, 128> pc(c + bi * scb + t0 * scl + (long long)g * N, scl,
                           nv, N, nullptr);
    Panel<T, true, 128> pb(b + bi * sbb + t0 * sbl + (long long)g * N, sbl,
                           nv, N, nullptr);
    float acc[Ly::TM][Ly::TN];
    zero<128>(acc);
    gemm_ss<128, true>(acc, pc, pb, N, sa, sb);
    float* out = gram + j * LCMAX * PW;
#pragma unroll
    for (int i = 0; i < Ly::TM; ++i)
#pragma unroll
      for (int cg = 0; cg < Ly::NC; ++cg) {
        if (i < Ly::RG && cg == 1) continue;
        *reinterpret_cast<float4*>(out + Ly::row(i) * PW + Ly::col0(cg)) =
            make_float4(acc[i][4 * cg], acc[i][4 * cg + 1],
                        acc[i][4 * cg + 2], acc[i][4 * cg + 3]);
      }
    return;
  }

  using Ly = Lay<NT>;
  const long long blk = blockIdx.x;
  const int dti = (int)(blk % ndt);
  const long long bh = blk / ndt;
  const int h = (int)(bh % H), ch = (int)((bh / H) % nch);
  const int bi = (int)(bh / ((long long)H * nch));
  const int g = h / (H / G);
  const int t0 = ch * lc, nv = min(lc, L - t0);
  if (tid < 32)
    head_scan<T>(dt + ((long long)bi * L + t0) * H + h, H, a[h], lc, nv, cum,
                 dtv, wv, ev);
  __syncthreads();
  const int d0 = dti * DTILE, nd = min(DTILE, Dh - d0);
  Panel<T, false, DTILE> px(x + bi * sxb + t0 * sxl + (long long)h * Dh + d0,
                            sxl, nd, nv, wv);
  Panel<T, false, DTILE> py(dy + bi * syb + t0 * syl + (long long)h * Dh + d0,
                            syl, nd, nv, ev);
  Panel<T, false, NT> pb(b + bi * sbb + t0 * sbl + (long long)g * N, sbl, N,
                         nv, nullptr);
  Panel<T, false, NT> pc(c + bi * scb + t0 * scl + (long long)g * N, scl, N,
                         nv, nullptr);
  float acc[Ly::TM][Ly::TN];
  zero<NT>(acc);
  bool live[Ly::NG];
#pragma unroll
  for (int q = 0; q < Ly::NG; ++q) live[q] = true;
  const int np = (nv + KP - 1) / KP;
  px.load(0);
  py.load(0);
  pb.load(0);
  pc.load(0);
  px.store(sa, 0);
  py.store(sa + DTILE, 0);
  pb.store(sb, 0);
  pc.store(sc, 0);
  __syncthreads();
  for (int p = 0; p < np; ++p) {
    const int cur = p & 1, k1 = (p + 1) * KP;
    if (p + 1 < np) {
      px.load(k1);
      py.load(k1);
      pb.load(k1);
      pc.load(k1);
    }
    mma_panel<NT, 0, true, false>(acc, sa + cur * KP * PW, PW,
                                  sb + cur * KP * PW, sc + cur * KP * PW,
                                  live);
    if (p + 1 < np) {
      const int nx = (cur ^ 1) * KP * PW;
      px.store(sa + nx, k1);
      py.store(sa + nx + DTILE, k1);
      pb.store(sb + nx, k1);
      pc.store(sc + nx, k1);
    }
    __syncthreads();
  }
  const long long base = ((long long)bi * nch + ch) * H + h;
#pragma unroll
  for (int i = 0; i < Ly::TM; ++i) {
    const int m = Ly::row(i);
    const int d = m < DTILE ? m : m - DTILE;
    if (d >= nd) continue;
    float* out = (m < DTILE ? WS : WdS) + (base * Dh + d0 + d) * N;
#pragma unroll
    for (int cg = 0; cg < Ly::NC; ++cg) {
      const int n0 = Ly::col0(cg);
      if (n0 < N)
        store4<float>(out + n0,
                      make_float4(acc[i][4 * cg], acc[i][4 * cg + 1],
                                  acc[i][4 * cg + 2], acc[i][4 * cg + 3]),
                      N - n0);
    }
  }
  if (dti == 0 && tid == 0) clw[base] = cum[lc - 1];
}

// Launch 2: the state pass over the chunks. Block (batch * H + head,
// part of the head's DN state elements), one thread per 4 consecutive
// elements: forward over WS (each slot ends holding the state at its
// chunk's start), then in reverse over WdS (each slot ends holding the
// gradient of its chunk's end state), where each chunk's <dS, S> part of
// the block is summed (lanes, then warps, in a fixed order) into dsp
// (B, nch, H, parts). The loads of PD chunks are in flight together.
constexpr int PD = 8;
// The state pass's blocks a (batch, head): THREADS x 4 state elements each
__host__ __device__ __forceinline__ long long pass_parts(int Dh, int N) {
  const long long nq = ((long long)Dh * N + 3) / 4;
  return (nq + THREADS - 1) / THREADS;
}

__global__ void __launch_bounds__(THREADS)
ssd_bwd_pass(float* __restrict__ WS, float* __restrict__ WdS,
             const float* __restrict__ clw, float* __restrict__ dsp, int H,
             int nch, long long DN) {
  extern __shared__ float4 smem4[];
  float* wsum = reinterpret_cast<float*>(smem4);   // THREADS / 32
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nparts = gridDim.y;
  const long long nq = (DN + 3) / 4;
  const long long q = (long long)blockIdx.y * THREADS + tid;
  const bool act = q < nq;
  const long long e0 = 4 * q;
  const int ne = act ? (int)min(4LL, DN - e0) : 0;
  const bool vec = ne == 4 && DN % 4 == 0;
  const int h = (int)(blockIdx.x % H);
  const long long bi = blockIdx.x / H;
  for (int rev = 0; rev < 2; ++rev) {
    float* W = rev ? WdS : WS;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < nch; c0 += PD) {
      float d[PD][4], sv[PD][4], dec[PD];
#pragma unroll
      for (int j = 0; j < PD; ++j) {
        if (c0 + j >= nch) continue;
        const int k = rev ? nch - 1 - (c0 + j) : c0 + j;
        const long long slot = (bi * nch + k) * H + h;
        const float* p = W + slot * DN + e0;
        const float* ps = WS + slot * DN + e0;   // (reverse) S, written above
#pragma unroll
        for (int r = 0; r < 4; ++r) d[j][r] = sv[j][r] = 0.f;
        if (vec) {
          const float4 v = *reinterpret_cast<const float4*>(p);
          d[j][0] = v.x;
          d[j][1] = v.y;
          d[j][2] = v.z;
          d[j][3] = v.w;
          if (rev) {
            const float4 u = *reinterpret_cast<const float4*>(ps);
            sv[j][0] = u.x;
            sv[j][1] = u.y;
            sv[j][2] = u.z;
            sv[j][3] = u.w;
          }
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (r < ne) {
              d[j][r] = p[r];
              if (rev) sv[j][r] = ps[r];
            }
        }
        dec[j] = expf(clw[slot]);
      }
#pragma unroll
      for (int j = 0; j < PD; ++j) {
        if (c0 + j >= nch) continue;
        const int k = rev ? nch - 1 - (c0 + j) : c0 + j;
        const long long slot = (bi * nch + k) * H + h;
        float* p = W + slot * DN + e0;
        if (vec) {
          *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (r < ne) p[r] = s[r];
        }
        if (rev) {
          float dot = s[0] * sv[j][0] + s[1] * sv[j][1] + s[2] * sv[j][2] +
                      s[3] * sv[j][3];
#pragma unroll
          for (int o = 16; o >= 1; o >>= 1)
            dot += __shfl_xor_sync(FULL, dot, o);
          if (lane == 0) wsum[warp] = dot;
          __syncthreads();
          if (tid == 0) {
            float t = 0.f;
            for (int w = 0; w < THREADS / 32; ++w) t += wsum[w];
            dsp[slot * nparts + blockIdx.y] = t;
          }
          __syncthreads();
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) s[r] = dec[j] * s[r] + d[j][r];
      }
    }
  }
}

constexpr size_t chunk_smem_floats() {
  return 2 * (size_t)LCMAX * PW + 4 * (size_t)KP * PW +
         7 * (size_t)HS * LCMAX;
}
static_assert(4 * KP * PW >= 2 * 8 * LCMAX, "the column partials alias the "
              "panels");

// Launch 3: one block per (batch, chunk, group, split of the group's
// heads); see the head note. WS and WdS hold each chunk's start state and
// the gradient of its end state; gram holds G. dx and ddt are written in
// T; db and dc summed over the block's heads, in T when the group has one
// split (nsp 1), else as f32 partials (nsp, B, L, G, N); da's partial of
// each head into dap (B, nch, H).
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_chunk(const T* __restrict__ x, const T* __restrict__ dt,
              const float* __restrict__ a, const T* __restrict__ b,
              const T* __restrict__ c, const T* __restrict__ dy,
              const float* __restrict__ WS, const float* __restrict__ WdS,
              const float* __restrict__ gram, const float* __restrict__ dsp,
              T* __restrict__ dx, T* __restrict__ ddt, T* __restrict__ db,
              T* __restrict__ dc, float* __restrict__ partb,
              float* __restrict__ partc, float* __restrict__ dap, int B,
              int L, int H, int Dh, int G,
              int N, int lc, int nch, int hs, int nsp, long long sxb,
              long long sxl, long long sbb, long long sbl, long long scb,
              long long scl, long long syb, long long syl) {
  using L1 = Lay<128>;   // dM
  using L2 = Lay<DTILE>; // dX
  using LN = Lay<NT>;    // the N-wide products
  extern __shared__ float4 smem4[];
  float* Msm = reinterpret_cast<float*>(smem4);   // LCMAX x PW: M[t][u]
  float* dGs = Msm + LCMAX * PW;                  // the heads' sum of dG
  float* sa = dGs + LCMAX * PW;                   // 2 x KP x PW each
  float* sb = sa + 2 * KP * PW;
  float* colP = sa;                  // 8 x LCMAX partials (over the panels)
  float* colD = colP + 8 * LCMAX;
  float* cumv = sb + 2 * KP * PW;    // HS x LCMAX each, one row a head
  float* dtv = cumv + HS * LCMAX;
  float* wv = dtv + HS * LCMAX;
  float* ev = wv + HS * LCMAX;
  // P's row sums - its column sums + e_t (dY S)_t . c_t
  float* d1v = ev + HS * LCMAX;
  float* dirv = d1v + HS * LCMAX;    // sum_t dM G L (dt's direct term)
  float* dwv = dirv + HS * LCMAX;    // x_u . (B dS^T)_u

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long blk = blockIdx.x;
  const int s = (int)(blk % nsp);
  const int g = (int)((blk / nsp) % G);
  const int ch = (int)((blk / ((long long)nsp * G)) % nch);
  const int bi = (int)(blk / ((long long)nsp * G * nch));
  const int rep = H / G, h0 = g * rep + s * hs;
  const int nh = min(hs, rep - s * hs);
  const int t0 = ch * lc, nv = min(lc, L - t0);
  const bool has_S = ch > 0, has_dS = ch < nch - 1;
  const T* bg = b + bi * sbb + t0 * sbl + (long long)g * N;
  const T* cg = c + bi * scb + t0 * scl + (long long)g * N;
  const float* Gb = gram + (((long long)bi * nch + ch) * G + g) * LCMAX * PW;

  for (int e = tid; e < LCMAX * PW / 4; e += THREADS)
    reinterpret_cast<float4*>(dGs)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (warp < nh)
    head_scan<T>(dt + ((long long)bi * L + t0) * H + h0 + warp, H,
                 a[h0 + warp], lc, nv, cumv + warp * LCMAX,
                 dtv + warp * LCMAX, wv + warp * LCMAX, ev + warp * LCMAX);
  __syncthreads();

  // ---- per head: dM, M, dG, the dcum sums; dX and dw --------------------
  for (int w = 0; w < nh; ++w) {
    const int h = h0 + w;
    const T* xh = x + bi * sxb + t0 * sxl + (long long)h * Dh;
    const T* yh = dy + bi * syb + t0 * syl + (long long)h * Dh;
    const float* dSh = WdS + (((long long)bi * nch + ch) * H + h) * Dh * N;
    const float* cum = cumv + w * LCMAX;
    const float* dtw = dtv + w * LCMAX;
    // the first dX tile's B and dS^T panels, loaded during dM's epilogue
    Panel<T, true, 128> pbm(bg, sbl, nv, N, nullptr);              // A[u][n]
    Panel<float, true, DTILE> pds(dSh, N, min(DTILE, Dh), N, nullptr);
    {
      // G into this thread's own slots of Msm (those its epilogue reads),
      // in flight during dM's products
#pragma unroll
      for (int i = 0; i < L1::TM; ++i)
#pragma unroll
        for (int cq = 0; cq < L1::NC; ++cq) {
          const int t = L1::row(i), u0 = L1::col0(cq);
          if (u0 <= t && t < nv)
            __pipeline_memcpy_async(Msm + t * PW + u0, Gb + t * PW + u0, 16);
        }
      __pipeline_commit();
      float acc[L1::TM][L1::TN];
      zero<128>(acc);
      Panel<T, true, 128> py(yh, syl, nv, Dh, nullptr);   // A[t][d]
      Panel<T, true, 128> px(xh, sxl, nv, Dh, nullptr);   // B[u][d]
      gemm_ss<128, true>(acc, py, px, Dh, sa, sb);
      if (has_dS) {
        pbm.load(0);
        pds.load(0);
      }
      __pipeline_wait_prior(0);
      float cp[L1::TN], cd[L1::TN];
#pragma unroll
      for (int j = 0; j < L1::TN; ++j) cp[j] = cd[j] = 0.f;
#pragma unroll
      for (int i = 0; i < L1::TM; ++i) {
        const int t = L1::row(i);
        float rp = 0.f;
#pragma unroll
        for (int cq = 0; cq < L1::NC; ++cq) {
          const int u0 = L1::col0(cq);
          const bool any = u0 <= t && t < nv;
          const float4 gv = any ? *reinterpret_cast<const float4*>(
                                      Msm + t * PW + u0)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          const float gq[4] = {gv.x, gv.y, gv.z, gv.w};
          float mq[4], dgq[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int u = u0 + jj, j = 4 * cq + jj;
            const bool on = any && u <= t;
            const float gt = on ? gq[jj] : 0.f;
            const float lv = on ? expf(cum[t] - cum[u]) : 0.f;
            const float dm = on ? acc[i][j] : 0.f;
            const float m = gt * lv * dtw[u];
            mq[jj] = m;
            dgq[jj] = dm * lv * dtw[u];
            const float pv = dm * m;
            rp += pv;
            cp[j] += pv;
            cd[j] += dm * gt * lv;
          }
          *reinterpret_cast<float4*>(Msm + t * PW + u0) =
              make_float4(mq[0], mq[1], mq[2], mq[3]);
          float4* dgp = reinterpret_cast<float4*>(dGs + t * PW + u0);
          const float4 o = *dgp;
          *dgp = make_float4(o.x + dgq[0], o.y + dgq[1], o.z + dgq[2],
                             o.w + dgq[3]);
        }
        rp = row_sum<128>(rp);
        if (L1::tx() == 0) d1v[w * LCMAX + t] = rp;
      }
      // the column partials: the warp's two row sets (lanes l, l ^ 16),
      // then the 8 warps' in order below
#pragma unroll
      for (int j = 0; j < L1::TN; ++j) {
        const int u = L1::col0(j / 4) + j % 4;
        const float p2 = cp[j] + __shfl_xor_sync(FULL, cp[j], 16);
        const float d2 = cd[j] + __shfl_xor_sync(FULL, cd[j], 16);
        if (lane < 16) {
          colP[warp * LCMAX + u] = p2;
          colD[warp * LCMAX + u] = d2;
        }
      }
    }
    __syncthreads();
    for (int u = tid; u < LCMAX; u += THREADS) {
      float sp = 0.f, sd = 0.f;
      for (int k = 0; k < THREADS / 32; ++k) {
        sp += colP[k * LCMAX + u];
        sd += colD[k * LCMAX + u];
      }
      d1v[w * LCMAX + u] -= sp;
      dirv[w * LCMAX + u] = sd;
    }
    __syncthreads();   // the column partials' panels are free again

    float dwp[L2::TM];
#pragma unroll
    for (int i = 0; i < L2::TM; ++i) dwp[i] = 0.f;
    for (int dc0 = 0; dc0 < Dh; dc0 += DTILE) {
      const int nd = min(DTILE, Dh - dc0);
      float acc[L2::TM][L2::TN];
      zero<DTILE>(acc);
      if (has_dS) {
        if (dc0 > 0)
          pds = Panel<float, true, DTILE>(dSh + (long long)dc0 * N, N, nd, N,
                                          nullptr);          // B[d][n]
        gemm_ss<DTILE, false>(acc, pbm, pds, N, sa, sb, dc0 == 0);
#pragma unroll
        for (int i = 0; i < L2::TM; ++i) {
          const int u = L2::row(i), d = dc0 + L2::col0(0);
          if (u < nv && d < Dh) {
            const float4 xv = load4<T>(xh + u * sxl + d, Dh - d);
            dwp[i] += xv.x * acc[i][0] + xv.y * acc[i][1] +
                      xv.z * acc[i][2] + xv.w * acc[i][3];
          }
          const float wu = wv[w * LCMAX + u];
#pragma unroll
          for (int j = 0; j < L2::TN; ++j) acc[i][j] *= wu;
        }
      }
      Panel<T, false, DTILE> pdy(yh + dc0, syl, nd, nv, nullptr);  // B[t][d]
      gemm_rs<DTILE, 0, 1>(acc, Msm, pdy, nv, sb);
#pragma unroll
      for (int i = 0; i < L2::TM; ++i) {
        const int u = L2::row(i), d = dc0 + L2::col0(0);
        if (u < nv && d < Dh)
          store4<T>(dx + (((long long)bi * L + t0 + u) * H + h) * Dh + d,
                    make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]),
                    Dh - d);
      }
    }
#pragma unroll
    for (int i = 0; i < L2::TM; ++i) {
      const float sdw = row_sum<DTILE>(dwp[i]);
      if (L2::tx() == 0) dwv[w * LCMAX + L2::row(i)] = sdw;
    }
  }

  // ---- per head: (e dY) S into dc's head sum, the e term; ddt, da -------
  // Msm now holds the heads' sum of diag(e) dY S (each thread its own
  // elements, in the N-wide layout)
#pragma unroll
  for (int i = 0; i < LN::TM; ++i)
#pragma unroll
    for (int cq = 0; cq < LN::NC; ++cq)
      *reinterpret_cast<float4*>(Msm + LN::row(i) * PW + LN::col0(cq)) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  for (int w = 0; w < nh; ++w) {
    const int h = h0 + w;
    const T* yh = dy + bi * syb + t0 * syl + (long long)h * Dh;
    const long long soff = (((long long)bi * nch + ch) * H + h) * Dh * N;
    float acc[LN::TM][LN::TN];
    zero<NT>(acc);
    if (has_S) {
      Panel<T, true, 128> py(yh, syl, nv, Dh, ev + w * LCMAX);  // A[t][d] e_t
      Panel<float, false, NT> ps(WS + soff, N, N, Dh, nullptr); // B[d][n]
      gemm_ss<NT, false>(acc, py, ps, Dh, sa, sb);
    }
#pragma unroll
    for (int i = 0; i < LN::TM; ++i) {
      const int t = LN::row(i);
      float ep = 0.f;
#pragma unroll
      for (int cq = 0; cq < LN::NC; ++cq) {
        const int n0 = LN::col0(cq);
        if (t < nv && n0 < N) {
          const float4 cv = load4<T>(cg + t * scl + n0, N - n0);
          ep += cv.x * acc[i][4 * cq] + cv.y * acc[i][4 * cq + 1] +
                cv.z * acc[i][4 * cq + 2] + cv.w * acc[i][4 * cq + 3];
        }
        float4* pm = reinterpret_cast<float4*>(Msm + t * PW + n0);
        const float4 o = *pm;
        *pm = make_float4(o.x + acc[i][4 * cq], o.y + acc[i][4 * cq + 1],
                          o.z + acc[i][4 * cq + 2], o.w + acc[i][4 * cq + 3]);
      }
      ep = row_sum<NT>(ep);
      if (LN::tx() == 0) d1v[w * LCMAX + t] += ep;
    }
  }
  __syncthreads();
  // each head's dcum, its reverse cumsum, ddt and da's partial: warp w
  // for head w
  if (warp < nh) {
    const int w = warp, h = h0 + w;
    const float* cum = cumv + w * LCMAX;
    const float cl = cum[lc - 1];
    // <dS, S> of the head at this chunk: the state pass's parts in order
    const int np = (int)pass_parts(Dh, N);
    const float* dp = dsp + (((long long)bi * nch + ch) * H + h) * np;
    float dsdot = 0.f;
    for (int k = 0; k < np; ++k) dsdot += dp[k];
    float dcum[4], dwl = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = 4 * lane + i;
      const float dw_w = dwv[w * LCMAX + u] * wv[w * LCMAX + u];
      dcum[i] = u < lc ? d1v[w * LCMAX + u] - dw_w : 0.f;
      dwl += u < lc ? dw_w : 0.f;
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) dwl += __shfl_xor_sync(FULL, dwl, o);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * lane + i == lc - 1) dcum[i] += dwl + expf(cl) * dsdot;
    // the reverse cumsum of dcum: within the lane, then over the lanes
    float suf[4], run = 0.f;
#pragma unroll
    for (int i = 3; i >= 0; --i) {
      run += dcum[i];
      suf[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float dn = __shfl_down_sync(FULL, incl, o);
      if (lane + o < 32) incl += dn;
    }
    const float after = incl - run;   // the lanes above this one
    const float ah = a[h];
    float dap_ = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = 4 * lane + i;
      const float dda = suf[i] + after;   // d(dt a) at row u
      dap_ += dtv[w * LCMAX + u] * dda;
      if (u < nv)
        ddt[((long long)bi * L + t0 + u) * H + h] = from_f<T>(
            dirv[w * LCMAX + u] + dwv[w * LCMAX + u] * expf(cl - cum[u]) +
            ah * dda);
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) dap_ += __shfl_xor_sync(FULL, dap_, o);
    if (lane == 0) dap[((long long)bi * nch + ch) * H + h] = dap_;
  }

  // ---- dC = sum_h e dY_h S_h + dG_sum B; dB = dG_sum^T C + sum_h w X dS --
  const long long orow = (long long)bi * L + t0;
  T* dco = nsp == 1 ? dc : nullptr;
  T* dbo = nsp == 1 ? db : nullptr;
  float* pco = partc + (long long)s * B * L * G * N;
  float* pbo = partb + (long long)s * B * L * G * N;
  {
    float acc[LN::TM][LN::TN];
#pragma unroll
    for (int i = 0; i < LN::TM; ++i)
#pragma unroll
      for (int cq = 0; cq < LN::NC; ++cq) {
        const float4 v = *reinterpret_cast<const float4*>(
            Msm + LN::row(i) * PW + LN::col0(cq));
        acc[i][4 * cq] = v.x;
        acc[i][4 * cq + 1] = v.y;
        acc[i][4 * cq + 2] = v.z;
        acc[i][4 * cq + 3] = v.w;
      }
    Panel<T, false, NT> pbm(bg, sbl, N, nv, nullptr);   // B[u][n]
    gemm_rs<NT, 1, 2>(acc, dGs, pbm, nv, sb);
#pragma unroll
    for (int i = 0; i < LN::TM; ++i) {
      const int t = LN::row(i);
      if (t >= nv) continue;
#pragma unroll
      for (int cq = 0; cq < LN::NC; ++cq) {
        const int n0 = LN::col0(cq);
        if (n0 >= N) continue;
        const float4 v = make_float4(acc[i][4 * cq], acc[i][4 * cq + 1],
                                     acc[i][4 * cq + 2], acc[i][4 * cq + 3]);
        const long long o = ((orow + t) * G + g) * N + n0;
        if (dco)
          store4<T>(dco + o, v, N - n0);
        else
          store4<float>(pco + o, v, N - n0);
      }
    }
  }
  {
    float acc[LN::TM][LN::TN];
    zero<NT>(acc);
    Panel<T, false, NT> pcm(cg, scl, N, nv, nullptr);   // B[t][n]
    gemm_rs<NT, 0, 1>(acc, dGs, pcm, nv, sb);
    if (has_dS)
      for (int w = 0; w < nh; ++w) {
        const int h = h0 + w;
        Panel<T, true, 128> px(x + bi * sxb + t0 * sxl + (long long)h * Dh,
                               sxl, nv, Dh, wv + w * LCMAX);   // A[u][d] w_u
        Panel<float, false, NT> pds(
            WdS + (((long long)bi * nch + ch) * H + h) * Dh * N, N, N, Dh,
            nullptr);                                          // B[d][n]
        gemm_ss<NT, false>(acc, px, pds, Dh, sa, sb);
      }
#pragma unroll
    for (int i = 0; i < LN::TM; ++i) {
      const int u = LN::row(i);
      if (u >= nv) continue;
#pragma unroll
      for (int cq = 0; cq < LN::NC; ++cq) {
        const int n0 = LN::col0(cq);
        if (n0 >= N) continue;
        const float4 v = make_float4(acc[i][4 * cq], acc[i][4 * cq + 1],
                                     acc[i][4 * cq + 2], acc[i][4 * cq + 3]);
        const long long o = ((orow + u) * G + g) * N + n0;
        if (dbo)
          store4<T>(dbo + o, v, N - n0);
        else
          store4<float>(pbo + o, v, N - n0);
      }
    }
  }
}

// Launch 4: db and dc of each group, the sums of its splits' partials in
// split order (nsp > 1); da the sum of its partials in (batch, chunk)
// order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce(const float* __restrict__ partb,
               const float* __restrict__ partc, const float* __restrict__ dap,
               T* __restrict__ db, T* __restrict__ dc, float* __restrict__ da,
               long long total, int H, long long nbc, int nsp) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (nsp > 1 && i < total) {
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < nsp; ++k) {
      sb += partb[k * total + i];
      sc += partc[k * total + i];
    }
    db[i] = from_f<T>(sb);
    dc[i] = from_f<T>(sc);
  }
  if (i < H) {
    float s = 0.f;
    for (long long k = 0; k < nbc; ++k) s += dap[k * H + i];
    da[i] = s;
  }
}

// Heads of one group a chunk block owns: enough splits of each group for
// about TARGET_BLOCKS blocks, at most HS heads a block.
int heads_per_block(long long B, long long nch, int H, int G) {
  const long long base = B * nch * G;
  const long long want = base >= TARGET_BLOCKS ? 1 : TARGET_BLOCKS / base;
  const long long rep = H / G;
  long long hs = (rep + want - 1) / want;
  if (hs < 1) hs = 1;
  if (hs > HS) hs = HS;
  return (int)hs;
}

// Floats a workspace takes: a multiple of 64, so that every part carved
// from the caller's buffer starts 256-byte aligned (G and the state
// workspaces are read and written as 16-byte vectors).
long long padded(long long n) { return (n + 63) / 64 * 64; }

// Floats of each workspace (see the head note), in out[0..6]; out[7] the
// heads a chunk block owns. Returns the floats' sum.
long long workspace_floats(int B, int L, int H, int Dh, int G, int N, int lc,
                           long long* out) {
  const long long nch = (L + lc - 1) / lc;
  const long long nstate = padded((long long)B * nch * H * Dh * N);
  const int hs = heads_per_block(B, nch, H, G);
  const long long nsp = (H / G + hs - 1) / hs;
  const long long npart = nsp > 1 ? padded(nsp * B * L * G * N) : 0;
  const long long parts[7] = {
      nstate,
      nstate,
      (long long)B * nch * G * LCMAX * PW,
      padded((long long)B * nch * H),
      padded((long long)B * nch * H),
      padded((long long)B * nch * H * pass_parts(Dh, N)),
      2 * npart};
  long long sum = 0;
  for (int i = 0; i < 7; ++i) {
    if (out) out[i] = parts[i];
    sum += parts[i];
  }
  if (out) out[7] = hs;
  return sum;
}

template <typename T, int NT>
int launch(const void* x, const void* dt, const float* a, const void* b,
           const void* c, const void* dy, void* dx, void* ddt, float* da,
           void* db, void* dc, float* work, int B, int L, int H, int Dh,
           int G, int N, int lc, const long long* st, cudaStream_t stream) {
  const int nch = (L + lc - 1) / lc;
  long long part[8];
  workspace_floats(B, L, H, Dh, G, N, lc, part);
  float* WS = work;
  float* WdS = WS + part[0];
  float* gram = WdS + part[1];
  float* clw = gram + part[2];
  float* dap = clw + part[3];
  float* dsp = dap + part[4];
  float* partb = dsp + part[5];
  const long long npart = part[6] / 2;
  float* partc = partb + npart;
  const int hs = (int)part[7];
  const int nsp = (H / G + hs - 1) / hs;
  const T* xt = static_cast<const T*>(x);
  const T* dtt = static_cast<const T*>(dt);
  const T* bt = static_cast<const T*>(b);
  const T* ct = static_cast<const T*>(c);
  const T* yt = static_cast<const T*>(dy);

  const int ndt = (Dh + DTILE - 1) / DTILE;
  const long long nsb = (long long)B * nch * H * ndt;
  const long long nblk = nsb + (long long)B * nch * G;
  const size_t s1 = states_smem_floats() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_states<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s1);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_states<T, NT><<<(unsigned)nblk, THREADS, s1, stream>>>(
      xt, dtt, a, bt, ct, yt, WS, WdS, gram, clw, L, H, Dh, G, N, lc, nch,
      ndt, nsb, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7]);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const long long DN = (long long)Dh * N;
  ssd_bwd_pass<<<dim3((unsigned)(B * H), (unsigned)pass_parts(Dh, N)),
                 THREADS, THREADS / 32 * sizeof(float), stream>>>(
      WS, WdS, clw, dsp, H, nch, DN);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t s3 = chunk_smem_floats() * sizeof(float);
  e = cudaFuncSetAttribute(ssd_bwd_chunk<T, NT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)s3);
  if (e != cudaSuccess) return (int)e;
  const long long ncb = (long long)B * nch * G * nsp;
  ssd_bwd_chunk<T, NT><<<(unsigned)ncb, THREADS, s3, stream>>>(
      xt, dtt, a, bt, ct, yt, WS, WdS, gram, dsp, static_cast<T*>(dx),
      static_cast<T*>(ddt), static_cast<T*>(db), static_cast<T*>(dc), partb,
      partc, dap, B, L, H, Dh, G, N, lc, nch, hs, nsp, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7]);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const long long total = (long long)B * L * G * N;
  const long long n = nsp > 1 ? (total > H ? total : H) : H;
  ssd_bwd_reduce<T><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                      stream>>>(partb, partc, dap, static_cast<T*>(db),
                                static_cast<T*>(dc), da, total, H,
                                (long long)B * nch, nsp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* x, const void* dt, const float* a, const void* b,
             const void* c, const void* dy, void* dx, void* ddt, float* da,
             void* db, void* dc, float* work, int B, int L, int H, int Dh,
             int G, int N, int lc, const long long* st, cudaStream_t stream) {
  if (N <= 16)
    return launch<T, 16>(x, dt, a, b, c, dy, dx, ddt, da, db, dc, work, B, L,
                         H, Dh, G, N, lc, st, stream);
  return launch<T, NMAX>(x, dt, a, b, c, dy, dx, ddt, da, db, dc, work, B, L,
                         H, Dh, G, N, lc, st, stream);
}

}  // namespace

// Floats of each workspace the caller allocates, in out[0..6] (the state
// updates, their gradients, G, cl, da's partials, the state pass's parts
// of each <dS, S>, the splits' db and dc), and in out[7] the heads of one
// group a chunk block owns. Returns the floats' sum.
extern "C" long long saath_ssd_scan_bwd_workspace(int B, int L, int H,
                                                  int Dh, int G, int N,
                                                  int lc, long long* out) {
  return workspace_floats(B, L, H, Dh, G, N, lc, out);
}

// bf16 != 0: x, dt, b, c, dy and dx, ddt, db, dc are bf16, else f32; a
// and da f32. strides: the batch and time-step strides (elements) of x,
// b, c and dy, in that order (inner two dims packed); dt is contiguous,
// the gradients are written contiguous. lc <= 128, N <= 128, H a multiple
// of G. work: `saath_ssd_scan_bwd_workspace` floats. Four launches;
// returns the CUDA error code of the first that failed (0 = none).
extern "C" int saath_ssd_scan_bwd(const void* x, const void* dt,
                                  const float* a, const void* b,
                                  const void* c, const void* dy, void* dx,
                                  void* ddt, float* da, void* db, void* dc,
                                  float* work, int B, int L, int H, int Dh,
                                  int G, int N, int lc,
                                  const long long* strides, int bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_t<__nv_bfloat16>(x, dt, a, b, c, dy, dx, ddt, da, db, dc,
                                   work, B, L, H, Dh, G, N, lc, strides, s);
  return launch_t<float>(x, dt, a, b, c, dy, dx, ddt, da, db, dc, work, B, L,
                         H, Dh, G, N, lc, strides, s);
}
