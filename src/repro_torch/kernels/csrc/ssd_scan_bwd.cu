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
// Design (correctness first: f32 products on the CUDA cores, as K4's):
//
//  * ssd_bwd_sweep, twice. A block owns DS = 32 rows d of one head's
//    (Dh, N) state (grid (B H, ceil(Dh / DS))): dS[d, :] needs only
//    column d of dY, as S[d, :] needs only column d of x. Forward, it
//    writes every chunk's start state S (the forward's recurrence,
//    S' = exp(cl) S + (x w)^T b); in reverse, every chunk's dS (dS' =
//    exp(cl) dS + (e dY)^T c, 0 after the last chunk). Each thread keeps
//    a 4 x 4 tile of the slice in registers across the chunks.
//  * ssd_bwd_chunk: given S and dS at a chunk's two ends, everything
//    else in the chunk is local, so one block per (batch, chunk, head)
//    forms G and dM (256 threads, an 8 x 8 register tile each of the
//    lc x lc square), keeps M and dG in shared memory (2 x 66 KB), and
//    runs the products above over k-panels of 16 rows staged in shared
//    memory; the dcum terms' row and column sums are fixed-order (lane
//    shuffles, then an ordered sum of 16 partials), the reverse cumsum
//    and da's partial a single thread's sequential sums. dx and ddt are
//    written in the inputs' type; db and dc of each head go to f32
//    workspaces (B, L, H, N), da's partial to (B, nch, H).
//  * ssd_bwd_reduce sums the H / G heads of each group in head order
//    (and da's partials in (batch, chunk) order) and casts.
//
// No float atomics: every output element has one owner and one order of
// sums, so two calls give the same bits. Rows past L read as zeros (the
// forward's zero padding: dt = 0 there) and are not written.
//
// Bound on this card (67 TFLOP/s f32, 989 bf16 on the tensor cores, 3.35
// TB/s): the function's multiply-adds are, per (batch, group, chunk), G =
// c b^T over the causal half (lc^2 / 2 x N), and per (batch, head, chunk)
// the causal halves of dM and M^T dY (lc^2 / 2 x Dh each) and of dG B and
// dG^T C (lc^2 / 2 x N each) and the six lc x Dh x N products (S
// recomputed, dS, B dS^T, dY S, X dS and (e dY)^T C). At Mamba2-1.3B's
// train shape (B 4, L 2048, H 64, G 1, Dh 64, N 128, lc 128) that is 38.8
// G multiply-adds: 1.10 ms in bf16 (G and dM, products of the inputs
// alone, at the tensor-core rate; the rest, with f32 operands, at 67
// TFLOP/s), 1.16 ms in f32; its bytes (inputs and outputs once, bf16)
// about 0.08 ms. At Jamba's microbatch shape (1, 1024, 128, 1, 64, 16,
// 128) 2.16 G, 0.05 ms in bf16. `chip_smoke.ssd_bwd_bound_ms` counts them
// from the inputs. This first design does the causal products over the
// whole lc x lc square and stages its k-panels through registers without
// overlap: it reaches about a tenth of the bound (PERF.md).
//
// Workspaces (f32, allocated by the caller, `saath_ssd_scan_bwd_workspace`):
// S and dS (B, nch, H, Dh, N) each, db and dc per head (B, L, H, N) each,
// da's partials (B, nch, H): 134 + 134 + 268 + 268 MB at Mamba2-1.3B's
// train shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int LCMAX = 128;   // chunk rows
constexpr int NMAX = 128;    // state columns
constexpr int DS = 32;       // state rows a sweep block owns
constexpr int KP = 16;       // inner rows of one staged k-panel
constexpr int TS = LCMAX + 1;  // row stride of the lc x lc tiles (floats)
constexpr int PS = LCMAX + 1;  // row stride of a k-panel (floats)
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

// dt of the chunk's rows (0 past L or lc) into dtv, then (warp 0) the
// inclusive cumsum of dt a into cum: lane-serial over four rows, then a
// scan of the lane totals. Ends with a barrier.
template <typename T>
__device__ __forceinline__ void chunk_cumsum(const T* dtb, long long sdl,
                                             float ah, int t0, int lc,
                                             int L, float* dtv,
                                             float* cum) {
  const int tid = threadIdx.x;
  for (int u = tid; u < LCMAX; u += THREADS)
    dtv[u] = (u < lc && t0 + u < L) ? to_f(dtb[(long long)(t0 + u) * sdl])
                                    : 0.f;
  __syncthreads();
  if (tid < 32) {
    const int lane = tid;
    float v[4];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      run += dtv[4 * lane + i] * ah;
      v[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += up;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) cum[4 * lane + i] = incl - run + v[i];
  }
  __syncthreads();
}

// The state sweep. Forward (REV false): p = x, q = b, coef_u = w_u =
// exp(cl - cum_u) dt_u; out[chunk] = the state before the chunk, then
// S = exp(cl) S + sum_u coef_u p_u q_u^T. Reverse: p = dy, q = c, coef_t
// = e_t = exp(cum_t), chunks from the last; out[chunk] = dS of the
// chunk's end, then dS = exp(cl) dS + sum_t coef_t p_t q_t^T. Block
// (batch * H + head, DS-row slice); thread tile rows dq + 8 i (i < 4),
// columns 4 nq .. 4 nq + 3.
template <typename T, bool REV>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_sweep(const T* __restrict__ p, long long spb, long long spl,
              const T* __restrict__ q, long long sqb, long long sql,
              const T* __restrict__ dt, const float* __restrict__ a,
              float* __restrict__ out, int L, int H, int Dh, int G, int N,
              int lc, int nch) {
  extern __shared__ float4 smem4[];
  float* P = reinterpret_cast<float*>(smem4);   // LCMAX x DS
  float* Q = P + LCMAX * DS;                    // LCMAX x NMAX
  float* dtv = Q + LCMAX * NMAX;                // LCMAX each
  float* cum = dtv + LCMAX;
  float* coef = cum + LCMAX;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, bi = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int d0 = blockIdx.y * DS;
  const float ah = a[h];
  const T* pb = p + (long long)bi * spb + (long long)h * Dh + d0;
  const T* qb = q + (long long)bi * sqb + (long long)g * N;
  const T* dtb = dt + (long long)bi * L * H + h;
  const int nq = tid & 31, dq = tid >> 5;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int it = 0; it < nch; ++it) {
    const int ch = REV ? nch - 1 - it : it;
    const int t0 = ch * lc;
    __syncthreads();   // the last chunk's reads of P, Q and coef are done
    chunk_cumsum<T>(dtb, H, ah, t0, lc, L, dtv, cum);
    const float cl = cum[lc - 1];
    for (int u = tid; u < LCMAX; u += THREADS)
      coef[u] = u < lc ? (REV ? expf(cum[u]) : expf(cl - cum[u]) * dtv[u])
                       : 0.f;
    __syncthreads();
    for (int i = tid; i < LCMAX * DS; i += THREADS) {
      const int u = i / DS, d = i % DS;
      P[i] = (u < lc && t0 + u < L && d0 + d < Dh)
                 ? coef[u] * to_f(pb[(long long)(t0 + u) * spl + d]) : 0.f;
    }
    for (int i = tid; i < LCMAX * NMAX; i += THREADS) {
      const int u = i / NMAX, n = i % NMAX;
      Q[i] = (u < lc && t0 + u < L && n < N)
                 ? to_f(qb[(long long)(t0 + u) * sql + n]) : 0.f;
    }
    __syncthreads();
    // the value at the chunk's boundary, before this chunk's update
    float* ob = out + ((((long long)bi * nch + ch) * H + h) * Dh) * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = d0 + dq + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * nq + j;
        if (d < Dh && n < N) ob[(long long)d * N + n] = acc[i][j];
      }
    }
    const float el = expf(cl);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= el;
    if (4 * nq < N) {
      for (int u = 0; u < lc; ++u) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = P[u * DS + dq + 8 * i];
        const float4 qv = *reinterpret_cast<const float4*>(Q + u * NMAX +
                                                           4 * nq);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(pv[i], qv.x, acc[i][0]);
          acc[i][1] = fmaf(pv[i], qv.y, acc[i][1]);
          acc[i][2] = fmaf(pv[i], qv.z, acc[i][2]);
          acc[i][3] = fmaf(pv[i], qv.w, acc[i][3]);
        }
      }
    }
  }
}

constexpr size_t sweep_smem_floats() {
  return (size_t)LCMAX * DS + (size_t)LCMAX * NMAX + 3 * (size_t)LCMAX;
}

// acc[i][j] += sum_{k < K} fa(k, ty + 16 i) * fb(k, tx + 16 j) over
// k-panels of KP rows staged in shared memory (As, Bs: KP x PS). A
// loader returns 0 outside its operand. KFA / KFB: the panel is filled
// with k fastest across threads (for operands whose k is their
// contiguous axis), else with the row fastest.
template <bool KFA, bool KFB, typename FA, typename FB>
__device__ __forceinline__ void gemm(float (&acc)[8][8], int K, float* As,
                                     float* Bs, FA fa, FB fb) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int k0 = 0; k0 < K; k0 += KP) {
    __syncthreads();   // the last panel's (and the caller's) reads are done
    for (int e = tid; e < KP * LCMAX; e += THREADS) {
      const int kk = KFA ? e % KP : e / LCMAX;
      const int r = KFA ? e / KP : e % LCMAX;
      As[kk * PS + r] = k0 + kk < K ? fa(k0 + kk, r) : 0.f;
    }
    for (int e = tid; e < KP * LCMAX; e += THREADS) {
      const int kk = KFB ? e % KP : e / LCMAX;
      const int r = KFB ? e / KP : e % LCMAX;
      Bs[kk * PS + r] = k0 + kk < K ? fb(k0 + kk, r) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KP; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = As[kk * PS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Bs[kk * PS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// the sum of v over the 16 lanes that share a row block (fixed order)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

constexpr size_t chunk_smem_floats() {
  return 2 * (size_t)LCMAX * TS + 2 * (size_t)KP * PS +
         2 * 16 * (size_t)LCMAX + 10 * (size_t)LCMAX + THREADS;
}

// One block per (batch, chunk, head): every gradient of the chunk given
// S (its start state) and dS (the gradient of its end state); see the
// head note. Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i
// and columns tx + 16 j of each product's output tile.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_chunk(const T* __restrict__ x, const T* __restrict__ dt,
              const float* __restrict__ a, const T* __restrict__ b,
              const T* __restrict__ c, const T* __restrict__ dy,
              const float* __restrict__ S, const float* __restrict__ dS,
              T* __restrict__ dx, T* __restrict__ ddt,
              float* __restrict__ dbh, float* __restrict__ dch,
              float* __restrict__ dap, int L, int H, int Dh, int G, int N,
              int lc, int nch, long long sxb, long long sxl, long long sbb,
              long long sbl, long long scb, long long scl, long long syb,
              long long syl) {
  extern __shared__ float4 smem4[];
  float* Msm = reinterpret_cast<float*>(smem4);   // LCMAX x TS: M[t][u]
  float* dGsm = Msm + LCMAX * TS;                 // dG[t][u]
  float* As = dGsm + LCMAX * TS;                  // KP x PS
  float* Bs = As + KP * PS;
  float* colP = Bs + KP * PS;                     // 16 x LCMAX partials
  float* colD = colP + 16 * LCMAX;
  float* dtv = colD + 16 * LCMAX;                 // LCMAX each
  float* cum = dtv + LCMAX;
  float* ecum = cum + LCMAX;
  float* wv = ecum + LCMAX;
  float* prow = wv + LCMAX;     // P's row sums
  float* pcol = prow + LCMAX;   // P's column sums
  float* dirv = pcol + LCMAX;   // sum_t dM G L (dt's direct term via M)
  float* eterm = dirv + LCMAX;  // e_t (dY_t . S c_t)
  float* dwv = eterm + LCMAX;   // x_u^T dS b_u
  float* dcum = dwv + LCMAX;
  float* red = dcum + LCMAX;    // THREADS

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int blk = blockIdx.x;
  const int h = blk % H, ch = (blk / H) % nch, bi = blk / (H * nch);
  const int g = h / (H / G);
  const int t0 = ch * lc;
  const float ah = a[h];
  const T* xb = x + (long long)bi * sxb + (long long)t0 * sxl +
                (long long)h * Dh;
  const T* yb = dy + (long long)bi * syb + (long long)t0 * syl +
                (long long)h * Dh;
  const T* bb = b + (long long)bi * sbb + (long long)t0 * sbl +
                (long long)g * N;
  const T* cb = c + (long long)bi * scb + (long long)t0 * scl +
                (long long)g * N;
  const long long soff = (((long long)bi * nch + ch) * H + h) * Dh * N;
  const float* Sb = S + soff;     // (Dh, N)
  const float* dSb = dS + soff;
  const int nv = min(lc, L - t0);   // valid rows of the chunk

  chunk_cumsum<T>(dt + (long long)bi * L * H + h, H, ah, t0, lc, L, dtv,
                  cum);
  const float cl = cum[lc - 1];
  for (int u = tid; u < LCMAX; u += THREADS) {
    ecum[u] = u < lc ? expf(cum[u]) : 0.f;
    wv[u] = u < lc ? expf(cl - cum[u]) * dtv[u] : 0.f;
  }

  auto X = [&](int u, int d) {
    return (u < nv && d < Dh) ? to_f(xb[(long long)u * sxl + d]) : 0.f;
  };
  auto DY = [&](int t, int d) {
    return (t < nv && d < Dh) ? to_f(yb[(long long)t * syl + d]) : 0.f;
  };
  auto Bv = [&](int u, int n) {
    return (u < nv && n < N) ? to_f(bb[(long long)u * sbl + n]) : 0.f;
  };
  auto Cv = [&](int t, int n) {
    return (t < nv && n < N) ? to_f(cb[(long long)t * scl + n]) : 0.f;
  };

  // ---- G = C B^T and dM = dY X^T over the lc x lc square ----------------
  float gacc[8][8], macc[8][8];
  zero(gacc);
  zero(macc);
  gemm<true, true>(gacc, N, As, Bs, [&](int n, int t) { return Cv(t, n); },
                   [&](int n, int u) { return Bv(u, n); });
  gemm<true, true>(macc, Dh, As, Bs, [&](int d, int t) { return DY(t, d); },
                   [&](int d, int u) { return X(u, d); });
  {
    float rowp[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) rowp[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int u = tx + 16 * j;
      float cp = 0.f, cd = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i;
        const bool on = u <= t && t < lc;
        const float lv = on ? expf(cum[t] - cum[u]) : 0.f;
        const float m = gacc[i][j] * lv * dtv[u];
        const float dm = on ? macc[i][j] : 0.f;
        Msm[t * TS + u] = m;
        dGsm[t * TS + u] = dm * lv * dtv[u];
        const float pv = dm * m;
        rowp[i] += pv;
        cp += pv;
        cd += dm * gacc[i][j] * lv;
      }
      colP[ty * LCMAX + u] = cp;
      colD[ty * LCMAX + u] = cd;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = sum16(rowp[i]);
      if (tx == 0) prow[ty + 16 * i] = s;
    }
  }
  __syncthreads();
  for (int u = tid; u < LCMAX; u += THREADS) {
    float sp = 0.f, sd = 0.f;
    for (int k = 0; k < 16; ++k) {
      sp += colP[k * LCMAX + u];
      sd += colD[k * LCMAX + u];
    }
    pcol[u] = sp;
    dirv[u] = sd;
  }

  float acc[8][8], acc2[8][8];
  // ---- dX = M^T dY + diag(w) B dS^T; dw = rowsum(X * B dS^T) ------------
  float dwp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) dwp[i] = 0.f;
  for (int dc0 = 0; dc0 < Dh; dc0 += LCMAX) {
    zero(acc);
    zero(acc2);
    gemm<false, false>(acc, lc, As, Bs,
                       [&](int t, int u) { return Msm[t * TS + u]; },
                       [&](int t, int d) { return DY(t, dc0 + d); });
    gemm<true, true>(acc2, N, As, Bs, [&](int n, int u) { return Bv(u, n); },
                     [&](int n, int d) {
                       return dc0 + d < Dh ? dSb[(long long)(dc0 + d) * N + n]
                                           : 0.f;
                     });
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int u = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = dc0 + tx + 16 * j;
        if (u < nv && d < Dh) {
          dx[(((long long)bi * L + t0 + u) * H + h) * Dh + d] =
              from_f<T>(acc[i][j] + wv[u] * acc2[i][j]);
          dwp[i] += X(u, d) * acc2[i][j];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float s = sum16(dwp[i]);
    if (tx == 0) dwv[ty + 16 * i] = s;
  }

  // ---- dC = dG B + diag(e) dY S; eterm = e * rowsum(C * dY S) -----------
  zero(acc);
  zero(acc2);
  gemm<false, false>(acc, lc, As, Bs,
                     [&](int u, int t) { return dGsm[t * TS + u]; },
                     [&](int u, int n) { return Bv(u, n); });
  gemm<true, false>(acc2, Dh, As, Bs, [&](int d, int t) { return DY(t, d); },
                    [&](int d, int n) {
                      return n < N ? Sb[(long long)d * N + n] : 0.f;
                    });
  {
    float ep[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty + 16 * i;
      ep[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (t < nv && n < N) {
          dch[(((long long)bi * L + t0 + t) * H + h) * N + n] =
              acc[i][j] + ecum[t] * acc2[i][j];
          ep[i] += Cv(t, n) * acc2[i][j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = sum16(ep[i]);
      const int t = ty + 16 * i;
      if (tx == 0) eterm[t] = ecum[t] * s;
    }
  }

  // ---- dB = dG^T C + diag(w) X dS ---------------------------------------
  zero(acc);
  zero(acc2);
  gemm<false, false>(acc, lc, As, Bs,
                     [&](int t, int u) { return dGsm[t * TS + u]; },
                     [&](int t, int n) { return Cv(t, n); });
  gemm<true, false>(acc2, Dh, As, Bs, [&](int d, int u) { return X(u, d); },
                    [&](int d, int n) {
                      return n < N ? dSb[(long long)d * N + n] : 0.f;
                    });
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int u = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j;
      if (u < nv && n < N)
        dbh[(((long long)bi * L + t0 + u) * H + h) * N + n] =
            acc[i][j] + wv[u] * acc2[i][j];
    }
  }

  // ---- <dS, S>, then dcum, its reverse cumsum, ddt and da's partial -----
  float part = 0.f;
  for (int e = tid; e < Dh * N; e += THREADS) part += dSb[e] * Sb[e];
  red[tid] = part;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) {
    float dcl = 0.f;
    for (int u = 0; u < lc; ++u) {
      dcum[u] = prow[u] - pcol[u] + eterm[u] - dwv[u] * wv[u];
      dcl += dwv[u] * wv[u];
    }
    dcum[lc - 1] += dcl + expf(cl) * red[0];
    float run = 0.f, dap_ = 0.f;
    for (int u = lc - 1; u >= 0; --u) {
      run += dcum[u];
      dcum[u] = run;              // d(dt a) at row u
      dap_ += dtv[u] * run;
    }
    dap[((long long)bi * nch + ch) * H + h] = dap_;
  }
  __syncthreads();
  for (int u = tid; u < nv; u += THREADS)
    ddt[((long long)bi * L + t0 + u) * H + h] = from_f<T>(
        dirv[u] + dwv[u] * expf(cl - cum[u]) + ah * dcum[u]);
}

// db and dc of each group: the sums of its heads' in head order; da the
// sum of its partials in (batch, chunk) order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce(const float* __restrict__ dbh, const float* __restrict__ dch,
               const float* __restrict__ dap, T* __restrict__ db,
               T* __restrict__ dc, float* __restrict__ da, int B, int L,
               int H, int G, int N, int nch) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int rep = H / G;
  const long long total = (long long)B * L * G * N;
  if (i < total) {
    const int n = (int)(i % N);
    const int gi = (int)((i / N) % G);
    const long long bt = i / ((long long)N * G);   // batch * L + row
    const long long base = (bt * H + (long long)gi * rep) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < rep; ++r) {
      sb += dbh[base + (long long)r * N];
      sc += dch[base + (long long)r * N];
    }
    db[i] = from_f<T>(sb);
    dc[i] = from_f<T>(sc);
  }
  if (i < H) {
    float s = 0.f;
    for (long long k = 0; k < (long long)B * nch; ++k) s += dap[k * H + i];
    da[i] = s;
  }
}

template <typename T>
int launch(const void* x, const void* dt, const float* a, const void* b,
           const void* c, const void* dy, void* dx, void* ddt, float* da,
           void* db, void* dc, float* work, int B, int L, int H, int Dh,
           int G, int N, int lc, const long long* st, cudaStream_t stream) {
  const int nch = (L + lc - 1) / lc;
  const long long nstate = (long long)B * nch * H * Dh * N;
  const long long nhead = (long long)B * L * H * N;
  float* S = work;
  float* dS = S + nstate;
  float* dbh = dS + nstate;
  float* dch = dbh + nhead;
  float* dap = dch + nhead;
  const T* xt = static_cast<const T*>(x);
  const T* dtt = static_cast<const T*>(dt);
  const T* bt = static_cast<const T*>(b);
  const T* ct = static_cast<const T*>(c);
  const T* yt = static_cast<const T*>(dy);

  const size_t sw = sweep_smem_floats() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_sweep<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sw);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(ssd_bwd_sweep<T, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sw);
  if (e != cudaSuccess) return (int)e;
  const dim3 sgrid(B * H, (Dh + DS - 1) / DS);
  ssd_bwd_sweep<T, false><<<sgrid, THREADS, sw, stream>>>(
      xt, st[0], st[1], bt, st[2], st[3], dtt, a, S, L, H, Dh, G, N, lc,
      nch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_sweep<T, true><<<sgrid, THREADS, sw, stream>>>(
      yt, st[6], st[7], ct, st[4], st[5], dtt, a, dS, L, H, Dh, G, N, lc,
      nch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t cs = chunk_smem_floats() * sizeof(float);
  e = cudaFuncSetAttribute(ssd_bwd_chunk<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)cs);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_chunk<T><<<B * nch * H, THREADS, cs, stream>>>(
      xt, dtt, a, bt, ct, yt, S, dS, static_cast<T*>(dx),
      static_cast<T*>(ddt), dbh, dch, dap, L, H, Dh, G, N, lc, nch, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7]);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const long long total = (long long)B * L * G * N;
  const long long n = total > H ? total : H;
  ssd_bwd_reduce<T><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                      stream>>>(dbh, dch, dap, static_cast<T*>(db),
                                static_cast<T*>(dc), da, B, L, H, G, N, nch);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of each workspace the caller allocates, in `out`: the chunk
// states, their gradients, db and dc per head, da's partials. Returns
// their sum.
extern "C" long long saath_ssd_scan_bwd_workspace(int B, int L, int H,
                                                  int Dh, int N, int lc,
                                                  long long* out) {
  const long long nch = (L + lc - 1) / lc;
  const long long nstate = (long long)B * nch * H * Dh * N;
  const long long nhead = (long long)B * L * H * N;
  const long long parts[5] = {nstate, nstate, nhead, nhead,
                              (long long)B * nch * H};
  long long sum = 0;
  for (int i = 0; i < 5; ++i) {
    if (out) out[i] = parts[i];
    sum += parts[i];
  }
  return sum;
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
    return launch<__nv_bfloat16>(x, dt, a, b, c, dy, dx, ddt, da, db, dc,
                                 work, B, L, H, Dh, G, N, lc, strides, s);
  return launch<float>(x, dt, a, b, c, dy, dx, ddt, da, db, dc, work, B, L,
                       H, Dh, G, N, lc, strides, s);
}
