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
// contiguous, all f32 or all bf16; arithmetic and sums in f32, outputs
// in the inputs' type. (D, DV) one of (16, 16), (32, 32), (64, 64),
// (128, 128) and (192, 128), the forward's pairs.
//
// Bound on this card: at StarCoder2-3B's train shape (B 4, H 24, Hkv 2,
// S = T = 2048, D = DV = 128, causal) the three launches recompute the
// scores three times and form four more products: (5 D + 3 DV)
// multiply-adds for each of the 201 M unmasked pairs, 0.41 TFLOP; at
// the bf16 tensor-core rate (989 TFLOP/s) 0.42 ms, at the f32 rate of
// the CUDA cores (67 TFLOP/s) 6.2 ms. Its bytes (q, k, v, o and do read
// once, dq, dk and dv written once, 0.17 GB in bf16) take 0.05 ms. So it
// is bound by its products; this first design keeps them on the CUDA
// cores in f32 (a wgmma design is later work, ROADMAP "Kernel
// headroom").
//
// Design: three launches, no atomics (every output element has one
// owner, so the gradients are the same from run to run):
//   1. stats: one block of 256 threads per (batch, head, tile of BQ = 64
//      query rows); it recomputes the scores against key tiles of BK =
//      32 up to the tile's causal limit, keeps each row's running max m
//      and sum l (warp w owns rows w, w + 8, ..., lane j scores key j of
//      the tile, shuffles reduce across the lanes), and writes m,
//      1 / max(l, 1e-30) and delta = do . o (f32 scratch, (B, H, S)
//      each).
//   2. dk, dv: one block per (batch, KV head, tile of BK = 32 keys),
//      heaviest causal tiles first; it holds its K and V tiles and loops
//      over the G query heads and their query tiles from the first one
//      its keys can see: scores and dp as in 1 (lane j, rows of warp w),
//      p and ds to shared memory, then thread (key = lane, column group
//      = warp) adds p do and ds q over the tile's 64 rows into
//      registers.
//   3. dq: one block per (batch, head, query tile), looping over the key
//      tiles up to its causal limit; scores, dp and ds as in 2, then
//      thread (row = tid % 64, column group = tid / 64) adds ds k.
// Tiles sit in shared memory as f32 rows padded by 4 floats, so that
// the lanes' float4 reads of 32 different rows hit distinct banks while
// the other operand is one broadcast read. Dynamic shared memory at
// (192, 128): 75 KB (1), 143 KB (2), 135 KB (3).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;              // query rows per tile
constexpr int BK = 32;              // keys per tile (one a lane)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPW = BQ / WARPS;     // query rows per warp in a score tile
constexpr int PAD = 4;              // floats of padding per tile row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// (batch, head, row) strides of one tensor
struct Str {
  long long b, h, s;
};

// rows [r0, r0 + n) of a strided (rows x W) matrix into shared memory
// as f32 rows of W + PAD floats, zeros past `rows`
template <typename T, int W>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long ss, int r0, int n,
                                          int rows) {
  for (int idx = threadIdx.x; idx < n * W; idx += THREADS) {
    const int r = idx / W, c = idx % W;
    dst[r * (W + PAD) + c] =
        r0 + r < rows ? to_f(src[(long long)(r0 + r) * ss + c]) : 0.f;
  }
}

// out[r] = a_{rw + r WARPS} . key for the RPW rows of warp rw: the key
// row (this lane's own) is read once per 4 columns, the query rows are
// broadcast reads
template <int W>
__device__ __forceinline__ void dots(float out[RPW], const float* a, int rw,
                                     const float* key) {
#pragma unroll
  for (int r = 0; r < RPW; ++r) out[r] = 0.f;
#pragma unroll 4
  for (int d = 0; d < W; d += 4) {
    const float4 y = *reinterpret_cast<const float4*>(key + d);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(
          a + (rw + r * WARPS) * (W + PAD) + d);
      out[r] = fmaf(x.x, y.x, out[r]);
      out[r] = fmaf(x.y, y.y, out[r]);
      out[r] = fmaf(x.z, y.z, out[r]);
      out[r] = fmaf(x.w, y.w, out[r]);
    }
  }
}

// acc[c] += w * row[c] over N columns (a broadcast read)
template <int N>
__device__ __forceinline__ void axpy(float acc[N], float w,
                                     const float* row) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(row + c);
      acc[c] = fmaf(w, x.x, acc[c]);
      acc[c + 1] = fmaf(w, x.y, acc[c + 1]);
      acc[c + 2] = fmaf(w, x.z, acc[c + 2]);
      acc[c + 3] = fmaf(w, x.w, acc[c + 3]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) acc[c] = fmaf(w, row[c], acc[c]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int w = 16; w >= 1; w /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, w));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int w = 16; w >= 1; w /= 2) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

__device__ __forceinline__ bool visible(int qrow, int key, int S, int Tk,
                                        int causal, int q_offset) {
  return qrow < S && key < Tk && (!causal || key <= q_offset + qrow);
}

// ---- 1. per query row: m, 1 / max(l, 1e-30) and delta = do . o --------
template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_stats(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ o, const T* __restrict__ dout,
          float* __restrict__ stats, int H, int G, int S, int Tk, Str qs,
          Str ks, Str os, Str dos, float scale, int causal, int q_offset) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // BQ x (D + PAD)
  float* Ks = Qs + BQ * (D + PAD);        // BK x (D + PAD)
  const int lane = threadIdx.x % 32, rw = threadIdx.x / 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / G) * ks.h;
  load_rows<T, D>(Qs, qb, qs.s, q0, BQ, S);

  float m[RPW], l[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
  const int q_last = min(q0 + BQ, S) - 1;
  const int kend = causal ? min(Tk, q_offset + q_last + 1) : Tk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    load_rows<T, D>(Ks, kb, ks.s, k0, BK, Tk);
    __syncthreads();
    float s[RPW];
    dots<D>(s, Qs, rw, Ks + lane * (D + PAD));
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = q0 + rw + r * WARPS;
      const float x = visible(i, k0 + lane, S, Tk, causal, q_offset)
                          ? s[r] * scale
                          : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(x));
      l[r] = l[r] * expf(m[r] - m_new) + warp_sum(expf(x - m_new));
      m[r] = m_new;
    }
  }

  const size_t plane = (size_t)gridDim.z * H * S;
  float* sb = stats + ((size_t)b * H + h) * S;
  const T* ob = o + b * os.b + h * os.h;
  const T* db = dout + b * dos.b + h * dos.h;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = q0 + rw + r * WARPS;
    if (i >= S) continue;
    float dl = 0.f;
    for (int e = lane; e < DV; e += 32)
      dl = fmaf(to_f(db[(long long)i * dos.s + e]),
                to_f(ob[(long long)i * os.s + e]), dl);
    dl = warp_sum(dl);
    if (lane == 0) {
      sb[i] = m[r];
      sb[plane + i] = 1.f / fmaxf(l[r], 1e-30f);
      sb[2 * plane + i] = dl;
    }
  }
}

// shared scores of 2 and 3: p and ds of the tile's rows (warp rw) against
// this lane's key, from Qs / dOs rows and the lane's K / V rows
template <int D, int DV>
__device__ __forceinline__ void probs(float p[RPW], float ds[RPW],
                                      const float* Qs, const float* dOs,
                                      const float* krow, const float* vrow,
                                      const float* st_m, const float* st_rl,
                                      const float* st_d, int rw, int q0,
                                      int key, int S, int Tk, float scale,
                                      int causal, int q_offset) {
  float s[RPW], dp[RPW];
  dots<D>(s, Qs, rw, krow);
  dots<DV>(dp, dOs, rw, vrow);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int ir = rw + r * WARPS;
    p[r] = visible(q0 + ir, key, S, Tk, causal, q_offset)
               ? expf(s[r] * scale - st_m[ir]) * st_rl[ir]
               : 0.f;
    ds[r] = p[r] * (dp[r] - st_d[ir]);
  }
}

// the stats of query rows [q0, q0 + BQ) of head h into shared memory
// (rows past S: m 0, 1/l 0, delta 0, so their p is 0)
__device__ __forceinline__ void load_stats(float* st, const float* stats,
                                           size_t plane, int b, int h,
                                           int H, int S, int q0) {
  const float* sb = stats + ((size_t)b * H + h) * S;
  for (int idx = threadIdx.x; idx < 3 * BQ; idx += THREADS) {
    const int w = idx / BQ, r = idx % BQ;
    st[idx] = q0 + r < S ? sb[w * plane + q0 + r] : 0.f;
  }
}

// ---- 2. dk and dv: one block per (batch, KV head, key tile) -------------
template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ stats, T* __restrict__ dk,
         T* __restrict__ dv, int H, int G, int S, int Tk, Str qs, Str ks,
         Str vs, Str dos, Str dks, Str dvs, float scale, int causal,
         int q_offset) {
  constexpr int CK = D / WARPS;    // dk columns of a thread
  constexpr int CV = DV / WARPS;   // dv columns of a thread
  extern __shared__ float smem[];
  float* Ks = smem;                        // BK x (D + PAD)
  float* Vs = Ks + BK * (D + PAD);         // BK x (DV + PAD)
  float* Qs = Vs + BK * (DV + PAD);        // BQ x (D + PAD)
  float* dOs = Qs + BQ * (D + PAD);        // BQ x (DV + PAD)
  float* Ps = dOs + BQ * (DV + PAD);       // BQ x BK
  float* dSs = Ps + BQ * BK;               // BQ x BK
  float* st = dSs + BQ * BK;               // m, 1/l, delta: 3 x BQ
  const int lane = threadIdx.x % 32, rw = threadIdx.x / 32;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const size_t plane = (size_t)gridDim.z * H * S;
  load_rows<T, D>(Ks, k + b * ks.b + kvh * ks.h, ks.s, k0, BK, Tk);
  load_rows<T, DV>(Vs, v + b * vs.b + kvh * vs.h, vs.s, k0, BK, Tk);

  float acc_k[CK], acc_v[CV];
#pragma unroll
  for (int c = 0; c < CK; ++c) acc_k[c] = 0.f;
#pragma unroll
  for (int c = 0; c < CV; ++c) acc_v[c] = 0.f;

  const int qstart = causal ? max(0, k0 - q_offset) / BQ * BQ : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* db = dout + b * dos.b + h * dos.h;
    for (int q0 = qstart; q0 < S; q0 += BQ) {
      __syncthreads();   // the last tile's Ps, dSs, Qs and dOs read
      load_rows<T, D>(Qs, qb, qs.s, q0, BQ, S);
      load_rows<T, DV>(dOs, db, dos.s, q0, BQ, S);
      load_stats(st, stats, plane, b, h, H, S, q0);
      __syncthreads();
      float p[RPW], ds[RPW];
      probs<D, DV>(p, ds, Qs, dOs, Ks + lane * (D + PAD),
                   Vs + lane * (DV + PAD), st, st + BQ, st + 2 * BQ, rw, q0,
                   k0 + lane, S, Tk, scale, causal, q_offset);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        Ps[(rw + r * WARPS) * BK + lane] = p[r];
        dSs[(rw + r * WARPS) * BK + lane] = ds[r];
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        axpy<CV>(acc_v, Ps[i * BK + lane], dOs + i * (DV + PAD) + rw * CV);
        axpy<CK>(acc_k, dSs[i * BK + lane], Qs + i * (D + PAD) + rw * CK);
      }
    }
  }

  const int j = k0 + lane;
  if (j >= Tk) return;
  T* dkr = dk + b * dks.b + kvh * dks.h + (long long)j * dks.s + rw * CK;
  T* dvr = dv + b * dvs.b + kvh * dvs.h + (long long)j * dvs.s + rw * CV;
#pragma unroll
  for (int c = 0; c < CK; ++c) dkr[c] = from_f<T>(acc_k[c] * scale);
#pragma unroll
  for (int c = 0; c < CV; ++c) dvr[c] = from_f<T>(acc_v[c]);
}

// ---- 3. dq: one block per (batch, head, query tile) --------------------
template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ stats, T* __restrict__ dq, int H, int G,
       int S, int Tk, Str qs, Str ks, Str vs, Str dos, Str dqs, float scale,
       int causal, int q_offset) {
  constexpr int GROUPS = THREADS / BQ;   // column groups of dq
  constexpr int CQ = D / GROUPS;         // dq columns of a thread
  constexpr int DSL = BK + 1;            // row length of dSs
  extern __shared__ float smem[];
  float* Qs = smem;                        // BQ x (D + PAD)
  float* dOs = Qs + BQ * (D + PAD);        // BQ x (DV + PAD)
  float* Ks = dOs + BQ * (DV + PAD);       // BK x (D + PAD)
  float* Vs = Ks + BK * (D + PAD);         // BK x (DV + PAD)
  float* dSs = Vs + BK * (DV + PAD);       // BQ x DSL
  float* st = dSs + BQ * DSL;              // 3 x BQ
  const int lane = threadIdx.x % 32, rw = threadIdx.x / 32;
  const int row = threadIdx.x % BQ, cg = threadIdx.x / BQ;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t plane = (size_t)gridDim.z * H * S;
  const T* kb = k + b * ks.b + (h / G) * ks.h;
  const T* vb = v + b * vs.b + (h / G) * vs.h;
  load_rows<T, D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, BQ, S);
  load_rows<T, DV>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, BQ, S);
  load_stats(st, stats, plane, b, h, H, S, q0);

  float acc[CQ];
#pragma unroll
  for (int c = 0; c < CQ; ++c) acc[c] = 0.f;
  const int q_last = min(q0 + BQ, S) - 1;
  const int kend = causal ? min(Tk, q_offset + q_last + 1) : Tk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();   // Qs, dOs and stats written; the last dSs and Ks read
    load_rows<T, D>(Ks, kb, ks.s, k0, BK, Tk);
    load_rows<T, DV>(Vs, vb, vs.s, k0, BK, Tk);
    __syncthreads();
    float p[RPW], ds[RPW];
    probs<D, DV>(p, ds, Qs, dOs, Ks + lane * (D + PAD),
                 Vs + lane * (DV + PAD), st, st + BQ, st + 2 * BQ, rw, q0,
                 k0 + lane, S, Tk, scale, causal, q_offset);
#pragma unroll
    for (int r = 0; r < RPW; ++r) dSs[(rw + r * WARPS) * DSL + lane] = ds[r];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j)
      axpy<CQ>(acc, dSs[row * DSL + j], Ks + j * (D + PAD) + cg * CQ);
  }

  if (q0 + row >= S) return;
  T* dqr = dq + b * dqs.b + h * dqs.h + (long long)(q0 + row) * dqs.s +
           cg * CQ;
#pragma unroll
  for (int c = 0; c < CQ; ++c) dqr[c] = from_f<T>(acc[c] * scale);
}

template <int D, int DV>
constexpr size_t stats_bytes() {
  return (size_t)(BQ + BK) * (D + PAD) * sizeof(float);
}
template <int D, int DV>
constexpr size_t dkdv_bytes() {
  return ((size_t)(BK + BQ) * (D + PAD + DV + PAD) + 2 * BQ * BK + 3 * BQ) *
         sizeof(float);
}
template <int D, int DV>
constexpr size_t dq_bytes() {
  return ((size_t)(BK + BQ) * (D + PAD + DV + PAD) + BQ * (BK + 1) +
          3 * BQ) * sizeof(float);
}

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// st: 8 x (batch, head, row) strides of q, k, v, o, do, dq, dk, dv
template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* stats,
           int B, int H, int Hkv, int S, int Tk, const long long* st,
           float scale, int causal, int q_offset, cudaStream_t stream) {
  const Str qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]},
      dos{st[12], st[13], st[14]}, dqs{st[15], st[16], st[17]},
      dks{st[18], st[19], st[20]}, dvs{st[21], st[22], st[23]};
  const int G = H / Hkv;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  cudaError_t e;
  if ((e = allow_smem(bwd_stats<T, D, DV>, stats_bytes<D, DV>())) ||
      (e = allow_smem(bwd_dkdv<T, D, DV>, dkdv_bytes<D, DV>())) ||
      (e = allow_smem(bwd_dq<T, D, DV>, dq_bytes<D, DV>())))
    return (int)e;
  const int qtiles = (S + BQ - 1) / BQ, ktiles = (Tk + BK - 1) / BK;
  bwd_stats<T, D, DV><<<dim3(qtiles, H, B), THREADS, stats_bytes<D, DV>(),
                        stream>>>(qp, kp, static_cast<const T*>(o), dop,
                                  stats, H, G, S, Tk, qs, ks, os, dos,
                                  scale, causal, q_offset);
  if ((e = cudaGetLastError())) return (int)e;
  bwd_dkdv<T, D, DV><<<dim3(ktiles, Hkv, B), THREADS, dkdv_bytes<D, DV>(),
                       stream>>>(qp, kp, vp, dop, stats,
                                 static_cast<T*>(dk), static_cast<T*>(dv),
                                 H, G, S, Tk, qs, ks, vs, dos, dks, dvs,
                                 scale, causal, q_offset);
  if ((e = cudaGetLastError())) return (int)e;
  bwd_dq<T, D, DV><<<dim3(qtiles, H, B), THREADS, dq_bytes<D, DV>(),
                     stream>>>(qp, kp, vp, dop, stats, static_cast<T*>(dq),
                               H, G, S, Tk, qs, ks, vs, dos, dqs, scale,
                               causal, q_offset);
  return (int)cudaGetLastError();
}

constexpr int widths(int D, int DV) { return D * 1024 + DV; }

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, float* stats,
             int B, int H, int Hkv, int S, int Tk, int D, int DV,
             const long long* st, float scale, int causal, int q_offset,
             cudaStream_t s) {
  switch (widths(D, DV)) {
    case widths(16, 16):
      return launch<T, 16, 16>(q, k, v, o, dout, dq, dk, dv, stats, B, H,
                               Hkv, S, Tk, st, scale, causal, q_offset, s);
    case widths(32, 32):
      return launch<T, 32, 32>(q, k, v, o, dout, dq, dk, dv, stats, B, H,
                               Hkv, S, Tk, st, scale, causal, q_offset, s);
    case widths(64, 64):
      return launch<T, 64, 64>(q, k, v, o, dout, dq, dk, dv, stats, B, H,
                               Hkv, S, Tk, st, scale, causal, q_offset, s);
    case widths(128, 128):
      return launch<T, 128, 128>(q, k, v, o, dout, dq, dk, dv, stats, B, H,
                                 Hkv, S, Tk, st, scale, causal, q_offset, s);
    case widths(192, 128):
      return launch<T, 192, 128>(q, k, v, o, dout, dq, dk, dv, stats, B, H,
                                 Hkv, S, Tk, st, scale, causal, q_offset, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// the whole backward of one attention call: three launches on `stream`;
// stats is an f32 scratch of 3 B H S floats. Returns the first CUDA
// error (0 on success).
extern "C" int saath_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* stats, int B,
    int H, int Hkv, int S, int Tk, int D, int Dv, const long long* strides,
    float scale, int causal, int q_offset, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, stats, B, H,
                                   Hkv, S, Tk, D, Dv, strides, scale, causal,
                                   q_offset, s);
  return launch_d<float>(q, k, v, o, dout, dq, dk, dv, stats, B, H, Hkv, S,
                         Tk, D, Dv, strides, scale, causal, q_offset, s);
}
