// Mamba-2 SSD chunked scan on Hopper (sm_90a): kernel K4.
//
// Replaces the Pallas kernel repro/kernels/ssd_scan.py:ssd_scan_pallas
// (body _ssd_kernel), the TPU fast path of the chunked SSD scan that the
// prefill of every Mamba layer runs (repro/models/mamba.py:162,
// ssd_chunked_jnp). Per head h (group g = h / (H / G)) the recurrence
//
//     S_t = exp(dt_t a_h) S_{t-1} + dt_t x_t b_t^T,   y_t = S_t c_t
//
// is computed chunk by chunk (chunk length lc): with cum the inclusive
// cumsum of dt a over the chunk,
//
//     y  = (c b^T * exp(cum_t - cum_u) [u <= t] * dt_u) x
//          + exp(cum_t) (c S^T)
//     S' = exp(cum_L) S + (x * exp(cum_L - cum) dt)^T b
//
// Inputs x (B, L, H, Dh), dt (B, L, H), b and c (B, L, G, N) in one type
// (f32 or bf16) and a (H,) f32, the optional initial state (B, H, Dh, N)
// f32. x, b and c are read through their batch and time-step strides
// (heads and state columns packed, unit innermost), so the Mamba mixer's
// views of its convolution output need no copy. Any L: rows past L read
// as zeros (dt = 0 leaves the state unchanged), which is the reference's
// zero padding, and are not written. Outputs: y in x's type (contiguous)
// and the final state in f32.
//
// Bound on this card: the f32 multiply-adds. At the serve shape (B = 4,
// L = 1024, H = 64, Dh = 64, N = 128, lc = 128) M x (causal half), c S^T
// and the state update are 5.4 G multiply-adds (0.16 ms at 67 TFLOP/s);
// c b^T is 33.8 M once per group; the bytes (about 78 MB in bf16) take
// 0.02 ms. Design:
//
//  * Two launches. ssd_gram writes the causal half of c b^T once per
//    (batch, group, chunk) into an f32 scratch that stays in L2 (2 MB at
//    the serve shape): the heads of a group and the blocks of a head
//    share it instead of each recomputing it.
//  * ssd_scan splits every head's state by rows: y[:, d] and S[d, :]
//    depend on column d of x alone, so a block owns DT columns of one
//    head (grid (B H, ceil(Dh / DT))) and carries its (DT, N) slice of the
//    state across the chunks in shared memory, with nothing shared between
//    blocks. DT = 64: 256 blocks of 256 threads, 99 KB of shared memory
//    each, two blocks an SM.
//  * The three products run as register-tiled matrix products over
//    k-panels of 32 rows staged in shared memory (c^T, M^T and the
//    weighted b in turn): each thread keeps an R x 4 tile (R = DT / 8) of
//    y or of the state update in registers and reads its operands as
//    16-byte vectors, 3 shared-memory reads per 32 multiply-adds at
//    DT = 64. The panels are double-buffered: while one is multiplied,
//    each thread's global loads of the next are in flight in registers,
//    and one barrier a panel hands the buffers over. The causal half of
//    M x is skipped warp by warp, and warps take row blocks in pairs
//    (w, 7 - w) so that the four schedulers carry equal work.
//  * The chunk's cumsum is a warp scan. The decay's argument is formed
//    only for u <= t (above the diagonal exp would overflow into inf * 0).
//  * Every product is f32 on the CUDA cores (M, S and the state weights
//    are f32): no tensor cores, TMA or TF32, as ROADMAP's float policy asks
//    for the f32 bar.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int LCMAX = 128;     // chunk rows a block holds
constexpr int NMAX = 128;      // state columns
constexpr int KP = 32;         // rows of one k-panel
constexpr int PS = LCMAX + 4;  // panel row stride (floats)
constexpr unsigned FULL = 0xffffffffu;
constexpr int DT = 64;         // state rows (head columns) a block owns

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

// A value's bits, held in a register while its load is in flight, and
// the f32 they stand for (a bf16 is the upper half of an f32)
__device__ __forceinline__ unsigned bits_of(const float* p) {
  return __float_as_uint(*p);
}
__device__ __forceinline__ unsigned bits_of(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}
template <typename T> __device__ __forceinline__ float from_bits(unsigned v);
template <> __device__ __forceinline__ float from_bits<float>(unsigned v) {
  return __uint_as_float(v);
}
template <>
__device__ __forceinline__ float from_bits<__nv_bfloat16>(unsigned v) {
  return __uint_as_float(v << 16);
}

// R consecutive floats (R a multiple of 4) from 16-byte-aligned shared
// memory
template <int R>
__device__ __forceinline__ void load_r(const float* p, float (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    v[i] = t.x;
    v[i + 1] = t.y;
    v[i + 2] = t.z;
    v[i + 3] = t.w;
  }
}

// GT[blk][u][t] = sum_n c[t][n] b[u][n] for u <= t < lc, blk = (batch,
// group, chunk). Block (blk, 32 x 32 tile (ju, jt) of (u, t)); the tiles
// above the diagonal exit at once. Each thread's loads of every state
// column (up to 16 + 16) are in flight together, then one barrier;
// thread tile 1 u x 4 t.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_gram(const T* __restrict__ b, const T* __restrict__ c,
         float* __restrict__ gt, int L, int G, int N, int lc, int nch,
         long long sbb, long long sbl, long long scb, long long scl) {
  constexpr int TS = KP + 4;                    // tile row stride
  constexpr int NP = NMAX / KP;                 // k-panels at most
  __shared__ __align__(16) float cs[NMAX * TS];  // [n][t]
  __shared__ __align__(16) float bs[NMAX * TS];  // [n][u]
  const int nt = (lc + KP - 1) / KP;
  const int ju = blockIdx.y / nt, jt = blockIdx.y % nt;
  if (ju > jt) return;
  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int ch = blk % nch, bg = blk / nch;
  const int g = bg % G, bi = bg / G;
  const int t0 = ch * lc, u0 = KP * ju, tt0 = KP * jt;
  const T* bb = b + (long long)bi * sbb + (long long)g * N;
  const T* cb = c + (long long)bi * scb + (long long)g * N;
  float cv[NP][4], bv[NP][4];
#pragma unroll
  for (int k = 0; k < NP; ++k)
#pragma unroll
    for (int m = 0; m < 4; ++m) {   // entry (n, r): 32 distinct banks a warp
      const int e = tid + THREADS * m, part = e >> 5;
      const int n = KP * k + 8 * (part & 3) + (e & 7);
      const int r = 4 * (part >> 2) + ((e >> 3) & 3);
      const int t = tt0 + r, u = u0 + r;
      cv[k][m] = (t < lc && t0 + t < L && n < N)
                     ? to_f(cb[(long long)(t0 + t) * scl + n]) : 0.f;
      bv[k][m] = (u < lc && t0 + u < L && n < N)
                     ? to_f(bb[(long long)(t0 + u) * sbl + n]) : 0.f;
    }
#pragma unroll
  for (int k = 0; k < NP; ++k)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int e = tid + THREADS * m, part = e >> 5;
      const int n = KP * k + 8 * (part & 3) + (e & 7);
      const int r = 4 * (part >> 2) + ((e >> 3) & 3);
      cs[n * TS + r] = cv[k][m];
      bs[n * TS + r] = bv[k][m];
    }
  __syncthreads();
  const int ul = tid >> 3, tq = 4 * (tid & 7);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int k = 0; k < N; ++k) {
    const float av = bs[k * TS + ul];
    const float4 t4 = *reinterpret_cast<const float4*>(cs + k * TS + tq);
    acc[0] = fmaf(av, t4.x, acc[0]);
    acc[1] = fmaf(av, t4.y, acc[1]);
    acc[2] = fmaf(av, t4.z, acc[2]);
    acc[3] = fmaf(av, t4.w, acc[3]);
  }
  const int u = u0 + ul;
  float* out = gt + ((long long)blk * lc + u) * lc;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = tt0 + tq + j;
    if (u < lc && t < lc && u <= t) out[t] = acc[j];
  }
}

constexpr size_t smem_floats() {
  return 2 * (size_t)KP * PS + (size_t)LCMAX * DT + (size_t)NMAX * DT +
         4 * (size_t)LCMAX;
}

// Block (batch * H + head, DT-column slice of the head); see the head
// note. Shared memory: two k-panels, X[u][d] (the chunk's x slice),
// ST[n][d] (the state slice), cum, exp(cum), dt and the state weights.
// Each chunk runs a pipeline of panels, c^T (n-panels) then M^T and the
// weighted b (u-panels): while a panel is multiplied, every thread's
// global loads of the next one are in flight in registers, and one
// barrier a panel hands the buffers over.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan(const T* __restrict__ x, const T* __restrict__ dt,
         const float* __restrict__ a, const T* __restrict__ b,
         const T* __restrict__ c, const float* __restrict__ gt,
         const float* __restrict__ s0, T* __restrict__ y,
         float* __restrict__ sfin, int L, int H, int Dh, int G, int N,
         int lc, int nch, long long sxb, long long sxl, long long sbb,
         long long sbl, long long scb, long long scl) {
  constexpr int R = DT / 8;     // y rows / state rows of a thread
  constexpr int CG = DT / 4;    // y column groups (4 columns each)
  constexpr int PE = KP * LCMAX / THREADS;   // panel entries a thread
  extern __shared__ float4 smem4[];
  float* panels = reinterpret_cast<float*>(smem4);  // 2 x KP x PS
  float* X = panels + 2 * KP * PS;                   // LCMAX x DT
  float* ST = X + LCMAX * DT;                        // NMAX x DT
  float* cum = ST + NMAX * DT;                       // LCMAX each
  float* ecum = cum + LCMAX;
  float* dtv = ecum + LCMAX;
  float* wv = dtv + LCMAX;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, bi = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int d0 = blockIdx.y * DT;
  const float ah = a[h];
  const T* xb = x + (long long)bi * sxb + (long long)h * Dh + d0;
  const T* bb = b + (long long)bi * sbb + (long long)g * N;
  const T* cb = c + (long long)bi * scb + (long long)g * N;
  const T* dtb = dt + (long long)bi * L * H + h;
  T* yb = y + (long long)bi * L * H * Dh + (long long)h * Dh + d0;
  const long long sbase = ((long long)bh * Dh + d0) * N;

  // y tile: R rows from yr0, 4 columns from yc0; warp w takes the row
  // block rb of 16 rows, pairing (w, 7 - w) on one scheduler
  const int rb = warp < 4 ? warp : 11 - warp;
  const int yr0 = 16 * rb + R * (lane / CG);
  const int yc0 = 4 * (lane % CG);
  // state tile: R rows from sd0, 4 columns from sn0
  const int sd0 = R * (4 * (warp >> 2) + (lane >> 3));
  const int sn0 = 32 * (warp & 3) + 4 * (lane & 7);
  // panel entries of this thread: entry m is (row pr0 + 2m, column pc)
  // of an M^T or b panel, and (n, t) = (ctn, ctt0 + 8m) of a c^T panel
  // (each warp's c^T writes hit 32 distinct banks)
  const int pr0 = tid >> 7, pc = tid & 127;
  const int ctn = 8 * ((tid >> 5) & 3) + (tid & 7);
  const int ctt0 = 4 * (tid >> 7) + ((tid >> 3) & 3);

  for (int i = tid; i < NMAX * DT; i += THREADS) {
    const int d = i / NMAX, n = i % NMAX;
    ST[n * DT + d] = (s0 && d0 + d < Dh && n < N)
                         ? s0[sbase + (long long)d * N + n] : 0.f;
  }

  const int npn = (N + KP - 1) / KP, npu = (lc + KP - 1) / KP;
  const int np = npn + 2 * npu;
  unsigned stage[PE];   // the next panel's values, loads in flight
  for (int ch = 0; ch < nch; ++ch) {
    const int t0 = ch * lc;
    const float* gtc = gt + ((long long)(bi * G + g) * nch + ch) * lc * lc;
    // panel p: c^T rows 32p (p < npn), M^T rows 32(p - npn) (< npn + npu),
    // weighted b rows 32(p - npn - npu)
    auto fetch = [&](int p) {
      if (p < npn) {
        const int n = KP * p + ctn;
#pragma unroll
        for (int m = 0; m < PE; ++m) {
          const int t = ctt0 + 8 * m;
          stage[m] = (t < lc && t0 + t < L && n < N)
                         ? bits_of(cb + (long long)(t0 + t) * scl + n) : 0u;
        }
      } else if (p < npn + npu) {
        const int u0 = KP * (p - npn);
#pragma unroll
        for (int m = 0; m < PE; ++m) {
          const int u = u0 + pr0 + 2 * m;
          stage[m] = (u <= pc && pc < lc)
                         ? bits_of(gtc + (long long)u * lc + pc) : 0u;
        }
      } else {
        const int u0 = KP * (p - npn - npu);
#pragma unroll
        for (int m = 0; m < PE; ++m) {
          const int u = u0 + pr0 + 2 * m;
          stage[m] = (u < lc && t0 + u < L && pc < N)
                         ? bits_of(bb + (long long)(t0 + u) * sbl + pc) : 0u;
        }
      }
    };
    auto commit = [&](int p, float* panel) {
      if (p < npn) {
#pragma unroll
        for (int m = 0; m < PE; ++m)
          panel[ctn * PS + ctt0 + 8 * m] = from_bits<T>(stage[m]);
      } else if (p < npn + npu) {
        const int u0 = KP * (p - npn);
        const float ct = cum[pc];
#pragma unroll
        for (int m = 0; m < PE; ++m) {
          const int u = u0 + pr0 + 2 * m;
          panel[(pr0 + 2 * m) * PS + pc] =
              u <= pc ? __uint_as_float(stage[m]) * expf(ct - cum[u]) *
                            dtv[u]
                      : 0.f;
        }
      } else {
        const int u0 = KP * (p - npn - npu);
#pragma unroll
        for (int m = 0; m < PE; ++m)
          panel[(pr0 + 2 * m) * PS + pc] =
              from_bits<T>(stage[m]) * wv[u0 + pr0 + 2 * m];
      }
    };

    __syncthreads();   // the last chunk's state update has read X
    for (int u = tid; u < LCMAX; u += THREADS)
      dtv[u] = (u < lc && t0 + u < L)
                   ? to_f(dtb[(long long)(t0 + u) * H]) : 0.f;
    for (int i = tid; i < LCMAX * DT; i += THREADS) {
      const int u = i / DT, d = i % DT;
      X[i] = (u < lc && t0 + u < L && d0 + d < Dh)
                 ? to_f(xb[(long long)(t0 + u) * sxl + d]) : 0.f;
    }
    fetch(0);
    __syncthreads();
    if (warp == 0) {   // inclusive cumsum of dt a: lane-serial, then a scan
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
    const float cl = cum[lc - 1];
    for (int u = tid; u < LCMAX; u += THREADS) {
      ecum[u] = expf(cum[u]);
      wv[u] = expf(cl - cum[u]) * dtv[u];
    }
    commit(0, panels);
    __syncthreads();

    float acc[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int p = 0; p < np; ++p) {
      const float* panel = panels + (p & 1) * KP * PS;
      if (p + 1 < np) fetch(p + 1);
      if (p < npn + npu) {
        // y += c^T panel x S^T rows, then M^T panel x X rows (causal:
        // the warp's rows end at 16 rb + 16)
        const int k0 = p < npn ? KP * p : KP * (p - npn);
        const int kn = p < npn ? min(KP, N - k0)
                               : min(min(KP, lc - k0), 16 * rb + 16 - k0);
        const float* brow = (p < npn ? ST : X) + k0 * DT + yc0;
#pragma unroll 4
        for (int k = 0; k < kn; ++k) {
          float av[R];
          load_r<R>(panel + k * PS + yr0, av);
          const float4 bv = *reinterpret_cast<const float4*>(brow + k * DT);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
            acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
            acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
            acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
          }
        }
        if (p == npn - 1) {   // y so far is c S^T: scale it by exp(cum)
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float e = ecum[yr0 + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] *= e;
          }
        }
        if (p == npn + npu - 1) {   // y is done: store it, start S'
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int t = yr0 + i;
            if (t < lc && t0 + t < L) {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (d0 + yc0 + j < Dh)
                  yb[(long long)(t0 + t) * H * Dh + yc0 + j] =
                      from_f<T>(acc[i][j]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
          }
        }
      } else {
        // S' += (x w)^T b: X rows x the weighted b panel
        const int k0 = KP * (p - npn - npu);
        const int kn = min(KP, lc - k0);
#pragma unroll 4
        for (int k = 0; k < kn; ++k) {
          float av[R];
          load_r<R>(X + (k0 + k) * DT + sd0, av);
          const float4 bv =
              *reinterpret_cast<const float4*>(panel + k * PS + sn0);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
            acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
            acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
            acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
          }
        }
      }
      if (p + 1 < np) commit(p + 1, panels + ((p + 1) & 1) * KP * PS);
      __syncthreads();
    }
    // every thread has passed the last barrier after its last read of ST
    const float el = expf(cl);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* s = ST + (sn0 + j) * DT + sd0 + i;
        *s = el * *s + acc[i][j];
      }
  }
  __syncthreads();
  for (int i = tid; i < NMAX * DT; i += THREADS) {
    const int d = i / NMAX, n = i % NMAX;
    if (d0 + d < Dh && n < N) sfin[sbase + (long long)d * N + n] = ST[n * DT + d];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const float* a, const void* b,
           const void* c, float* gt, const float* s0, void* y, float* sfin,
           int B, int L, int H, int Dh, int G, int N, int lc,
           const long long* strides, cudaStream_t stream) {
  const int nch = (L + lc - 1) / lc;
  const T* bt = static_cast<const T*>(b);
  const T* ct = static_cast<const T*>(c);
  if (nch > 0) {
    const int nt = (lc + KP - 1) / KP;
    ssd_gram<T><<<dim3(B * G * nch, nt * nt), THREADS, 0, stream>>>(
        bt, ct, gt, L, G, N, lc, nch, strides[2], strides[3], strides[4],
        strides[5]);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const size_t bytes = smem_floats() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  ssd_scan<T><<<dim3(B * H, (Dh + DT - 1) / DT), THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a, bt, ct, gt,
      s0, static_cast<T*>(y), sfin, L, H, Dh, G, N, lc, nch, strides[0],
      strides[1], strides[2], strides[3], strides[4], strides[5]);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of the c b^T scratch the caller allocates.
extern "C" long long saath_ssd_scan_scratch(int B, int L, int G, int lc) {
  const long long nch = (L + lc - 1) / lc;
  return (long long)B * G * nch * lc * lc;
}

// bf16 != 0: x, dt, b, c and y are bf16, else f32. s0 may be null (zero
// initial state). strides: the batch and time-step strides (elements) of
// x, b and c, in that order; dt is contiguous, y is written contiguous.
// lc <= 128, N <= 128. Two launches; returns the CUDA error code of the
// first that failed (0 = none).
extern "C" int saath_ssd_scan(const void* x, const void* dt, const float* a,
                              const void* b, const void* c, float* gt,
                              const float* s0, void* y, float* sfin, int B,
                              int L, int H, int Dh, int G, int N, int lc,
                              const long long* strides, int bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, a, b, c, gt, s0, y, sfin, B, L, H,
                                 Dh, G, N, lc, strides, s);
  return launch<float>(x, dt, a, b, c, gt, s0, y, sfin, B, L, H, Dh, G, N,
                       lc, strides, s);
}
