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
// f32, all in the reference's layout (no transposes); L % lc == 0 (the
// wrapper pads). Outputs: y in x's type and the final state in f32.
//
// Design (simple and right first). The Pallas grid's sequential chunk
// axis carried the state in VMEM from one grid step to the next; Hopper
// blocks run in no order and carry nothing, so one block of 512 threads
// takes one (batch, head) and loops over the chunks itself, with the
// (Dh, N) f32 state in shared memory the whole time. Per chunk it loads
// x, b, c and dt into shared memory as f32; one thread takes the
// cumsum, sequentially, in the order of the plain version on the CPU;
// then the chunk's rows are taken in tiles of 32: the tile's rows of the
// masked, decay-weighted M = c b^T * decay * dt (causal half only), then
// the tile's y. Only when every row has read the old state does the
// block update it. The decay's argument is masked before the exp
// (u > t would give exp of a positive number, inf, and inf * 0 = NaN).
// At lc = 128, Dh = 64, N = 128 the state, the x, b and c chunks and a
// (32, 128) tile of M take 211 KB of shared memory (above 48 KB, so the
// launcher raises the block's dynamic limit); rows of S, b and c are
// padded to N + 1 floats so that a warp reading one column of 32 rows
// hits 32 banks. Everything runs on the CUDA cores in f32: no tensor
// cores, TMA or TF32.
//
// Bound on this card: the f32 products (at the serve shape B = 4,
// L = 1024, H = 64, Dh = 64, N = 128 about 15 GFLOP of the causal half,
// 0.23 ms at 67 TFLOP/s) outweigh the bytes (about 78 MB in bf16,
// 0.02 ms at 3.35 TB/s). Each multiply-add here reads one or two
// shared-memory operands, so the kernel is bound by shared-memory
// bandwidth well above the f32 rate's floor; register tiles and wgmma on bf16 tiles
// are later work. At B = 1 only H = 64 blocks run on the 132 SMs
// (later work too).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 512;
constexpr int ROW_TILE = 32;

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

__host__ __device__ inline int row_tile(int lc) {
  return lc < ROW_TILE ? lc : ROW_TILE;
}

// floats of shared memory: S (Dh, N+1), x (lc, Dh), b and c (lc, N+1),
// cum, exp(cum), dt and the state weights (lc each), M tile (rt, lc)
inline size_t smem_floats(int Dh, int N, int lc) {
  return (size_t)Dh * (N + 1) + (size_t)lc * Dh + 2 * (size_t)lc * (N + 1)
         + 4 * (size_t)lc + (size_t)row_tile(lc) * lc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan(const T* __restrict__ x, const T* __restrict__ dt,
         const float* __restrict__ a, const T* __restrict__ b,
         const T* __restrict__ c, const float* __restrict__ s0,
         T* __restrict__ y, float* __restrict__ sfin, int L, int H, int Dh,
         int G, int N, int lc) {
  extern __shared__ float smem[];
  const int NP = N + 1;
  const int rt = row_tile(lc);
  float* S = smem;                  // Dh x NP
  float* xs = S + Dh * NP;          // lc x Dh
  float* bs = xs + lc * Dh;         // lc x NP
  float* cs = bs + lc * NP;         // lc x NP
  float* cum = cs + lc * NP;        // lc
  float* ecum = cum + lc;           // lc
  float* dtv = ecum + lc;           // lc
  float* wv = dtv + lc;             // lc
  float* mt = wv + lc;              // rt x lc

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int bi = bh / H, h = bh % H;
  const int g = h / (H / G);
  const float ah = a[h];
  const size_t xrow = (size_t)H * Dh;   // x and y: one time step
  const size_t brow = (size_t)G * N;    // b and c: one time step
  const T* xb = x + (size_t)bi * L * xrow + (size_t)h * Dh;
  T* yb = y + (size_t)bi * L * xrow + (size_t)h * Dh;
  const T* dtb = dt + (size_t)bi * L * H + h;
  const T* bb = b + (size_t)bi * L * brow + (size_t)g * N;
  const T* cb = c + (size_t)bi * L * brow + (size_t)g * N;
  const size_t sbase = (size_t)bh * Dh * N;

  for (int i = tid; i < Dh * N; i += THREADS)
    S[(i / N) * NP + i % N] = s0 ? s0[sbase + i] : 0.f;

  for (int t0 = 0; t0 < L; t0 += lc) {
    __syncthreads();   // the previous chunk's state update is done
    for (int i = tid; i < lc * Dh; i += THREADS)
      xs[i] = to_f(xb[(size_t)(t0 + i / Dh) * xrow + i % Dh]);
    for (int i = tid; i < lc * N; i += THREADS) {
      const size_t off = (size_t)(t0 + i / N) * brow + i % N;
      bs[(i / N) * NP + i % N] = to_f(bb[off]);
      cs[(i / N) * NP + i % N] = to_f(cb[off]);
    }
    for (int u = tid; u < lc; u += THREADS)
      dtv[u] = to_f(dtb[(size_t)(t0 + u) * H]);
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int u = 0; u < lc; ++u) {
        run += dtv[u] * ah;
        cum[u] = run;
      }
    }
    __syncthreads();
    const float cl = cum[lc - 1];
    for (int u = tid; u < lc; u += THREADS) {
      ecum[u] = expf(cum[u]);
      wv[u] = expf(cl - cum[u]) * dtv[u];
    }

    for (int r0 = 0; r0 < lc; r0 += rt) {
      __syncthreads();   // ecum and wv written; the last tile's M read
      // M rows r0 .. r0 + rt - 1 (zero above the diagonal)
      for (int i = tid; i < rt * lc; i += THREADS) {
        const int t = r0 + i / lc, u = i % lc;
        float m = 0.f;
        if (u <= t) {
          const float* cr = cs + t * NP;
          const float* br = bs + u * NP;
          float gd = 0.f;
#pragma unroll 8
          for (int n = 0; n < N; ++n) gd += cr[n] * br[n];
          m = gd * expf(cum[t] - cum[u]) * dtv[u];
        }
        mt[i] = m;
      }
      __syncthreads();
      // y rows r0 .. r0 + rt - 1: intra-chunk M x plus the carried state
      for (int i = tid; i < rt * Dh; i += THREADS) {
        const int tl = i / Dh, d = i % Dh, t = r0 + tl;
        const float* mr = mt + tl * lc;
        float intra = 0.f;
        for (int u = 0; u <= t; ++u) intra += mr[u] * xs[u * Dh + d];
        const float* cr = cs + t * NP;
        const float* sr = S + d * NP;
        float inter = 0.f;
#pragma unroll 8
        for (int n = 0; n < N; ++n) inter += cr[n] * sr[n];
        yb[(size_t)(t0 + t) * xrow + d] = from_f<T>(intra + ecum[t] * inter);
      }
    }
    __syncthreads();   // every row has read the old state and x
    for (int i = tid; i < lc * Dh; i += THREADS) xs[i] *= wv[i / Dh];
    __syncthreads();
    const float el = expf(cl);
    for (int i = tid; i < Dh * N; i += THREADS) {
      const int d = i / N, n = i % N;
      float acc = 0.f;
#pragma unroll 8
      for (int u = 0; u < lc; ++u) acc += xs[u * Dh + d] * bs[u * NP + n];
      S[d * NP + n] = el * S[d * NP + n] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < Dh * N; i += THREADS)
    sfin[sbase + i] = S[(i / N) * NP + i % N];
}

template <typename T>
int launch(const void* x, const void* dt, const float* a, const void* b,
           const void* c, const float* s0, void* y, float* sfin, int B,
           int L, int H, int Dh, int G, int N, int lc,
           cudaStream_t stream) {
  const size_t bytes = smem_floats(Dh, N, lc) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  ssd_scan<T><<<B * H, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a,
      static_cast<const T*>(b), static_cast<const T*>(c), s0,
      static_cast<T*>(y), sfin, L, H, Dh, G, N, lc);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 != 0: x, dt, b, c and y are bf16, else f32. s0 may be null (zero
// initial state). Returns the CUDA error code of the launch (0 = none).
extern "C" int saath_ssd_scan(const void* x, const void* dt, const float* a,
                              const void* b, const void* c, const float* s0,
                              void* y, float* sfin, int B, int L, int H,
                              int Dh, int G, int N, int lc, int bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, a, b, c, s0, y, sfin, B, L, H, Dh,
                                 G, N, lc, s);
  return launch<float>(x, dt, a, b, c, s0, y, sfin, B, L, H, Dh, G, N, lc,
                       s);
}
