// The coordinator tick's sequential walks on Hopper (sm_90a).
//
// Has no Pallas counterpart: in repro/core/jax_coordinator.py:tick_core
// XLA ran these as while_loops with data-dependent trip counts:
//   (a) all-or-none MADD admission over the compacted priority list
//       (jax_coordinator.py:311-322);
//   (b) coflow-granular work conservation over the missed coflows
//       (:330-340), for fidelity="coflow";
//   (c) per-flow greedy work conservation (:387-434), fidelity="flow",
//       capped on a leaf-spine fabric by the flow's uplink and downlink.
// Eager PyTorch would read n_live on the host every tick; here each lane's
// trip counts are read from device memory, so the tick loop never syncs.
//
// Columns: W = 2P + 2Lf capacities [sender ports | receiver ports |
// uplinks | downlinks]; Lf = 0 on the big switch (the walk is then the
// big-switch walk bit for bit). Modes: 0 = (a)+(b), 1 = (a)+(c), 2 = (a)
// only, for the max-min fill (kernel K3, maxmin.cu) that runs next on the
// capacity (a) leaves. Every mode writes that capacity out.
//
// Design: one block per lane (trace). The lane's residual capacities
// `avail` (W floats) live in shared memory for the whole walk.
//   (a)/(b) For each coflow c = order[k], k < n_live, the block's threads
//       compute min_j(avail[j] * (1 / cnt[c, j]), BIG where cnt = 0) with
//       a block reduction, then subtract r * cnt[c, :] from avail.
//   (c) The reference sorts the candidate flows by (coflow priority, flow
//       index). Flows are stored contiguous per coflow ([flow_lo, flow_hi)
//       in traces.batch's layout), so that order is: the missed coflows in
//       priority order, each one's live flows in index order. The block
//       walks exactly that, with no sort: it stages each segment's
//       (src, dst, up, dn, live) in shared memory in parallel, and one
//       thread applies min(a_s[src], a_r[dst], a_u[up], a_d[dn]) flow by
//       flow. The links get a BIG slot each at index Lf (2Lf + 2 floats of
//       shared memory): a flow that stays in its leaf names the slot, is
//       never link-capped, and its subtract leaves the slot at BIG, as the
//       reference's do. The big switch (Lf = 0) runs an instance compiled
//       without the slots (a min with BIG changes no value): the serial
//       loop stays the port-only one.
// dp.wc gates (b)/(c) through the trip count, as in the reference.
//
// Float rounding: build with -fmad=false, and the products and
// differences below are written with __fmul_rn / __fsub_rn besides, so
// `avail - r * cnt` rounds the product before the subtraction exactly as
// the plain version (and the JAX reference) does; a fused multiply-add
// would round once and drift, and the walk feeds every later tick.
//
// Bound on this card: the walk is a chain of dependent steps (each
// admission needs the previous one's avail), so it is bound by latency,
// not by bytes (it reads only the n_live rows of cnt) or operations. One
// block per lane leaves most SMs idle at B=16; a warp-parallel walk is
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float BIG = 1e30f;

// min over the W columns of avail * (1 / cnt) (+ BIG where cnt == 0),
// returned to every thread of the block.
__device__ float madd_rate(const float* avail, const float* row, int W,
                           float* red) {
  float m = __int_as_float(0x7f800000);  // +inf
  for (int j = threadIdx.x; j < W; j += THREADS) {
    float v = row[j];
    float x = v > 0.0f ? __fmul_rn(avail[j], __frcp_rn(fmaxf(v, 1e-9f)))
                       : BIG;
    m = fminf(m, x);
  }
  for (int o = 16; o > 0; o >>= 1)
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < THREADS / 32; ++i) r = fminf(r, red[i]);
  __syncthreads();   // red is reused by the next call
  return r;
}

__device__ void take(float* avail, const float* row, int W, float r) {
  for (int j = threadIdx.x; j < W; j += THREADS)
    avail[j] = __fsub_rn(avail[j], __fmul_rn(r, row[j]));
  __syncthreads();
}

// kLinks: the leaf-spine instance (Lf > 0); the big-switch instance
// compiles the link slots out of the per-flow fill entirely.
template <bool kLinks>
__global__ void tick_walk(const int64_t* __restrict__ order,
                          const int64_t* __restrict__ n_live,
                          const float* __restrict__ cnt,
                          const float* __restrict__ avail0,
                          const float* __restrict__ min_rate,
                          const float* __restrict__ wc_gate,
                          const int64_t* __restrict__ flow_lo,
                          const int64_t* __restrict__ flow_hi,
                          const int64_t* __restrict__ src,
                          const int64_t* __restrict__ dst,
                          const uint8_t* __restrict__ live,
                          const int64_t* __restrict__ up,
                          const int64_t* __restrict__ dn,
                          float* rate, uint8_t* admitted, float* wc_rate,
                          float* wc_flow, float* avail_out, int C, int P,
                          int Lf, int F, int mode) {
  extern __shared__ float smem[];
  const int W = 2 * P + 2 * Lf;
  float* avail = smem;                                   // W
  float* red = avail + W;                                // THREADS / 32
  float* a_u = red + THREADS / 32;                       // Lf + 1
  float* a_d = a_u + Lf + 1;                             // Lf + 1
  int* s_src = reinterpret_cast<int*>(a_d + Lf + 1);     // THREADS
  int* s_dst = s_src + THREADS;                          // THREADS
  int* s_up = s_dst + THREADS;                           // THREADS
  int* s_dn = s_up + THREADS;                            // THREADS

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  order += (long long)b * C;
  cnt += (long long)b * C * W;
  rate += (long long)b * C;
  admitted += (long long)b * C;
  wc_rate += (long long)b * C;

  for (int i = tid; i < C; i += THREADS) {
    rate[i] = 0.0f;
    admitted[i] = 0;
    wc_rate[i] = 0.0f;
  }
  if (mode == 1)
    for (int i = tid; i < F; i += THREADS) wc_flow[(long long)b * F + i] = 0.0f;
  for (int j = tid; j < W; j += THREADS) avail[j] = avail0[(long long)b * W + j];
  __syncthreads();

  const int nl = (int)n_live[b];
  const float mr = min_rate[b];

  // (a) admission
  for (int k = 0; k < nl; ++k) {
    const long long c = order[k];
    const float* row = cnt + c * W;
    float r = madd_rate(avail, row, W, red);
    const bool ok = (r >= mr) && (r < BIG);
    r = ok ? r : 0.0f;
    if (tid == 0) {
      rate[c] = r;
      admitted[c] = ok ? 1 : 0;
    }
    take(avail, row, W, r);
  }
  for (int j = tid; j < W; j += THREADS)
    avail_out[(long long)b * W + j] = avail[j];
  if (mode == 2 || !(wc_gate[b] > 0.0f)) return;

  if (mode == 0) {
    // (b) coflow-granular work conservation
    for (int k = 0; k < nl; ++k) {
      const long long c = order[k];
      const float* row = cnt + c * W;
      float r = madd_rate(avail, row, W, red);
      const bool ok = !admitted[c] && (r > 0.0f) && (r < BIG);
      r = ok ? r : 0.0f;
      if (tid == 0) wc_rate[c] = r;
      take(avail, row, W, r);
    }
    return;
  }

  // (c) per-flow greedy fill over the missed coflows' live flows
  float* a_s = avail;
  float* a_r = avail + P;
  if (kLinks) {
    for (int j = tid; j <= Lf; j += THREADS) {
      a_u[j] = j < Lf ? avail[2 * P + j] : BIG;
      a_d[j] = j < Lf ? avail[2 * P + Lf + j] : BIG;
    }
    __syncthreads();
    up += (long long)b * F;
    dn += (long long)b * F;
  }
  src += (long long)b * F;
  dst += (long long)b * F;
  live += (long long)b * F;
  wc_flow += (long long)b * F;
  for (int k = 0; k < nl; ++k) {
    const long long c = order[k];
    if (admitted[c]) continue;            // uniform across the block
    const long long lo = flow_lo[(long long)b * C + c];
    const long long hi = flow_hi[(long long)b * C + c];
    for (long long base = lo; base < hi; base += THREADS) {
      const int n = (int)min((long long)THREADS, hi - base);
      if (tid < n) {
        const long long f = base + tid;
        s_src[tid] = live[f] ? (int)src[f] : -1;
        s_dst[tid] = (int)dst[f];
        if (kLinks) {
          s_up[tid] = (int)up[f];
          s_dn[tid] = (int)dn[f];
        }
      }
      __syncthreads();
      if (kLinks && tid == 0) {
        for (int i = 0; i < n; ++i) {
          const int sp = s_src[i];
          if (sp < 0) continue;
          const int dq = s_dst[i], u = s_up[i], d = s_dn[i];
          const float r = fmaxf(fminf(fminf(a_s[sp], a_r[dq]),
                                      fminf(a_u[u], a_d[d])), 0.0f);
          a_s[sp] = __fsub_rn(a_s[sp], r);
          a_r[dq] = __fsub_rn(a_r[dq], r);
          a_u[u] = __fsub_rn(a_u[u], r);
          a_d[d] = __fsub_rn(a_d[d], r);
          wc_flow[base + i] = r;
        }
      } else if (tid == 0) {
        // big switch: the serial chain touches the ports only
        for (int i = 0; i < n; ++i) {
          const int sp = s_src[i];
          if (sp < 0) continue;
          const int dq = s_dst[i];
          const float r = fmaxf(fminf(a_s[sp], a_r[dq]), 0.0f);
          a_s[sp] = __fsub_rn(a_s[sp], r);
          a_r[dq] = __fsub_rn(a_r[dq], r);
          wc_flow[base + i] = r;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

// order (B, C) int64; n_live (B,) int64; cnt (B, C, W) f32; avail0 (B, W)
// f32 with W = 2P + 2Lf; min_rate, wc_gate (B,) f32; flow_lo, flow_hi
// (B, C) int64; src, dst (B, F) int64; live (B, F) bool; up, dn (B, F)
// int64 leaves in [0, Lf] (read only when Lf > 0); outputs rate (B, C)
// f32, admitted (B, C) bool, wc_rate (B, C) f32, wc_flow (B, F) f32,
// avail_out (B, W) f32. The flow arguments are read only in mode 1.
// Contiguous, on the current device. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int saath_tick_walk(const void* order, const void* n_live,
                               const void* cnt, const void* avail0,
                               const void* min_rate, const void* wc_gate,
                               const void* flow_lo, const void* flow_hi,
                               const void* src, const void* dst,
                               const void* live, const void* up,
                               const void* dn, void* rate, void* admitted,
                               void* wc_rate, void* wc_flow,
                               void* avail_out, int B, int C, int P,
                               int Lf, int F, int mode, void* stream) {
  if (B == 0) return 0;
  const size_t smem = sizeof(float) * (2 * P + 2 * Lf + THREADS / 32 +
                                       2 * (Lf + 1)) +
                      sizeof(int) * 4 * THREADS;
  auto kernel = Lf ? tick_walk<true> : tick_walk<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(order),
      static_cast<const int64_t*>(n_live), static_cast<const float*>(cnt),
      static_cast<const float*>(avail0), static_cast<const float*>(min_rate),
      static_cast<const float*>(wc_gate),
      static_cast<const int64_t*>(flow_lo),
      static_cast<const int64_t*>(flow_hi), static_cast<const int64_t*>(src),
      static_cast<const int64_t*>(dst), static_cast<const uint8_t*>(live),
      static_cast<const int64_t*>(up), static_cast<const int64_t*>(dn),
      static_cast<float*>(rate), static_cast<uint8_t*>(admitted),
      static_cast<float*>(wc_rate), static_cast<float*>(wc_flow),
      static_cast<float*>(avail_out), C, P, Lf, F, mode);
  return (int)cudaGetLastError();
}
