// Max-min fair work-conservation rates on Hopper (sm_90a): kernel K3.
//
// Replaces the Pallas kernel repro/kernels/maxmin.py:maxmin_pallas (body
// _maxmin_kernel), which the leaf-spine tick calls at
// repro/core/jax_coordinator.py:383 under LeafSpine(wc_fill="maxmin"):
// bipartite max-min fair rates of the work-conservation candidates by
// progressive filling. Each round counts the active flows on every row,
// takes the least fair level avail / count over the rows, freezes the
// active flows on every row within 1e-12 of that level at the level, and
// subtracts level x frozen flows from every row (clamped at 0). The
// rounds run until no active flow is left, at most W + 2 of them (the
// reference's 2 Pe + 2 with Pe = P + Lf rows per side).
//
// Rows: W = 2P + 2Lf in the tick walk's layout [sender ports | receiver
// ports | uplinks | downlinks]. Flow f uses rows src[f], P + dst[f] and,
// when it leaves its leaf (up/dn < Lf, the sentinel Lf = no link),
// 2P + up[f] and 2P + Lf + dn[f].
//
// Design (simple and right first): the Pallas kernel holds dense (P, F)
// one-hot matrices in VMEM and runs mat-vecs on the MXU; at the fleet's
// shape (188 rows a side, 30,016 flows, 16 lanes) each one-hot would be
// ~361 MB, so this kernel takes per-flow row ids instead. One block of
// 1024 threads per lane. The W residual capacities, per-row levels, the
// integer per-row counters and the saturated-row flags live in shared
// memory, with one active byte per flow; the row ids stay in global
// memory (about 1 MB a lane, L2-resident across rounds). Each round, with
// a barrier between steps: zero the counters; count active flows per row
// with shared-memory integer atomics (exact in any order); per-row level
// and a block-wide min; mark the saturated rows; each thread freezes its
// flows that touch a saturated row at the level and counts hits per row;
// subtract from each row. The loop ends as soon as a round finds no
// active flow: the reference's remaining rounds are exact no-ops then (no
// flow is hit, every residual is already clamped at 0), so the rates are
// the reference's.
//
// Float rounding: built with -fmad=false, and the level, product and
// difference are written as __fdiv_rn, __fmul_rn and __fsub_rn, so each
// rounds as the plain version's separate PyTorch operations do; the
// counts are integers. The kernel equals the plain version
// (kernels/ref.py:maxmin_ref) bit for bit on the same inputs.
//
// Bound on this card: the rounds are a chain of dependent, barrier-
// separated steps, so the kernel is bound by latency, not by bytes (the
// inputs are read once from device memory, then from L2) or operations.
// One block per lane leaves 116 of 132 SMs idle at B = 16; a cluster or
// multi-block design per lane is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr float BIG = 1e30f;

// min of v over the block, returned to every thread.
__device__ float block_min(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < THREADS / 32; ++i) r = fminf(r, red[i]);
  __syncthreads();   // red is reused by the next round
  return r;
}

__global__ void maxmin(const int64_t* __restrict__ src,
                       const int64_t* __restrict__ dst,
                       const int64_t* __restrict__ up,
                       const int64_t* __restrict__ dn,
                       const uint8_t* __restrict__ cand,
                       const float* __restrict__ avail0,
                       float* __restrict__ rates, int F, int P, int Lf,
                       int rounds) {
  extern __shared__ float smem[];
  const int W = 2 * P + 2 * Lf;
  float* avail = smem;                                    // W
  float* lvl_r = avail + W;                               // W
  float* red = lvl_r + W;                                 // THREADS / 32
  int* cnt = reinterpret_cast<int*>(red + THREADS / 32);  // W
  int* nhit = cnt + W;                                    // W
  int* sat = nhit + W;                                    // W
  uint8_t* act = reinterpret_cast<uint8_t*>(sat + W);     // F

  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  src += b * F;
  dst += b * F;
  cand += b * F;
  rates += b * F;
  if (Lf) {
    up += b * F;
    dn += b * F;
  }
  for (int j = tid; j < W; j += THREADS) avail[j] = avail0[b * W + j];
  for (int f = tid; f < F; f += THREADS) {
    act[f] = cand[f];
    rates[f] = 0.0f;
  }
  __syncthreads();

  const int ru = 2 * P, rd = 2 * P + Lf;   // first uplink / downlink row
  for (int round = 0; round < rounds; ++round) {
    // 1. zero the counters
    for (int j = tid; j < W; j += THREADS) {
      cnt[j] = 0;
      nhit[j] = 0;
    }
    __syncthreads();
    // 2. active flows per row
    int any = 0;
    for (int f = tid; f < F; f += THREADS) {
      if (!act[f]) continue;
      any = 1;
      atomicAdd(&cnt[(int)src[f]], 1);
      atomicAdd(&cnt[P + (int)dst[f]], 1);
      if (Lf) {
        const int u = (int)up[f], d = (int)dn[f];
        if (u < Lf) atomicAdd(&cnt[ru + u], 1);
        if (d < Lf) atomicAdd(&cnt[rd + d], 1);
      }
    }
    if (!__syncthreads_or(any)) break;   // nothing active: rates are final
    // 3. per-row level and the least level
    float m = BIG;
    for (int j = tid; j < W; j += THREADS) {
      const int c = cnt[j];
      const float l = c > 0 ? __fdiv_rn(avail[j], (float)c) : BIG;
      lvl_r[j] = l;
      m = fminf(m, l);
    }
    const float lvl = block_min(m, red);
    // 4. saturated rows
    const float thr = __fadd_rn(lvl, 1e-12f);
    for (int j = tid; j < W; j += THREADS)
      sat[j] = cnt[j] > 0 && lvl_r[j] <= thr;
    __syncthreads();
    // 5. freeze the active flows on a saturated row; hits per row
    for (int f = tid; f < F; f += THREADS) {
      if (!act[f]) continue;
      const int s = (int)src[f], r = P + (int)dst[f];
      const int u = Lf ? (int)up[f] : 0, d = Lf ? (int)dn[f] : 0;
      const bool lu = u < Lf, ld = d < Lf;
      if (!(sat[s] || sat[r] || (lu && sat[ru + u]) || (ld && sat[rd + d])))
        continue;
      rates[f] = lvl;
      act[f] = 0;
      atomicAdd(&nhit[s], 1);
      atomicAdd(&nhit[r], 1);
      if (lu) atomicAdd(&nhit[ru + u], 1);
      if (ld) atomicAdd(&nhit[rd + d], 1);
    }
    __syncthreads();
    // 6. what the frozen flows use
    for (int j = tid; j < W; j += THREADS)
      avail[j] = fmaxf(__fsub_rn(avail[j], __fmul_rn(lvl, (float)nhit[j])),
                       0.0f);
    __syncthreads();
  }
}

}  // namespace

// Shared memory one block needs for W rows and F flows.
extern "C" size_t saath_maxmin_smem(int W, int F) {
  return sizeof(float) * (2 * (size_t)W + THREADS / 32) +
         sizeof(int) * 3 * (size_t)W + (size_t)F;
}

// src, dst (B, F) int64 ports; up, dn (B, F) int64 leaves in [0, Lf]
// (read only when Lf > 0); cand (B, F) bool; avail0 (B, W) f32 with
// W = 2P + 2Lf; output rates (B, F) f32. Contiguous, on the current
// device. Returns the cudaError_t of the launch (0 = launched).
extern "C" int saath_maxmin(const void* src, const void* dst, const void* up,
                            const void* dn, const void* cand,
                            const void* avail0, void* rates, int B, int F,
                            int P, int Lf, int rounds, void* stream) {
  if (B == 0) return 0;
  const size_t smem = saath_maxmin_smem(2 * P + 2 * Lf, F);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        maxmin, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  maxmin<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(src), static_cast<const int64_t*>(dst),
      static_cast<const int64_t*>(up), static_cast<const int64_t*>(dn),
      static_cast<const uint8_t*>(cand), static_cast<const float*>(avail0),
      static_cast<float*>(rates), F, P, Lf, rounds);
  return (int)cudaGetLastError();
}
