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
// What bounds it: the rounds are a chain of dependent, barrier-separated
// steps, so the kernel is bound by the latency of a round, not by bytes
// (the inputs are read once) or operations. The Pallas kernel holds dense
// (P, F) one-hot matrices in VMEM and runs mat-vecs on the MXU; at the
// fleet's shape (188 rows a side, 30,016 flows, 16 lanes) each one-hot
// would be ~361 MB, so this kernel takes per-flow row ids instead, and
// shortens a round:
//
// One block of 512 threads per lane (chosen on the H100 over 256 and
// 1024; PERF.md).
//   Prologue: the candidates are compacted, with warp ballots and one
//   shared-memory atomicAdd a warp for each 16 flows a thread, into a
//   list of flow indices; then each entry gets its row ids, narrowed to
//   16 bits, and the active flows per row are counted. The list's order
//   is free: counts are integer atomics and each rate goes to its own
//   slot, so no result depends on it. The list lives in shared memory up
//   to the capacity the rows leave (two lists of ~9.4k leaf-spine entries
//   at W = 376); a lane with more candidates compacts again into a global
//   scratch the wrapper allocates, and runs its own instance of the rest,
//   so that each instance addresses one memory space.
//   Each round, two barriers:
//   (c+a) per row, the last round's update avail = max(avail - lvl x
//       nhit, 0) and cnt -= nhit (exact integers; the counts need no
//       recount), then the row's level avail / cnt (BIG where cnt = 0)
//       and the block's least level. After the first update every row is
//       clamped, so a row that no flow hit keeps its residual and level
//       exactly and is not recomputed. Barrier.
//   (b) one pass over the surviving list only, 2 entries a thread at
//       once: a flow on a saturated row gets rates[f] = lvl and adds its
//       hits per row; the survivors are appended to the other half of a
//       ping-pong list with one atomicAdd a warp. A row is saturated if
//       it carries active flows and its level is within 1e-12 of the
//       least (level <= __fadd_rn(lvl, 1e-12)); every row of a listed
//       flow carries that flow, so the level alone decides. Barrier.
//   The loop ends as soon as the list is empty: the reference's remaining
//   rounds are exact no-ops then (no flow is hit, every residual is
//   already clamped at 0). The rounds are the same data-determined
//   rounds as the reference's.
//
// Float rounding: built with -fmad=false, and the level, product and
// difference are written as __fdiv_rn, __fmul_rn and __fsub_rn, so each
// rounds as the plain version's separate PyTorch operations do; the
// counts are integers. The kernel equals the plain version
// (kernels/ref.py:maxmin_ref) bit for bit on the same inputs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;   // bytes of shared memory a block may use
constexpr size_t STATIC_SMEM = 1024;  // kept back for the static arrays
constexpr int U = 2;    // list entries a thread takes at once in a round
constexpr int UR = 8;   // candidates whose rows a thread loads at once
constexpr int UC = 16;  // flows whose candidate flag a thread loads at once
constexpr int kThreads = 512;  // threads a block (one block per lane)

// avail, lvl_r (f32; lvl_r has a slot at W for the no-link row) and cnt,
// nhit (int32) for W rows, 16-byte aligned
__host__ __device__ inline size_t row_bytes(int W) {
  return (16 * (size_t)W + 4 + 15) & ~(size_t)15;
}

int entry_words(int Lf) { return Lf ? 3 : 2; }

// list entries one of the two shared-memory lists holds
long long list_cap(int W, int Lf, int F) {
  const size_t need = row_bytes(W) + STATIC_SMEM;
  if (need > SMEM_MAX) return -1;
  const long long fit = (long long)((SMEM_MAX - need) /
                                    (2 * 4 * (size_t)entry_words(Lf)));
  return fit < F ? fit : F;
}

template <bool kLinks>
__global__ void __launch_bounds__(kThreads)
maxmin(const int64_t* __restrict__ src, const int64_t* __restrict__ dst,
       const int64_t* __restrict__ up, const int64_t* __restrict__ dn,
       const uint8_t* __restrict__ cand, const float* __restrict__ avail0,
       float* __restrict__ rates, int* scratch, int F, int P, int Lf,
       int rounds, int cap) {
  constexpr int WARPS = kThreads / 32;
  constexpr int NW = kLinks ? 3 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[WARPS];
  __shared__ int s_n[2];
  const int W = 2 * P + 2 * Lf;
  float* avail = reinterpret_cast<float*>(smem);          // W
  float* lvl_r = avail + W;                                // W + 1
  int* cnt = reinterpret_cast<int*>(lvl_r + W + 1);        // W
  int* nhit = cnt + W;                                     // W
  int* lists = reinterpret_cast<int*>(smem + row_bytes(W));

  const long long b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  src += b * F;
  dst += b * F;
  cand += b * F;
  rates += b * F;
  if (kLinks) {
    up += b * F;
    dn += b * F;
  }
  for (int j = tid; j < W; j += kThreads) {
    avail[j] = avail0[b * W + j];
    cnt[j] = 0;
    nhit[j] = 0;
  }
  for (int f = tid; f < F; f += kThreads) rates[f] = 0.0f;
  if (tid == 0) {
    s_n[0] = s_n[1] = 0;
    lvl_r[W] = __int_as_float(0x7f800000);   // the no-link row: never
  }                                            // saturated
  __syncthreads();

  // the candidates' indices into list L (capacity `capacity`), with
  // counter s_n[ctr]; each thread issues the loads of UC flows at once,
  // and each warp takes one atomicAdd for them
  auto compact = [&](int* L, long long capacity, int ctr) {
    for (int base = 0; base < F; base += kThreads * UC) {
      bool c[UC];
      unsigned m[UC];
      int total = 0;
#pragma unroll
      for (int u = 0; u < UC; ++u) {
        const int f = base + u * kThreads + tid;
        c[u] = (f < F) & (cand[f < F ? f : 0] != 0);
      }
#pragma unroll
      for (int u = 0; u < UC; ++u) {
        m[u] = __ballot_sync(FULL, c[u]);
        total += __popc(m[u]);
      }
      int at = 0;
      if (lane == 0 && total) at = atomicAdd(&s_n[ctr], total);
      at = __shfl_sync(FULL, at, 0);
#pragma unroll
      for (int u = 0; u < UC; ++u) {
        const int o = at + __popc(m[u] & ((1u << lane) - 1u));
        if (c[u] && o < capacity) L[o] = base + u * kThreads + tid;
        at += __popc(m[u]);
      }
    }
  };
  compact(lists, cap, 0);
  __syncthreads();
  const int n0 = s_n[0];
  const int ru = 2 * P, rd = 2 * P + Lf;   // first uplink / downlink row
  // a row is saturated if it carries active flows and its own level is
  // within 1e-12 of the least: every row of an active flow carries it, so
  // for the rows of a listed flow the level alone decides (the no-link
  // row W reads +inf)
  auto sat = [&](int j, float thr) { return lvl_r[j] <= thr; };

  // the rest, on the lists at L0 and L1 = L0 + NW * capacity; run once on
  // the shared-memory lists and once on the scratch, so that each
  // instance addresses one memory space
  auto fill = [&](int* L0, long long capacity) {
    int* L1 = L0 + NW * capacity;
    if (tid == 0) s_n[1] = 0;
    // each candidate's rows, narrowed to 16 bits, and the active flows
    // per row (UR entries a thread at once)
    for (int base = 0; base < n0; base += kThreads * UR) {
      int f[UR], s[UR], r[UR], ui[UR], di[UR];
#pragma unroll
      for (int u = 0; u < UR; ++u) {
        const int i = base + u * kThreads + tid;
        f[u] = i < n0 ? L0[i] : -1;
      }
#pragma unroll
      for (int u = 0; u < UR; ++u) {   // loads without branches: they overlap
        const int g = f[u] < 0 ? 0 : f[u];
        s[u] = (int)src[g];
        r[u] = P + (int)dst[g];
        ui[u] = di[u] = W;
        if (kLinks) {
          const int uu = (int)up[g], dd = (int)dn[g];
          ui[u] = uu < Lf ? ru + uu : W;
          di[u] = dd < Lf ? rd + dd : W;
        }
      }
#pragma unroll
      for (int u = 0; u < UR; ++u) {
        if (f[u] < 0) continue;
        const int i = base + u * kThreads + tid;
        atomicAdd(&cnt[s[u]], 1);
        atomicAdd(&cnt[r[u]], 1);
        if (ui[u] < W) atomicAdd(&cnt[ui[u]], 1);
        if (di[u] < W) atomicAdd(&cnt[di[u]], 1);
        L0[capacity + i] = s[u] | (r[u] << 16);
        if (kLinks) L0[2 * capacity + i] = ui[u] | (di[u] << 16);
      }
    }
    __syncthreads();

    int n = n0, cur = 0;
    float lvl = 0.0f;
    for (int round = 0; n > 0 && round < rounds; ++round) {
      // (c) what the last round's frozen flows use, then (a) the levels.
      // After the first update every row is clamped at 0, so a row no
      // flow hit keeps its residual, count and level exactly: only hit
      // rows are recomputed
      float m = BIG;
      for (int j = tid; j < W; j += kThreads) {
        const int h = round ? nhit[j] : 0;
        if (round <= 1 || h) {
          int c = cnt[j];
          if (round) {
            avail[j] = fmaxf(__fsub_rn(avail[j], __fmul_rn(lvl, (float)h)),
                             0.0f);
            c -= h;
            cnt[j] = c;
            nhit[j] = 0;
          }
          lvl_r[j] = c > 0 ? __fdiv_rn(avail[j], (float)c) : BIG;
        }
        m = fminf(m, lvl_r[j]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fminf(m, __shfl_xor_sync(FULL, m, o));
      if (lane == 0) red[warp] = m;
      if (tid == 0 && round) s_n[cur ^ 1] = 0;   // read two rounds ago
      __syncthreads();
      lvl = red[0];
#pragma unroll
      for (int i = 1; i < WARPS; ++i) lvl = fminf(lvl, red[i]);
      // (b) freeze the surviving flows on a saturated row; compact the
      // rest into the other list
      const float thr = __fadd_rn(lvl, 1e-12f);
      const int* Lc = cur ? L1 : L0;
      int* Ln = cur ? L0 : L1;
      for (int base = 0; base < n; base += kThreads * U) {
        int f[U], a[U], e[U];
        bool hit[U], keep[U];
        // the slots the list reaches in this batch (the same in every
        // thread): the others load nothing
        const int nu = min(U, (n - base + kThreads - 1) / kThreads);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = base + u * kThreads + tid, ii = i < n ? i : 0;
          f[u] = -1;
          a[u] = e[u] = 0;
          if (u < nu) {
            f[u] = i < n ? Lc[ii] : -1;
            a[u] = Lc[capacity + ii];
            if (kLinks) e[u] = Lc[2 * capacity + ii];
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          bool h = false;
          if (u < nu) {
            h = sat(a[u] & 0xffff, thr) | sat(a[u] >> 16, thr);
            if (kLinks)
              h = h | sat(e[u] & 0xffff, thr) | sat(e[u] >> 16, thr);
          }
          hit[u] = h & (f[u] >= 0);
          keep[u] = (f[u] >= 0) & !h;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (!hit[u]) continue;
          const int ui = e[u] & 0xffff, di = e[u] >> 16;
          rates[f[u]] = lvl;
          atomicAdd(&nhit[a[u] & 0xffff], 1);
          atomicAdd(&nhit[a[u] >> 16], 1);
          if (kLinks && ui < W) atomicAdd(&nhit[ui], 1);
          if (kLinks && di < W) atomicAdd(&nhit[di], 1);
        }
        // the survivors of the U entries: one atomicAdd a warp
        unsigned mk[U];
        int total = 0;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          mk[u] = __ballot_sync(FULL, keep[u]);
          total += __popc(mk[u]);
        }
        int at = 0;
        if (lane == 0 && total) at = atomicAdd(&s_n[cur ^ 1], total);
        at = __shfl_sync(FULL, at, 0);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (keep[u]) {
            const int o = at + __popc(mk[u] & ((1u << lane) - 1u));
            Ln[o] = f[u];
            Ln[capacity + o] = a[u];
            if (kLinks) Ln[2 * capacity + o] = e[u];
          }
          at += __popc(mk[u]);
        }
      }
      __syncthreads();
      n = s_n[cur ^ 1];
      cur ^= 1;
    }
  };
  if (n0 <= cap) {
    fill(lists, cap);
  } else {   // uniform: this lane's lists live in the scratch
    int* g = scratch + b * 2 * NW * (long long)F;
    compact(g, F, 1);
    __syncthreads();
    fill(g, F);
  }
}

int launch(const void* src, const void* dst, const void* up, const void* dn,
           const void* cand, const void* avail0, void* rates, void* scratch,
           int B, int F, int P, int Lf, int rounds, int cap,
           cudaStream_t stream) {
  auto kernel = Lf ? maxmin<true> : maxmin<false>;
  const size_t smem =
      row_bytes(2 * P + 2 * Lf) + 2 * 4 * (size_t)entry_words(Lf) * cap;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, kThreads, smem, stream>>>(
      static_cast<const int64_t*>(src), static_cast<const int64_t*>(dst),
      static_cast<const int64_t*>(up), static_cast<const int64_t*>(dn),
      static_cast<const uint8_t*>(cand), static_cast<const float*>(avail0),
      static_cast<float*>(rates), static_cast<int*>(scratch), F, P, Lf,
      rounds, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// int32 scratch entries the wrapper allocates for B lanes of F flows over
// W = 2P + 2Lf rows (0: none), or -1 when the rows alone overflow a
// block's shared memory.
extern "C" long long saath_maxmin_scratch(int B, int P, int Lf, int F) {
  const long long cap = list_cap(2 * P + 2 * Lf, Lf, F);
  if (cap < 0) return -1;
  return cap < F ? 2LL * B * entry_words(Lf) * F : 0;
}

// src, dst (B, F) int64 ports; up, dn (B, F) int64 leaves in [0, Lf]
// (read only when Lf > 0); cand (B, F) bool; avail0 (B, W) f32 with
// W = 2P + 2Lf; output rates (B, F) f32; scratch as saath_maxmin_scratch
// sizes it (null when it is 0). Contiguous, on the current device.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int saath_maxmin(const void* src, const void* dst, const void* up,
                            const void* dn, const void* cand,
                            const void* avail0, void* rates, void* scratch,
                            int B, int F, int P, int Lf, int rounds,
                            void* stream) {
  if (B == 0) return 0;
  const long long cap = list_cap(2 * P + 2 * Lf, Lf, F);
  if (cap < 0 || (cap < F && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch(src, dst, up, dn, cand, avail0, rates, scratch, B, F, P,
                Lf, rounds, (int)cap, static_cast<cudaStream_t>(stream));
}
