// The coordinator tick's sequential walks on Hopper (sm_90a): kernel K2.
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
// uplinks | downlinks]; Lf = 0 on the big switch. Modes: 0 = (a)+(b),
// 1 = (a)+(c), 2 = (a) only, for the max-min fill (kernel K3, maxmin.cu)
// that runs next on the capacity (a) leaves. Every mode writes that
// capacity out.
//
// What bounds it: each lane's walk is one chain of dependent steps (every
// admission needs the previous one's capacity), so the kernel is bound by
// the latency of a step, not by bytes (it reads the n_live rows of cnt
// and the missed coflows' flows once) or operations. More SMs per lane
// cannot shorten a chain; only a shorter step can. The design therefore
// keeps the chain on one warp with no block barrier in it, and moves every
// load that does not depend on the chain off it:
//
// One block of 256 threads per lane (trace).
//   Warp 0 runs the chain. In (a) and (b) lane l owns the columns
//   j = l + 32 i and keeps their capacity in registers (12 a lane, so
//   W <= 384; a wider W keeps them in shared memory under the same
//   warp-only chain). A step is the reference's avail * inv + bigm per
//   column (inv = 1 / max(cnt, 1e-9) and bigm = 0 where cnt > 0, inv = 0
//   and bigm = BIG elsewhere), with no branch or select, so a lane's 12
//   columns interleave; a min tree and one redux.sync over the warp; the
//   admit test; a subtract in registers. A step that admits nothing
//   subtracts r = 0, which changes no value (x - (+0) is x for every x,
//   -0 included), so it skips the subtract.
//   Warps 1-7 load the cnt rows of order[0 ...] into a ring of up to 32
//   shared-memory stages, row k on warp 1 + k % 7, each with its next
//   row's loads in flight. Beside each row a loader writes its (inv,
//   bigm) pairs and the coflow id, and marks the stage `ready`: the
//   full-precision reciprocal is a long instruction sequence behind a
//   branch, and on the chain it would run one column after another.
//   Warp 0 releases a stage (`empty`), and stores the step's rate, one
//   step late: after the next step's warp-wide min, which shows every
//   lane past it (at once in a ring of one stage). Mode 0 streams the
//   rows a second time for (b).
//   (c) Per-flow greedy fill. The reference sorts the candidate flows by
//   (coflow priority, flow index); flows are stored contiguous per coflow
//   ([flow_lo, flow_hi) in traces.batch's layout), so that order is the
//   missed coflows in priority order, each one's flows in index order.
//   After admission the block writes the missed segments' exclusive
//   prefix `pos` over the walk (shared memory for C < 4096, a scratch the
//   wrapper allocates otherwise). Warps 1-7 then fill a ring of 32
//   windows of 32 stream positions each: per position a binary search in
//   `pos`, the flow index, and its rows (src, P + dst and, with links, the
//   uplink and downlink rows or a BIG slot at W and W + 1 for a flow that
//   stays in its leaf) narrowed to 16 bits; a flow that is not live is
//   marked -1. Warp 0 takes a window at a time.
//   The skip is exact. Flow f takes r = max(min(a_s[src], a_r[dst],
//   a_u[up], a_d[dn]), 0) and subtracts r from each of its rows. If any
//   of its rows is <= 0, r = +-0 and every row keeps its value (x - (+0)
//   = x; x - (-0) turns a -0 row into +0, and both compare as 0), so the
//   flow may be skipped with wc_flow = +0 (zeroed first): a -0 row gives
//   the plain version r = -0, which torch.equal holds equal to +0, as its
//   clamp(min=0) does. If all its rows are > 0, r > 0 equals one of them,
//   and that row becomes exactly +0 (x - x). Rows only fall. So a row
//   that is <= 0 stays so, each non-zero take zeroes a positive row, and
//   at most W flows a lane take a non-zero rate in a tick (the BIG slots
//   never reach 0). Warp 0 tests the 32 flows of a window at once (all
//   rows > 0), takes a ballot, lets the first set lane take its rate and
//   subtract in shared memory, and after a __syncwarp tests the later
//   lanes of the ballot again: the chain is (windows + takes) steps, not
//   one step per candidate flow.
// dp.wc gates (b)/(c) through the trip count, as in the reference.
//
// Float rounding: build with -fmad=false, and the reciprocals, products
// and differences below are written with __frcp_rn, __fmul_rn and
// __fsub_rn besides, so `avail - r * cnt` rounds the product before the
// subtraction exactly as the plain version (and the JAX reference) does;
// the min is exact in any order. The walk feeds every later tick, and
// the kernel equals kernels/ref.py:tick_walk_ref bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WORKERS = WARPS - 1;   // warps 1.. fill the flow ring in (c)
constexpr int NREG = 12;             // columns a lane keeps in registers
constexpr int MAX_STAGES = 32;       // cnt rows in flight
constexpr int SLOTS = 32;            // flow windows in flight
constexpr int GROUP = 2;             // windows a worker fills at once
constexpr int POS_SHARED = 4096;     // prefix entries kept in shared memory
constexpr size_t SMEM_MAX = 232448;  // bytes of shared memory a block may use
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e30f;

// Floats of a stage's cnt row (its (1 / cnt, BIG-or-0) pairs take twice
// as many): the register instance reads all NREG columns of every lane,
// so its rows are padded to 32 NREG.
__host__ __device__ inline int stage_width(int W) {
  return W <= 32 * NREG ? 32 * NREG : (W + 3) & ~3;
}

// Byte offsets of the dynamic shared memory: barriers (row ready and
// empty; ring full and empty), row stages (a cnt row and a row of
// (1 / cnt, BIG-or-0) pairs each), avail (W + 2 BIG slots), stage coflow
// ids, the flow ring (index, rows, link rows), the walk's prefix.
struct Layout {
  size_t rows, avail, stage_c, ent, pos, total;
};

__host__ __device__ inline Layout layout(int W, int C, int stages,
                                         bool pos_in_smem) {
  Layout L;
  size_t o = 8 * (2 * MAX_STAGES + 2 * SLOTS);
  L.rows = o;
  o += (size_t)stages * 3 * stage_width(W) * 4;
  L.avail = o;
  o = (o + 4 * (size_t)(W + 2) + 15) & ~(size_t)15;
  L.stage_c = o;
  o += 4 * MAX_STAGES;
  L.ent = o;
  o += 4 * 3 * SLOTS * 32;
  L.pos = o;
  if (pos_in_smem) o += 8 * (size_t)(C + 1);
  L.total = o;
  return L;
}

// The least x over the warp in one reduction: the map below orders the
// floats' bit patterns as signed integers (it flips the magnitude bits
// of a negative float, and is its own inverse). fminf would give the same
// value (the order of -0 and +0 aside, which compare equal).
__device__ __forceinline__ float warp_min(float x) {
  int i = __float_as_int(x);
  i = __reduce_min_sync(FULL, i ^ ((i >> 31) & 0x7fffffff));
  return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
}

// kLinks: the leaf-spine instance (Lf > 0), whose flows have four rows;
// kRegs: the lanes keep their columns' capacity in registers (W <= 384).
template <bool kLinks, bool kRegs>
__global__ void __launch_bounds__(THREADS)
tick_walk(const int64_t* __restrict__ order,
          const int64_t* __restrict__ n_live,
          const float* __restrict__ cnt, const float* __restrict__ avail0,
          const float* __restrict__ min_rate,
          const float* __restrict__ wc_gate,
          const int64_t* __restrict__ flow_lo,
          const int64_t* __restrict__ flow_hi,
          const int64_t* __restrict__ src, const int64_t* __restrict__ dst,
          const uint8_t* __restrict__ live, const int64_t* __restrict__ up,
          const int64_t* __restrict__ dn, float* rate, uint8_t* admitted,
          float* wc_rate, float* wc_flow, float* avail_out, int* pos_g,
          int C, int P, int Lf, int F, int mode, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int wsum[WARPS];
  const int W = 2 * P + 2 * Lf, Ws = stage_width(W);
  const bool pos_in_smem = mode == 1 && pos_g == nullptr;
  const Layout L = layout(W, C, stages, pos_in_smem);
  const uint32_t row_ready = sm90::smem_u32(smem);
  const uint32_t row_empty = row_ready + 8 * MAX_STAGES;
  const uint32_t ring_full = row_empty + 8 * MAX_STAGES;
  const uint32_t ring_empty = ring_full + 8 * SLOTS;
  float* rows = reinterpret_cast<float*>(smem + L.rows);
  float* avail = reinterpret_cast<float*>(smem + L.avail);
  int* stage_c = reinterpret_cast<int*>(smem + L.stage_c);
  int* ent_f = reinterpret_cast<int*>(smem + L.ent);
  uint32_t* ent_a = reinterpret_cast<uint32_t*>(ent_f + SLOTS * 32);
  uint32_t* ent_b = ent_a + SLOTS * 32;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int* pos = pos_in_smem ? reinterpret_cast<int*>(smem + L.pos)
                         : pos_g + (size_t)b * 2 * (C + 1);
  int* seglo = pos + C + 1;
  order += (long long)b * C;
  cnt += (long long)b * C * W;
  rate += (long long)b * C;
  admitted += (long long)b * C;
  wc_rate += (long long)b * C;
  flow_lo += (long long)b * C;
  flow_hi += (long long)b * C;
  avail0 += (long long)b * W;
  avail_out += (long long)b * W;
  const long long fb = (long long)b * F;

  const int nl = (int)n_live[b];
  const float mr = min_rate[b];
  const bool gate = wc_gate[b] > 0.0f;
  const bool fill_flows = mode == 1 && gate;
  const int nrows = mode == 0 && gate ? 2 * nl : nl;

  for (int i = tid; i < C; i += THREADS) {
    rate[i] = 0.0f;
    admitted[i] = 0;
    wc_rate[i] = 0.0f;
  }
  if (mode == 1)
    for (int i = tid; i < F; i += THREADS) wc_flow[fb + i] = 0.0f;
  if (!kRegs)
    for (int j = tid; j < W; j += THREADS) avail[j] = avail0[j];
  // a padding column of the register instance: cnt 0, inv 0, bigm BIG
  for (int i = tid; i < stages * (Ws - W); i += THREADS) {
    const int j = W + i % (Ws - W);
    float* row = rows + (size_t)(i / (Ws - W)) * 3 * Ws;
    row[j] = 0.0f;
    reinterpret_cast<float2*>(row + Ws)[j] = make_float2(0.0f, BIG);
  }
  if (tid == 0) {
    avail[W] = BIG;       // the uplink slot of a flow inside its leaf
    avail[W + 1] = BIG;   // and its downlink slot
    for (int s = 0; s < MAX_STAGES; ++s) {
      sm90::mbar_init(row_ready + 8 * s, 1);
      sm90::mbar_init(row_empty + 8 * s, 1);
    }
    for (int s = 0; s < SLOTS; ++s) {
      sm90::mbar_init(ring_full + 8 * s, 1);
      sm90::mbar_init(ring_empty + 8 * s, 1);
    }
  }
  __syncthreads();

  if (warp == 0) {
    // ---- the chain: admission (a), then the coflow fill (b) ----------
    float av[kRegs ? NREG : 1];
    if (kRegs) {
#pragma unroll
      for (int i = 0; i < NREG; ++i) {
        const int j = lane + 32 * i;
        av[i] = j < W ? avail0[j] : 0.0f;
      }
    }
    int s = 0;         // the stage of step k = k % stages
    uint32_t ph = 0;   // and the parity of its use, (k / stages) & 1
    // The previous step's stage is released, and its results stored,
    // once the next step's warp-wide min shows every lane past it.
    int ps = -1, pc = 0;
    float pr = 0.0f;
    bool pok = false, psecond = false;
    auto retire = [&]() {
      if (lane == 0 && ps >= 0) {
        sm90::mbar_arrive(row_empty + 8 * ps);
        if (psecond) {
          wc_rate[pc] = pr;
        } else {
          rate[pc] = pr;
          admitted[pc] = pok ? 1 : 0;
        }
      }
      ps = -1;
    };
    auto step = [&](bool second) {
      sm90::mbar_wait(row_ready + 8 * s, ph);
      // the reference's MADD form: avail * inv + bigm, with inv =
      // 1 / max(cnt, 1e-9) and bigm = 0 where cnt > 0, inv = 0 and
      // bigm = BIG elsewhere, side by side
      const float* row = rows + (size_t)s * 3 * Ws;
      const float2* ib = reinterpret_cast<const float2*>(row + Ws);
      const int c = stage_c[s];
      int adm = 0;
      if (second && lane == 0) adm = admitted[c];   // lane 0 wrote it
      float m;
      float v[kRegs ? NREG : 1];
      if (kRegs) {
        // the columns are independent, with no branch or select, so
        // they interleave; then a min tree (fminf is exact in any order)
        float x[NREG];
#pragma unroll
        for (int i = 0; i < NREG; ++i) {
          const int j = lane + 32 * i;
          const float2 t = ib[j];
          v[i] = row[j];
          x[i] = __fadd_rn(__fmul_rn(av[i], t.x), t.y);
        }
#pragma unroll
        for (int w = 1; w < NREG; w <<= 1)
#pragma unroll
          for (int i = 0; i + w < NREG; i += 2 * w)
            x[i] = fminf(x[i], x[i + w]);
        m = x[0];
      } else {
        m = BIG;
        for (int j = lane; j < W; j += 32) {
          const float2 t = ib[j];
          m = fminf(m, __fadd_rn(__fmul_rn(avail[j], t.x), t.y));
        }
      }
      m = warp_min(m);
      retire();
      adm = __shfl_sync(FULL, adm, 0);
      const bool ok = second ? !adm && m > 0.0f && m < BIG
                             : m >= mr && m < BIG;
      const float r = ok ? m : 0.0f;
      if (ok) {
        if (kRegs) {
#pragma unroll
          for (int i = 0; i < NREG; ++i)
            av[i] = __fsub_rn(av[i], __fmul_rn(r, v[i]));
        } else {
          for (int j = lane; j < W; j += 32)
            avail[j] = __fsub_rn(avail[j], __fmul_rn(r, row[j]));
        }
      }
      ps = s;
      pc = c;
      pr = r;
      pok = ok;
      psecond = second;
      if (stages == 1) {   // the next row needs this very stage
        __syncwarp();
        retire();
      }
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    };
    for (int k = 0; k < nl; ++k) step(false);
    __syncwarp();
    retire();
    if (kRegs) {
#pragma unroll
      for (int i = 0; i < NREG; ++i) {
        const int j = lane + 32 * i;
        if (j < W) {
          avail_out[j] = av[i];
          if (fill_flows) avail[j] = av[i];
        }
      }
    } else {
      for (int j = lane; j < W; j += 32) avail_out[j] = avail[j];
    }
    for (int k = nl; k < nrows; ++k) step(true);
    __syncwarp();
    retire();
  } else {
    // ---- the loaders: row k on warp 1 + k % nld -------------------------
    // Each loader reads its rows straight into registers, the next row's
    // loads in flight while it writes the current one's cnt and (inv,
    // bigm) pairs (__frcp_rn) into its stage and marks it ready. A parity
    // wait tells only a stage's current use from the one before, so a
    // loader, which waits for row k after its row k - nld, needs
    // nld <= stages (the ring holds one stage at W = 8192).
    const int nld = min(WARPS - 1, stages), t = warp - 1;
    const int mine = t < nld && nrows > t ? (nrows - t + nld - 1) / nld : 0;
    int cl = 0;   // the coflows of this loader's rows 32 (m / 32) ...
    auto coflow = [&](int m) {   // of its row m, k = t + m nld
      if ((m & 31) == 0) {
        const int k = t + (m + lane) * nld;
        cl = m + lane < mine ? (int)order[k < nl ? k : k - nl] : 0;
      }
      return __shfl_sync(FULL, cl, m & 31);
    };
    // a column's cnt and (inv, bigm) into the stage
    auto col = [&](float* row, int j, float v) {
      row[j] = v;
      reinterpret_cast<float2*>(row + Ws)[j] =
          v > 0.0f ? make_float2(__frcp_rn(fmaxf(v, 1e-9f)), 0.0f)
                   : make_float2(0.0f, BIG);
    };
    auto open = [&](int k) {   // row k's stage, once its last use is read
      const int s = k % stages;
      if (k >= stages)
        sm90::mbar_wait(row_empty + 8 * s, ((k / stages) - 1) & 1);
      return s;
    };
    auto close = [&](int s, int c) {
      if (lane == 0) stage_c[s] = c;
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(row_ready + 8 * s);
    };
    if (kRegs && mine) {
      float nxt[NREG];
      auto fetch = [&](int c) {
        const float* src_row = cnt + (long long)c * W;
#pragma unroll
        for (int i = 0; i < NREG; ++i) {
          const int j = lane + 32 * i;
          nxt[i] = j < W ? src_row[j] : 0.0f;
        }
      };
      int c = coflow(0);
      fetch(c);
      for (int m = 0; m < mine; ++m) {
        float cur[NREG];
#pragma unroll
        for (int i = 0; i < NREG; ++i) cur[i] = nxt[i];
        const int cc = c;
        if (m + 1 < mine) {
          c = coflow(m + 1);
          fetch(c);
        }
        const int s = open(t + m * nld);
        float* row = rows + (size_t)s * 3 * Ws;
#pragma unroll
        for (int i = 0; i < NREG; ++i)
          if (lane + 32 * i < W) col(row, lane + 32 * i, cur[i]);
        close(s, cc);
      }
    } else {
      for (int m = 0; m < mine; ++m) {
        const int c = coflow(m);
        const float* src_row = cnt + (long long)c * W;
        const int s = open(t + m * nld);
        float* row = rows + (size_t)s * 3 * Ws;
        for (int j = lane; j < W; j += 32) col(row, j, src_row[j]);
        close(s, c);
      }
    }
  }
  if (!fill_flows) return;

  // ---- (c): the missed segments' prefix over the walk -----------------
  __syncthreads();
  int carry = 0;
  for (int base = 0; base < nl; base += THREADS) {
    const int k = base + tid;
    int n = 0;
    if (k < nl) {
      const long long c = order[k];
      int lo = 0;
      if (!admitted[c]) {
        lo = (int)flow_lo[c];
        n = (int)flow_hi[c] - lo;
      }
      seglo[k] = lo;
    }
    int x = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    int before = carry;
    for (int i = 0; i < WARPS; ++i) {
      const int t = wsum[i];
      if (i < warp) before += t;
      carry += t;
    }
    if (k < nl) pos[k] = before + x - n;
    __syncthreads();
  }
  const int T = carry;   // stream positions: the missed coflows' flows
  if (tid == 0) pos[nl] = T;
  __syncthreads();
  const int nwin = (T + 31) >> 5;

  if (warp == 0) {
    // ---- the chain: a window of 32 flows at a time ---------------------
    for (int w = 0; w < nwin; ++w) {
      const int s = w % SLOTS;
      sm90::mbar_wait(ring_full + 8 * s, (w / SLOTS) & 1);
      const int f = ent_f[s * 32 + lane];
      const uint32_t ea = ent_a[s * 32 + lane];
      const uint32_t eb = kLinks ? ent_b[s * 32 + lane] : 0u;
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(ring_empty + 8 * s);
      const int i0 = ea & 0xffff, i1 = ea >> 16;
      const int i2 = eb & 0xffff, i3 = eb >> 16;
      unsigned todo = __ballot_sync(FULL, f >= 0);
      while (todo) {
        float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f, x3 = 0.0f;
        bool can = false;
        if ((todo >> lane) & 1) {
          x0 = avail[i0];
          x1 = avail[i1];
          can = x0 > 0.0f && x1 > 0.0f;
          if (kLinks) {
            x2 = avail[i2];
            x3 = avail[i3];
            can = can && x2 > 0.0f && x3 > 0.0f;
          }
        }
        const unsigned m = __ballot_sync(FULL, can);
        if (!m) break;
        const int i = __ffs(m) - 1;
        if (lane == i) {
          float r = fminf(x0, x1);
          if (kLinks) r = fminf(r, fminf(x2, x3));
          avail[i0] = __fsub_rn(x0, r);
          avail[i1] = __fsub_rn(x1, r);
          if (kLinks) {
            avail[i2] = __fsub_rn(x2, r);
            avail[i3] = __fsub_rn(x3, r);
          }
          wc_flow[fb + f] = r;
        }
        todo = m & ~((2u << i) - 1u);   // the later lanes that passed
        __syncwarp();
      }
    }
  } else {
    // ---- the flow workers: windows g * GROUP ... into the ring ---------
    for (int g = warp - 1; g * GROUP < nwin; g += WORKERS) {
      int ef[GROUP];
      uint32_t ea[GROUP], eb[GROUP];
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const int p = (g * GROUP + u) * 32 + lane;
        ef[u] = -1;
        ea[u] = eb[u] = 0u;
        if (p < T) {
          int lo = 0, hi = nl;   // pos[lo] <= p < pos[hi]
          while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (pos[mid] <= p) lo = mid;
            else hi = mid;
          }
          const long long f = fb + seglo[lo] + (p - pos[lo]);
          ea[u] = (uint32_t)src[f] | ((uint32_t)(P + (int)dst[f]) << 16);
          if (kLinks) {
            const int uu = (int)up[f], dd = (int)dn[f];
            eb[u] = (uint32_t)(uu < Lf ? 2 * P + uu : W) |
                    ((uint32_t)(dd < Lf ? 2 * P + Lf + dd : W + 1) << 16);
          }
          if (live[f]) ef[u] = (int)(f - fb);
        }
      }
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const int w = g * GROUP + u;
        if (w >= nwin) break;
        const int s = w % SLOTS;
        if (w >= SLOTS)
          sm90::mbar_wait(ring_empty + 8 * s, ((w / SLOTS) - 1) & 1);
        ent_f[s * 32 + lane] = ef[u];
        ent_a[s * 32 + lane] = ea[u];
        if (kLinks) ent_b[s * 32 + lane] = eb[u];
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(ring_full + 8 * s);
      }
    }
  }
}

bool pos_in_scratch(int C, int mode) {
  return mode == 1 && C + 1 > POS_SHARED;
}

}  // namespace

// int32 scratch entries the wrapper allocates for B lanes (0: none).
extern "C" long long saath_tick_walk_scratch(int B, int C, int mode) {
  return pos_in_scratch(C, mode) ? 2LL * B * (C + 1) : 0;
}

// order (B, C) int64; n_live (B,) int64; cnt (B, C, W) f32; avail0 (B, W)
// f32 with W = 2P + 2Lf <= 8192; min_rate, wc_gate (B,) f32; flow_lo,
// flow_hi (B, C) int64; src, dst (B, F) int64; live (B, F) bool; up, dn
// (B, F) int64 leaves in [0, Lf] (read only when Lf > 0); outputs rate
// (B, C) f32, admitted (B, C) bool, wc_rate (B, C) f32, wc_flow (B, F)
// f32, avail_out (B, W) f32; scratch as saath_tick_walk_scratch sizes it
// (null when it is 0). The flow arguments are read only in mode 1.
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
                               void* avail_out, void* scratch, int B, int C,
                               int P, int Lf, int F, int mode,
                               void* stream) {
  if (B == 0) return 0;
  const int W = 2 * P + 2 * Lf;
  const bool scratch_pos = pos_in_scratch(C, mode);
  if (scratch_pos && scratch == nullptr) return (int)cudaErrorInvalidValue;
  int stages = MAX_STAGES;
  while (stages > 1 &&
         layout(W, C, stages, mode == 1 && !scratch_pos).total > SMEM_MAX)
    --stages;
  const size_t smem = layout(W, C, stages, mode == 1 && !scratch_pos).total;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const bool regs = W <= 32 * NREG;
  auto kernel = Lf ? (regs ? tick_walk<true, true> : tick_walk<true, false>)
                   : (regs ? tick_walk<false, true> : tick_walk<false, false>);
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
      static_cast<float*>(avail_out),
      scratch_pos ? static_cast<int*>(scratch) : nullptr, C, P, Lf, F, mode,
      stages);
  return (int)cudaGetLastError();
}
