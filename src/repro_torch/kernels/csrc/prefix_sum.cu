// Row prefix sums in the JAX package's own order on Hopper (sm_90a):
// kernel K6.
//
// No Pallas kernel: the JAX engine's segment sums
// (repro/fabric/jax_engine.py:_segment_sum) are `jnp.cumsum` plus two
// gathers, and XLA's CPU backend lowers that cumsum to a reduce-window
// that it rewrites as a recursive scan in blocks of 16:
//   * each block of 16 is summed sequentially from its first element;
//   * the block totals are scanned by the same rule, recursively, until
//     at most 16 remain, which are summed sequentially;
//   * an element of block b > 0 is (the scanned total of blocks 0..b-1)
//     + (its in-block prefix); block 0 keeps its in-block prefix.
// Float addition is not associative, so a per-coflow byte sum (the
// Aalo-queue ablation's total bytes, the pilot estimate's byte sum)
// rounds by the order; this kernel reproduces that association exactly,
// which `ref.prefix_sum_ref` spells out as tensor adds. Every add is
// __fadd_rn: no contraction question arises, and the result is the same
// bits as the plain version's on any input.
//
// Shape: x (B, F) f32 -> out (B, F + 1) f32 with out[:, 0] = 0, the
// layout the segment sums gather from. One launch, one block per row:
//  1. each thread takes whole blocks of 16 of x and sums them in
//     registers into the level-1 totals;
//  2. levels 2 and up: the same rule on the totals, down to at most 16;
//  3. thread 0 scans the top level sequentially; then each level's
//     blocks take their in-block prefixes plus the scanned total of the
//     blocks before them, on the way back down to the totals of level 1;
//  4. each thread re-reads its blocks of x (from L2), forms the
//     in-block prefixes, adds the scanned total before the block and
//     writes the output row.
// The totals (F/15 floats a row) live in shared memory up to
// SMEM_FLOATS, past that in a global scratch of the wrapper's.
//
// Bound on this card: bytes, each x read once and each out written once
// ((2F + 1) x 4 B a row: 3.8 MB at the fleet shape (16, 30016), about
// 1.1 us at 3.35 TB/s); the F adds are far below that. The dependent
// chain of a row is 16 adds a level (3 levels at the fleet shape), and
// 16 rows fill only 16 of the 132 SMs, each thread reading 64-byte
// strided blocks: the kernel is bound by that latency, not by bytes
// (0.0375 ms at the fleet shape on the H100, PERF.md). Several blocks a
// row would keep the association and fill the card.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int BLK = 16;
constexpr int MAX_LEVELS = 8;          // 16^8 > 2^31 elements
constexpr int SMEM_FLOATS = 12 * 1024;  // 48 KB: no opt-in attribute

struct Levels {
  int k;                       // number of total levels (>= 1)
  long long n[MAX_LEVELS + 1];   // n[0] = F, n[j] = ceil(n[j-1] / 16)
  long long off[MAX_LEVELS + 1];  // offset of level j's totals (j >= 1)
  long long total;             // floats of all levels
};

__host__ __device__ inline Levels levels_of(long long F) {
  Levels L;
  L.n[0] = F;
  L.k = 0;
  L.total = 0;
  long long n = F;
  do {
    n = (n + BLK - 1) / BLK;
    L.k += 1;
    L.n[L.k] = n;
    L.off[L.k] = L.total;
    L.total += n;
  } while (n > BLK && L.k < MAX_LEVELS);
  return L;
}

// the sequential sum of block b of v (length n, zeros past the end)
__device__ __forceinline__ float block_sum(const float* v, long long n,
                                           long long b) {
  const long long base = b * BLK;
  float s = base < n ? v[base] : 0.0f;
#pragma unroll
  for (int i = 1; i < BLK; ++i) {
    const float e = base + i < n ? v[base + i] : 0.0f;
    s = __fadd_rn(s, e);
  }
  return s;
}

__global__ void __launch_bounds__(THREADS)
    prefix_sum_kernel(const float* __restrict__ x, float* __restrict__ out,
                      float* scratch, long long F, Levels L) {
  extern __shared__ float smem[];
  const long long row = blockIdx.x;
  const float* xr = x + row * F;
  float* orow = out + row * (F + 1);
  float* tot = scratch ? scratch + row * L.total : smem;
  const int tid = threadIdx.x;

  // 1. level-1 totals from x
  for (long long b = tid; b < L.n[1]; b += THREADS)
    tot[L.off[1] + b] = block_sum(xr, F, b);
  __syncthreads();
  // 2. the totals of the levels above
  for (int j = 1; j < L.k; ++j) {
    for (long long b = tid; b < L.n[j + 1]; b += THREADS)
      tot[L.off[j + 1] + b] = block_sum(tot + L.off[j], L.n[j], b);
    __syncthreads();
  }
  // 3. the top level (<= 16 totals) sequentially, then each level's
  // blocks: in-block prefix + the scanned total of the blocks before
  if (tid == 0) {
    float* t = tot + L.off[L.k];
    for (long long i = 1; i < L.n[L.k]; ++i) t[i] = __fadd_rn(t[i - 1], t[i]);
  }
  __syncthreads();
  for (int j = L.k - 1; j >= 1; --j) {
    float* t = tot + L.off[j];
    const float* up = tot + L.off[j + 1];
    const long long n = L.n[j];
    for (long long b = tid; b < L.n[j + 1]; b += THREADS) {
      const long long base = b * BLK;
      float s = t[base];
      const float before = b > 0 ? up[b - 1] : 0.0f;
      if (b > 0) t[base] = __fadd_rn(before, s);
      for (int i = 1; i < BLK && base + i < n; ++i) {
        s = __fadd_rn(s, t[base + i]);
        t[base + i] = b > 0 ? __fadd_rn(before, s) : s;
      }
    }
    __syncthreads();
  }
  // 4. the output row from x and the scanned level-1 totals
  if (tid == 0) orow[0] = 0.0f;
  const float* up = tot + L.off[1];
  for (long long b = tid; b < L.n[1]; b += THREADS) {
    const long long base = b * BLK;
    const float before = b > 0 ? up[b - 1] : 0.0f;
    float s = xr[base];
    orow[1 + base] = b > 0 ? __fadd_rn(before, s) : s;
#pragma unroll
    for (int i = 1; i < BLK; ++i) {
      if (base + i < F) {
        s = __fadd_rn(s, xr[base + i]);
        orow[1 + base + i] = b > 0 ? __fadd_rn(before, s) : s;
      }
    }
  }
}

}  // namespace

// Floats of global scratch a call at (B, F) needs: 0 when a row's
// totals fit in shared memory.
extern "C" long long saath_prefix_sum_scratch(int B, long long F) {
  if (F <= 0) return 0;
  const Levels L = levels_of(F);
  return L.total <= SMEM_FLOATS ? 0 : (long long)B * L.total;
}

// x: (B, F) f32; out: (B, F + 1) f32; scratch: saath_prefix_sum_scratch
// floats or null. All contiguous on the current device. One launch;
// returns its cudaError_t (0 = launched).
extern "C" int saath_prefix_sum(const float* x, float* out, float* scratch,
                                int B, long long F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || F == 0) return 0;  // the wrapper fills the zero column
  const Levels L = levels_of(F);
  const bool shared = L.total <= SMEM_FLOATS;
  if (!shared && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = shared ? sizeof(float) * L.total : 0;
  prefix_sum_kernel<<<B, THREADS, smem, s>>>(x, out, shared ? nullptr
                                                            : scratch,
                                             F, L);
  return (int)cudaGetLastError();
}
