// Row prefix sums in the JAX package's own order on Hopper (sm_90a):
// kernel K6.
//
// Replaces no Pallas kernel: the JAX engine's segment sums
// (repro/fabric/jax_engine.py:180, _segment_sum) are `jnp.cumsum` plus
// two gathers, and XLA's CPU backend lowers that cumsum to a
// reduce-window that it rewrites as a recursive scan in blocks of 16:
//   * each block of 16 is summed sequentially from the identity +0.0
//     (so a leading -0.0 becomes +0.0: fl(+0 + x) is x for every other
//     x);
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
// Shape: x (R, F) f32 -> out (R, F + 1) f32 with out[:, 0] = 0, the
// layout the segment sums gather from; the engine stacks a step's
// independent sums into the rows of one call. Rows of up to 2^23
// floats.
//
// Bound on this card: bytes, each x read once and each out written once
// ((2F + 1) x 4 B a row: 3.8 MB at the fleet shape (16, 30016), about
// 1.1 us at 3.35 TB/s); the F adds a row are far below that.
//
// Design: tiles of (row, chunk), a chunk being 16^3 = 4096 floats
// aligned to the row's start. An aligned chunk of 16^m is a whole
// subtree of XLA's association, so its level-1..3 totals are its own.
// One cooperative launch of co-resident blocks (each loops over tiles,
// so any number of rows fits), two phases split by one grid barrier:
//  A. each block stages its tile in shared memory with coalesced
//     cp.async loads (16 bytes a thread where the rows are 16-byte
//     aligned, swizzled so that a thread's 16 floats read without bank
//     conflicts), sums each block of 16 in one thread's registers into
//     the tile's 256 level-1 totals (kept in shared memory), those into
//     its 16 level-2 totals and those into its level-3 total; the last
//     two go to a global scratch (`Levels` counts, levels 2 and 3);
//  B. each tile, still in shared memory when the block holds one tile
//     (else re-read from L2), reads in one round trip its row's level-3
//     totals and the level-2 totals of its chunk and the one before;
//     scans the row's levels 3.. in shared memory (top level
//     sequentially, then each block: in-block prefix + the scanned
//     total before it); scans the two chunks' level-2 blocks the same
//     way, and its own 16 level-1 blocks; then forms every element as
//     __fadd_rn(scanned level-1 total before its block, in-block
//     prefix), in place, and writes the output row coalesced. The
//     level-1 total just before the chunk is XLA's: (scanned level-2
//     total before the previous chunk's last level-1 block) + (that
//     block's total).
// Each tile scans its row's high levels again (8 totals at the fleet
// shape): that costs less than a second barrier and a block a row
// scanning in L2 while the rest of the grid spins, which took half the
// time of a first version (PERF.md §6). What remains above the bytes:
// the launch, one barrier and a few dependent chains of 16 adds.
//
// Why not a look-back scan (each chunk's own scan plus a carry from a
// sequential scan of the chunk totals): the first block of a chunk
// takes its "before" from scanned totals inside the previous chunk,
// which XLA forms as fl(S + t) over totals nested in that chunk, not as
// fl(carry + chunk-local prefix); the two round apart on most rows
// (tests/test_torch_prefix_sum_design.py pins the difference). So the
// row's totals are scanned exactly as XLA does, and only the byte work
// is spread over the card.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;             // one block of 16 of a tile each
constexpr int BLK = 16;
constexpr int TILE = BLK * BLK * BLK;    // 4096 floats: a chunk of a row
constexpr int TILE4 = TILE / 4;          // its float4s
constexpr int MAX_BLOCKS_PER_SM = 6;     // 40 registers a thread
constexpr int MAX_LEVELS = 8;
constexpr long long MAX_ROW = 1LL << 23;  // the longest row taken
// shared floats for a row's level-3.. totals: 2048 + 128 + 8 at MAX_ROW
constexpr int HIGH = 2184;

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

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared-memory slot of the tile's float4 q: thread t's four float4s
// (q = 4t..4t+3) and a warp's 8 consecutive float4s each fall in 8
// distinct bank groups.
__device__ __forceinline__ int swz(int q) { return q ^ ((q >> 3) & 3); }

// Stage the tile's `len` floats from xt into shared memory, zeros past
// len. `vec`: xt is 16-byte aligned and len a multiple of 4.
__device__ __forceinline__ void load_tile(float4* sm, const float* xt,
                                          int len, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    for (int q = tid; q < TILE4; q += THREADS) {
      if (4 * q < len) copy16(sm + swz(q), xt + 4 * q);
      else sm[swz(q)] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    float* s = reinterpret_cast<float*>(sm);
    for (int e = tid; e < TILE; e += THREADS) {
      float* d = s + 4 * swz(e >> 2) + (e & 3);
      if (e < len) copy4(d, xt + e);
      else *d = 0.0f;
    }
  }
  copies_done();
  __syncthreads();
}

// Thread t's block of 16 (tile floats 16t..16t+15) to and from registers.
__device__ __forceinline__ void read_block(const float4* sm, int t,
                                           float* v) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 f = sm[swz(4 * t + j)];
    v[4 * j] = f.x; v[4 * j + 1] = f.y; v[4 * j + 2] = f.z;
    v[4 * j + 3] = f.w;
  }
}
__device__ __forceinline__ void write_block(float4* sm, int t,
                                            const float* v) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    sm[swz(4 * t + j)] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2],
                                     v[4 * j + 3]);
}

// The sequential sum of 16 floats from the identity +0.0, as XLA
// starts every chain.
__device__ __forceinline__ float seq_sum(const float* v) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < BLK; ++i) s = __fadd_rn(s, v[i]);
  return s;
}

// Each element of v: its in-block prefix, plus `before` when `add`.
__device__ __forceinline__ void block_scan(float* v, float before,
                                           bool add) {
  float s = __fadd_rn(0.0f, v[0]);   // the chain starts from +0.0
  v[0] = add ? __fadd_rn(before, s) : s;
#pragma unroll
  for (int i = 1; i < BLK; ++i) {
    s = __fadd_rn(s, v[i]);
    v[i] = add ? __fadd_rn(before, s) : s;
  }
}

// The XLA scan of a row's level-3.. totals in shared memory: `h` holds
// level 3 (L.n[3] floats) followed by room for the levels above; on
// return level 3 holds its scanned totals. Every thread of the block
// calls it.
__device__ void scan_high(float* h, const Levels& L) {
  const int tid = threadIdx.x;
  float v[BLK];
  for (int j = 3; j < L.k; ++j) {   // the levels above 3 (F > 65,536)
    const float* t = h + (L.off[j] - L.off[3]);
    for (long long b = tid; b < L.n[j + 1]; b += THREADS) {
#pragma unroll
      for (int i = 0; i < BLK; ++i)
        v[i] = b * BLK + i < L.n[j] ? t[b * BLK + i] : 0.0f;
      h[L.off[j + 1] - L.off[3] + b] = seq_sum(v);
    }
    __syncthreads();
  }
  if (tid == 0) {   // the top level (<= 16 totals), sequentially
    float* t = h + (L.off[L.k] - L.off[3]);
#pragma unroll
    for (int i = 0; i < BLK; ++i) v[i] = i < L.n[L.k] ? t[i] : 0.0f;
    block_scan(v, 0.0f, false);
#pragma unroll
    for (int i = 0; i < BLK; ++i)
      if (i < L.n[L.k]) t[i] = v[i];
  }
  __syncthreads();
  for (int j = L.k - 1; j >= 3; --j) {
    float* t = h + (L.off[j] - L.off[3]);
    const float* up = h + (L.off[j + 1] - L.off[3]);
    for (long long b = tid; b < L.n[j + 1]; b += THREADS) {
      const long long base = b * BLK;
#pragma unroll
      for (int i = 0; i < BLK; ++i)
        v[i] = base + i < L.n[j] ? t[base + i] : 0.0f;
      block_scan(v, b > 0 ? up[b - 1] : 0.0f, b > 0);
#pragma unroll
      for (int i = 0; i < BLK; ++i)
        if (base + i < L.n[j]) t[base + i] = v[i];
    }
    __syncthreads();
  }
}

// Each thread's level-1 total of the tile in shared memory (zeros past
// the row's end, as XLA pads), into t1s.
__device__ __forceinline__ void level1_totals(const float4* tile, float* t1s,
                                              long long b, long long n1) {
  float v[BLK];
  read_block(tile, threadIdx.x, v);
  const float s = seq_sum(v);
  t1s[threadIdx.x] = b < n1 ? s : 0.0f;
}

// scratch: per row, the raw level-2 totals (n[2]) then the raw level-3
// totals (n[3]), as far as the row has those levels.
__global__ void __launch_bounds__(THREADS, MAX_BLOCKS_PER_SM)
    prefix_sum_kernel(const float* __restrict__ x, float* __restrict__ out,
                      float* scratch, int R, long long F, Levels L,
                      int vec) {
  __shared__ float4 tile[TILE4];
  __shared__ float t1s[THREADS];     // the tile's level-1 totals
  __shared__ float t2s[2 * BLK];     // level-2 totals of chunks c-1, c
  __shared__ float high[HIGH];       // the row's level-3.. totals
  __shared__ float bnd;              // scanned level-1 total before c
  const int tid = threadIdx.x;
  const long long nchunk = (F + TILE - 1) / TILE;
  const long long tiles = (long long)R * nchunk;
  const bool keep = tiles <= (long long)gridDim.x;   // one tile a block
  const long long n2 = L.k >= 2 ? L.n[2] : 0;
  const long long n3 = L.k >= 3 ? L.n[3] : 0;

  // ---- A. the tiles' level-1..3 totals ----------------------------------
  for (long long tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
    const long long row = tl / nchunk, c = tl % nchunk;
    const long long e0 = c * TILE;
    const int len = (int)(F - e0 < TILE ? F - e0 : TILE);
    float* lev2 = scratch + row * (n2 + n3);
    __syncthreads();   // the last tile's shared memory is read
    load_tile(tile, x + row * F + e0, len, vec);
    level1_totals(tile, t1s, c * THREADS + tid, L.n[1]);
    __syncthreads();
    if (tid < 32) {
      if (tid < BLK && c * BLK + tid < n2) {
        const float s2 = seq_sum(t1s + BLK * tid);
        t2s[tid] = s2;
        lev2[c * BLK + tid] = s2;
      } else if (tid < BLK) {
        t2s[tid] = 0.0f;
      }
      __syncwarp();
      if (n3 && tid == 0) lev2[n2 + c] = seq_sum(t2s);
    }
  }

  cg::this_grid().sync();

  // ---- B. each tile: its row's totals in XLA's order, then its output ---
  for (long long tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
    const long long row = tl / nchunk, c = tl % nchunk;
    const long long e0 = c * TILE;
    const int len = (int)(F - e0 < TILE ? F - e0 : TILE);
    const float* lev2 = scratch + row * (n2 + n3);
    const long long b = c * THREADS + tid;
    __syncthreads();   // the last tile's shared memory is read
    if (!keep) {
      load_tile(tile, x + row * F + e0, len, vec);
      level1_totals(tile, t1s, b, L.n[1]);
    }
    // one round trip to L2: the row's level-3 totals, the level-2 totals
    // of chunks c-1 and c (zeros past the row's end)
    for (long long i = tid; i < n3; i += THREADS)
      high[i] = __ldcg(lev2 + n2 + i);
    if (tid < 2 * BLK) {
      const long long q = (c - 1) * BLK + tid;
      t2s[tid] = q >= 0 && q < n2 ? __ldcg(lev2 + q) : 0.0f;
    }
    __syncthreads();
    if (n3) scan_high(high, L);
    if (tid < 32) {
      // level 2: chunks c-1 and c take their scanned totals, each chunk
      // the scanned level-3 total before it (chunk 0 none)
      if (n2 && tid < 2 && c - 1 + tid >= 0) {
        const long long blk = c - 1 + tid;
        float v[BLK];
#pragma unroll
        for (int i = 0; i < BLK; ++i) v[i] = t2s[BLK * tid + i];
        const float last = v[BLK - 1];
        block_scan(v, blk > 0 ? high[blk - 1] : 0.0f, blk > 0);
        // the scanned level-1 total just before chunk c (c > 0):
        // (scanned level-2 total before the last level-1 block of chunk
        // c-1) + (that block's own total), as XLA forms it
        if (tid == 0) bnd = __fadd_rn(v[BLK - 2], last);
#pragma unroll
        for (int i = 0; i < BLK; ++i) t2s[BLK * tid + i] = v[i];
      }
      __syncwarp();
      // level 1: the tile's 16 level-1 blocks, each the scanned level-2
      // total before it (t2s[BLK + tid - 1]; the row's first none)
      if (tid < BLK) {
        const long long m = c * BLK + tid;
        float v[BLK];
#pragma unroll
        for (int i = 0; i < BLK; ++i) v[i] = t1s[BLK * tid + i];
        block_scan(v, m > 0 ? t2s[BLK + tid - 1] : 0.0f, m > 0);
#pragma unroll
        for (int i = 0; i < BLK; ++i) t1s[BLK * tid + i] = v[i];
      }
    }
    __syncthreads();
    // level 0: each element = scanned level-1 total before its block +
    // its in-block prefix
    if (b < L.n[1]) {
      float v[BLK];
      read_block(tile, tid, v);
      const float before = tid > 0 ? t1s[tid - 1] : bnd;
      block_scan(v, before, b > 0);
      write_block(tile, tid, v);
    }
    __syncthreads();
    float* orow = out + row * (F + 1);
    const float* t = reinterpret_cast<const float*>(tile);
    for (int e = tid; e < len; e += THREADS)
      orow[1 + e0 + e] = t[4 * swz(e >> 2) + (e & 3)];
    if (c == 0 && tid == 0) orow[0] = 0.0f;
  }
}

// Launch configurations worked out so far (one per device), for the
// port's build sanitizer (`analysis.sanitize.assert_no_recompiles`).
std::atomic<long long> g_configs{0};

// The most co-resident blocks of prefix_sum_kernel on the current
// device, worked out on its first call and kept, so that a step's call
// makes no host query before its launch.
cudaError_t resident_blocks(long long* most) {
  struct Entry { int dev; long long most; };
  static std::mutex mu;
  static Entry cache[16];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev) {
      *most = cache[i].most;
      return cudaSuccess;
    }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, prefix_sum_kernel, THREADS, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *most = (long long)sms *
          (per_sm < MAX_BLOCKS_PER_SM ? per_sm : MAX_BLOCKS_PER_SM);
  g_configs.fetch_add(1);
  cache[used < 16 ? used++ : 15] = {dev, *most};
  return cudaSuccess;
}

}  // namespace

// Launch configurations this library has worked out and kept since it was
// loaded.
extern "C" long long saath_prefix_sum_configs() { return g_configs.load(); }

// Floats of global scratch a call at (R, F) needs (the raw level-2 and
// level-3 totals of every row), or -1 when a row is longer than 2^23.
extern "C" long long saath_prefix_sum_scratch(int R, long long F) {
  if (F <= 0) return 0;
  if (F > MAX_ROW) return -1;
  const Levels L = levels_of(F);
  return (long long)R * ((L.k >= 2 ? L.n[2] : 0) + (L.k >= 3 ? L.n[3] : 0));
}

// x: (R, F) f32; out: (R, F + 1) f32; scratch: saath_prefix_sum_scratch
// floats (unused, may be null, when that is 0). All contiguous on the
// current device. One cooperative launch; returns its cudaError_t
// (0 = launched).
extern "C" int saath_prefix_sum(const float* x, float* out, float* scratch,
                                int R, long long F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 0 || F == 0) return 0;  // the wrapper fills the zero column
  const long long need = saath_prefix_sum_scratch(R, F);
  if (need < 0 || (need > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Levels L = levels_of(F);
  long long most = 0;
  cudaError_t e = resident_blocks(&most);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)R * ((F + TILE - 1) / TILE);
  const long long grid = tiles < most ? tiles : most;
  int vec = F % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  void* args[] = {(void*)&x, (void*)&out, (void*)&scratch, (void*)&R,
                  (void*)&F, (void*)&L, (void*)&vec};
  e = cudaLaunchCooperativeKernel((const void*)prefix_sum_kernel,
                                  dim3((unsigned)grid), dim3(THREADS), args,
                                  0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
