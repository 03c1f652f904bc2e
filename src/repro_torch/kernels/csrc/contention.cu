// LCoF contention counts k_c on Hopper (sm_90a): kernel K1.
//
// Replaces the Pallas kernel repro/kernels/contention.py:
// contention_pallas (body _contention_kernel), which forms
// S = A_s A_s^T + A_r A_r^T on the TPU's matrix unit over bc x bc blocks
// and carries each row's count across the sequential j axis of its grid.
//
// k_c = number of other active coflows c' that share at least one sender
// or one receiver port with active coflow c (0 when c is inactive).
//
// Design: port-major bitmasks. For each lane and port p, smask[p] and
// rmask[p] are bitmasks over the lane's coflows (ceil(C/32) words, the
// inactive coflows left out). Then
//
//     k_c = popcount(OR_{p in S_c} smask[p] | OR_{p in R_c} rmask[p]
//                    without c's own bit)
//
// which takes sum_c (|S_c| + |R_c|) x ceil(C/32) word ORs: never more
// than the pairwise C x C x 2 ceil(P/32) word ANDs (|S_c| + |R_c| <= 2P),
// and about 20x fewer at Table 2's 5% density. The count is an exact
// integer: no float tolerance.
//
// One cooperative launch, two phases split by a grid barrier:
//  1. pack: one warp per (lane, s/r, 32 coflows, 32 ports). Lane l loads
//     the 32 coflows' entries of port 32q + l (each load coalesced over
//     the ports, all 32 in flight, beside the coflows' active flags);
//     the 32 bits it holds are the mask word of its port, and 32 ballots
//     transpose them into the 32 coflows' port words (the rows' port
//     lists). Both go to a global scratch (L2-resident: 20 KB a lane at
//     the fleet shape); inactive coflows pack to zero. The outputs are
//     zeroed here too.
//  2. count: tiles of (lane, 8 mask words = 256 coflows, 128 rows). A
//     block stages the tile's 8 words of every port's two masks and the
//     rows' port words in shared memory with cp.async (one round trip to
//     L2 a tile); each row is taken by LPR lanes (LPR = the next power of
//     two >= ceil(P/32)), lane q walking the set bits of port word q of
//     both lists, four ports a trip so that their 16-byte mask reads are
//     in flight together, then the lanes' words are OR-reduced by
//     shuffles, the row's own bit cleared, and the popcount added to
//     out[c] with an integer atomicAdd (exact in any order). Where a
//     lane's masks outgrow one tile (Table 2: 512 KB), each tile adds its
//     partial count.
// The grid is sized to the card (at most two blocks an SM, all
// co-resident, as a cooperative launch needs), so both shapes fill the
// 132 SMs: 3840 pack warps and 240 tiles at (16, 528, 150), 4096 warps
// and 512 tiles at (1, 4096, 512). Both phases are bound by latency (a
// round trip to memory a pack item, a dependent chain of shared-memory
// reads a set bit), not by bytes or word operations.
//
// Inputs: f32 (elt_bytes 4), bf16 (2) or bool/uint8 (1). The Pallas and
// plain versions threshold the float product at 0.5; the port's inputs
// are {0,1} by contract, and this kernel reads ANY non-zero value (sign
// bit ignored, so -0.0 is zero) as 1.
//
// Bound on this card: the bytes, B*C*2P*elt + 5 B*C (10 MB of f32 at the
// fleet shape, 3 us at 3.35 TB/s; 2.5 MB of bool); the word operations
// are far below it at either shape.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WK = 8;          // mask words of one count tile (uint4 x 2)
constexpr int RT = 128;        // rows of one count tile
constexpr int MAX_BLOCKS_PER_SM = 2;
constexpr unsigned FULL = 0xffffffffu;

// Asynchronous global -> shared copies (cp.async): a tile's loads are all
// in flight at once instead of one round trip to L2 per loop step.
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

template <int ELT>
__device__ __forceinline__ bool nonzero(const void* a, long long off) {
  if (ELT == 4)
    return (static_cast<const uint32_t*>(a)[off] & 0x7fffffffu) != 0u;
  if (ELT == 2)
    return (static_cast<const uint16_t*>(a)[off] & 0x7fffu) != 0u;
  return static_cast<const uint8_t*>(a)[off] != 0;
}

// masks: (B, 2, P, WC) words, WC = ceil(C/32) rounded up to WK;
// rows: (B, C, 2, WP) words, WP = ceil(P/32); out: (B, C) int32.
template <int ELT>
__global__ void __launch_bounds__(THREADS, MAX_BLOCKS_PER_SM)
contention(const void* __restrict__ a_send, const void* __restrict__ a_recv,
           const uint8_t* __restrict__ active, uint32_t* __restrict__ masks,
           uint32_t* __restrict__ rows, int32_t* __restrict__ out, int B,
           int C, int P, int WC, int WP, int lpr) {
  extern __shared__ uint4 sm[];   // (2, P, WK) mask words, RT row lists
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long nthreads = (long long)gridDim.x * THREADS;
  const long long gtid = (long long)blockIdx.x * THREADS + tid;

  // ---- 1. pack ----------------------------------------------------------
  for (long long i = gtid; i < (long long)B * C; i += nthreads) out[i] = 0;
  const long long items = (long long)B * 2 * WC * WP;
  for (long long it = gtid >> 5; it < items; it += nthreads >> 5) {
    const int q = (int)(it % WP);
    long long rest = it / WP;
    const int w = (int)(rest % WC);
    rest /= WC;
    const int arr = (int)(rest & 1);
    const int b = (int)(rest >> 1);
    const void* a = arr ? a_recv : a_send;
    const int c0 = 32 * w;
    const int p = 32 * q + lane;
    const bool act = c0 + lane < C && active[(long long)b * C + c0 + lane];
    uint32_t col = 0u;   // bit i: coflow c0 + i uses port p
    if (p < P) {   // loaded beside `active`, not after it: one round trip
      const long long base = ((long long)b * C + c0) * P + p;
      const int rows_here = min(32, C - c0);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (i < rows_here)
          col |= (uint32_t)nonzero<ELT>(a, base + (long long)i * P) << i;
    }
    col &= __ballot_sync(FULL, act);   // inactive coflows left out
    if (p < P) masks[(((long long)b * 2 + arr) * P + p) * WC + w] = col;
    uint32_t mine = 0u;  // lane i: port word q of coflow c0 + i
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const uint32_t word = __ballot_sync(FULL, (col >> i) & 1u);
      if (lane == i) mine = word;
    }
    if (c0 + lane < C)
      rows[(((long long)b * C + c0 + lane) * 2 + arr) * WP + q] = mine;
  }

  cg::this_grid().sync();

  // ---- 2. count ---------------------------------------------------------
  const int K = WC / WK;
  const int RB = (C + RT - 1) / RT;
  const long long tiles = (long long)B * K * RB;
  const int group = tid / lpr, q = tid % lpr;
  const int per_pass = THREADS / lpr;
  uint32_t* srow = reinterpret_cast<uint32_t*>(sm + 2 * P * 2);  // RT x 2WP
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r = (int)(tile % RB);
    const int k = (int)((tile / RB) % K);
    const int b = (int)(tile / ((long long)RB * K));
    const int c0 = r * RT, nrow = min(RT, C - c0);
    __syncthreads();   // the last tile's masks and rows are read
    for (int i = tid; i < 2 * P * 2; i += THREADS) {
      const int half = i & 1, ap = i >> 1;   // ap = arr * P + p
      copy16(sm + i, masks + ((long long)b * 2 * P + ap) * WC + k * WK +
                         4 * half);
    }
    const uint32_t* trow = rows + ((long long)b * C + c0) * 2 * WP;
    const int nw = nrow * 2 * WP;
    if ((reinterpret_cast<uintptr_t>(trow) & 15) == 0 && (nw & 3) == 0) {
      for (int i = tid; i < nw / 4; i += THREADS)
        copy16(srow + 4 * i, trow + 4 * i);
    } else {
      for (int i = tid; i < nw; i += THREADS) copy4(srow + i, trow + i);
    }
    copies_done();
    __syncthreads();
    // the tile's words past ceil(C/32) are zero: skip their half
    const bool upper = 32 * (k * WK + WK / 2) < C;
    for (int r0 = 0; r0 < nrow; r0 += per_pass) {
      const int cl = r0 + group;   // row within the tile
      uint32_t acc[WK] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      if (cl < nrow && q < WP) {
        for (int arr = 0; arr < 2; ++arr) {
          uint32_t bits = srow[(cl * 2 + arr) * WP + q];
          const uint4* ms = sm + 2 * (arr * P + 32 * q);
          while (bits) {   // up to four ports a trip, their reads in flight
            int pp[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              pp[j] = bits ? __ffs(bits) - 1 : -1;
              bits &= bits - 1u;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (pp[j] < 0) continue;
              const uint4 m0 = ms[2 * pp[j]];
              acc[0] |= m0.x; acc[1] |= m0.y; acc[2] |= m0.z; acc[3] |= m0.w;
              if (upper) {
                const uint4 m1 = ms[2 * pp[j] + 1];
                acc[4] |= m1.x; acc[5] |= m1.y; acc[6] |= m1.z;
                acc[7] |= m1.w;
              }
            }
          }
        }
      }
      for (int o = lpr >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int j = 0; j < WK; ++j) acc[j] |= __shfl_xor_sync(FULL, acc[j], o);
      if (q == 0 && cl < nrow) {
        const int c = c0 + cl;
        const int self = c - k * WK * 32;
        int n = 0;
#pragma unroll
        for (int j = 0; j < WK; ++j) {
          uint32_t v = acc[j];
          if (self >= 32 * j && self < 32 * (j + 1)) v &= ~(1u << (self & 31));
          n += __popc(v);
        }
        if (n) atomicAdd(out + (long long)b * C + c, n);
      }
    }
  }
}

// The most co-resident blocks of contention<ELT> on the current device
// for this P (its shared memory depends on P alone). Worked out, with the
// shared-memory attribute raised to the most any kept P needs, on the
// first call for a (device, P) and kept, so that a tick's call makes no
// host queries before its launch.
template <int ELT>
cudaError_t resident_blocks(int P, int smem, long long* most) {
  struct Entry { int dev, P, smem; long long most; };
  static std::mutex mu;
  static Entry cache[16];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].P == P) {
      *most = cache[i].most;
      return cudaSuccess;
    }
  auto kernel = contention<ELT>;
  int smem_max = smem;
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].smem > smem_max)
      smem_max = cache[i].smem;
  e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *most = (long long)sms *
          (per_sm < MAX_BLOCKS_PER_SM ? per_sm : MAX_BLOCKS_PER_SM);
  cache[used < 16 ? used++ : 15] = {dev, P, smem, *most};
  return cudaSuccess;
}

template <int ELT>
int launch(const void* a_send, const void* a_recv, const void* active,
           void* masks, void* rows, void* out, int B, int C, int P,
           cudaStream_t stream) {
  int WC = (C + 31) / 32;
  WC = (WC + WK - 1) / WK * WK;
  const int WP = (P + 31) / 32;
  int lpr = 1;
  while (lpr < WP) lpr <<= 1;
  const int smem = (2 * P * WK + RT * 2 * WP) * (int)sizeof(uint32_t);
  long long most = 0;
  cudaError_t e = resident_blocks<ELT>(P, smem, &most);
  if (e != cudaSuccess) return (int)e;
  const long long pack_blocks =
      ((long long)B * 2 * WC * WP + WARPS - 1) / WARPS;
  const long long tiles = (long long)B * (WC / WK) * ((C + RT - 1) / RT);
  long long grid = pack_blocks > tiles ? pack_blocks : tiles;
  if (grid > most) grid = most;
  if (grid < 1) grid = 1;
  const uint8_t* act = static_cast<const uint8_t*>(active);
  uint32_t* m = static_cast<uint32_t*>(masks);
  uint32_t* rw = static_cast<uint32_t*>(rows);
  int32_t* o = static_cast<int32_t*>(out);
  void* args[] = {(void*)&a_send, (void*)&a_recv, (void*)&act, (void*)&m,
                  (void*)&rw, (void*)&o, (void*)&B, (void*)&C, (void*)&P,
                  (void*)&WC, (void*)&WP, (void*)&lpr};
  e = cudaLaunchCooperativeKernel((const void*)contention<ELT>,
                                  dim3((unsigned)grid), dim3(THREADS), args,
                                  (size_t)smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Words of the scratch the caller allocates (32-byte aligned): the masks
// (B, 2, P, WC), then the rows (B, C, 2, WP).
extern "C" long long saath_contention_scratch(int B, int C, int P) {
  long long WC = (C + 31) / 32;
  WC = (WC + WK - 1) / WK * WK;
  return (long long)B * 2 * P * WC + (long long)B * C * 2 * ((P + 31) / 32);
}

// a_send, a_recv: (B, C, P) f32 (elt_bytes 4), bf16 (2) or bool (1);
// active: (B, C) bool; scratch: saath_contention_scratch(B, C, P) words;
// out: (B, C) int32. All contiguous on the current device. One
// cooperative launch; returns its cudaError_t (0 = launched).
extern "C" int saath_contention(const void* a_send, const void* a_recv,
                                const void* active, void* scratch, void* out,
                                int B, int C, int P, int elt_bytes,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || C == 0) return 0;
  long long WC = (C + 31) / 32;
  WC = (WC + WK - 1) / WK * WK;
  uint32_t* masks = static_cast<uint32_t*>(scratch);
  uint32_t* rows = masks + (long long)B * 2 * P * WC;
  if (elt_bytes == 4)
    return launch<4>(a_send, a_recv, active, masks, rows, out, B, C, P, s);
  if (elt_bytes == 2)
    return launch<2>(a_send, a_recv, active, masks, rows, out, B, C, P, s);
  return launch<1>(a_send, a_recv, active, masks, rows, out, B, C, P, s);
}
