// LCoF contention counts k_c on Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/contention.py:
// contention_pallas (body _contention_kernel), which forms
// S = A_s A_s^T + A_r A_r^T on the TPU's matrix unit over bc x bc blocks
// and carries each row's count across the sequential j axis of its grid.
// Hopper's blocks run in no order, so nothing is carried across blocks
// here: a block owns a tile of rows and loops over all columns itself.
//
// k_c = number of other active coflows c' that share at least one sender
// or one receiver port with active coflow c (0 when c is inactive).
//
// Design. The incidence is {0,1}, so a coflow's sender and receiver port
// sets are bit-packed into 32-bit words (150 ports = 5 + 5 words) by
// pack_ports (one warp per word: __ballot_sync over 32 ports, coalesced
// loads). count_contention then gives each block TR rows of one lane and
// walks the columns in tiles of TC staged in shared memory; a pair
// overlaps when any (s[c] & s[c']) | (r[c] & r[c']) word is non-zero.
// Inactive coflows pack to all-zero words, so they neither count nor are
// counted. The result is an exact integer: there is no float tolerance.
//
// Inputs that are not exactly 0 or 1: the Pallas and plain versions
// threshold the float product at 0.5; the port's f32 and bf16 inputs are
// {0,1} by contract, and this kernel reads ANY non-zero value (sign bit
// ignored, so -0.0 is zero) as 1.
//
// Bound on this card. At the main path's shape (B=16, C=528, P=150) the
// kernel must read B*C*2P*4 B ~ 10 MB of f32 incidence, ~3 us at
// 3.35 TB/s, so it is bound by bytes and, at that size, by launch
// overhead. At Table 2's (C=4096, P=512) the C^2 word ANDs dominate.
// Making it fast (bit-sliced popcount tiles, tensor cores) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TR = 64;        // rows per block
constexpr int TC = 64;        // columns per shared-memory tile
constexpr int THREADS = 256;  // 4 column groups of TR threads
constexpr int G = THREADS / TR;

// One warp per output word: words (rows, 2W) holds W sender words then
// W receiver words per row.
__global__ void pack_ports(const void* __restrict__ a_send,
                           const void* __restrict__ a_recv,
                           const uint8_t* __restrict__ active,
                           uint32_t* __restrict__ words,
                           long long rows, int P, int W, int elt_bytes) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long warp = t >> 5;
  int lane = (int)(t & 31);
  if (warp >= rows * 2 * W) return;   // uniform per warp
  long long row = warp / (2 * W);
  int w = (int)(warp % (2 * W));
  const void* a = w < W ? a_send : a_recv;
  int p = (w % W) * 32 + lane;
  bool on = false;
  if (p < P && active[row]) {
    long long off = row * P + p;
    if (elt_bytes == 4)
      on = (static_cast<const uint32_t*>(a)[off] & 0x7fffffffu) != 0u;
    else
      on = (static_cast<const uint16_t*>(a)[off] & 0x7fffu) != 0u;
  }
  uint32_t bits = __ballot_sync(0xffffffffu, on);
  if (lane == 0) words[warp] = bits;
}

// grid (ceil(C / TR), B); THREADS threads: thread t takes row t % TR of
// the tile and every G-th column of each column tile.
__global__ void count_contention(const uint32_t* __restrict__ words,
                                 int32_t* __restrict__ out, int C, int W2) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_row = smem;                       // TR x (W2 + 1), padded
  uint32_t* s_col = s_row + TR * (W2 + 1);      // TC x W2
  int* s_cnt = reinterpret_cast<int*>(s_col + TC * W2);  // THREADS

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TR;
  const int tid = threadIdx.x;
  const int r = tid % TR;
  const int g = tid / TR;
  const uint32_t* lane_words = words + (long long)b * C * W2;

  for (int i = tid; i < TR * W2; i += THREADS) {
    int rr = i / W2, w = i % W2, c = row0 + rr;
    s_row[rr * (W2 + 1) + w] = c < C ? lane_words[(long long)c * W2 + w] : 0u;
  }
  const int self = row0 + r;
  int count = 0;
  for (int col0 = 0; col0 < C; col0 += TC) {
    __syncthreads();
    for (int i = tid; i < TC * W2; i += THREADS) {
      int j = i / W2, w = i % W2, c = col0 + j;
      s_col[j * W2 + w] = c < C ? lane_words[(long long)c * W2 + w] : 0u;
    }
    __syncthreads();
    for (int j = g; j < TC; j += G) {
      int c2 = col0 + j;
      if (c2 >= C) break;
      uint32_t acc = 0u;
      for (int w = 0; w < W2; ++w)
        acc |= s_row[r * (W2 + 1) + w] & s_col[j * W2 + w];
      count += (acc != 0u && c2 != self) ? 1 : 0;
    }
  }
  s_cnt[tid] = count;
  __syncthreads();
  if (g == 0 && self < C) {
    int total = 0;
    for (int gg = 0; gg < G; ++gg) total += s_cnt[gg * TR + r];
    out[(long long)b * C + self] = total;
  }
}

}  // namespace

// a_send, a_recv: (B, C, P) f32 (elt_bytes 4) or bf16 (elt_bytes 2);
// active: (B, C) bool; words: (B, C, 2W) int32 scratch, W = ceil(P/32);
// out: (B, C) int32. All contiguous on the current device. Returns the
// cudaError_t of the launches (0 = launched).
extern "C" int saath_contention(const void* a_send, const void* a_recv,
                                const void* active, void* words, void* out,
                                int B, int C, int P, int elt_bytes,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || C == 0) return 0;
  const int W = (P + 31) / 32;
  const int W2 = 2 * W;
  const long long rows = (long long)B * C;
  if (W > 0) {
    long long threads = rows * W2 * 32;
    int blocks = (int)((threads + 255) / 256);
    pack_ports<<<blocks, 256, 0, s>>>(
        a_send, a_recv, static_cast<const uint8_t*>(active),
        static_cast<uint32_t*>(words), rows, P, W, elt_bytes);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  size_t smem = sizeof(uint32_t) * (TR * (W2 + 1) + TC * W2) +
                sizeof(int) * THREADS;
  dim3 grid((C + TR - 1) / TR, B);
  count_contention<<<grid, THREADS, smem, s>>>(
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(out), C,
      W2);
  return (int)cudaGetLastError();
}
