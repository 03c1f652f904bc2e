// Forward GQA flash attention on Hopper (sm_90a): kernel K5.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (body _flash_kernel), the TPU fast path of the
// chunked online-softmax attention that the prefill of every attention
// layer runs (repro/models/attention.py:181, jnp_flash). For query head h
// (KV head h / G, G = H / Hkv; K and V are never repeated), query row i
// at absolute position q_offset + i and key j:
//
//     s_ij = (q_i . k_j) D^-1/2, masked where j >= T or, under causal,
//            j > q_offset + i
//     m = running max, l = running sum of exp(s - m), acc = running
//     sum of exp(s - m) v; o_i = acc / max(l, 1e-30) in q's type.
//
// Inputs q (B, H, S, D), k (B, Hkv, T, D) and v (B, Hkv, T, DV) and the
// output o (B, H, S, DV), each given by its (batch, head, row) strides
// with the last axis contiguous, so (B, S, H, D) tensors and slices of a
// longer KV cache pass as views without a copy; f32 or bf16 (all four of
// one type); (D, DV) one of (16, 16), (32, 32), (64, 64), (128, 128),
// (192, 128), MLA's prefill (repro/models/attention.py:268: q.k over 128
// columns without RoPE and 64 with, values 128 wide; the scale D^-1/2 is
// jnp_flash's, so MLA's folded factor is 1), and (256, 256), Gemma-7B's
// heads. Two designs, one for each type; each takes the pairs as template
// parameters. Causal or not (an encoder's self-attention, a decoder's
// cross attention of S rows against T != S encoder rows).
//
// Bound on this card: at the serve shape (B 4, H 24, Hkv 2, S = T =
// 2000, D 128, causal) the function needs 2 D multiply-adds for each of
// the 192 M unmasked (query, key) pairs, 98 GFLOP: 1.47 ms at the f32
// rate of 67 TFLOP/s, 0.099 ms at the bf16 tensor-core rate of 989; its
// bytes (q and o once, k and v once per KV head, 106 MB in bf16) take
// 0.032 ms at 3.35 TB/s. Its exps (one a pair) run on the SFUs at 16 a
// clock an SM (~4.2 T/s): 0.046 ms, half of the bf16 product time. At
// DeepSeek-V2's MLA prefill (B 4, H = Hkv = 128, S = T = 1000, (192,
// 128)) it needs (192 + 128) multiply-adds for each of 256 M pairs, 164
// GFLOP: 0.166 ms in bf16, 2.45 ms in f32; its bytes 0.098 ms.
//
// f32 (flash_fwd<float, D>, the port's first design; the 2e-6 bar rules
// out TF32, so the products stay on the CUDA cores): one block of 256
// threads takes one (batch, head, tile of BQ = 64 query rows) and loops
// over the key tiles of BK = 64 itself, stopping at the causal limit of
// its last row (the Pallas grid's `run` skip, as a loop bound). The
// query tile sits in shared memory transposed (D x BQ) for the whole
// loop; each key tile is staged transposed (D x BK) and each value tile
// as it is (BK x D). Thread (ty, tx) of the 16 x 16 grid owns query rows
// 4ty..4ty+3: it computes their scores against keys 4tx..4tx+3 from two
// float4 reads per step of d, the row max and sum by shuffles over its
// half-warp, and keeps the rows' m, l and a (4, D / 16) slice of acc in
// registers; the probabilities go back to shared memory (over the key
// tile) for acc += P V. 101.6 KB of shared memory at D = 128, two
// blocks an SM; 137.2 KB at (192, 128), one; 204.8 KB at (256, 256), one.
// Bound by its f32 multiply-adds and the shared-memory reads that feed
// them.
//
// bf16 (hopper::flash_fwd_sm90<D>; the 2e-2 bar admits bf16 products
// with f32 sums): both products run on the tensor cores (wgmma), which
// bound it, with the exps overlapped under them.
//   - Block: 3 warpgroups. Warpgroup 0 is the producer: it gives up
//     registers (setmaxnreg 24) and one thread issues every TMA load.
//     Warpgroups 1 and 2 are consumers (setmaxnreg 240), 64 query rows
//     each, so a block takes BQ = 128 rows of one (batch, head). The
//     grid is one block per (tile, head, batch), the heaviest causal
//     tiles first over all heads.
//   - TMA: 4-D tensor maps (D, rows, heads, batch) built on the host
//     from the tensors' own strides and extents (S for q, T for k and
//     v, never a cache's length), rows past the extent read as zero.
//     A box is at most 128 bytes wide under the 128B swizzle, so a tile
//     of 128 rows lies in shared memory as D / 64 column blocks of 64
//     columns at D = 128 (one block, swizzled 128B / 64B / 32B, at D =
//     64 / 32 / 16). Q is loaded once; K and V tiles of BK = 128 keys
//     (64 at D = 256, bk<D>) go through a ring of 2 stages each, every
//     stage with a "full" mbarrier (expect-tx bytes) and an "empty" one
//     (one arrival per consumer warp); their TMA boxes are BK rows high,
//     Q's 128. TMA needs a 16-byte-aligned base and strides that are
//     multiples of 16 bytes; the wrapper raises on any other view. 160
//     KB of shared memory at D = 128, one block an SM; at (192, 128) Q
//     and K tiles take 3 column blocks (48 KB) and V tiles 2 (32 KB):
//     208 KB; at (256, 256) Q 64 KB and K and V tiles of 64 keys 32 KB
//     each: 192 KB (128-key rings would need 320).
//   - S = Q K^T: wgmma m64n{BK}k16 (n64 at D = 256), both operands
//     K-major in shared memory, D / 16 k-steps (32 bytes along a
//     swizzled row, then the next column block): 12 at D = 192, 16 at
//     256.
//   - Online softmax on the f32 accumulator fragment, in registers: the
//     row max over the 4 threads of a row (2 shuffles), D^-1/2 log2 e
//     folded into one multiply-add before ex2, l summed per thread from
//     the f32 p and across the row once at the end; only the key tiles
//     that cross T or the causal limit are masked, and the key loop
//     stops at the causal limit of the block's last row.
//   - O += P V: P rounded to bf16 in registers is the A operand of
//     wgmma m64n{DV}k16 (the accumulator fragment is the A fragment's
//     layout), so it never touches shared memory; V is the B operand,
//     MN-major (transposed), its column blocks one leading offset apart.
//     At DV = 256 O is 128 f32 registers a consumer thread, S 32 and P
//     16: the 64-key tile is what leaves them room under setmaxnreg 240
//     (no spill, 168 registers at launch).
//   - Overlap, both ways: within a consumer, S_j = Q K_j^T and O +=
//     P_{j-1} V_{j-1} are issued together, the exps of S_j run while
//     the second product is in flight, and O is rescaled once it has
//     landed; across the two consumers, named barriers make them take
//     turns to issue (ping-pong), so one's exps run under the other's
//     products. K stages are released as soon as S_j has landed, V
//     stages after their product.
//   - Epilogue: o = O / max(l, 1e-30) in bf16 to the strided output,
//     rows >= S masked.
//   Rounding against the Pallas contract: _flash_kernel forms P V with P
//   and V in f32; here P is rounded to bf16 (ROADMAP C8).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int TP = 4;           // row padding of the transposed tiles
constexpr int QT = BQ + TP;     // row length of Qt (D rows) and Pt (BK rows)
constexpr int KT = BK + TP;     // row length of Kt (D rows)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

// floats of shared memory: Qt (D x QT), the key tile Kt (D x KT) shared
// with the probabilities Pt (BK x QT), the value tile V (BK x DV)
__host__ __device__ constexpr size_t kp_floats(int D) {
  return (size_t)D * KT > (size_t)BK * QT ? (size_t)D * KT
                                          : (size_t)BK * QT;
}
__host__ __device__ constexpr size_t smem_floats(int D, int DV) {
  return (size_t)D * QT + kp_floats(D) + (size_t)BK * DV;
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int H, int G, int S,
          int Tk, long long qsb, long long qsh, long long qss,
          long long ksb, long long ksh, long long kss, long long vsb,
          long long vsh, long long vss, long long osb, long long osh,
          long long oss, float scale, int causal, int q_offset) {
  // o columns of thread tx: NJ groups of VEC, group g at
  // g * 16 VEC + tx VEC (a quarter-warp's float4 reads hit 32 banks)
  constexpr int VEC = DV >= 64 ? 4 : DV / 16;
  constexpr int NJ = DV / (16 * VEC);
  extern __shared__ float smem[];
  float* Qt = smem;                  // D x QT
  float* Kt = Qt + D * QT;           // D x KT, then Pt: BK x QT
  float* Pt = Kt;
  float* Vs = Kt + kp_floats(D);     // BK x DV

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / G) * ksh;
  const T* vb = v + b * vsb + (h / G) * vsh;
  T* ob = o + b * osb + h * osh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    Qt[d * QT + r] = q0 + r < S ? to_f(qb[(q0 + r) * qss + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NJ * VEC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NJ * VEC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int kend = causal ? min(Tk, q_offset + q_last + 1) : Tk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();   // Qt written; the last tile's Pt and V read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D, t = k0 + c;
      Kt[d * KT + c] = t < Tk ? to_f(kb[t * kss + d]) : 0.f;
    }
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int c = i / DV, d = i % DV, t = k0 + c;
      Vs[c * DV + d] = t < Tk ? to_f(vb[t * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + d * QT + 4 * ty);
      const float4 kv = *reinterpret_cast<const float4*>(Kt + d * KT + 4 * tx);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + 4 * ty + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        const bool ok = kpos < Tk && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w >= 1; w /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int w = 8; w >= 1; w /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NJ * VEC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();   // every thread has read the key tile
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (4 * tx + j) * QT + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(Pt + c * QT + 4 * ty);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < NJ; ++g) {
        const float* vr = Vs + c * DV + g * 16 * VEC + tx * VEC;
        float va[VEC];
        if constexpr (VEC == 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(vr);
          va[0] = t4.x; va[1] = t4.y; va[2] = t4.z; va[3] = t4.w;
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) va[e] = vr[e];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[i][g * VEC + e] = fmaf(pa[i], va[e], acc[i][g * VEC + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= S) continue;
    const float lm = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NJ; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        ob[r * oss + g * 16 * VEC + tx * VEC + e] =
            from_f<T>(acc[i][g * VEC + e] / lm);
  }
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int S, int Tk, const long long* st, float scale,
           int causal, int q_offset, cudaStream_t stream) {
  const size_t bytes = smem_floats(D, DV) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<T, D, DV><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / Hkv, S, Tk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale, causal, q_offset);
  return (int)cudaGetLastError();
}

// the (D, DV) pairs of both instances, as one key
constexpr int widths(int D, int DV) { return D * 1024 + DV; }

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int S, int Tk, int D, int DV,
             const long long* st, float scale, int causal, int q_offset,
             cudaStream_t stream) {
  switch (widths(D, DV)) {
    case widths(16, 16):
      return launch<T, 16, 16>(q, k, v, o, B, H, Hkv, S, Tk, st, scale,
                               causal, q_offset, stream);
    case widths(32, 32):
      return launch<T, 32, 32>(q, k, v, o, B, H, Hkv, S, Tk, st, scale,
                               causal, q_offset, stream);
    case widths(64, 64):
      return launch<T, 64, 64>(q, k, v, o, B, H, Hkv, S, Tk, st, scale,
                               causal, q_offset, stream);
    case widths(128, 128):
      return launch<T, 128, 128>(q, k, v, o, B, H, Hkv, S, Tk, st, scale,
                                 causal, q_offset, stream);
    case widths(192, 128):
      return launch<T, 192, 128>(q, k, v, o, B, H, Hkv, S, Tk, st, scale,
                                 causal, q_offset, stream);
    case widths(256, 256):
      return launch<T, 256, 256>(q, k, v, o, B, H, Hkv, S, Tk, st, scale,
                                 causal, q_offset, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---- the bf16 instance: wgmma tensor cores fed by a TMA ring ------------

namespace hopper {

using namespace sm90;

constexpr int BQ = 128;          // query rows per block, 64 per consumer
constexpr int STAGES = 2;        // K and V tiles in flight, each
constexpr int THREADS = 384;     // a producer and two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;

// keys per K and V tile: 128, but 64 at D = 256, where 128-key rings
// would not fit a block's shared memory (64 + 2 x 64 + 2 x 64 KB) and
// the 128 accumulator registers of O leave a consumer room for a
// 64-key S only
template <int D>
__host__ __device__ constexpr int bk() { return D >= 256 ? 64 : 128; }

// shared-memory geometry of a tile of ROWS rows of width D: NB column
// blocks of INNER columns (one TMA box each), rows of ROWB bytes,
// swizzled over ROWB (the widest swizzle a box can take)
template <int D, int ROWS>
struct Geo {
  static constexpr int INNER = D < 64 ? D : 64;
  static constexpr int ROWB = 2 * INNER;               // 32, 64 or 128
  static constexpr int NB = D / INNER;                  // 2 at D = 128
  static constexpr int BLOCK = ROWS * ROWB;             // bytes a column block
  static constexpr int TILE = NB * BLOCK;               // bytes a tile
  static constexpr uint32_t SWZ = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
};

// the block's shared memory at q.k width D and value width DV: Q, then
// the K ring, then the V ring; 9 barriers after them. 160 KB at (128,
// 128), 208 KB at (192, 128), 192 KB at (256, 256)
template <int D, int DV>
struct Smem {
  using GQ = Geo<D, BQ>;
  using GK = Geo<D, bk<D>()>;
  using GV = Geo<DV, bk<D>()>;
  static constexpr int SK = GQ::TILE;                         // the K ring
  static constexpr int SV = SK + STAGES * GK::TILE;           // the V ring
  static constexpr int BAR_OFF = SV + STAGES * GV::TILE;
  static constexpr size_t BYTES = 1024 + BAR_OFF + 9 * 8;  // + alignment slack
};

// S = Q K^T for one consumer's 64 rows and the tile's N keys: D / 16
// k-steps, both operands K-major; a k-step moves 32 bytes along a
// swizzled row, then to the next column block (Q's and K's blocks
// differ in height)
template <int D, int N>
__device__ __forceinline__ void qk(float (&s)[N / 2], uint32_t sq,
                                   uint32_t sk) {
  using GQ = Geo<D, BQ>;
  using GK = Geo<D, N>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t blk = kk / (GQ::INNER / 16), col = (kk % (GQ::INNER / 16)) * 32;
    wgmma_ss<N>(s, desc(sq + blk * GQ::BLOCK + col, 16, 8 * GQ::ROWB, GQ::SWZ),
                desc(sk + blk * GK::BLOCK + col, 16, 8 * GK::ROWB, GK::SWZ),
                kk > 0);
  }
}

// O += P V: N / 16 k-steps of 16 keys, P from registers, V MN-major (16
// key rows a step; its column blocks LBO apart)
template <int DV, int N>
__device__ __forceinline__ void pv(float (&o)[DV / 2],
                                   const uint32_t (&p)[N / 16][4],
                                   uint32_t sv) {
  using G = Geo<DV, N>;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_rs<DV>(o, p[kk],
                 desc(sv + kk * 16 * G::ROWB, G::BLOCK, 8 * G::ROWB, G::SWZ),
                 1);
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, long long osb, long long osh,
               long long oss, int B, int H, int G, int S, int Tk,
               int q_tiles, float scale_log2, int causal, int q_offset) {
  constexpr int BK = bk<D>();
  using Sm = Smem<D, DV>;
  using GQ = typename Sm::GQ;   // the Q tile
  using GK = typename Sm::GK;   // K tiles
  using GV = typename Sm::GV;   // V tiles
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + Sm::SK, sV = base + Sm::SV;
  const uint32_t bar_q = base + Sm::BAR_OFF;
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * STAGES,
                 empty_k = full_v + 8 * STAGES,
                 empty_v = empty_k + 8 * STAGES;

  // heaviest causal query tiles first, over every (batch, head)
  const int id = blockIdx.x, bh = B * H;
  const int q0 = (q_tiles - 1 - id / bh) * BQ;
  const int h = id % H, b = (id % bh) / H;
  const int q_last = min(q0 + BQ, S) - 1;
  const int kend = causal ? min(Tk, q_offset + q_last + 1) : Tk;
  const int n = (kend + BK - 1) / BK;     // key tiles of this block

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, CONSUMER_WARPS);
      mbar_init(empty_v + 8 * s, CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread issues every TMA load -------------------
    setmaxnreg_dec<24>();
    if (tid == 0 && n > 0) {
      const int hk = h / G;
      mbar_expect_tx(bar_q, GQ::TILE);
      for (int c = 0; c < GQ::NB; ++c)
        tma_load_4d(sQ + c * GQ::BLOCK, &tq, bar_q, c * GQ::INNER, q0, h, b);
      for (int j = 0; j < n; ++j) {
        const int s = j % STAGES;
        const uint32_t parity = ((j / STAGES) - 1) & 1;
        if (j >= STAGES) mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, GK::TILE);
        for (int c = 0; c < GK::NB; ++c)
          tma_load_4d(sK + s * GK::TILE + c * GK::BLOCK, &tk, full_k + 8 * s,
                      c * GK::INNER, j * BK, hk, b);
        if (j >= STAGES) mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, GV::TILE);
        for (int c = 0; c < GV::NB; ++c)
          tma_load_4d(sV + s * GV::TILE + c * GV::BLOCK, &tv, full_v + 8 * s,
                      c * GV::INNER, j * BK, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ---------------------------------
    setmaxnreg_inc<240>();
    const int cw = tid / 128 - 1;             // 0 or 1
    const int t = tid % 128, lane = t % 32;
    const int r0 = (t / 32) * 16 + lane / 4;  // rows r0 and r0 + 8 of 64
    const int row0 = q0 + 64 * cw + r0;       // query row in the sequence
    const uint32_t sq = sQ + 64 * cw * GQ::ROWB;
    const bool leader = lane == 0;            // arrives for its warp

    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    uint32_t p[BK / 16][4];

    // s <- exp2((s - m_new) D^-1/2 log2 e) for key tile j, with the
    // running max m updated and l rescaled and summed from the f32 p;
    // returns each row's rescale factor of the accumulator
    auto softmax = [&](int j, float (&alpha)[2]) {
      const int k0 = j * BK;
      if (k0 + BK > Tk || (causal && k0 + BK - 1 > q_offset + q0 + 64 * cw)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          const int qpos = q_offset + row0 + 8 * ((i / 2) % 2);
          if (kpos >= Tk || (causal && kpos > qpos)) s[i] = -INFINITY;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if ((i / 2) % 2 == r) mx = fmaxf(mx, s[i]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mu = mx == -INFINITY ? 0.f : mx;
        alpha[r] = ex2((m[r] - mu) * scale_log2);
        m[r] = mx;
        const float neg = -mu * scale_log2;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if ((i / 2) % 2 == r) {
            s[i] = ex2(fmaf(s[i], scale_log2, neg));
            sum += s[i];
          }
        l[r] = l[r] * alpha[r] + sum;
      }
    };
    auto to_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    };

    // ping-pong: the two consumers take turns to issue their products
    // (named barrier 1 + cw is consumer cw's turn), so that one's exps
    // run under the other's products; consumer 1 first hands the first
    // turn to consumer 0, and each issues n + 1 times
    auto turn_wait = [&]() { bar_sync(1 + cw, 256); };
    auto turn_pass = [&]() { bar_arrive(2 - cw, 256); };
    if (n > 0) {
      float alpha[2];
      if (cw == 1) bar_arrive(1, 256);
      mbar_wait(bar_q, 0);
      mbar_wait(full_k, 0);
      turn_wait();
      wgmma_fence();
      qk<D, BK>(s, sq, sK);
      wgmma_commit();
      turn_pass();
      wgmma_wait<0>();
      fence_operand(s);
      if (leader) mbar_arrive(empty_k);
      softmax(0, alpha);
      to_p();
      for (int j = 1; j < n; ++j) {
        const int st = j % STAGES, sp = (j - 1) % STAGES;
        // S_j = Q K_j^T and O += P_{j-1} V_{j-1} in flight together;
        // the exps of S_j run under the second product
        mbar_wait(full_k + 8 * st, (j / STAGES) & 1);
        fence_operand(acc);
        turn_wait();
        wgmma_fence();
        qk<D, BK>(s, sq, sK + st * GK::TILE);
        wgmma_commit();
        mbar_wait(full_v + 8 * sp, ((j - 1) / STAGES) & 1);
        pv<DV, BK>(acc, p, sV + sp * GV::TILE);
        wgmma_commit();
        turn_pass();
        wgmma_wait<1>();
        fence_operand(s);
        if (leader) mbar_arrive(empty_k + 8 * st);
        softmax(j, alpha);
        wgmma_wait<0>();
        fence_operand(acc);
        if (leader) mbar_arrive(empty_v + 8 * sp);
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
        to_p();
      }
      const int sp = (n - 1) % STAGES;
      mbar_wait(full_v + 8 * sp, ((n - 1) / STAGES) & 1);
      fence_operand(acc);
      turn_wait();
      wgmma_fence();
      pv<DV, BK>(acc, p, sV + sp * GV::TILE);
      wgmma_commit();
      if (cw == 0) turn_pass();   // consumer 0 takes no turn after this
      wgmma_wait<0>();
      fence_operand(acc);
    }

    // o = acc / max(l, 1e-30) over the 4 threads that share a row
    __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < DV / 2; i += 2) {
      const int r = (i / 2) % 2, row = row0 + 8 * r;
      if (row < S)
        *reinterpret_cast<__nv_bfloat162*>(
            ob + row * oss + 8 * (i / 4) + 2 * (lane % 4)) =
            __floats2bfloat162_rn(acc[i] * l[r], acc[i + 1] * l[r]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the CUDA driver's cuTensorMapEncodeTiled (its 12.0 form), found
// through the runtime, so the library links no -lcuda (needs CUDA 12.5+)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult res;
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &res);
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a 4-D map (D, rows, heads, batch) over a bf16 tensor with the given
// (row, head, batch) strides in elements, boxes of (INNER, BOX, 1, 1),
// rows past `rows` read as zero
template <int D, int BOX>
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int heads,
                int batch, long long srow, long long shead, long long sbatch) {
  using G = Geo<D, BOX>;
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(rows > 0 ? rows : 1),
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)srow * 2, (cuuint64_t)shead * 2,
                                 (cuuint64_t)sbatch * 2};
  const cuuint32_t box[4] = {G::INNER, BOX, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = G::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : G::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int S, int Tk, const long long* st, float scale,
           int causal, int q_offset, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!tensor_map<D, BQ>(&mq, q, S, H, B, st[2], st[1], st[0]) ||
      !tensor_map<D, bk<D>()>(&mk, k, Tk, Hkv, B, st[5], st[4], st[3]) ||
      !tensor_map<DV, bk<D>()>(&mv, v, Tk, Hkv, B, st[8], st[7], st[6]))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = Smem<D, DV>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int q_tiles = (S + BQ - 1) / BQ;
  flash_fwd_sm90<D, DV><<<q_tiles * H * B, THREADS, bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11], B,
      H, H / Hkv, S, Tk, q_tiles, scale * 1.4426950408889634f, causal,
      q_offset);
  return (int)cudaGetLastError();
}

int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int S, int Tk, int D, int DV,
             const long long* st, float scale, int causal, int q_offset,
             cudaStream_t stream) {
  switch (widths(D, DV)) {
    case widths(16, 16):
      return launch<16, 16>(q, k, v, o, B, H, Hkv, S, Tk, st, scale, causal,
                            q_offset, stream);
    case widths(32, 32):
      return launch<32, 32>(q, k, v, o, B, H, Hkv, S, Tk, st, scale, causal,
                            q_offset, stream);
    case widths(64, 64):
      return launch<64, 64>(q, k, v, o, B, H, Hkv, S, Tk, st, scale, causal,
                            q_offset, stream);
    case widths(128, 128):
      return launch<128, 128>(q, k, v, o, B, H, Hkv, S, Tk, st, scale,
                              causal, q_offset, stream);
    case widths(192, 128):
      return launch<192, 128>(q, k, v, o, B, H, Hkv, S, Tk, st, scale,
                              causal, q_offset, stream);
    case widths(256, 256):
      return launch<256, 256>(q, k, v, o, B, H, Hkv, S, Tk, st, scale,
                              causal, q_offset, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace hopper

}  // namespace

// D: the q.k width (of q and k), Dv: the value width (of v and o).
// strides: the (batch, head, row) strides of q, k, v and o, in elements,
// in that order (12 values); the last axis is contiguous. bf16 != 0: q,
// k, v and o are bf16, else f32. Returns the CUDA error code of the
// launch (0 = none; cudaErrorInvalidValue for a (D, Dv) the kernel is
// not built for or a bf16 tensor that TMA cannot map).
extern "C" int saath_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int Hkv, int S, int Tk, int D, int Dv,
                                     const long long* strides, float scale,
                                     int causal, int q_offset, int bf16,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return hopper::launch_d(q, k, v, o, B, H, Hkv, S, Tk, D, Dv, strides,
                            scale, causal, q_offset, s);
  return launch_d<float>(q, k, v, o, B, H, Hkv, S, Tk, D, Dv, strides, scale,
                         causal, q_offset, s);
}
