// Forward GQA flash attention on Hopper (sm_90a): kernel K5.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (body _flash_kernel), the TPU fast path of the
// chunked online-softmax attention that the prefill of every attention
// layer runs (repro/models/attention.py:181, jnp_flash). For query head h
// (KV head h / G, G = H / Hkv; K and V are never repeated), query row i
// at absolute position q_offset + i and key j, all in f32:
//
//     s_ij = (q_i . k_j) D^-1/2, set to -1e30 where j >= T or, under
//            causal, j > q_offset + i
//     m = running max, l = running sum of exp(s - m), acc = running
//     sum of exp(s - m) v; o_i = acc / max(l, 1e-30) in q's type.
//
// Inputs q (B, H, S, D), k and v (B, Hkv, T, D) and the output o
// (B, H, S, D), each given by its (batch, head, row) strides with the
// D axis contiguous, so (B, S, H, D) tensors pass as transposed views
// without a copy; f32 or bf16 (all four of one type); D in {16, 32, 64,
// 128}.
//
// Design (simple and right first). The Pallas grid carried m, l and acc
// in VMEM scratch across its sequential key axis; Hopper blocks run in
// no order and carry nothing, so one block of 256 threads takes one
// (batch, head, tile of BQ = 64 query rows) and loops over the key tiles
// of BK = 64 itself, stopping at the causal limit of its last row (the
// Pallas grid's `run` skip, as a loop bound). The query tile sits in
// shared memory transposed (D x BQ) for the whole loop; each key tile is
// staged transposed (D x BK) and each value tile as it is (BK x D), all
// as f32. Thread (ty, tx) of the 16 x 16 grid owns query rows 4ty..4ty+3:
// it computes their scores against keys 4tx..4tx+3 from two float4
// reads per step of d (16 multiply-adds), the row max and sum by
// shuffles over the 16 threads of its half-warp, and keeps the rows' m,
// l and a (4, D / 16) slice of acc in registers. The probabilities go
// back to shared memory (BK x BQ, over the key tile, which is no longer
// read) for acc += P V, one float4 of P and D / 64 float4 of V per key.
// At D = 128 a block takes 101.6 KB of shared memory (above 48 KB, so
// the launcher raises the block's dynamic limit), two blocks an SM. The
// heaviest query tiles (last under causal) are launched first. Every
// product is f32 on the CUDA cores: no TF32, no tensor cores, no TMA.
//
// Bound on this card: at the serve shape (B 4, H 24, Hkv 2, S = T =
// 2000, D 128, causal) the function needs 2 D multiply-adds for each of
// the 192 M unmasked (query, key) pairs, 98 GFLOP: 1.47 ms at the f32
// rate of 67 TFLOP/s, 0.10 ms at the bf16 tensor-core rate; its bytes
// (q and o once, k and v once per KV head, 106 MB in bf16) take
// 0.032 ms at 3.35 TB/s. Its exps (one a pair) run on the SFUs at 16 a
// clock an SM (~4.2 T/s): 0.046 ms, no bound, but half of the bf16
// product time, which is why fast Hopper kernels overlap them with
// wgmma. This kernel
// is bound by its f32 multiply-adds and the shared-memory reads that
// feed them; bf16 wgmma tiles, TMA and warp specialisation are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int TP = 4;           // row padding of the transposed tiles
constexpr int QT = BQ + TP;     // row length of Qt (D rows) and Pt (BK rows)
constexpr int KT = BK + TP;     // row length of Kt (D rows)
constexpr float NEG_INF = -1e30f;

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

// floats of shared memory: Qt (D x QT), the key tile Kt (D x KT) shared
// with the probabilities Pt (BK x QT), the value tile V (BK x D)
__host__ __device__ constexpr size_t kp_floats(int D) {
  return (size_t)D * KT > (size_t)BK * QT ? (size_t)D * KT
                                          : (size_t)BK * QT;
}
__host__ __device__ constexpr size_t smem_floats(int D) {
  return (size_t)D * QT + kp_floats(D) + (size_t)BK * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int H, int G, int S,
          int Tk, long long qsb, long long qsh, long long qss,
          long long ksb, long long ksh, long long kss, long long vsb,
          long long vsh, long long vss, long long osb, long long osh,
          long long oss, float scale, int causal, int q_offset) {
  // o columns of thread tx: NJ groups of VEC, group g at
  // g * 16 VEC + tx VEC (a quarter-warp's float4 reads hit 32 banks)
  constexpr int VEC = D >= 64 ? 4 : D / 16;
  constexpr int NJ = D / (16 * VEC);
  extern __shared__ float smem[];
  float* Qt = smem;                  // D x QT
  float* Kt = Qt + D * QT;           // D x KT, then Pt: BK x QT
  float* Pt = Kt;
  float* Vs = Kt + kp_floats(D);     // BK x D

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
      const bool ok = t < Tk;
      Kt[d * KT + c] = ok ? to_f(kb[t * kss + d]) : 0.f;
      Vs[c * D + d] = ok ? to_f(vb[t * vss + d]) : 0.f;
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
        const float* vr = Vs + c * D + g * 16 * VEC + tx * VEC;
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int S, int Tk, const long long* st, float scale,
           int causal, int q_offset, cudaStream_t stream) {
  const size_t bytes = smem_floats(D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / Hkv, S, Tk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale, causal, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int S, int Tk, int D, const long long* st,
             float scale, int causal, int q_offset, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, Hkv, S, Tk, st, scale, causal,
                           q_offset, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, Hkv, S, Tk, st, scale, causal,
                           q_offset, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Hkv, S, Tk, st, scale, causal,
                           q_offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Hkv, S, Tk, st, scale, causal,
                            q_offset, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: the (batch, head, row) strides of q, k, v and o, in elements,
// in that order (12 values); the D axis is contiguous. bf16 != 0: q, k,
// v and o are bf16, else f32. Returns the CUDA error code of the launch
// (0 = none; cudaErrorInvalidValue for a D the kernel is not built for).
extern "C" int saath_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int Hkv, int S, int Tk, int D,
                                     const long long* strides, float scale,
                                     int causal, int q_offset, int bf16,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, Tk, D, strides,
                                   scale, causal, q_offset, s);
  return launch_d<float>(q, k, v, o, B, H, Hkv, S, Tk, D, strides, scale,
                         causal, q_offset, s);
}
