// Hopper (sm_90a) flash attention, forward: blockwise online softmax over
// key tiles, so the (S, T) score matrix never reaches device memory.
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py:flash_attention (its _kernel).
// Plain C entry point, bound from Python with ctypes
// (repro_torch/kernels/flash_attention.py); it launches one kernel on the
// caller's stream and returns cudaGetLastError().
//
// Contract (flash_attention.py:73-128): q (B, H, S, D), k (B, H, T, D),
// v (B, H, T, Dv) -> out (B, H, S, Dv) in q's dtype (f32 or bf16), all
// contiguous. Scores are q.k * D^-0.5 in f32; the causal mask is top-left
// (key j seen by query i when j <= i, also when T != S) and masked scores
// are -1e30, not -inf. m, l and the (rows, Dv) accumulator stay in f32;
// out = acc / max(l, 1e-30). Any S and T: ragged query rows are computed
// on zeros and not stored, keys past T score -1e30. D and Dv are
// multiples of 8 up to 256 (the wrapper checks).
//
// What bounds it: at a long prompt the work is ~4 S T D H / 2 operations
// causal against ~(2 S + 2 T) D H elements moved, so it is bound by
// operations. This first version does them all as scalar f32 FMAs on the
// CUDA cores, f32 and bf16 inputs alike, with no TF32 and no tensor
// cores: f32 inputs must hold 2e-5 of the plain form, which TF32 cannot
// give, and bf16 inputs get the same arithmetic as the TPU kernel, which
// keeps p in f32 for P.V (flash_attention.py:58-62). Its bound is
// therefore the f32 rate (67 TFLOP/s) for f32 inputs; for bf16 the card's
// bound is the tensor-core rate, which this version does not reach.
//
// Design, simple first:
// - one block of 256 threads per (64-query tile, head, batch); query
//   tiles run last-first, so under the causal mask the longest tiles
//   start first;
// - the Q tile and each 64-key K tile are staged in shared memory as f32,
//   transposed (d-major), and the V tile row-major; dynamic shared memory
//   of 128 D + 64 Dv + 64 * 68 floats (113 KB at D = Dv = 128, 209 KB at
//   256);
// - thread (ty, tx) owns query rows 4 ty .. 4 ty + 3 and keys tx + 16 j
//   (j < 4) of the tile: 16 scores from one float4 of Q (broadcast across
//   the 16 lanes of its rows) and four K words (consecutive across lanes)
//   per d; the 16 lanes of a row group hold its m and l, reduced by an
//   xor butterfly (every lane ends with the same bits);
// - probabilities go through shared memory (rows padded to 68 floats, so
//   the transposed writes do not collide in a bank), and each thread then
//   accumulates its 4 rows x Dv / 16 value columns (float4 chunks
//   4 tx + 64 c) over the tile's keys;
// - under the causal mask, key tiles wholly above the diagonal are
//   skipped: in the TPU kernel they add exp(-1e30 - m) = 0 exactly, and
//   the first tile always holds key 0, which every query sees.
// cp.async/TMA double buffering of the K/V tiles and wgmma for bf16 are
// left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // keys per tile
constexpr int kPStride = kBQ + 4;     // padded row of the probability tile
constexpr float kNegInf = -1e30f;     // flash_attention.py NEG_INF
static_assert(kBQ == kBK, "one staging routine serves Q and K tiles");

// 16 bytes of T at p, widened to f32
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// rows r0 .. r0 + 63 of the (L, D) matrix x, transposed into xs[d][64]
// as f32; rows at or past L are zeros
template <typename T>
__device__ __forceinline__ void stage_transposed(const T* __restrict__ x,
                                                 int r0, int L, int D,
                                                 float* xs) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = D / kVec;
  for (int idx = threadIdx.x; idx < kBQ * chunks; idx += kThreads) {
    const int r = idx % kBQ;
    const int c = idx / kBQ;
    float v[kVec];
    if (r0 + r < L) {
      load16(x + (long long)(r0 + r) * D + c * kVec, v);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) xs[(c * kVec + e) * kBQ + r] = v[e];
  }
}

// rows r0 .. r0 + 63 of the (L, Dv) matrix x into xs[64][Dv] as f32
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, int r0,
                                           int L, int Dv, float* xs) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = Dv / kVec;
  for (int idx = threadIdx.x; idx < kBK * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = idx % chunks;
    float v[kVec];
    if (r0 + r < L) {
      load16(x + (long long)(r0 + r) * Dv + c * kVec, v);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = 0.f;
    }
    float* dst = xs + r * Dv + c * kVec;
#pragma unroll
    for (int e = 0; e < kVec; e += 4) store4(dst + e, v[e], v[e + 1],
                                             v[e + 2], v[e + 3]);
  }
}

// kChunks: float4 value columns per thread, Dv <= 64 kChunks
template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int H, int S,
                 int T_len, int D, int Dv, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                       // [D][kBQ]
  float* k_s = q_s + D * kBQ;              // [D][kBK]
  float* v_s = k_s + D * kBK;              // [kBK][Dv]
  float* p_s = v_s + kBK * Dv;             // [kBK][kPStride]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;                 // row group: rows 4 ty .. 4 ty + 3
  const int tx = tid & 15;                 // keys tx + 16 j, columns 4 tx + 64 c
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  const T* qb = q + bh * S * D;
  const T* kb = k + bh * T_len * D;
  const T* vb = v + bh * T_len * Dv;

  stage_transposed(qb, q0, S, D, q_s);

  float m[4], l[4], acc[4][kChunks][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  int n_tiles = (T_len + kBK - 1) / kBK;
  if (causal) {
    const int q_last = min(q0 + kBQ, S) - 1;
    n_tiles = min(n_tiles, q_last / kBK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    stage_transposed(kb, k0, T_len, D, k_s);
    stage_rows(vb, k0, T_len, Dv, v_s);
    __syncthreads();

    // scores of rows 4 ty + i against keys k0 + tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(q_s + d * kBQ +
                                                         4 * ty);
      const float* kr = k_s + d * kBK + tx;
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      float ka[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = kr[16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    // mask, online softmax per row (16 lanes share a row group)
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < T_len && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store4(p_s + (tx + 16 * j) * kPStride + 4 * ty, s[0][j], s[1][j],
             s[2][j], s[3][j]);
    __syncthreads();

    // acc = acc * corr + P . V over the tile's keys
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr[i];
    const int kn = min(kBK, T_len - k0);
#pragma unroll 2
    for (int kk = 0; kk < kn; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(
          p_s + kk * kPStride + 4 * ty);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = 4 * tx + 64 * c;
        if (col < Dv) {
          const float4 vv =
              *reinterpret_cast<const float4*>(v_s + kk * Dv + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c][0] = fmaf(pa[i], vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pa[i], vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pa[i], vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pa[i], vv.w, acc[i][c][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  T* ob = out + bh * S * Dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = 4 * tx + 64 * c;
      if (col < Dv)
        store4(ob + (long long)row * Dv + col, acc[i][c][0] / li,
               acc[i][c][1] / li, acc[i][c][2] / li, acc[i][c][3] / li);
    }
  }
}

template <typename T, int kChunks>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int S, int T_len, int D, int Dv, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)2 * D * kBQ + (size_t)kBK * Dv +
                       (size_t)kBK * kPStride);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kChunks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, kChunks><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, S, T_len, D, Dv,
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int H, int S, int T_len, int D, int Dv, float scale, int causal,
             cudaStream_t stream) {
  if (Dv <= 64)
    return launch<T, 1>(q, k, v, out, B, H, S, T_len, D, Dv, scale, causal,
                        stream);
  if (Dv <= 128)
    return launch<T, 2>(q, k, v, out, B, H, S, T_len, D, Dv, scale, causal,
                        stream);
  return launch<T, 4>(q, k, v, out, B, H, S, T_len, D, Dv, scale, causal,
                      stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). B, H, S,
// T >= 1; D, Dv multiples of 8 in [8, 256].
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int S, int T_len, int D,
                        int Dv, float scale, int causal, int dtype,
                        void* stream) {
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, H, S, T_len, D, Dv,
                                   scale, causal, (cudaStream_t)stream);
  return dispatch<float>(q, k, v, out, B, H, S, T_len, D, Dv, scale, causal,
                         (cudaStream_t)stream);
}

}  // extern "C"
