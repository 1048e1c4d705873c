// Hopper (sm_90a) flash-decode over a paged KV cache: one query token per
// sequence, grouped-query attention. Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py:paged_flash_decode (its _kernel).
// Plain C entry point, bound from Python with ctypes
// (repro_torch/kernels/decode_attention.py); it launches two kernels on
// the caller's stream and returns the first cudaGetLastError() that is
// not cudaSuccess.
//
// Contract (decode_attention.py:154-220): q (B, H, D), k_pages
// (N, PS, Hkv, D), v_pages (N, PS, Hkv, Dv), page_table (B, Pmax) int32,
// kv_lens (B,) int32 -> out (B, H, Dv) in q's dtype (f32 or bf16).
// Softmax and accumulation run in f32 with scale D^-0.5. Head h reads KV
// head h / G (G = H / Hkv), so each KV row is read once per KV head, not
// once per query head. Token j of sequence b lives in physical page
// clamp(page_table[b, j / PS], 0, N - 1), slot j % PS: -1 and stale
// entries read page 0 (the null page) and are masked by the length.
// Only tokens j < min(kv_len, Pmax * PS) are read at all, so the walk
// stops at ceil(kv_len / PS) pages; kv_len <= 0 gives exact zeros
// (acc = 0 and the 1e-30 floor on the row sum, decode_attention.py:150).
//
// What bounds it: at serving shapes (B = 8 sequences, a few hundred
// tokens, Hkv = 2, D = 64, bf16) one call reads about a megabyte of K/V,
// well under a microsecond at 3.35 TB/s, so a call is bound by the
// latency of its dependent loads (table -> K rows -> V rows) and by the
// launches, not by bytes. With one block per (sequence, KV head), 16
// blocks walked up to 551 tokens each in serial 128-token tiles on 132
// SMs. Split-K puts many short walks in flight at once:
// - pass 1, paged_decode_split_kernel, grid (B, Hkv, n_split): each
//   block takes a fixed, contiguous run of `pages_per_split` pages and
//   writes f32 partials m (G), l (G) and the unnormalised acc (G, Dv) of
//   its tokens to scratch the wrapper allocates. A split that starts at
//   or past the length writes m = -1e30, l = 0, acc = 0 and reads no K
//   or V. n_split and pages_per_split come from the shapes alone
//   (decode_attention.py split_plan: B, Hkv, Pmax, PS and the SM count),
//   never from kv_lens or the table, which live on the card;
// - pass 2, paged_decode_combine_kernel, grid (B, H): merges the
//   splits in split order, m* = max m_i, out = sum exp(m_i - m*) acc_i /
//   max(sum exp(m_i - m*) l_i, 1e-30), cast to q's dtype. No atomics
//   anywhere, so the output is the same bits on every run. It is
//   launched as a programmatic dependent of pass 1 (griddepcontrol), so
//   its launch overlaps pass 1's tail and its blocks wait for pass 1's
//   writes.
// Inside a split block, many loads stay in flight per thread:
// - the G query rows of the group sit in shared memory as f32 and are
//   broadcast to every thread;
// - the split is walked in tiles of kThreads tokens regardless of the
//   page size (PS = 8 .. 128 alike): thread t owns token j0 + t, looks up
//   its page in the table, reads its K row with 16-byte loads and scores
//   it against all G query rows, keeping G partial sums in registers (no
//   lane layout assumes G divides 32: G = 7 and 6 are common);
// - one warp per query row turns the tile's scores into probabilities
//   with the online-softmax update (running max m, sum l, correction
//   exp(m_prev - m_new)), with tokens past the split re-masked to 0;
// - for P @ V, Dv / 8 neighbouring threads cover one V row with 16-byte
//   loads and the block covers kThreads * 8 / Dv tokens at once; each
//   thread walks its tokens of the tile a few at a time (loads issued
//   before the multiply-adds) and keeps (G, 8) f32 accumulators in
//   registers, so the block holds partial sums over disjoint token sets,
//   which one pass through shared memory adds up at the end, all G rows
//   at once.
// One build covers G <= 8 and D, Dv <= 128, every ported config (G in
// {1, 6, 7, 8}, head_dim 64 or 128); the wrapper refuses more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // threads per block = tokens per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;             // query heads / KV head (wrapper checks)
constexpr int kMaxD = 128;           // D and Dv (wrapper checks)
constexpr int kVec = 8;              // elements per 16-byte bf16 load
constexpr int kUnroll = 4;           // V rows in flight per thread
constexpr int kKChunks = 8;          // 16-byte K loads in flight per thread
constexpr float kNegInf = -1e30f;    // decode_attention.py NEG_INF

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Pass 1: one block per (sequence, KV head, split) walks the split's
// tokens and writes its partial m, l and unnormalised acc (G, Dv) to
// `part` (one record of G (Dv + 2) floats per block: m[G], l[G],
// acc[G][Dv]).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                          const T* __restrict__ vp,
                          const int* __restrict__ tbl,
                          const int* __restrict__ lens,
                          float* __restrict__ part, int H, int Hkv, int D,
                          int Dv, int N, int PS, int Pmax,
                          int pages_per_split, float scale) {
  __shared__ __align__(16) float q_s[kMaxG * kMaxD];
  __shared__ float p_s[kMaxG][kThreads];    // scores, then probabilities
  __shared__ long long row_s[kThreads];    // KV row of each tile token
  __shared__ __align__(16) float red_s[kMaxG][kThreads * kVec];  // partials
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];

  // the combine kernel may be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // P @ V layout: `cpr` threads per V row, `rpar` rows at once
  const int cpr = Dv / kVec;
  const int rpar = kThreads / cpr;
  const int my_row = tid / cpr;
  const int my_col = (tid % cpr) * kVec;
  const bool pv = my_row < rpar;

  const int len = max(min(lens[b], Pmax * PS), 0);
  const int split = blockIdx.z;
  const int j_begin = split * pages_per_split * PS;
  const int j_end = min(len, j_begin + pages_per_split * PS);
  float* rec = part + (((long long)b * Hkv + kvh) * gridDim.z + split) *
                          (long long)(G * (Dv + 2));
  if (j_begin >= j_end) {          // past the length: an empty partial
    for (int i = tid; i < G * (Dv + 2); i += kThreads)
      rec[i] = i < G ? kNegInf : 0.f;
    return;
  }

  const T* qb = q + ((long long)b * H + (long long)kvh * G) * D;
  for (int i = tid; i < G * D / kVec; i += kThreads) {
    float x[kVec];
    load8(qb + i * kVec, x);
#pragma unroll
    for (int e = 0; e < kVec; ++e) q_s[i * kVec + e] = x[e];
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int* tb = tbl + (long long)b * Pmax;

  float acc[kMaxG][kVec];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  __syncthreads();

  for (int j0 = j_begin; j0 < j_end; j0 += kThreads) {
    const int ntok = min(kThreads, j_end - j0);

    // 1. scores of token j0 + tid against the G query rows
    if (tid < ntok) {
      const int j = j0 + tid;
      const int page = min(max(tb[j / PS], 0), N - 1);
      const long long row = ((long long)page * PS + j % PS) * Hkv + kvh;
      row_s[tid] = row;
      const T* kr = kp + row * D;
      float s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
      // kKChunks 16-byte loads of the row in flight before their
      // multiply-adds (all of a 64-wide bf16 row)
      for (int d0 = 0; d0 < D; d0 += kKChunks * kVec) {
        float kv[kKChunks][kVec];
#pragma unroll
        for (int u = 0; u < kKChunks; ++u)
          if (d0 + u * kVec < D) load8(kr + d0 + u * kVec, kv[u]);
#pragma unroll
        for (int u = 0; u < kKChunks; ++u) {
          const int d = d0 + u * kVec;
          if (d >= D) break;
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              const float4* q4 =
                  reinterpret_cast<const float4*>(q_s + g * D + d);
              const float4 a = q4[0], c = q4[1];
              s[g] = fmaf(a.x, kv[u][0], s[g]);
              s[g] = fmaf(a.y, kv[u][1], s[g]);
              s[g] = fmaf(a.z, kv[u][2], s[g]);
              s[g] = fmaf(a.w, kv[u][3], s[g]);
              s[g] = fmaf(c.x, kv[u][4], s[g]);
              s[g] = fmaf(c.y, kv[u][5], s[g]);
              s[g] = fmaf(c.z, kv[u][6], s[g]);
              s[g] = fmaf(c.w, kv[u][7], s[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) p_s[g][tid] = s[g] * scale;
    }
    __syncthreads();

    // 2. online softmax, one warp per query row; tokens past the tile's
    //    valid count are re-masked to probability 0
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < ntok; t += 32) mx = fmaxf(mx, p_s[g][t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < kThreads; t += 32) {
        const float p = t < ntok ? expf(p_s[g][t] - m_new) : 0.f;
        p_s[g][t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + P @ V over this thread's tokens of the tile
    if (pv) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float c = corr_s[g];
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[g][e] *= c;
        }
      }
      for (int t0 = my_row; t0 < ntok; t0 += kUnroll * rpar) {
        float v[kUnroll][kVec];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = t0 + u * rpar;
          if (t < ntok) {
            load8(vp + row_s[t] * Dv + my_col, v[u]);
          } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) v[u][e] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = min(t0 + u * rpar, kThreads - 1);  // p = 0 past ntok
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              const float p = p_s[g][t];
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                acc[g][e] = fmaf(p, v[u][e], acc[g][e]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // 4. add up the rpar partial sums of each query row; write m, l and
  //    the unnormalised rows
  if (tid < G) {
    rec[tid] = m_s[tid];
    rec[G + tid] = l_s[tid];
  }
  if (pv) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float4* dst =
            reinterpret_cast<float4*>(&red_s[g][my_row * Dv + my_col]);
        dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      }
    }
  }
  __syncthreads();
  float* acc_out = rec + 2 * G;
  for (int i = tid; i < G * Dv; i += kThreads) {
    const int g = i / Dv;
    const int c = i - g * Dv;
    float sum = 0.f;
#pragma unroll 8
    for (int r = 0; r < rpar; ++r) sum += red_s[g][r * Dv + c];
    acc_out[i] = sum;
  }
}

// Pass 2: one block per (sequence, query head), one thread per output
// column, merges the n_split records in split order: m* = max m_i,
// out = sum exp(m_i - m*) acc_i / max(sum exp(m_i - m*) l_i, 1e-30), in
// q's dtype. No atomics, so the result is the same bits on every run;
// kv_len = 0 gives exact zeros (every acc_i and l_i is 0).
template <typename T>
__global__ void __launch_bounds__(kMaxD)
paged_decode_combine_kernel(const float* __restrict__ part,
                            T* __restrict__ out, int H, int Hkv, int Dv,
                            int n_split) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = H / Hkv;
  const int kvh = h / G;
  const int g = h - kvh * G;
  // launched early (programmatic dependent launch): wait until the split
  // kernel has finished and its partials are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int c = threadIdx.x;
  if (c >= Dv) return;
  const long long rec_len = (long long)G * (Dv + 2);
  const float* rec0 = part + ((long long)b * Hkv + kvh) * n_split * rec_len;
  float m_star = kNegInf;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s)
    m_star = fmaxf(m_star, rec0[s * rec_len + g]);
  float l = 0.f, acc = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const float* rec = rec0 + s * rec_len;
    const float w = expf(rec[g] - m_star);
    l = fmaf(w, rec[G + g], l);
    acc = fmaf(w, rec[2 * G + g * Dv + c], acc);
  }
  store(out + ((long long)b * H + h) * Dv + c, acc / fmaxf(l, 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* page_table, const int* kv_lens, float* part, void* out,
           int B, int H, int Hkv, int D, int Dv, int N, int PS, int Pmax,
           int n_split, int pages_per_split, float scale,
           cudaStream_t stream) {
  paged_decode_split_kernel<T><<<dim3(B, Hkv, n_split), kThreads, 0,
                                 stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), page_table, kv_lens, part, H, Hkv, D,
      Dv, N, PS, Pmax, pages_per_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // programmatic dependent launch: the combine's launch overlaps the
  // split kernel's tail instead of following its end
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, H);
  cfg.blockDim = dim3(kMaxD);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_decode_combine_kernel<T>,
                           static_cast<const float*>(part),
                           static_cast<T*>(out), H, Hkv, Dv, n_split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it). part:
// f32 scratch of B * Hkv * n_split * G * (Dv + 2) floats, with
// n_split * pages_per_split >= Pmax.
int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                 const int* page_table, const int* kv_lens, void* part,
                 void* out, int B, int H, int Hkv, int D, int Dv, int N,
                 int PS, int Pmax, int n_split, int pages_per_split,
                 float scale, int dtype, cudaStream_t stream) {
  float* p = static_cast<float*>(part);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, kv_lens, p,
                                 out, B, H, Hkv, D, Dv, N, PS, Pmax, n_split,
                                 pages_per_split, scale, stream);
  return launch<float>(q, k_pages, v_pages, page_table, kv_lens, p, out, B,
                       H, Hkv, D, Dv, N, PS, Pmax, n_split, pages_per_split,
                       scale, stream);
}

}  // extern "C"
