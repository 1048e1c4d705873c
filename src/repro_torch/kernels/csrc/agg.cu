// Hopper (sm_90a) kernels for the three GradAgg reductions over the
// device-resident (n, P) f32 gradient ledger. Plain C entry points, bound
// from Python with ctypes (repro_torch/kernels/agg.py); each launches one
// kernel on the caller's stream and returns cudaGetLastError().
//
// All three are memory-bound reductions over a small agent axis (n = 20
// on the paper's LeNet path, P = 431,080). Their bound on an H100 is the
// bytes of the rows that can contribute, read once, over the memory rate:
// 17 received rows of 431,080 f32 are 29.3 MB, ~9 us at 3.35 TB/s. The
// design answers it simply:
// - one thread per coordinate column reads down the agent rows, so a
//   warp's loads of one row are 32 neighbouring words (coalesced);
// - each block first compacts the rows that can contribute (received,
//   or kept by the filter) into shared memory, so no other row is read;
// - each thread issues the loads of several rows before it adds any of
//   them, so a column's rows are in flight together rather than one
//   memory latency after another;
// - every sum runs in a fixed order (agent order per column, fixed trees
//   for the norms): results are identical from run to run, no atomics.
// Vector loads, cp.async/TMA and several columns per thread are left for
// later work.
//
// P tiles ride gridDim.x (up to 2^31 - 1 blocks); gridDim.y/z stop at
// 65,535, which a large ledger would exceed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // threads per block, every kernel
constexpr int kNormCols = 4;         // columns per thread in the norm pass
constexpr int kNormTile = kThreads * kNormCols;   // columns per norm block
constexpr int kRowBatch = 8;         // rows whose loads are issued together
constexpr float kBig = 1e30f;        // received-masking sentinel (agg.py BIG)
constexpr int kTrimMaxN = 32;        // agents a trimmed-mean column holds

// rows[0..m) = the indices i < n with sel[i] != 0, ascending; returns m.
// Warp 0 compacts 32 entries per ballot; the whole block must call it.
template <typename T>
__device__ int compact_rows(const T* __restrict__ sel, int n, int* rows) {
  __shared__ int s_m;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int m = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const bool take = i < n && sel[i] != T(0);
      const unsigned b = __ballot_sync(0xffffffffu, take);
      if (take) rows[m + __popc(b & ((1u << lane) - 1u))] = i;
      m += __popc(b);
    }
    if (lane == 0) s_m = m;
  }
  __syncthreads();
  return s_m;
}

// ---------------------------------------------------------------------------
// masked_cge_reduce — replaces src/repro/kernels/agg.py:masked_cge_reduce.
//
// The TPU kernel carries per-agent squared norms from phase 0 to phase 1
// in a VMEM block revisited across a sequential grid. Hopper blocks run
// in no order, so the phases become three launches:
//   1. cge_partial_norms: block b writes partial[i, b], the sum of
//      g[i, c]^2 over its kNormTile columns, for every received row i
//      (8 rows at a time; warp shuffle trees, then warp totals in order).
//   2. cge_keep: one block; warp w sums row w's partials (lane-strided,
//      then a shuffle tree), takes sqrtf, keys non-received rows to +inf,
//      ranks rank(i) = #{j : key_j < key_i or (key_j == key_i and j < i)}
//      (agg.py:97-104) and writes keep[i] in {0, 1}.
//   3. masked_col_sum with keep as selector and weights: the kept rows
//      summed per column in agent order.
// Ranking uses the sqrt norm, not the squared norm: the oracle keys on
// the f32 norm, and two distinct squared norms can round to one norm.

__global__ void cge_partial_norms_kernel(const float* __restrict__ g,
                                         const uint8_t* __restrict__ rx,
                                         int n, long long p, int nblk,
                                         float* __restrict__ partial) {
  extern __shared__ int rows[];                 // (n,)
  __shared__ float warp_tot[kRowBatch][kThreads / 32];
  const int m = compact_rows(rx, n, rows);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long c0 = (long long)blockIdx.x * kNormTile + threadIdx.x;
  for (int j0 = 0; j0 < m; j0 += kRowBatch) {
    float acc[kRowBatch];
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) acc[u] = 0.f;
#pragma unroll
    for (int k = 0; k < kNormCols; ++k) {
      const long long c = c0 + (long long)k * kThreads;
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) {
        const bool live = j0 + u < m && c < p;
        const float v = live ? g[(long long)rows[j0 + u] * p + c] : 0.f;
        acc[u] = fmaf(v, v, acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
      float a = acc[u];
      for (int off = 16; off > 0; off >>= 1)
        a += __shfl_down_sync(0xffffffffu, a, off);
      if (lane == 0) warp_tot[u][warp] = a;
    }
    __syncthreads();
    if ((int)threadIdx.x < kRowBatch && j0 + (int)threadIdx.x < m) {
      float tot = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) tot += warp_tot[threadIdx.x][w];
      partial[(long long)rows[j0 + threadIdx.x] * nblk + blockIdx.x] = tot;
    }
    __syncthreads();                            // warp_tot reused next batch
  }
}

__global__ void cge_keep_kernel(const float* __restrict__ partial,
                                const uint8_t* __restrict__ rx, int n,
                                int nblk, int f, float* __restrict__ keep) {
  extern __shared__ float key[];                // (n,)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  for (int i = warp; i < n; i += nwarp) {
    float acc = 0.f;
    if (rx[i])
      for (int b = lane; b < nblk; b += 32)
        acc += partial[(long long)i * nblk + b];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) key[i] = rx[i] ? sqrtf(acc) : INFINITY;
  }
  __syncthreads();
  int m = 0;
  for (int j = 0; j < n; ++j) m += rx[j] ? 1 : 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float ki = key[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const float kj = key[j];
      rank += (kj < ki || (kj == ki && j < i)) ? 1 : 0;
    }
    keep[i] = (rx[i] && rank < m - f) ? 1.f : 0.f;
  }
}

// ---------------------------------------------------------------------------
// out[c] = sum over rows i with sel[i] != 0 of float(g[i, c]) * w[i], in
// agent order; rows not selected are never read.
// - T = float, sel = w = the CGE keep vector: the CGE masked sum.
// - T = int8_t, sel = received, w = scale: dequant_accum, which replaces
//   src/repro/kernels/agg.py:dequant_accum. The int8 stack is read once
//   and never widened in memory. The TPU wrapper folds scale * received
//   into one weight vector before its kernel (agg.py:260-261); here the
//   fold is the row selection itself, so the call is one launch.

template <typename T, typename S>
__global__ void masked_col_sum_kernel(const T* __restrict__ g,
                                      const S* __restrict__ sel,
                                      const float* __restrict__ w, int n,
                                      long long p, float* __restrict__ out) {
  extern __shared__ int rows[];                 // (n,)
  const int m = compact_rows(sel, n, rows);
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= p) return;
  float acc = 0.f;
  int j = 0;
  for (; j + kRowBatch <= m; j += kRowBatch) {
    float v[kRowBatch];
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u)
      v[u] = (float)g[(long long)rows[j + u] * p + c];
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) acc += v[u] * w[rows[j + u]];
  }
  for (; j < m; ++j) acc += (float)g[(long long)rows[j] * p + c] * w[rows[j]];
  out[c] = acc;
}

// ---------------------------------------------------------------------------
// trimmed_mean — replaces src/repro/kernels/agg.py:trimmed_mean_tiled.
//
// One thread per column keeps the column's values in registers, for
// n <= kTrimMaxN = 32 agents: every loop runs to the compile-time
// kTrimMaxN, unrolled, so the array stays in registers and the received rows' loads
// (one predicate each, from a 32-bit mask) are all in flight together.
// Two bit masks stand for the oracle's two sentinel-masked copies (lo:
// +1e30 where not received or already removed, hi: -1e30). f rounds each
// take the min over lo's candidates and the max over hi's and remove one
// occurrence, the first by agent id (agg.py:143-150), which matches sort
// semantics under duplicates. The output is (ssum - cut) / max(m - 2f, 1),
// or 0 where m - 2f <= 0 (where the rounds run out of candidates and add
// the sentinels, as the oracle does).

__global__ void trimmed_mean_kernel(const float* __restrict__ g,
                                    const uint8_t* __restrict__ rx, int n,
                                    long long p, int f,
                                    float* __restrict__ out) {
  __shared__ unsigned s_mask;
  if (threadIdx.x < 32) {
    const bool r = (int)threadIdx.x < n && rx[threadIdx.x];
    const unsigned b = __ballot_sync(0xffffffffu, r);
    if (threadIdx.x == 0) s_mask = b;
  }
  __syncthreads();
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= p) return;
  const unsigned mask = s_mask;
  float v[kTrimMaxN];
#pragma unroll
  for (int i = 0; i < kTrimMaxN; ++i)
    v[i] = ((mask >> i) & 1u) ? g[(long long)i * p + c] : 0.f;
  float ssum = 0.f;
#pragma unroll
  for (int i = 0; i < kTrimMaxN; ++i) ssum += v[i];
  unsigned lo = mask, hi = mask;                // candidates left per side
  float cut = 0.f;
  for (int k = 0; k < f; ++k) {
    float mn = kBig, mx = -kBig;
    int imn = -1, imx = -1;
#pragma unroll
    for (int i = 0; i < kTrimMaxN; ++i) {
      if (((lo >> i) & 1u) && v[i] < mn) { mn = v[i]; imn = i; }
      if (((hi >> i) & 1u) && v[i] > mx) { mx = v[i]; imx = i; }
    }
    cut += mn + mx;
    if (imn >= 0) lo &= ~(1u << imn);
    if (imx >= 0) hi &= ~(1u << imx);
  }
  const int cnt = __popc(mask) - 2 * f;
  const float num = cnt > 0 ? ssum - cut : 0.f;
  out[c] = num / (float)(cnt > 1 ? cnt : 1);
}

inline unsigned int col_blocks(long long p) {
  return (unsigned int)((p + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int agg_norm_tile() { return kNormTile; }

int agg_cge_partial_norms(const float* g, const uint8_t* rx, int n,
                          long long p, int nblk, float* partial,
                          void* stream) {
  cge_partial_norms_kernel<<<nblk, kThreads, n * sizeof(int),
                             (cudaStream_t)stream>>>(g, rx, n, p, nblk,
                                                     partial);
  return (int)cudaGetLastError();
}

int agg_cge_keep(const float* partial, const uint8_t* rx, int n, int nblk,
                 int f, float* keep, void* stream) {
  const int warps = n < 32 ? n : 32;
  cge_keep_kernel<<<1, 32 * warps, n * sizeof(float),
                    (cudaStream_t)stream>>>(partial, rx, n, nblk, f, keep);
  return (int)cudaGetLastError();
}

int agg_cge_masked_sum(const float* g, const float* keep, int n, long long p,
                       float* out, void* stream) {
  masked_col_sum_kernel<<<col_blocks(p), kThreads, n * sizeof(int),
                          (cudaStream_t)stream>>>(g, keep, keep, n, p, out);
  return (int)cudaGetLastError();
}

int agg_dequant_accum(const int8_t* q, const float* scale, const uint8_t* rx,
                      int n, long long p, float* out, void* stream) {
  masked_col_sum_kernel<<<col_blocks(p), kThreads, n * sizeof(int),
                          (cudaStream_t)stream>>>(q, rx, scale, n, p, out);
  return (int)cudaGetLastError();
}

int agg_trimmed_mean(const float* g, const uint8_t* rx, int n, long long p,
                     int f, float* out, void* stream) {
  trimmed_mean_kernel<<<col_blocks(p), kThreads, 0,
                        (cudaStream_t)stream>>>(g, rx, n, p, f, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
