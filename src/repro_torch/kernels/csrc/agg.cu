// Hopper (sm_90a) kernels for the three GradAgg reductions over the
// device-resident (n, P) gradient ledger. Plain C entry points, bound
// from Python with ctypes (repro_torch/kernels/agg.py); each launches one
// kernel on the caller's stream and returns the launch's cudaError_t.
//
// All three are memory-bound reductions over a small agent axis (n = 20
// on the paper's LeNet path, P = 431,080). Their bound on an H100 is the
// bytes of the rows that can contribute, read once, plus the (P,) output
// written once, over the memory rate: 17 received rows of 431,080 f32 and
// the output are 31.0 MB, 9.27 us at 3.35 TB/s.
//
// masked_cge_reduce and trimmed_mean read the received rows of a column
// range into shared memory once (stage_rows: one bulk asynchronous copy
// per row segment, completion on an mbarrier) and compute per column from
// there. One thread asks for a whole segment, so the bytes in flight do
// not depend on registers or on how many loads a thread issues. The plan
// (grid, column shares, chunks, what is held on chip) is computed in
// Python (agg.py: cge_plan, trimmed_plan) and handed to the kernels.
//
// Every sum runs in a fixed order (agent order per column; per row, fixed
// lanes and a fixed shuffle tree): results are bit-identical run to run,
// and no sum uses atomics.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;        // threads per block of dequant_accum
constexpr int kRowBatch = 8;         // rows whose loads are issued together
constexpr float kBig = 1e30f;        // received-masking sentinel (agg.py BIG)
constexpr int kTrimMaxN = 32;        // agents a trimmed-mean column holds
constexpr int kCgeThreads = 1024;    // one block per SM, 32 warps
constexpr int kTrimThreads = 512;
constexpr int kTrimCols = 4;         // columns a trimmed-mean thread sums at once
constexpr int kHeader = 64;          // agg.py SMEM_HEADER: mbarriers, counters
constexpr int kMaxChunks = 4;        // agg.py CGE_CHUNKS: held chunks (mbarriers)
constexpr int kMaxStages = 3;        // agg.py TRIM_STAGES: the ring's stages

// rows[0..m) = the indices i < n with sel[i] != 0, ascending; returns m
// (also left in *s_m, a shared int). Warp 0 compacts 32 entries per
// ballot; the whole block must call it.
template <typename T>
__device__ int compact_rows(const T* __restrict__ sel, int n, int* rows,
                            int* s_m) {
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
    if (lane == 0) *s_m = m;
  }
  __syncthreads();
  return *s_m;
}

// ---------------------------------------------------------------------------
// Bulk asynchronous copies into shared memory, completed on an mbarrier.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also expects ``bytes`` more of asynchronous copies
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// one plain arrival (a release: the caller's earlier stores are visible to
// the threads that see the phase complete)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity ``parity`` of *bar has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// shared memory last read by threads, next written by bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Word offset of element (row, c) of g within its 16-byte line. Row r
// starts at byte 4 r P and g itself at any 4-byte offset, so rows are
// misaligned whenever P % 4 != 0 or g is a view. agg.py: row_shift.
__device__ __forceinline__ int row_shift(const float* g, long long p,
                                         int row, long long c) {
  return (int)(((reinterpret_cast<uintptr_t>(g) >> 2) +
                (unsigned long long)row * (unsigned long long)p +
                (unsigned long long)c) & 3ull);
}

// Columns of a row segment of ``width`` columns whose first column has
// word offset ``shift``: ``head`` go by plain loads up to the first
// 16-byte line, ``bulk`` (a multiple of 4) by one bulk copy, the rest
// (at most 3) by plain loads. agg.py: row_segments.
__device__ __forceinline__ int seg_head(int shift, int width) {
  return min((4 - shift) & 3, width);
}

// Stage columns [c_lo, c_lo + width) of rows rows[0..m) of g into shared
// memory: column c_lo + x of compacted row j lands at dst[off[j] + x],
// where off[j] = j * stride + (word offset of (rows[j], c_lo)), stride a
// multiple of 4 and dst 16-byte aligned, so a row's global and shared
// addresses agree modulo 16 and its aligned interior goes in one bulk
// copy. c_lo is a multiple of 4 (the plan's shares and chunks are), so
// the offset is the same for every chunk of a row.
//
// Called by one warp; lane l stages rows l, l + 32, ... ``bar`` counts
// 64 arrivals: each lane arrives once expecting the bytes of its bulk
// copies, issues them, then loads its rows' heads and tails (at most 6
// words a row, none on aligned rows) and stores them with plain
// instructions, and arrives again (a release). The phase completes when
// every byte, bulk or plain, is in shared memory and visible to the
// threads that wait on ``bar``. Issuing a bulk copy can stall while the
// copy engine's queue is full, so the threads that compute never issue.
__device__ void stage_rows(float* dst, const int* off,
                           const float* __restrict__ g, long long p,
                           const int* rows, int m, long long c_lo, int width,
                           uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  uint32_t bytes = 0;
  for (int j = lane; j < m; j += 32) {
    const int head = seg_head(row_shift(g, p, rows[j], c_lo), width);
    bytes += (uint32_t)((width - head) & ~3) * 4u;
  }
  mbar_arrive_tx(bar, bytes);
  for (int j = lane; j < m; j += 32) {
    const int head = seg_head(row_shift(g, p, rows[j], c_lo), width);
    const int bulk = (width - head) & ~3;
    if (bulk > 0)
      bulk_g2s(dst + off[j] + head, g + (long long)rows[j] * p + c_lo + head,
               (uint32_t)bulk * 4u, bar);
  }
  for (int j = lane; j < m; j += 32) {
    const float* src = g + (long long)rows[j] * p + c_lo;
    float* d = dst + off[j];
    const int head = seg_head(row_shift(g, p, rows[j], c_lo), width);
    const int tail = (width - head) & 3;
    for (int u = 0; u < head; ++u) d[u] = src[u];
    for (int u = width - tail; u < width; ++u) d[u] = src[u];
  }
  mbar_arrive(bar);
}

__device__ __forceinline__ float warp_sum(float a) {
  for (int o = 16; o > 0; o >>= 1) a += __shfl_down_sync(0xffffffffu, a, o);
  return a;                                     // lane 0 holds the sum
}

// ---------------------------------------------------------------------------
// masked_cge_reduce — replaces src/repro/kernels/agg.py:masked_cge_reduce.
//
// The TPU kernel carries per-agent squared norms from its phase 0 to its
// phase 1 through a VMEM block revisited across a sequential grid, and
// streams the stack twice. Hopper has no sequential grid; here one
// persistent, cooperatively launched block per SM (every block resident)
// reads its share of the received rows from device memory once:
//   A. Warp 0 stages the received rows of the block's columns
//      [c0, c0 + sb) into shared memory: the first ``hb`` columns (the
//      plan's held[m], the most columns whose m rows of hb + 4 words fit
//      in ``budget`` bytes) in up to kMaxChunks chunks, each on its own
//      mbarrier, so the norms of a chunk are summed while later chunks
//      are in flight. Warps 1..31 sum the squares of rows w - 1,
//      w + 30, ...: lane l the columns l, l + 32, ... of each chunk in
//      order, then the columns past hb from device memory (a share that
//      does not fit), then a fixed shuffle tree. Every row sums the same
//      columns in the same order, so rows that are sign flips of one
//      another keep bit-identical norms. Lane 0 writes partial[j, b].
//   B. A grid-wide barrier (cooperative groups; every block is resident
//      because the launch is cooperative).
//   C. Every block sums the m x G partials of each row in the same fixed
//      order (8 loads a lane in flight) and takes sqrtf; rows not
//      received keep the key +inf. Warp 0 ranks rank(i) = #{j : key_j <
//      key_i or (key_j == key_i and j < i)} (agg.py:97-104) and lists
//      the kept rows in agent order: every block derives the identical
//      keep-set, and no single block serialises the card.
//   D. The block sums its kept rows per column in agent order from shared
//      memory (16-byte loads where every kept row is aligned), then the
//      columns it could not hold from device memory, the last read first
//      (they are the likeliest still in L2), and writes its share of out.
// At the paper's shape (m = 17, P = 431,080, 132 SMs) a share is 3,268
// columns and every received row is held: 222,496 B of 232,448.
// Ranking uses the sqrt norm, not the squared norm: the oracle keys on
// the f32 norm, and two distinct squared norms can round to one norm.
// m - f <= 0 (every agent crashed, or too few received) writes zeros
// and reads nothing; every block decides it alike, before the barrier.

__global__ void __launch_bounds__(kCgeThreads, 1)
masked_cge_kernel(const float* __restrict__ g, const uint8_t* __restrict__ rx,
                  int n, long long p, int f, int share, int chunk,
                  int budget, float* partial, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);         // kMaxChunks
  int* s_m = reinterpret_cast<int*>(smem + 8 * kMaxChunks);
  int* s_k = s_m + 1;                           // kept rows
  int* s_al = s_m + 2;                          // every kept row aligned
  int* rows = reinterpret_cast<int*>(smem + kHeader);        // (n,) each
  int* off = rows + n;
  int* koff = off + n;                          // kept rows' offsets, rows
  int* krow = koff + n;
  float* key = reinterpret_cast<float*>(krow + n);
  float* data = reinterpret_cast<float*>(
      smem + ((kHeader + 20 * n + 15) & ~15));               // agg.py

  const int m = compact_rows(rx, n, rows, s_m);
  const long long c0 = (long long)blockIdx.x * share;
  const int sb = (int)min((long long)share, p - c0);
  const int kept_max = m - f;
  if (kept_max <= 0) {
    for (int x = threadIdx.x; x < sb; x += blockDim.x) out[c0 + x] = 0.f;
    return;
  }
  const int hb = min(max(0, (budget / (4 * m) - 4) & ~3), sb);
  const int stride = hb + 4;
  const int nk = (hb + chunk - 1) / chunk;
  for (int j = threadIdx.x; j < m; j += blockDim.x)
    off[j] = j * stride + row_shift(g, p, rows[j], c0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) key[i] = INFINITY;
  if (threadIdx.x == 0) {
    for (int k = 0; k < nk; ++k) mbar_init(&bar[k], 64);
    mbar_init_fence();
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int G = gridDim.x;
  if (warp == 0) {
    for (int k = 0; k < nk; ++k)
      stage_rows(data + k * chunk, off, g, p, rows, m,
                 c0 + (long long)k * chunk, min(chunk, hb - k * chunk),
                 &bar[k]);
  }

  // A. per-row partial squared norms of this share
  for (int j = warp - 1; warp > 0 && j < m; j += kCgeThreads / 32 - 1) {
    float acc = 0.f;
    const float* row = data + off[j];
    for (int k = 0; k < nk; ++k) {
      mbar_wait(&bar[k], 0);
      const int hi = min((k + 1) * chunk, hb);
#pragma unroll 8
      for (int x = k * chunk + lane; x < hi; x += 32)
        acc = fmaf(row[x], row[x], acc);
    }
    const float* gr = g + (long long)rows[j] * p + c0;
#pragma unroll 4
    for (int x = hb + lane; x < sb; x += 32) {
      const float v = gr[x];
      acc = fmaf(v, v, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) partial[(long long)j * G + blockIdx.x] = acc;
  }

  // B. every block's partials written
  cg::this_grid().sync();

  // C. the keep-set, identical in every block
  for (int j = warp; j < m; j += kCgeThreads / 32) {
    const float* pj = partial + (long long)j * G;
    float acc = 0.f;
    for (int b0 = lane; b0 < G; b0 += 8 * 32) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = b0 + 32 * u < G ? __ldcg(pj + b0 + 32 * u) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += v[u];
    }
    acc = warp_sum(acc);
    if (lane == 0) key[rows[j]] = sqrtf(acc);
  }
  __syncthreads();
  if (warp == 0) {
    int nkeep = 0;
    bool aligned = true;
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      bool keep = false;
      if (j < m) {
        const int i = rows[j];
        const float ki = key[i];
        int rank = 0;
#pragma unroll 8
        for (int t = 0; t < n; ++t) {
          const float kt = key[t];
          rank += (kt < ki || (kt == ki && t < i)) ? 1 : 0;
        }
        keep = rank < kept_max;
      }
      const unsigned b = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int q = nkeep + __popc(b & ((1u << lane) - 1u));
        koff[q] = off[j];
        krow[q] = rows[j];
      }
      aligned = __all_sync(0xffffffffu, aligned && (!keep || !(off[j] & 3)));
      nkeep += __popc(b);
    }
    if (lane == 0) {
      *s_k = nkeep;
      *s_al = aligned;
    }
  }
  for (int k = 0; k < nk; ++k) mbar_wait(&bar[k], 0);  // every chunk landed
  __syncthreads();
  const int nkeep = *s_k;

  // D. the kept rows summed per column, in agent order
  if (*s_al) {
    for (int x = 4 * threadIdx.x; x < hb; x += 4 * kCgeThreads) {
      if (x + 4 <= hb) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int q = 0; q < nkeep; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(data + koff[q] + x);
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
        *reinterpret_cast<float4*>(out + c0 + x) = acc;
      } else {
        for (int u = x; u < hb; ++u) {
          float acc = 0.f;
          for (int q = 0; q < nkeep; ++q) acc += data[koff[q] + u];
          out[c0 + u] = acc;
        }
      }
    }
  } else {
    for (int x0 = threadIdx.x; x0 < hb; x0 += 4 * kCgeThreads) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int q = 0; q < nkeep; ++q) {
        const float* row = data + koff[q];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (x0 + u * kCgeThreads < hb) acc[u] += row[x0 + u * kCgeThreads];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (x0 + u * kCgeThreads < hb) out[c0 + x0 + u * kCgeThreads] = acc[u];
    }
  }
  const int nre = sb - hb;                      // columns not held
  for (int t0 = nre - 1 - (nre - 1) % kCgeThreads; nre > 0 && t0 >= 0;
       t0 -= kCgeThreads) {
    const int x = hb + t0 + threadIdx.x;
    if (x >= sb) continue;
    float acc = 0.f;
#pragma unroll 4
    for (int q = 0; q < nkeep; ++q) acc += g[(long long)krow[q] * p + c0 + x];
    out[c0 + x] = acc;
  }
}

// ---------------------------------------------------------------------------
// out[c] = sum over rows i with sel[i] != 0 of float(g[i, c]) * w[i], in
// agent order; rows not selected are never read. With T = int8_t, sel =
// received and w = scale it is dequant_accum, which replaces
// src/repro/kernels/agg.py:dequant_accum. The int8 stack is read once and
// never widened in memory. The TPU wrapper folds scale * received into
// one weight vector before its kernel (agg.py:260-261); here the fold is
// the row selection itself, so the call is one launch. One thread per
// column reads down the selected rows (a warp's loads of one row are 32
// neighbouring bytes), issuing the loads of kRowBatch rows before adding
// any of them.

template <typename T, typename S>
__global__ void masked_col_sum_kernel(const T* __restrict__ g,
                                      const S* __restrict__ sel,
                                      const float* __restrict__ w, int n,
                                      long long p, float* __restrict__ out) {
  extern __shared__ int rows[];                 // (n,)
  __shared__ int s_m;
  const int m = compact_rows(sel, n, rows, &s_m);
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
// A persistent grid (at most one block per SM) walks column chunks: block
// b takes its share [c0, c0 + sb) in chunks of ``chunk`` columns through
// a ring of ``stages`` buffers of n rows. Warp 0 is the producer: it
// stages chunk c into buffer c % stages (stage_rows, completing full[s])
// once the consumers have released that buffer (empty[s]), so while the
// consumers compute one chunk the next one or two are in flight, and no
// consumer waits while a copy is issued. The other warps are consumers:
// a thread reads only the m received rows (compacted, in agent order) of
// its columns from shared memory and sums them in agent order. Two paths:
// - f <= 1, the paper's: one pass, kTrimCols columns a thread. With every
//   received row a candidate, the oracle's one round of extraction
//   (agg.py:134-151) takes the plain min and max, and removes nothing
//   that a later round would see.
// - f >= 2: a kTrimMaxN-entry register array per column (every loop
//   unrolled to the compile-time kTrimMaxN). Two bit masks stand for the
//   oracle's two sentinel-masked copies (lo: +1e30 where not received or
//   already removed, hi: -1e30). f rounds each take the min over lo's
//   candidates and the max over hi's and remove one occurrence, the
//   first by agent id, which matches sort semantics under duplicates.
// The output is (ssum - cut) / (m - 2f), or 0 where m - 2f <= 0: every
// block decides that alike and reads nothing. The rounds never run out
// of candidates where m - 2f > 0; where they would, they add the 1e30
// sentinels as the oracle does, and the output is 0 anyway.

constexpr int kTrimConsumers = kTrimThreads - 32;

// columns [0, w) of a staged chunk, by consumer thread ``t``
__device__ void trimmed_columns(const float* st, const int* off, int m,
                                int f, int cnt, int w, int t, float* out) {
  if (f <= 1) {
    for (int x0 = t; x0 < w; x0 += kTrimCols * kTrimConsumers) {
      float ssum[kTrimCols], mn[kTrimCols], mx[kTrimCols];
#pragma unroll
      for (int u = 0; u < kTrimCols; ++u) {
        ssum[u] = 0.f;
        mn[u] = kBig;
        mx[u] = -kBig;
      }
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const float* row = st + off[j];
#pragma unroll
        for (int u = 0; u < kTrimCols; ++u) {
          if (x0 + u * kTrimConsumers < w) {
            const float v = row[x0 + u * kTrimConsumers];
            ssum[u] += v;
            mn[u] = fminf(mn[u], v);
            mx[u] = fmaxf(mx[u], v);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kTrimCols; ++u)
        if (x0 + u * kTrimConsumers < w)
          out[x0 + u * kTrimConsumers] =
              (ssum[u] - (f ? mn[u] + mx[u] : 0.f)) / (float)cnt;
    }
    return;
  }
  for (int x = t; x < w; x += kTrimConsumers) {
    float v[kTrimMaxN];
#pragma unroll
    for (int j = 0; j < kTrimMaxN; ++j) v[j] = j < m ? st[off[j] + x] : 0.f;
    float ssum = 0.f;
#pragma unroll
    for (int j = 0; j < kTrimMaxN; ++j) ssum += v[j];
    const unsigned all = m >= 32 ? 0xffffffffu : (1u << m) - 1u;
    unsigned lo = all, hi = all;                // candidates left per side
    float cut = 0.f;
    for (int k = 0; k < f; ++k) {
      float mn = kBig, mx = -kBig;
      int imn = -1, imx = -1;
#pragma unroll
      for (int j = 0; j < kTrimMaxN; ++j) {
        if (((lo >> j) & 1u) && v[j] < mn) { mn = v[j]; imn = j; }
        if (((hi >> j) & 1u) && v[j] > mx) { mx = v[j]; imx = j; }
      }
      cut += mn + mx;
      if (imn >= 0) lo &= ~(1u << imn);
      if (imx >= 0) hi &= ~(1u << imx);
    }
    out[x] = (ssum - cut) / (float)cnt;
  }
}

__global__ void __launch_bounds__(kTrimThreads, 1)
trimmed_mean_kernel(const float* __restrict__ g,
                    const uint8_t* __restrict__ rx, int n, long long p,
                    int f, int share, int chunk, int stages,
                    float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);        // kMaxStages
  uint64_t* empty = full + kMaxStages;                       // kMaxStages
  int* s_m = reinterpret_cast<int*>(empty + kMaxStages);
  int* rows = reinterpret_cast<int*>(smem + kHeader);        // kTrimMaxN
  int* off = rows + kTrimMaxN;
  float* ring = reinterpret_cast<float*>(smem + kHeader + 8 * kTrimMaxN);

  const int m = compact_rows(rx, n, rows, s_m);
  const long long c0 = (long long)blockIdx.x * share;
  const int sb = (int)min((long long)share, p - c0);
  const int cnt = m - 2 * f;
  if (cnt <= 0) {
    for (int x = threadIdx.x; x < sb; x += blockDim.x) out[c0 + x] = 0.f;
    return;
  }
  const int stride = chunk + 4;
  const int stage_floats = n * stride;
  const int nc = (sb + chunk - 1) / chunk;
  if (threadIdx.x < kTrimMaxN)                  // rows past m: never read
    off[threadIdx.x] = (int)threadIdx.x < m
        ? (int)threadIdx.x * stride + row_shift(g, p, rows[threadIdx.x], c0)
        : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 64);
      mbar_init(&empty[s], kTrimConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 32) {                       // producer
    for (int c = 0; c < nc; ++c) {
      const int s = c % stages;
      if (c >= stages) {
        mbar_wait(&empty[s], (uint32_t)((c / stages - 1) & 1));
        fence_proxy_async();
      }
      stage_rows(ring + s * stage_floats, off, g, p, rows, m,
                 c0 + (long long)c * chunk, min(chunk, sb - c * chunk),
                 &full[s]);
    }
    return;
  }
  for (int c = 0; c < nc; ++c) {                // consumers
    const int s = c % stages;
    mbar_wait(&full[s], (uint32_t)((c / stages) & 1));
    trimmed_columns(ring + s * stage_floats, off, m, f, cnt,
                    min(chunk, sb - c * chunk), threadIdx.x - 32,
                    out + c0 + (long long)c * chunk);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
  }
}

inline unsigned int col_blocks(long long p) {
  return (unsigned int)((p + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// the shared memory a block may ask for on ``device`` (232,448 B on an H100)
int agg_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return v;
}

// One cooperative launch of ``grid`` blocks (agg.py: cge_plan). A grid
// that cannot be resident all at once is refused, and the error returned.
int agg_masked_cge(const float* g, const uint8_t* rx, int n, long long p,
                   int f, int grid, int share, int chunk, int budget,
                   int smem, float* partial, float* out, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      masked_cge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&g, &rx, &n, &p, &f, &share, &chunk, &budget, &partial,
                  &out};
  e = cudaLaunchCooperativeKernel((const void*)masked_cge_kernel, dim3(grid),
                                  dim3(kCgeThreads), args, (size_t)smem,
                                  (cudaStream_t)stream);
  return (int)e;
}

int agg_trimmed_mean(const float* g, const uint8_t* rx, int n, long long p,
                     int f, int grid, int share, int chunk, int stages,
                     int smem, float* out, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      trimmed_mean_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  trimmed_mean_kernel<<<grid, kTrimThreads, smem, (cudaStream_t)stream>>>(
      g, rx, n, p, f, share, chunk, stages, out);
  return (int)cudaGetLastError();
}

int agg_dequant_accum(const int8_t* q, const float* scale, const uint8_t* rx,
                      int n, long long p, float* out, void* stream) {
  masked_col_sum_kernel<<<col_blocks(p), kThreads, n * sizeof(int),
                          (cudaStream_t)stream>>>(q, rx, scale, n, p, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
