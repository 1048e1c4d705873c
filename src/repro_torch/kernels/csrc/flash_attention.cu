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
// operations: the bf16 tensor-core rate (989 TFLOP/s) for bf16 inputs,
// the f32 rate outside the tensor cores (67 TFLOP/s) for f32 inputs.
//
// Two kernels, chosen by dtype:
//
// flash_wgmma_kernel (bf16). The products run on the tensor cores with
// wgmma (m64n64k16, bf16 in, f32 accumulation):
// - one block of two warpgroups (256 threads) per (128-query tile, head,
//   batch); each warpgroup owns 64 query rows. The grid is one dimension
//   with the query tile major and last-first, so under the causal mask
//   the longest tiles of every head start before any shorter one (by
//   head, the last heads' longest tiles would start late and set the
//   tail);
// - Q, K and V tiles are bf16 in shared memory in the 128-byte-swizzled
//   layout wgmma reads (64-column atoms of 128-byte rows, 16-byte chunk
//   j of row r at chunk j ^ (r % 8)), written by cp.async 16 bytes at a
//   time. K and V come through a ring of two stages: the copy of key
//   tile t + 1 is in flight while tile t is multiplied. Copies past T
//   (rows) or past D (columns) are zero-filled by cp.async's source size
//   of 0, so ragged T and D, Dv that are multiples of 8 but not of 16 or
//   64 need no other code: D is padded with zeros to a multiple of 64
//   (the 64-column atom), Dv likewise, and padded output columns are
//   not stored;
// - S = Q.K^T: A (Q) and B (K) both read from shared memory, K-major;
//   the scores stay in the accumulator registers (32 f32 per thread per
//   64-key tile). m and l are per row in registers, reduced over the
//   four lanes of a row with two shuffles. Softmax runs in base 2, the
//   same function: p = 2^(s c - m) with c = D^-0.5 log2 e, one fused
//   multiply-add and one ex2 per score;
// - O += P.V: P is rounded to bf16 in registers and is the register A
//   operand (the accumulator layout of S is the A-fragment layout of
//   P), V is the B operand read from shared memory in its row-major
//   (T, Dv) layout as a transposed (MN-major) operand; O stays in
//   registers, Dv / 64 accumulators of 64 columns;
// - per tile, S is waited for, its softmax taken, then P.V waited for
//   (issuing P(t).V(t) and S(t + 1) back to back over a third stage
//   measured slower on the H100 at both of chip_smoke.py's shapes);
// - under the causal mask, key tiles wholly above a warpgroup's diagonal
//   are skipped, and only tiles that cross the diagonal or T are masked
//   element by element.
// Numerics: the TPU kernel keeps P in f32 for P.V (flash_attention.py:
// 58-62); the tensor cores take it in bf16, which adds at most 2^-8
// relative to each term of P.V, on top of the output's own bf16 rounding
// (2^-8); kernels/cases.py FLASH_TOL states the limit. The sum l is
// taken over the f32 P.
//
// flash_fwd_kernel (f32). Every multiply-add a scalar f32 FMA on the
// CUDA cores: f32 inputs must hold 2e-5 of the plain form, which TF32
// cannot give. One block of 256 threads per 64-query tile; f32 Q, K (d-
// major) and V tiles and a probability tile in dynamic shared memory;
// thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and keys tx + 16 j.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;     // flash_attention.py NEG_INF

// ---------------------------------------------------------------------------
// f32: CUDA cores

constexpr int kThreads = 256;
constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // keys per tile
constexpr int kPStride = kBQ + 4;     // padded row of the probability tile

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// rows r0 .. r0 + 63 of the (L, D) matrix x, transposed into xs[d][64];
// rows at or past L are zeros
__device__ __forceinline__ void stage_transposed(const float* __restrict__ x,
                                                 int r0, int L, int D,
                                                 float* xs) {
  const int chunks = D / 4;
  for (int idx = threadIdx.x; idx < kBQ * chunks; idx += kThreads) {
    const int r = idx % kBQ;
    const int c = idx / kBQ;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < L)
      v = *reinterpret_cast<const float4*>(x + (long long)(r0 + r) * D +
                                           c * 4);
    xs[(c * 4 + 0) * kBQ + r] = v.x;
    xs[(c * 4 + 1) * kBQ + r] = v.y;
    xs[(c * 4 + 2) * kBQ + r] = v.z;
    xs[(c * 4 + 3) * kBQ + r] = v.w;
  }
}

// rows r0 .. r0 + 63 of the (L, Dv) matrix x into xs[64][Dv]
__device__ __forceinline__ void stage_rows(const float* __restrict__ x,
                                           int r0, int L, int Dv,
                                           float* xs) {
  const int chunks = Dv / 4;
  for (int idx = threadIdx.x; idx < kBK * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = idx % chunks;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < L)
      v = *reinterpret_cast<const float4*>(x + (long long)(r0 + r) * Dv +
                                           c * 4);
    *reinterpret_cast<float4*>(xs + r * Dv + c * 4) = v;
  }
}

// kChunks: float4 value columns per thread, Dv <= 64 kChunks
template <int kChunks>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int H,
                 int S, int T_len, int D, int Dv, float scale, int causal) {
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
  const float* qb = q + bh * S * D;
  const float* kb = k + bh * T_len * D;
  const float* vb = v + bh * T_len * Dv;

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

  float* ob = out + bh * S * Dv;
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

template <int kChunks>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int B, int H, int S, int T_len, int D, int Dv, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)2 * D * kBQ + (size_t)kBK * Dv +
                       (size_t)kBK * kPStride);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<kChunks>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<kChunks><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, S, T_len, D,
      Dv, scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma

constexpr int kWgThreads = 256;       // two warpgroups
constexpr int kWgBQ = 128;            // query rows per block, 64 per warpgroup
constexpr int kWgBK = 64;             // keys per tile
constexpr int kWgStages = 2;          // K/V tiles in the ring
constexpr uint32_t kAtomRow = 128;    // bytes in one row of a 64-column atom

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from g to shared address s; bytes = 0 writes 16 zero bytes and
// reads nothing
__device__ __forceinline__ void cp_async16(uint32_t s, const void* g,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(g), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// makes this thread's completed cp.async writes visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows r0 .. r0 + rows - 1 of the row-major (L, W) bf16 matrix x into the
// swizzled atoms at s (each rows x 128 bytes): chunks c < nch per row,
// zeros for rows at or past L and for columns at or past W
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ x,
                                          int r0, int rows, int L, int W,
                                          int nch, uint32_t s) {
  for (int idx = threadIdx.x; idx < rows * nch; idx += kWgThreads) {
    const int r = idx / nch;
    const int c = idx - r * nch;
    const bool ok = r0 + r < L && c * 8 < W;
    const __nv_bfloat16* src = ok ? x + (long long)(r0 + r) * W + c * 8 : x;
    const uint32_t dst = s + (uint32_t)(c >> 3) * rows * kAtomRow +
                         (uint32_t)r * kAtomRow +
                         ((uint32_t)((c & 7) ^ (r & 7)) << 4);
    cp_async16(dst, src, ok ? 16 : 0);
  }
}

// wgmma matrix descriptor, 128-byte swizzle: start address, leading and
// stride byte offsets (bits 0-13, 16-29, 32-45, each in 16-byte units),
// layout type 1 (bits 62-63)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define WG_D32_STR                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31}"
#define WG_D32_OPS(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),             \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
      "+f"(d[30]), "+f"(d[31])

// d (64 x 64, f32) = A . B (+ d if accumulate): A and B from shared
// memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32_STR
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32_OPS(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A . B: A (64 x 16 bf16) from registers, B from
// shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32_STR
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kN) : "memory");
}

// dynamic shared memory of one block: 1024 bytes of alignment slack, the
// Q tile (ka atoms of 128 rows), then the stages of K (ka atoms of 64
// rows) and V (nv atoms of 64 rows)
constexpr size_t wg_smem_bytes(int ka, int nv) {
  return 1024 + (size_t)ka * kWgBQ * kAtomRow +
         (size_t)kWgStages * (ka + nv) * kWgBK * kAtomRow;
}

// issue S = Q . K^T over D in steps of 16 (32 bytes inside an atom) for
// warpgroup wg's 64 rows, and commit it
template <int kKA>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_s,
                                         uint32_t ks, int wg) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * kKA; ++kk) {
    const uint32_t within = (uint32_t)(kk & 3) * 32;
    const uint64_t da = sw128_desc(
        q_s + (kk >> 2) * kWgBQ * kAtomRow + wg * 64 * kAtomRow + within, 16,
        1024);
    const uint64_t db =
        sw128_desc(ks + (kk >> 2) * kWgBK * kAtomRow + within, 16, 1024);
    wgmma_ss(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// issue O += P . V: 16 keys (2048 bytes of V rows) per step, one 64-column
// atom of Dv per accumulator, and commit it
template <int kNV>
__device__ __forceinline__ void issue_pv(float (&o)[kNV][32],
                                         const uint32_t (&a)[4][4],
                                         uint32_t vs) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < kNV; ++c)
      wgmma_rs(o[c], a[j],
               sw128_desc(vs + c * kWgBK * kAtomRow + j * 16 * kAtomRow, 1024,
                          1024));
  wgmma_commit();
}

// the online-softmax step of one 64-key tile: mask (tiles that cross the
// diagonal or T only), running max m and sum l of rows row0 and row1 in
// base-2 units, O rescaled, P packed into the bf16 A fragments of four
// 16-key steps. s[4 j + e] is row (e & 2 ? row1 : row0), key
// k0 + 8 j + 2 tig + (e & 1), unscaled.
template <int kNV>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], uint32_t (&a)[4][4], float (&o)[kNV][32], float& m0,
    float& m1, float& l0, float& l1, bool need_mask, int k0, int T_len,
    int causal, int row0, int row1, int tig, float scale_log2) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (need_mask) {
      const int kpos = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
      const int qpos = (i & 2) ? row1 : row0;
      if (kpos >= T_len || (causal && kpos > qpos)) s[i] = kNegInf;
    }
    if (i & 2) mx1 = fmaxf(mx1, s[i]);
    else mx0 = fmaxf(mx0, s[i]);
  }
#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
  }
  // the scale is positive, so the max of the scaled scores is the
  // scaled max, bit for bit
  const float mn0 = fmaxf(m0, mx0 * scale_log2);
  const float mn1 = fmaxf(m1, mx1 * scale_log2);
  const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = ex2(fmaf(s[i], scale_log2, (i & 2) ? -mn1 : -mn0));
    s[i] = p;
    if (i & 2) sum1 += p;
    else sum0 += p;
  }
  l0 = l0 * c0 + sum0;
  l1 = l1 * c1 + sum1;
#pragma unroll
  for (int c = 0; c < kNV; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] *= (i & 2) ? c1 : c0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack_bf16(s[8 * j + 0], s[8 * j + 1]);
    a[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
    a[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
    a[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
  }
}

// kKA: 64-column atoms of D (D <= 64 kKA); kNV: of Dv (Dv <= 64 kNV)
template <int kKA, int kNV>
__global__ void __launch_bounds__(kWgThreads, kKA + kNV <= 2 ? 2 : 1)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, int H, int S, int T_len,
                   int D, int Dv, float scale_log2, int causal) {
  constexpr uint32_t kStage = (kKA + kNV) * kWgBK * kAtomRow;
  constexpr uint32_t kVOff = kKA * kWgBK * kAtomRow;   // V after K
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + kKA * kWgBQ * kAtomRow;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid & 127) >> 5;
  const int lane = tid & 31;
  const int tig = lane & 3;
  // one grid dimension, query tiles major and last-first: the longest
  // causal tiles of every (batch, head) start before any shorter one
  const int n_q = (S + kWgBQ - 1) / kWgBQ;
  const int n_bh = gridDim.x / n_q;
  const int q0 = (n_q - 1 - (int)(blockIdx.x / n_bh)) * kWgBQ;
  const long long bh = blockIdx.x % n_bh;
  const __nv_bfloat16* qb = q + bh * S * D;
  const __nv_bfloat16* kb = k + bh * T_len * D;
  const __nv_bfloat16* vb = v + bh * T_len * Dv;

  int n_tiles = (T_len + kWgBK - 1) / kWgBK;
  if (causal) {
    const int q_last = min(q0 + kWgBQ, S) - 1;
    n_tiles = min(n_tiles, q_last / kWgBK + 1);
  }
  // one cp.async group per tile (empty past the last): Q with tile 0,
  // then tiles 1 .. kWgStages - 1 ahead
  auto load_kv = [&](int t) {
    if (t < n_tiles) {
      const uint32_t st = kv_s + (t % kWgStages) * kStage;
      load_tile(kb, t * kWgBK, kWgBK, T_len, D, kKA * 8, st);
      load_tile(vb, t * kWgBK, kWgBK, T_len, Dv, kNV * 8, st + kVOff);
    }
    cp_async_commit();
  };
  load_tile(qb, q0, kWgBQ, S, D, kKA * 8, q_s);
#pragma unroll
  for (int t = 0; t < kWgStages; ++t) load_kv(t);

  const int wg_first = q0 + 64 * wg;          // this warpgroup's rows
  const int wg_last = wg_first + 63;
  const int row0 = wg_first + 16 * warp + (lane >> 2);   // and row0 + 8
  const int row1 = row0 + 8;
  // key tiles wholly above the diagonal of all of the warpgroup's rows
  // are skipped (the first tile never is)
  const int wg_tiles =
      causal ? min(n_tiles, wg_last / kWgBK + 1) : n_tiles;

  float o[kNV][32];
  float s[32];
  uint32_t a[4][4];
#pragma unroll
  for (int c = 0; c < kNV; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kWgStages - 1>();
    fence_async_shared();
    __syncthreads();
    if (t < wg_tiles) {
      const uint32_t st = kv_s + (t % kWgStages) * kStage;
      issue_qk<kKA>(s, q_s, st, wg);
      wgmma_wait0();
      fence_regs(s);
      const int k0 = t * kWgBK;
      softmax_tile<kNV>(
          s, a, o, m0, m1, l0, l1,
          k0 + kWgBK > T_len || (causal && k0 + kWgBK - 1 > wg_first), k0,
          T_len, causal, row0, row1, tig, scale_log2);
      issue_pv<kNV>(o, a, st + kVOff);
      wgmma_wait0();
#pragma unroll
      for (int c = 0; c < kNV; ++c) fence_regs(o[c]);
    }
    __syncthreads();
    load_kv(t + kWgStages);
  }

#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = out + bh * S * Dv;
#pragma unroll
  for (int c = 0; c < kNV; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + 2 * tig;
      if (col >= Dv) continue;
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(ob + (long long)row0 * Dv + col) =
            pack_bf16(o[c][4 * j] * inv0, o[c][4 * j + 1] * inv0);
      if (row1 < S)
        *reinterpret_cast<uint32_t*>(ob + (long long)row1 * Dv + col) =
            pack_bf16(o[c][4 * j + 2] * inv1, o[c][4 * j + 3] * inv1);
    }
  }
}

template <int kKA, int kNV>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int H, int S, int T_len, int D, int Dv, float scale,
                 int causal, cudaStream_t stream) {
  constexpr size_t smem = wg_smem_bytes(kKA, kNV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<kKA, kNV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kWgBQ - 1) / kWgBQ * B * H);
  flash_wgmma_kernel<kKA, kNV><<<grid, kWgThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), H, S, T_len, D, Dv,
      scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

template <int kKA>
int dispatch_nv(const void* q, const void* k, const void* v, void* out,
                int B, int H, int S, int T_len, int D, int Dv, float scale,
                int causal, cudaStream_t stream) {
  switch ((Dv + 63) / 64) {
    case 1: return launch_wgmma<kKA, 1>(q, k, v, out, B, H, S, T_len, D, Dv,
                                        scale, causal, stream);
    case 2: return launch_wgmma<kKA, 2>(q, k, v, out, B, H, S, T_len, D, Dv,
                                        scale, causal, stream);
    case 3: return launch_wgmma<kKA, 3>(q, k, v, out, B, H, S, T_len, D, Dv,
                                        scale, causal, stream);
    default: return launch_wgmma<kKA, 4>(q, k, v, out, B, H, S, T_len, D,
                                         Dv, scale, causal, stream);
  }
}

}  // namespace

extern "C" {

// dynamic shared memory of one block of the bf16 kernel for D and Dv
int flash_wgmma_smem_bytes(int D, int Dv) {
  return (int)wg_smem_bytes((D + 63) / 64, (Dv + 63) / 64);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). B, H, S,
// T >= 1; D, Dv multiples of 8 in [8, 256].
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int S, int T_len, int D,
                        int Dv, float scale, int causal, int dtype,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    switch ((D + 63) / 64) {
      case 1: return dispatch_nv<1>(q, k, v, out, B, H, S, T_len, D, Dv,
                                    scale, causal, st);
      case 2: return dispatch_nv<2>(q, k, v, out, B, H, S, T_len, D, Dv,
                                    scale, causal, st);
      case 3: return dispatch_nv<3>(q, k, v, out, B, H, S, T_len, D, Dv,
                                    scale, causal, st);
      default: return dispatch_nv<4>(q, k, v, out, B, H, S, T_len, D, Dv,
                                     scale, causal, st);
    }
  }
  if (Dv <= 64)
    return launch_f32<1>(q, k, v, out, B, H, S, T_len, D, Dv, scale, causal,
                         st);
  if (Dv <= 128)
    return launch_f32<2>(q, k, v, out, B, H, S, T_len, D, Dv, scale, causal,
                         st);
  return launch_f32<4>(q, k, v, out, B, H, S, T_len, D, Dv, scale, causal,
                       st);
}

}  // extern "C"
