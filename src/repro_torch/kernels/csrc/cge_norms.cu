// Hopper (sm_90a) kernels for the CGE filter's bucketed passes over a
// (n_buckets, width) gradient bucketing (kernels/ops.py tree_bucket):
// per-row f32 squared norms, and a per-row keep/drop scaling. They replace
// the Pallas TPU kernels src/repro/kernels/cge_norms.py:block_sq_norms and
// :masked_scale. Plain C entry points, bound from Python with ctypes
// (repro_torch/kernels/cge_norms.py); each launches one kernel on the
// caller's stream and returns cudaGetLastError().
//
// Both are bound by bytes: the squared norms read every element once and
// write 4 bytes per row (a full qwen2-0.5b tree bucketed as bf16 is
// 241,227 rows x 2048 = 988 MB, ~295 us at 3.35 TB/s); the scaling reads
// and writes every element once (~590 us there). The design:
// - block_sq_norms: one warp per row, each lane reading 16 bytes at a
//   time (8 bf16 or 4 f32) with four loads in flight, squares summed in
//   f32 in a fixed order per lane, then a fixed xor-butterfly across the
//   warp. No atomics and no order that depends on scheduling, so a row's
//   norm is the same from run to run and the CGE keep-set built from it
//   cannot flip between runs. Any width: rows whose width or base is not
//   16-byte aligned take the same walk one element at a time.
// - masked_scale: a block walks rows (grid-stride over rows), its threads
//   the row's 16-byte vectors; the row's scale is read once. Each element
//   is widened to f32, multiplied once by the scale and rounded once
//   (round to nearest even) to x's dtype: bit-identical to
//   (x.float() * scale[:, None]).to(x.dtype).
// Multi-row unrolling, cp.async/TMA bulk copies and a fused norms+scale
// pass are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // threads per block
constexpr int kWarps = kThreads / 32;       // rows per block (norms)
constexpr int kUnroll = 4;                  // 16-byte loads in flight
constexpr int kScaleBlocks = 132 * 8;       // grid of masked_scale

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes of T as f32 values
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
  float x[kN];
};

__device__ __forceinline__ void load_vec(const float* p, Vec<float>& v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v.x[0] = a.x; v.x[1] = a.y; v.x[2] = a.z; v.x[3] = a.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         Vec<__nv_bfloat16>& v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v.x[2 * i] = f.x;
    v.x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const Vec<float>& v) {
  *reinterpret_cast<float4*>(p) = make_float4(v.x[0], v.x[1], v.x[2], v.x[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const Vec<__nv_bfloat16>& v) {
  uint4 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(v.x[i]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
block_sq_norms_kernel(const T* __restrict__ x, long long n, long long w,
                      float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = x + row * w;
  float acc = 0.f;
  if (kVec) {
    constexpr int kN = Vec<T>::kN;
    const long long nv = w / kN;           // the wrapper checks w % kN == 0
    for (long long v0 = lane; v0 < nv; v0 += 32 * kUnroll) {
      Vec<T> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long vi = v0 + 32LL * u;
        if (vi < nv) {
          load_vec(xr + vi * kN, v[u]);
        } else {
#pragma unroll
          for (int e = 0; e < kN; ++e) v[u].x[e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int e = 0; e < kN; ++e) acc = fmaf(v[u].x[e], v[u].x[e], acc);
    }
  } else {
    for (long long i = lane; i < w; i += 32) {
      const float a = to_f32(xr[i]);
      acc = fmaf(a, a, acc);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[row] = acc;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
masked_scale_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    long long n, long long w, T* __restrict__ out) {
  for (long long row = blockIdx.x; row < n; row += gridDim.x) {
    const float s = scale[row];
    const T* xr = x + row * w;
    T* orow = out + row * w;
    if (kVec) {
      constexpr int kN = Vec<T>::kN;
      const long long nv = w / kN;
      for (long long vi = threadIdx.x; vi < nv; vi += kThreads) {
        Vec<T> v;
        load_vec(xr + vi * kN, v);
#pragma unroll
        for (int e = 0; e < kN; ++e) v.x[e] = v.x[e] * s;
        store_vec(orow + vi * kN, v);
      }
    } else {
      for (long long i = threadIdx.x; i < w; i += kThreads)
        from_f32(orow + i, to_f32(xr[i]) * s);
    }
  }
}

template <typename T>
void launch_norms(const void* x, long long n, long long w, int vec,
                  float* out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  const T* xx = static_cast<const T*>(x);
  if (vec) {
    block_sq_norms_kernel<T, true><<<blocks, kThreads, 0, stream>>>(xx, n, w,
                                                                     out);
  } else {
    block_sq_norms_kernel<T, false><<<blocks, kThreads, 0, stream>>>(xx, n, w,
                                                                      out);
  }
}

template <typename T>
void launch_scale(const void* x, const float* scale, long long n, long long w,
                  int vec, void* out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)(n < kScaleBlocks ? n : kScaleBlocks);
  const T* xx = static_cast<const T*>(x);
  T* oo = static_cast<T*>(out);
  if (vec) {
    masked_scale_kernel<T, true><<<blocks, kThreads, 0, stream>>>(xx, scale,
                                                                  n, w, oo);
  } else {
    masked_scale_kernel<T, false><<<blocks, kThreads, 0, stream>>>(xx, scale,
                                                                   n, w, oo);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. vec != 0: every row starts on a
// 16-byte boundary (the wrapper checks the base and width). n >= 1.
int cge_block_sq_norms(const void* x, long long n, long long w, int dtype,
                       int vec, float* out, void* stream) {
  if (dtype == 1) {
    launch_norms<__nv_bfloat16>(x, n, w, vec, out, (cudaStream_t)stream);
  } else {
    launch_norms<float>(x, n, w, vec, out, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

int cge_masked_scale(const void* x, const float* scale, long long n,
                     long long w, int dtype, int vec, void* out,
                     void* stream) {
  if (dtype == 1) {
    launch_scale<__nv_bfloat16>(x, scale, n, w, vec, out,
                                (cudaStream_t)stream);
  } else {
    launch_scale<float>(x, scale, n, w, vec, out, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
