// Shared helpers for the port's attention kernels (sm_90a, plain C ABI).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Finite mask sentinel shared with the reference kernels: a row whose first
// tiles are fully masked accumulates a bogus uniform contribution that the
// exp(m_prev - m_cur) rescale annihilates once a live key appears; -inf
// would give NaN there.
constexpr float NEG_INF = -1e30f;

// dtype codes passed from Python
constexpr int DT_F32 = 0;
constexpr int DT_BF16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Load N consecutive elements of T (16-byte aligned for N * sizeof(T) >= 16,
// 8-byte aligned below) and widen them to float.
template <typename T, int N>
__device__ __forceinline__ void load_as_float(const T* __restrict__ p, float* out) {
  if constexpr (sizeof(T) == 4) {
    static_assert(N % 4 == 0, "f32 loads come in float4");
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i + 0] = v.x;
      out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z;
      out[4 * i + 3] = v.w;
    }
  } else if constexpr (sizeof(T) == 2) {
    static_assert(N % 8 == 0, "bf16 loads come in 16 bytes");
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        out[8 * i + 2 * j] = f.x;
        out[8 * i + 2 * j + 1] = f.y;
      }
    }
  } else {
    static_assert(N % 8 == 0, "int8 loads come in 8 or 16 bytes");
    if constexpr (N % 16 == 0) {
#pragma unroll
      for (int i = 0; i < N / 16; ++i) {
        const uint4 raw = reinterpret_cast<const uint4*>(p)[i];
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int j = 0; j < 16; ++j) out[16 * i + j] = static_cast<float>(b[j]);
      }
    } else {
      const uint2 raw = reinterpret_cast<const uint2*>(p)[0];
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) out[j] = static_cast<float>(b[j]);
    }
  }
}

// (batch, seq, head) strides in elements of a [B, S, H, hd] tensor
struct Strides {
  long long b, s, h;
};

// Stage `rows` rows of HD elements starting at row `row0` (rows >= n_valid
// are zero-filled) into shared memory with row stride LD, scaled by `mul`;
// NT threads of the block share the work.
template <typename T, int HD, int LD, int NT>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          long long stride_s, int row0, int n_valid, int rows,
                                          float mul) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CH = HD / V;
  for (int idx = threadIdx.x; idx < rows * CH; idx += NT) {
    const int r = idx / CH;
    const int c = (idx % CH) * V;
    float vals[V];
    if (row0 + r < n_valid) {
      load_as_float<T, V>(src + (long long)(row0 + r) * stride_s + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) vals[i] = 0.f;
    }
    float* d = dst + r * LD + c;
#pragma unroll
    for (int i = 0; i < V; ++i) d[i] = vals[i] * mul;
  }
}

}  // namespace repro
