// Shared helpers of the attention kernels: dtype conversion and the
// vectorised tile loader.  Every tensor is row-major with rows of HD
// elements, so each row starts on a 16-byte boundary (the wrappers check
// the base pointers) and a row loads as HD*sizeof(T)/16 vectors of 16 B.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float NEG_INF = -1e30f;   // the reference's masked-score value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

// Copy rows [0, ROWS) of a (rows, HD) tile into shared memory as fp32
// with row stride LDS, times `mul`; rows at or past `valid_rows` (the
// ragged edge) are written as zeros and never read from global memory.
template <typename T, int HD, int ROWS, int LDS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int valid_rows, float mul) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = HD / V;
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += NT) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * V;
    float x[V];
    if (r < valid_rows) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (size_t)r * HD + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = to_float(e[i]) * mul;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) dst[r * LDS + c + i] = x[i];
  }
}

}  // namespace repro
