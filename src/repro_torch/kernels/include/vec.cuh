// Element helpers shared by the port's kernels: 16-byte vector loads that
// widen fp32 or bf16 to float, stores that narrow float to fp32 or bf16, and
// the error-string entry every kernel library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace repro {

// Write the 16 raw bytes of 4 fp32 or 8 bf16 values to dst as floats.
__device__ __forceinline__ void widen16(const uint4& raw, float* dst, float) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i] = f[i];
}

__device__ __forceinline__ void widen16(const uint4& raw, float* dst,
                                        __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Load 16 bytes from a 16-byte aligned address and write them to dst as
// floats.
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  widen16(*reinterpret_cast<const uint4*>(src), dst, T());
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

}  // namespace repro

// Each library links its own CUDA runtime, so each exports its own way to
// name the error codes its entry points return.  A kernel library includes
// this header from exactly one source file.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
