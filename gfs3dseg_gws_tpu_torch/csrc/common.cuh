// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define GFS_EXPORT extern "C" __attribute__((visibility("default")))

namespace gfs {

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

}  // namespace gfs
