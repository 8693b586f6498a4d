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

// the kNN kernels' squared distance from |q|^2, |k|^2 and q.k, each summed
// as one fmaf chain over the channels in order: K1/K3/K6 (knn_split_kernel,
// knn_kernel) and
// K8 (knn_fold_kernel) both use it, so their distances agree bit for bit
__device__ __forceinline__ float sq_dist(float qq, float kk, float dot) {
  return fmaxf(qq + kk - 2.f * dot, 0.f);
}

// K8's fold-merge selection (csrc/knn_fold.cu) on x (B, N, C): idx (B, N, k)
// nearest first; with btab, also K3's neighbour statistics into the zeroed
// cnt (B, N) and scb (B, N, cb). folds is 2, 4 or 8. scratch holds
// knn_fold_scratch_bytes bytes (may be null when that is 0).
cudaError_t launch_knn_fold(const float* x, int* idx, int batch, int n, int c,
                            int k, int folds, const float* btab, float* cnt,
                            float* scb, int cb, void* scratch,
                            cudaStream_t s);

// the scratch launch_knn_fold needs at this shape on the current device: 0
// when one query's key row fits in shared memory
cudaError_t knn_fold_scratch_bytes(int batch, int n, int c, int k, int folds,
                                   long long* bytes);

}  // namespace gfs
