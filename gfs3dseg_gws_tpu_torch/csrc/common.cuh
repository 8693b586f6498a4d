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
// knn_kernel) and K8 (knn_stream_kernel, knn_fold_kernel) all use it, so
// their distances agree bit for bit
__device__ __forceinline__ float sq_dist(float qq, float kk, float dot) {
  return fmaxf(qq + kk - 2.f * dot, 0.f);
}

// K8's selection (csrc/knn_fold.cu) on x (B, N, C) for the nq queries of
// rows q_off .. q_off + nq - 1 (0 and N: all): idx (B, nq, k) nearest
// first, indices into all N rows; with btab (nq = N), also K3's neighbour
// statistics into the zeroed cnt (B, N) and scb (B, N, cb). k <= 256 runs
// the streaming selection (knn_stream_kernel), past it the fold-merge
// tournament; folds is 2, 4 or 8 (4 with btab), the tournament's. scratch
// holds knn_fold_scratch_bytes bytes (may be null when that is 0).
cudaError_t launch_knn_fold(const float* x, int* idx, int batch, int n,
                            int nq, int q_off, int c, int k, int folds,
                            const float* btab, float* cnt, float* scb, int cb,
                            void* scratch, cudaStream_t s);

// the scratch launch_knn_fold needs for nq queries against n keys on the
// current device: 0 unless k > 256 and one query's key row does not fit in
// shared memory
cudaError_t knn_fold_scratch_bytes(int batch, int n, int nq, int c, int k,
                                   int folds, long long* bytes);

}  // namespace gfs
