// K7: the backward of the EdgeConv neighbour gather, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel gfs3dseg_gws_tpu/ops/edgeconv.py::
// _scatter_bwd_pallas (its Pallas body `_scatter_bwd_kernel`):
//
//   dx[b, j, :] = sum over (i, r) with idx[b, i, r] == j of g[b, i, r, :]
//
// for g (B, N, K, C) fp32 and idx (B, N, K) int32 -> dx (B, N, C) fp32,
// which the caller has zeroed. The TPU kernel carried the sum across a
// sequential grid in VMEM and added through a bf16 one-hot matmul; blocks
// of a GPU grid run in no order, so here every edge row is added straight
// into dx with float atomics, in full fp32.
//
// What bounds it: bytes. g is read once (168 MB at 16 x 2048 x 20 x 64,
// 50 us at 3.35 TB/s); dx (8 MB) stays in L2, where the atomics land. One
// warp takes one edge row (b, i, r) at a time: the lanes read g's row as
// consecutive words (coalesced) and add it to dx's row j as consecutive
// words, so each warp-wide atomic instruction touches one row. The order of
// the additions varies from run to run, and so do the last bits of dx.
// The alternative, a counting sort of idx by destination and one warp per
// destination row, is deterministic but costs a sort and two more passes
// over the indices; it is left for a PR that needs run-to-run identical
// gradients.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps per block

__global__ void __launch_bounds__(kThreads)
edgeconv_scatter_kernel(const int* __restrict__ idx,
                        const float* __restrict__ g, float* __restrict__ dx,
                        long long rows, int n, int k, int c) {
  const int lane = threadIdx.x % 32;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
       row < rows; row += warps) {
    // row = (b * n + i) * k + r; its destination is row j of batch b
    const long long b = row / (static_cast<long long>(n) * k);
    const int j = __ldg(idx + row);
    const float* src = g + row * c;
    float* dst = dx + (b * n + j) * c;
    for (int ch = lane; ch < c; ch += 32) atomicAdd(dst + ch, __ldg(src + ch));
  }
}

}  // namespace

// K7. idx (B, N, K) int32 with entries in [0, N), g (B, N, K, C) fp32, dx
// (B, N, C) fp32 zeroed by the caller: contiguous, on one device. Returns a
// cudaError_t.
GFS_EXPORT int gfs_edgeconv_scatter(const void* idx, const void* g, void* dx,
                                    int batch, int n, int k, int c,
                                    void* stream) {
  if (batch < 1 || n < 1 || k < 1 || c < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(batch) * n * k;
  // enough warps to keep every SM busy; each walks rows with a grid stride
  const long long want = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  edgeconv_scatter_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(g),
      static_cast<float*>(dx), rows, n, k, c);
  return static_cast<int>(cudaGetLastError());
}
