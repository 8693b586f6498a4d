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
// 50 us at 3.35 TB/s); dx (8 MB) stays in L2, where the atomics land. So
// the design keeps as many bytes of g in flight as it can and spends few
// instructions on the additions:
// * 16-byte rows. When C % 4 == 0 and g and dx start on 16 bytes, every
//   row of g and dx starts on 16 bytes, and a lane loads a float4 of g and
//   adds it with one vector atomic (atomicAdd(float4*), `red.global.add`
//   .v4.f32 on sm_90): at C = 64, 16 lanes cover a row and one warp
//   instruction two rows, a quarter of the atomic instructions of one
//   float a lane. Otherwise (C = 9: a row starts on 36 bytes) the same
//   code runs on single floats.
// * Several rows in flight. A warp takes a unit of R whole rows (R = 8 at
//   C = 64, 32 vectors at most: R = 1 past 512 channels, a row then in
//   several passes), laid end to end as one run of vectors in g. Lane l
//   first loads the destination row of the unit's row l (idx, then b * N
//   + j), then kPerLane vectors of the run, 32 apart (coalesced), and only
//   then issues their atomics, each to the destination its row's lane
//   hands over by a shuffle; so the loads of R rows overlap, and no load
//   of g waits for idx. C = 100 (25 float4s a row) takes 5 rows a unit,
//   125 of a warp's 128 vector slots.
// * The grid is the SMs times the blocks an SM holds (from the occupancy
//   calculator, asked once a device); warps take units with a grid
//   stride, neighbouring warps neighbouring units, so the card streams g
//   in order.
// The order of the additions varies from run to run, and so do the last
// bits of dx. On the H100 (700 W) the atomics, not the loads, set the
// pace: about 1.5 TB/s of updates at C = 64 and at C = 256 alike, so
// float4 atomics bought 15% over one float a lane at C = 64 (0.1258 ->
// 0.1075 ms queued at 16 x 2048 x 20) and ~2% at C = 256 (0.430 ->
// 0.419), not 4x. The alternative, a counting
// sort of idx by destination and one warp a destination row summing in
// edge order, gives run-to-run identical gradients but ran 4x slower as
// built (each bucket ordered by rank counting, quadratic in the in-degree
// of the graph's hub rows; PERF.md).
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kPerLane = 4;    // vectors a lane loads before it adds any
constexpr int kSlots = 32 * kPerLane;   // vectors of a warp's pass

// V: float4 (16-byte rows) or float. cv: vectors a row; rpu: rows a unit
// (<= 32, one a lane for the destinations)
template <typename V>
__global__ void __launch_bounds__(kThreads)
edgeconv_scatter_kernel(const int* __restrict__ idx, const V* __restrict__ g,
                        V* __restrict__ dx, long long rows, int n, int k,
                        int cv, int rpu) {
  const int lane = threadIdx.x % 32;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long nk = static_cast<long long>(n) * k;
  const long long units = (rows + rpu - 1) / rpu;
  for (long long unit = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
       unit < units; unit += warps) {
    // row = (b * n + i) * k + r; its destination is row b * n + j of dx
    const long long row0 = unit * rpu;
    const int nrows = static_cast<int>(rows - row0 < rpu ? rows - row0 : rpu);
    long long dst_row = 0;
    if (lane < nrows) {
      const long long row = row0 + lane;
      dst_row = (row / nk * n + __ldg(idx + row)) * cv;
    }
    const V* src = g + row0 * cv;
    const int total = nrows * cv;
    for (int e0 = 0; e0 < total; e0 += kSlots) {
      V val[kPerLane];
      long long dst[kPerLane];
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        const int e = e0 + 32 * t + lane;
        if (e < total) val[t] = __ldg(src + e);
      }
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        const int e = e0 + 32 * t + lane;
        const int r = e / cv;   // past total: any lane, never used
        dst[t] = __shfl_sync(0xffffffffu, dst_row, r & 31) + (e - r * cv);
      }
#pragma unroll
      for (int t = 0; t < kPerLane; ++t)
        if (e0 + 32 * t + lane < total) atomicAdd(dx + dst[t], val[t]);
    }
  }
}

// The grid's cap on the current device, into *most: its SMs times the
// blocks of edgeconv_scatter_kernel<V> an SM holds. Asked of the runtime
// once a device (the training steps' host time sets their pace).
template <typename V>
cudaError_t grid_cap(int* most) {
  constexpr int kDevices = 64;
  static std::atomic<int> cache[kDevices];   // 0: not asked yet
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices &&
      (*most = cache[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, edgeconv_scatter_kernel<V>, kThreads, 0);
  if (err != cudaSuccess) return err;
  *most = sms * per_sm;
  if (dev < kDevices) cache[dev].store(*most, std::memory_order_relaxed);
  return cudaSuccess;
}

template <typename V>
cudaError_t run_scatter(const int* idx, const void* g, void* dx,
                        long long rows, int n, int k, int cv,
                        cudaStream_t s) {
  int most = 0;
  const cudaError_t err = grid_cap<V>(&most);
  if (err != cudaSuccess) return err;
  const int rpu = cv >= kSlots ? 1 : (kSlots / cv < 32 ? kSlots / cv : 32);
  const long long units = (rows + rpu - 1) / rpu;
  const long long want = (units + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = static_cast<int>(want < most ? want : most);
  edgeconv_scatter_kernel<V><<<grid, kThreads, 0, s>>>(
      idx, static_cast<const V*>(g), static_cast<V*>(dx), rows, n, k, cv,
      rpu);
  return cudaGetLastError();
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
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int*>(idx);
  const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  return static_cast<int>(
      vec ? run_scatter<float4>(ix, g, dx, rows, n, k, c / 4, s)
          : run_scatter<float>(ix, g, dx, rows, n, k, c, s));
}
