// K8: exact kNN indices by fold-merge selection, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel gfs3dseg_gws_tpu/ops/knn.py::_knn_pallas_fold (its
// Pallas body `_knn_fold_kernel`), which computes what K6 computes - the k
// nearest keys of every query, self included, nearest first - by a
// tournament: split the key row into `folds` column slices, sort every
// column across the folds with a small network (so each column's minimum
// sits in fold 0), then pop the global minimum k times from fold 0 alone,
// shifting the popped column up by one fold.
//
// Here one warp owns one query. Its whole key row lives in shared memory as
// 64-bit keys, the distance's bits high and the key's index low: exact (the
// TPU packed both into 32 bits and lost 2^-12 of the distance) and ordered
// by (distance, index), K6's rule for ties. Lane l owns the columns l,
// l + 32, ... of the (folds, w) layout (w = ceil(N / folds); keys past N are
// all-ones and never popped, so ragged N needs no gate). A round is a
// five-step shuffle-min over the lanes' minima of their fold-0 entries;
// the lane whose column popped shifts it and rescans its own w / 32
// entries, the others wait.
//
// The distances come from K6's own arithmetic: |q|^2, |k|^2 and q.k are
// fmaf chains over the channels in order (the key tile staged through
// shared memory, 64 channels at a time for C > 64) and gfs::sq_dist puts
// them together, so K8's indices equal K6's bit for bit. fmaxf(x, 0) may
// return -0.0, whose sign bit would sort it after every positive distance:
// the sign bit is cleared before packing.
//
// launch_knn_fold also serves K1, K3 and K6 for k > 64 (csrc/
// fused_edgeconv.cu), with K3's neighbour statistics added per popped
// neighbour: the lanes add the query's btab row into scb[j], lane 0 adds 1
// to cnt[j]. What bounds K8: the B N^2 C distance FMAs, as for K6; each
// block of up to eight warps streams every key row once per eight queries.
//
// A whole key row takes N * 8 bytes of shared memory per query, so past
// N ~ 27,000 (at eight warps: 3,328 keys each, four folds) the row is
// streamed in chunks that fit: each chunk runs the same fold-merge, and its
// pops are merged with the query's running k best, a sorted list of k keys
// kept in a global scratch (B, N, 2, k) (the merge writes the other half of
// the pair and the two swap); the statistics are added from the final
// list. A row that fits runs in one chunk and pops straight into idx (and
// the statistics), with no scratch.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kTile = 64;                 // key rows per shared-memory tile
constexpr int kMaxWarps = 8;              // queries per block, at most
using fold_key = unsigned long long;       // (distance bits << 32) | index
constexpr fold_key kNoKey = ~0ull;

__device__ __forceinline__ void cx(fold_key& a, fold_key& b) {
  const fold_key lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

// sorting networks across the folds (minimum at index 0): the TPU kernel's
template <int F>
__device__ __forceinline__ void sort_column(fold_key (&f)[F]);
template <>
__device__ __forceinline__ void sort_column<2>(fold_key (&f)[2]) {
  cx(f[0], f[1]);
}
template <>
__device__ __forceinline__ void sort_column<4>(fold_key (&f)[4]) {
  cx(f[0], f[1]); cx(f[2], f[3]); cx(f[0], f[2]); cx(f[1], f[3]);
  cx(f[1], f[2]);
}
template <>
__device__ __forceinline__ void sort_column<8>(fold_key (&f)[8]) {
  cx(f[0], f[1]); cx(f[2], f[3]); cx(f[4], f[5]); cx(f[6], f[7]);
  cx(f[0], f[2]); cx(f[1], f[3]); cx(f[4], f[6]); cx(f[5], f[7]);
  cx(f[1], f[2]); cx(f[5], f[6]); cx(f[0], f[4]); cx(f[1], f[5]);
  cx(f[2], f[6]); cx(f[3], f[7]); cx(f[2], f[4]); cx(f[3], f[5]);
  cx(f[1], f[2]); cx(f[3], f[4]); cx(f[5], f[6]);
}

// CP: input width padded to a multiple of 4 (16 or 64), or 0 for C > 64
// (64-channel chunks); F: folds; kStats: K3's statistics (see above). w:
// columns of one key chunk (ceil(N / F) when the row fits, else a multiple
// of 32, so that a chunk of F w keys holds whole 64-row tiles); scratch:
// the running lists, used when the row takes more than one chunk.
template <int CP, int F, bool kStats>
__global__ void __launch_bounds__(kMaxWarps * 32)
knn_fold_kernel(const float* __restrict__ x, int* __restrict__ idx, int n,
                int c, int k, int w, const float* __restrict__ btab,
                float* __restrict__ cnt, float* __restrict__ scb, int cb,
                fold_key* __restrict__ scratch) {
  constexpr bool kWide = CP == 0;
  constexpr int QW = kWide ? 64 : CP;     // channels held at once
  constexpr int kStride = QW + 4;          // float4 rows, no bank conflicts
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tile = reinterpret_cast<float*>(smem_raw);   // [kTile][kStride]
  float* kk_s = tile + kTile * kStride;                // [kTile]
  fold_key* keys = reinterpret_cast<fold_key*>(kk_s + kTile);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int batch = blockIdx.y;
  const int qi = blockIdx.x * (blockDim.x / 32) + warp;
  const bool active = qi < n;
  const float* xb = x + static_cast<size_t>(batch) * n * c;
  fold_key* my = keys + static_cast<size_t>(warp) * F * w;
  const int span = F * w;                  // keys of one chunk
  const bool one_chunk = span >= n;
  int* row = idx + (static_cast<size_t>(batch) * n + qi) * k;
  const float* brow =
      kStats ? btab + (static_cast<size_t>(batch) * n + qi) * cb : nullptr;
  // the running k best (sorted) and the merge's output, when chunked
  fold_key* run = one_chunk || !active
                      ? nullptr
                      : scratch + (static_cast<size_t>(batch) * n + qi) * 2 * k;
  fold_key* merged = run == nullptr ? nullptr : run + k;
  int have = 0;

  // the query row (in every lane) and |q|^2, in K6's order
  float q[QW];
  float qq = 0.f;
  if constexpr (kWide) {
    for (int ch = 0; ch < c; ++ch) {
      const float v = active ? xb[static_cast<size_t>(qi) * c + ch] : 0.f;
      qq = fmaf(v, v, qq);
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < CP; ++ch) {
      q[ch] = (active && ch < c) ? xb[static_cast<size_t>(qi) * c + ch] : 0.f;
      qq = fmaf(q[ch], q[ch], qq);
    }
  }

  const int chunks = kWide ? (c + QW - 1) / QW : 1;
  for (int first = 0; first < n; first += span) {
    // every distance of the chunk: lane l scores rows l and l + 32 of a tile
    const int valid = min(n - first, span);
    for (int base = first; base < first + valid; base += kTile) {
      float dot[2] = {0.f, 0.f};
      for (int cc = 0; cc < chunks; ++cc) {
        const int c0 = cc * QW;
        __syncthreads();  // every thread is done with the previous tile
        for (int e = threadIdx.x; e < kTile * QW; e += blockDim.x) {
          const int r = e / QW, ch = e % QW, j = base + r;
          tile[r * kStride + ch] =
              (j < n && c0 + ch < c) ? xb[static_cast<size_t>(j) * c + c0 + ch]
                                     : 0.f;
        }
        if constexpr (kWide) {
#pragma unroll
          for (int ch = 0; ch < QW; ++ch)
            q[ch] = (active && c0 + ch < c)
                        ? xb[static_cast<size_t>(qi) * c + c0 + ch]
                        : 0.f;
        }
        __syncthreads();
        for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
          float s = cc == 0 ? 0.f : kk_s[r];
#pragma unroll
          for (int ch = 0; ch < QW; ++ch)
            s = fmaf(tile[r * kStride + ch], tile[r * kStride + ch], s);
          kk_s[r] = s;
        }
        if (active) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* krow = tile + (lane + 32 * h) * kStride;
#pragma unroll
            for (int ch = 0; ch < QW; ch += 4) {
              const float4 kv = gfs::load4(krow + ch);
              dot[h] = fmaf(q[ch], kv.x, dot[h]);
              dot[h] = fmaf(q[ch + 1], kv.y, dot[h]);
              dot[h] = fmaf(q[ch + 2], kv.z, dot[h]);
              dot[h] = fmaf(q[ch + 3], kv.w, dot[h]);
            }
          }
        }
      }
      __syncthreads();  // kk_s is complete
      if (active) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lane + 32 * h, j = base + r;
          if (j < n) {
            const float d = gfs::sq_dist(qq, kk_s[r], dot[h]);
            my[j - first] =
                (static_cast<fold_key>(__float_as_uint(d) & 0x7fffffffu)
                 << 32) | static_cast<unsigned>(j);
          }
        }
      }
    }
    if (!active) continue;  // (a block-wide barrier follows, next chunk)

    for (int j = valid + lane; j < span; j += 32) my[j] = kNoKey;
    __syncwarp();
    // sort every column across the folds
    for (int col = lane; col < w; col += 32) {
      fold_key f[F];
#pragma unroll
      for (int i = 0; i < F; ++i) f[i] = my[i * w + col];
      sort_column<F>(f);
#pragma unroll
      for (int i = 0; i < F; ++i) my[i * w + col] = f[i];
    }
    __syncwarp();

    fold_key lmin = kNoKey;
    for (int col = lane; col < w; col += 32)
      lmin = my[col] < lmin ? my[col] : lmin;
    // one pop of the chunk's minimum `best`: the lane that owns its column
    // shifts it up by one fold and rescans
    auto pop = [&](fold_key best) {
      const int col = static_cast<int>(best & 0xffffffffu) - first;
      const int cl = col % w;
      if (lane == cl % 32) {
#pragma unroll
        for (int i = 0; i + 1 < F; ++i) my[i * w + cl] = my[(i + 1) * w + cl];
        my[(F - 1) * w + cl] = kNoKey;
        lmin = kNoKey;
        for (int c2 = lane; c2 < w; c2 += 32)
          lmin = my[c2] < lmin ? my[c2] : lmin;
      }
    };
    auto warp_min = [&]() {
      fold_key best = lmin;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const fold_key o = __shfl_xor_sync(0xffffffffu, best, off);
        best = o < best ? o : best;
      }
      return best;
    };
    if (one_chunk) {
      for (int r = 0; r < k; ++r) {
        const fold_key best = warp_min();
        const int j = static_cast<int>(best & 0xffffffffu);
        if (lane == 0) row[r] = j;
        pop(best);
        if constexpr (kStats) {
          float* srow = scb + (static_cast<size_t>(batch) * n + j) * cb;
          for (int ch = lane; ch < cb; ch += 32)
            atomicAdd(srow + ch, brow[ch]);
          if (lane == 0)
            atomicAdd(cnt + static_cast<size_t>(batch) * n + j, 1.f);
        }
      }
      continue;
    }
    // merge the chunk's pops with the running list (keys are distinct: the
    // index is in their low bits)
    const int len = min(k, have + valid);
    int taken = 0;
    for (int r = 0; r < len; ++r) {
      const fold_key best = warp_min();
      const fold_key old = taken < have ? run[taken] : kNoKey;
      if (best < old) {
        if (lane == 0) merged[r] = best;
        pop(best);
      } else {
        if (lane == 0) merged[r] = old;
        ++taken;
      }
    }
    __syncwarp();
    fold_key* t = run;
    run = merged;
    merged = t;
    have = len;
  }
  if (!active || one_chunk) return;
  for (int r = 0; r < k; ++r) {
    const int j = static_cast<int>(run[r] & 0xffffffffu);
    if (lane == 0) row[r] = j;
    if constexpr (kStats) {
      float* srow = scb + (static_cast<size_t>(batch) * n + j) * cb;
      for (int ch = lane; ch < cb; ch += 32) atomicAdd(srow + ch, brow[ch]);
      if (lane == 0) atomicAdd(cnt + static_cast<size_t>(batch) * n + j, 1.f);
    }
  }
}

// the block's shape for (n, c, folds): warps (queries) per block, columns
// w of one key chunk, shared memory; chunked when one query's row does not
// fit beside the tiles
struct FoldPlan {
  int warps, w;
  size_t smem;
  bool chunked;
};

cudaError_t plan_fold(int n, int c, int folds, FoldPlan* plan) {
  const int qw = c <= 16 ? 16 : 64;
  const size_t fixed = (kTile * (qw + 4) + kTile) * sizeof(float);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int w = (n + folds - 1) / folds;
  const size_t per_warp = static_cast<size_t>(folds) * w * sizeof(fold_key);
  if (fixed + per_warp <= static_cast<size_t>(max_smem)) {
    plan->warps = static_cast<int>(
        std::min<size_t>(kMaxWarps, (max_smem - fixed) / per_warp));
    plan->w = w;
    plan->smem = fixed + plan->warps * per_warp;
    plan->chunked = false;
    return cudaSuccess;
  }
  // chunks of folds x wc keys, wc a multiple of 32, at eight warps
  const size_t keys = (max_smem - fixed) / kMaxWarps / sizeof(fold_key);
  const int wc = static_cast<int>(keys / folds) / 32 * 32;
  if (wc < 32) return cudaErrorInvalidValue;
  plan->warps = kMaxWarps;
  plan->w = wc;
  plan->smem = fixed + static_cast<size_t>(kMaxWarps) * folds * wc *
                           sizeof(fold_key);
  plan->chunked = true;
  return cudaSuccess;
}

template <int CP, int F, bool kStats>
cudaError_t run_fold(const float* x, int* idx, int batch, int n, int c,
                     int k, const float* btab, float* cnt, float* scb, int cb,
                     void* scratch, cudaStream_t s) {
  FoldPlan plan;
  cudaError_t err = plan_fold(n, c, F, &plan);
  if (err != cudaSuccess) return err;
  if (plan.chunked && scratch == nullptr) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(knn_fold_kernel<CP, F, kStats>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(plan.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + plan.warps - 1) / plan.warps, batch);
  knn_fold_kernel<CP, F, kStats><<<grid, plan.warps * 32, plan.smem, s>>>(
      x, idx, n, c, k, plan.w, btab, cnt, scb, cb,
      static_cast<fold_key*>(scratch));
  return cudaGetLastError();
}

template <int F, bool kStats>
cudaError_t run_fold_c(const float* x, int* idx, int batch, int n, int c,
                       int k, const float* btab, float* cnt, float* scb,
                       int cb, void* scratch, cudaStream_t s) {
  if (c <= 16)
    return run_fold<16, F, kStats>(x, idx, batch, n, c, k, btab, cnt, scb, cb,
                                   scratch, s);
  if (c <= 64)
    return run_fold<64, F, kStats>(x, idx, batch, n, c, k, btab, cnt, scb, cb,
                                   scratch, s);
  return run_fold<0, F, kStats>(x, idx, batch, n, c, k, btab, cnt, scb, cb,
                                scratch, s);
}

}  // namespace

namespace gfs {

cudaError_t launch_knn_fold(const float* x, int* idx, int batch, int n, int c,
                            int k, int folds, const float* btab, float* cnt,
                            float* scb, int cb, void* scratch,
                            cudaStream_t s) {
  if (batch < 1 || batch > 65535 || n < 1 || c < 1 || k < 1 || k > n)
    return cudaErrorInvalidValue;
  if (btab != nullptr) {  // K3 for k > 64: four folds
    if (folds != 4 || cb < 1) return cudaErrorInvalidValue;
    return run_fold_c<4, true>(x, idx, batch, n, c, k, btab, cnt, scb, cb,
                               scratch, s);
  }
  switch (folds) {
    case 2:
      return run_fold_c<2, false>(x, idx, batch, n, c, k, nullptr, nullptr,
                                  nullptr, 0, scratch, s);
    case 4:
      return run_fold_c<4, false>(x, idx, batch, n, c, k, nullptr, nullptr,
                                  nullptr, 0, scratch, s);
    case 8:
      return run_fold_c<8, false>(x, idx, batch, n, c, k, nullptr, nullptr,
                                  nullptr, 0, scratch, s);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t knn_fold_scratch_bytes(int batch, int n, int c, int k, int folds,
                                   long long* bytes) {
  if (batch < 1 || n < 1 || c < 1 || k < 1 || k > n ||
      (folds != 2 && folds != 4 && folds != 8))
    return cudaErrorInvalidValue;
  FoldPlan plan;
  const cudaError_t err = plan_fold(n, c, folds, &plan);
  if (err != cudaSuccess) return err;
  *bytes = plan.chunked ? static_cast<long long>(batch) * n * 2 * k *
                              static_cast<long long>(sizeof(fold_key))
                        : 0;
  return cudaSuccess;
}

}  // namespace gfs

// K8. x (B, N, C) fp32, idx (B, N, k) int32: contiguous, on one device;
// folds 2, 4 or 8; scratch: gfs_knn_scratch_bytes(..., folds) bytes, or
// null when that is 0. Returns a cudaError_t.
GFS_EXPORT int gfs_knn_fold(const void* x, void* idx, void* scratch,
                            int batch, int n, int c, int k, int folds,
                            void* stream) {
  return static_cast<int>(gfs::launch_knn_fold(
      static_cast<const float*>(x), static_cast<int*>(idx), batch, n, c, k,
      folds, nullptr, nullptr, nullptr, 0, scratch,
      static_cast<cudaStream_t>(stream)));
}
