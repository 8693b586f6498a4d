// K1: the fused eval-mode EdgeConv block, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel gfs3dseg_gws_tpu/ops/fused_edgeconv.py::
// fused_edgeconv_infer (its Pallas body `_fused_kernel`). One call computes
// a whole eval EdgeConv block whose BatchNorms the caller has folded into
// a_table, b_table, W2 and bias2:
//
//   d2[i, j] = max(|x_i|^2 + |x_j|^2 - 2 x_i . x_j, 0)       exact fp32
//   nbr(i)   = the k smallest d2[i, :], self included (ties: lower index)
//   out[i]   = max over j in nbr(i) of leaky(leaky(a[j] + b[i]) @ W2 + bias2)
//
// What is read is x, the two tables, W2 and bias2; what is written is
// (B, N, W1) and the (B, N, k) neighbour indices in between. No (B, N, N)
// distance matrix and no (B, N, K, C) edge tensor ever exists in device
// memory. Everything is fp32: the TPU kernel's bf16 rounding and its
// one-hot matmul "gather" (a Mosaic workaround) are not carried over.
//
// What bounds it: fp32 FMAs. At B=16, N=2048, C=64, k=20 the distances are
// 4.3 G FMAs and the per-edge 64x64 layer 2.7 G FMAs, while the bytes read
// are a few MB that stay in L2. The two stages want different register
// budgets, so they are two kernels launched back to back:
//
// 1. knn_kernel: one block per (batch, kTileQ queries), one thread per query.
//    The query's row of x and its sorted top-k list live in registers; key
//    rows stream through shared memory kTileK at a time (the 512 KB of keys
//    of one batch element do not fit in the 227 KB a block may use) and are
//    read as broadcast float4 loads, one load feeding four FMAs in every
//    lane, with four keys scored at once for four independent FMA chains.
//    Insertion is a fixed compare-and-swap chain that the compiler unrolls
//    over kMaxK slots, so the list never leaves registers; slots at or past
//    k hold -inf and are never displaced. A key tile is first scored and
//    filtered against the threshold without branching, and only the
//    survivors go through the chain, so a warp pays for its busiest lane's
//    survivors rather than for every key that any lane would insert.
//
// 2. edge_mlp_kernel: the per-edge layer as a register-tiled fp32 GEMM. A
//    block takes kTileQ queries and walks their neighbours kChunk at a time:
//    it builds the chunk's edge rows e = leaky(a[j] + b[i]) in shared memory
//    (kTileQ * kChunk rows of up to 64 channels, transposed), multiplies
//    them by W2 (in shared memory) with each thread owning an 8 x 8 output
//    tile - the 8 edges of 2 queries x 4 neighbours by 8 output channels,
//    so four float4 loads feed 64 FMAs - and folds bias, LeakyReLU and the
//    max over the neighbours into its 2 x 8 running maxima.
//
// Ragged N is masked here, not by the caller: key rows past N are never
// inserted, and queries past N are computed on zeros and never stored.
//
// K3: knn_kernel<CP, true> is the training path's kNN with neighbour
// statistics, replacing the TPU kernel gfs3dseg_gws_tpu/ops/knn.py::
// knn_with_stats (its Pallas body `_knn_stats_kernel`). After the same
// top-k it writes idx and then, for every (query i, neighbour j) pair of
// its tile, adds 1 to cnt[j] and the row b[i, :] to scb[j, :]:
//
//   cnt[j]    = |{(i, r) : idx[i, r] == j}|          (in-degree, exact)
//   scb[j, :] = sum over those (i, r) of b[i, :]     (transposed b-scatter)
//
// The block's two warps walk its pairs, one pair per warp at a time, the
// lanes over the channels, so each float atomicAdd instruction of a warp
// hits one row of scb in consecutive words. The order of the additions
// varies from run to run, and so do the last bits of scb; cnt holds small
// integers and is exact. At k = 20 and Cb = 64 the scatter is 1,280
// float atomics per query, against the kNN's 2,048 x C distance FMAs.
//
// K6 and K9 are K1's two stages, each behind an entry of its own:
// gfs_knn_indices launches knn_kernel<CP, false> alone and replaces the TPU
// kernel gfs3dseg_gws_tpu/ops/knn.py::knn_indices (`_knn_pallas`, body
// `_knn_kernel`); gfs_gather_conv launches edge_mlp_kernel alone on given
// indices and replaces ops/fused_edgeconv.py::fused_edgeconv_infer_split
// (body `_gather_conv_kernel`). All three entries share the two launch
// helpers, so K6 then K9 computes what K1 computes, bit for bit. K6 is
// bound by its B N^2 C distance FMAs, K9 by its B N k W0 W1 edge-layer FMAs.
#include "common.cuh"

namespace {

constexpr int kTileQ = 64;   // queries per block
constexpr int kTileK = 64;   // key rows per shared-memory tile (multiple of 4)
constexpr int kMaxK = 32;    // largest neighbour count
constexpr int kMaxW = 64;    // widest a/b table (W0) and output (W1)
constexpr int kMaxC = 64;    // widest input x
constexpr int kChunk = 4;    // neighbours per edge-GEMM step
constexpr int kRows = kTileQ * kChunk;   // edge rows per step (256)
constexpr int kMlpThreads = 256;         // 32 query pairs x 8 column groups
constexpr size_t kMlpSmem =
    (static_cast<size_t>(kMaxW) * kRows + kMaxW * kMaxW + kMaxW) *
    sizeof(float);

// CP: input width padded with zeros to a multiple of 4; kStats: also
// scatter the neighbour statistics of btab (B, N, cb) into cnt (B, N) and
// scb (B, N, cb), which the caller has zeroed (K3)
template <int CP, bool kStats>
__global__ void __launch_bounds__(kTileQ)
knn_kernel(const float* __restrict__ x, int* __restrict__ idx, int n, int c,
           int k, const float* __restrict__ btab, float* __restrict__ cnt,
           float* __restrict__ scb, int cb) {
  __shared__ __align__(16) float keys_s[kTileK][CP];
  __shared__ int nbr_s[kStats ? kTileQ : 1][kMaxK];
  __shared__ float kk_s[kTileK];
  // this tile's candidates of each query ([slot][query]: no bank conflicts)
  __shared__ float cand_d[kTileK][kTileQ];
  __shared__ unsigned char cand_r[kTileK][kTileQ];

  const int tid = threadIdx.x;
  const int batch = blockIdx.y;
  const int qi = blockIdx.x * kTileQ + tid;
  const bool active = qi < n;
  const float* xb = x + static_cast<size_t>(batch) * n * c;

  float q[CP];
  float qq = 0.f;
#pragma unroll
  for (int ch = 0; ch < CP; ++ch) {
    q[ch] = (active && ch < c) ? xb[static_cast<size_t>(qi) * c + ch] : 0.f;
    qq = fmaf(q[ch], q[ch], qq);
  }
  float best_d[kMaxK];
  int best_i[kMaxK];
#pragma unroll
  for (int t = 0; t < kMaxK; ++t) {
    best_d[t] = t < k ? INFINITY : -INFINITY;
    best_i[t] = 0;
  }
  float thr = INFINITY;  // always best_d[k - 1]

  for (int base = 0; base < n; base += kTileK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < kTileK * CP; e += kTileQ) {
      const int r = e / CP, ch = e % CP;
      const int j = base + r;
      keys_s[r][ch] =
          (j < n && ch < c) ? xb[static_cast<size_t>(j) * c + ch] : 0.f;
    }
    __syncthreads();
    for (int r = tid; r < kTileK; r += kTileQ) {
      float s = 0.f;
#pragma unroll
      for (int ch = 0; ch < CP; ++ch) s = fmaf(keys_s[r][ch], keys_s[r][ch], s);
      kk_s[r] = s;
    }
    __syncthreads();
    if (!active) continue;
    const int nk = min(kTileK, n - base);
    // score the tile and keep, without branching, the keys that beat the
    // threshold as it stood at the tile's start ...
    int cnt = 0;
    for (int r = 0; r < nk; r += 4) {
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ch = 0; ch < CP; ch += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 kv = gfs::load4(&keys_s[r + u][ch]);
          dot[u] = fmaf(q[ch], kv.x, dot[u]);
          dot[u] = fmaf(q[ch + 1], kv.y, dot[u]);
          dot[u] = fmaf(q[ch + 2], kv.z, dot[u]);
          dot[u] = fmaf(q[ch + 3], kv.w, dot[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float d = fmaxf(qq + kk_s[r + u] - 2.f * dot[u], 0.f);
        cand_d[cnt][tid] = d;
        cand_r[cnt][tid] = static_cast<unsigned char>(r + u);
        cnt += (r + u < nk && d < thr) ? 1 : 0;
      }
    }
    // ... then insert them in key order. A warp runs the insertion chain
    // as often as its busiest lane has candidates, instead of once for
    // every key that any of its 32 lanes would insert.
    for (int i = 0; i < cnt; ++i) {
      float cd = cand_d[i][tid];
      if (cd < thr) {
        int ci = base + cand_r[i][tid];
#pragma unroll
        for (int t = 0; t < kMaxK; ++t) {
          if (cd < best_d[t]) {
            const float td = best_d[t];
            const int ti = best_i[t];
            best_d[t] = cd;
            best_i[t] = ci;
            cd = td;
            ci = ti;
          }
        }
#pragma unroll
        for (int t = 0; t < kMaxK; ++t)
          if (t == k - 1) thr = best_d[t];
      }
    }
  }
  if (active) {
    int* row = idx + (static_cast<size_t>(batch) * n + qi) * k;
#pragma unroll
    for (int t = 0; t < kMaxK; ++t) {
      if (t < k) {
        row[t] = best_i[t];
        if constexpr (kStats) nbr_s[tid][t] = best_i[t];
      }
    }
  }
  if constexpr (kStats) {
    __syncthreads();
    const int lane = tid % 32, warp = tid / 32;
    const int q0 = blockIdx.x * kTileQ;
    const int pairs = min(kTileQ, n - q0) * k;
    const float* b_b = btab + static_cast<size_t>(batch) * n * cb;
    float* scb_b = scb + static_cast<size_t>(batch) * n * cb;
    for (int pr = warp; pr < pairs; pr += kTileQ / 32) {
      const int q = pr / k;
      const int j = nbr_s[q][pr - q * k];
      const float* brow = b_b + static_cast<size_t>(q0 + q) * cb;
      float* srow = scb_b + static_cast<size_t>(j) * cb;
      for (int ch = lane; ch < cb; ch += 32) atomicAdd(srow + ch, brow[ch]);
      if (lane == 0) atomicAdd(cnt + static_cast<size_t>(batch) * n + j, 1.f);
    }
  }
}

__global__ void __launch_bounds__(kMlpThreads)
edge_mlp_kernel(const int* __restrict__ idx, const float* __restrict__ a_table,
                const float* __restrict__ b_table,
                const float* __restrict__ w2, const float* __restrict__ bias2,
                float* __restrict__ out, int n, int w0, int w1, int k,
                float neg_slope) {
  extern __shared__ __align__(16) float smem[];
  float* e_s = smem;                       // [kMaxW][kRows]: e_s[ch*kRows+r]
  float* w2_s = e_s + kMaxW * kRows;       // [kMaxW][kMaxW], zero padded
  float* bias_s = w2_s + kMaxW * kMaxW;    // [kMaxW], zero padded

  const int tid = threadIdx.x;
  const int batch = blockIdx.y;
  const int q_base = blockIdx.x * kTileQ;
  // GEMM tile of this thread: edge rows 8p..8p+7 (queries 2p, 2p+1 times
  // kChunk neighbours) by output channels 8cg..8cg+7
  const int p = tid / 8, cg = tid % 8;

  for (int e = tid; e < kMaxW * kMaxW; e += kMlpThreads) {
    const int r = e / kMaxW, o = e % kMaxW;
    w2_s[e] = (r < w0 && o < w1) ? w2[r * w1 + o] : 0.f;
  }
  for (int o = tid; o < kMaxW; o += kMlpThreads)
    bias_s[o] = o < w1 ? bias2[o] : 0.f;

  // the edge row this thread builds in each step: query r / kChunk,
  // neighbour slot r % kChunk of the step
  const int r_own = tid;
  const int q_own = q_base + r_own / kChunk;
  const bool q_own_ok = q_own < n;
  const float* b_row =
      b_table + (static_cast<size_t>(batch) * n + (q_own_ok ? q_own : 0)) * w0;
  const float* a_b = a_table + static_cast<size_t>(batch) * n * w0;
  const int* idx_row =
      idx + (static_cast<size_t>(batch) * n + (q_own_ok ? q_own : 0)) * k;

  float mx[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) mx[i][j] = -INFINITY;

  for (int t0 = 0; t0 < k; t0 += kChunk) {
    __syncthreads();  // previous step's GEMM is done with e_s
    {
      const int t = t0 + r_own % kChunk;
      const bool ok = q_own_ok && t < k;
      const float* a_row = a_b + static_cast<size_t>(ok ? idx_row[t] : 0) * w0;
      for (int ch = 0; ch < kMaxW; ++ch)
        e_s[ch * kRows + r_own] =
            (ok && ch < w0) ? gfs::leaky(a_row[ch] + b_row[ch], neg_slope)
                            : 0.f;
    }
    __syncthreads();

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int ch = 0; ch < kMaxW; ++ch) {
      const float4 a0 = gfs::load4(&e_s[ch * kRows + 8 * p]);
      const float4 a1 = gfs::load4(&e_s[ch * kRows + 8 * p + 4]);
      const float4 b0 = gfs::load4(&w2_s[ch * kMaxW + 8 * cg]);
      const float4 b1 = gfs::load4(&w2_s[ch * kMaxW + 8 * cg + 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // rows 0-3: query 2p, rows 4-7: query 2p+1; row % kChunk = neighbour
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (t0 + i % kChunk < k) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx[i / kChunk][j] = fmaxf(
              mx[i / kChunk][j],
              gfs::leaky(acc[i][j] + bias_s[8 * cg + j], neg_slope));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q_base + 2 * p + i;
    if (qi >= n) continue;
    float* orow = out + (static_cast<size_t>(batch) * n + qi) * w1;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * cg + j < w1) orow[8 * cg + j] = mx[i][j];
  }
}

// knn_kernel<CP, false> over (batch, n, c): idx (B, N, k), nearest first
cudaError_t launch_knn(const float* x, int* idx, int batch, int n, int c,
                       int k, cudaStream_t s) {
  const dim3 grid((n + kTileQ - 1) / kTileQ, batch);
  if (c <= 16)
    knn_kernel<16, false><<<grid, kTileQ, 0, s>>>(x, idx, n, c, k, nullptr,
                                                  nullptr, nullptr, 0);
  else
    knn_kernel<64, false><<<grid, kTileQ, 0, s>>>(x, idx, n, c, k, nullptr,
                                                  nullptr, nullptr, 0);
  return cudaGetLastError();
}

// edge_mlp_kernel on given indices: out (B, N, w1)
cudaError_t launch_edge_mlp(const int* idx, const float* a_table,
                            const float* b_table, const float* w2,
                            const float* bias2, float* out, int batch, int n,
                            int w0, int w1, int k, float neg_slope,
                            cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      edge_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMlpSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTileQ - 1) / kTileQ, batch);
  edge_mlp_kernel<<<grid, kMlpThreads, kMlpSmem, s>>>(
      idx, a_table, b_table, w2, bias2, out, n, w0, w1, k, neg_slope);
  return cudaGetLastError();
}

bool bad_sizes(int batch, int n, int k) {
  return batch < 1 || batch > 65535 || n < 1 || k < 1 || k > kMaxK || k > n;
}

}  // namespace

// K1. x (B, N, C), a_table and b_table (B, N, W0), w2 (W0, W1), bias2 (W1),
// out (B, N, W1) fp32 and the scratch idx (B, N, k) int32: contiguous, on
// one device. Returns a cudaError_t.
GFS_EXPORT int gfs_fused_edgeconv_infer(const void* x, const void* a_table,
                                        const void* b_table, const void* w2,
                                        const void* bias2, void* idx,
                                        void* out, int batch, int n, int c,
                                        int w0, int w1, int k,
                                        float neg_slope, void* stream) {
  if (bad_sizes(batch, n, k) || c < 1 || c > kMaxC || w0 < 1 || w0 > kMaxW ||
      w1 < 1 || w1 > kMaxW)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* ix = static_cast<int*>(idx);
  cudaError_t err =
      launch_knn(static_cast<const float*>(x), ix, batch, n, c, k, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_edge_mlp(
      ix, static_cast<const float*>(a_table),
      static_cast<const float*>(b_table), static_cast<const float*>(w2),
      static_cast<const float*>(bias2), static_cast<float*>(out), batch, n,
      w0, w1, k, neg_slope, s));
}

// K6: K1's first stage alone. x (B, N, C) fp32, idx (B, N, k) int32:
// contiguous, on one device. Returns a cudaError_t.
GFS_EXPORT int gfs_knn_indices(const void* x, void* idx, int batch, int n,
                               int c, int k, void* stream) {
  if (bad_sizes(batch, n, k) || c < 1 || c > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_knn(static_cast<const float*>(x),
                                     static_cast<int*>(idx), batch, n, c, k,
                                     static_cast<cudaStream_t>(stream)));
}

// K9: K1's second stage alone on given indices. idx (B, N, k) int32 with
// entries in [0, N), a_table and b_table (B, N, W0), w2 (W0, W1), bias2
// (W1), out (B, N, W1) fp32: contiguous, on one device. Returns a
// cudaError_t.
GFS_EXPORT int gfs_gather_conv(const void* idx, const void* a_table,
                               const void* b_table, const void* w2,
                               const void* bias2, void* out, int batch, int n,
                               int w0, int w1, int k, float neg_slope,
                               void* stream) {
  if (bad_sizes(batch, n, k) || w0 < 1 || w0 > kMaxW || w1 < 1 || w1 > kMaxW)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_edge_mlp(
      static_cast<const int*>(idx), static_cast<const float*>(a_table),
      static_cast<const float*>(b_table), static_cast<const float*>(w2),
      static_cast<const float*>(bias2), static_cast<float*>(out), batch, n,
      w0, w1, k, neg_slope, static_cast<cudaStream_t>(stream)));
}

// K3. x (B, N, C) and btab (B, N, Cb) fp32, idx (B, N, k) int32, cnt (B, N)
// and scb (B, N, Cb) fp32 zeroed by the caller: contiguous, on one device.
// Returns a cudaError_t.
GFS_EXPORT int gfs_knn_with_stats(const void* x, const void* btab, void* idx,
                                  void* cnt, void* scb, int batch, int n,
                                  int c, int cb, int k, void* stream) {
  if (bad_sizes(batch, n, k) || c < 1 || c > kMaxC || cb < 1 || cb > kMaxW)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kTileQ - 1) / kTileQ, batch);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(btab);
  auto* ix = static_cast<int*>(idx);
  auto* cf = static_cast<float*>(cnt);
  auto* sf = static_cast<float*>(scb);
  if (c <= 16)
    knn_kernel<16, true><<<grid, kTileQ, 0, s>>>(xf, ix, n, c, k, bf, cf, sf,
                                                 cb);
  else
    knn_kernel<64, true><<<grid, kTileQ, 0, s>>>(xf, ix, n, c, k, bf, cf, sf,
                                                 cb);
  return static_cast<int>(cudaGetLastError());
}
