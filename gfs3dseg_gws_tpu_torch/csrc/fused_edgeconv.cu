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
//    k hold -inf and are never displaced by a key, only by the shift
//    below it (their contents are never read). A key tile is first scored and
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
// Widths and neighbour counts. The kernels above are the fast path, for
// C, W0, W1 <= 64 and k <= 32 (the model's widths). Past those:
// * C > 64: knn_kernel<0, ...> streams the channels through keys_s in
//   chunks of 64; the partial dot products wait in cand_d and |k|^2 in kk_s
//   until the last chunk, and the fmaf chains run over the channels in the
//   same order, so a distance is the one a single pass would give;
// * 32 < k <= 64: knn_kernel<CP, 64, ...>, the same chain over 64 slots;
// * k > 64: K8's fold-merge selection (csrc/knn_fold.cu, four folds), which
//   holds each query's key row in shared memory, in chunks merged through
//   the caller's scratch past N ~ 27,000; for K3 it adds the statistics
//   itself;
// * W0 or W1 > 64: edge_mlp_kernel<true> takes 64 output columns per block
//   (grid z) and walks W0 in chunks of 64 through e_s and w2_s, carrying
//   the GEMM accumulators across the chunks.
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
constexpr int kMaxK = 32;    // neighbour slots of the fast path's chain
constexpr int kWideK = 64;   // ... of its second instantiation
constexpr int kFolds = 4;    // K8's folds for k > kWideK
constexpr int kMaxW = 64;    // a/b table (W0) and output (W1) channels per tile
constexpr int kMaxC = 64;    // input channels held in registers
constexpr int kChunk = 4;    // neighbours per edge-GEMM step
constexpr int kRows = kTileQ * kChunk;   // edge rows per step (256)
constexpr int kMlpThreads = 256;         // 32 query pairs x 8 column groups
constexpr size_t kMlpSmem =
    (static_cast<size_t>(kMaxW) * kRows + kMaxW * kMaxW + kMaxW) *
    sizeof(float);

// CP: input width padded with zeros to a multiple of 4, or 0 for C > 64
// (streamed in chunks of kMaxC); KMAX: slots of the insertion chain (k <=
// KMAX); kStats: also scatter the neighbour statistics of btab (B, N, cb)
// into cnt (B, N) and scb (B, N, cb), which the caller has zeroed (K3)
template <int CP, int KMAX, bool kStats>
__global__ void __launch_bounds__(kTileQ)
knn_kernel(const float* __restrict__ x, int* __restrict__ idx, int n, int c,
           int k, const float* __restrict__ btab, float* __restrict__ cnt,
           float* __restrict__ scb, int cb) {
  constexpr bool kWide = CP == 0;
  constexpr int QW = kWide ? kMaxC : CP;   // channels held at once
  // the fast path keeps its lists here for the statistics; the others read
  // them back from idx
  constexpr bool kNbrSmem = kStats && KMAX == kMaxK;
  __shared__ __align__(16) float keys_s[kTileK][QW];
  __shared__ int nbr_s[kNbrSmem ? kTileQ : 1][KMAX];
  __shared__ float kk_s[kTileK];
  // this tile's candidates of each query ([slot][query]: no bank conflicts)
  __shared__ float cand_d[kTileK][kTileQ];
  __shared__ unsigned char cand_r[kTileK][kTileQ];

  const int tid = threadIdx.x;
  const int batch = blockIdx.y;
  const int qi = blockIdx.x * kTileQ + tid;
  const bool active = qi < n;
  const float* xb = x + static_cast<size_t>(batch) * n * c;

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
  float best_d[KMAX];
  int best_i[KMAX];
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    best_d[t] = t < k ? INFINITY : -INFINITY;
    best_i[t] = 0;
  }
  float thr = INFINITY;  // always best_d[k - 1]

  for (int base = 0; base < n; base += kTileK) {
    const int nk = min(kTileK, n - base);
    int cnt = 0;
    if constexpr (!kWide) {
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
        for (int ch = 0; ch < CP; ++ch)
          s = fmaf(keys_s[r][ch], keys_s[r][ch], s);
        kk_s[r] = s;
      }
      __syncthreads();
      if (!active) continue;
      // score the tile and keep, without branching, the keys that beat the
      // threshold as it stood at the tile's start ...
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
          const float d = gfs::sq_dist(qq, kk_s[r + u], dot[u]);
          cand_d[cnt][tid] = d;
          cand_r[cnt][tid] = static_cast<unsigned char>(r + u);
          cnt += (r + u < nk && d < thr) ? 1 : 0;
        }
      }
    } else {
      // the channels in chunks: partial dots in cand_d[r][tid], partial
      // |k|^2 in kk_s[r], both carried from chunk to chunk
      for (int c0 = 0; c0 < c; c0 += kMaxC) {
        __syncthreads();  // every thread is done with the previous chunk
        for (int e = tid; e < kTileK * kMaxC; e += kTileQ) {
          const int r = e / kMaxC, ch = e % kMaxC;
          const int j = base + r;
          keys_s[r][ch] = (j < n && c0 + ch < c)
                              ? xb[static_cast<size_t>(j) * c + c0 + ch]
                              : 0.f;
        }
#pragma unroll
        for (int ch = 0; ch < kMaxC; ++ch)
          q[ch] = (active && c0 + ch < c)
                      ? xb[static_cast<size_t>(qi) * c + c0 + ch]
                      : 0.f;
        __syncthreads();
        {
          float s = c0 == 0 ? 0.f : kk_s[tid];   // row tid (kTileK == kTileQ)
#pragma unroll
          for (int ch = 0; ch < kMaxC; ++ch)
            s = fmaf(keys_s[tid][ch], keys_s[tid][ch], s);
          kk_s[tid] = s;
        }
        if (!active) continue;
        for (int r = 0; r < nk; r += 4) {
          float dot[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) dot[u] = c0 == 0 ? 0.f : cand_d[r + u][tid];
#pragma unroll
          for (int ch = 0; ch < kMaxC; ch += 4) {
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
          for (int u = 0; u < 4; ++u) cand_d[r + u][tid] = dot[u];
        }
      }
      __syncthreads();  // kk_s is complete
      if (!active) continue;
      // compact in place (slot cnt <= r is read before it is written)
      for (int r = 0; r < nk; ++r) {
        const float d = gfs::sq_dist(qq, kk_s[r], cand_d[r][tid]);
        cand_d[cnt][tid] = d;
        cand_r[cnt][tid] = static_cast<unsigned char>(r);
        cnt += d < thr ? 1 : 0;
      }
    }
    // ... then insert them in key order. A warp runs the insertion chain
    // as often as its busiest lane has candidates, instead of once for
    // every key that any of its 32 lanes would insert.
    // A key goes after every listed key at its distance (keys come in
    // index order), and once it takes a slot every later entry moves down
    // one: the list stays ordered by (distance, index).
    for (int i = 0; i < cnt; ++i) {
      float cd = cand_d[i][tid];
      if (cd < thr) {
        int ci = base + cand_r[i][tid];
        bool shifting = false;
#pragma unroll
        for (int t = 0; t < KMAX; ++t) {
          if (shifting || cd < best_d[t]) {
            const float td = best_d[t];
            const int ti = best_i[t];
            best_d[t] = cd;
            best_i[t] = ci;
            cd = td;
            ci = ti;
            shifting = true;
          }
        }
#pragma unroll
        for (int t = 0; t < KMAX; ++t)
          if (t == k - 1) thr = best_d[t];
      }
    }
  }
  if (active) {
    int* row = idx + (static_cast<size_t>(batch) * n + qi) * k;
#pragma unroll
    for (int t = 0; t < KMAX; ++t) {
      if (t < k) {
        row[t] = best_i[t];
        if constexpr (kNbrSmem) nbr_s[tid][t] = best_i[t];
      }
    }
  }
  if constexpr (kStats) {
    __syncthreads();  // the block's idx rows (or nbr_s) are complete
    const int lane = tid % 32, warp = tid / 32;
    const int q0 = blockIdx.x * kTileQ;
    const int pairs = min(kTileQ, n - q0) * k;
    const float* b_b = btab + static_cast<size_t>(batch) * n * cb;
    float* scb_b = scb + static_cast<size_t>(batch) * n * cb;
    const int* idx_b = idx + (static_cast<size_t>(batch) * n + q0) * k;
    for (int pr = warp; pr < pairs; pr += kTileQ / 32) {
      const int q = pr / k;
      int j;
      if constexpr (kNbrSmem)
        j = nbr_s[q][pr - q * k];
      else
        j = idx_b[pr];
      const float* brow = b_b + static_cast<size_t>(q0 + q) * cb;
      float* srow = scb_b + static_cast<size_t>(j) * cb;
      for (int ch = lane; ch < cb; ch += 32) atomicAdd(srow + ch, brow[ch]);
      if (lane == 0) atomicAdd(cnt + static_cast<size_t>(batch) * n + j, 1.f);
    }
  }
}

// acc[8][8] += e_s rows 8p .. 8p + 7 times w2_s columns 8cg .. 8cg + 7 over
// kMaxW channels
__device__ __forceinline__ void edge_gemm(const float* e_s, const float* w2_s,
                                          int p, int cg, float (&acc)[8][8]) {
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
}

// kWide: W0 or W1 above kMaxW; the block takes output columns col0 ..
// col0 + 63 (col0 = 64 blockIdx.z) and W0 in chunks of kMaxW
template <bool kWide>
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
  const int col0 = kWide ? blockIdx.z * kMaxW : 0;
  // GEMM tile of this thread: edge rows 8p..8p+7 (queries 2p, 2p+1 times
  // kChunk neighbours) by output channels 8cg..8cg+7
  const int p = tid / 8, cg = tid % 8;

  if constexpr (!kWide) {
    for (int e = tid; e < kMaxW * kMaxW; e += kMlpThreads) {
      const int r = e / kMaxW, o = e % kMaxW;
      w2_s[e] = (r < w0 && o < w1) ? w2[r * w1 + o] : 0.f;
    }
  }
  for (int o = tid; o < kMaxW; o += kMlpThreads)
    bias_s[o] = col0 + o < w1 ? bias2[col0 + o] : 0.f;

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
    const int t = t0 + r_own % kChunk;
    const bool ok = q_own_ok && t < k;
    const float* a_row = a_b + static_cast<size_t>(ok ? idx_row[t] : 0) * w0;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int c0 = 0; c0 < (kWide ? w0 : 1); c0 += kMaxW) {
      __syncthreads();  // the previous GEMM is done with e_s (and w2_s)
      for (int ch = 0; ch < kMaxW; ++ch)
        e_s[ch * kRows + r_own] =
            (ok && c0 + ch < w0)
                ? gfs::leaky(a_row[c0 + ch] + b_row[c0 + ch], neg_slope)
                : 0.f;
      if constexpr (kWide) {
        for (int e = tid; e < kMaxW * kMaxW; e += kMlpThreads) {
          const int r = e / kMaxW, o = e % kMaxW;
          w2_s[e] = (c0 + r < w0 && col0 + o < w1)
                        ? w2[static_cast<size_t>(c0 + r) * w1 + col0 + o]
                        : 0.f;
        }
      }
      __syncthreads();
      edge_gemm(e_s, w2_s, p, cg, acc);
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
    float* orow = out + (static_cast<size_t>(batch) * n + qi) * w1 + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (col0 + 8 * cg + j < w1) orow[8 * cg + j] = mx[i][j];
  }
}

template <int CP, int KMAX, bool kStats>
cudaError_t run_knn(const float* x, int* idx, int batch, int n, int c, int k,
                    const float* btab, float* cnt, float* scb, int cb,
                    cudaStream_t s) {
  const dim3 grid((n + kTileQ - 1) / kTileQ, batch);
  knn_kernel<CP, KMAX, kStats><<<grid, kTileQ, 0, s>>>(x, idx, n, c, k, btab,
                                                       cnt, scb, cb);
  return cudaGetLastError();
}

template <int KMAX, bool kStats>
cudaError_t run_knn_c(const float* x, int* idx, int batch, int n, int c,
                      int k, const float* btab, float* cnt, float* scb,
                      int cb, cudaStream_t s) {
  if (c <= 16)
    return run_knn<16, KMAX, kStats>(x, idx, batch, n, c, k, btab, cnt, scb,
                                     cb, s);
  if (c <= kMaxC)
    return run_knn<64, KMAX, kStats>(x, idx, batch, n, c, k, btab, cnt, scb,
                                     cb, s);
  return run_knn<0, KMAX, kStats>(x, idx, batch, n, c, k, btab, cnt, scb, cb,
                                  s);
}

// the kNN stage over (batch, n, c): idx (B, N, k), nearest first; with btab
// also the neighbour statistics (K3). The variant follows c and k.
cudaError_t launch_knn(const float* x, int* idx, int batch, int n, int c,
                       int k, void* scratch, cudaStream_t s,
                       const float* btab = nullptr, float* cnt = nullptr,
                       float* scb = nullptr, int cb = 0) {
  const bool stats = btab != nullptr;
  if (k <= kMaxK)
    return stats ? run_knn_c<kMaxK, true>(x, idx, batch, n, c, k, btab, cnt,
                                          scb, cb, s)
                 : run_knn_c<kMaxK, false>(x, idx, batch, n, c, k, btab, cnt,
                                           scb, cb, s);
  if (k <= kWideK)
    return stats ? run_knn_c<kWideK, true>(x, idx, batch, n, c, k, btab, cnt,
                                           scb, cb, s)
                 : run_knn_c<kWideK, false>(x, idx, batch, n, c, k, btab,
                                            cnt, scb, cb, s);
  return gfs::launch_knn_fold(x, idx, batch, n, c, k, kFolds, btab, cnt, scb,
                              cb, scratch, s);
}

// edge_mlp_kernel on given indices: out (B, N, w1)
cudaError_t launch_edge_mlp(const int* idx, const float* a_table,
                            const float* b_table, const float* w2,
                            const float* bias2, float* out, int batch, int n,
                            int w0, int w1, int k, float neg_slope,
                            cudaStream_t s) {
  const bool wide = w0 > kMaxW || w1 > kMaxW;
  cudaError_t err = cudaFuncSetAttribute(
      wide ? edge_mlp_kernel<true> : edge_mlp_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMlpSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTileQ - 1) / kTileQ, batch,
                  wide ? (w1 + kMaxW - 1) / kMaxW : 1);
  if (wide)
    edge_mlp_kernel<true><<<grid, kMlpThreads, kMlpSmem, s>>>(
        idx, a_table, b_table, w2, bias2, out, n, w0, w1, k, neg_slope);
  else
    edge_mlp_kernel<false><<<grid, kMlpThreads, kMlpSmem, s>>>(
        idx, a_table, b_table, w2, bias2, out, n, w0, w1, k, neg_slope);
  return cudaGetLastError();
}

bool bad_sizes(int batch, int n, int k) {
  return batch < 1 || batch > 65535 || n < 1 || k < 1 || k > n;
}

}  // namespace

// The bytes of scratch that K1, K3 and K6 (folds 0) or K8 (folds 2, 4, 8)
// need at this shape on the current device, into *bytes: 0 unless the
// kNN runs K8's selection in chunks (k > 64 and a key row too long for
// shared memory). Returns a cudaError_t.
GFS_EXPORT int gfs_knn_scratch_bytes(int batch, int n, int c, int k,
                                     int folds, long long* bytes) {
  *bytes = 0;
  if (folds == 0) {
    if (k <= kWideK) return static_cast<int>(cudaSuccess);
    folds = kFolds;
  }
  return static_cast<int>(
      gfs::knn_fold_scratch_bytes(batch, n, c, k, folds, bytes));
}

// K1. x (B, N, C), a_table and b_table (B, N, W0), w2 (W0, W1), bias2 (W1),
// out (B, N, W1) fp32 and the scratch idx (B, N, k) int32: contiguous, on
// one device; scratch: gfs_knn_scratch_bytes(..., 0) bytes, or null when
// that is 0 (likewise for K6 and K3 below). Returns a cudaError_t.
GFS_EXPORT int gfs_fused_edgeconv_infer(const void* x, const void* a_table,
                                        const void* b_table, const void* w2,
                                        const void* bias2, void* idx,
                                        void* scratch, void* out, int batch,
                                        int n, int c,
                                        int w0, int w1, int k,
                                        float neg_slope, void* stream) {
  if (bad_sizes(batch, n, k) || c < 1 || w0 < 1 || w1 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* ix = static_cast<int*>(idx);
  cudaError_t err =
      launch_knn(static_cast<const float*>(x), ix, batch, n, c, k, scratch,
                 s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_edge_mlp(
      ix, static_cast<const float*>(a_table),
      static_cast<const float*>(b_table), static_cast<const float*>(w2),
      static_cast<const float*>(bias2), static_cast<float*>(out), batch, n,
      w0, w1, k, neg_slope, s));
}

// K6: K1's first stage alone. x (B, N, C) fp32, idx (B, N, k) int32:
// contiguous, on one device. Returns a cudaError_t.
GFS_EXPORT int gfs_knn_indices(const void* x, void* idx, void* scratch,
                               int batch, int n, int c, int k, void* stream) {
  if (bad_sizes(batch, n, k) || c < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_knn(static_cast<const float*>(x),
                                     static_cast<int*>(idx), batch, n, c, k,
                                     scratch,
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
  if (bad_sizes(batch, n, k) || w0 < 1 || w1 < 1)
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
                                  void* cnt, void* scb, void* scratch,
                                  int batch, int n, int c, int cb, int k,
                                  void* stream) {
  if (bad_sizes(batch, n, k) || c < 1 || cb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_knn(
      static_cast<const float*>(x), static_cast<int*>(idx), batch, n, c, k,
      scratch, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(btab), static_cast<float*>(cnt),
      static_cast<float*>(scb), cb));
}
