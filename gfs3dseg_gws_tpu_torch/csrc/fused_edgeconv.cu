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
// What bounds it: operations. At B=16, N=2048, C=64, k=20 the distances are
// 4.3 G fp32 FMAs and the per-edge 64x64 layer 2.7 G FMAs (in 3xTF32 on the
// tensor cores, three TF32 products each), while the bytes read are a few
// MB that stay in L2. The two stages want different register budgets, so
// they are two kernels launched back to back:
//
// 1. knn_split_kernel (C <= 64, k <= 32): one block of kSplitThreads (8
//    warps) per (batch, Q queries), S threads per query (S = 2, Q = 128;
//    S = 4, Q = 64 for K3 at C > 16: the faster on the H100). Key rows
//    stream through shared memory kTileK at a time (the 512 KB of keys of
//    one batch element do not fit in the 227 KB a block may use), double
//    buffered with cp.async. Each tile is two phases:
//    * distances: the block's Q x 64 query.key products as a register-
//      tiled fp32 product, each thread 4 x 4 tiles (queries qg + 16 v,
//      keys kg + 16 u), so 8 float4 loads feed 64 FMAs; each dot is one
//      fmaf chain over the channels in order from 0, written to a shared
//      tile, and |k|^2 likewise;
//    * selection: thread s of a query takes the tile's keys S i + s in
//      index order and keeps its own sorted list of k (distance, index) in
//      registers, KMAX slots (k exactly for the model's k = 20, else 32). A
//      key goes after every entry at its distance, and each slot takes its
//      new entry from the old list alone (stay, the key, or the entry
//      above), so an insertion is KMAX independent selects rather than a
//      chain. A thread's keys are first filtered against its threshold
//      without branching, into a bit mask, and only the survivors are
//      inserted, so a warp pays for its busiest lane's survivors. The
//      filter also drops a key farther than every list's ceil(k / S)-th
//      entry as the last tile left them: the S lists then hold at least k
//      keys nearer, so such a key is not among the k nearest (exact, ties
//      included).
//    At the end one thread per query merges its S lists by (distance,
//    index). Every partial list is ordered so, and holds every key of its
//    share that is among the k nearest, so the merged list is the one a
//    single scan in index order gives, bit for bit: the distances are the
//    same fmaf chains, and zero channels past C (CP = 12 for C = 9) add
//    exact zeros to them.
//    knn_kernel, one thread per query and its chain, serves the rest:
//    C > 64 and 32 < k <= 64 (below).
//
// 2. edge_mma_kernel (W0, W1 <= 64): the per-edge layer on the tensor
//    cores in 3xTF32 mma.sync (csrc/mma_tf32.cuh). A warp takes 16 queries
//    (the rows of an m16 tile) and all 64 output columns, and walks their
//    neighbour slots one at a time: the slot's rows a[j] land in shared
//    memory by cp.async while the previous slot computes, each A element
//    is formed as leaky(a[j] + b[i]) in fp32 as its fragment loads and
//    split into hi and lo, W2 waits split in shared memory in fragment
//    order, and each slot's 64-channel sum starts in fresh accumulators
//    that fold into running maxima in fp32 (details at the kernel).
//
// Ragged N is masked here, not by the caller: key rows past N are never
// inserted, and queries past N are computed on zeros and never stored.
//
// K3: knn_split_kernel<CP, KMAX, true> (and knn_kernel<CP, KMAX, true> past
// the fast path) is the training path's kNN with neighbour statistics,
// replacing the TPU kernel gfs3dseg_gws_tpu/ops/knn.py::knn_with_stats (its
// Pallas body `_knn_stats_kernel`). After the same top-k it writes idx and
// then, for every (query i, neighbour j) pair of its tile, adds 1 to cnt[j]
// and the row b[i, :] to scb[j, :]:
//
//   cnt[j]    = |{(i, r) : idx[i, r] == j}|          (in-degree, exact)
//   scb[j, :] = sum over those (i, r) of b[i, :]     (transposed b-scatter)
//
// The block's warps walk its pairs, one pair per warp at a time, the
// lanes over the channels, so each float atomicAdd instruction of a warp
// hits one row of scb in consecutive words. The order of the additions
// varies from run to run, and so do the last bits of scb; cnt holds small
// integers and is exact. At k = 20 and Cb = 64 the scatter is 1,280
// float atomics per query, against the kNN's 2,048 x C distance FMAs.
//
// Widths and neighbour counts. knn_split_kernel and edge_mma_kernel are the
// fast path, for C, W0, W1 <= 64 and k <= 32 (the model's widths;
// edge_mma_kernel takes any k).
// Past those, knn_kernel, one thread per query, selects:
// * C > 64: knn_kernel<0, ...> streams the channels through keys_s in
//   chunks of 64; the partial dot products wait in cand_d and |k|^2 in kk_s
//   until the last chunk, and the fmaf chains run over the channels in the
//   same order, so a distance is the one a single pass would give;
// * 32 < k <= 64: knn_kernel<CP, 64, ...>, the same chain over 64 slots;
// * k > 64: K8's fold-merge selection (csrc/knn_fold.cu, four folds), which
//   holds each query's key row in shared memory, in chunks merged through
//   the caller's scratch past N ~ 27,000; for K3 it adds the statistics
//   itself;
// * W0 or W1 > 64: edge_mlp_wide_kernel, a register-tiled fp32 GEMM, takes
//   64 output columns per block (grid z) and kChunk neighbours of kTileQ
//   queries a step, and walks W0 in chunks of 64 through e_s and w2_s,
//   carrying the GEMM accumulators across the chunks.
//
// K6 and K9 are K1's two stages, each behind an entry of its own:
// gfs_knn_indices launches the kNN stage alone and replaces the TPU
// kernel gfs3dseg_gws_tpu/ops/knn.py::knn_indices (`_knn_pallas`, body
// `_knn_kernel`); gfs_gather_conv launches the edge stage alone on given
// indices and replaces ops/fused_edgeconv.py::fused_edgeconv_infer_split
// (body `_gather_conv_kernel`). All three entries share the two launch
// helpers, so K6 then K9 computes what K1 computes, bit for bit. K6 is
// bound by its B N^2 C distance FMAs, K9 by its B N k W0 W1 edge-layer FMAs.
#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_tf32.cuh"   // 3xTF32 mma.sync, the cp.async helpers

namespace {

constexpr int kTileQ = 64;   // queries per block
constexpr int kTileK = 64;   // key rows per shared-memory tile (multiple of 4)
constexpr int kMaxK = 32;    // neighbour slots of the fast path's chain
constexpr int kModelK = 20;  // the model's k (dgcnn_k): a list of its own
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
  // with k <= 32 (C > 64 here) the lists wait here for the statistics; the
  // others read them back from idx
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

// ---- the fast path's kNN stage (C <= 64, k <= 32): knn_split_kernel

constexpr int kSplitThreads = 256;   // 8 warps a block

// the block's shape with S threads per query
template <int S>
struct Split {
  static constexpr int Q = kSplitThreads / S;  // queries per block
  static constexpr int kShare = kTileK / S;    // a thread's keys a tile
  static constexpr int V = Q / 16;             // a thread's queries in the
                                               // distance tile,
  static constexpr int PV = V < 4 ? V : 4;     // ... PV at a time
  static constexpr int kDot = Q + 4;           // floats a row of dot_s
};

// the row stride (floats) of the key and query tiles: CP + 4 or CP + 8,
// whichever is an odd number of float4s, so the 8 rows 16 apart that a
// warp's lanes read at one channel lie in 8 different bank quads
__host__ __device__ constexpr int split_stride(int cp) {
  return ((cp + 4) / 4) % 2 == 1 ? cp + 4 : cp + 8;
}

// floats of shared memory for the scan: two key tiles, the query tile, the
// q.k tile, |k|^2 and the lists' bounds (two tiles' worth)
template <int CP, int S>
__host__ __device__ constexpr int split_scan_floats() {
  return (2 * kTileK + Split<S>::Q) * split_stride(CP) +
         kTileK * Split<S>::kDot + kTileK + 2 * kSplitThreads;
}

// ... and the merge, which reuses it: S lists of k (distance, index) per
// query
template <int CP, int S>
__host__ __device__ inline int split_region_floats(int k) {
  return split_scan_floats<CP, S>() > 2 * kSplitThreads * k
             ? split_scan_floats<CP, S>()
             : 2 * kSplitThreads * k;
}

template <int CP, int KMAX, int S, bool kStats>
size_t split_smem_bytes(int k) {
  return (static_cast<size_t>(split_region_floats<CP, S>(k)) +
          (kStats ? Split<S>::Q * KMAX : 0)) *
         sizeof(float);
}

// rows [base, base + rows) x channels [0, CP) of xb (n, c) into a
// [rows][PK] shared tile with cp.async, zeros past n and c: 16-byte copies
// when every row starts on 16 bytes (vec), else one float at a time
template <int CP, int PK>
__device__ __forceinline__ void split_stage(const float* __restrict__ xb,
                                            float* dst, int rows, int base,
                                            int n, int c, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * (CP / 4); e += kSplitThreads) {
      const int r = e / (CP / 4), ch = 4 * (e % (CP / 4));
      const bool ok = base + r < n && ch < c;
      gfs::cp_async16(dst + r * PK + ch,
                      ok ? xb + static_cast<size_t>(base + r) * c + ch : xb,
                      ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * CP; e += kSplitThreads) {
      const int r = e / CP, ch = e % CP;
      const bool ok = base + r < n && ch < c;
      gfs::cp_async4(dst + r * PK + ch,
                     ok ? xb + static_cast<size_t>(base + r) * c + ch : xb,
                     ok);
    }
  }
}

// CP: 12, 16 or 64 (C padded with zeros); KMAX: slots of the lists (k <=
// KMAX); S: threads per query; kStats as knn_kernel's
template <int CP, int KMAX, int S, bool kStats>
__global__ void __launch_bounds__(kSplitThreads, 2)
knn_split_kernel(const float* __restrict__ x, int* __restrict__ idx, int n,
                 int c, int k, const float* __restrict__ btab,
                 float* __restrict__ cnt, float* __restrict__ scb, int cb) {
  constexpr int PK = split_stride(CP);
  constexpr int Q = Split<S>::Q, V = Split<S>::V, PV = Split<S>::PV;
  constexpr int kDot = Split<S>::kDot;
  extern __shared__ __align__(16) float smem[];
  float* keys_s = smem;                   // [2][kTileK][PK]
  float* q_s = keys_s + 2 * kTileK * PK;  // [Q][PK]
  float* dot_s = q_s + Q * PK;            // [kTileK][kDot]: q.k
  float* kk_s = dot_s + kTileK * kDot;    // [kTileK]
  float* bound_s = kk_s + kTileK;         // [2][S][Q]
  // after the scan: the partial lists, [S][k][Q] each
  float* mrg_d = smem;
  int* mrg_i = reinterpret_cast<int*>(smem + S * k * Q);
  // the merged lists for the statistics, [Q][KMAX]
  int* nbr_s = reinterpret_cast<int*>(smem + split_region_floats<CP, S>(k));

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int batch = blockIdx.y;
  const int q0 = blockIdx.x * Q;
  const float* xb = x + static_cast<size_t>(batch) * n * c;
  const bool vec =
      c % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // selection: query sq of the block, keys S i + s of every key tile
  const int sq = tid % Q, s = tid / Q;
  // distances: queries qg + 16 v by keys kg + 16 u
  const int kg = lane % 8 + 8 * (warp % 2), qg = lane / 8 + 4 * (warp / 2);

  split_stage<CP, PK>(xb, q_s, Q, q0, n, c, vec);
  split_stage<CP, PK>(xb, keys_s, kTileK, 0, n, c, vec);
  gfs::cp_async_commit();
  gfs::cp_async_wait<0>();
  __syncthreads();
  float qq = 0.f;
#pragma unroll
  for (int ch = 0; ch < CP; ++ch)
    qq = fmaf(q_s[sq * PK + ch], q_s[sq * PK + ch], qq);

  // the list, sorted by (distance, index); slots at or past k hold what
  // they are shifted (never read)
  float best_d[KMAX];
  int best_i[KMAX];
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    best_d[t] = INFINITY;
    best_i[t] = 0;
  }
  float thr = INFINITY;  // always best_d[k - 1]
  const int m = (k + S - 1) / S - 1;   // the slot the bound reads

  const int tiles = (n + kTileK - 1) / kTileK;
  for (int tile = 0; tile < tiles; ++tile) {
    const int base = tile * kTileK;
    const float* kt = keys_s + (tile % 2) * kTileK * PK;
    // the next tile streams in while this one is scored (its buffer was
    // last read before the previous tile's second barrier)
    if (tile + 1 < tiles)
      split_stage<CP, PK>(xb, keys_s + ((tile + 1) % 2) * kTileK * PK,
                          kTileK, base + kTileK, n, c, vec);
    gfs::cp_async_commit();
    gfs::cp_async_wait<1>();
    __syncthreads();  // this tile is in; the last selection is done

    // ---- q.k of the tile, each an fmaf chain over the channels in order
#pragma unroll 1
    for (int v0 = 0; v0 < V; v0 += PV) {
      const float* qp = q_s + (qg + 16 * v0) * PK;
      float acc[PV][4];
#pragma unroll
      for (int v = 0; v < PV; ++v)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[v][u] = 0.f;
#pragma unroll
      for (int ch = 0; ch < CP; ch += 4) {
        float4 kv[4], qv[PV];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          kv[u] = gfs::load4(kt + (kg + 16 * u) * PK + ch);
#pragma unroll
        for (int v = 0; v < PV; ++v)
          qv[v] = gfs::load4(qp + 16 * v * PK + ch);
#pragma unroll
        for (int v = 0; v < PV; ++v)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[v][u] = fmaf(qv[v].x, kv[u].x, acc[v][u]);
            acc[v][u] = fmaf(qv[v].y, kv[u].y, acc[v][u]);
            acc[v][u] = fmaf(qv[v].z, kv[u].z, acc[v][u]);
            acc[v][u] = fmaf(qv[v].w, kv[u].w, acc[v][u]);
          }
      }
#pragma unroll
      for (int v = 0; v < PV; ++v)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dot_s[(kg + 16 * u) * kDot + qg + 16 * (v0 + v)] = acc[v][u];
    }
    if (tid < kTileK) {
      float s2 = 0.f;
#pragma unroll
      for (int ch = 0; ch < CP; ch += 4) {
        const float4 kv = gfs::load4(kt + tid * PK + ch);
        s2 = fmaf(kv.x, kv.x, s2);
        s2 = fmaf(kv.y, kv.y, s2);
        s2 = fmaf(kv.z, kv.z, s2);
        s2 = fmaf(kv.w, kv.w, s2);
      }
      kk_s[tid] = s2;
    }
    __syncthreads();  // dot_s and kk_s are complete

    // ---- selection. The filter: nearer than this list's k-th, and no
    // farther than the largest of the lists' m-th as the last tile left
    // them (d <= bound is d < the next float up)
    float lim = thr;
    if (tile > 0) {
      const float* bp = bound_s + ((tile - 1) % 2) * S * Q + sq;
      float bound = bp[0];
#pragma unroll
      for (int u = 1; u < S; ++u) bound = fmaxf(bound, bp[u * Q]);
      lim = fminf(thr, nextafterf(bound, INFINITY));
    }
    const int nk = min(kTileK, n - base);
    unsigned int mask = 0;
#pragma unroll
    for (int i = 0; i < Split<S>::kShare; ++i) {
      const int r = S * i + s;
      const float d = gfs::sq_dist(qq, kk_s[r], dot_s[r * kDot + sq]);
      mask |= (r < nk && d < lim) ? 1u << i : 0u;
    }
    // ... then insert the survivors in key order, each after every listed
    // key at its distance: the list stays ordered by (distance, index)
    while (mask != 0) {
      const int i = __ffs(mask) - 1;
      mask &= mask - 1;
      const int r = S * i + s;
      float cd = gfs::sq_dist(qq, kk_s[r], dot_s[r * kDot + sq]);
      if (cd < thr) {
        // the entries at cd or nearer keep their slots (a prefix: the list
        // is sorted); the key takes the next slot and every later entry
        // moves down one. Each slot is set from the old list alone, top
        // slot first, so no slot waits for another.
        const int ci = base + r;
#pragma unroll
        for (int t = KMAX - 1; t > 0; --t) {
          const bool stays = best_d[t] <= cd, above = best_d[t - 1] <= cd;
          best_i[t] = stays ? best_i[t] : above ? ci : best_i[t - 1];
          best_d[t] = stays ? best_d[t] : above ? cd : best_d[t - 1];
        }
        if (!(best_d[0] <= cd)) {
          best_d[0] = cd;
          best_i[0] = ci;
        }
        if (k == KMAX) {
          thr = best_d[KMAX - 1];
        } else {
#pragma unroll
          for (int t = 0; t < KMAX; ++t)
            if (t == k - 1) thr = best_d[t];
        }
      }
    }
    float dm = best_d[0];
#pragma unroll
    for (int t = 1; t < KMAX; ++t)
      if (t == m) dm = best_d[t];
    bound_s[(tile % 2) * S * Q + s * Q + sq] = dm;
  }

  // ---- merge the S lists of each query by (distance, index)
  __syncthreads();  // the scan is done with every tile (the lists reuse them)
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    if (t < k) {
      mrg_d[(s * k + t) * Q + sq] = best_d[t];
      mrg_i[(s * k + t) * Q + sq] = best_i[t];
    }
  }
  __syncthreads();
  if (s == 0 && q0 + sq < n) {
    float hd[S];
    int hi[S], pos[S];
#pragma unroll
    for (int u = 0; u < S; ++u) {
      hd[u] = mrg_d[u * k * Q + sq];
      hi[u] = mrg_i[u * k * Q + sq];
      pos[u] = 0;
    }
    int* row = idx + (static_cast<size_t>(batch) * n + q0 + sq) * k;
    for (int t = 0; t < k; ++t) {
      float bd = hd[0];
      int bi = hi[0], bu = 0;
#pragma unroll
      for (int u = 1; u < S; ++u) {
        const bool nearer = hd[u] < bd || (hd[u] == bd && hi[u] < bi);
        bd = nearer ? hd[u] : bd;
        bi = nearer ? hi[u] : bi;
        bu = nearer ? u : bu;
      }
      row[t] = bi;
      if constexpr (kStats) nbr_s[sq * KMAX + t] = bi;
#pragma unroll
      for (int u = 0; u < S; ++u) {
        if (u == bu) {
          // a spent list reads as (inf, past every index)
          ++pos[u];
          const bool more = pos[u] < k;
          const int at = (u * k + (more ? pos[u] : 0)) * Q + sq;
          hd[u] = more ? mrg_d[at] : INFINITY;
          hi[u] = more ? mrg_i[at] : INT_MAX;
        }
      }
    }
  }
  if constexpr (kStats) {
    __syncthreads();  // nbr_s is complete
    const int pairs = min(Q, n - q0) * k;
    const float* b_b = btab + static_cast<size_t>(batch) * n * cb;
    float* scb_b = scb + static_cast<size_t>(batch) * n * cb;
    for (int pr = warp; pr < pairs; pr += kSplitThreads / 32) {
      const int q = pr / k;
      const int j = nbr_s[q * KMAX + pr - q * k];
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

// edge_mma_kernel: the edge stage for W0, W1 <= 64 on the tensor cores.
// A warp takes kMmaRows = 16 queries (the rows of one m16n8k8 tile) and all
// 64 output columns (8 n-tiles), and walks their neighbour slots r = 0 ..
// k - 1: slot r's 16 x 64 edge rows e = leaky(a[idx[i, r]] + b[i]) times W2,
// in 3xTF32 (csrc/mma_tf32.cuh), summed in fresh accumulators (64 channels,
// 8 k-steps: no long truncating chain), then folded into running maxima
// element by element in fp32. leaky(. + bias2) is monotone, so it is
// applied once to the max, which gives the same floats as the max of
// leaky(z + bias2). The rows a[idx[i, r + 1]] land in shared memory by
// cp.async while slot r computes; each warp stages its own rows (and its
// own b rows, held in registers), so the loop needs no block barrier. W2 is
// split into hi and lo once a block and kept in shared memory in fragment
// order (one 16-byte load a lane per B fragment).
//
// The sum over channels is taken in an order of our choosing: a lane loads
// channels 16 p + 4 t .. + 3 of its two rows as one float4 and uses them
// for the k-steps 2 p (channels + 0, + 1 at k-positions t, t + 4) and 2 p +
// 1 (+ 2, + 3), and W2's fragments are laid out to match.
constexpr int kMmaRows = 16;     // queries a warp
constexpr int kMmaWarps = 4;     // warps a block, 64 queries (2 blocks an
                                 // SM; 8 warps, one block an SM, ran no
                                 // faster on the H100: PERF.md)
constexpr int kMmaStride = 80;   // floats a staged row (64 + 16): the float4
                                 // loads of a quarter warp (2 rows) are free
                                 // of bank conflicts
constexpr int kMmaSlots = 32;    // idx slots staged at a time
constexpr int kMmaStages = 2;    // a-row buffers
constexpr int kW2Frags = kMaxW * kMaxW / 2;   // (k-step, n-tile, lane)
constexpr int kMmaWarpFloats =
    (kMmaStages + 1) * kMmaRows * kMmaStride + kMmaRows * kMmaSlots;

constexpr size_t kMmaSmem =
    (4 * static_cast<size_t>(kW2Frags) + kMaxW +
     kMmaWarps * static_cast<size_t>(kMmaWarpFloats)) * sizeof(float);

// vec16: w0 % 4 == 0 and both tables 16-byte aligned (16-byte copies, else
// 4-byte ones)
__global__ void __launch_bounds__(kMmaWarps * 32)
edge_mma_kernel(const int* __restrict__ idx, const float* __restrict__ a_table,
                const float* __restrict__ b_table,
                const float* __restrict__ w2, const float* __restrict__ bias2,
                float* __restrict__ out, int n, int w0, int w1, int k,
                float neg_slope, bool vec16) {
  extern __shared__ __align__(16) float smem[];
  uint4* w2f = reinterpret_cast<uint4*>(smem);   // [kk][j][lane]: hi0 hi1
                                                 // lo0 lo1
  float* bias_s = smem + 4 * kW2Frags;           // [kMaxW], zero padded
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float* a_s = bias_s + kMaxW + warp * kMmaWarpFloats;  // [stage][row][ch]
  float* b_s = a_s + kMmaStages * kMmaRows * kMmaStride;  // [row][ch]
  int* idx_s = reinterpret_cast<int*>(b_s + kMmaRows * kMmaStride);
  const int batch = blockIdx.y;
  const int q0 = (blockIdx.x * kMmaWarps + warp) * kMmaRows;
  const float* a_b = a_table + static_cast<size_t>(batch) * n * w0;
  const float* b_b = b_table + static_cast<size_t>(batch) * n * w0;
  const int* idx_b = idx + static_cast<size_t>(batch) * n * k;

  // W2's B fragments, split once: k-step kk takes channels 16 (kk / 2) +
  // 4 t + 2 (kk % 2) + {0, 1} at k-positions t, t + 4
  for (int f = threadIdx.x; f < kW2Frags; f += kMmaWarps * 32) {
    const int l = f % 32, j = (f / 32) % 8, kk = f / 256;
    const int r0 = 16 * (kk / 2) + 4 * (l % 4) + 2 * (kk % 2);
    const int col = 8 * j + l / 4;
    const bool ok = col < w1;
    uint32_t h0, lo0, h1, lo1;
    gfs::split_tf32(ok && r0 < w0 ? w2[r0 * w1 + col] : 0.f, h0, lo0);
    gfs::split_tf32(ok && r0 + 1 < w0 ? w2[(r0 + 1) * w1 + col] : 0.f, h1,
                    lo1);
    w2f[f] = make_uint4(h0, h1, lo0, lo1);
  }
  for (int o = threadIdx.x; o < kMaxW; o += kMmaWarps * 32)
    bias_s[o] = o < w1 ? bias2[o] : 0.f;

  // this warp's 16 rows of `tab` into dst [row][kMmaStride], row r taken
  // from table row row_of(r) (zeros where that is < 0), channels past w0
  // zero
  auto stage = [&](float* dst, const float* tab, auto row_of) {
    if (vec16) {
      for (int e = lane; e < kMmaRows * (kMaxW / 4); e += 32) {
        const int r = e / (kMaxW / 4), c = 4 * (e % (kMaxW / 4));
        const int j = row_of(r);
        const bool ok = j >= 0 && c < w0;
        gfs::cp_async16(dst + r * kMmaStride + c,
                        ok ? tab + static_cast<size_t>(j) * w0 + c : tab, ok);
      }
    } else {
      for (int e = lane; e < kMmaRows * kMaxW; e += 32) {
        const int r = e / kMaxW, c = e % kMaxW;
        const int j = row_of(r);
        const bool ok = j >= 0 && c < w0;
        gfs::cp_async4(dst + r * kMmaStride + c,
                       ok ? tab + static_cast<size_t>(j) * w0 + c : tab, ok);
      }
    }
  };
  // idx of slots s0 .. s0 + kMmaSlots - 1 of the warp's queries (-1 past n
  // or k)
  auto load_idx = [&](int s0) {
    for (int e = lane; e < kMmaRows * kMmaSlots; e += 32) {
      const int q = q0 + e / kMmaSlots, s = s0 + e % kMmaSlots;
      idx_s[e] = q < n && s < k ? idx_b[static_cast<size_t>(q) * k + s] : -1;
    }
    __syncwarp();
  };
  auto slot_rows = [&](int s) {
    return [=](int r) { return idx_s[r * kMmaSlots + s % kMmaSlots]; };
  };

  stage(b_s, b_b, [&](int r) { return q0 + r < n ? q0 + r : -1; });
  load_idx(0);
  stage(a_s, a_b, slot_rows(0));
  gfs::cp_async_commit();
  gfs::cp_async_wait<0>();
  __syncthreads();   // w2f, bias_s and every warp's first rows

  // b of rows g and g + 8 at the channels this lane loads
  float4 bv[4][2];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    bv[p][0] = gfs::load4(b_s + g * kMmaStride + 16 * p + 4 * t);
    bv[p][1] = gfs::load4(b_s + (g + 8) * kMmaStride + 16 * p + 4 * t);
  }

  float mx[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[j][i] = -INFINITY;

  for (int r = 0; r < k; ++r) {
    if (r + 1 < k) {
      if ((r + 1) % kMmaSlots == 0) load_idx(r + 1);
      stage(a_s + ((r + 1) % kMmaStages) * kMmaRows * kMmaStride, a_b,
            slot_rows(r + 1));
      gfs::cp_async_commit();
      gfs::cp_async_wait<1>();
    } else {
      gfs::cp_async_wait<0>();
    }
    __syncwarp();   // slot r's rows, from every lane's copies
    const float* ar = a_s + (r % kMmaStages) * kMmaRows * kMmaStride;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float4 x0 = gfs::load4(ar + g * kMmaStride + 16 * p + 4 * t);
      const float4 x1 = gfs::load4(ar + (g + 8) * kMmaStride + 16 * p + 4 * t);
      gfs::FragA fa[2];   // k-steps 2 p and 2 p + 1
      gfs::set_a(fa[0], gfs::leaky(x0.x + bv[p][0].x, neg_slope),
                 gfs::leaky(x1.x + bv[p][1].x, neg_slope),
                 gfs::leaky(x0.y + bv[p][0].y, neg_slope),
                 gfs::leaky(x1.y + bv[p][1].y, neg_slope));
      gfs::set_a(fa[1], gfs::leaky(x0.z + bv[p][0].z, neg_slope),
                 gfs::leaky(x1.z + bv[p][1].z, neg_slope),
                 gfs::leaky(x0.w + bv[p][0].w, neg_slope),
                 gfs::leaky(x1.w + bv[p][1].w, neg_slope));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint4 fb[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) fb[j] = w2f[((2 * p + h) * 8 + j) * 32 + lane];
        // 3xTF32 as gfs::mma_3xtf32 sums it (a_lo b_hi, a_hi b_lo, a_hi
        // b_hi), each product over the 8 n-tiles in turn: 8 independent
        // accumulator chains between two steps of one chain
#pragma unroll
        for (int j = 0; j < 8; ++j)
          gfs::mma_tf32(acc[j], fa[h].lo, {fb[j].x, fb[j].y});
#pragma unroll
        for (int j = 0; j < 8; ++j)
          gfs::mma_tf32(acc[j], fa[h].hi, {fb[j].z, fb[j].w});
#pragma unroll
        for (int j = 0; j < 8; ++j)
          gfs::mma_tf32(acc[j], fa[h].hi, {fb[j].x, fb[j].y});
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[j][i] = fmaxf(mx[j][i], acc[j][i]);
    __syncwarp();   // every lane is done with this buffer
  }

  // C fragment: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + g + 8 * (i / 2), col = 8 * j + 2 * t + i % 2;
      if (qi < n && col < w1)
        out[(static_cast<size_t>(batch) * n + qi) * w1 + col] =
            gfs::leaky(mx[j][i] + bias_s[col], neg_slope);
    }
  }
}

// W0 or W1 above kMaxW: the block takes output columns col0 .. col0 + 63
// (col0 = 64 blockIdx.z) and W0 in chunks of kMaxW, as a register-tiled
// fp32 GEMM
__global__ void __launch_bounds__(kMlpThreads)
edge_mlp_wide_kernel(const int* __restrict__ idx,
                     const float* __restrict__ a_table,
                     const float* __restrict__ b_table,
                     const float* __restrict__ w2,
                     const float* __restrict__ bias2,
                     float* __restrict__ out, int n, int w0, int w1, int k,
                     float neg_slope) {
  extern __shared__ __align__(16) float smem[];
  float* e_s = smem;                       // [kMaxW][kRows]: e_s[ch*kRows+r]
  float* w2_s = e_s + kMaxW * kRows;       // [kMaxW][kMaxW], zero padded
  float* bias_s = w2_s + kMaxW * kMaxW;    // [kMaxW], zero padded

  const int tid = threadIdx.x;
  const int batch = blockIdx.y;
  const int q_base = blockIdx.x * kTileQ;
  const int col0 = blockIdx.z * kMaxW;
  // GEMM tile of this thread: edge rows 8p..8p+7 (queries 2p, 2p+1 times
  // kChunk neighbours) by output channels 8cg..8cg+7
  const int p = tid / 8, cg = tid % 8;

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
    for (int c0 = 0; c0 < w0; c0 += kMaxW) {
      __syncthreads();  // the previous GEMM is done with e_s and w2_s
      for (int ch = 0; ch < kMaxW; ++ch)
        e_s[ch * kRows + r_own] =
            (ok && c0 + ch < w0)
                ? gfs::leaky(a_row[c0 + ch] + b_row[c0 + ch], neg_slope)
                : 0.f;
      for (int e = tid; e < kMaxW * kMaxW; e += kMlpThreads) {
        const int r = e / kMaxW, o = e % kMaxW;
        w2_s[e] = (c0 + r < w0 && col0 + o < w1)
                      ? w2[static_cast<size_t>(c0 + r) * w1 + col0 + o]
                      : 0.f;
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

// S threads a query: 2 (128 queries a block), but 4 for K3 at C > 16,
// where S = 2 ran slower on the H100 (PERF.md)
template <int CP, int KMAX, bool kStats>
cudaError_t run_knn_split(const float* x, int* idx, int batch, int n, int c,
                          int k, const float* btab, float* cnt, float* scb,
                          int cb, cudaStream_t s) {
  constexpr int S = kStats && CP == kMaxC ? 4 : 2;
  const auto kernel = knn_split_kernel<CP, KMAX, S, kStats>;
  const size_t smem = split_smem_bytes<CP, KMAX, S, kStats>(k);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + Split<S>::Q - 1) / Split<S>::Q, batch);
  kernel<<<grid, kSplitThreads, smem, s>>>(x, idx, n, c, k, btab, cnt, scb,
                                           cb);
  return cudaGetLastError();
}

// the list's length: exactly k for the model's k, else kMaxK slots
template <int CP, bool kStats>
cudaError_t run_knn_split_k(const float* x, int* idx, int batch, int n,
                            int c, int k, const float* btab, float* cnt,
                            float* scb, int cb, cudaStream_t s) {
  if (k == kModelK)
    return run_knn_split<CP, kModelK, kStats>(x, idx, batch, n, c, k, btab,
                                              cnt, scb, cb, s);
  return run_knn_split<CP, kMaxK, kStats>(x, idx, batch, n, c, k, btab, cnt,
                                          scb, cb, s);
}

// the variant by width: the fast path's split selection for c <= 64 (CP =
// 12, 16 or 64) and k <= 32, else one thread per query
template <int KMAX, bool kStats>
cudaError_t run_knn_c(const float* x, int* idx, int batch, int n, int c,
                      int k, const float* btab, float* cnt, float* scb,
                      int cb, cudaStream_t s) {
  if constexpr (KMAX == kMaxK) {
    if (c <= 12)
      return run_knn_split_k<12, kStats>(x, idx, batch, n, c, k, btab, cnt,
                                         scb, cb, s);
    if (c <= 16)
      return run_knn_split_k<16, kStats>(x, idx, batch, n, c, k, btab, cnt,
                                         scb, cb, s);
    if (c <= kMaxC)
      return run_knn_split_k<64, kStats>(x, idx, batch, n, c, k, btab, cnt,
                                         scb, cb, s);
  } else {
    if (c <= 16)
      return run_knn<16, KMAX, kStats>(x, idx, batch, n, c, k, btab, cnt,
                                       scb, cb, s);
    if (c <= kMaxC)
      return run_knn<64, KMAX, kStats>(x, idx, batch, n, c, k, btab, cnt,
                                       scb, cb, s);
  }
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

// the edge stage on given indices: out (B, N, w1). W0, W1 <= 64 on the
// tensor cores (edge_mma_kernel), wider tables on edge_mlp_wide_kernel
cudaError_t launch_edge_mlp(const int* idx, const float* a_table,
                            const float* b_table, const float* w2,
                            const float* bias2, float* out, int batch, int n,
                            int w0, int w1, int k, float neg_slope,
                            cudaStream_t s) {
  if (w0 > kMaxW || w1 > kMaxW) {
    cudaError_t err = cudaFuncSetAttribute(
        edge_mlp_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMlpSmem));
    if (err != cudaSuccess) return err;
    const dim3 grid((n + kTileQ - 1) / kTileQ, batch,
                    (w1 + kMaxW - 1) / kMaxW);
    edge_mlp_wide_kernel<<<grid, kMlpThreads, kMlpSmem, s>>>(
        idx, a_table, b_table, w2, bias2, out, n, w0, w1, k, neg_slope);
    return cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      edge_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMmaSmem));
  if (err != cudaSuccess) return err;
  constexpr int rows = kMmaWarps * kMmaRows;
  const bool vec16 = w0 % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(a_table) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(b_table) % 16 == 0;
  edge_mma_kernel<<<dim3((n + rows - 1) / rows, batch), kMmaWarps * 32,
                    kMmaSmem, s>>>(idx, a_table, b_table, w2, bias2, out, n,
                                   w0, w1, k, neg_slope, vec16);
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
