// K8: exact kNN indices, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel gfs3dseg_gws_tpu/ops/knn.py::_knn_pallas_fold (its
// Pallas body `_knn_fold_kernel`), which computes what K6 computes - the k
// nearest keys of every query, self included, nearest first - by a
// tournament: split the key row into `folds` column slices, sort every
// column across the folds with a small network (so each column's minimum
// sits in fold 0), then pop the global minimum k times from fold 0 alone,
// shifting the popped column up by one fold. The tournament is the TPU's
// way to take a minimum out of VMEM; a block of this card needs no such
// thing, so for k <= kCap (256) K8 runs a streaming selection instead, and
// the tournament stays only past kCap.
//
// Keys are 64 bits, the distance's bits high and the key's index low:
// exact (the TPU packed both into 32 bits and lost 2^-12 of the distance),
// distinct, and ordered by (distance, index), K6's rule for ties. The
// distances come from K6's own arithmetic: |q|^2, |k|^2 and q.k are fmaf
// chains over the channels in order (64 channels at a time for C > 64,
// the chains carried from chunk to chunk; zero channels past C add exact
// zeros) and gfs::sq_dist puts them together, so K8's indices equal K6's
// bit for bit. fmaxf(x, 0) may return -0.0, whose sign bit would sort it
// after every positive distance: the sign bit is cleared before packing.
//
// 1. knn_stream_kernel (k <= kCap): the selection of Johnson, Douze and
//    Jegou's WarpSelect ("Billion-scale similarity search with GPUs",
//    arXiv 1702.08734), on distances computed a tile at a time. A block of
//    8 warps takes 32 queries and streams every key row of its batch
//    element through shared memory, 64 rows a tile, double buffered with
//    cp.async. Each tile:
//    * distances: the 32 x 64 query.key products as a register-tiled fp32
//      product (each thread 2 queries x 4 keys, knn_split_kernel's layout
//      in csrc/fused_edgeconv.cu), each dot one fmaf chain; |k|^2 once a
//      key row, by 64 threads (their chains carried across the chunks of
//      C > 64), |q|^2 once a query, by the lane that keeps it;
//    * selection: warp w keeps queries 4w .. 4w + 3. Each query holds its
//      best keys as a sorted list of kl = max(32, k rounded up to a power
//      of two) keys in shared memory, and a queue of up to 64 taken keys.
//      Lane l scores keys l and l + 32 of the tile; a key is taken only if
//      it is below the list's k-th key (all-ones until k keys are listed),
//      and the taken keys are appended to the queue in index order (a
//      ballot and its prefix counts). When a tile's keys would overflow the
//      queue, the queue is merged first and the tile's keys filtered again
//      against the new k-th key; while fewer than k keys are listed, a
//      queue that holds k is merged at once.
//    The merge: the queue, padded with all-ones, is sorted by a 64-wide
//    bitonic network (one compare-exchange a lane a stage), the list's
//    entry kl - 1 - t is replaced by the smaller of it and the queue's t-th
//    (the kl smallest of both, as a bitonic sequence), and a bitonic merge
//    sorts the list again. Keys are distinct, so the list holds the kl
//    smallest keys taken so far whatever order they came in; a key left out
//    was above the k-th of k listed keys, so it is not among the k nearest.
//    At the end every queue is merged, and the list's first k indices are
//    the query's row of idx. The state does not grow with N: one code path
//    for every N, no scratch, and at kl <= 128 two blocks an SM.
// 2. knn_fold_kernel (k > kCap): the tournament above. One warp owns one
//    query; its whole key row lives in shared memory, lane l owning the
//    columns l, l + 32, ... of the (folds, w) layout (w = ceil(N / folds);
//    keys past N are all-ones and never popped). A round is a five-step
//    shuffle-min over the lanes' minima of their fold-0 entries; the lane
//    whose column popped shifts it and rescans its own w / 32 entries.
//    A key row takes N * 8 bytes of shared memory per query, so past
//    N ~ 27,000 (at eight warps: 3,328 keys each, four folds) the row is
//    streamed in chunks that fit: each chunk runs the same fold-merge, and
//    its pops are merged with the query's running k best, a sorted list of
//    k keys kept in a global scratch (B, nq, 2, k) (the merge writes the
//    other half of the pair and the two swap). A row that fits runs in one
//    chunk and pops straight into idx, with no scratch.
//
// launch_knn_fold also serves K1, K3 and K6 for k > 64 (csrc/
// fused_edgeconv.cu), for their nq queries from row q_off (a sequence-
// parallel rank's own rows against all N keys; K8's own entry takes every
// row), with K3's neighbour statistics added from each
// query's final list: the lanes add the query's btab row into scb[j], lane
// 0 adds 1 to cnt[j]. `folds` chooses the tournament's layout and nothing
// else: the indices never depend on it. What bounds K8: the B N^2 C
// distance FMAs, as for K6.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "mma_tf32.cuh"   // the cp.async helpers

namespace {

constexpr int kTile = 64;                 // key rows per shared-memory tile
constexpr int kMaxWarps = 8;              // queries per block, at most
using fold_key = unsigned long long;       // (distance bits << 32) | index
constexpr fold_key kNoKey = ~0ull;

// ---- 1. knn_stream_kernel (k <= kCap)

constexpr int kCap = 256;            // the longest list: k <= kCap
constexpr int kSelThreads = 256;     // 8 warps a block
constexpr int kSelQ = 32;            // queries a block
constexpr int kOwn = kSelQ / 8;      // ... a warp keeps
constexpr int kQueue = 64;           // taken keys a query's queue holds
constexpr int kDot = kTile + 8;      // floats a row of dot_s ([query][key])

// the row stride (floats) of the key and query tiles: qw + 4 or qw + 8,
// whichever is an odd number of float4s (no bank conflicts; as
// knn_split_kernel's)
__host__ __device__ constexpr int sel_stride(int qw) {
  return ((qw + 4) / 4) % 2 == 1 ? qw + 4 : qw + 8;
}

// floats of shared memory before the lists: two key tiles, the query tile
// (two for C > 64, whose query channels change with the chunk), the q.k
// tile and |k|^2 (an even count: the lists after them are 8-byte aligned)
template <int CP>
__host__ __device__ constexpr int stream_floats() {
  constexpr int qw = CP == 0 ? 64 : CP;
  return (2 * kTile + (CP == 0 ? 2 : 1) * kSelQ) * sel_stride(qw) +
         kSelQ * kDot + kTile;
}

template <int CP>
size_t stream_smem_bytes(int kl) {
  return stream_floats<CP>() * sizeof(float) +
         static_cast<size_t>(kSelQ) * (kl + kQueue) * sizeof(fold_key);
}

// rows [base, base + rows) x channels [c0, c0 + QW) of xb (n, c) into a
// [rows][PK] shared tile with cp.async, zeros past n and c: 16-byte copies
// when every row starts on 16 bytes (vec), else one float at a time
template <int QW, int PK>
__device__ __forceinline__ void stream_stage(const float* __restrict__ xb,
                                             float* dst, int rows, int base,
                                             int c0, int n, int c, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * (QW / 4); e += kSelThreads) {
      const int r = e / (QW / 4), ch = 4 * (e % (QW / 4));
      const bool ok = base + r < n && c0 + ch < c;
      gfs::cp_async16(
          dst + r * PK + ch,
          ok ? xb + static_cast<size_t>(base + r) * c + c0 + ch : xb, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * QW; e += kSelThreads) {
      const int r = e / QW, ch = e % QW;
      const bool ok = base + r < n && c0 + ch < c;
      gfs::cp_async4(
          dst + r * PK + ch,
          ok ? xb + static_cast<size_t>(base + r) * c + c0 + ch : xb, ok);
    }
  }
}

// the first of the two entries of compare-exchange p at a bitonic stage of
// this stride (a power of two): p / stride * 2 stride + p % stride
__device__ __forceinline__ int pair_first(int p, int stride) {
  return ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
}

// one warp merges a query's queue (fill keys) into its sorted list of kl
// keys; returns the list's k-th key. Out of line: the selection calls it
// from eight places, which inlined cost the kernel its registers.
__device__ __noinline__ fold_key merge_queue(fold_key* list,
                                                fold_key* queue, int fill,
                                                int kl, int k, int lane) {
  __syncwarp();   // the queue's keys are written
  for (int e = fill + lane; e < kQueue; e += 32) queue[e] = kNoKey;
  __syncwarp();
  // bitonic sort of the queue, ascending: a compare-exchange a lane a stage
#pragma unroll
  for (int size = 2; size <= kQueue; size *= 2) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride /= 2) {
      const int i = pair_first(lane, stride);
      const fold_key a = queue[i], b = queue[i + stride];
      if ((a > b) == ((i & size) == 0)) {
        queue[i] = b;
        queue[i + stride] = a;
      }
      __syncwarp();
    }
  }
  // the kl smallest of list and queue: entry kl - 1 - t takes the smaller
  // of itself and the queue's t-th, which leaves the list bitonic
  for (int t = lane; t < min(kl, kQueue); t += 32) {
    const fold_key v = queue[t];
    if (v < list[kl - 1 - t]) list[kl - 1 - t] = v;
  }
  __syncwarp();
  // bitonic merge, ascending
  for (int stride = kl / 2; stride > 0; stride /= 2) {
    for (int p = lane; p < kl / 2; p += 32) {
      const int i = pair_first(p, stride);
      const fold_key a = list[i], b = list[i + stride];
      if (a > b) {
        list[i] = b;
        list[i + stride] = a;
      }
    }
    __syncwarp();
  }
  return list[k - 1];
}

// CP: input width padded with zeros to 12, 16 or 64, or 0 for C > 64
// (64-channel chunks); kStats: K3's statistics into the zeroed cnt (B, N)
// and scb (B, N, cb). kl: the lists' length (a power of two, k <= kl <=
// kCap)
template <int CP, bool kStats>
__global__ void __launch_bounds__(kSelThreads, 2)
knn_stream_kernel(const float* __restrict__ x, int* __restrict__ idx, int n,
                  int nq, int q_off, int c, int k, int kl,
                  const float* __restrict__ btab, float* __restrict__ cnt,
                  float* __restrict__ scb, int cb) {
  constexpr bool kWide = CP == 0;
  constexpr int QW = kWide ? 64 : CP;         // channels a step
  constexpr int PK = sel_stride(QW);
  constexpr int V = kSelQ / 16;               // a thread's queries
  extern __shared__ __align__(16) float smem[];
  float* keys_s = smem;                                  // [2][kTile][PK]
  float* q_s = keys_s + 2 * kTile * PK;                  // [1 or 2][Q][PK]
  float* dot_s = q_s + (kWide ? 2 : 1) * kSelQ * PK;     // [Q][kDot]
  float* kk_s = dot_s + kSelQ * kDot;                    // [kTile]
  fold_key* lists = reinterpret_cast<fold_key*>(smem + stream_floats<CP>());
  fold_key* queues = lists + kSelQ * kl;                 // [Q][kQueue]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int batch = blockIdx.y;
  const int q0 = blockIdx.x * kSelQ;   // of nq (row q_off + q0 of x)
  const int qr0 = q_off + q0, qend = q_off + nq;
  const float* xb = x + static_cast<size_t>(batch) * n * c;
  const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // distances: queries qg + 16 v by keys kg + 16 u
  const int kg = lane % 8 + 8 * (warp % 2), qg = lane / 8 + 4 * (warp / 2);
  const int chunks = kWide ? (c + QW - 1) / QW : 1;
  const int steps = (n + kTile - 1) / kTile * chunks;

  for (int e = tid; e < kSelQ * kl; e += kSelThreads) lists[e] = kNoKey;
  // the selection state of this warp's queries (the same in every lane);
  // lane o < kOwn also sums |q|^2 of query kOwn w + o
  fold_key thr[kOwn];
  int fill[kOwn];
#pragma unroll
  for (int o = 0; o < kOwn; ++o) {
    thr[o] = kNoKey;
    fill[o] = 0;
  }
  float qq = 0.f, kk = 0.f;
  float acc[V][4];

  stream_stage<QW, PK>(xb, q_s, kSelQ, qr0, 0, qend, c, vec);
  stream_stage<QW, PK>(xb, keys_s, kTile, 0, 0, n, c, vec);
  gfs::cp_async_commit();
  for (int st = 0; st < steps; ++st) {
    const int tile = st / chunks, cc = st - tile * chunks;
    const int base = tile * kTile;
    // the next step's rows stream in while this one computes (their
    // buffers were last read before the previous step's second barrier)
    if (st + 1 < steps) {
      const int nt = (st + 1) / chunks, nc = st + 1 - nt * chunks;
      stream_stage<QW, PK>(xb, keys_s + ((st + 1) % 2) * kTile * PK, kTile,
                           nt * kTile, nc * QW, n, c, vec);
      if constexpr (kWide)
        stream_stage<QW, PK>(xb, q_s + ((st + 1) % 2) * kSelQ * PK, kSelQ,
                             qr0, nc * QW, qend, c, vec);
    }
    gfs::cp_async_commit();
    gfs::cp_async_wait<1>();
    __syncthreads();  // this step's rows are in

    const float* kt = keys_s + (st % 2) * kTile * PK;
    const float* qt = q_s + (kWide ? (st % 2) * kSelQ * PK : 0);
    if (cc == 0) {
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[v][u] = 0.f;
      kk = 0.f;
    }
    // ---- q.k, |k|^2 and |q|^2 over this step's channels, in order
#pragma unroll
    for (int ch = 0; ch < QW; ch += 4) {
      float4 kv[4], qv[V];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        kv[u] = gfs::load4(kt + (kg + 16 * u) * PK + ch);
#pragma unroll
      for (int v = 0; v < V; ++v)
        qv[v] = gfs::load4(qt + (qg + 16 * v) * PK + ch);
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[v][u] = fmaf(qv[v].x, kv[u].x, acc[v][u]);
          acc[v][u] = fmaf(qv[v].y, kv[u].y, acc[v][u]);
          acc[v][u] = fmaf(qv[v].z, kv[u].z, acc[v][u]);
          acc[v][u] = fmaf(qv[v].w, kv[u].w, acc[v][u]);
        }
    }
    if (tid < kTile) {
#pragma unroll
      for (int ch = 0; ch < QW; ch += 4) {
        const float4 kv = gfs::load4(kt + tid * PK + ch);
        kk = fmaf(kv.x, kv.x, kk);
        kk = fmaf(kv.y, kv.y, kk);
        kk = fmaf(kv.z, kv.z, kk);
        kk = fmaf(kv.w, kv.w, kk);
      }
    }
    if (tile == 0 && lane < kOwn) {
      const float* qp = qt + (kOwn * warp + lane) * PK;
#pragma unroll
      for (int ch = 0; ch < QW; ch += 4) {
        const float4 qv = gfs::load4(qp + ch);
        qq = fmaf(qv.x, qv.x, qq);
        qq = fmaf(qv.y, qv.y, qq);
        qq = fmaf(qv.z, qv.z, qq);
        qq = fmaf(qv.w, qv.w, qq);
      }
    }
    const bool last = cc == chunks - 1;
    if (last) {
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dot_s[(qg + 16 * v) * kDot + kg + 16 * u] = acc[v][u];
      if (tid < kTile) kk_s[tid] = kk;
    }
    __syncthreads();  // dot_s and kk_s are complete; this step's rows read
    if (!last) continue;

    // ---- selection: lane l scores keys l and l + 32 of the tile for each
    // of the warp's queries, all of them before any is appended
    const unsigned below = (1u << lane) - 1;
    fold_key key[kOwn][2];
    bool ok[kOwn][2];
    unsigned m0[kOwn], m1[kOwn];
#pragma unroll
    for (int o = 0; o < kOwn; ++o) {
      const int ql = kOwn * warp + o;
      const float qv = __shfl_sync(0xffffffffu, qq, o);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h, j = base + r;
        const float d = gfs::sq_dist(qv, kk_s[r], dot_s[ql * kDot + r]);
        key[o][h] = (static_cast<fold_key>(__float_as_uint(d) & 0x7fffffffu)
                     << 32) | static_cast<unsigned>(j);
        ok[o][h] = j < n && q0 + ql < nq;
      }
      m0[o] = __ballot_sync(0xffffffffu, ok[o][0] && key[o][0] < thr[o]);
      m1[o] = __ballot_sync(0xffffffffu, ok[o][1] && key[o][1] < thr[o]);
    }
#pragma unroll
    for (int o = 0; o < kOwn; ++o) {
      if ((m0[o] | m1[o]) == 0) continue;
      const int ql = kOwn * warp + o;
      fold_key* list = lists + ql * kl;
      fold_key* queue = queues + ql * kQueue;
      if (fill[o] + __popc(m0[o]) + __popc(m1[o]) > kQueue) {
        thr[o] = merge_queue(list, queue, fill[o], kl, k, lane);
        fill[o] = 0;
        m0[o] = __ballot_sync(0xffffffffu, ok[o][0] && key[o][0] < thr[o]);
        m1[o] = __ballot_sync(0xffffffffu, ok[o][1] && key[o][1] < thr[o]);
      }
      if (m0[o] >> lane & 1u)
        queue[fill[o] + __popc(m0[o] & below)] = key[o][0];
      if (m1[o] >> lane & 1u)
        queue[fill[o] + __popc(m0[o]) + __popc(m1[o] & below)] = key[o][1];
      fill[o] += __popc(m0[o]) + __popc(m1[o]);
      // the first k keys queued while fewer than k are listed: merge now,
      // so that the next tile meets a k-th key
      if (thr[o] == kNoKey && fill[o] >= k) {
        thr[o] = merge_queue(list, queue, fill[o], kl, k, lane);
        fill[o] = 0;
      }
    }
  }

  // ---- the last merge of every queue; idx rows and the statistics
#pragma unroll
  for (int o = 0; o < kOwn; ++o) {
    const int ql = kOwn * warp + o, qi = q0 + ql;
    if (qi >= nq) break;
    fold_key* list = lists + ql * kl;
    if (fill[o] > 0)
      merge_queue(list, queues + ql * kQueue, fill[o], kl, k, lane);
    __syncwarp();
    int* row = idx + (static_cast<size_t>(batch) * nq + qi) * k;
    for (int r = lane; r < k; r += 32)
      row[r] = static_cast<int>(list[r] & 0xffffffffu);
    if constexpr (kStats) {
      const float* brow =
          btab + (static_cast<size_t>(batch) * n + q_off + qi) * cb;
      for (int r = 0; r < k; ++r) {
        const int j = static_cast<int>(list[r] & 0xffffffffu);
        float* srow = scb + (static_cast<size_t>(batch) * n + j) * cb;
        for (int ch = lane; ch < cb; ch += 32) atomicAdd(srow + ch, brow[ch]);
        if (lane == 0)
          atomicAdd(cnt + static_cast<size_t>(batch) * n + j, 1.f);
      }
    }
  }
}

// the lists' length for k: a power of two, at least 32
int stream_list(int k) {
  int kl = 32;
  while (kl < k) kl *= 2;
  return kl;
}

template <int CP, bool kStats>
cudaError_t run_stream(const float* x, int* idx, int batch, int n, int nq,
                       int q_off, int c, int k, const float* btab, float* cnt,
                       float* scb, int cb, cudaStream_t s) {
  const auto kernel = knn_stream_kernel<CP, kStats>;
  const int kl = stream_list(k);
  const size_t smem = stream_smem_bytes<CP>(kl);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kSelQ - 1) / kSelQ, batch);
  kernel<<<grid, kSelThreads, smem, s>>>(x, idx, n, nq, q_off, c, k, kl, btab,
                                         cnt, scb, cb);
  return cudaGetLastError();
}

// the variant by width: CP = 12, 16 or 64 (C zero-padded), or 64-channel
// chunks past 64
template <bool kStats>
cudaError_t run_stream_c(const float* x, int* idx, int batch, int n, int nq,
                         int q_off, int c, int k, const float* btab,
                         float* cnt, float* scb, int cb, cudaStream_t s) {
  if (c <= 12)
    return run_stream<12, kStats>(x, idx, batch, n, nq, q_off, c, k, btab,
                                  cnt, scb, cb, s);
  if (c <= 16)
    return run_stream<16, kStats>(x, idx, batch, n, nq, q_off, c, k, btab,
                                  cnt, scb, cb, s);
  if (c <= 64)
    return run_stream<64, kStats>(x, idx, batch, n, nq, q_off, c, k, btab,
                                  cnt, scb, cb, s);
  return run_stream<0, kStats>(x, idx, batch, n, nq, q_off, c, k, btab, cnt,
                               scb, cb, s);
}

// ---- 2. knn_fold_kernel (k > kCap)

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
                int nq, int q_off, int c, int k, int w,
                const float* __restrict__ btab, float* __restrict__ cnt,
                float* __restrict__ scb, int cb,
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
  const int qi = blockIdx.x * (blockDim.x / 32) + warp;   // of nq
  const bool active = qi < nq;
  const size_t qrow = static_cast<size_t>(q_off) + qi;    // its row of x
  const float* xb = x + static_cast<size_t>(batch) * n * c;
  fold_key* my = keys + static_cast<size_t>(warp) * F * w;
  const int span = F * w;                  // keys of one chunk
  const bool one_chunk = span >= n;
  int* row = idx + (static_cast<size_t>(batch) * nq + qi) * k;
  const float* brow =
      kStats ? btab + (static_cast<size_t>(batch) * n + qrow) * cb : nullptr;
  // the running k best (sorted) and the merge's output, when chunked
  fold_key* run =
      one_chunk || !active
          ? nullptr
          : scratch + (static_cast<size_t>(batch) * nq + qi) * 2 * k;
  fold_key* merged = run == nullptr ? nullptr : run + k;
  int have = 0;

  // the query row (in every lane) and |q|^2, in K6's order
  float q[QW];
  float qq = 0.f;
  if constexpr (kWide) {
    for (int ch = 0; ch < c; ++ch) {
      const float v = active ? xb[qrow * c + ch] : 0.f;
      qq = fmaf(v, v, qq);
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < CP; ++ch) {
      q[ch] = (active && ch < c) ? xb[qrow * c + ch] : 0.f;
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
            q[ch] = (active && c0 + ch < c) ? xb[qrow * c + c0 + ch] : 0.f;
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
cudaError_t run_fold(const float* x, int* idx, int batch, int n, int nq,
                     int q_off, int c, int k, const float* btab, float* cnt,
                     float* scb, int cb, void* scratch, cudaStream_t s) {
  FoldPlan plan;
  cudaError_t err = plan_fold(n, c, F, &plan);
  if (err != cudaSuccess) return err;
  if (plan.chunked && scratch == nullptr) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(knn_fold_kernel<CP, F, kStats>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(plan.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + plan.warps - 1) / plan.warps, batch);
  knn_fold_kernel<CP, F, kStats><<<grid, plan.warps * 32, plan.smem, s>>>(
      x, idx, n, nq, q_off, c, k, plan.w, btab, cnt, scb, cb,
      static_cast<fold_key*>(scratch));
  return cudaGetLastError();
}

template <int F, bool kStats>
cudaError_t run_fold_c(const float* x, int* idx, int batch, int n, int nq,
                       int q_off, int c, int k, const float* btab,
                       float* cnt, float* scb, int cb, void* scratch,
                       cudaStream_t s) {
  if (c <= 16)
    return run_fold<16, F, kStats>(x, idx, batch, n, nq, q_off, c, k, btab,
                                   cnt, scb, cb, scratch, s);
  if (c <= 64)
    return run_fold<64, F, kStats>(x, idx, batch, n, nq, q_off, c, k, btab,
                                   cnt, scb, cb, scratch, s);
  return run_fold<0, F, kStats>(x, idx, batch, n, nq, q_off, c, k, btab, cnt,
                                scb, cb, scratch, s);
}

}  // namespace

namespace gfs {

cudaError_t launch_knn_fold(const float* x, int* idx, int batch, int n,
                            int nq, int q_off, int c, int k, int folds,
                            const float* btab, float* cnt, float* scb, int cb,
                            void* scratch, cudaStream_t s) {
  if (batch < 1 || batch > 65535 || n < 1 || c < 1 || k < 1 || k > n ||
      nq < 1 || q_off < 0 || q_off > n - nq ||
      (folds != 2 && folds != 4 && folds != 8))
    return cudaErrorInvalidValue;
  if (btab != nullptr && cb < 1) return cudaErrorInvalidValue;
  if (k <= kCap)  // the streaming selection (folds: validated, unused)
    return btab != nullptr
               ? run_stream_c<true>(x, idx, batch, n, nq, q_off, c, k, btab,
                                    cnt, scb, cb, s)
               : run_stream_c<false>(x, idx, batch, n, nq, q_off, c, k,
                                     nullptr, nullptr, nullptr, 0, s);
  if (btab != nullptr) {  // K3 for k > kCap: four folds
    if (folds != 4) return cudaErrorInvalidValue;
    return run_fold_c<4, true>(x, idx, batch, n, nq, q_off, c, k, btab, cnt,
                               scb, cb, scratch, s);
  }
  switch (folds) {
    case 2:
      return run_fold_c<2, false>(x, idx, batch, n, nq, q_off, c, k, nullptr,
                                  nullptr, nullptr, 0, scratch, s);
    case 4:
      return run_fold_c<4, false>(x, idx, batch, n, nq, q_off, c, k, nullptr,
                                  nullptr, nullptr, 0, scratch, s);
    case 8:
      return run_fold_c<8, false>(x, idx, batch, n, nq, q_off, c, k, nullptr,
                                  nullptr, nullptr, 0, scratch, s);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t knn_fold_scratch_bytes(int batch, int n, int nq, int c, int k,
                                   int folds, long long* bytes) {
  if (batch < 1 || n < 1 || nq < 1 || nq > n || c < 1 || k < 1 || k > n ||
      (folds != 2 && folds != 4 && folds != 8))
    return cudaErrorInvalidValue;
  *bytes = 0;
  if (k <= kCap) return cudaSuccess;   // the streaming selection
  FoldPlan plan;
  const cudaError_t err = plan_fold(n, c, folds, &plan);
  if (err != cudaSuccess) return err;
  *bytes = plan.chunked ? static_cast<long long>(batch) * nq * 2 * k *
                              static_cast<long long>(sizeof(fold_key))
                        : 0;
  return cudaSuccess;
}

}  // namespace gfs

// K8. x (B, N, C) fp32, idx (B, N, k) int32: contiguous, on one device;
// folds 2, 4 or 8 (the tournament's, past k = 256); scratch:
// gfs_knn_scratch_bytes(..., folds) bytes, or null when that is 0. Returns
// a cudaError_t.
GFS_EXPORT int gfs_knn_fold(const void* x, void* idx, void* scratch,
                            int batch, int n, int c, int k, int folds,
                            void* stream) {
  return static_cast<int>(gfs::launch_knn_fold(
      static_cast<const float*>(x), static_cast<int*>(idx), batch, n, n, 0, c,
      k, folds, nullptr, nullptr, nullptr, 0, scratch,
      static_cast<cudaStream_t>(stream)));
}

// The longest k that K8 (and K1, K3 and K6 past k = 64) runs on the
// streaming selection; past it, the fold-merge tournament.
GFS_EXPORT int gfs_knn_stream_cap() { return kCap; }
