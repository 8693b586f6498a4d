// K4: the fused train-mode EdgeConv block, hand-written for Hopper (sm_90a).
//
// Replaces the TPU op gfs3dseg_gws_tpu/ops/fused_edgeconv_train.py::
// fused_edgeconv_train: K4a (gsf_kernel) its forward Pallas body
// `_gsf_kernel`, K4b (bwd_kernel) its backward body `_bwd_kernel`. The
// torch glue (ops/fused_edgeconv_train.py) computes the batch statistics and
// assembles the gradients in closed form around them. Per block, with
// E = B * N * k edges (i a query, j = idx[i, t] its t-th neighbour):
//
//   e0 = a[j] + b[i];  h1 = leaky(e0 * s1 + t1);  z1 = h1 @ W2
//
// K4a writes, per query, max_t z1 and min_t z1 with their slots t and
// sum_t a[j], and per block sum(h1) and the Gram matrix h1^T h1, from which
// the glue takes the bn2 statistics. K4b recomputes e0, h1 and z1, forms
//
//   dz1 = g2s * ([t == ksel] gsel - c1 - (z1 - mu2) * inv2 * c2)
//   dy1 = (dz1 @ W2^T) * leaky'(pre1),  yhat1 = (e0 - mu1) * inv1
//
// and reduces dW2 = h1^T dz1, sum(dy1), sum(dy1 * yhat1) per block and
// psum[i] = sum_t g1s * dy1 per query, and scatters [g1s * dy1 | yhat1]
// onto the neighbour rows scat[j] with float atomics (their order, and so
// the last bits of scat, vary from run to run). fp32 accuracy throughout
// (3xTF32 where the tensor cores take a product): the TPU's bf16 one-hot
// "gathers" and bf16 residual are Mosaic workarounds. Neither kernel
// writes a (B, N, k, C) edge tensor: the backward gathers a[j] again, from
// L2, instead of reading back a stored one (168 MB at B=16, N=2048).
//
// Per-block sums (Gram, sum h1, dW2, the bn1 sums) go to a (blocks, ...)
// buffer of partials in a fixed order, and the glue sums them: the forward
// statistics and dW2 are the same from run to run.
//
// What bounds them: their products. At B=16, N=2048, k=20, C=W1=64 the
// forward needs 2.7 G FMAs for z1 and 1.4 G for the symmetric Gram matrix
// (c (c + 1) / 2 entries; gsf_kernel computes all c x c), the backward
// 3 x 2.7 G (z1, dW2, dh1) plus 84 M float atomics. For C, W1 <= 64 both
// of K4a's products and K4b's recomputed z1 run on the tensor cores in
// 3xTF32 (csrc/mma_tf32.cuh: 0.049 ms for K4a at the card's TF32 peak,
// against 0.121 ms for its FMAs in fp32); K4b's dW2 and dh1 are fp32 FMAs.
// A block takes kTileQ queries and walks their neighbours a few at a time:
// it builds the step's edge rows (one row = one (query, slot) pair) in
// shared memory, transposed as [channel][row] with a padded stride, and
// runs the products on them: m16n8k8 fragments (see gsf_kernel and
// bwd_kernel), or K1's register-tiled GEMM (each thread an 8 x 8 or 4 x 8
// tile, float4 loads) and the C x C reductions as 4 x 4 tiles whose
// channels are strided by 16, so that the eight lanes of a float4 load
// phase read eight different bank groups. Rows of edges past k or queries
// past N are zero in the buffers and left out of every output: ragged N is
// masked here.
//
// Past C, W1 <= 64 (the fast path above), gsf_wide_kernel and
// bwd_wide_kernel take the same steps with a grid axis over 64-column tiles
// of W1 (and, in K4b, 64-channel chunks of C) and the C channels in chunks
// of 64 through the same buffers; see their comments. Any k: a slot takes
// 16 bits of the packed max/min slots.
#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kMaxW = 64;     // table C and output W1 channels per tile
constexpr int kTileQ = 64;    // queries per block
constexpr int kThreads = 256;

// W2 for a z1 on the tensor cores, split into TF32 hi and lo fragments
// (kW2Frags 16-byte entries, twice the floats of a plain copy)
constexpr int kW2Frags = kMaxW * kMaxW / 2;   // (k-step, n-tile, lane)

// K4a: 4 neighbours per step, 256 edge rows (fwd_row orders them); the
// row stride 260 = 4 mod 32 keeps the fragment loads free of bank
// conflicts. The fast kernel also keeps each warp's running Gram sums
// (kFGram floats) and the gathered rows of the next step (kFStage 16-byte
// chunks, 16 a thread) and the tile's b rows (4 chunks a thread) in shared
// memory: 214,528 bytes.
constexpr int kFChunk = 4;
constexpr int kFRows = kTileQ * kFChunk;
constexpr int kFStride = kFRows + 4;
constexpr int kFGram = (kThreads / 32) * 8 * 4 * 32;
constexpr int kFStage = 16 * kThreads;
constexpr size_t kFwdSmem =
    (static_cast<size_t>(kMaxW) * kFStride + 4 * kW2Frags + kFGram +
     4 * (kFStage + 4 * kThreads) + 2 * kMaxW) *
    sizeof(float);
constexpr size_t kFwdWideSmem =
    (static_cast<size_t>(kMaxW) * kFStride + kMaxW * kMaxW + 2 * kMaxW) *
    sizeof(float);

// K4b: 2 neighbours per step, 128 edge rows (three row buffers and two
// copies of W2 must fit in one block's shared memory)
constexpr int kBChunk = 2;
constexpr int kBRows = kTileQ * kBChunk;
constexpr int kBStride = kBRows + 4;
constexpr size_t kBwdSmem =
    (3 * static_cast<size_t>(kMaxW) * kBStride + 4 * kW2Frags +
     kMaxW * kMaxW + 10 * kMaxW) *
    sizeof(float);
constexpr size_t kBwdWideSmem =
    (3 * static_cast<size_t>(kMaxW) * kBStride + 2 * kMaxW * kMaxW +
     10 * kMaxW) *
    sizeof(float);

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

// acc[R][8] += rows R p .. R p + R - 1 of the [channel][row] buffer h_s
// (row stride `stride`) times columns 8cg .. 8cg + 7 of w_s, over kMaxW
// channels (K1's register tile: R = 8 in gsf_wide_kernel, 4 in K4b). The
// helpers below serve the tiled kernels past kMaxW; bwd_kernel keeps its
// own copy of this loop for dh1, so that its compiled code stays as it was.
template <int R>
__device__ __forceinline__ void tile_gemm(const float* h_s, int stride,
                                          const float* w_s, int p, int cg,
                                          float (&acc)[R][8]) {
#pragma unroll 4
  for (int ch = 0; ch < kMaxW; ++ch) {
    float av[R];
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 a = gfs::load4(&h_s[ch * stride + R * p + i]);
      av[i] = a.x;
      av[i + 1] = a.y;
      av[i + 2] = a.z;
      av[i + 3] = a.w;
    }
    const float4 b0 = gfs::load4(&w_s[ch * kMaxW + 8 * cg]);
    const float4 b1 = gfs::load4(&w_s[ch * kMaxW + 8 * cg + 4]);
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// the bn1 sums' reduction of the tiled K4b: sum0/sum1 (8 channels
// cg + 8j of each of the 32 row groups p) in a fixed order over the groups
// into out[0 * stride + ch] and out[1 * stride + ch] for the channels
// ch0 + ch < c; `red` holds 2 x 32 x kMaxW floats
__device__ __forceinline__ void reduce_bn1_sums(float* red, const float* sum0,
                                                const float* sum1, int p,
                                                int cg, int ch0, int c,
                                                float* out, int stride) {
  __syncthreads();  // every thread is done with the buffer red reuses
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[p * kMaxW + cg + 8 * j] = sum0[j];
    red[32 * kMaxW + p * kMaxW + cg + 8 * j] = sum1[j];
  }
  __syncthreads();
  if (threadIdx.x < 2 * kMaxW) {
    const int which = threadIdx.x / kMaxW, ch = threadIdx.x % kMaxW;
    if (ch0 + ch < c) {
      float s = 0.f;
      for (int g = 0; g < 32; ++g) s += red[which * 32 * kMaxW + g * kMaxW + ch];
      out[which * stride + ch] = s;
    }
  }
}

// running max / min over the neighbours of z1 in acc (rows 0-3: query 2p,
// 4-7: query 2p + 1; row % kFChunk = slot t0 + row % kFChunk) with their
// slots; slots rise, so a strict comparison keeps the first slot of a tie
__device__ __forceinline__ void track_extremes(const float (&acc)[8][8],
                                               int t0, int k,
                                               float (&zmx)[2][8],
                                               float (&zmn)[2][8],
                                               unsigned (&slots)[2][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const unsigned t = t0 + i % kFChunk;
    if (t < static_cast<unsigned>(k)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = acc[i][j];
        const int qi = i / kFChunk;
        if (v > zmx[qi][j]) {
          zmx[qi][j] = v;
          slots[qi][j] = (slots[qi][j] & ~0xffffu) | t;
        }
        if (v < zmn[qi][j]) {
          zmn[qi][j] = v;
          slots[qi][j] = (slots[qi][j] & 0xffffu) | (t << 16);
        }
      }
    }
  }
}

// W2's B fragments, split once a block into w2f: k-step kk takes channels
// 8 kk + 2 t and 8 kk + 2 t + 1 at k-positions t, t + 4 (t = lane % 4) of
// column 8 j + lane / 4; entry (kk, j, lane) holds hi0 hi1 lo0 lo1
__device__ __forceinline__ void split_w2(uint4* w2f, const float* w2, int c,
                                         int w1) {
#pragma unroll
  for (int f = threadIdx.x; f < kW2Frags; f += kThreads) {
    const int l = f % 32, j = (f / 32) % 8, kk = f / 256;
    const int r0 = 8 * kk + 2 * (l % 4), col = 8 * j + l / 4;
    const bool ok = col < w1;
    uint32_t h0, lo0, h1, lo1;
    gfs::split_tf32(ok && r0 < c ? w2[r0 * w1 + col] : 0.f, h0, lo0);
    gfs::split_tf32(ok && r0 + 1 < c ? w2[(r0 + 1) * w1 + col] : 0.f, h1,
                    lo1);
    w2f[f] = make_uint4(h0, h1, lo0, lo1);
  }
}

// z1 = h1 @ W2 on the tensor cores for the warp's MT m-tiles, rows row0 +
// 16 m .. + 15 of the [channel][row] buffer h_s (row stride `stride` = 4
// mod 32, so that the A loads hit 32 banks): all 64 columns as 8 n-tiles,
// 8 k-steps of 3xTF32 into zc (no chain longer than the 64 channels). Each
// product (a_lo b_hi, a_hi b_lo, a_hi b_hi, as gfs::mma_3xtf32 sums them)
// runs over every n-tile and m-tile in turn, with no early exit, so that
// the 8 MT accumulator chains interleave. C fragment i of zc[m][j] is row
// row0 + 16 m + lane / 4 + 8 (i / 2), column 8 j + 2 (lane % 4) + i % 2.
template <int MT>
__device__ __forceinline__ void z1_mma(const float* h_s, int stride, int row0,
                                       const uint4* w2f, int lane,
                                       float (&zc)[MT][8][4]) {
  const int lg = lane / 4, lt = lane % 4;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) zc[m][j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMaxW / 8; ++kk) {
    const float* hk = h_s + (8 * kk + 2 * lt) * stride + row0 + lg;
    gfs::FragA fa[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      gfs::set_a(fa[m], hk[16 * m], hk[16 * m + 8], hk[stride + 16 * m],
                 hk[stride + 16 * m + 8]);
    uint4 fb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) fb[j] = w2f[(kk * 8 + j) * 32 + lane];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        gfs::mma_tf32(zc[m][j], fa[m].lo, {fb[j].x, fb[j].y});
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        gfs::mma_tf32(zc[m][j], fa[m].hi, {fb[j].z, fb[j].w});
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        gfs::mma_tf32(zc[m][j], fa[m].hi, {fb[j].x, fb[j].y});
  }
}

// ------------------------------------------------------------------------
// K4a: the forward's one gather pass. A step builds the edge rows of the
// tile's 64 queries at 4 slots in h_s, row fwd_row(q, u) = query q at slot
// t0 + u: warp w's 32 rows are its queries 8 w .. 8 w + 7 at the 4 slots,
// as two m16n8k8 m-tiles whose fragment rows g and g + 8 are one query at
// two successive slots. z1 = h1 @ W2 runs on the tensor cores in 3xTF32
// (z1_mma, W2 split once a block), and each lane keeps the running max and
// min of its query's columns 8 j + 2 t, + 1 straight from its C fragments:
// no shuffle, no trip through shared memory. The Gram matrix h1^T h1 runs on
// the tensor cores too: A = h1^T and B = h1 are both read from h_s by
// ldmatrix (a 16-row slab of channels is the A fragment of one m-tile and
// the B fragments of two n-tiles); warp w takes the channels 16 (w % 4) ..
// + 15 by all 64 over the step's rows 128 (w / 4) .. + 127 in fresh
// accumulators, added in fp32 to its running sums in shared memory (a
// tensor core truncates as it accumulates), and the two row halves are
// added at the end. The gathered rows a[j] of the next step land in
// shared memory by cp.async while the tensor cores run, so a step's build
// reads shared memory only. snbr and sum h1 stay with the build role, as
// fp32 sums in slot order.
// ------------------------------------------------------------------------
__device__ __forceinline__ int fwd_row(int q, int u) {
  return 32 * (q / 8) + 8 * u + q % 8;
}

// this thread's channels 16 bg .. 16 bg + 15 of `row` into its four
// 16-byte slots of a [chunk][thread] stage by cp.async, zeros past c or
// where !ok: 16 bytes a copy when `vec` (rows 16-byte aligned), else 4
__device__ __forceinline__ void stage_row(float4* stage, const float* row,
                                          bool ok, int bg, int c, bool vec) {
#pragma unroll
  for (int i4 = 0; i4 < 4; ++i4) {
    const int ch = 16 * bg + 4 * i4;
    float* dst = reinterpret_cast<float*>(stage + i4 * kThreads + threadIdx.x);
    if (vec) {
      gfs::cp_async16(dst, row + (ok && ch < c ? ch : 0), ok && ch < c);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gfs::cp_async4(dst + e, row + (ok && ch + e < c ? ch + e : 0),
                       ok && ch + e < c);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
gsf_kernel(const float* __restrict__ a, const float* __restrict__ b,
           const int* __restrict__ idx, const float* __restrict__ s1,
           const float* __restrict__ t1, const float* __restrict__ w2,
           float* __restrict__ snbr, float* __restrict__ zmax_out,
           float* __restrict__ zmin_out, int* __restrict__ kmax_out,
           int* __restrict__ kmin_out, float* __restrict__ part, int n,
           int c, int w1, int k, float slope) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                      // [kMaxW][kFStride]: h1 by channel
  // [kk][j][lane]: hi0 hi1 lo0 lo1 of W2's B fragments
  uint4* w2f = reinterpret_cast<uint4*>(h_s + kMaxW * kFStride);
  // [warp][j][i][lane]: the warps' running Gram sums
  float* gram_s = reinterpret_cast<float*>(w2f + kW2Frags);
  // [4 u + i4][thread]: the step's gathered a rows; [i4][thread]: b rows
  float4* a_st = reinterpret_cast<float4*>(gram_s + kFGram);
  float4* b_st = a_st + kFStage;
  float2* st_s = reinterpret_cast<float2*>(b_st + 4 * kThreads);  // s1, t1

  const int tid = threadIdx.x;
  const int q_base = blockIdx.x * kTileQ;
  const size_t boff = static_cast<size_t>(blockIdx.y) * n;

  // build role: query bq of the tile, 16 channels of group bg; register
  // (i4, e) holds channel fwd_ch(i4, e), rotated by bg so that the 32
  // lanes of a warp write h_s in 32 different banks
  const int bq = tid / 4, bg = tid % 4;
  const int qb = q_base + bq;
  const bool qb_ok = qb < n;
  const int* idx_row = idx + (boff + (qb_ok ? qb : 0)) * k;
  const float* a_b = a + boff * c;
  const bool vec = c % 4 == 0 && (reinterpret_cast<uintptr_t>(a) |
                                  reinterpret_cast<uintptr_t>(b)) % 16 == 0;
  const auto fwd_ch = [bg](int i4, int e) {
    return 16 * bg + 4 * ((i4 + bg / 2) & 3) + ((e + 2 * (bg & 1)) & 3);
  };
  stage_row(b_st, b + (boff + (qb_ok ? qb : 0)) * c, qb_ok, bg, c, vec);
#pragma unroll
  for (int u = 0; u < kFChunk; ++u) {
    const bool ok = qb_ok && u < k;
    stage_row(a_st + u * 4 * kThreads,
              a_b + static_cast<size_t>(ok ? idx_row[u] : 0) * c, ok, bg, c,
              vec);
  }
  gfs::cp_async_commit();

  split_w2(w2f, w2, c, w1);
  for (int ch = tid; ch < kMaxW; ch += kThreads)
    st_s[ch] = ch < c ? make_float2(s1[ch], t1[ch]) : make_float2(0.f, 0.f);
  float snbr_acc[4][4], sumh1[4][4];
#pragma unroll
  for (int i4 = 0; i4 < 4; ++i4)
#pragma unroll
    for (int e = 0; e < 4; ++e) snbr_acc[i4][e] = sumh1[i4][e] = 0.f;

  // tensor-core role: lane = 4 lg + lt (the fragment's row group g and
  // k-position t). z1: query 8 warp + lg, columns 8 j + 2 lt + e
  const int warp = tid / 32, lane = tid % 32, lg = lane / 4, lt = lane % 4;
  float zmx[8][2], zmn[8][2];
  unsigned slots[8][2];  // kmax | kmin << 16
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      zmx[j][e] = -INFINITY;
      zmn[j][e] = INFINITY;
      slots[j][e] = 0;
    }
  // Gram: channels 16 gm + lg (+ 8) by 8 j + 2 lt (+ 1), rows of half gh;
  // entry (j, i) of this lane's running sums at gram_w[(4 j + i) * 32]
  const int gm = warp % 4, gh = warp / 4;
  float* gram_w = gram_s + warp * 8 * 4 * 32 + lane;
#pragma unroll
  for (int f = 0; f < 32; ++f) gram_w[f * 32] = 0.f;
  // ldmatrix rows of this lane: channel 8 ((lane / 8) % 2) + lane % 8 of a
  // 16-channel slab, k offset 4 (lane / 16)
  const float* ld_base =
      h_s + (8 * ((lane / 8) % 2) + lane % 8) * kFStride + 4 * (lane / 16) +
      kFRows / 2 * gh;

  for (int t0 = 0; t0 < k; t0 += kFChunk) {
    int nidx[kFChunk];   // the next step's neighbours, loaded early
#pragma unroll
    for (int u = 0; u < kFChunk; ++u) {
      const int t = t0 + kFChunk + u;
      nidx[u] = qb_ok && t < k ? idx_row[t] : 0;
    }
    gfs::cp_async_wait<0>();  // this thread's rows of the step have landed
    __syncthreads();          // the previous step's products are done with h_s
    // register (i4, e) reads chunk (i4 + bg / 2) % 4 of the stage, its
    // halves swapped for odd bg
    float bm[4][4];
#pragma unroll
    for (int i4 = 0; i4 < 4; ++i4) {
      float4 bv = b_st[((i4 + bg / 2) & 3) * kThreads + tid];
      if (bg & 1) bv = make_float4(bv.z, bv.w, bv.x, bv.y);
      bm[i4][0] = bv.x;
      bm[i4][1] = bv.y;
      bm[i4][2] = bv.z;
      bm[i4][3] = bv.w;
    }
#pragma unroll
    for (int u = 0; u < kFChunk; ++u) {
      const bool ok = qb_ok && t0 + u < k;
      const int r = fwd_row(bq, u);
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) {
        float4 av = a_st[(4 * u + ((i4 + bg / 2) & 3)) * kThreads + tid];
        if (bg & 1) av = make_float4(av.z, av.w, av.x, av.y);
        const float am[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = fwd_ch(i4, e);
          float h = 0.f;
          if (ok && ch < c) {
            const float2 st = st_s[ch];
            snbr_acc[i4][e] += am[e];
            h = gfs::leaky(fmaf(am[e] + bm[i4][e], st.x, st.y), slope);
            sumh1[i4][e] += h;
          }
          h_s[ch * kFStride + r] = h;
        }
      }
    }
    __syncthreads();  // h_s is whole; every thread is done with its stage
    if (t0 + kFChunk < k) {
#pragma unroll
      for (int u = 0; u < kFChunk; ++u) {
        const bool ok = qb_ok && t0 + kFChunk + u < k;
        stage_row(a_st + u * 4 * kThreads,
                  a_b + static_cast<size_t>(nidx[u]) * c, ok, bg, c, vec);
      }
      gfs::cp_async_commit();
    }

    // z1 of the warp's 32 rows; the running max / min over the slots, in
    // rising slot order, so a strict comparison keeps the first slot of a
    // tie (rows of absent slots are left out; those of queries past n are
    // not written)
    {
      float zc[2][8][4];
      z1_mma<2>(h_s, kFStride, 32 * warp, w2f, lane, zc);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const unsigned t = t0 + 2 * m + hf;
          if (t < static_cast<unsigned>(k)) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float v = zc[m][j][2 * hf + e];
                if (v > zmx[j][e]) {
                  zmx[j][e] = v;
                  slots[j][e] = (slots[j][e] & ~0xffffu) | t;
                }
                if (v < zmn[j][e]) {
                  zmn[j][e] = v;
                  slots[j][e] = (slots[j][e] & 0xffffu) | (t << 16);
                }
              }
          }
        }
    }

    // Gram matrix over the step's rows (rows of absent edges are zero):
    // 16 k-steps of 8 rows in fresh accumulators
    {
      float gc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) gc[j][i] = 0.f;
#pragma unroll 2
      for (int s = 0; s < kFRows / 16; ++s) {
        uint32_t slab[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          gfs::ldmatrix_x4(slab[i], ld_base + 16 * i * kFStride + 8 * s);
        uint32_t ra[4];
        gfs::ldmatrix_x4(ra, ld_base + 16 * gm * kFStride + 8 * s);
        gfs::FragA fa;
        gfs::set_a(fa, __uint_as_float(ra[0]), __uint_as_float(ra[1]),
                   __uint_as_float(ra[2]), __uint_as_float(ra[3]));
        gfs::FragB fb[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          gfs::set_b(fb[j], __uint_as_float(slab[j / 2][j % 2]),
                     __uint_as_float(slab[j / 2][2 + j % 2]));
#pragma unroll
        for (int j = 0; j < 8; ++j) gfs::mma_tf32(gc[j], fa.lo, fb[j].hi);
#pragma unroll
        for (int j = 0; j < 8; ++j) gfs::mma_tf32(gc[j], fa.hi, fb[j].lo);
#pragma unroll
        for (int j = 0; j < 8; ++j) gfs::mma_tf32(gc[j], fa.hi, fb[j].hi);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) gram_w[(4 * j + i) * 32] += gc[j][i];
    }
  }

  // per-query outputs
  if (qb_ok) {
#pragma unroll
    for (int i4 = 0; i4 < 4; ++i4)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = fwd_ch(i4, e);
        if (ch < c) snbr[(boff + qb) * c + ch] = snbr_acc[i4][e];
      }
  }
  const int qz = q_base + 8 * warp + lg;
  if (qz < n) {
    const size_t row = (boff + qz) * w1;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = 8 * j + 2 * lt + e;
        if (o < w1) {
          zmax_out[row + o] = zmx[j][e];
          zmin_out[row + o] = zmn[j][e];
          kmax_out[row + o] = slots[j][e] & 0xffffu;
          kmin_out[row + o] = slots[j][e] >> 16;
        }
      }
  }
  // block partials: [sum h1 (c) | Gram (c x c)]; sum h1 in a fixed order
  // over the tile's queries, the Gram's two row halves added in order
  __syncthreads();
  float* red = h_s;  // [kTileQ][kMaxW]: sum h1
#pragma unroll
  for (int i4 = 0; i4 < 4; ++i4)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[bq * kMaxW + fwd_ch(i4, e)] = sumh1[i4][e];
  __syncthreads();
  float* prow = part + (static_cast<size_t>(blockIdx.y) * gridDim.x +
                        blockIdx.x) * (c + c * c);
  if (tid < c) {
    float s = 0.f;
    for (int q = 0; q < kTileQ; ++q) s += red[q * kMaxW + tid];
    prow[tid] = s;
  }
  if (gh == 0) {
    const float* other = gram_w + 4 * 8 * 4 * 32;  // warp + 4: half 1
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c1 = 16 * gm + lg + 8 * (i / 2), c2 = 8 * j + 2 * lt + i % 2;
        if (c1 < c && c2 < c)
          prow[c + c1 * c + c2] =
              gram_w[(4 * j + i) * 32] + other[(4 * j + i) * 32];
      }
  }
}

// ------------------------------------------------------------------------
// K4b: the backward, gathering a[j] again. Each step's z1 = h1 @ W2 runs on
// the tensor cores: warp w takes edge rows 16 w .. 16 w + 15 of h_s (the
// rows of one m16n8k8 tile: queries 8 w .. 8 w + 7 times the step's two
// slots) and all 64 columns as 8 n-tiles, 8 k-steps of 3xTF32 in fresh
// accumulators (no chain longer than the 64 channels; the n-tile loop has
// no early exit, so the 8 accumulator chains interleave), and forms dz1
// straight from the C fragments into dz_s. k-step kk takes channel 8 kk +
// 2 t at k-position t and 8 kk + 2 t + 1 at t + 4: with h_s's stride of
// 132 = 4 mod 32 floats the A loads of a warp hit 32 different banks. W2
// is split into hi and lo once a block and kept in fragment order (one
// 16-byte load a lane per B fragment), as in edge_mma_kernel. dW2 and dh1
// stay fp32 register tiles.
// ------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
           const int* __restrict__ idx, const float* __restrict__ p1,
           const float* __restrict__ w2, const float* __restrict__ gsel,
           const int* __restrict__ ksel, const float* __restrict__ pk,
           float* __restrict__ scat, float* __restrict__ psum,
           float* __restrict__ part, int n, int c, int w1, int k,
           float slope) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                       // [kMaxW][kBStride]: h1
  float* y_s = h_s + kMaxW * kBStride;     // [kMaxW][kBStride]: yhat1
  float* dz_s = y_s + kMaxW * kBStride;    // [kMaxW][kBStride]: dz1 by column
  // [kk][j][lane]: hi0 hi1 lo0 lo1 of W2's B fragments
  uint4* w2f = reinterpret_cast<uint4*>(dz_s + kMaxW * kBStride);
  float* w2tp_s = reinterpret_cast<float*>(w2f + kW2Frags);
                                           // [o][8cg + j] = W2[cg + 8j][o]
  float* p1_s = w2tp_s + kMaxW * kMaxW;    // [5][kMaxW]: s1 t1 mu1 inv1 g1s
  float* pk_s = p1_s + 5 * kMaxW;          // [5][kMaxW]: g2s c1 c2 mu2 inv2

  const int tid = threadIdx.x;
  const int q_base = blockIdx.x * kTileQ;
  const size_t boff = static_cast<size_t>(blockIdx.y) * n;

  split_w2(w2f, w2, c, w1);
  for (int e = tid; e < kMaxW * kMaxW; e += kThreads) {
    const int row = e / kMaxW, col = e % kMaxW;
    const int strided = col / 8 + 8 * (col % 8);   // cg + 8j of col = 8cg + j
    w2tp_s[e] = (row < w1 && strided < c) ? w2[strided * w1 + row] : 0.f;
  }
  for (int e = tid; e < 5 * kMaxW; e += kThreads) {
    const int i = e / kMaxW, ch = e % kMaxW;
    p1_s[e] = ch < c ? p1[i * c + ch] : 0.f;
    pk_s[e] = ch < w1 ? pk[i * w1 + ch] : 0.f;
  }
  const float* s1_s = p1_s;
  const float* t1_s = p1_s + kMaxW;
  const float* mu1_s = p1_s + 2 * kMaxW;
  const float* inv1_s = p1_s + 3 * kMaxW;
  const float* g1s_s = p1_s + 4 * kMaxW;
  const float* g2s_s = pk_s;
  const float* c1_s = pk_s + kMaxW;
  const float* c2_s = pk_s + 2 * kMaxW;
  const float* mu2_s = pk_s + 3 * kMaxW;
  const float* inv2_s = pk_s + 4 * kMaxW;

  // build role: query bq of the tile, channels bc .. bc + 15
  const int bq = tid / 4, bc = (tid % 4) * 16;
  const int qb = q_base + bq;
  const bool qb_ok = qb < n;
  const float* b_row = b + (boff + (qb_ok ? qb : 0)) * c;
  const int* idx_row = idx + (boff + (qb_ok ? qb : 0)) * k;
  const float* a_b = a + boff * c;

  // tensor-core role (z1, dz1): the warp's 16 rows, fragment lane = 4 lg +
  // lt (lg = the fragment's row group g, lt its k-position t)
  const int warp = tid / 32, lg = (tid % 32) / 4, lt = tid % 4;
  // GEMM role (dh1): rows 4p .. 4p + 3 = queries 2p, 2p + 1 times the
  // step's two slots, channels cg + 8j
  const int p = tid / 8, cg = tid % 8;
  float ps[2][8], sum0[8], sum1[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ps[0][j] = ps[1][j] = 0.f;
    sum0[j] = sum1[j] = 0.f;
  }
  // dW2 role: channels g1 + 16 ii by columns g2 + 16 jj
  const int g1 = tid / 16, g2 = tid % 16;
  float dw2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dw2[i][j] = 0.f;

  for (int t0 = 0; t0 < k; t0 += kBChunk) {
    __syncthreads();  // the previous step is done with h_s, y_s and dz_s
#pragma unroll
    for (int u = 0; u < kBChunk; ++u) {
      const int t = t0 + u;
      const bool ok = qb_ok && t < k;
      const float* a_row = a_b + static_cast<size_t>(ok ? idx_row[t] : 0) * c;
      const int r = bq * kBChunk + u;
#pragma unroll
      for (int cc = 0; cc < 16; ++cc) {
        const int ch = bc + cc;
        float h = 0.f, y = 0.f;
        if (ok && ch < c) {
          const float e0 = a_row[ch] + b_row[ch];
          h = gfs::leaky(fmaf(e0, s1_s[ch], t1_s[ch]), slope);
          y = (e0 - mu1_s[ch]) * inv1_s[ch];
        }
        h_s[ch * kBStride + r] = h;
        y_s[ch * kBStride + r] = y;
      }
    }
    __syncthreads();

    // z1 = h1 @ W2 on the tensor cores, then dz1 into dz_s
    float zc[1][8][4];
    z1_mma<1>(h_s, kBStride, 16 * warp, w2f, tid % 32, zc);
    // C fragment i: row lg + 8 (i / 2), column 8 j + 2 lt + i % 2; row r is
    // query r / 2, slot t0 + r % 2, as the build phase lays them out
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * warp + lg + 8 * (i / 2);
      const int t = t0 + r % kBChunk;
      const int q = q_base + r / kBChunk;
      const bool ok = q < n && t < k;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = 8 * j + 2 * lt + i % 2;
        float dz = 0.f;
        if (ok && o < w1) {
          const size_t qo = (boff + q) * w1 + o;
          const float dy2 = ksel[qo] == t ? gsel[qo] : 0.f;
          dz = g2s_s[o] *
               (dy2 - c1_s[o] - (zc[0][j][i] - mu2_s[o]) * inv2_s[o] * c2_s[o]);
        }
        dz_s[o * kBStride + r] = dz;
      }
    }
    __syncthreads();

    // dW2 += h1^T dz1 over the step's rows (absent edges are zero in both)
    for (int r = 0; r < kBRows; r += 4) {
      float4 x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = gfs::load4(&h_s[(g1 + 16 * i) * kBStride + r]);
        y[i] = gfs::load4(&dz_s[(g2 + 16 * i) * kBStride + r]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dw2[i][j] = dot4(x[i], y[j], dw2[i][j]);
    }

    // dh1 = dz1 @ W2^T, then dy1, the bn1 sums, psum and the scatter
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int o = 0; o < kMaxW; ++o) {
      const float4 a0 = gfs::load4(&dz_s[o * kBStride + 4 * p]);
      const float4 b0 = gfs::load4(&w2tp_s[o * kMaxW + 8 * cg]);
      const float4 b1 = gfs::load4(&w2tp_s[o * kMaxW + 8 * cg + 4]);
      const float av[4] = {a0.x, a0.y, a0.z, a0.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + i % kBChunk;
      const int qi = 2 * p + i / kBChunk;
      const int q = q_base + qi;
      if (q >= n || t >= k) continue;
      const int nbr = idx[(boff + q) * k + t];
      float* srow = scat + (boff + nbr) * (2 * c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = cg + 8 * j;
        if (ch < c) {
          const int r = 4 * p + i;
          const float y = y_s[ch * kBStride + r];
          // h1 >= 0 exactly where pre1 >= 0 (leaky keeps the sign)
          const float dy =
              h_s[ch * kBStride + r] >= 0.f ? acc[i][j] : slope * acc[i][j];
          const float g = g1s_s[ch] * dy;
          sum0[j] += dy;
          sum1[j] = fmaf(dy, y, sum1[j]);
          ps[i / kBChunk][j] += g;
          atomicAdd(srow + ch, g);
          atomicAdd(srow + c + ch, y);
        }
      }
    }
  }

  // per-query sums over the neighbours
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q_base + 2 * p + i;
    if (q >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ch = cg + 8 * j;
      if (ch < c) psum[(boff + q) * c + ch] = ps[i][j];
    }
  }
  // block partials: [dW2 (c x w1) | sum dy1 (c) | sum dy1 * yhat1 (c)]
  float* prow = part + (static_cast<size_t>(blockIdx.y) * gridDim.x +
                        blockIdx.x) * (c * w1 + 2 * c);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = g1 + 16 * i, o = g2 + 16 * j;
      if (ch < c && o < w1) prow[ch * w1 + o] = dw2[i][j];
    }
  // the bn1 sums in a fixed order over the 32 row groups
  __syncthreads();
  float* red = h_s;  // [2][32][kMaxW]
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[p * kMaxW + cg + 8 * j] = sum0[j];
    red[32 * kMaxW + p * kMaxW + cg + 8 * j] = sum1[j];
  }
  __syncthreads();
  if (tid < 2 * kMaxW) {
    const int which = tid / kMaxW, ch = tid % kMaxW;
    if (ch < c) {
      float s = 0.f;
      for (int g = 0; g < 32; ++g) s += red[which * 32 * kMaxW + g * kMaxW + ch];
      prow[c * w1 + which * c + ch] = s;
    }
  }
}

// ------------------------------------------------------------------------
// K4a past kMaxW: blockIdx.z takes the output columns col0 .. col0 + 63
// (col0 = 64 z); each step walks C in chunks of kMaxW through h_s and w2_s,
// carrying the z1 accumulators across the chunks. Instead of sum(h1) and the
// C x C Gram matrix it reduces sum z1 and sum z1^2 per output column (the
// bn2 statistics directly) into part (blocks, 2 W1). snbr is added by the
// z = 0 blocks straight into the zeroed output, one thread per (query,
// channel).
// ------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
gsf_wide_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const int* __restrict__ idx, const float* __restrict__ s1,
                const float* __restrict__ t1, const float* __restrict__ w2,
                float* __restrict__ snbr, float* __restrict__ zmax_out,
                float* __restrict__ zmin_out, int* __restrict__ kmax_out,
                int* __restrict__ kmin_out, float* __restrict__ part, int n,
                int c, int w1, int k, float slope) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                      // [kMaxW][kFStride]: a chunk of h1
  float* w2_s = h_s + kMaxW * kFStride;   // [kMaxW][kMaxW]: W2[chunk, cols]

  const int tid = threadIdx.x;
  const int q_base = blockIdx.x * kTileQ;
  const size_t boff = static_cast<size_t>(blockIdx.y) * n;
  const int col0 = blockIdx.z * kMaxW;
  const bool own_snbr = blockIdx.z == 0;

  // build role: query bq of the tile, channels bc .. bc + 15 of the chunk
  const int bq = tid / 4, bc = (tid % 4) * 16;
  const int qb = q_base + bq;
  const bool qb_ok = qb < n;
  const float* b_row = b + (boff + (qb_ok ? qb : 0)) * c;
  const int* idx_row = idx + (boff + (qb_ok ? qb : 0)) * k;
  const float* a_b = a + boff * c;
  float* snbr_row = snbr + (boff + (qb_ok ? qb : 0)) * c;

  // GEMM role (K1's tile): rows 8p .. 8p + 7 = queries 2p, 2p + 1 times
  // the step's kFChunk slots, output columns col0 + 8cg .. + 7
  const int p = tid / 8, cg = tid % 8;
  float zmx[2][8], zmn[2][8], zs[8], zs2[8];
  unsigned slots[2][8];  // kmax | kmin << 16
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    zs[j] = zs2[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      zmx[i][j] = -INFINITY;
      zmn[i][j] = INFINITY;
      slots[i][j] = 0;
    }
  }

  for (int t0 = 0; t0 < k; t0 += kFChunk) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int c0 = 0; c0 < c; c0 += kMaxW) {
      __syncthreads();  // the previous GEMM is done with h_s and w2_s
      for (int e = tid; e < kMaxW * kMaxW; e += kThreads) {
        const int r = e / kMaxW, o = e % kMaxW;
        w2_s[e] = (c0 + r < c && col0 + o < w1)
                      ? w2[static_cast<size_t>(c0 + r) * w1 + col0 + o]
                      : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kFChunk; ++u) {
        const int t = t0 + u;
        const bool ok = qb_ok && t < k;
        const float* a_row =
            a_b + static_cast<size_t>(ok ? idx_row[t] : 0) * c;
        const int r = bq * kFChunk + u;
#pragma unroll
        for (int cc = 0; cc < 16; ++cc) {
          const int ch = c0 + bc + cc;
          float h = 0.f;
          if (ok && ch < c) {
            const float av = a_row[ch];
            if (own_snbr) snbr_row[ch] += av;
            h = gfs::leaky(fmaf(av + b_row[ch], s1[ch], t1[ch]), slope);
          }
          h_s[(bc + cc) * kFStride + r] = h;
        }
      }
      __syncthreads();
      tile_gemm<8>(h_s, kFStride, w2_s, p, cg, acc);
    }
    track_extremes(acc, t0, k, zmx, zmn, slots);
    // absent edges have h1 = 0 and so z1 = 0: they add nothing
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        zs[j] += acc[i][j];
        zs2[j] = fmaf(acc[i][j], acc[i][j], zs2[j]);
      }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q_base + 2 * p + i;
    if (qi >= n) continue;
    const size_t row = (boff + qi) * w1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = col0 + 8 * cg + j;
      if (o < w1) {
        zmax_out[row + o] = zmx[i][j];
        zmin_out[row + o] = zmn[i][j];
        kmax_out[row + o] = slots[i][j] & 0xffffu;
        kmin_out[row + o] = slots[i][j] >> 16;
      }
    }
  }
  // block partials [sum z1 (w1) | sum z1^2 (w1)], in a fixed order over the
  // 32 row groups
  __syncthreads();
  float* red = h_s;  // [2][32][kMaxW]
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[p * kMaxW + 8 * cg + j] = zs[j];
    red[32 * kMaxW + p * kMaxW + 8 * cg + j] = zs2[j];
  }
  __syncthreads();
  if (tid < 2 * kMaxW) {
    const int which = tid / kMaxW, o = tid % kMaxW;
    if (col0 + o < w1) {
      float s = 0.f;
      for (int g = 0; g < 32; ++g) s += red[which * 32 * kMaxW + g * kMaxW + o];
      part[(static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * 2 * w1 +
           which * w1 + col0 + o] = s;
    }
  }
}

// ------------------------------------------------------------------------
// K4b past kMaxW: blockIdx.z = ot + OT ct takes the output columns col0 =
// 64 ot .. col0 + 63 and the channels ch0 = 64 ct .. ch0 + 63. Each step
// forms z1 over all of C in chunks (chunk ct last, so that h_s and y_s hold
// it afterwards) and dz1 for the block's columns, then dW2[chunk ct,
// columns ot] and the share of dh1 = dz1 W2^T that the block's columns
// give to chunk ct. dy1 and all that follows from it are linear in dh1, so
// the OT column tiles' shares add up: scat by float atomics (its yhat1
// half once, from ot = 0), psum into slice ot of psum (OT, B, N, C) and the
// bn1 sums into slot ot of part (blocks, C W1 + OT 2 C), which the glue
// adds.
// ------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
bwd_wide_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const int* __restrict__ idx, const float* __restrict__ p1,
                const float* __restrict__ w2, const float* __restrict__ gsel,
                const int* __restrict__ ksel, const float* __restrict__ pk,
                float* __restrict__ scat, float* __restrict__ psum,
                float* __restrict__ part, int n, int c, int w1, int k,
                float slope) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                       // [kMaxW][kBStride]: h1 chunk
  float* y_s = h_s + kMaxW * kBStride;     // [kMaxW][kBStride]: yhat1 chunk
  float* dz_s = y_s + kMaxW * kBStride;    // [kMaxW][kBStride]: dz1 by column
  // [ch][8cg + j] = W2[c0 + ch][col0 + cg + 8j] for the current chunk
  float* w2p_s = dz_s + kMaxW * kBStride;
  // [o][8cg + j] = W2[ch0 + cg + 8j][col0 + o]
  float* w2tp_s = w2p_s + kMaxW * kMaxW;
  float* pk_s = w2tp_s + kMaxW * kMaxW;    // [5][kMaxW]: g2s c1 c2 mu2 inv2

  const int tid = threadIdx.x;
  const int q_base = blockIdx.x * kTileQ;
  const size_t boff = static_cast<size_t>(blockIdx.y) * n;
  const int n_ot = (w1 + kMaxW - 1) / kMaxW, n_ct = (c + kMaxW - 1) / kMaxW;
  const int ot = blockIdx.z % n_ot, ct = blockIdx.z / n_ot;
  const int col0 = ot * kMaxW, ch0 = ct * kMaxW;

  for (int e = tid; e < kMaxW * kMaxW; e += kThreads) {
    const int o = e / kMaxW, col = e % kMaxW;
    const int strided = col / 8 + 8 * (col % 8);
    w2tp_s[e] = (col0 + o < w1 && ch0 + strided < c)
                    ? w2[static_cast<size_t>(ch0 + strided) * w1 + col0 + o]
                    : 0.f;
  }
  for (int e = tid; e < 5 * kMaxW; e += kThreads) {
    const int i = e / kMaxW, o = e % kMaxW;
    pk_s[e] = col0 + o < w1 ? pk[i * w1 + col0 + o] : 0.f;
  }
  const float* s1 = p1;
  const float* t1 = p1 + c;
  const float* mu1 = p1 + 2 * c;
  const float* inv1 = p1 + 3 * c;
  const float* g1s = p1 + 4 * c;
  const float* g2s_s = pk_s;
  const float* c1_s = pk_s + kMaxW;
  const float* c2_s = pk_s + 2 * kMaxW;
  const float* mu2_s = pk_s + 3 * kMaxW;
  const float* inv2_s = pk_s + 4 * kMaxW;

  // build role: query bq of the tile, channels bc .. bc + 15 of a chunk
  const int bq = tid / 4, bc = (tid % 4) * 16;
  const int qb = q_base + bq;
  const bool qb_ok = qb < n;
  const float* b_row = b + (boff + (qb_ok ? qb : 0)) * c;
  const int* idx_row = idx + (boff + (qb_ok ? qb : 0)) * k;
  const float* a_b = a + boff * c;

  // GEMM role (K4b's tile): rows 4p .. 4p + 3, columns / channels cg + 8j
  const int p = tid / 8, cg = tid % 8;
  float ps[2][8], sum0[8], sum1[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ps[0][j] = ps[1][j] = 0.f;
    sum0[j] = sum1[j] = 0.f;
  }
  // dW2 role: channels ch0 + g1 + 16 ii by columns col0 + g2 + 16 jj
  const int g1 = tid / 16, g2 = tid % 16;
  float dw2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dw2[i][j] = 0.f;

  for (int t0 = 0; t0 < k; t0 += kBChunk) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int s = 1; s <= n_ct; ++s) {
      const int c0 = ((ct + s) % n_ct) * kMaxW;
      __syncthreads();  // the previous step / chunk is done with the buffers
      for (int e = tid; e < kMaxW * kMaxW; e += kThreads) {
        const int row = e / kMaxW, col = e % kMaxW;
        const int strided = col / 8 + 8 * (col % 8);
        w2p_s[e] = (c0 + row < c && col0 + strided < w1)
                       ? w2[static_cast<size_t>(c0 + row) * w1 + col0 + strided]
                       : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBChunk; ++u) {
        const int t = t0 + u;
        const bool ok = qb_ok && t < k;
        const float* a_row =
            a_b + static_cast<size_t>(ok ? idx_row[t] : 0) * c;
        const int r = bq * kBChunk + u;
#pragma unroll
        for (int cc = 0; cc < 16; ++cc) {
          const int ch = c0 + bc + cc;
          float h = 0.f, y = 0.f;
          if (ok && ch < c) {
            const float e0 = a_row[ch] + b_row[ch];
            h = gfs::leaky(fmaf(e0, s1[ch], t1[ch]), slope);
            y = (e0 - mu1[ch]) * inv1[ch];
          }
          h_s[(bc + cc) * kBStride + r] = h;
          y_s[(bc + cc) * kBStride + r] = y;
        }
      }
      __syncthreads();
      tile_gemm<4>(h_s, kBStride, w2p_s, p, cg, acc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + i % kBChunk;
      const int q = q_base + 2 * p + i / kBChunk;
      const bool ok = q < n && t < k;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = cg + 8 * j;
        float dz = 0.f;
        if (ok && col0 + o < w1) {
          const size_t qo = (boff + q) * w1 + col0 + o;
          const float dy2 = ksel[qo] == t ? gsel[qo] : 0.f;
          dz = g2s_s[o] *
               (dy2 - c1_s[o] - (acc[i][j] - mu2_s[o]) * inv2_s[o] * c2_s[o]);
        }
        dz_s[o * kBStride + 4 * p + i] = dz;
      }
    }
    __syncthreads();

    for (int r = 0; r < kBRows; r += 4) {
      float4 x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = gfs::load4(&h_s[(g1 + 16 * i) * kBStride + r]);
        y[i] = gfs::load4(&dz_s[(g2 + 16 * i) * kBStride + r]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dw2[i][j] = dot4(x[i], y[j], dw2[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    tile_gemm<4>(dz_s, kBStride, w2tp_s, p, cg, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + i % kBChunk;
      const int q = q_base + 2 * p + i / kBChunk;
      if (q >= n || t >= k) continue;
      const int nbr = idx[(boff + q) * k + t];
      float* srow = scat + (boff + nbr) * (2 * c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = cg + 8 * j, ch = ch0 + cl;
        if (ch < c) {
          const int r = 4 * p + i;
          const float y = y_s[cl * kBStride + r];
          const float dy =
              h_s[cl * kBStride + r] >= 0.f ? acc[i][j] : slope * acc[i][j];
          const float g = g1s[ch] * dy;
          sum0[j] += dy;
          sum1[j] = fmaf(dy, y, sum1[j]);
          ps[i / kBChunk][j] += g;
          atomicAdd(srow + ch, g);
          if (ot == 0) atomicAdd(srow + c + ch, y);
        }
      }
    }
  }

  float* psum_t = psum + static_cast<size_t>(ot) * gridDim.y * n * c;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q_base + 2 * p + i;
    if (q >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ch = ch0 + cg + 8 * j;
      if (ch < c) psum_t[(boff + q) * c + ch] = ps[i][j];
    }
  }
  float* prow = part + (static_cast<size_t>(blockIdx.y) * gridDim.x +
                        blockIdx.x) * (static_cast<size_t>(c) * w1 + 2 * c * n_ot);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = ch0 + g1 + 16 * i, o = col0 + g2 + 16 * j;
      if (ch < c && o < w1) prow[static_cast<size_t>(ch) * w1 + o] = dw2[i][j];
    }
  reduce_bn1_sums(h_s, sum0, sum1, p, cg, ch0, c,
                  prow + static_cast<size_t>(c) * w1 + 2 * c * ot + ch0, c);
}

bool bad_shape(int batch, int n, int c, int w1, int k) {
  return batch < 1 || batch > 65535 || n < 1 || c < 1 || w1 < 1 || k < 1 ||
         k > n || k > 65535;
}

bool is_wide(int c, int w1) { return c > kMaxW || w1 > kMaxW; }

}  // namespace

// K4a. a, b (B, N, C), s1, t1 (C), w2 (C, W1) fp32 and idx (B, N, k) int32
// in; snbr (B, N, C), zmax, zmin (B, N, W1) fp32, kmax, kmin (B, N, W1)
// int32 and part (B * ceil(N / 64), C + C * C) fp32 out: contiguous, on one
// device. Past C, W1 <= 64, snbr must be zeroed and part is
// (B * ceil(N / 64), 2 W1). Returns a cudaError_t.
GFS_EXPORT int gfs_edgeconv_train_fwd(const void* a, const void* b,
                                      const void* idx, const void* s1,
                                      const void* t1, const void* w2,
                                      void* snbr, void* zmax, void* zmin,
                                      void* kmax, void* kmin, void* part,
                                      int batch, int n, int c, int w1, int k,
                                      float slope, void* stream) {
  if (bad_shape(batch, n, c, w1, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = is_wide(c, w1);
  const auto kern = wide ? gsf_wide_kernel : gsf_kernel;
  const size_t smem = wide ? kFwdWideSmem : kFwdSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTileQ - 1) / kTileQ, batch,
                  wide ? (w1 + kMaxW - 1) / kMaxW : 1);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const int*>(idx), static_cast<const float*>(s1),
      static_cast<const float*>(t1), static_cast<const float*>(w2),
      static_cast<float*>(snbr), static_cast<float*>(zmax),
      static_cast<float*>(zmin), static_cast<int*>(kmax),
      static_cast<int*>(kmin), static_cast<float*>(part), n, c, w1, k, slope);
  return static_cast<int>(cudaGetLastError());
}

// K4b. a, b (B, N, C), p1 (5, C), w2 (C, W1), gsel (B, N, W1), pk (5, W1)
// fp32 and idx (B, N, k), ksel (B, N, W1) int32 in; scat (B, N, 2C) fp32
// zeroed by the caller, psum (B, N, C) and part (B * ceil(N / 64),
// C * W1 + 2C) fp32 out: contiguous, on one device. Past C, W1 <= 64, psum
// is (OT, B, N, C) and part (B * ceil(N / 64), C * W1 + OT * 2C) with OT =
// ceil(W1 / 64), to be summed over OT. Returns a cudaError_t.
GFS_EXPORT int gfs_edgeconv_train_bwd(const void* a, const void* b,
                                      const void* idx, const void* p1,
                                      const void* w2, const void* gsel,
                                      const void* ksel, const void* pk,
                                      void* scat, void* psum, void* part,
                                      int batch, int n, int c, int w1, int k,
                                      float slope, void* stream) {
  if (bad_shape(batch, n, c, w1, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = is_wide(c, w1);
  const auto kern = wide ? bwd_wide_kernel : bwd_kernel;
  const size_t smem = wide ? kBwdWideSmem : kBwdSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTileQ - 1) / kTileQ, batch,
                  wide ? ((w1 + kMaxW - 1) / kMaxW) * ((c + kMaxW - 1) / kMaxW)
                       : 1);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const int*>(idx), static_cast<const float*>(p1),
      static_cast<const float*>(w2), static_cast<const float*>(gsel),
      static_cast<const int*>(ksel), static_cast<const float*>(pk),
      static_cast<float*>(scat), static_cast<float*>(psum),
      static_cast<float*>(part), n, c, w1, k, slope);
  return static_cast<int>(cudaGetLastError());
}
