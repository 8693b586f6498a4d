// K2: fused single-head attention for inference, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel gfs3dseg_gws_tpu/ops/attention_kernel.py::
// fused_attention (its Pallas body `_attn_kernel`):
//
//   out[b] = softmax((q[b] / temperature) k[b]^T) v[b]
//
// The (N, N) score matrix never reaches device memory: FlashAttention-2's
// forward, an online softmax in fp32 (a running max m and denominator l per
// query, the output accumulator rescaled by exp(m_old - m_new) once per key
// tile and normalised at the end).
//
// What bounds it: the two products, 2 B N^2 D FMAs (8.6 G at B=16, N=2048,
// D=64) over 1.5 MB of q, k and v per batch element: operations, far from
// the memory bound. Both run on the tensor cores in 3xTF32 (csrc/
// mma_tf32.cuh), which keeps fp32's accuracy at three TF32 products each:
// the bound is 3 x 2 x FMAs / 495 TFLOP/s, against 2 x FMAs / 67 TFLOP/s
// on the fp32 pipe.
//
// attention_mma_kernel<DP, KT>, for D <= 128 (DP = 32, 64 or 128, the head
// zero-padded up to it): one block of 8 warps per (batch, 128 queries), all
// of D at once, so every score is computed once. Each warp owns 16 queries.
// q is copied to shared memory once; key and value tiles of KT rows stream
// through two shared buffers with cp.async, the next tile in flight while
// the current one is multiplied. S = q k^T (M = 16 queries, N = KT keys,
// K = D) is multiplied by 1 / temperature on its accumulators, the softmax
// works on them in fp32 (a query's row lives in the 4 lanes of a quad), and
// they serve as the A operand of P V directly (the k permutation of
// mma_tf32.cuh; V is read at rows 2t and 2t + 1). Operands are split into
// hi and lo as their fragments are loaded. Shared rows are DP + 4 floats
// (4 mod 32 banks), so every fragment load is free of bank conflicts. KT =
// 64 up to D = 64 and 16 at D = 128, so that two blocks (16 warps) fit on
// a SM (104 and 101 KB of shared memory, at most 128 registers): the
// products wait on their operands' latency, and at 4 warps a block, 8 a
// SM, K2 took 1.5x as long at D = 64 (PERF.md). Ragged N: keys past
// N score -inf (weight 0), queries past N run on zeros and are never
// stored.
//
// Past D = 128 (attention_wide_kernel, the fp32 pipe): blockIdx.z takes the
// output channels c_out .. c_out + 63 (c_out = 64 z). The scores need all of
// D, so each key tile streams q and k through q_s and k_s 64 channels at a
// time, the score accumulators carried across the chunks; every z block
// computes the same scores in the same order, so the online softmax's
// weights are identical across them, and each block multiplies them by its
// own 64 columns of v. A D that is not a multiple of 4 is zero-padded by the
// caller (ops/attention_kernel.py).
#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kTileQ = 64;    // queries per block
constexpr int kTileK = 64;    // key/value rows per shared-memory tile
constexpr int kMaxD = 64;     // head channels per tile (zero padded up to it)
constexpr int kPad = 68;      // row stride of the padded Q, K and P tiles
constexpr int kThreads = 128; // 16 query groups x 8 key/channel groups
constexpr size_t kSmem =
    (static_cast<size_t>(3) * 64 * kPad + kTileK * kMaxD) * sizeof(float);

// rows [base, base + 64) x columns [c0, c0 + 64) of a (n, d) matrix into
// a (64, stride) tile, as float4s (d % 4 == 0), zeros past n and d
__device__ __forceinline__ void stage_cols(const float* __restrict__ src,
                                           float* dst, int stride, int base,
                                           int n, int d, float scale,
                                           int c0) {
  for (int e = threadIdx.x; e < 64 * (kMaxD / 4); e += kThreads) {
    const int r = e / (kMaxD / 4), c = 4 * (e % (kMaxD / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (base + r < n && c0 + c < d) {
      v = gfs::load4(src + static_cast<size_t>(base + r) * d + c0 + c);
      v.x *= scale;
      v.y *= scale;
      v.z *= scale;
      v.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * stride + c) = v;
  }
}

// s[i][j] += q_s rows qg + 16i . k_s rows cg + 8j over kMaxD channels
__device__ __forceinline__ void score_tile(const float* q_s, const float* k_s,
                                           int qg, int cg, float (&s)[4][8]) {
#pragma unroll 2
  for (int c = 0; c < kMaxD; c += 4) {
    float4 qf[4], kf[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) qf[i] = gfs::load4(q_s + (qg + 16 * i) * kPad + c);
#pragma unroll
    for (int j = 0; j < 8; ++j) kf[j] = gfs::load4(k_s + (cg + 8 * j) * kPad + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = fmaf(qf[i].x, kf[j].x, s[i][j]);
        s[i][j] = fmaf(qf[i].y, kf[j].y, s[i][j]);
        s[i][j] = fmaf(qf[i].z, kf[j].z, s[i][j]);
        s[i][j] = fmaf(qf[i].w, kf[j].w, s[i][j]);
      }
  }
}

__global__ void __launch_bounds__(kThreads)
attention_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int n, int d, float inv_temp) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // [query][kPad], scaled by 1/temp
  float* k_s = q_s + 64 * kPad;       // [key][kPad]
  float* p_s = k_s + 64 * kPad;       // [key][kPad]: slot 4qg + i holds
                                      // query qg + 16i
  float* v_s = p_s + 64 * kPad;       // [key][kMaxD]

  const int tid = threadIdx.x;
  const int batch = blockIdx.y;
  const int q_base = blockIdx.x * kTileQ;
  const int qg = tid / 8, cg = tid % 8;   // 8 lanes per query group
  const size_t off = static_cast<size_t>(batch) * n * d;
  const int c_out = blockIdx.z * kMaxD;

  float o[4][8];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
  }

  for (int base = 0; base < n; base += kTileK) {
    // scores of queries qg + 16i against keys base + cg + 8j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < d; c0 += kMaxD) {
      __syncthreads();  // every thread is done with q_s, k_s (and v_s)
      stage_cols(q + off, q_s, kPad, q_base, n, d, inv_temp, c0);
      stage_cols(k + off, k_s, kPad, base, n, d, 1.f, c0);
      __syncthreads();
      score_tile(q_s, k_s, qg, cg, s);
    }
    // read after the barrier that publishes p_s below
    stage_cols(v + off, v_s, kMaxD, base, n, d, 1.f, c_out);
    // online softmax; key base + cg exists (base < n), so m_new is finite
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (base + cg + 8 * j >= n) s[i][j] = -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, w));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        psum += s[i][j];
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, w);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(p_s + (cg + 8 * j) * kPad + 4 * qg) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // o[i][h*4 + t] += sum_j p[query qg + 16i][j] * v[j][4cg + 32h + t]
#pragma unroll 4
    for (int j = 0; j < kTileK; ++j) {
      const float4 pf = gfs::load4(p_s + j * kPad + 4 * qg);
      const float4 v0 = gfs::load4(v_s + j * kMaxD + 4 * cg);
      const float4 v1 = gfs::load4(v_s + j * kMaxD + 32 + 4 * cg);
      const float pv[4] = {pf.x, pf.y, pf.z, pf.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < 8; ++t) o[i][t] = fmaf(pv[i], vv[t], o[i][t]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q_base + qg + 16 * i;
    if (qi >= n) continue;
    float* orow = out + off + static_cast<size_t>(qi) * d + c_out;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 4 * cg + 32 * h;
      if (c_out + c < d)
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(o[i][4 * h] / l[i], o[i][4 * h + 1] / l[i],
                        o[i][4 * h + 2] / l[i], o[i][4 * h + 3] / l[i]);
    }
  }
}


// ---------------------------------------------------------------------------
// D <= 128: one block per (batch, 128 queries), 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;          // 16 queries each
constexpr int kMmaQ = 16 * kMmaWarps;  // queries per block

template <int DP, int KT>
constexpr size_t mma_smem() {
  return static_cast<size_t>(kMmaQ + 4 * KT) * (DP + 4) * sizeof(float);
}

template <int DP, int KT>
// two blocks per SM: at most 128 registers
__global__ void __launch_bounds__(32 * kMmaWarps, 2)
attention_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int n, int d, float inv_temp) {
  constexpr int kS = DP + 4;          // row stride: 4 mod 32 banks
  constexpr int kNt = KT / 8;         // key n-tiles of S
  constexpr int kDt = DP / 8;         // channel tiles
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                      // [kMmaQ queries][kS]
  float* kv_s = q_s + kMmaQ * kS;         // 2 x ([KT keys][kS] k, then v)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int batch = blockIdx.y;
  const int q_base = blockIdx.x * kMmaQ;
  const size_t off = static_cast<size_t>(batch) * n * d;
  const int tiles = (n + KT - 1) / KT;

  gfs::stage_async<DP>(q + off, q_s, kMmaQ, kS, q_base, n, d);
  gfs::stage_async<DP>(k + off, kv_s, KT, kS, 0, n, d);
  gfs::stage_async<DP>(v + off, kv_s + KT * kS, KT, kS, 0, n, d);
  gfs::cp_async_commit();

  // rows g and g + 8 of this warp's 16 queries
  const float* qa = q_s + (16 * warp + g) * kS;
  float o[kDt][4];
#pragma unroll
  for (int j = 0; j < kDt; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int tile = 0; tile < tiles; ++tile) {
    const float* k_s = kv_s + (tile & 1) * 2 * KT * kS;
    const float* v_s = k_s + KT * kS;
    if (tile + 1 < tiles) {
      float* nk = kv_s + ((tile + 1) & 1) * 2 * KT * kS;
      gfs::stage_async<DP>(k + off, nk, KT, kS, (tile + 1) * KT, n, d);
      gfs::stage_async<DP>(v + off, nk + KT * kS, KT, kS, (tile + 1) * KT, n,
                           d);
      gfs::cp_async_commit();
      gfs::cp_async_wait<1>();
    } else {
      gfs::cp_async_wait<0>();
    }
    __syncthreads();

    // S = q k^T over all of D: 16 queries x KT keys
    float s[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
    for (int c = 0; c < DP; c += 8) {
      gfs::FragA a;
      gfs::set_a(a, qa[c + t], qa[8 * kS + c + t], qa[c + t + 4],
                 qa[8 * kS + c + t + 4]);
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        const float* kr = k_s + (8 * j + g) * kS + c;
        gfs::FragB b;
        gfs::set_b(b, kr[t], kr[t + 4]);
        gfs::mma_3xtf32(s[j], a, b);
      }
    }

    // online softmax on the accumulators: s[j][0..1] is row g, s[j][2..3]
    // row g + 8, at keys 8j + 2t and 8j + 2t + 1; key tile * KT exists, so
    // the first tile's max is finite
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = tile * KT + 8 * j + 2 * t + e;
          float& x = s[j][2 * h + e];
          x = key < n ? x * inv_temp : -INFINITY;
          rmax = fmaxf(rmax, x);
        }
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      const float m_new = fmaxf(m[h], rmax);
      const float corr = expf(m[h] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * h + e];
          x = expf(x - m_new);
          psum += x;
        }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l[h] = l[h] * corr + psum;
      m[h] = m_new;
#pragma unroll
      for (int j = 0; j < kDt; ++j) {
        o[j][2 * h] *= corr;
        o[j][2 * h + 1] *= corr;
      }
    }

    // O += P V: P's accumulators are the A fragments (k permuted), V read
    // at key rows 2t and 2t + 1 of each block of 8
#pragma unroll
    for (int kk = 0; kk < kNt; ++kk) {
      gfs::FragA a;
      gfs::set_a(a, s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      const float* vr = v_s + (8 * kk + 2 * t) * kS + g;
#pragma unroll
      for (int j = 0; j < kDt; ++j) {
        gfs::FragB b;
        gfs::set_b(b, vr[8 * j], vr[kS + 8 * j]);
        gfs::mma_3xtf32(o[j], a, b);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q_base + 16 * warp + g + 8 * h;
    if (qi >= n) continue;
    const float inv_l = 1.f / l[h];
    float* orow = out + off + static_cast<size_t>(qi) * d;
#pragma unroll
    for (int j = 0; j < kDt; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < d)
        *reinterpret_cast<float2*>(orow + c) =
            make_float2(o[j][2 * h] * inv_l, o[j][2 * h + 1] * inv_l);
    }
  }
}

template <int DP, int KT>
cudaError_t launch_mma(const float* q, const float* k, const float* v,
                       float* out, int batch, int n, int d, float inv_temp,
                       cudaStream_t stream) {
  constexpr size_t smem = mma_smem<DP, KT>();
  const cudaError_t err = cudaFuncSetAttribute(
      attention_mma_kernel<DP, KT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kMmaQ - 1) / kMmaQ, batch);
  attention_mma_kernel<DP, KT><<<grid, 32 * kMmaWarps, smem, stream>>>(
      q, k, v, out, n, d, inv_temp);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: (B, N, D) contiguous fp32 on one device, 16-byte aligned,
// D a multiple of 4. Returns a cudaError_t.
GFS_EXPORT int gfs_fused_attention(const void* q, const void* k,
                                   const void* v, void* out, int batch, int n,
                                   int d, float inv_temp, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || d < 4 || d % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    return launch_mma<32, 64>(qf, kf, vf, of, batch, n, d, inv_temp, s);
  if (d <= 64)
    return launch_mma<64, 64>(qf, kf, vf, of, batch, n, d, inv_temp, s);
  if (d <= 128)
    return launch_mma<128, 16>(qf, kf, vf, of, batch, n, d, inv_temp, s);
  const cudaError_t err = cudaFuncSetAttribute(
      attention_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTileQ - 1) / kTileQ, batch, (d + kMaxD - 1) / kMaxD);
  attention_wide_kernel<<<grid, kThreads, kSmem, s>>>(qf, kf, vf, of, n, d,
                                                      inv_temp);
  return static_cast<int>(cudaGetLastError());
}
