// K2: fused single-head attention for inference, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel gfs3dseg_gws_tpu/ops/attention_kernel.py::
// fused_attention (its Pallas body `_attn_kernel`):
//
//   out[b] = softmax((q[b] / temperature) k[b]^T) v[b]
//
// The (N, N) score matrix never reaches device memory. One block per
// (batch, tile of kTileQ queries); key and value rows stream through shared
// memory kTileK rows at a time, and each query keeps an online softmax in
// fp32: a running max m and denominator l, with its output accumulator
// rescaled by exp(m_old - m_new) once per key tile and normalised at the
// end. q is scaled by 1/temperature first, as the TPU kernel does.
//
// What bounds it: fp32 FMAs. At B=16, N=2048, D=64 the two products are
// 8.6 G FMAs over 1.5 MB of q, k and v per batch element, far from the
// memory bound, so both products are register-tiled: each of the 128
// threads owns 4 queries x 8 keys of a tile's scores and 4 queries x 8
// channels of the output, so that per step three or twelve 16-byte
// shared-memory loads feed 32 or 128 FMAs. The 8 threads that share a
// query row sit in adjacent lanes and reduce its max and sum with warp
// shuffles. A thread's queries, keys and channels are interleaved
// (qg + 16i, cg + 8j, 4cg + 32h) and the Q, K and P rows padded to 68
// floats, so that the lanes of a warp read distinct banks. Ragged N is
// masked here: keys past N score -inf (weight 0), queries past N are
// computed on zeros and never stored.
//
// Past D = 64 (attention_kernel<true>): blockIdx.z takes the output
// channels c_out .. c_out + 63 (c_out = 64 z). The scores need all of D, so
// each key tile streams q and k through q_s and k_s 64 channels at a time,
// the score accumulators carried across the chunks; every z block computes
// the same scores in the same order, so the online softmax's weights are
// identical across them, and each block multiplies them by its own 64
// columns of v. A D that is not a multiple of 4 is zero-padded by the
// caller (ops/attention_kernel.py).
#include "common.cuh"

namespace {

constexpr int kTileQ = 64;    // queries per block
constexpr int kTileK = 64;    // key/value rows per shared-memory tile
constexpr int kMaxD = 64;     // head channels per tile (zero padded up to it)
constexpr int kPad = 68;      // row stride of the padded Q, K and P tiles
constexpr int kThreads = 128; // 16 query groups x 8 key/channel groups
constexpr size_t kSmem =
    (static_cast<size_t>(3) * 64 * kPad + kTileK * kMaxD) * sizeof(float);

// rows [base, base + 64) of a (n, d) matrix into a (64, stride) tile, as
// float4s (d % 4 == 0), zeros past n and d
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           float* dst, int stride, int base,
                                           int n, int d, float scale) {
  for (int e = threadIdx.x; e < 64 * (kMaxD / 4); e += kThreads) {
    const int r = e / (kMaxD / 4), c = 4 * (e % (kMaxD / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (base + r < n && c < d) {
      v = gfs::load4(src + static_cast<size_t>(base + r) * d + c);
      v.x *= scale;
      v.y *= scale;
      v.z *= scale;
      v.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * stride + c) = v;
  }
}

// stage_rows for columns [c0, c0 + 64) (the tiled kernel past kMaxD)
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

// s[i][j] += q_s rows qg + 16i . k_s rows cg + 8j over kMaxD channels (the
// tiled kernel's chunk; the fast path keeps its own copy of this loop)
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

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int n,
                 int d, float inv_temp) {
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
  const int c_out = kWide ? blockIdx.z * kMaxD : 0;

  if constexpr (!kWide) stage_rows(q + off, q_s, kPad, q_base, n, d, inv_temp);

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
    if constexpr (!kWide) {
      __syncthreads();  // every thread is done with the previous tile
      stage_rows(k + off, k_s, kPad, base, n, d, 1.f);
      stage_rows(v + off, v_s, kMaxD, base, n, d, 1.f);
      __syncthreads();

#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
      for (int c = 0; c < kMaxD; c += 4) {
        float4 qf[4], kf[8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qf[i] = gfs::load4(q_s + (qg + 16 * i) * kPad + c);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          kf[j] = gfs::load4(k_s + (cg + 8 * j) * kPad + c);
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
    } else {
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
    }

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

}  // namespace

// q, k, v, out: (B, N, D) contiguous fp32 on one device, 16-byte aligned,
// D a multiple of 4. Returns a cudaError_t.
GFS_EXPORT int gfs_fused_attention(const void* q, const void* k,
                                   const void* v, void* out, int batch, int n,
                                   int d, float inv_temp, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || d < 4 || d % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = d > kMaxD;
  const auto kern = wide ? attention_kernel<true> : attention_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTileQ - 1) / kTileQ, batch,
                  wide ? (d + kMaxD - 1) / kMaxD : 1);
  kern<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, d, inv_temp);
  return static_cast<int>(cudaGetLastError());
}
