// K5a/K5b: single-head attention with dropout on the weights, for training,
// hand-written for Hopper (sm_90a).
//
// Replace the TPU kernels gfs3dseg_gws_tpu/ops/attention_train.py::
// attention_train (its Pallas bodies `_fwd_kernel`, K5a, and `_bwd_kernel`,
// K5b):
//
//   P   = softmax((q / t) k^T)           rows normalised BEFORE dropout
//   A   = keep * P / (1 - rate)          dropped weights are 0
//   out = A v
//
// K5a (`attn_train_fwd_kernel`) is K2 (csrc/attention.cu) plus the mask:
// one block per (batch, 64 queries), keys and values streamed through
// shared memory 64 rows at a time, an online softmax in fp32 whose running
// sum takes every weight while the P.V product takes the kept ones only, so
// out = (sum_j keep_ij e_ij v_j) / (1 - rate) / den_i. It saves the row max
// m and denominator den (B, N), as the TPU kernel does, so that the
// backward recomputes the same P.
//
// K5b (`attn_train_bwd_kernel`) is FlashAttention-2's backward with one
// block per (batch, 64 keys): K and V stay in shared memory, the block
// walks every 64-query tile and keeps dk and dv for its keys in registers;
// with Delta_i = dy_i . out_i (= rowsum(dP * P), dropout included) from the
// caller,
//   dA = dy v^T,  dP = keep * dA / (1 - rate),  dS = P * (dP - Delta),
//   dv += A^T dy,  dk += dS^T q / t,  dq += dS k / t.
// The TPU kernel carried dk and dv across a sequential grid axis; blocks on
// Hopper run in parallel, so here dq is the sum across blocks instead: each
// block adds its 64-key share with float atomics into a zeroed dq (so dq's
// last bits vary from run to run; dk and dv do not). Each block starts its
// walk at another query tile, so that the blocks of one batch element do
// not add into the same dq rows at the same time.
//
// Dropout mask: the TPU kernel's in-core random bits cannot be reproduced.
// Here keep_ij is a counter-based hash of (seed, batch, query i, key j),
// independent of any tiling: h = mix(mix(mix(seed + b G) + i G) + j G) with
// G = 0x9e3779b9 and mix = the `lowbias32` finaliser (xor-shift and 32-bit
// multiply-low only), keep iff (h >> 8) >= thr, thr = ceil(rate 2^24),
// i.e. u = (h >> 8) / 2^24 >= rate. K5a, K5b and the plain twin
// (ops/attention_train.py, in int64 arithmetic) draw bit-identical masks.
// At rate 0 (thr == 0) the hash is skipped.
//
// What bounds them: fp32 FMAs. At B=16, N=2048, D=64, K5a does 2 B N^2 D =
// 8.6 G FMAs and K5b 5 B N^2 D = 21.5 G (S, dA, dv, dk, dq) over a few MB
// of q, k, v, dy. Every product is register-tiled as in K2: a thread owns
// 4 queries x 8 keys of a score tile and 4 rows x 8 channels of an output,
// so one 16-byte shared-memory load feeds 4-8 FMAs. Ragged N is masked
// here: keys past N get weight 0, queries past N are computed on zeros and
// never stored.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;     // queries and keys per tile
constexpr int kMaxD = 64;     // widest head (zero padded up to it)
constexpr int kPad = 68;      // row stride of the [row][channel] tiles
constexpr int kPadT = 72;     // row stride of the [query][key] tiles of K5b
constexpr int kThreads = 128; // 16 row groups x 8 column groups
constexpr uint32_t kGolden = 0x9e3779b9u;
constexpr size_t kSmemFwd =
    (static_cast<size_t>(3) * kTile * kPad + kTile * kMaxD) * sizeof(float);
constexpr size_t kSmemBwd =
    (static_cast<size_t>(4) * kTile * kPad + 2 * kTile * kPadT + 3 * kTile) *
    sizeof(float);

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// the hash of (seed, batch, query row), before the key column is mixed in
__device__ __forceinline__ uint32_t row_key(uint32_t seed, int batch, int row) {
  return mix32(mix32(seed + static_cast<uint32_t>(batch) * kGolden) +
               static_cast<uint32_t>(row) * kGolden);
}

__device__ __forceinline__ bool kept(uint32_t rkey, int col, uint32_t thr) {
  return (mix32(rkey + static_cast<uint32_t>(col) * kGolden) >> 8) >= thr;
}

// rows [base, base + 64) of a (n, d) matrix into a (64, stride) tile, as
// float4s (d % 4 == 0), zeros past n and d
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           float* dst, int stride, int base,
                                           int n, int d, float scale) {
  for (int e = threadIdx.x; e < kTile * (kMaxD / 4); e += kThreads) {
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

// s[i][j] = a_s[rows ra + 16i] . b_s[rows rb + 8j] over kMaxD channels
__device__ __forceinline__ void tile_dot(const float* a_s, const float* b_s,
                                         int ra, int rb, float s[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < kMaxD; c += 4) {
    float4 af[4], bf[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) af[i] = gfs::load4(a_s + (ra + 16 * i) * kPad + c);
#pragma unroll
    for (int j = 0; j < 8; ++j) bf[j] = gfs::load4(b_s + (rb + 8 * j) * kPad + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = fmaf(af[i].x, bf[j].x, s[i][j]);
        s[i][j] = fmaf(af[i].y, bf[j].y, s[i][j]);
        s[i][j] = fmaf(af[i].z, bf[j].z, s[i][j]);
        s[i][j] = fmaf(af[i].w, bf[j].w, s[i][j]);
      }
  }
}

// three blocks per SM (68.6 KB of shared memory each): at most 170 registers
__global__ void __launch_bounds__(kThreads, 3)
attn_train_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const int* __restrict__ seed_ptr,
                      float* __restrict__ out, float* __restrict__ m_out,
                      float* __restrict__ den_out, int n, int d,
                      float inv_temp, uint32_t thr, float keep_scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // [query][kPad], scaled by 1/temp
  float* k_s = q_s + kTile * kPad;    // [key][kPad]
  float* p_s = k_s + kTile * kPad;    // [key][kPad]: slot 4qg + i holds
                                      // query qg + 16i
  float* v_s = p_s + kTile * kPad;    // [key][kMaxD]

  const int tid = threadIdx.x;
  const int batch = blockIdx.y;
  const int q_base = blockIdx.x * kTile;
  const int qg = tid / 8, cg = tid % 8;   // 8 lanes per query group
  const size_t off = static_cast<size_t>(batch) * n * d;
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);

  stage_rows(q + off, q_s, kPad, q_base, n, d, inv_temp);

  float o[4][8];
  float m[4], l[4];
  uint32_t rkey[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    rkey[i] = row_key(seed, batch, q_base + qg + 16 * i);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
  }

  for (int base = 0; base < n; base += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    stage_rows(k + off, k_s, kPad, base, n, d, 1.f);
    stage_rows(v + off, v_s, kMaxD, base, n, d, 1.f);
    __syncthreads();

    // scores of queries qg + 16i against keys base + cg + 8j
    float s[4][8];
    tile_dot(q_s, k_s, qg, cg, s);

    // online softmax over every key; key base + cg exists (base < n), so
    // m_new is finite. The P.V product below takes the kept weights only.
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
      if (thr != 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (!kept(rkey[i], base + cg + 8 * j, thr)) s[i][j] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(p_s + (cg + 8 * j) * kPad + 4 * qg) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // o[i][h*4 + t] += sum_j p[query qg + 16i][j] * v[j][4cg + 32h + t]
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
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
    const size_t row = static_cast<size_t>(batch) * n + qi;
    if (cg == 0) {
      m_out[row] = m[i];
      den_out[row] = l[i];
    }
    const float f = keep_scale / l[i];
    float* orow = out + row * d;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 4 * cg + 32 * h;
      if (c < d)
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(o[i][4 * h] * f, o[i][4 * h + 1] * f,
                        o[i][4 * h + 2] * f, o[i][4 * h + 3] * f);
    }
  }
}

// two blocks per SM (107 KB of shared memory each)
__global__ void __launch_bounds__(kThreads, 2)
attn_train_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const int* __restrict__ seed_ptr,
                      const float* __restrict__ m_in,
                      const float* __restrict__ den_in,
                      const float* __restrict__ delta_in,
                      const float* __restrict__ dy, float* __restrict__ dq,
                      float* __restrict__ dk, float* __restrict__ dv, int n,
                      int d, float inv_temp, uint32_t thr, float keep_scale) {
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                  // [key][kPad], this block's keys
  float* v_s = k_s + kTile * kPad;    // [key][kPad]
  float* q_s = v_s + kTile * kPad;    // [query][kPad], scaled by 1/temp
  float* dy_s = q_s + kTile * kPad;   // [query][kPad]
  float* a_t = dy_s + kTile * kPad;   // [query][kPadT]: A of key column j
  float* ds_t = a_t + kTile * kPadT;  // [query][kPadT]: dS of key column j
  float* m_s = ds_t + kTile * kPadT;  // per query of the tile: row max,
  float* id_s = m_s + kTile;          // 1 / den (0 past n),
  float* dl_s = id_s + kTile;         // Delta

  const int tid = threadIdx.x;
  const int batch = blockIdx.y;
  const int k_base = blockIdx.x * kTile;
  // score tiles: queries rg + 16i x keys cg + 8j; dk/dv: keys 4rg + u x
  // channels 4cg + 32h + t; dq: queries rg + 16i x the same channels
  const int rg = tid / 8, cg = tid % 8;
  const size_t off = static_cast<size_t>(batch) * n * d;
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);

  stage_rows(k + off, k_s, kPad, k_base, n, d, 1.f);
  stage_rows(v + off, v_s, kPad, k_base, n, d, 1.f);

  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int t = 0; t < 8; ++t) dk_acc[u][t] = dv_acc[u][t] = 0.f;

  const int n_tiles = (n + kTile - 1) / kTile;
  for (int step = 0; step < n_tiles; ++step) {
    const int q_base = ((blockIdx.x + step) % n_tiles) * kTile;
    __syncthreads();  // every thread is done with the previous query tile
    stage_rows(q + off, q_s, kPad, q_base, n, d, inv_temp);
    stage_rows(dy + off, dy_s, kPad, q_base, n, d, 1.f);
    if (tid < kTile) {
      const int qi = q_base + tid;
      const size_t row = static_cast<size_t>(batch) * n + qi;
      m_s[tid] = qi < n ? m_in[row] : 0.f;
      id_s[tid] = qi < n ? 1.f / den_in[row] : 0.f;
      dl_s[tid] = qi < n ? delta_in[row] : 0.f;
    }
    __syncthreads();

    float s[4][8], da[4][8];
    tile_dot(q_s, k_s, rg, cg, s);     // S  = (q / t) k^T
    tile_dot(dy_s, v_s, rg, cg, da);   // dA = dy v^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
      const float mi = m_s[r], idn = id_s[r], dli = dl_s[r];
      const uint32_t rkey = row_key(seed, batch, q_base + r);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k_base + cg + 8 * j;
        const float p = key < n ? expf(s[i][j] - mi) * idn : 0.f;
        const bool keep = thr == 0 || kept(rkey, key, thr);
        const float dp = keep ? da[i][j] * keep_scale : 0.f;
        a_t[r * kPadT + cg + 8 * j] = keep ? p * keep_scale : 0.f;
        ds_t[r * kPadT + cg + 8 * j] = p * (dp - dli);
      }
    }
    __syncthreads();

    // dv[4rg + u] += sum_r A[r][4rg + u] dy[r];  dk likewise with dS, q/t
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      const float4 af = gfs::load4(a_t + r * kPadT + 4 * rg);
      const float4 sf = gfs::load4(ds_t + r * kPadT + 4 * rg);
      const float4 y0 = gfs::load4(dy_s + r * kPad + 4 * cg);
      const float4 y1 = gfs::load4(dy_s + r * kPad + 32 + 4 * cg);
      const float4 q0 = gfs::load4(q_s + r * kPad + 4 * cg);
      const float4 q1 = gfs::load4(q_s + r * kPad + 32 + 4 * cg);
      const float av[4] = {af.x, af.y, af.z, af.w};
      const float sv[4] = {sf.x, sf.y, sf.z, sf.w};
      const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
      const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          dv_acc[u][t] = fmaf(av[u], yv[t], dv_acc[u][t]);
          dk_acc[u][t] = fmaf(sv[u], qv[t], dk_acc[u][t]);
        }
    }

    // this block's share of dq[rg + 16i] = sum_j dS[rg + 16i][j] k[j] / t
    float g[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 8; ++t) g[i][t] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float4 k0 = gfs::load4(k_s + j * kPad + 4 * cg);
      const float4 k1 = gfs::load4(k_s + j * kPad + 32 + 4 * cg);
      const float kv[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dsv = ds_t[(rg + 16 * i) * kPadT + j];
#pragma unroll
        for (int t = 0; t < 8; ++t) g[i][t] = fmaf(dsv, kv[t], g[i][t]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q_base + rg + 16 * i;
      if (qi >= n) continue;
      float* row = dq + off + static_cast<size_t>(qi) * d;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 4 * cg + 32 * h;
        if (c < d)
#pragma unroll
          for (int t = 0; t < 4; ++t)
            atomicAdd(row + c + t, g[i][4 * h + t] * inv_temp);
      }
    }
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int key = k_base + 4 * rg + u;
    if (key >= n) continue;
    const size_t row = off + static_cast<size_t>(key) * d;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 4 * cg + 32 * h;
      if (c >= d) continue;
      *reinterpret_cast<float4*>(dk + row + c) =
          make_float4(dk_acc[u][4 * h], dk_acc[u][4 * h + 1],
                      dk_acc[u][4 * h + 2], dk_acc[u][4 * h + 3]);
      *reinterpret_cast<float4*>(dv + row + c) =
          make_float4(dv_acc[u][4 * h], dv_acc[u][4 * h + 1],
                      dv_acc[u][4 * h + 2], dv_acc[u][4 * h + 3]);
    }
  }
}

bool bad_shape(int batch, int n, int d, int thr) {
  return batch < 1 || batch > 65535 || n < 1 || d < 4 || d > kMaxD ||
         d % 4 || thr < 0 || thr > (1 << 24);
}

}  // namespace

// q, k, v, out: (B, N, D) contiguous fp32 on one device, 16-byte aligned,
// D <= 64 and a multiple of 4; seed: one int32 on the device; m, den:
// (B, N). thr = ceil(rate 2^24), keep_scale = 1 / (1 - rate). Returns a
// cudaError_t.
GFS_EXPORT int gfs_attention_train_fwd(const void* q, const void* k,
                                       const void* v, const void* seed,
                                       void* out, void* m, void* den,
                                       int batch, int n, int d, float inv_temp,
                                       int thr, float keep_scale,
                                       void* stream) {
  if (bad_shape(batch, n, d, thr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      attn_train_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemFwd));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTile - 1) / kTile, batch);
  attn_train_fwd_kernel<<<grid, kThreads, kSmemFwd,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(seed),
      static_cast<float*>(out), static_cast<float*>(m),
      static_cast<float*>(den), n, d, inv_temp, static_cast<uint32_t>(thr),
      keep_scale);
  return static_cast<int>(cudaGetLastError());
}

// As the forward, plus delta, dy (B, N[, D]) in and dq, dk, dv (B, N, D)
// out; dq must be zeroed by the caller (the blocks add into it).
GFS_EXPORT int gfs_attention_train_bwd(const void* q, const void* k,
                                       const void* v, const void* seed,
                                       const void* m, const void* den,
                                       const void* delta, const void* dy,
                                       void* dq, void* dk, void* dv, int batch,
                                       int n, int d, float inv_temp, int thr,
                                       float keep_scale, void* stream) {
  if (bad_shape(batch, n, d, thr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      attn_train_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBwd));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTile - 1) / kTile, batch);
  attn_train_bwd_kernel<<<grid, kThreads, kSmemBwd,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(seed),
      static_cast<const float*>(m), static_cast<const float*>(den),
      static_cast<const float*>(delta), static_cast<const float*>(dy),
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), n, d, inv_temp, static_cast<uint32_t>(thr),
      keep_scale);
  return static_cast<int>(cudaGetLastError());
}
