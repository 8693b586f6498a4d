// fp32-accurate products on Hopper's tensor cores ("3xTF32"), and the
// asynchronous copies that feed them: shared by K2 (csrc/attention.cu), K5a
// and K5b (csrc/attention_train.cu), K1's edge stage, also K9
// (csrc/fused_edgeconv.cu: edge_mma_kernel), and K4a and K4b
// (csrc/fused_edgeconv_train.cu).
//
// A tensor-core TF32 product keeps 10 mantissa bits of each operand, which
// alone misses fp32 by ~1e-3. 3xTF32 splits each operand x = hi + lo, with
// hi = x rounded to TF32 (ties away from zero, as cvt.rna.tf32.f32 does) and
// lo = x - hi (exact in fp32), and sums three TF32 products in fp32:
//   a b ~= a_lo b_hi + a_hi b_lo + a_hi b_hi
// (the small terms first). lo is handed to the tensor core as it is, which
// reads its top 19 bits; the dropped terms are ~2^-21 |a b|, near fp32's own
// rounding (tests/test_torch_port_split_tf32.py emulates this on the CPU).
//
// Fragments are those of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32
// with lane = 4 g + t (g = lane / 4, t = lane % 4):
//   A (16 x 8, row major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, [k][n]):     b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)
// A C fragment becomes the A fragment of a product over its columns without
// any exchange between lanes if that product's k index is permuted within
// each block of 8: k = t stands for column 2t and k = t + 4 for column
// 2t + 1, so a = (c0, c2, c1, c3), and the B operand is read at rows 2t and
// 2t + 1 (a sum over k does not depend on its order).
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

namespace gfs {

// hi = x rounded to TF32, ties away (as cvt.rna.tf32.f32); lo = x - hi
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void set_a(FragA& f, float a0, float a1, float a2,
                                      float a3) {
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
}

__device__ __forceinline__ void set_b(FragB& f, float b0, float b1) {
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
}

// d += a b on one m16n8k8 tile, TF32 inputs, fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// four 8 x 4 tiles of fp32 from shared memory, one 16-byte row a lane:
// lane l gives the address of row l % 8 of tile l / 8 (16-byte aligned) and
// gets r[i] = word t of row g of tile i. With the tiles (rows m .. m + 7,
// k .. k + 3), (m + 8 .., k ..), (m .., k + 4 ..), (m + 8 .., k + 4 ..) of a
// [row][k] buffer, r is the A fragment of rows m .. m + 15; r[0], r[2] and
// r[1], r[3] are the B fragments of n-tiles m .. m + 7 and m + 8 .. m + 15
// of the same buffer read as [n][k].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// 16 bytes global -> shared without a register round trip; zeros when
// !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, zero when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` of this thread's groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// rows [base, base + rows) x channels [0, DP) of a (n, d) fp32 matrix into
// a [rows][stride] shared tile with cp.async, zeros past n and d (d % 4 ==
// 0, so a 16-byte chunk is all in or all out); every thread of the block
// takes a share
template <int DP>
__device__ __forceinline__ void stage_async(const float* __restrict__ src,
                                            float* dst, int rows, int stride,
                                            int base, int n, int d) {
  for (int e = threadIdx.x; e < rows * (DP / 4); e += blockDim.x) {
    const int r = e / (DP / 4), c = 4 * (e % (DP / 4));
    const bool valid = base + r < n && c < d;
    cp_async16(dst + r * stride + c,
               valid ? src + static_cast<size_t>(base + r) * d + c : src,
               valid);
  }
}

}  // namespace gfs
