// Tensor-core and asynchronous-copy helpers for the bf16 kernels
// (lm_head_mma.cuh, flash_attention.cu) and the SSD kernel
// (ssd_chunk.cu): 16-byte cp.async copies into shared memory, ldmatrix
// fragment loads, the warp-level mma.sync.m16n8k16 bf16 product with fp32
// sums, and the m16n8k8 tf32 product with its 3xTF32 split.
//
// Fragment layout of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4): A (16 x 16, row-major) a[0] = (g, 2t..2t+1), a[1] = (g + 8,
// 2t..), a[2] = (g, 2t + 8..), a[3] = (g + 8, 2t + 8..); B (16 x 8) b[0] =
// (k = 2t..2t+1, n = g), b[1] = (k = 2t + 8.., n = g); C/D (16 x 8, fp32)
// c[0..1] = (g, 2t..2t+1), c[2..3] = (g + 8, 2t..2t+1). The lower-indexed
// element of a pair sits in the low half of its 32-bit register.
#pragma once

#include "common.cuh"

namespace rt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !full (src is
// then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared through L1 (cp.async.cg takes only 16), for rows
// that are 4-byte but not 16-byte aligned; zero-filled when !full.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, whose fragment lands in r[i].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The same, transposed: lane 4g + t gets rows 2t, 2t + 1 of column g.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16 bf16) . b (16 x 8 bf16), fp32 accumulators in place.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 codes (bytes b0..b3 of r) as two bf16 pairs, exactly: even =
// (b0, b2), odd = (b1, b3), the first in the low half. Each byte, biased
// to c + 128, is placed in the mantissa of 2^23 (fp32), 2^23 + 128 is
// subtracted, and the top half of the fp32 result is its bf16 (a code
// has at most 8 significant bits).
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t r, uint32_t& even,
                                               uint32_t& odd) {
  const uint32_t u = r ^ 0x80808080u;
  const uint32_t base = 0x4B000000u;
  const float f0 = __uint_as_float(__byte_perm(u, base, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, base, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, base, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, base, 0x7653)) - 8388736.f;
  even = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  odd = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

// Four plane-packed int4 bytes of r (low nibble plane 0, high nibble plane
// 1, two's complement) as two bf16 pairs of plane p, exactly: even = (b0,
// b2), odd = (b1, b3). Each nibble, biased to c + 8, goes into the
// mantissa of bf16 128 (0x4300 | n = 128 + n), and 136 is subtracted.
__device__ __forceinline__ uint32_t bf16x2_minus136(uint32_t x) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(x), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}
__device__ __forceinline__ void i4x8_to_bf16x2(uint32_t r, int p,
                                               uint32_t& even,
                                               uint32_t& odd) {
  const uint32_t u = r ^ 0x88888888u;
  even = bf16x2_minus136(((u >> (4 * p)) & 0x000F000Fu) | 0x43004300u);
  odd = bf16x2_minus136(((u >> (8 + 4 * p)) & 0x000F000Fu) | 0x43004300u);
}

// Two floats rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = hi + lo, both bf16 pairs: hi = bf16(x), lo = bf16(x - hi), so hi + lo
// keeps ~16 significant bits of x (x - hi is exact in fp32).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// fp32 rounded to tf32 (10 stored mantissa bits, nearest, ties away from
// zero; the low 13 bits of the result are 0), as cvt.rna.tf32.f32 rounds
// a finite x, in two integer operations (the conversion instruction issues
// at a fraction of their rate: PERF.md, scripts/probe_ssd_chunk.py).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both tf32: hi = tf32(x), lo = tf32(x - hi), so hi + lo keeps
// ~22 significant bits of x (x - hi is exact in fp32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a (16 x 8 tf32) . b (8 x 8 tf32), fp32 accumulators in place.
// Fragments (lane = 4 * g + t): a[0] = (g, t), a[1] = (g + 8, t), a[2] =
// (g, t + 4), a[3] = (g + 8, t + 4); b0 = (k = t, n = g), b1 = (k = t + 4,
// n = g); d as m16n8k16's.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in ~fp32 precision from split operands (3xTF32): the small
// products a_hi . b_lo and a_lo . b_hi first, then a_hi . b_hi; a_lo . b_lo
// (~2^-22 of a . b) is dropped.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bh0, bh1);
}

}  // namespace rt
