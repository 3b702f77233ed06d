// Warp-level building blocks shared by the attention kernels of this
// directory: cp.async staging, ldmatrix fragment loads and the bf16
// tensor-core product mma.sync.m16n8k16 with f32 accumulators.
//
// Fragment layouts of m16n8k16 (lane = 4 * gid + tig):
//   A (16 x 16, row major), 4 regs of 2 bf16: a0 (row gid, cols 2tig..+1),
//     a1 (row gid+8, same cols), a2 (row gid, cols 8+2tig..+1), a3 (row gid+8, cols 8+..)
//   B (16 x 8, k x n), 2 regs: b0 (k 2tig..+1, n gid), b1 (k 8+2tig..+1, n gid)
//   C (16 x 8 f32), 4 floats: c0, c1 (row gid, cols 2tig, 2tig+1), c2, c3 (row gid+8)
// The lower-indexed element of a pair sits in the low 16 bits.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (the
// source address is not read then, but must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// the same, each matrix transposed on the way (B operands stored k-major)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a * b, bf16 inputs, f32 accumulators (registers only: not
// volatile, so the compiler may interleave it with other work; the
// shared-memory loads above stay volatile and in order with the barriers)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ex2.approx: relative error ~2^-22;
// a very negative x gives +0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one bf16 pair (round to nearest), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// two floats as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi): hi + lo
// keeps ~16 bits of x, so a product over it matches f32 x to ~2^-16
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// two int8 values -> one bf16 pair, exactly (|x| <= 128 needs 8 bits).
// (Building the f32 from its bits, 0x4B000000 | (x + 128) less 2^23 + 128,
// avoids the int-to-float converter but measured ~10% slower on the
// int8 decode kernel.)
__device__ __forceinline__ uint32_t pack_i8(int8_t lo, int8_t hi) {
  return pack_bf16(static_cast<float>(lo), static_cast<float>(hi));
}

}  // namespace sm90
