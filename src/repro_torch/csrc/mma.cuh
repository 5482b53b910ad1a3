// Tensor-core and asynchronous-copy building blocks for the bf16 kernels,
// sm_90a: cp.async with zero fill, ldmatrix and mma.sync m16n8k16 (bf16
// inputs, fp32 accumulation), m16n8k8 in TF32, and the shared-memory
// swizzle their tiles use.
// Plain C interface users only: no PyTorch headers.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace repro {

// 16 bytes from global to shared memory, asynchronously (LDGSTS). When
// `valid` is false nothing is read and the 16 bytes are zeroed; `src` must
// still be a mapped address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 matrices of 16-bit elements; lane l gives the address of one
// 16-byte row of matrix l / 8. Without .trans thread t receives row t / 4,
// elements 2 (t % 4) and 2 (t % 4) + 1 of each matrix; with .trans the same
// of the transposed matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a (16x16, row-major fragment) * b (16x8, column fragment); bf16
// products are exact in fp32, so only the order of the fp32 sums differs
// from the CUDA-core kernels. Fragments (g = lane / 4, q = lane % 4):
// a[0] = A[g][2q..], a[1] = A[g+8][2q..], a[2] = A[g][2q+8..],
// a[3] = A[g+8][2q+8..]; b0 = B[2q..][g], b1 = B[2q+8..][g];
// c[0..1] = C[g][2q..], c[2..3] = C[g+8][2q..].
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x (MUFU.EX2; flushes subnormal results to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values as one bf16x2 register (x in the low half), each rounded
// to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Element offset of 16-byte chunk `c` of row `r` in a tile of rows of CH
// such chunks. The chunk index is XORed with bits of the row so that the 8
// rows one ldmatrix reads at one logical chunk land in 8 different bank
// groups, conflict-free: rows of >= 128 bytes (CH >= 8) take r % 8, rows of
// 64 bytes (CH == 4, two rows per 128-byte line) take (r / 2) % 4, rows of
// 32 bytes (CH == 2, four rows per line) take (r / 4) % 2.
template <int CH>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(CH == 2 || CH == 4 || CH % 8 == 0, "rows of 32 or 64 bytes or a multiple of 128");
  const int x = CH >= 8 ? (r & 7) : CH == 4 ? ((r >> 1) & 3) : ((r >> 2) & 1);
  return r * CH * 8 + (c ^ x) * 8;
}

// 4 bytes from global to shared memory, asynchronously; zero-filled when
// `valid` is false (`src` must still be a mapped address).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// c += a (16x8) * b (8x8) in TF32 (m16n8k8), fp32 accumulation. Fragments
// (g = lane / 4, q = lane % 4): a[0] = A[g][q], a[1] = A[g+8][q],
// a[2] = A[g][q+4], a[3] = A[g+8][q+4]; b0 = B[q][g], b1 = B[q+4][g]; c as
// for mma_bf16. Each operand is an fp32 bit pattern rounded by to_tf32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// fp32 rounded to TF32 (nearest, ties away from zero), as mma_tf32 takes it.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

}  // namespace repro
