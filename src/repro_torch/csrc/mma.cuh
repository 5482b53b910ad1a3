// Tensor-core and asynchronous-copy building blocks for the bf16 kernels,
// sm_90a: cp.async with zero fill, ldmatrix and mma.sync m16n8k16 (bf16
// inputs, fp32 accumulation), and the shared-memory swizzle their tiles use.
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
// 64 bytes (CH == 4, two rows per 128-byte line) take (r / 2) % 4.
template <int CH>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(CH == 4 || CH % 8 == 0, "rows of 64 bytes or a multiple of 128");
  return r * CH * 8 + ((CH >= 8 ? (c ^ (r & 7)) : (c ^ ((r >> 1) & 3))) * 8);
}

}  // namespace repro
