// Helpers shared by the kernels: type conversion and warp reductions. Plain C interface users only: no PyTorch headers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// Same meaning as NEG_INF in repro_torch/kernels/common.py: a masked score
// that keeps the softmax NaN-free.
constexpr float kNegInf = -1e30f;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// ------------------------------------------------------------------------
// The online-softmax step both attention kernels share. A block of
// kThreads stages one KV head's keys through shared memory kBK at a time
// (one key per lane); each warp owns R query rows and keeps their running
// max m, denominator l and fp32 output accumulator in registers, lane
// `lane` holding output columns lane, lane + 32, ... .
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 32;

template <int D>
struct KVTile {
  float k[kBK][D + 1];  // +1: lane j reads row j across d without bank conflicts
  float v[kBK][D];
};

// 16 bytes of T as fp32 (little-endian: element 0 in the low bits).
template <typename T> __device__ __forceinline__ void unpack(const uint4& u, float* f);
template <> __device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Stages ROWS rows of D elements of T from device memory into shared memory
// as fp32, in two steps so that loads overlap: fetch() issues all of this
// thread's 16-byte loads into registers with no branch around them (a row
// at or past `valid` reads row valid-1, which is in bounds), and store()
// converts and writes them, zeroing rows at or past `valid`. A load guarded
// by a branch and converted inside it waits for its data before the next
// load issues: one memory latency per element instead of one per stage.
// Row r starts at element base + r * stride; rows must be 16-byte aligned.
template <typename T, int ROWS, int D>
struct RowStager {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kVecs = ROWS * D / kVec;
  static constexpr int kPer = (kVecs + kThreads - 1) / kThreads;
  static_assert(D % kVec == 0, "rows must be whole 16-byte vectors");
  uint4 raw[kPer];

  __device__ __forceinline__ void fetch(const T* __restrict__ src, size_t base,
                                        size_t stride, int valid) {
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
      const int e = min(int(threadIdx.x) + it * kThreads, kVecs - 1) * kVec;
      const int r = min(e / D, valid - 1);
      raw[it] = __ldg(reinterpret_cast<const uint4*>(src + base + size_t(r) * stride + e % D));
    }
  }

  template <int PITCH>
  __device__ __forceinline__ void store(float* dst, int valid, float scale) const {
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
      const int vi = threadIdx.x + it * kThreads;
      if (vi >= kVecs) break;
      const int e = vi * kVec, r = e / D, d = e % D;
      float f[kVec];
      unpack<T>(raw[it], f);
#pragma unroll
      for (int x = 0; x < kVec; ++x) dst[r * PITCH + d + x] = r < valid ? f[x] * scale : 0.f;
    }
  }
};

// This warp's R rows of pre-scaled fp32 queries `q` against the staged tile:
// scores, then the online-softmax update of (m, l, acc) exactly as the TPU
// kernels do it. keep(r, j) says whether row r attends tile key j; a key
// that is not kept scores kNegInf, as in the plain version. The first
// `valid` keys of the tile exist; the others weigh exactly zero. `p` is the
// warp's R x kBK scratch in shared memory.
template <int D, int R, typename Keep>
__device__ __forceinline__ void attend_tile(const float (*q)[D], const KVTile<D>& t,
                                            float (*p)[kBK], int valid, Keep keep,
                                            float (&m)[R], float (&l)[R],
                                            float (&acc)[R][D / 32]) {
  const int lane = threadIdx.x % 32;
  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float kd = t.k[lane][d];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = fmaf(q[r][d], kd, s[r]);
  }
  const bool exists = lane < valid;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float sr = exists && keep(r, lane) ? s[r] : kNegInf;
    const float m_new = fmaxf(m[r], warp_max(sr));
    const float pr = exists ? expf(sr - m_new) : 0.f;
    const float alpha = expf(m[r] - m_new);
    l[r] = l[r] * alpha + warp_sum(pr);
    m[r] = m_new;
    p[r][lane] = pr;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc[r][c] *= alpha;
  }
  __syncwarp();
  for (int j = 0; j < valid; ++j) {
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      const float vj = t.v[j][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r][c] = fmaf(p[r][j], vj, acc[r][c]);
    }
  }
  __syncwarp();  // p is rewritten for the next tile
}

template <int R, int D>
__device__ __forceinline__ void init_state(float (&m)[R], float (&l)[R],
                                           float (&acc)[R][D / 32]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc[r][c] = 0.f;
  }
}

// Streams keys [lo, hi) of one KV head through `tile`, kBK at a time, and
// folds each tile into this warp's (m, l, acc) with attend_tile. Key i's row
// starts at element base + i * stride; keys at or past n (>= hi) do not
// exist. The next tile's loads are in flight while the current tile is
// computed. prologue() runs once, after the first tile's loads are issued
// and before the first barrier: the kernel stages its queries there, so
// their loads overlap the first tile's. keep(r, key) takes the absolute key.
template <typename T, int D, int R, typename Prologue, typename Keep>
__device__ __forceinline__ void attend_range(const float (*q)[D], KVTile<D>& tile,
                                             float (*p)[kBK], const T* __restrict__ k,
                                             const T* __restrict__ v, size_t base,
                                             size_t stride, int lo, int hi, int n,
                                             Prologue prologue, Keep keep, float (&m)[R],
                                             float (&l)[R], float (&acc)[R][D / 32]) {
  RowStager<T, kBK, D> ks, vs;
  if (lo < hi) {
    ks.fetch(k, base + size_t(lo) * stride, stride, n - lo);
    vs.fetch(v, base + size_t(lo) * stride, stride, n - lo);
  }
  prologue();
  for (int k0 = lo; k0 < hi; k0 += kBK) {
    __syncthreads();                    // previous tile consumed, queries staged
    ks.template store<D + 1>(&tile.k[0][0], n - k0, 1.f);
    vs.template store<D>(&tile.v[0][0], n - k0, 1.f);
    __syncthreads();
    const int next = k0 + kBK;
    if (next < hi) {
      ks.fetch(k, base + size_t(next) * stride, stride, n - next);
      vs.fetch(v, base + size_t(next) * stride, stride, n - next);
    }
    attend_tile<D, R>(q, tile, p, min(kBK, n - k0),
                      [&](int r, int j) { return keep(r, k0 + j); }, m, l, acc);
  }
}

}  // namespace repro
