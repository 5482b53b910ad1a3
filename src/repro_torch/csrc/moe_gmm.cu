// Grouped (per-expert batched) matmul for the MoE experts, for Hopper,
// sm_90a.
//
// Replaces: src/repro/kernels/moe_gmm/kernel.py, gmm_pallas (body
// _gmm_kernel). x (E,C,d) against w (E,d,f) -> (E,C,f): for each expert e,
// its C capacity rows times its own weight matrix. Both operands are
// widened to fp32, products are summed in fp32 (FMA on the CUDA cores, no
// TF32), and each output is rounded once to the dtype of x. Unlike the TPU
// kernel, whose blocks shrink to divisors of the shape (_fit_block), it
// masks ragged tails, so any C, d and f work.
//
// What bounds it on the H100: HBM. Every call reads the whole weight
// tensor, E*d*f elements, against 2*E*C*d*f operations: C operations per
// weight element, and C is small at the serving shapes (the one-hot
// dispatch gives every expert a capacity buffer of 4-16 rows). For
// granite-moe-3b-a800m (E=40, d=1536, f=512, bf16) that is 62.9 MB per
// call, about 18.8 us at 3.35 TB/s, against 0.5 GFLOP.
//
// Design: each weight element is read from HBM once per call (per chunk of
// CR rows of C; C <= 16 is one chunk). One block of 256 threads per
// (f-tile, expert). A warp row of 8 threads reads 128 contiguous bytes of a
// weight row with 16-byte loads (f is the contiguous axis), and the
// block's 32 such rows of threads split d between them, 128 rows of d per
// tile; the next tile's loads are in flight while the current tile is
// computed. The CR rows of x for the tile are staged in shared memory as
// fp32, and each thread keeps its CR x VEC accumulators in registers. At
// the end the partial sums over d are added across the lanes of a warp
// (shuffles) and then across warps (shared memory). Where f is not a whole
// number of 16-byte vectors, or w is not 16-byte aligned, a scalar variant
// (one column per thread, 32 threads across f) runs instead. Tensor cores
// (wgmma) and TMA for large C are later work.
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kGmmThreads = 256;
constexpr int kGmmWarps = kGmmThreads / 32;
constexpr int kDT = 128;  // rows of d per tile
// Threads across f: 8 x 16 bytes = 128 contiguous bytes of a weight row per
// warp row for the vector variant, 32 elements for the scalar one.
constexpr int kTxVector = 8, kTxScalar = 32;

// VEC consecutive weights of one row: one 16-byte load, or one element.
template <typename T, bool kVector> struct WVec;
template <typename T> struct WVec<T, true> {
  static constexpr int N = 16 / sizeof(T);
  uint4 raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void get(float* f) const { unpack<T>(raw, f); }
};
template <typename T> struct WVec<T, false> {
  static constexpr int N = 1;
  T raw;
  __device__ __forceinline__ void load(const T* p) { raw = *p; }
  __device__ __forceinline__ void get(float* f) const { f[0] = to_float<T>(raw); }
};

// Two blocks per SM where the CR x VEC accumulators leave room for them.
template <typename T, int CR, bool kVector>
__global__ void __launch_bounds__(kGmmThreads, (CR * (kVector ? 16 / int(sizeof(T)) : 1) <= 64 ? 2 : 1))
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ o,
           int C, int d, int f) {
  using Vec = WVec<T, kVector>;
  constexpr int VEC = Vec::N;
  constexpr int TX = kVector ? kTxVector : kTxScalar;
  constexpr int TY = kGmmThreads / TX;        // threads across d
  constexpr int FT = TX * VEC;                // columns of f per block
  constexpr int NL = kDT / TY;                // weight loads per thread per tile
  constexpr int NX = CR * kDT / kGmmThreads;  // x elements per thread per tile
  constexpr int kXs = 2 * CR * kDT, kRed = kGmmWarps * CR * FT;
  static_assert(kDT % TY == 0 && (CR * kDT) % kGmmThreads == 0, "tile shape");
  // The x tiles (double-buffered) and, after the d loop, the per-warp sums.
  __shared__ float smem[kXs > kRed ? kXs : kRed];
  auto xs = reinterpret_cast<float (*)[CR][kDT]>(smem);   // [2][CR][kDT]
  auto red = reinterpret_cast<float (*)[CR][FT]>(smem);   // [kGmmWarps][CR][FT]

  const int e = blockIdx.y, f0 = blockIdx.x * FT;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nt = (d + kDT - 1) / kDT;
  const T* xe = x + size_t(e) * C * d;
  // Columns past f read the last vector of the row (in bounds), never stored.
  const T* we = w + size_t(e) * d * f + min(f0 + tx * VEC, f - VEC);
  T* oe = o + size_t(e) * C * f;

  for (int c0 = 0; c0 < C; c0 += CR) {
    float acc[CR][VEC];
#pragma unroll
    for (int c = 0; c < CR; ++c)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[c][v] = 0.f;
    Vec cur[NL], nxt[NL];
    T xr[NX];
    // Loads take clamped, in-bounds addresses with no branch around them, so
    // that all of a tile's loads are in flight together; rows past d are
    // zeroed in the x tile, so their (finite) weights add nothing.
    auto fetch_w = [&](Vec (&buf)[NL], int t) {
#pragma unroll
      for (int i = 0; i < NL; ++i)
        buf[i].load(we + size_t(min(t * kDT + ty + i * TY, d - 1)) * f);
    };
    auto fetch_x = [&](int t) {
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        const int idx = threadIdx.x + k * kGmmThreads, c = idx / kDT, r = idx % kDT;
        xr[k] = xe[size_t(min(c0 + c, C - 1)) * d + min(t * kDT + r, d - 1)];
      }
    };
    auto store_x = [&](int buf, int t) {
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        const int idx = threadIdx.x + k * kGmmThreads, c = idx / kDT, r = idx % kDT;
        const float v = to_float<T>(xr[k]);
        xs[buf][c][r] = (c0 + c < C && t * kDT + r < d) ? v : 0.f;
      }
    };

    fetch_w(cur, 0);
    fetch_x(0);
    store_x(0, 0);
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const int tn = min(t + 1, nt - 1);  // the last tile fetches itself again
      fetch_w(nxt, tn);
      fetch_x(tn);
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        float wv[VEC];
        cur[i].get(wv);
        const int r = ty + i * TY;
#pragma unroll
        for (int c = 0; c < CR; ++c) {
          const float xv = xs[t & 1][c][r];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[c][v] = fmaf(xv, wv[v], acc[c][v]);
        }
      }
      store_x((t + 1) & 1, tn);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NL; ++i) cur[i] = nxt[i];
    }

    // Sum over d: the TY/kGmmWarps rows of threads in a warp, then the warps.
#pragma unroll
    for (int c = 0; c < CR; ++c)
#pragma unroll
      for (int v = 0; v < VEC; ++v)
#pragma unroll
        for (int off = TX; off < 32; off <<= 1)
          acc[c][v] += __shfl_xor_sync(0xffffffffu, acc[c][v], off);
    if (lane < TX) {
#pragma unroll
      for (int c = 0; c < CR; ++c)
#pragma unroll
        for (int v = 0; v < VEC; ++v) red[warp][c][tx * VEC + v] = acc[c][v];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < CR * FT; i += kGmmThreads) {
      const int c = i / FT, j = i % FT;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kGmmWarps; ++k) s += red[k][c][j];
      if (c0 + c < C && f0 + j < f) oe[size_t(c0 + c) * f + f0 + j] = from_float<T>(s);
    }
    __syncthreads();  // red shares memory with the next chunk's x tiles
  }
}

template <typename T, int CR>
cudaError_t launch(const T* x, const T* w, T* o, int E, int C, int d, int f,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (f % VEC == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0)
    gmm_kernel<T, CR, true><<<dim3(cdiv(f, kTxVector * VEC), E), kGmmThreads, 0, stream>>>(x, w, o, C, d, f);
  else
    gmm_kernel<T, CR, false><<<dim3(cdiv(f, kTxScalar), E), kGmmThreads, 0, stream>>>(x, w, o, C, d, f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, void* o, int E, int C, int d, int f,
                     cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(o);
  if (C <= 4) return launch<T, 4>(xp, wp, op, E, C, d, f, stream);
  if (C <= 8) return launch<T, 8>(xp, wp, op, E, C, d, f, stream);
  return launch<T, 16>(xp, wp, op, E, C, d, f, stream);  // C > 16: chunks of 16 rows
}

}  // namespace
}  // namespace repro

// x (E,C,d), w (E,d,f), o (E,C,f); all contiguous, of one dtype
// (repro::DType); E <= 65535. Launches on `stream` of `device` and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_grouped_matmul(const void* x, const void* w, void* o, int E, int C,
                                    int d, int f, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0 || E > 65535) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return repro::dispatch<float>(x, w, o, E, C, d, f, s);
  if (dtype == repro::kBFloat16) return repro::dispatch<__nv_bfloat16>(x, w, o, E, C, d, f, s);
  return cudaErrorInvalidValue;
}
