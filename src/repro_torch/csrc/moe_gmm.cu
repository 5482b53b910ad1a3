// Grouped (per-expert batched) matmul for the MoE experts, for Hopper,
// sm_90a.
//
// Replaces: src/repro/kernels/moe_gmm/kernel.py, gmm_pallas (body
// _gmm_kernel). x (E,C,d) against w (E,d,f) -> (E,C,f): for each expert e,
// its C capacity rows times its own weight matrix, sums in fp32 and one
// rounding of each output to the dtype of x. Unlike the TPU kernel, whose
// blocks shrink to divisors of the shape (_fit_block), it masks ragged
// tails, so any C, d and f work.
//
// What bounds it on the H100: HBM. Every call reads the whole weight
// tensor, E*d*f elements, against 2*E*C*d*f operations: C operations per
// weight element, and C is small at the serving shapes (the one-hot
// dispatch gives every expert a capacity buffer of 4 rows at decode, 16 and
// 64 at the 64- and 256-token prefill buckets). For granite-moe-3b-a800m
// (E=40, d=1536, f=512, bf16) that is 62.9 MB per call, about 19 us at
// 3.35 TB/s, against 0.5 GFLOP at C=4 and 8 GFLOP at C=64 (8 us on the
// tensor cores, about 120 us as fp32 FMA on the CUDA cores).
//
// Design of the bf16 kernel (gmm_mma_kernel): the weight stream has to keep
// about 25 KB in flight on every SM, and every SM must stream a share.
// - One block of 4 warps per (expert, 64-column f tile) strip, each warp a
//   quarter of the columns over all of d, so every output is one warp's sum
//   in a fixed order: no reduction across blocks, no atomics, results
//   repeat bit for bit. At granite's shapes that is 320 (gate/up) or 960
//   (down) blocks, several resident per SM.
// - Each block keeps a ring of 4 stages of (32 x 64 weight tile, 32 columns
//   of its x rows) in shared memory, filled with cp.async (16-byte copies,
//   zero-filled past d, f and C), 3 stages in flight while one is computed:
//   12 KB of weights per block.
// - The products run on the tensor cores: mma.sync m16n8k16 with the C rows
//   (padded to 16, 32 or 64; larger C in passes of 64) as A and the weight
//   tile as B (ldmatrix.trans), fp32 accumulators in registers. Tiles are
//   XOR-swizzled so that ldmatrix reads are conflict-free.
// Tilings timed against this one (chip_variants.py): 128-column tiles and
// an 8-stage ring. A split of d over a thread-block cluster, its partial
// sums added through distributed shared memory, was tried and dropped: it
// was level at best and up to 2x slower at the served shapes.
// It needs 16-byte rows and operands (d and f multiples of 8, x and w
// 16-byte aligned).
//
// The fp32 variant, and the path for bf16 operands the bf16 kernel does not
// take (f or d not a multiple of 8, w not 16-byte aligned), is the earlier
// kernel (gmm_kernel): one block of 256 threads per (f tile, expert), both
// operands widened to fp32 and FMA on the CUDA cores (no TF32, so the fp32
// sweep's 1e-4 holds), one d tile of 16-byte loads in flight; a scalar
// variant of it takes any f or a misaligned w.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

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

// ------------------------------------------------------------------------
// The bf16 tensor-core kernel (see the note at the top).
constexpr int kMmaThreads = 128;          // 4 warps, a quarter of the f tile each
constexpr int kMmaFT = 64;                // columns of f per block
constexpr int kNJ = kMmaFT / 4 / 8;       // n8 tiles per warp
constexpr int kMmaKT = 32;                // rows of d per stage
constexpr int kStages = 4;

template <int MT>
constexpr int mma_smem_bytes() { return kStages * (kMmaKT * kMmaFT + MT * 16 * kMmaKT) * 2; }

// MT m16 tiles of C rows per pass (16 * MT rows; C > 16 * MT in passes).
template <int MT>
__global__ void __launch_bounds__(kMmaThreads)
gmm_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ o, int C, int d, int f) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kWTile = kMmaKT * kMmaFT, kXTile = MT * 16 * kMmaKT;
  auto ws = reinterpret_cast<__nv_bfloat16*>(smem);                   // [kStages][kWTile]
  auto xs = ws + kStages * kWTile;                                    // [kStages][kXTile]

  const int f0 = blockIdx.x * kMmaFT, e = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nt = (d + kMmaKT - 1) / kMmaKT;
  const __nv_bfloat16* xe = x + size_t(e) * C * d;
  const __nv_bfloat16* we = w + size_t(e) * d * f;
  __nv_bfloat16* oe = o + size_t(e) * C * f;

  for (int c0 = 0; c0 < C; c0 += MT * 16) {
    // Stage i: d tile i of the 32 x kMmaFT weights and the 16*MT x 32 x
    // tile, 16-byte copies zero-filled past d, f and C.
    auto load = [&](int i) {
      if (i >= nt) return;
      const int slot = i % kStages, k0 = i * kMmaKT;
      __nv_bfloat16* wt = ws + slot * kWTile;
#pragma unroll
      for (int j = 0; j < kWTile / 8 / kMmaThreads; ++j) {
        const int idx = tid + j * kMmaThreads, r = idx / (kMmaFT / 8), c = idx % (kMmaFT / 8);
        const bool ok = k0 + r < d && f0 + 8 * c < f;
        cp_async16(wt + swz<kMmaFT / 8>(r, c),
                   ok ? we + size_t(k0 + r) * f + f0 + 8 * c : we, ok);
      }
      __nv_bfloat16* xt = xs + slot * kXTile;
#pragma unroll
      for (int j = 0; j < (kXTile / 8 + kMmaThreads - 1) / kMmaThreads; ++j) {
        const int idx = tid + j * kMmaThreads, r = idx / (kMmaKT / 8), c = idx % (kMmaKT / 8);
        if (idx < kXTile / 8) {
          const bool ok = c0 + r < C && k0 + 8 * c < d;
          cp_async16(xt + swz<kMmaKT / 8>(r, c),
                     ok ? xe + size_t(c0 + r) * d + k0 + 8 * c : xe, ok);
        }
      }
    };

    float acc[MT][kNJ][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[m][j][v] = 0.f;

#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      load(i);
      cp_async_commit();
    }
    for (int i = 0; i < nt; ++i) {
      cp_async_wait<kStages - 2>();      // stage i has landed (this thread's part)
      __syncthreads();                   // ... everyone's, and stage i-1 is consumed
      load(i + kStages - 1);             // into the slot stage i-1 used
      cp_async_commit();
      const __nv_bfloat16* wt = ws + (i % kStages) * kWTile;
      const __nv_bfloat16* xt = xs + (i % kStages) * kXTile;
#pragma unroll
      for (int kk = 0; kk < kMmaKT / 16; ++kk) {
        uint32_t a[MT][4], b[kNJ / 2][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldmatrix_x4(a[m], xt + swz<kMmaKT / 8>(m * 16 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
        for (int j = 0; j < kNJ / 2; ++j)
          ldmatrix_x4_trans(b[j], wt + swz<kMmaFT / 8>(16 * kk + (lane & 15),
                                                        kNJ * warp + 2 * j + (lane >> 4)));
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < kNJ; ++j)
            mma_bf16(acc[m][j], a[m], b[j / 2][2 * (j % 2)], b[j / 2][2 * (j % 2) + 1]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();                     // the ring is free for the next pass

    // Each warp holds the whole d sum of its columns: two adjacent outputs
    // per fragment row, rounded once (f is a multiple of 8, so col < f
    // takes col + 1 too).
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int col = f0 + 8 * (kNJ * warp + j) + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = c0 + m * 16 + g + 8 * h;
          if (r < C && col < f)
            *reinterpret_cast<uint32_t*>(oe + size_t(r) * f + col) =
                pack_bf16(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
        }
      }
  }
}

template <int MT>
cudaError_t launch_mma(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* o,
                       int E, int C, int d, int f, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<MT>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_mma_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  gmm_mma_kernel<MT><<<dim3(cdiv(f, kMmaFT), E), kMmaThreads, smem, stream>>>(x, w, o, C, d, f);
  return cudaGetLastError();
}

// Rows of C per pass of the bf16 kernel: 16, 32, or 64 (C > 64 in passes).
inline int mma_tiles(int C) { return C <= 16 ? 1 : C <= 32 ? 2 : 4; }

}  // namespace
}  // namespace repro

// x (E,C,d), w (E,d,f), o (E,C,f); all contiguous, of one dtype
// (repro::DType); E <= 65535. variant 0 is the CUDA-core kernel (any
// operands); variant 1 the bf16 tensor-core kernel, which needs bf16, d and
// f multiples of 8 and x and w 16-byte aligned. Launches on `stream` of
// `device` and returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_grouped_matmul(const void* x, const void* w, void* o, int E, int C,
                                    int d, int f, int dtype, int variant, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0 || E > 65535) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const bool ok = dtype == repro::kBFloat16 && d % 8 == 0 && f % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (!ok) return cudaErrorInvalidValue;
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    const auto* wp = static_cast<const __nv_bfloat16*>(w);
    auto* op = static_cast<__nv_bfloat16*>(o);
    switch (repro::mma_tiles(C)) {
      case 1: return repro::launch_mma<1>(xp, wp, op, E, C, d, f, s);
      case 2: return repro::launch_mma<2>(xp, wp, op, E, C, d, f, s);
      default: return repro::launch_mma<4>(xp, wp, op, E, C, d, f, s);
    }
  }
  if (variant != 0) return cudaErrorInvalidValue;
  if (dtype == repro::kFloat32) return repro::dispatch<float>(x, w, o, E, C, d, f, s);
  if (dtype == repro::kBFloat16) return repro::dispatch<__nv_bfloat16>(x, w, o, E, C, d, f, s);
  return cudaErrorInvalidValue;
}
