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
//
// The gradients (repro_grouped_gemm below). Replaces:
// src/repro/kernels/moe_gmm/ops.py, _gmm_bwd, the jax.custom_vjp rule of
// gmm_pallas: dx = g w^T (E,C,d) and dw = x^T g (E,d,f), each a grouped
// product of the untransposed tensors, one layout instance of one kernel:
// dx "NT" (g rows of f, w rows of f: both operands K-major) and dw "TN"
// (x and g rows of d and f with K = C across rows: both MN-major). At
// training capacities (granite-moe-3b-a800m, C = 256 at B x S = 1024) one
// call is 16.1 GFLOP (16 us on the tensor cores) against 105 MB (31 us at
// 3.35 TB/s): bound by bytes, but only a kernel that feeds the tensor cores
// at full rate gets near it, so the design is Hopper's GEMM shape:
// - gmm_tiled_kernel: one persistent block per SM walks 128 x kTBN output
//   tiles (expert-major, the M tiles of one weight tile adjacent so they
//   share it in L2). One producer warp issues TMA loads (3-D tensor maps:
//   (E, rows, inner), so a box never crosses into the next expert and reads
//   past C, d or f are zeros, which also zero-fills dw's K = C tail) into a
//   ring of kTStages stages of 128 x 64 and kTBN x 64 tiles in the 128-byte
//   swizzle, each stage's arrival on a full mbarrier. Two consumer
//   warpgroups, 64 rows each, run wgmma m64nNk16 from shared memory (the
//   layout is the instruction's transpose bits: no copy of w or x), keep one
//   stage's products in flight and free a stage on its empty mbarrier.
// - Each output is one warpgroup's sum over K in a fixed order: no split-K,
//   no atomics; results repeat bit for bit. The epilogue stages the tile in
//   shared memory and writes 16-byte rows, while the producer already loads
//   the next tile.
// Its "NN" instance (x w, w MN-major) also takes the forward product from
// 128 capacity rows on (kernels/moe_gmm/ops.py TILED_MIN_C), where it beat
// gmm_mma_kernel 2-3x. Tilings timed (chip_variants.py): 64- and 128-column
// tiles, rings of 3 to 6 stages; 128 x 128 with 5 stages came first at
// C = 256 and 512.
// It needs bf16, the inner dims (d, f) multiples of 8 and 16-byte aligned
// operands (TMA's strides); any E, C. fp32 gradients, and bf16 operands
// that are not aligned, take gemm_fma_kernel: 64 x 64 tiles on the CUDA
// cores, fp32 FMA, K in order, any strides.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

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

// ------------------------------------------------------------------------
// The grouped GEMM of the gradients (see the note at the top): out[e] (M x
// N) = A[e] (M x K) B[e] (K x N), bf16 in, fp32 sums, bf16 out.
using bf16 = __nv_bfloat16;
constexpr int kTM = 128;                  // output rows per tile: two warpgroups of 64
constexpr int kTBN = 128;                 // output columns per tile (64 or 128)
constexpr int kTK = 64;                   // K per stage: one 128-byte swizzle row
constexpr int kTStages = 5;
constexpr int kTConsumers = 256;
constexpr int kTThreads = kTConsumers + 32;   // + the producer warp
constexpr int kTBox = 64 * kTK * 2;       // bytes of one 64-row (or 64-column) box

template <int BN> struct Wgmma;
template <> struct Wgmma<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    wgmma_m64n64k16<TA, TB>(d, a, b, acc);
  }
};
template <> struct Wgmma<128> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    wgmma_m64n128k16<TA, TB>(d, a, b, acc);
  }
};

constexpr int kTStageBytes = (kTM + kTBN) * kTK * 2;
constexpr int kTEpPitch = kTBN + 8;       // staged epilogue rows: conflict-free fragment writes
// + 1024: the tiles' alignment
constexpr int kTSmemBytes = 1024 + kTStages * kTStageBytes + 2 * 64 * kTEpPitch * 2 + 2 * kTStages * 8;

__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// kTA / kTB: 0 when the operand is K-major (A: rows of K, (E, M, K); B:
// rows of K, (E, N, K)), 1 when MN-major (A: (E, K, M); B: (E, K, N)).
// ta / tb: the operands' tensor maps; a K-major one in boxes of 64 K x 128
// (A) or kTBN (B) rows, an MN-major one in boxes of 64 MN x 64 K rows.
template <int kTA, int kTB>
__global__ void __launch_bounds__(kTThreads, 1)
gmm_tiled_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                 bf16* __restrict__ out, int E, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles start on 1024-byte boundaries
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  constexpr int kStage = kTStageBytes, kABytes = kTM * kTK * 2;
  bf16* ep = reinterpret_cast<bf16*>(smem + kTStages * kStage);        // [2][64][kTEpPitch]
  uint64_t* full = reinterpret_cast<uint64_t*>(ep + 2 * 64 * kTEpPitch);
  uint64_t* empty = full + kTStages;

  const int tm = (M + kTM - 1) / kTM, tn = (N + kTBN - 1) / kTBN;
  const int per_e = tm * tn, tiles = E * per_e, nk = (K + kTK - 1) / kTK;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kTConsumers / 32) {
    // The producer: one thread keeps the ring full, tile after tile.
    if (threadIdx.x % 32 != 0) return;
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int e = t / per_e, r = t % per_e, m0 = (r % tm) * kTM, n0 = (r / tm) * kTBN;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&empty[s], phase ^ 1);          // the consumers freed this stage
        unsigned char* sa = smem + s * kStage;
        unsigned char* sb = sa + kABytes;
        const int k0 = kb * kTK;
        mbar_expect_tx(&full[s], kStage);
        if (kTA) {
          tma_load_3d(sa, &ta, &full[s], m0, k0, e);
          tma_load_3d(sa + kTBox, &ta, &full[s], m0 + 64, k0, e);
        } else {
          tma_load_3d(sa, &ta, &full[s], k0, m0, e);
        }
        if (kTB) {
#pragma unroll
          for (int h = 0; h < kTBN / 64; ++h) tma_load_3d(sb + h * kTBox, &tb, &full[s], n0 + 64 * h, k0, e);
        } else {
          tma_load_3d(sb, &tb, &full[s], k0, n0, e);
        }
        if (++s == kTStages) { s = 0; phase ^= 1; }
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile.
  const int wg = warp / 4, tid = threadIdx.x % 128, lane = threadIdx.x % 32, w4 = warp % 4;
  bf16* my = ep + wg * 64 * kTEpPitch;
  float acc[kTBN / 2];
  int s = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int e = t / per_e, r = t % per_e, m0 = (r % tm) * kTM, n0 = (r / tm) * kTBN;
    int prev = 0;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[s], phase);
      const unsigned char* sa = smem + s * kStage + wg * kTBox;
      const unsigned char* sb = smem + s * kStage + kABytes;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kTK / 16; ++j) {
        // K-major: 16 K = 32 bytes along the swizzled row; MN-major: 16 K
        // rows of 128 bytes. 64-wide MN blocks lie kTBox apart.
        const uint64_t da = kTA ? wgmma_desc(sa + 2048 * j, kTBox, 1024)
                                : wgmma_desc(sa + 32 * j, 16, 1024);
        const uint64_t db = kTB ? wgmma_desc(sb + 2048 * j, kTBox, 1024)
                                : wgmma_desc(sb + 32 * j, 16, 1024);
        Wgmma<kTBN>::template run<kTA, kTB>(acc, da, db, kb > 0 || j > 0);
      }
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<1>();                           // the previous stage's products are done
      if (kb > 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == kTStages) { s = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[prev]);

    // Epilogue: fragments to shared memory, then 16-byte rows to the output.
    wg_barrier(1 + wg);                          // the previous tile's rows are written
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int i = 0; i < kTBN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(my + (16 * w4 + g + 8 * h) * kTEpPitch + 8 * i + 2 * q) =
            pack_bf16(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    wg_barrier(1 + wg);
    bf16* oe = out + size_t(e) * M * N;
#pragma unroll
    for (int c = tid; c < 64 * kTBN / 8; c += 128) {
      const int rr = c / (kTBN / 8), cc = c % (kTBN / 8);
      const int row = m0 + 64 * wg + rr, col = n0 + 8 * cc;
      if (row < M && col < N)
        *reinterpret_cast<uint4*>(oe + size_t(row) * N + col) =
            *reinterpret_cast<const uint4*>(my + rr * kTEpPitch + 8 * cc);
    }
  }
}

// out[e] = A[e] B[e] on the CUDA cores: A(m, k) = a[e sae + m sam + k sak],
// B(k, n) = b[e sbe + k sbk + n sbn]; 64 x 64 tiles, 16 K per step staged as
// fp32, each thread 4 x 4 outputs (rows ty + 16 i, columns tx + 16 j), fp32
// FMA in K order (no TF32).
constexpr int kFT = 64, kFK = 16;

template <typename T>
__global__ void __launch_bounds__(256)
gemm_fma_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ o, int M,
                int N, int K, long long sae, long long sam, long long sak, long long sbe,
                long long sbk, long long sbn) {
  __shared__ float as[kFK][kFT + 1], bs[kFK][kFT + 1];
  const int e = blockIdx.z, m0 = blockIdx.y * kFT, n0 = blockIdx.x * kFT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* ae = a + e * sae;
  const T* be = b + e * sbe;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < kFT * kFK / 256; ++i) {
      const int idx = threadIdx.x + 256 * i;
      // neighbouring threads along whichever axis is contiguous
      const int am = sak == 1 ? idx / kFK : idx % kFT, ak = sak == 1 ? idx % kFK : idx / kFT;
      const int bn = sbn == 1 ? idx % kFT : idx / kFK, bk = sbn == 1 ? idx / kFT : idx % kFK;
      as[ak][am] = (m0 + am < M && k0 + ak < K)
                       ? to_float<T>(ae[(m0 + am) * sam + (k0 + ak) * sak]) : 0.f;
      bs[bk][bn] = (n0 + bn < N && k0 + bk < K)
                       ? to_float<T>(be[(k0 + bk) * sbk + (n0 + bn) * sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(as[k][ty + 16 * i], bs[k][tx + 16 * j], acc[i][j]);
    __syncthreads();
  }
  T* oe = o + size_t(e) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) oe[size_t(m) * N + n] = from_float<T>(acc[i][j]);
    }
}

template <int kTA, int kTB>
cudaError_t launch_tiled(const void* a, const void* b, void* o, int E, int M, int N, int K,
                         int device, cudaStream_t stream) {
  CUtensorMap ta, tb;
  // a: (E, M, K) K-major, (E, K, M) MN-major; b: (E, N, K) or (E, K, N)
  const bool ok = (kTA ? encode_bf16_map(&ta, a, E, K, M, kTK)
                       : encode_bf16_map(&ta, a, E, M, K, kTM)) &&
                  (kTB ? encode_bf16_map(&tb, b, E, K, N, kTK)
                       : encode_bf16_map(&tb, b, E, N, K, kTBN));
  if (!ok) return cudaErrorInvalidValue;
  constexpr int smem = kTSmemBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_tiled_kernel<kTA, kTB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)E * cdiv(M, kTM) * cdiv(N, kTBN);
  const int grid = int(tiles < sms ? tiles : sms);
  gmm_tiled_kernel<kTA, kTB><<<grid, kTThreads, smem, stream>>>(
      ta, tb, static_cast<bf16*>(o), E, M, N, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gemm_fma(const void* a, const void* b, void* o, int E, int M, int N, int K,
                            int layout, cudaStream_t stream) {
  // element strides of A(m, k) and B(k, n) for the three layouts
  const long long sae = (long long)M * K, sbe = (long long)K * N;
  const long long sam = layout == 2 ? 1 : K, sak = layout == 2 ? M : 1;
  const long long sbk = layout == 1 ? 1 : N, sbn = layout == 1 ? K : 1;
  gemm_fma_kernel<T><<<dim3(cdiv(N, kFT), cdiv(M, kFT), E), 256, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(o), M, N, K, sae, sam,
      sak, sbe, sbk, sbn);
  return cudaGetLastError();
}

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

// out[e] (M x N) = A[e] (M x K) B[e] (K x N), all contiguous, of one dtype
// (repro::DType), out (E, M, N). layout 0 "NN": a (E, M, K), b (E, K, N);
// 1 "NT": a (E, M, K), b (E, N, K) (dx = g w^T); 2 "TN": a (E, K, M),
// b (E, K, N) (dw = x^T g). variant 0 is the CUDA-core kernel (any
// operands); variant 1 the TMA/wgmma kernel, which needs bf16, the inner
// dims of a, b and out multiples of 8 and a and b 16-byte aligned. Launches
// on `stream` of `device` and returns cudaGetLastError() after the launch.
extern "C" int repro_grouped_gemm(const void* a, const void* b, void* o, int E, int M, int N,
                                  int K, int layout, int dtype, int variant, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (E <= 0 || M <= 0 || N <= 0 || K <= 0 || E > 65535 || layout < 0 || layout > 2)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const int inner_a = layout == 2 ? M : K, inner_b = layout == 1 ? K : N;
    const bool ok = dtype == repro::kBFloat16 && inner_a % 8 == 0 && inner_b % 8 == 0 &&
                    N % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(o) % 16 == 0;
    if (!ok) return cudaErrorInvalidValue;
    switch (layout) {
      case 0: return repro::launch_tiled<0, 1>(a, b, o, E, M, N, K, device, s);
      case 1: return repro::launch_tiled<0, 0>(a, b, o, E, M, N, K, device, s);
      default: return repro::launch_tiled<1, 1>(a, b, o, E, M, N, K, device, s);
    }
  }
  if (variant != 0) return cudaErrorInvalidValue;
  if (dtype == repro::kFloat32) return repro::launch_gemm_fma<float>(a, b, o, E, M, N, K, layout, s);
  if (dtype == repro::kBFloat16)
    return repro::launch_gemm_fma<__nv_bfloat16>(a, b, o, E, M, N, K, layout, s);
  return cudaErrorInvalidValue;
}
