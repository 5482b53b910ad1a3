// Chunked Mamba2 SSD (selective state-space) scan for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/mamba_scan/kernel.py, ssd_pallas (body
// _ssd_kernel). Per batch b and head h, with the (P x N) state S carried
// through the sequence:
//     S_t = exp(dt_t A_h) S_{t-1} + (dt_t x_t) outer B_t,
//     y_t = S_t C_t + D_h x_t.
// x (B,S,H,P) and B/C (B,S,N) in fp32 or bf16, dt (B,S,H), A and D (H,) and
// the initial state (B,H,P,N) in fp32 -> y (B,S,H,P) in x's dtype and the
// final state in fp32. The fp32 kernel widens every input to fp32 and does
// all arithmetic as fp32 FMA on the CUDA cores (no TF32), as the plain
// version computes it; the bf16 kernel runs its products on the tensor
// cores (below).
//
// The sequence is cut into chunks of T = 64 tokens, as on the TPU. Per
// chunk, with cum_t the running sum of dt_u A_h over the chunk:
//   M[t][u] = (C_t . B_u) dt_u exp(cum_t - cum_u) for u <= t, else 0;
//   y_t     = sum_u M[t][u] x_u + exp(cum_t) (S C_t) + D_h x_t;
//   S      <- exp(cum_T) S + sum_u exp(cum_T - cum_u) dt_u x_u outer B_u.
// The exponent is taken only where u <= t: above the diagonal it is
// positive, and exp overflowing to inf times a zero mask would give NaN.
//
// Unlike the TPU kernel, which asserts S % T == 0, any S works: the ragged
// last chunk is padded with dt = 0 inside the kernel (decay exp(0) = 1,
// update 0, so the state passes through) and its padded rows of y are not
// stored.
//
// What bounds it on the H100: at zamba2-1.2b's prefill (B = 1, S <= 63,
// H = P = N = 64) neither bytes nor operations: 2.1 MB and 0.05 GFLOP per
// call are well under a microsecond at 3.35 TB/s or on the bf16 tensor
// cores, the peak rate for its inputs' type (the bytes' 0.64 us is the
// bound). Latency bounds it: each block's chain of dependent products,
// barriers and exponentials over a chunk.
//
// Design of the bf16 kernel (ssd_mma_kernel, x/B/C bf16):
// - One block of 4 warps per (kPW columns of P, head, b); the chunk axis
//   is a loop inside the block. The block keeps its slice of the head's
//   state resident in shared memory in fp32 for the whole sequence.
// - Per chunk it stages B, C, x (bf16, XOR-swizzled) and dt (fp32) by
//   cp.async, the next chunk's loads in flight behind this one's products.
//   cum is a warp scan, as in the fp32 kernel, kept in base-2 units so that
//   every exponential is one ex2 (MUFU), and it is taken only where u <= t.
// - All four products run on the tensor cores (mma.sync, fp32 sums): C.B^T
//   (bf16, exact products), once per chunk per block; the
//   decay-masked scores M times x, M built in fp32 from C.B^T and taken as
//   two bf16 operands (its rounding and the remainder: one rounding fails
//   the row check where the t = 0 row's coefficient cancels); the read of
//   the carried state C.S^T; and the state update (x w)^T B (x w rounded
//   once to bf16), accumulated onto exp(cum_T) S in fp32. Warp w owns
//   tokens 16w .. 16w + 15 of the first three, and 16-row slices of P of
//   the update. Tiles above the diagonal are skipped, and so is the state
//   read of a zero initial state.
// - The state is fp32 throughout; only its copy as an operand of C.S^T is
//   rounded, to TF32 (m16n8k8). Rounded to bf16, y's error reached 6.25e-2
//   where the repo's bf16 tolerance (atol 2e-2 + rtol 2e-2) allowed less,
//   at B = 3, S = 1000, H = 3, P = 16, N = 32 with a nonzero initial state,
//   though bf16 was 8.2 us faster at zamba2's shape, S = 1000.
// - kPW = 16 columns of P and one head per block: 256 blocks at zamba2's
//   prefill (B = 1, H = P = 64) for 132 SMs, each forming its head's C.B^T
//   once per chunk. chip_variants.py times 32 and 64 columns, both slower;
//   two heads per block sharing one C.B^T were slower too.
// - cudaFuncSetAttribute runs once per instantiation (a static).
//
// The fp32 variant, and the bf16 `before` time in chip_smoke.py, is the
// earlier kernel (ssd_scan_kernel): one block of 256 threads per (16-row
// tile of P, h, b), with the 16 x N slice of the state resident in shared
// memory. Per chunk it stages dt, B, C and its x columns as fp32 (the loads
// issued before the barrier that ends the previous chunk), forms cum with a
// warp scan, then runs three products as fp32 FMA with register tiles --
// the 64 x 64 scores, y (over the scores and the state) and the state
// update -- reading shared memory as float4. C.B^T is recomputed in each
// P tile. x, B, C and dt are read through batch and sequence strides by
// both kernels, so the model's column slices of one conv buffer need no
// copy. Splitting the sequence across blocks is later work.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace repro {
namespace {

constexpr int kT = 64;              // tokens per chunk
constexpr int kPT = 16;             // state rows (P) per block
constexpr int kSsdThreads = 256;

template <int N>
struct SsdSmem {
  float B[kT][N + 4];    // +4: rows stay 16-byte aligned and float4 reads
  float C[kT][N + 4];    //     of 8 consecutive rows hit distinct banks
  float M[kT][kT + 4];   // decay-masked scores M[t][u]
  float x[kT][kPT];      // this tile's columns of x
  float S[kPT][N + 4];   // this tile's rows of the carried state
  float dt[kT];
  float cum[kT];         // running sum of dt_u * A_h within the chunk
  float w[kT];           // exp(cum_T - cum_u) * dt_u
};

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  const float* init;  // nullptr: zero initial state
  void* y;
  float* final_state;
  int S, H, P;
  long long sx_b, sx_s, sdt_b, sdt_s, sB_b, sB_s, sC_b, sC_s;
};

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One chunk's global loads, held in registers between fetch() and store().
// fetch() clamps every address in bounds and has no branch around a load; a
// row at or past `valid` (and a column past P) is zeroed by store().
template <typename T, int N>
struct ChunkLoads {
  static constexpr int kBC = kT * N / kSsdThreads;
  static constexpr int kX = kT * kPT / kSsdThreads;
  static_assert(kBC * kSsdThreads == kT * N && kX * kSsdThreads == kT * kPT, "tiling");
  T b[kBC], c[kBC], x[kX];
  float dt;

  __device__ __forceinline__ void fetch(const SsdArgs& a, int bi, int h, int p0, int t0,
                                        int valid) {
    const T* Bp = static_cast<const T*>(a.B) + bi * a.sB_b;
    const T* Cp = static_cast<const T*>(a.C) + bi * a.sC_b;
    const T* xp = static_cast<const T*>(a.x) + bi * a.sx_b + size_t(h) * a.P;
#pragma unroll
    for (int k = 0; k < kBC; ++k) {
      const int e = threadIdx.x + k * kSsdThreads;
      const long long t = t0 + min(e / N, valid - 1);
      b[k] = Bp[t * a.sB_s + e % N];
      c[k] = Cp[t * a.sC_s + e % N];
    }
#pragma unroll
    for (int k = 0; k < kX; ++k) {
      const int e = threadIdx.x + k * kSsdThreads;
      const long long t = t0 + min(e / kPT, valid - 1);
      x[k] = xp[t * a.sx_s + min(p0 + e % kPT, a.P - 1)];
    }
    const long long t = t0 + min(int(threadIdx.x) % kT, valid - 1);
    dt = a.dt[bi * a.sdt_b + t * a.sdt_s + h];
  }

  __device__ __forceinline__ void store(SsdSmem<N>& s, int valid, int p0, int P) const {
#pragma unroll
    for (int k = 0; k < kBC; ++k) {
      const int e = threadIdx.x + k * kSsdThreads, t = e / N, n = e % N;
      s.B[t][n] = t < valid ? to_float<T>(b[k]) : 0.f;
      s.C[t][n] = t < valid ? to_float<T>(c[k]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kX; ++k) {
      const int e = threadIdx.x + k * kSsdThreads, t = e / kPT, p = e % kPT;
      s.x[t][p] = t < valid && p0 + p < P ? to_float<T>(x[k]) : 0.f;
    }
    if (threadIdx.x < kT) s.dt[threadIdx.x] = int(threadIdx.x) < valid ? dt : 0.f;
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(kSsdThreads, N <= 64 ? 2 : 1)
ssd_scan_kernel(SsdArgs a) {
  extern __shared__ float4 smem_raw[];
  SsdSmem<N>& s = *reinterpret_cast<SsdSmem<N>*>(smem_raw);
  const int p0 = blockIdx.x * kPT, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int P = a.P, H = a.H;
  const float Ah = a.A[h], Dh = a.D[h];
  const size_t state_base = (size_t(bi) * H + h) * P * N;

  for (int e = tid; e < kPT * N; e += kSsdThreads) {
    const int p = e / N, n = e % N;
    s.S[p][n] = a.init != nullptr && p0 + p < P ? a.init[state_base + size_t(p0 + p) * N + n]
                                                 : 0.f;
  }

  const int nc = (a.S + kT - 1) / kT;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kT, valid = min(kT, a.S - t0);
    {
      // The chunk's loads are issued before the barrier, so they overlap
      // the wait for the previous chunk's last reads of shared memory; the
      // registers that hold them are free again during the products.
      ChunkLoads<T, N> ld;
      ld.fetch(a, bi, h, p0, t0, valid);
      __syncthreads();  // the previous chunk's shared memory is consumed
      ld.store(s, valid, p0, P);
    }
    __syncthreads();

    // cum: an inclusive warp scan over the 64 tokens, two per lane.
    if (warp == 0) {
      const float a0 = s.dt[2 * lane] * Ah, a1 = s.dt[2 * lane + 1] * Ah;
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float ex = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) ex = 0.f;
      const float c0 = ex + a0, c1 = c0 + a1;
      const float total = __shfl_sync(0xffffffffu, c1, 31);
      s.cum[2 * lane] = c0;
      s.cum[2 * lane + 1] = c1;
      s.w[2 * lane] = expf(total - c0) * s.dt[2 * lane];
      s.w[2 * lane + 1] = expf(total - c1) * s.dt[2 * lane + 1];
    }
    __syncthreads();

    // Scores: thread (ti, tu) owns rows ti + 16i and columns tu + 16j.
    // Where j > i every column lies above the diagonal (u > t): those
    // products are skipped and their scores are zero.
    {
      const int ti = tid / 16, tu = tid % 16;
      float acc[4][4] = {};
#pragma unroll 1  // 8 float4 loads per step are enough in flight; more spill
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ld4(&s.C[ti + 16 * i][n]);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ld4(&s.B[tu + 16 * j][n]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j) acc[i][j] = dot4(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ti + 16 * i;
        const float ct = s.cum[t];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = tu + 16 * j;
          s.M[t][u] = u <= t ? acc[i][j] * s.dt[u] * expf(ct - s.cum[u]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y: thread (tg, p) owns rows tg + 16i of column p. Tokens u in
    // [16k, 16k + 16) lie above the diagonal of rows i < k: skipped. The
    // read of the carried state is skipped where it is the zero initial
    // state.
    {
      const int tg = tid / 16, p = tid % 16;
      float yi[4] = {}, ys[4] = {};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll 2
        for (int u = 16 * k; u < 16 * k + 16; u += 4) {
          const float x0 = s.x[u][p], x1 = s.x[u + 1][p], x2 = s.x[u + 2][p], x3 = s.x[u + 3][p];
#pragma unroll
          for (int i = k; i < 4; ++i) {
            const float4 m = ld4(&s.M[tg + 16 * i][u]);
            yi[i] = fmaf(m.w, x3, fmaf(m.z, x2, fmaf(m.y, x1, fmaf(m.x, x0, yi[i]))));
          }
        }
      }
      if (c > 0 || a.init != nullptr) {
#pragma unroll 2
        for (int n = 0; n < N; n += 4) {
          const float4 sv = ld4(&s.S[p][n]);
#pragma unroll
          for (int i = 0; i < 4; ++i) ys[i] = dot4(ld4(&s.C[tg + 16 * i][n]), sv, ys[i]);
        }
      }
      if (p0 + p < P) {
        T* yp = static_cast<T*>(a.y) + (size_t(bi) * a.S + t0) * H * P + size_t(h) * P + p0 + p;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = tg + 16 * i;
          if (t < valid)
            yp[size_t(t) * H * P] =
                from_float<T>(yi[i] + expf(s.cum[t]) * ys[i] + Dh * s.x[t][p]);
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // State update: thread owns 4 consecutive columns n of one row p; the
    // 16 rows p are the fastest-varying, so a warp reads 16 x values and
    // only 2 float4 of B per token.
    {
      const float lend = expf(s.cum[kT - 1]);
      for (int e = tid; e < kPT * N / 4; e += kSsdThreads) {
        const int p = e % kPT, n = 4 * (e / kPT);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
        for (int u = 0; u < kT; ++u) {
          const float xw = s.x[u][p] * s.w[u];
          const float4 bv = ld4(&s.B[u][n]);
          acc.x = fmaf(xw, bv.x, acc.x);
          acc.y = fmaf(xw, bv.y, acc.y);
          acc.z = fmaf(xw, bv.z, acc.z);
          acc.w = fmaf(xw, bv.w, acc.w);
        }
        float4 sv = ld4(&s.S[p][n]);
        sv.x = fmaf(lend, sv.x, acc.x);
        sv.y = fmaf(lend, sv.y, acc.y);
        sv.z = fmaf(lend, sv.z, acc.z);
        sv.w = fmaf(lend, sv.w, acc.w);
        *reinterpret_cast<float4*>(&s.S[p][n]) = sv;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < kPT * N; e += kSsdThreads) {
    const int p = e / N, n = e % N;
    if (p0 + p < P) a.final_state[state_base + size_t(p0 + p) * N + n] = s.S[p][n];
  }
}

template <typename T, int N>
cudaError_t launch(const SsdArgs& a, int batch, cudaStream_t stream) {
  constexpr int smem = sizeof(SsdSmem<N>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  ssd_scan_kernel<T, N><<<dim3(cdiv(a.P, kPT), a.H, batch), kSsdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}


// ------------------------------------------------------------------------
// The bf16 tensor-core kernel (see the note at the top).
constexpr int kMW = 4;                  // warps per block
constexpr int kPW = 16;                 // columns of P per block
static_assert(kPW % 16 == 0 && kPW <= 16 * kMW && (16 * kMW) % kPW == 0, "P tile");

// (a, b) as a bf16x2 operand `hi` and the remainder (a, b) - hi as `lo`:
// hi + lo holds about 16 bits of each value.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

template <int N>
struct MmaSmem {
  static constexpr int kBC = kT * N;            // one bf16 tile of B or C
  static constexpr int kX = kT * kPW;           // the block's x tile, bf16
  static constexpr int kSP = N + 4;             // fp32 state row pitch
  static constexpr int bytes() {
    return 2 * (2 * 2 * kBC + 2 * kX + kX) + 4 * (2 * kT + 2 * kT + kPW * kSP);
  }
};

// y rows (and the state-read rows) of warp w: tokens 16w .. 16w + 15 of the
// chunk; thread (g = lane / 4, q = lane % 4) holds rows g and g + 8 of each
// mma tile, columns 2q and 2q + 1.
template <int N>
__global__ void __launch_bounds__(32 * kMW)
ssd_mma_kernel(SsdArgs a) {
  using bf16 = __nv_bfloat16;
  using L = MmaSmem<N>;
  constexpr int CHN = N / 8, CHP = kPW / 8;
  constexpr int RG = kPW / 16, NG = kMW / RG;          // state-update warps: row groups x n groups
  constexpr int NDN = (N / 16 + NG - 1) / NG;           // 16-column n tiles per update warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Bs = reinterpret_cast<bf16*>(smem);             // [2][kT][N], swizzled
  bf16* Cs = Bs + 2 * L::kBC;                           // [2][kT][N]
  bf16* xs = Cs + 2 * L::kBC;                           // [2][kT][kPW]
  bf16* xw = xs + 2 * L::kX;                            // [kT][kPW]: x_u * w_u
  float* dts = reinterpret_cast<float*>(xw + L::kX);    // [2][kT]
  float* cum = dts + 2 * kT;                            // [kT]
  float* wts = cum + kT;                                // [kT]
  float* Ss = wts + kT;                                 // [kPW][N + 4] fp32 state

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int p0 = blockIdx.x * kPW, h = blockIdx.y, bi = blockIdx.z;
  const int P = a.P, H = a.H;
  const bf16* Bg = static_cast<const bf16*>(a.B) + bi * a.sB_b;
  const bf16* Cg = static_cast<const bf16*>(a.C) + bi * a.sC_b;
  const bf16* xg = static_cast<const bf16*>(a.x) + bi * a.sx_b;
  const float* dtg = a.dt + bi * a.sdt_b;

  // Chunk c's B, C, x and dt into ring slot c % 2; rows past the sequence
  // and columns past P are zero-filled (dt = 0 pads the tail).
  auto load_chunk = [&](int c) {
    const int t0 = c * kT, valid = min(kT, a.S - t0), st = c & 1;
    for (int i = tid; i < kT * CHN; i += 32 * kMW) {
      const int t = i / CHN, ch = i % CHN;
      const bool ok = t < valid;
      cp_async16(Bs + st * L::kBC + swz<CHN>(t, ch), ok ? Bg + (t0 + t) * a.sB_s + 8 * ch : Bg, ok);
      cp_async16(Cs + st * L::kBC + swz<CHN>(t, ch), ok ? Cg + (t0 + t) * a.sC_s + 8 * ch : Cg, ok);
    }
    for (int i = tid; i < kT * CHP; i += 32 * kMW) {
      const int t = i / CHP, ch = i % CHP;
      const bool ok = t < valid && p0 + 8 * ch < P;
      cp_async16(xs + st * L::kX + swz<CHP>(t, ch),
                 ok ? xg + (t0 + t) * a.sx_s + size_t(h) * P + p0 + 8 * ch : xg, ok);
    }
    for (int t = tid; t < kT; t += 32 * kMW) {
      const bool ok = t < valid;
      cp_async4(dts + st * kT + t, ok ? dtg + (t0 + t) * a.sdt_s + h : dtg, ok);
    }
  };

  const int nc = (a.S + kT - 1) / kT;
  load_chunk(0);
  cp_async_commit();
  for (int e = tid; e < kPW * N / 4; e += 32 * kMW) {
    const int p = e / (N / 4), n = 4 * (e % (N / 4));
    const bool ok = a.init != nullptr && p0 + p < P;
    *reinterpret_cast<float4*>(Ss + p * L::kSP + n) =
        ok ? *reinterpret_cast<const float4*>(a.init + ((size_t(bi) * H + h) * P + p0 + p) * N + n)
           : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kT, valid = min(kT, a.S - t0), st = c & 1;
    if (c + 1 < nc) load_chunk(c + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                        // chunk c has landed (and the initial state)
    const bf16* Bc = Bs + st * L::kBC;
    const bf16* Cc = Cs + st * L::kBC;
    const float* dtc = dts + st * kT;

    // cum and w: an inclusive warp scan over the 64 tokens, by warp 0.
    if (warp == 0) {
      const float Ah = a.A[h] * kLog2e;     // cum in base-2 units
      const float d0 = dtc[2 * lane], d1 = dtc[2 * lane + 1];
      const float a0 = d0 * Ah, a1 = d1 * Ah;
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float ex = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) ex = 0.f;
      const float c0 = ex + a0, c1 = c0 + a1;
      const float total = __shfl_sync(0xffffffffu, c1, 31);
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = c1;
      wts[2 * lane] = ex2(total - c0) * d0;
      wts[2 * lane + 1] = ex2(total - c1) * d1;
    }

    // C.B^T for this warp's 16 rows t, once per chunk; 16-column tiles of u
    // wholly above the diagonal (u > t) are skipped.
    uint32_t cf[N / 16][4];
#pragma unroll
    for (int kd = 0; kd < N / 16; ++kd)
      ldmatrix_x4(cf[kd], Cc + swz<CHN>(16 * warp + (lane & 15), 2 * kd + (lane >> 4)));
    float cb[kT / 8][4];
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) cb[j][x] = 0.f;
#pragma unroll
    for (int kd = 0; kd < N / 16; ++kd)
#pragma unroll
      for (int jj = 0; jj < kT / 16; ++jj) {
        if (jj > warp) continue;
        uint32_t bfr[4];
        ldmatrix_x4(bfr, Bc + swz<CHN>(16 * jj + (lane & 7) + ((lane >> 4) << 3),
                                       2 * kd + ((lane >> 3) & 1)));
        mma_bf16(cb[2 * jj], cf[kd], bfr[0], bfr[1]);
        mma_bf16(cb[2 * jj + 1], cf[kd], bfr[2], bfr[3]);
      }
    __syncthreads();                        // cum and w are written

    // x_u * w_u for the state update, rounded once to bf16.
    for (int i = tid; i < kT * CHP; i += 32 * kMW) {
      const int t = i / CHP, ch = i % CHP;
      const int off = swz<CHP>(t, ch);
      const uint4 raw = *reinterpret_cast<const uint4*>(xs + st * L::kX + off);
      float f[8];
      unpack<bf16>(raw, f);
      const float wt = wts[t];
      uint4 out;
      out.x = pack_bf16(f[0] * wt, f[1] * wt);
      out.y = pack_bf16(f[2] * wt, f[3] * wt);
      out.z = pack_bf16(f[4] * wt, f[5] * wt);
      out.w = pack_bf16(f[6] * wt, f[7] * wt);
      *reinterpret_cast<uint4*>(xw + off) = out;
    }

    const bool has_state = c > 0 || a.init != nullptr;
    const bf16* xh = xs + st * L::kX;
    int trow[2];
    float ct[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      trow[r] = 16 * warp + g + 8 * r;
      ct[r] = cum[trow[r]];
    }

    // y = M x: M[t][u] = (C_t . B_u) dt_u exp(cum_t - cum_u) for u <= t,
    // built in fp32 and taken as two bf16 operands, M's rounding and its
    // remainder (about 16 bits of M): at t = 0, y is
    // (C_0 . B_0 dt_0 + D) x_0, and where that sum cancels, one rounding
    // of M to bf16 leaves the row far off (1.1e-2 of its norm at B = 1,
    // S = 1000, H = 2, P = N = 16 in chip_smoke.py's row check).
    float yi[kPW / 8][4];
#pragma unroll
    for (int j = 0; j < kPW / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) yi[j][x] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      if (kk > warp) continue;
      float mv[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int u = 16 * kk + 8 * hh + 2 * qd + x;
          const float du = dtc[u], cu = cum[u];
#pragma unroll
          for (int r = 0; r < 2; ++r)
            mv[hh][2 * r + x] = u <= trow[r] ? cb[2 * kk + hh][2 * r + x] * du * ex2(ct[r] - cu) : 0.f;
        }
      uint32_t mhi[4], mlo[4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
        split_bf16(mv[x >> 1][2 * (x & 1)], mv[x >> 1][2 * (x & 1) + 1], mhi[x], mlo[x]);
#pragma unroll
      for (int dn = 0; dn < kPW / 16; ++dn) {
        uint32_t xf[4];
        ldmatrix_x4_trans(xf, xh + swz<CHP>(16 * kk + (lane & 15), 2 * dn + (lane >> 4)));
        mma_bf16(yi[2 * dn], mhi, xf[0], xf[1]);
        mma_bf16(yi[2 * dn + 1], mhi, xf[2], xf[3]);
        mma_bf16(yi[2 * dn], mlo, xf[0], xf[1]);
        mma_bf16(yi[2 * dn + 1], mlo, xf[2], xf[3]);
      }
    }

    // The carried state's read, C_t . S_p (skipped for a zero initial state).
    float ys[kPW / 8][4];
#pragma unroll
    for (int j = 0; j < kPW / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) ys[j][x] = 0.f;
    if (has_state) {
#pragma unroll
      for (int k8 = 0; k8 < N / 8; ++k8) {
        uint32_t af[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int row = 16 * warp + g + 8 * (x & 1);
          af[x] = __float_as_uint(__bfloat162float(Cc[swz<CHN>(row, k8) + qd + 4 * (x >> 1)]));
        }
#pragma unroll
        for (int jp = 0; jp < kPW / 8; ++jp) {
          const float* sr = Ss + (8 * jp + g) * L::kSP + 8 * k8 + qd;
          mma_tf32(ys[jp], af, to_tf32(sr[0]), to_tf32(sr[4]));
        }
      }
    }

    // y_t = (M x)_t + exp(cum_t) (C_t . S) + D_h x_t, stored as bf16 pairs.
    const float Dh = a.D[h];
    bf16* yp = static_cast<bf16*>(a.y) + (size_t(bi) * a.S + t0) * H * P + size_t(h) * P;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = trow[r];
      if (t >= valid) continue;
      const float el = ex2(ct[r]);
#pragma unroll
      for (int jp = 0; jp < kPW / 8; ++jp) {
        const int p = 8 * jp + 2 * qd;
        if (p0 + p >= P) continue;
        const __nv_bfloat162 xv =
            *reinterpret_cast<const __nv_bfloat162*>(xh + swz<CHP>(t, jp) + 2 * qd);
        const float y0 = yi[jp][2 * r] + el * ys[jp][2 * r] + Dh * __low2float(xv);
        const float y1 = yi[jp][2 * r + 1] + el * ys[jp][2 * r + 1] + Dh * __high2float(xv);
        *reinterpret_cast<uint32_t*>(yp + size_t(t) * H * P + p0 + p) = pack_bf16(y0, y1);
      }
    }
    __syncthreads();                        // xw is written; every read of the old state is done

    // S <- exp(cum_T) S + (x w)^T B: rows p of warp (rg, ng), 16-column n
    // tiles ng, ng + NG, ...; the state stays fp32, its update's operands bf16.
    {
      const int rg = warp % RG, ng = warp / RG;
      const float lend = ex2(cum[kT - 1]);
      uint32_t af[kT / 16][4];
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        ldmatrix_x4_trans(af[kk], xw + swz<CHP>(16 * kk + (lane & 7) + ((lane >> 4) << 3),
                                                 2 * rg + ((lane >> 3) & 1)));
#pragma unroll
      for (int i = 0; i < NDN; ++i) {
        const int dn = ng + i * NG;
        if (dn >= N / 16) break;
        float acc[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 v = *reinterpret_cast<const float2*>(
                Ss + (16 * rg + g + 8 * r) * L::kSP + 16 * dn + 8 * hh + 2 * qd);
            acc[hh][2 * r] = lend * v.x;
            acc[hh][2 * r + 1] = lend * v.y;
          }
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, Bc + swz<CHN>(16 * kk + (lane & 15), 2 * dn + (lane >> 4)));
          mma_bf16(acc[0], af[kk], bfr[0], bfr[1]);
          mma_bf16(acc[1], af[kk], bfr[2], bfr[3]);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(Ss + (16 * rg + g + 8 * r) * L::kSP + 16 * dn + 8 * hh +
                                       2 * qd) = make_float2(acc[hh][2 * r], acc[hh][2 * r + 1]);
      }
    }
    __syncthreads();                        // the state is updated; slot c % 2 is free
  }

  for (int e = tid; e < kPW * N / 4; e += 32 * kMW) {
    const int p = e / (N / 4), n = 4 * (e % (N / 4));
    if (p0 + p < P)
      *reinterpret_cast<float4*>(a.final_state + ((size_t(bi) * H + h) * P + p0 + p) * N + n) =
          *reinterpret_cast<const float4*>(Ss + p * L::kSP + n);
  }
}

template <int N>
cudaError_t launch_mma(const SsdArgs& a, int batch, cudaStream_t stream) {
  constexpr int smem = MmaSmem<N>::bytes();
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_mma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  ssd_mma_kernel<N><<<dim3(cdiv(a.P, kPW), a.H, batch), 32 * kMW, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const SsdArgs& a, int batch, int N, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<T, 16>(a, batch, stream);
    case 32: return launch<T, 32>(a, batch, stream);
    case 64: return launch<T, 64>(a, batch, stream);
    case 128: return launch<T, 128>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// x (B,S,H,P) and B/C (B,S,N) of one dtype (repro::DType), dt (B,S,H) fp32:
// each with a contiguous last axis (x's (H,P) contiguous) and the given
// batch and sequence strides, in elements. A, D (H,), init (B,H,P,N) or
// null, all fp32 and contiguous. Writes y (B,S,H,P) in x's dtype and the
// final state (B,H,P,N) fp32, both contiguous. N in {16, 32, 64, 128};
// B, H <= 65535. variant 0 is the CUDA-core kernel (either dtype); variant
// 1 the bf16 tensor-core kernel, which also needs P and the strides of x,
// B and C to be multiples of 8 and x, B and C 16-byte aligned. Launches on
// `stream` of `device` and returns cudaGetLastError() after the launch (0
// on success).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A, const void* B,
                              const void* C, const void* D, const void* init, void* y,
                              void* final_state, int batch, int S, int H, int P, int N,
                              long long sx_b, long long sx_s, long long sdt_b,
                              long long sdt_s, long long sB_b, long long sB_s,
                              long long sC_b, long long sC_s, int dtype, int variant,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch <= 0 || S <= 0 || H <= 0 || P <= 0 || batch > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  const repro::SsdArgs a{x,
                         static_cast<const float*>(dt),
                         static_cast<const float*>(A),
                         B,
                         C,
                         static_cast<const float*>(D),
                         static_cast<const float*>(init),
                         y,
                         static_cast<float*>(final_state),
                         S,
                         H,
                         P,
                         sx_b,
                         sx_s,
                         sdt_b,
                         sdt_s,
                         sB_b,
                         sB_s,
                         sC_b,
                         sC_s};
  const auto s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
    if (dtype != repro::kBFloat16 || P % 8 || (sx_b | sx_s | sB_b | sB_s | sC_b | sC_s) % 8 ||
        misaligned(x) || misaligned(B) || misaligned(C))
      return cudaErrorInvalidValue;
    switch (N) {
      case 16: return repro::launch_mma<16>(a, batch, s);
      case 32: return repro::launch_mma<32>(a, batch, s);
      case 64: return repro::launch_mma<64>(a, batch, s);
      case 128: return repro::launch_mma<128>(a, batch, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (variant != 0) return cudaErrorInvalidValue;
  if (dtype == repro::kFloat32) return repro::dispatch<float>(a, batch, N, s);
  if (dtype == repro::kBFloat16) return repro::dispatch<__nv_bfloat16>(a, batch, N, s);
  return cudaErrorInvalidValue;
}
