// Chunked Mamba2 SSD (selective state-space) scan for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/mamba_scan/kernel.py, ssd_pallas (body
// _ssd_kernel). Per batch b and head h, with the (P x N) state S carried
// through the sequence:
//     S_t = exp(dt_t A_h) S_{t-1} + (dt_t x_t) outer B_t,
//     y_t = S_t C_t + D_h x_t.
// x (B,S,H,P) and B/C (B,S,N) in fp32 or bf16, dt (B,S,H), A and D (H,) and
// the initial state (B,H,P,N) in fp32 -> y (B,S,H,P) in x's dtype and the
// final state in fp32. Every input is widened to fp32 and all arithmetic is
// fp32 FMA on the CUDA cores (no TF32), as the plain version computes it.
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
// What bounds it on the H100: at zamba2-1.2b's prefill (H = P = N = 64) the
// fp32 operations, about 1.3 MFLOP per (b, h, chunk) against 20 KB of x, y
// and B/C per chunk and the 16 KB state read and written once; 67 TFLOP/s
// of fp32 against 3.35 TB/s puts it on the operations side.
//
// Design: the grid's sequential chunk axis on the TPU becomes a loop inside
// one block. One block of 256 threads per (16-row tile of P, h, b): rows p
// of the state are independent, so splitting P gives B*H*P/16 blocks (256
// at zamba2's prefill with B = 1) instead of B*H = 64 for 132 SMs, at the
// cost of recomputing C.B^T in each tile. The block keeps its 16 x N slice
// of the state resident in shared memory for the whole sequence. Per chunk
// it stages dt, B, C and its x columns in shared memory as fp32 (the loads
// are issued before the barrier that ends the previous chunk), forms cum
// with a warp scan, then runs the three products with register tiles: the
// 64 x 64 scores (4 x 4 per thread), y (4 rows per thread, over the 64
// scores and the N state columns) and the state update (4 columns of N per
// thread), reading shared memory as float4 along the contiguous axis.
// Products above the diagonal (u > t) are skipped where a whole register
// tile lies there, and so is the read of a state that is the zero initial
// state (the first chunk of a prefill). x, B, C and dt are read through
// batch and sequence strides, so the model's column slices of one conv
// buffer need no copy. Tensor cores (wgmma), sharing C.B^T across heads and
// splitting the sequence across blocks are later work.
#include <cstdint>

#include "common.cuh"

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
  const int smem = sizeof(SsdSmem<N>);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T, N><<<dim3(cdiv(a.P, kPT), a.H, batch), kSsdThreads, smem, stream>>>(a);
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
// B, H <= 65535. Launches on `stream` of `device` and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A, const void* B,
                              const void* C, const void* D, const void* init, void* y,
                              void* final_state, int batch, int S, int H, int P, int N,
                              long long sx_b, long long sx_s, long long sdt_b,
                              long long sdt_s, long long sB_b, long long sB_s,
                              long long sC_b, long long sC_s, int dtype, int device,
                              void* stream) {
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
  if (dtype == repro::kFloat32) return repro::dispatch<float>(a, batch, N, s);
  if (dtype == repro::kBFloat16) return repro::dispatch<__nv_bfloat16>(a, batch, N, s);
  return cudaErrorInvalidValue;
}
