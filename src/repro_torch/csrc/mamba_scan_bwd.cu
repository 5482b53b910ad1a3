// Backward of the chunked Mamba2 SSD scan for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/mamba_scan/ops.py, _ssd_bwd (the custom VJP of
// the scan's y, jax.vjp of ref.ssd_reference). Per batch b and head h, with
// the (P x N) state S_t = exp(dt_t A_h) S_{t-1} + (dt_t x_t) outer B_t and
// y_t = S_t C_t + D_h x_t, it takes the cotangent dy of y (the final state is
// not an output of the differentiated scan, so no gradient enters it) and
// returns dx (B,S,H,P), ddt (B,S,H), dA (H), dB, dC (B,S,N), dD (H) and the
// initial state's gradient (B,H,P,N): dx, dB and dC in x's dtype, the rest
// fp32. The plain version, ref.py ssd_backward_reference, is the same
// algorithm in PyTorch.
//
// Chunks of T = 64 tokens, as in the forward. With cum_t the running sum of
// dt_u A over the chunk, S0 the chunk's start state, G the adjoint of its end
// state (0 for the last chunk) and M[t][u] = (C_t.B_u) dt_u e^{cum_t-cum_u}
// for u <= t:
//   dx_u  = sum_{t>=u} M[t][u] dy_t + D dy_u + w_u G B_u,   w_u = dt_u e^{cum_T-cum_u}
//   dC_t += sum_{u<=t} (dy_t.x_u) dt_u e^{cum_t-cum_u} B_u + e^{cum_t} S0^T dy_t
//   dB_u += sum_{t>=u} (dy_t.x_u) dt_u e^{cum_t-cum_u} C_t + w_u G^T x_u
//   G    <- e^{cum_T} G + sum_t e^{cum_t} dy_t C_t^T        (dinit after chunk 0)
//   dD   += sum_t dy_t.x_t
// dt enters directly (through dt_u) and through cum: the adjoint of cum_t is
// collected, its reverse running sum r_t taken over the chunk, and A r_t is
// added to ddt_t, sum_t dt_t r_t to dA. The exponent is taken only where
// u <= t (above the diagonal it is positive: inf times a zero mask would be
// NaN), and a ragged last chunk is padded with dt = 0 in shared memory.
//
// Design (a first kernel: right and simple; tensor cores, TMA and a split of
// a head over several blocks are later work):
// - One block of 256 threads per (b, h); the chunk axis is a loop inside the
//   block. All arithmetic is FMA on the CUDA cores, in fp32 (bf16 x, B, C and
//   dy are widened as they are staged into shared memory), except that the
//   fp32 kernel keeps the state, its adjoint and the sums that set ddt and dA
//   in fp64 (AccOf below).
// - A first sweep runs the forward recurrence over the chunks and writes each
//   chunk's start state into a workspace (B, H, n_chunks, P, N) (JAX's rule
//   saves only the inputs; so does the port's Function): 33.5 MB at zamba2's
//   train shape in bf16. The second sweep runs from the last chunk to the
//   first, with the state's adjoint G and the chunk's start state resident in
//   shared memory (P x N each: 2 x 16 KB at P = N = 64 in bf16), and applies
//   the formulas above.
// - Every product keeps a 4 x 4 tile of sums per thread in registers and reads
//   shared memory in float4 along the contracted axis where the layout allows
//   it: C.B^T and dy.x^T (rows t = g + 16i against rows u = lane16 + 16j, so
//   the eight lanes of a 16-byte load read eight distinct rows, which a pitch
//   of 4 mod 32 words keeps on distinct banks); the masked coefficients M
//   (stored transposed, for dx's sum over t) and W = (dy.x) dt e^{..}; then
//   dx, dB, dC and the state update. 16-token blocks wholly above the
//   diagonal are skipped, and so are the products with G in the last chunk,
//   where G is zero.
// - Sums across blocks are deterministic: dB and dC (summed over heads) and
//   dA and dD (over batch) go as per-(b, h) fp32 partials to a workspace, and
//   a second kernel adds them in a fixed order (no float atomics), so two calls
//   give the same bits.
// - x, B, C and dt are read through their batch and sequence strides (the
//   model's x, B and C are column slices of one conv buffer); dy and the
//   outputs are contiguous.
//
// What bounds it on the H100: at zamba2-1.2b's train shape (B = 4, S = 512,
// H = P = N = 64, bf16) the call must move 56.6 MB (16.9 us at 3.35 TB/s) and
// needs 6.9 GFLOP, 7.0 us on the bf16 tensor cores (the peak rate for its
// inputs' type), so the bytes bound it. This first kernel runs every product
// on the CUDA cores; the tensor cores are the way to that bound.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kT = 64;            // tokens per chunk
constexpr int kThr = 256;         // threads per block
constexpr int kTP = kT + 4;       // pitch of the T x T coefficient matrices
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may take on sm_90

// The precision of the state and of the sums that set ddt and dA. ddt_u
// gathers terms such as (dy_t.x_u)(C_t.B_u) e^{cum_t-cum_u}, x_u^T G B_u and
// e^{cum_t} C_t^T S0^T dy_t that are large beside it (hundreds at the test
// sweep's shapes, where ddt may be near 0), so the rounding of those terms, of
// cum and of the state and its adjoint to fp32 alone leaves errors at fp32's
// tolerance of 1e-4 (the plain backward in fp32 passes it). The fp32 kernel
// therefore keeps the state, its adjoint, their workspace, cum and the
// decays in fp64 and forms C.B^T, dy.x^T and every product with the state or
// its adjoint in fp64; only the masked coefficients of dx, dB and dC and those
// outputs are fp32. The bf16 kernel, held to bf16's tolerance, keeps all of
// it in fp32.
template <typename T>
using AccOf = typename std::conditional<std::is_same<T, float>::value, double, float>::type;

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  const float* init;  // nullptr: zero initial state
  const void* dy;     // (B,S,H,P) contiguous
  void* dx;           // (B,S,H,P) contiguous, x's dtype
  float* ddt;         // (B,S,H)
  float* dbc_part;    // [2][B][H][S][N]: per-head partial sums of dB, then dC
  float* ad_part;     // [B][H][2]: per-(b, h) partial sums of dA and dD
  float* dinit;       // (B,H,P,N)
  void* states;       // (B,H,n_chunks,Pp,N) in the state's type: each chunk's start state
  int S, H, P, Pp, N;
  long long sx_b, sx_s, sdt_b, sdt_s, sB_b, sB_s, sC_b, sC_s;
};

__host__ __device__ inline int pad4(int P) { return (P + 3) / 4 * 4; }

// Bytes of dynamic shared memory a block takes, with the state, its adjoint
// and the sums in elements of acc_bytes: those arrays first, then the fp32
// ones; every array's size is a multiple of 16 bytes.
__host__ __device__ inline size_t smem_bytes(int Pp, int N, int acc_bytes) {
  return size_t(acc_bytes) * (size_t(2) * Pp * (N + 4) + size_t(2) * 16 * kT + 7 * kT + 32) +
         4 * (size_t(2) * kT * (Pp + 4) + size_t(2) * kT * (N + 4) + size_t(2) * kT * kTP + kT);
}

template <typename Acc>
struct Smem {
  Acc *S, *G, *colQ, *colK, *rowQ, *cum, *ecum, *erev, *w, *inter, *xgb, *red;
  float *x, *dy, *B, *C, *MT, *W, *dt;
  int pP, pN;

  __device__ Smem(void* base, int Pp, int N) : pP(Pp + 4), pN(N + 4) {
    S = static_cast<Acc*>(base);
    G = S + Pp * pN;
    colQ = G + Pp * pN;
    colK = colQ + 16 * kT;
    rowQ = colK + 16 * kT;
    cum = rowQ + kT;
    ecum = cum + kT;
    erev = ecum + kT;
    w = erev + kT;
    inter = w + kT;
    xgb = inter + kT;
    red = xgb + kT;
    x = reinterpret_cast<float*>(red + 32);
    dy = x + kT * pP;
    B = dy + kT * pP;
    C = B + kT * pN;
    MT = C + kT * pN;
    W = MT + kT * kTP;
    dt = W + kT * kTP;
  }
};

__device__ __forceinline__ double acc_exp(double v) { return exp(v); }
__device__ __forceinline__ float acc_exp(float v) { return expf(v); }

// Four consecutive elements (16-byte aligned) as V.
template <typename V>
__device__ __forceinline__ void ld4(const float* p, V (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
template <typename V>
__device__ __forceinline__ void ld4(const double* p, V (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

template <typename V>
__device__ __forceinline__ void st4(float* p, const V (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* p, const double (&v)[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// acc[j] += a * b[j]
template <typename V>
__device__ __forceinline__ void fma4(V (&acc)[4], V a, const V (&b)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = fma(a, b[j], acc[j]);
}

// Sum over the 16 lanes of a half-warp (lanes 0-15 and 16-31 sum apart).
template <typename V>
__device__ __forceinline__ V sum16(V v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename V>
__device__ __forceinline__ V sum32(V v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [0, kT) x columns [0, cols_p) of a token-major operand into shared
// memory as fp32; rows at or past `valid` and columns at or past `cols` are 0.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* __restrict__ src,
                                      long long stride, int valid, int cols, int cols_p) {
  for (int e = threadIdx.x; e < kT * cols_p; e += kThr) {
    const int t = e / cols_p, c = e % cols_p;
    dst[t * pitch + c] = t < valid && c < cols ? to_float<T>(src[t * stride + c]) : 0.f;
  }
}

// acc[i][j] += sum_k A[ra[i]][k] Bm[rb[j]][k] over k < K (a multiple of 4),
// in Acc; with kTri only where j <= i.
template <bool kTri, typename Acc, typename EA, typename EB>
__device__ __forceinline__ void nt_tile(Acc (&acc)[4][4], const EA* A, int pa,
                                        const int (&ra)[4], const EB* Bm, int pb,
                                        const int (&rb)[4], int K) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    Acc a[4][4], b[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ld4(A + ra[i] * pa + k, a[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) ld4(Bm + rb[j] * pb + k, b[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kTri && j > i) continue;
        Acc v = acc[i][j];
#pragma unroll
        for (int q = 0; q < 4; ++q) v = fma(a[i][q], b[j][q], v);
        acc[i][j] = v;
      }
  }
}

// St[p][n] <- decay St[p][n] + sum_t coef_t V[t][p] U[t][n], p < Pp, n < N:
// the state update of the forward sweep (V = x, U = B, coef = w) and the
// adjoint's (V = dy, U = C, coef = e^{cum}).
template <typename Acc>
__device__ __forceinline__ void state_update(Acc* St, int pN, const float* V, int pP,
                                             const float* U, const Acc* coef, Acc decay,
                                             int Pp, int N) {
  const int g = threadIdx.x / 16, xl = threadIdx.x % 16;
  for (int rb = 0; rb < Pp; rb += 64)
    for (int c4 = xl; c4 < N / 4; c4 += 16) {
      int p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = min(rb + g + 16 * i, Pp - 1);
      Acc acc[4][4] = {};
#pragma unroll 4
      for (int t = 0; t < kT; ++t) {
        Acc u[4];
        ld4(U + t * pN + 4 * c4, u);
        const Acc ct = coef[t];
#pragma unroll
        for (int i = 0; i < 4; ++i) fma4(acc[i], Acc(V[t * pP + p[i]]) * ct, u);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (rb + g + 16 * i >= Pp) continue;
        Acc* s = St + p[i] * pN + 4 * c4;
        Acc o[4];
        ld4(s, o);
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = fma(decay, o[j], acc[i][j]);
        st4(s, o);
      }
    }
}

// cum_t (the inclusive running sum of dt_u A over the chunk), e^{cum_t},
// e^{cum_T - cum_t} and w_t = dt_t e^{cum_T - cum_t}, in Acc, by warp 0 (two
// tokens a lane); a warp scan, as in the forward kernel.
template <typename Acc>
__device__ __forceinline__ void chunk_decays(Smem<Acc>& s, float Ah) {
  const int lane = threadIdx.x % 32;
  const Acc d0 = s.dt[2 * lane], d1 = s.dt[2 * lane + 1];
  const Acc a0 = d0 * Acc(Ah), a1 = d1 * Acc(Ah);
  Acc incl = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Acc v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  Acc ex = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) ex = Acc(0);
  const Acc c[2] = {ex + a0, ex + a0 + a1}, d[2] = {d0, d1};
  const Acc total = __shfl_sync(0xffffffffu, c[1], 31);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int t = 2 * lane + q;
    const Acc r = acc_exp(total - c[q]);
    s.cum[t] = c[q];
    s.ecum[t] = acc_exp(c[q]);
    s.erev[t] = r;
    s.w[t] = r * d[q];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThr, 1) ssd_bwd_kernel(BwdArgs a) {
  using Acc = AccOf<T>;
  extern __shared__ float4 smem_raw[];
  const int Pp = a.Pp, N = a.N, P = a.P, H = a.H;
  Smem<Acc> s(smem_raw, Pp, N);
  const int h = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = tid / 16, xl = tid % 16;
  const float Ah = a.A[h], Dh = a.D[h];
  const int nc = (a.S + kT - 1) / kT;
  const size_t bh = size_t(bi) * H + h;
  const T* xg = static_cast<const T*>(a.x) + bi * a.sx_b + size_t(h) * P;
  const T* dyg = static_cast<const T*>(a.dy) + (size_t(bi) * a.S * H + h) * P;
  const T* Bg = static_cast<const T*>(a.B) + bi * a.sB_b;
  const T* Cg = static_cast<const T*>(a.C) + bi * a.sC_b;
  const float* dtg = a.dt + bi * a.sdt_b + h;
  // written and read back by this block (plain loads: not through the read-only cache)
  Acc* states = static_cast<Acc*>(a.states) + bh * nc * Pp * N;

  auto stage_dt = [&](int t0, int valid) {
    for (int t = tid; t < kT; t += kThr) s.dt[t] = t < valid ? dtg[(t0 + t) * a.sdt_s] : 0.f;
  };

  // ---- sweep 1: each chunk's start state into the workspace
  for (int e = tid; e < Pp * N; e += kThr) {
    const int p = e / N, n = e % N;
    s.S[p * s.pN + n] = a.init != nullptr && p < P ? Acc(a.init[(bh * P + p) * N + n]) : Acc(0);
    s.G[p * s.pN + n] = Acc(0);
  }
  for (int c = 0; c < nc; ++c) {
    __syncthreads();                          // S holds chunk c's start state
    for (int e = tid; e < Pp * N / 4; e += kThr) {
      const int p = e / (N / 4), n = 4 * (e % (N / 4));
      Acc v[4];
      ld4(s.S + p * s.pN + n, v);
      st4(states + (size_t(c) * Pp + p) * N + n, v);
    }
    if (c == nc - 1) break;
    const int t0 = c * kT, valid = min(kT, a.S - t0);
    stage<T>(s.x, s.pP, xg + t0 * a.sx_s, a.sx_s, valid, P, Pp);
    stage<T>(s.B, s.pN, Bg + t0 * a.sB_s, a.sB_s, valid, N, N);
    stage_dt(t0, valid);
    __syncthreads();
    if (warp == 0) chunk_decays(s, Ah);
    __syncthreads();
    state_update(s.S, s.pN, s.x, s.pP, s.B, s.w, s.ecum[kT - 1], Pp, N);
  }

  // ---- sweep 2: from the last chunk to the first
  Acc dd = 0, da = 0;                         // this thread's shares of dD and dA
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kT, valid = min(kT, a.S - t0);
    const bool has_g = c < nc - 1;            // G is zero after the last chunk
    __syncthreads();                          // the previous chunk's reads are done
    stage<T>(s.x, s.pP, xg + t0 * a.sx_s, a.sx_s, valid, P, Pp);
    stage<T>(s.dy, s.pP, dyg + size_t(t0) * H * P, size_t(H) * P, valid, P, Pp);
    stage<T>(s.B, s.pN, Bg + t0 * a.sB_s, a.sB_s, valid, N, N);
    stage<T>(s.C, s.pN, Cg + t0 * a.sC_s, a.sC_s, valid, N, N);
    stage_dt(t0, valid);
    for (int e = tid; e < Pp * N / 4; e += kThr) {
      const int p = e / (N / 4), n = 4 * (e % (N / 4));
      Acc v[4];
      ld4(states + (size_t(c) * Pp + p) * N + n, v);
      st4(s.S + p * s.pN + n, v);
    }
    __syncthreads();
    if (warp == 0) chunk_decays(s, Ah);
    __syncthreads();

    // (1) C.B^T and dy.x^T on the lower triangle; the coefficients
    // M^T[u][t] = (C_t.B_u) dt_u e^{cum_t-cum_u} and W[t][u] = (dy_t.x_u) dt_u
    // e^{..}; with K = (dy_t.x_u)(C_t.B_u) e^{..} and Q = K dt_u, the row sums
    // of Q (into d cum_t), and per thread row group the column sums of Q
    // (out of d cum_u) and of K (into ddt_u).
    {
      int rt[4], ru[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rt[i] = g + 16 * i;
        ru[i] = xl + 16 * i;
      }
      Acc cb[4][4] = {}, dxy[4][4] = {};
      nt_tile<true>(cb, s.C, s.pN, rt, s.B, s.pN, ru, N);
      nt_tile<true>(dxy, s.dy, s.pP, rt, s.x, s.pP, ru, Pp);
      Acc rq[4] = {}, cq[4] = {}, ck[4] = {};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = rt[i], u = ru[j];
          float m = 0.f, wv = 0.f;
          if (j <= i && u <= t) {
            const Acc e = acc_exp(s.cum[t] - s.cum[u]), du = s.dt[u];
            const Acc k = dxy[i][j] * cb[i][j] * e, q = k * du;
            m = float(cb[i][j] * du * e);
            wv = float(dxy[i][j] * du * e);
            rq[i] += q;
            cq[j] += q;
            ck[j] += k;
          }
          s.MT[u * kTP + t] = m;
          s.W[t * kTP + u] = wv;
        }
      if (g == xl) {
#pragma unroll
        for (int i = 0; i < 4; ++i) dd += dxy[i][i];   // dy_t.x_t
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Acc r = sum16(rq[i]);
        if (xl == 0) s.rowQ[rt[i]] = r;
        s.colQ[g * kT + ru[i]] = cq[i];
        s.colK[g * kT + ru[i]] = ck[i];
      }
    }
    __syncthreads();

    // (2a) dx_u = sum_{t>=u} M[t][u] dy_t + D dy_u + w_u (G B_u); and
    // x_u.(G B_u). Rows u = g + 16i, columns p = lane16 + 16j.
    {
      int ru[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ru[i] = g + 16 * i;
      Acc xgp[4] = {};
      T* dxg = static_cast<T*>(a.dx) + (size_t(bi) * a.S + t0) * H * P + size_t(h) * P;
      for (int cb0 = 0; cb0 < Pp; cb0 += 64) {
        int pc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) pc[j] = min(cb0 + xl + 16 * j, Pp - 1);
        Acc gb[4][4] = {};
        float acc[4][4] = {};
        if (has_g) nt_tile<false>(gb, s.B, s.pN, ru, s.G, s.pN, pc, N);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll 2
          for (int t = 16 * k; t < 16 * k + 16; t += 4) {
            float dv[4][4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int j = 0; j < 4; ++j) dv[q][j] = s.dy[(t + q) * s.pP + pc[j]];
#pragma unroll
            for (int i = 0; i <= k; ++i) {
              float m[4];
              ld4(s.MT + ru[i] * kTP + t, m);
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] = fmaf(m[3], dv[3][j], fmaf(m[2], dv[2][j],
                            fmaf(m[1], dv[1][j], fmaf(m[0], dv[0][j], acc[i][j]))));
            }
          }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int u = ru[i];
          const Acc wu = s.w[u];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = cb0 + xl + 16 * j;
            if (p >= Pp) continue;
            xgp[i] = fma(Acc(s.x[u * s.pP + p]), gb[i][j], xgp[i]);
            if (u < valid && p < P)
              dxg[size_t(u) * H * P + p] = from_float<T>(
                  float(Acc(acc[i][j] + Dh * s.dy[u * s.pP + p]) + wu * gb[i][j]));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Acc v = sum16(xgp[i]);
        if (xl == 0) s.xgb[ru[i]] = v;
      }
    }

    // (2b) dB_u (this head's share) = sum_{t>=u} W[t][u] C_t + w_u G^T x_u.
    // Rows u = g + 16i, columns n = 4 (lane16 + 16j) .. + 3.
    {
      float* out = a.dbc_part + (bh * a.S + t0) * N;
      for (int c4 = xl; c4 < N / 4; c4 += 16) {
        float acc[4][4] = {};
        Acc xgv[4][4] = {};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll 4
          for (int t = 16 * k; t < 16 * k + 16; ++t) {
            float cv[4];
            ld4(s.C + t * s.pN + 4 * c4, cv);
#pragma unroll
            for (int i = 0; i <= k; ++i) fma4(acc[i], s.W[t * kTP + g + 16 * i], cv);
          }
        if (has_g) {
#pragma unroll 2
          for (int p = 0; p < Pp; p += 4) {
            Acc gv[4][4];
#pragma unroll
            for (int q = 0; q < 4; ++q) ld4(s.G + (p + q) * s.pN + 4 * c4, gv[q]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              Acc xv[4];
              ld4(s.x + (g + 16 * i) * s.pP + p, xv);
#pragma unroll
              for (int q = 0; q < 4; ++q) fma4(xgv[i], xv[q], gv[q]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int u = g + 16 * i;
          if (u >= valid) continue;
          const Acc wu = s.w[u];
          float o[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = float(fma(wu, xgv[i][j], Acc(acc[i][j])));
          st4(out + size_t(u) * N + 4 * c4, o);
        }
      }
    }

    // (2c) dC_t (this head's share) = sum_{u<=t} W[t][u] B_u + e^{cum_t} S0^T dy_t,
    // and C_t . e^{cum_t} S0^T dy_t (into d cum_t). Rows t = g + 16i.
    {
      float* out = a.dbc_part + (size_t(gridDim.y) * H + bh) * a.S * N + size_t(t0) * N;
      const bool has_s0 = c > 0 || a.init != nullptr;
      Acc itp[4] = {};
      for (int cb = 0; cb < N / 4; cb += 16) {
        const int c4 = cb + xl;
        const bool on = c4 < N / 4;
        const int cc = on ? c4 : 0;
        float acc[4][4] = {};
        Acc ev[4][4] = {};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll 2
          for (int u = 16 * k; u < 16 * k + 16; u += 4) {
            float bv[4][4];
#pragma unroll
            for (int q = 0; q < 4; ++q) ld4(s.B + (u + q) * s.pN + 4 * cc, bv[q]);
#pragma unroll
            for (int i = k; i < 4; ++i) {
              float wv[4];
              ld4(s.W + (g + 16 * i) * kTP + u, wv);
#pragma unroll
              for (int q = 0; q < 4; ++q) fma4(acc[i], wv[q], bv[q]);
            }
          }
        if (has_s0) {
#pragma unroll 2
          for (int p = 0; p < Pp; p += 4) {
            Acc sv[4][4];
#pragma unroll
            for (int q = 0; q < 4; ++q) ld4(s.S + (p + q) * s.pN + 4 * cc, sv[q]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              Acc dv[4];
              ld4(s.dy + (g + 16 * i) * s.pP + p, dv);
#pragma unroll
              for (int q = 0; q < 4; ++q) fma4(ev[i], dv[q], sv[q]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = g + 16 * i;
          const Acc et = s.ecum[t];
          if (!on) continue;
          Acc cv[4];
          ld4(s.C + t * s.pN + 4 * cc, cv);
          float o[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const Acc e = et * ev[i][j];
            itp[i] = fma(cv[j], e, itp[i]);
            o[j] = float(Acc(acc[i][j]) + e);
          }
          if (t < valid) st4(out + size_t(t) * N + 4 * cc, o);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Acc v = sum16(itp[i]);
        if (xl == 0) s.inter[g + 16 * i] = v;
      }
    }

    // (2d) <G, S0>, per warp (into d cum_T).
    {
      Acc gs = 0;
      if (has_g)
        for (int e = tid; e < Pp * N / 4; e += kThr) {
          const int p = e / (N / 4), n = 4 * (e % (N / 4));
          Acc gv[4], sv[4];
          ld4(s.G + p * s.pN + n, gv);
          ld4(s.S + p * s.pN + n, sv);
#pragma unroll
          for (int j = 0; j < 4; ++j) gs = fma(gv[j], sv[j], gs);
        }
      gs = sum32(gs);
      if (lane == 0) s.red[warp] = gs;
    }
    __syncthreads();

    // (3) G <- e^{cum_T} G + sum_t e^{cum_t} dy_t C_t^T (every read of the old
    // G is done); then, by warp 0, d cum, its reverse running sum r, ddt and dA.
    state_update(s.G, s.pN, s.dy, s.pP, s.C, s.ecum, s.ecum[kT - 1], Pp, N);
    if (warp == 0) {
      Acc gs = 0;
      for (int k = 0; k < kThr / 32; ++k) gs += s.red[k];
      Acc dc[2], kk[2], wx = 0;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int t = 2 * lane + q;
        Acc cq = 0, ck = 0;
        for (int k = 0; k < 16; ++k) {
          cq += s.colQ[k * kT + t];
          ck += s.colK[k * kT + t];
        }
        const Acc wxt = s.w[t] * s.xgb[t];
        dc[q] = s.rowQ[t] - cq + s.inter[t] - wxt;
        kk[q] = ck;
        wx += wxt;
      }
      wx = sum32(wx);
      if (lane == 31) dc[1] += s.ecum[kT - 1] * gs + wx;   // d cum_T: <G, S_end>
      Acc suf = dc[0] + dc[1];                             // sum over lanes >= this one
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const Acc v = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane + off < 32) suf += v;
      }
      Acc after = __shfl_down_sync(0xffffffffu, suf, 1);
      if (lane == 31) after = Acc(0);
      const Acc r1 = dc[1] + after, r0 = dc[0] + r1;
      const Acc r[2] = {r0, r1};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int t = 2 * lane + q;
        if (t < valid)
          a.ddt[(size_t(bi) * a.S + t0 + t) * H + h] =
              float(kk[q] + s.erev[t] * s.xgb[t] + Acc(Ah) * r[q]);
        da = fma(Acc(s.dt[t]), r[q], da);
      }
    }
  }

  // G is now the initial state's gradient.
  __syncthreads();
  for (int e = tid; e < P * N; e += kThr) {
    const int p = e / N, n = e % N;
    a.dinit[(bh * P + p) * N + n] = float(s.G[p * s.pN + n]);
  }
  dd = sum32(dd);
  if (lane == 0) s.red[16 + warp] = dd;
  if (warp == 0) da = sum32(da);
  __syncthreads();
  if (tid == 0) {
    Acc d = 0;
    for (int k = 0; k < kThr / 32; ++k) d += s.red[16 + k];
    a.ad_part[bh * 2] = float(da);
    a.ad_part[bh * 2 + 1] = float(d);
  }
}

// dB and dC: the heads' partials of row (b, s) added in order; one more block
// adds dA and dD over the batch.
template <typename T>
__global__ void ssd_bwd_sum_kernel(const float* __restrict__ dbc_part,
                                   const float* __restrict__ ad_part, void* dB, void* dC,
                                   float* dA, float* dD, int batch, int S, int H, int N) {
  const int row = blockIdx.x;
  if (row == batch * S) {
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float sa = 0.f, sd = 0.f;
      for (int b = 0; b < batch; ++b) {
        sa += ad_part[(size_t(b) * H + h) * 2];
        sd += ad_part[(size_t(b) * H + h) * 2 + 1];
      }
      dA[h] = sa;
      dD[h] = sd;
    }
    return;
  }
  const int b = row / S, si = row % S;
  const size_t half = size_t(batch) * H * S * N;
  for (int e = threadIdx.x; e < 2 * N; e += blockDim.x) {
    const int which = e / N, n = e % N;
    const float* part = dbc_part + which * half + (size_t(b) * H * S + si) * N + n;
    float acc = 0.f;
    for (int hh = 0; hh < H; ++hh) acc += part[size_t(hh) * S * N];
    static_cast<T*>(which ? dC : dB)[size_t(row) * N + n] = from_float<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const BwdArgs& a, float* dA, float* dD, void* dB, void* dC, int batch,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(a.Pp, a.N, sizeof(AccOf<T>));
  if (smem > size_t(kMaxSmem)) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  ssd_bwd_kernel<T><<<dim3(a.H, batch), kThr, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_sum_kernel<T><<<batch * a.S + 1, 128, 0, stream>>>(a.dbc_part, a.ad_part, dB, dC, dA,
                                                              dD, batch, a.S, a.H, a.N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x (B,S,H,P), B/C (B,S,N) and dy (B,S,H,P) of one dtype (repro::DType); x,
// B, C with a contiguous last axis (x's (H,P) contiguous) and the given batch
// and sequence strides in elements, dy contiguous. dt (B,S,H) fp32 with the
// given strides (H contiguous); A, D (H,), init (B,H,P,N) or null, fp32
// contiguous. Writes dx (B,S,H,P) and dB, dC (B,S,N) in that dtype, ddt
// (B,S,H), dA, dD (H,) and dinit (B,H,P,N) in fp32, all contiguous.
// Workspaces (contiguous): states (B,H,ceil(S/64),pad4(P),N), fp64 for fp32
// inputs and fp32 for bf16 ones; dbc_part (2,B,H,S,N) and ad_part (B,H,2),
// fp32. N in {16, 32, 64, 128}; B <= 65535; the block's shared memory
// (smem_bytes) at most 227 KB.
// Launches on `stream` of `device` and returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int repro_ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* B,
                                  const void* C, const void* D, const void* init, const void* dy,
                                  void* dx, void* ddt, void* dA, void* dB, void* dC, void* dD,
                                  void* dinit, void* states, void* dbc_part, void* ad_part,
                                  int batch, int S, int H, int P, int N, long long sx_b,
                                  long long sx_s, long long sdt_b, long long sdt_s,
                                  long long sB_b, long long sB_s, long long sC_b, long long sC_s,
                                  int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch <= 0 || S <= 0 || H <= 0 || P <= 0 || batch > 65535 ||
      (N != 16 && N != 32 && N != 64 && N != 128))
    return cudaErrorInvalidValue;
  const repro::BwdArgs a{x,
                         static_cast<const float*>(dt),
                         static_cast<const float*>(A),
                         B,
                         C,
                         static_cast<const float*>(D),
                         static_cast<const float*>(init),
                         dy,
                         dx,
                         static_cast<float*>(ddt),
                         static_cast<float*>(dbc_part),
                         static_cast<float*>(ad_part),
                         static_cast<float*>(dinit),
                         states,
                         S,
                         H,
                         P,
                         repro::pad4(P),
                         N,
                         sx_b,
                         sx_s,
                         sdt_b,
                         sdt_s,
                         sB_b,
                         sB_s,
                         sC_b,
                         sC_s};
  const auto s = static_cast<cudaStream_t>(stream);
  auto* fA = static_cast<float*>(dA);
  auto* fD = static_cast<float*>(dD);
  if (dtype == repro::kFloat32) return repro::launch<float>(a, fA, fD, dB, dC, batch, s);
  if (dtype == repro::kBFloat16) return repro::launch<__nv_bfloat16>(a, fA, fD, dB, dC, batch, s);
  return cudaErrorInvalidValue;
}
