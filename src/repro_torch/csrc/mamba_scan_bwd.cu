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
// Design of the chunked backward (variants 1 and 2), the chunk-parallel
// decomposition of Mamba2's own backward. With S0_c the start state of chunk
// c and G_c the adjoint of its end state:
//   S0_{c+1} = e^{cum_T} S0_c + sum_u w_u x_u B_u^T,
//   G_{c-1}  = e^{cum_T} G_c + sum_t e^{cum_t} dy_t C_t^T     (G_{nc-1} = 0),
// so only these two P x N recurrences run across chunks; everything else is
// per chunk, given S0_c and G_c. Three launches:
// - The states kernel: per (b, h, slice of P rows, direction) a loop over the
//   chunks, forward for S0, backward for G, each chunk's update a product of
//   the chunk's (x w)^T B or (dy e^cum)^T C onto the decayed state. It writes
//   every S0_c and G_c that the chunk kernel reads (not the zero ones: S0_0
//   without an initial state, G_{nc-1}) to a workspace, and dinit = G_{-1}.
//   A slice of P, not the whole head, is a block's: no head is too large.
// - The chunk kernel: per (b, chunk, group of heads), looping over the
//   group's heads, everything else of the formulas above: dx, ddt, the
//   per-(b, chunk, h) partials of dA and dD, and dB, dC summed over the
//   group's heads on chip (in registers), one partial per group. B and C
//   are every head's, so the W products sum over heads before they are
//   taken: sum_h W_h B and sum_h W_h^T C are one product each per block.
// - A reduce kernel adds the groups' dB / dC partials and the dA / dD
//   partials in a fixed order (no float atomics: two calls, same bits).
// bf16 x/B/C/dy that the tensor cores take (P and the strides of x, B and C
// multiples of 8, x, B, C and dy 16-byte aligned: ops.bwd_takes_mma) run the
// tensor-core kernels (variant 2); fp32, and bf16 operands they do not
// take, the CUDA-core kernels of the same decomposition (variant 1). Variant
// 0 is the two-sweep kernel above the chunked ones (two sweeps per (b, h)), kept
// for comparison.
//
// The tensor-core kernels (bf16):
// - Operands are staged by cp.async in 16-byte pieces into XOR-swizzled
//   shared memory and read by ldmatrix; every product is mma.sync m16n8k16
//   with fp32 sums: C.B^T (once per (b, chunk), kept in registers for the
//   group's heads), dy.x^T, dx = M^T dy, dC = W B, dB = W^T C, and the
//   products with the state and its adjoint, G B, G^T x, S0^T dy and the
//   states kernel's updates. The coefficients M and W are built in fp32 and
//   taken as two bf16 operands (their rounding and the remainder), as the
//   forward does for M; so are S0 and G, which the states kernel writes as
//   such hi / lo planes (an fp32 state rounded once to bf16 misses the bf16
//   tolerance in the forward, csrc/mamba_scan.cu). The states kernel's
//   (x w) and (dy e^cum) are split the same way.
// - Exponentials are ex2 (MUFU) of cum in base-2 units; each warp scans the
//   chunk's dt itself (no warp waits while one scans), and the d cum / ddt
//   / dA tail of a head is run by every warp, each storing its own tokens.
// - Chunk kernel: 4 warps, warp w owns tokens 16w .. 16w + 15 as rows of
//   C.B^T, dy.x^T, dC (and of dx, dB as the transposed side); 64-wide tiles
//   of P are looped over (one tile at P <= 64). The group's dB and dC stay
//   in registers across its heads (254 registers at N = 64, no spills), its
//   sum of W in shared memory (fp32, each thread its own elements). Of the
//   column sums of Q and K only K's are taken: those of Q = K dt_u are
//   dt_u times them.
// - The states workspace is an image of the chunk kernel's shared memory:
//   per (b, h, chunk) and 64-row tile of P, S0's (or G's) rounding plane and
//   remainder plane, each in the swizzled layout, rows past P zero. So one
//   thread moves a tile with one cp.async.bulk (16 KB at N = 64) reported to
//   an mbarrier, instead of 32 cp.async a thread. The next head's S0 is
//   issued as soon as this head's last read of S0 is done (<G, S0> is taken
//   beside S0^T dy), its x, dy and G once the products with G are done,
//   while the d cum tail runs.
// - The launch plan (ops.bwd_plan) takes as many heads per group as fill
//   one wave of blocks: at zamba2's train shape (B = 4, S = 512, H = P = N =
//   64) 8 heads a group, 256 chunk blocks of 128 threads, 2 an SM (100 KB of
//   shared memory each) on 132 SMs; 512 states blocks. Workspaces there:
//   S0 and G 58.7 MB written (hi / lo bf16, the zero ones not written), the
//   groups' dB / dC partials 8.4 MB, dA / dD partials 16 KB: 134.3 MB
//   written and read back against the two-sweep kernel's 201.3 MB, whose (2, B,
//   H, S, N) fp32 dB / dC partials (67.1 MB) are gone.
// - Measured on an H100 (chip_variants.py, chip_smoke.py): 8 heads a group
//   beat 2, 4, 16 and 32; 64-row P slices in the states kernel beat 32 and
//   16; S0 and G rounded once to bf16 (half the workspace) miss the dx
//   tolerance, so the remainder plane stays. Tried and not kept: 8 warps a
//   block (two a row tile, 128 registers, spills), the triangle's tiles
//   spread evenly over the warps, the products as wgmma (255 registers,
//   spills), and the next head's x, dy, S0 and G requested earlier (a
//   second dy buffer, S0 and G trading buffers); each was slower or no
//   faster. Taking the W products out of the head loop did not move the
//   time either: the chunk kernel is bound by the latency of each head's
//   chains at 8 warps an SM (2 blocks of 254 registers and 100 KB), with
//   no unit saturated; the states kernel by its bytes (about 100 MB).
// The CUDA-core kernels (fp32 precision path, and bf16 layouts the tensor
// cores do not take) keep the state, its adjoint and the sums on ddt's and
// dA's path in AccOf<T> (fp64 for fp32 inputs), read the states and x / dy
// through L1 where they are not staged, and hold a slice of P, never a whole
// head, so every P >= 1 runs.
//
// Design of the two-sweep kernel (variant 0; a first kernel, right and simple):
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
// inputs' type), so the bytes bound it. The two-sweep kernel runs every product
// on the CUDA cores in two waves of one block per (b, h); the chunked one
// runs them on the tensor cores in one wave, and its S0 / G workspace
// (written once, read once) is the traffic it adds beyond the bound.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

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

// ---------------------------------------------------------------------------
// The chunked backward (variants 1 and 2; the design note at the top).

constexpr int kCW = 4;    // warps per block of the tensor-core kernels
constexpr int kSP = 64;   // rows of P per block of the tensor-core states kernel
constexpr int kPW = 64;   // columns of P per tile of the tensor-core chunk kernel
constexpr int kFSP = 32;  // rows of P per block of the CUDA-core states kernel
constexpr int kFPT = 32;  // columns of P per staged tile of the CUDA-core chunk kernel
// The tensor-core kernels take S0 and G as their bf16 rounding and the
// remainder (false: the rounding alone, half the workspace's bytes)
constexpr bool kStateLo = true;

struct ChunkArgs {
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
  float* dinit;       // (B,H,P,N)
  // S0 then G, one unit per (b, h, chunk): tensor cores [2][P][N] bf16 (the
  // state's bf16 rounding, then the remainder), CUDA cores [P][N] in AccOf<T>
  void* states;
  float* dbc_part;    // [2][groups][B][S][N]: dB, then dC, summed over a group's heads
  float* ad_part;     // [B][nc][H][2]: dA, dD of each (b, chunk, h)
  int batch, S, H, P, N, nc, hg, groups;
  long long sx_b, sx_s, sdt_b, sdt_s, sB_b, sB_s, sC_b, sC_s;
};

// Elements of one (b, h, chunk) unit of the states workspace, and the offset
// of the G part (in the element type: bf16 for the tensor-core kernels,
// AccOf<T> for the CUDA-core ones). The tensor-core unit is P in whole tiles
// of kPW rows, each tile its bf16 rounding then its remainder, each plane
// laid out as the chunk kernel's shared memory holds it (swz), rows past P
// zero: one bulk copy a tile.
__host__ __device__ inline size_t state_unit(const ChunkArgs& a, bool mma) {
  return mma ? size_t((a.P + kPW - 1) / kPW) * kPW * a.N * 2 : size_t(a.P) * a.N;
}
__host__ __device__ inline size_t g_part(const ChunkArgs& a, bool mma) {
  return size_t(a.batch) * a.H * a.nc * state_unit(a, mma);
}

// (a, b) as a bf16x2 operand `hi` and the remainder (a, b) - hi as `lo`:
// hi + lo holds about 16 bits of each value.
__device__ __forceinline__ void hi_lo(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// The low (element 0) and high halves of a bf16x2 register as fp32.
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// This warp's scan of a chunk's dt in base-2 units (cum_t log2 e), two tokens
// a lane: c0, c1 at t = 2 lane, 2 lane + 1; returns cum_T on every lane.
__device__ __forceinline__ float warp_cum2(const float* dt, float A2, int lane, float& c0,
                                           float& c1) {
  const float a0 = dt[2 * lane] * A2, a1 = dt[2 * lane + 1] * A2;
  float incl = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float ex = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) ex = 0.f;
  c0 = ex + a0;
  c1 = c0 + a1;
  return __shfl_sync(0xffffffffu, c1, 31);
}

// ---- The tensor-core states kernel: per (slice of kSP rows of P padded to
// whole kPW-row tiles, and direction; h; b). Direction 0 carries S0 forward over the chunks with the
// updates (x w)^T B; direction 1 carries G backward with (dy e^cum)^T C. The
// state lives in registers (fp32); warp w holds rows 16 (w % RG) .. + 15 and
// 16-column tiles ng, ng + NG, ... of N.
template <int N>
struct StatesSmem {
  static constexpr int kOP = N + 8;  // pitch of the staged output rows (spreads the banks)
  static constexpr int bytes() {
    return 2 * (2 * kT * kSP + 2 * kT * N + 2 * kSP * kOP) + 4 * (2 * kT + kCW * kT);
  }
};

template <int N>
__global__ void __launch_bounds__(32 * kCW) ssd_bwd_states_mma(ChunkArgs a) {
  using bf16 = __nv_bfloat16;
  using L = StatesSmem<N>;
  constexpr int CHN = N / 8, CHP = kSP / 8;
  constexpr int RG = kSP / 16, NG = kCW / RG;
  constexpr int NDN = (N / 16 + NG - 1) / NG;
  static_assert(kCW % RG == 0, "state rows");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Vs = reinterpret_cast<bf16*>(smem);             // [2][kT][kSP], swizzled
  bf16* Us = Vs + 2 * kT * kSP;                         // [2][kT][N], swizzled
  bf16* Oh = Us + 2 * kT * N;                           // [kSP][kOP]: a state's bf16 rounding
  bf16* Ol = Oh + kSP * L::kOP;                         //   and its remainder
  float* dts = reinterpret_cast<float*>(Ol + kSP * L::kOP);   // [2][kT]
  float* coefw = dts + 2 * kT;                          // [kCW][kT]: each warp's coefficients

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int dir = blockIdx.x & 1, p0 = (blockIdx.x >> 1) * kSP, h = blockIdx.y, bi = blockIdx.z;
  const int P = a.P, H = a.H, nc = a.nc;
  const int rg = warp % RG, ng = warp / RG;
  const bf16 *Vg, *Ug;
  long long sv, su;
  if (dir == 0) {
    Vg = static_cast<const bf16*>(a.x) + bi * a.sx_b + size_t(h) * P;
    sv = a.sx_s;
    Ug = static_cast<const bf16*>(a.B) + bi * a.sB_b;
    su = a.sB_s;
  } else {
    Vg = static_cast<const bf16*>(a.dy) + size_t(bi) * a.S * H * P + size_t(h) * P;
    sv = (long long)H * P;
    Ug = static_cast<const bf16*>(a.C) + bi * a.sC_b;
    su = a.sC_s;
  }
  const float* dtg = a.dt + bi * a.sdt_b + h;
  bf16* ws = static_cast<bf16*>(a.states) + (dir ? g_part(a, true) : 0) +
             (size_t(bi) * H + h) * nc * state_unit(a, true);

  // Step i's chunk (forward or backward order) into ring slot i % 2; rows
  // past the sequence and columns past P are zero-filled.
  auto load = [&](int i) {
    const int c = dir ? nc - 1 - i : i, t0 = c * kT, valid = min(kT, a.S - t0), st = i & 1;
    for (int e = tid; e < kT * CHN; e += 32 * kCW) {
      const int t = e / CHN, ch = e % CHN;
      const bool ok = t < valid;
      cp_async16(Us + st * kT * N + swz<CHN>(t, ch), ok ? Ug + (t0 + t) * su + 8 * ch : Ug, ok);
    }
    for (int e = tid; e < kT * CHP; e += 32 * kCW) {
      const int t = e / CHP, ch = e % CHP;
      const bool ok = t < valid && p0 + 8 * ch < P;
      cp_async16(Vs + st * kT * kSP + swz<CHP>(t, ch), ok ? Vg + (t0 + t) * sv + p0 + 8 * ch : Vg,
                 ok);
    }
    for (int t = tid; t < kT; t += 32 * kCW) {
      const bool ok = t < valid;
      cp_async4(dts + st * kT + t, ok ? dtg + (t0 + t) * a.sdt_s : dtg, ok);
    }
  };

  float acc[NDN][2][4];
#pragma unroll
  for (int i = 0; i < NDN; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = p0 + 16 * rg + g + 8 * r, n = 16 * (ng + i * NG) + 8 * hh + 2 * qd;
        float2 v = make_float2(0.f, 0.f);
        if (dir == 0 && a.init != nullptr && p < P && n < N)
          v = *reinterpret_cast<const float2*>(a.init + ((size_t(bi) * H + h) * P + p) * N + n);
        acc[i][hh][2 * r] = v.x;
        acc[i][hh][2 * r + 1] = v.y;
      }

  // The state in the registers into unit c of the workspace, as two bf16
  // planes (its rounding, the remainder), staged in shared memory so that
  // each thread stores 16 bytes at a time.
  auto put = [&](int c) {
#pragma unroll
    for (int i = 0; i < NDN; ++i) {
      const int dn = ng + i * NG;
      if (dn >= N / 16) break;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * rg + g + 8 * r, col = 16 * dn + 8 * hh + 2 * qd;
          uint32_t hi, lo;
          hi_lo(acc[i][hh][2 * r], acc[i][hh][2 * r + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(Oh + row * L::kOP + col) = hi;
          if (kStateLo) *reinterpret_cast<uint32_t*>(Ol + row * L::kOP + col) = lo;
        }
    }
    __syncthreads();
    bf16* dst = ws + size_t(c) * state_unit(a, true);
    for (int e = tid; e < kSP * CHN; e += 32 * kCW) {
      const int r = e / CHN, ch = e % CHN, p = p0 + r;
      bf16* tl = dst + size_t(p / kPW) * 2 * kPW * N + swz<CHN>(p % kPW, ch);
      *reinterpret_cast<uint4*>(tl) = *reinterpret_cast<const uint4*>(Oh + r * L::kOP + 8 * ch);
      if (kStateLo)
        *reinterpret_cast<uint4*>(tl + kPW * N) =
            *reinterpret_cast<const uint4*>(Ol + r * L::kOP + 8 * ch);
    }
  };

  load(0);
  cp_async_commit();
  const float A2 = a.A[h] * kLog2e;
  for (int i = 0; i < nc; ++i) {
    const int c = dir ? nc - 1 - i : i, st = i & 1;
    if (i + 1 < nc) load(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                        // step i's chunk has landed; the last put's copy is done
    if (dir == 0 ? (c > 0 || a.init != nullptr) : c < nc - 1) put(c);
    if (dir == 0 && c == nc - 1) break;     // S0 of the last chunk is the last one read

    // this warp's coefficients: w_t = dt_t e^{cum_T - cum_t}, or e^{cum_t}
    float c0, c1;
    const float* dtc = dts + st * kT;
    const float cumT = warp_cum2(dtc, A2, lane, c0, c1);
    float* cw = coefw + warp * kT;
    cw[2 * lane] = dir ? ex2(c0) : dtc[2 * lane] * ex2(cumT - c0);
    cw[2 * lane + 1] = dir ? ex2(c1) : dtc[2 * lane + 1] * ex2(cumT - c1);
    __syncwarp();
    const float decay = ex2(cumT);
#pragma unroll
    for (int i2 = 0; i2 < NDN; ++i2)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[i2][hh][x] *= decay;

    // state += (V coef)^T U: A = (V coef)^T rows p (k = t), each scaled
    // element taken as its bf16 rounding and the remainder
    const bf16* Vc = Vs + st * kT * kSP;
    const bf16* Uc = Us + st * kT * N;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t af[4], ahi[4], alo[4];
      ldmatrix_x4_trans(af, Vc + swz<CHP>(16 * kk + (lane & 7) + ((lane >> 4) << 3),
                                          2 * rg + ((lane >> 3) & 1)));
      const float* ck = cw + 16 * kk + 2 * qd;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float s0 = ck[8 * (x >> 1)], s1 = ck[8 * (x >> 1) + 1];
        hi_lo(bf_lo(af[x]) * s0, bf_hi(af[x]) * s1, ahi[x], alo[x]);
      }
#pragma unroll
      for (int i2 = 0; i2 < NDN; ++i2) {
        const int dn = ng + i2 * NG;
        if (dn >= N / 16) break;
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, Uc + swz<CHN>(16 * kk + (lane & 15), 2 * dn + (lane >> 4)));
        mma_bf16(acc[i2][0], ahi, bfr[0], bfr[1]);
        mma_bf16(acc[i2][0], alo, bfr[0], bfr[1]);
        mma_bf16(acc[i2][1], ahi, bfr[2], bfr[3]);
        mma_bf16(acc[i2][1], alo, bfr[2], bfr[3]);
      }
    }
    __syncthreads();                        // slot st and the staged state are free
  }
  if (dir == 1) {                           // G after chunk 0 is the initial state's gradient
#pragma unroll
    for (int i = 0; i < NDN; ++i) {
      const int dn = ng + i * NG;
      if (dn >= N / 16) break;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = p0 + 16 * rg + g + 8 * r, n = 16 * dn + 8 * hh + 2 * qd;
          if (p < P)
            *reinterpret_cast<float2*>(a.dinit + ((size_t(bi) * H + h) * P + p) * N + n) =
                make_float2(acc[i][hh][2 * r], acc[i][hh][2 * r + 1]);
        }
    }
  }
}

// ---- The tensor-core chunk kernel: per (chunk, group of heads, b).
template <int N>
struct ChunkSmem {
  static constexpr int kBC = kT * N, kX = kT * kPW, kSt = kPW * N, kMW = kT * kT;
  static constexpr int kHalf = 2 * kBC + 2 * kX + 4 * kSt + 4 * kMW;   // bf16 elements
  static constexpr int kF32 = 2 * kT + kCW * kT + 3 * kT + kCW * kT + 2 * kCW;
  static constexpr int bytes() { return 2 * kHalf + 16 + 4 * kF32; }
};

// sum over 8 bf16 pairs of (a_hi + a_lo)(b_hi + b_lo)
__device__ __forceinline__ float dot8(const uint4& ah, const uint4& al, const uint4& bh,
                                      const uint4& bl) {
  const uint32_t A0[4] = {ah.x, ah.y, ah.z, ah.w}, A1[4] = {al.x, al.y, al.z, al.w};
  const uint32_t B0[4] = {bh.x, bh.y, bh.z, bh.w}, B1[4] = {bl.x, bl.y, bl.z, bl.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s += (bf_lo(A0[i]) + bf_lo(A1[i])) * (bf_lo(B0[i]) + bf_lo(B1[i])) +
         (bf_hi(A0[i]) + bf_hi(A1[i])) * (bf_hi(B0[i]) + bf_hi(B1[i]));
  return s;
}

template <int N>
__global__ void __launch_bounds__(32 * kCW, 2) ssd_bwd_chunk_mma(ChunkArgs a) {
  using bf16 = __nv_bfloat16;
  using L = ChunkSmem<N>;
  constexpr int CHN = N / 8, NT = N / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Bs = reinterpret_cast<bf16*>(smem);             // [kT][N] the chunk's B, swizzled
  bf16* Cs = Bs + L::kBC;                               // [kT][N]
  bf16* xs = Cs + L::kBC;                               // [kT][kPW] a tile of the head's x
  bf16* dys = xs + L::kX;                               // [kT][kPW] and of dy
  bf16* S0h = dys + L::kX;                              // [kPW][N] rows of S0: rounding
  bf16* S0l = S0h + L::kSt;                             //   and remainder
  bf16* Gh = S0l + L::kSt;                              // [kPW][N] rows of G
  bf16* Gl = Gh + L::kSt;
  bf16* Mh = Gl + L::kSt;                               // [kT][kT] M[t][u]: rounding
  bf16* Ml = Mh + L::kMW;                               //   and remainder
  // [kT][kT] fp32: W summed over the group's heads (swizzled as swz); after
  // the last head, that sum as rounding and remainder, Wh then Wl
  float* wsf = reinterpret_cast<float*>(Ml + L::kMW);
  bf16* Wh = Ml + L::kMW;
  bf16* Wl = Wh + L::kMW;
  uint64_t* bar = reinterpret_cast<uint64_t*>(Wl + L::kMW);   // [2]: S0's and G's bulk copies
  float* dtw = reinterpret_cast<float*>(bar + 2);       // [2][kT]: dt of this head and the next
  float* cumw = dtw + 2 * kT;                           // [kCW][kT]: each warp's cum (base 2)
  float* rowQ = cumw + kCW * kT;                        // [kT] row sums of Q
  float* xGB = rowQ + kT;                               // [kT] x_u . G B_u
  float* itp = xGB + kT;                                // [kT] C_t . e^{cum_t} S0^T dy_t
  float* colK = itp + kT;                               // [kCW][kT] column sums, per warp
  float* red = colK + kCW * kT;                         // [2][kCW]: dD, <G, S0> per warp

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int c = blockIdx.x, grp = blockIdx.y, bi = blockIdx.z;
  const int S = a.S, H = a.H, P = a.P, nc = a.nc;
  const int t0 = c * kT, valid = min(kT, S - t0);
  const int n_pt = (P + kPW - 1) / kPW;
  const bool has_g = c < nc - 1, has_s0 = c > 0 || a.init != nullptr;
  const bf16* Bg = static_cast<const bf16*>(a.B) + bi * a.sB_b;
  const bf16* Cg = static_cast<const bf16*>(a.C) + bi * a.sC_b;
  const bf16* xg = static_cast<const bf16*>(a.x) + bi * a.sx_b;
  const bf16* dyg = static_cast<const bf16*>(a.dy) + size_t(bi) * S * H * P;
  const bf16* ws = static_cast<const bf16*>(a.states);

  for (int e = tid; e < kT * CHN; e += 32 * kCW) {
    const int t = e / CHN, ch = e % CHN;
    const bool ok = t < valid;
    cp_async16(Bs + swz<CHN>(t, ch), ok ? Bg + (t0 + t) * a.sB_s + 8 * ch : Bg, ok);
    cp_async16(Cs + swz<CHN>(t, ch), ok ? Cg + (t0 + t) * a.sC_s + 8 * ch : Cg, ok);
  }
  cp_async_commit();
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
  }
  cp_async_wait<0>();
  __syncthreads();

  // C.B^T for this warp's rows t, once for the group's heads (tiles of u
  // wholly above the diagonal stay 0)
  float cb[kT / 8][4];
#pragma unroll
  for (int j = 0; j < kT / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) cb[j][x] = 0.f;
#pragma unroll
  for (int kd = 0; kd < N / 16; ++kd) {
    uint32_t af[4];
    ldmatrix_x4(af, Cs + swz<CHN>(16 * warp + (lane & 15), 2 * kd + (lane >> 4)));
#pragma unroll
    for (int jj = 0; jj < kT / 16; ++jj) {
      if (jj > warp) continue;
      uint32_t bfr[4];
      ldmatrix_x4(bfr, Bs + swz<CHN>(16 * jj + (lane & 7) + ((lane >> 4) << 3),
                                     2 * kd + ((lane >> 3) & 1)));
      mma_bf16(cb[2 * jj], af, bfr[0], bfr[1]);
      mma_bf16(cb[2 * jj + 1], af, bfr[2], bfr[3]);
    }
  }

  // the group's dB (rows u) and dC (rows t) of this warp's tokens; W summed
  // over the group's heads in shared memory (each thread its own elements):
  // B and C are every head's, so sum_h W_h B and sum_h W_h^T C are one
  // product each, after the last head
  float dBa[NT][4], dCa[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) dBa[j][x] = dCa[j][x] = 0.f;
  auto wsum_at = [&](int t, int j) {
    return reinterpret_cast<float2*>(wsf + t * kT + ((j ^ (t & 7)) << 3) + 2 * qd);
  };
#pragma unroll
  for (int j = 0; j < kT / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) *wsum_at(16 * warp + g + 8 * r, j) = make_float2(0.f, 0.f);

  // x, dy columns [kPW pt, kPW pt + kPW) of head h into shared memory by
  // cp.async (and dt into `dt_dst`), one group
  auto issue_xdy = [&](int h, int pt, float* dt_dst) {
    const int p0 = kPW * pt;
    for (int e = tid; e < kT * (kPW / 8); e += 32 * kCW) {
      const int t = e / (kPW / 8), ch = e % (kPW / 8);
      const bool ok = t < valid && p0 + 8 * ch < P;
      cp_async16(xs + swz<kPW / 8>(t, ch),
                 ok ? xg + (t0 + t) * a.sx_s + size_t(h) * P + p0 + 8 * ch : xg, ok);
      cp_async16(dys + swz<kPW / 8>(t, ch),
                 ok ? dyg + (size_t(t0 + t) * H + h) * P + p0 + 8 * ch : dyg, ok);
    }
    if (dt_dst != nullptr) {
      const float* dtg = a.dt + bi * a.sdt_b + h;
      for (int t = tid; t < kT; t += 32 * kCW) {
        const bool ok = t < valid;
        cp_async4(dt_dst + t, ok ? dtg + (t0 + t) * a.sdt_s : dtg, ok);
      }
    }
    cp_async_commit();
  };
  // tile pt of head h's S0 (which = 0) or G (1): one bulk copy by one
  // thread, reported to bar[which]; ph[which] is the phase to wait for
  constexpr uint32_t kStBytes = (kStateLo ? 2 : 1) * kPW * N * 2;
  uint32_t ph[2] = {0u, 0u};
  auto issue_state = [&](int h, int pt, int which) {
    if (tid != 0) return;
    const bf16* src = ws + (which ? g_part(a, true) : 0) +
                      ((size_t(bi) * H + h) * nc + c) * state_unit(a, true) + size_t(pt) * 2 * kPW * N;
    mbar_expect_tx(&bar[which], kStBytes);
    bulk_load(which ? Gh : S0h, src, kStBytes, &bar[which]);
  };
  auto wait_state = [&](int which) {
    mbar_wait(&bar[which], ph[which]);
    ph[which] ^= 1u;
  };

  bool prefetched = false;                  // the head's first tile is already in flight
  for (int hi = 0; hi < a.hg; ++hi) {
    const int h = grp * a.hg + hi;
    if (h >= H) break;
    const float Ah = a.A[h], Dh = a.D[h];
    const float* dts = dtw + (hi & 1) * kT;
    if (!prefetched) {
      issue_xdy(h, 0, dtw + (hi & 1) * kT);
      if (has_s0) issue_state(h, 0, 0);
      if (has_g) issue_state(h, 0, 1);
    }
    const bool ahead = n_pt == 1 && hi + 1 < a.hg && h + 1 < H;   // prefetch the next head
    cp_async_wait<0>();
    if (has_s0) wait_state(0);
    if (has_g) wait_state(1);
    __syncthreads();
    int resident = 0;
    // the tile pt of P resident, every warp done with the last one first
    auto tile = [&](int pt) {
      if (resident == pt) return;
      __syncthreads();
      issue_xdy(h, pt, nullptr);
      if (has_s0) issue_state(h, pt, 0);
      if (has_g) issue_state(h, pt, 1);
      cp_async_wait<0>();
      if (has_s0) wait_state(0);
      if (has_g) wait_state(1);
      __syncthreads();
      resident = pt;
    };

    // (1) dy.x^T over the tiles of P, rows t of this warp
    float dxy[kT / 8][4];
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) dxy[j][x] = 0.f;
    for (int pt = 0; pt < n_pt; ++pt) {
      tile(pt);
#pragma unroll
      for (int kp = 0; kp < kPW / 16; ++kp) {
        uint32_t af[4];
        ldmatrix_x4(af, dys + swz<kPW / 8>(16 * warp + (lane & 15), 2 * kp + (lane >> 4)));
#pragma unroll
        for (int jj = 0; jj < kT / 16; ++jj) {
          if (jj > warp) continue;
          uint32_t bfr[4];
          ldmatrix_x4(bfr, xs + swz<kPW / 8>(16 * jj + (lane & 7) + ((lane >> 4) << 3),
                                             2 * kp + ((lane >> 3) & 1)));
          mma_bf16(dxy[2 * jj], af, bfr[0], bfr[1]);
          mma_bf16(dxy[2 * jj + 1], af, bfr[2], bfr[3]);
        }
      }
    }

    // cum of this head's chunk, each warp its own copy
    float* cum = cumw + warp * kT;
    float cumT;
    {
      float c0, c1;
      cumT = warp_cum2(dts, Ah * kLog2e, lane, c0, c1);
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = c1;
      __syncwarp();
    }

    // (2) the coefficients on the lower triangle: M = (C.B) dt_u e^{..} into
    // shared memory as rounding and remainder, W = (dy.x) dt_u e^{..} onto the
    // group's sum; K = (dy.x)(C.B) e^{..} and Q = K dt_u: row sums of Q (into
    // d cum_t) and column sums of K (into ddt_u; those of Q, out of d cum_u,
    // are dt_u times them)
    {
      float rq[2] = {0.f, 0.f}, dd = 0.f;
      float ct[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) ct[r] = cum[16 * warp + g + 8 * r];
#pragma unroll
      for (int j = 0; j < kT / 8; ++j) {
        float ck[2] = {0.f, 0.f};
        if (j / 2 <= warp) {
          float mv[4], wv[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int r = x >> 1, e = x & 1, t = 16 * warp + g + 8 * r, u = 8 * j + 2 * qd + e;
            mv[x] = wv[x] = 0.f;
            if (u <= t) {
              const float du = dts[u], ex = ex2(ct[r] - cum[u]);
              const float k = dxy[j][x] * cb[j][x] * ex, q = k * du;
              mv[x] = cb[j][x] * du * ex;
              wv[x] = dxy[j][x] * du * ex;
              rq[r] += q;
              ck[e] += k;
              if (u == t) dd += dxy[j][x];
            }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int t = 16 * warp + g + 8 * r, off = swz<kT / 8>(t, j) + 2 * qd;
            uint32_t h0, l0;
            hi_lo(mv[2 * r], mv[2 * r + 1], h0, l0);
            *reinterpret_cast<uint32_t*>(Mh + off) = h0;
            *reinterpret_cast<uint32_t*>(Ml + off) = l0;
            float2* ws2 = wsum_at(t, j);
            const float2 v = *ws2;
            *ws2 = make_float2(v.x + wv[2 * r], v.y + wv[2 * r + 1]);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) ck[e] += __shfl_xor_sync(0xffffffffu, ck[e], off);
        }
        if (g == 0)
#pragma unroll
          for (int e = 0; e < 2; ++e) colK[warp * kT + 8 * j + 2 * qd + e] = ck[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = rq[r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (qd == 0) rowQ[16 * warp + g + 8 * r] = v;
      }
      dd = warp_sum(dd);
      if (lane == 0) red[warp] = dd;
    }
    __syncwarp();

    // (3) dC rows t += e^{cum_t} S0^T dy_t; C_t . e^{cum_t} S0^T dy_t into d
    // cum_t; <G, S0> (into d cum_T)
    {
      float ip[2] = {0.f, 0.f}, gs = 0.f;
      if (has_s0) {
        float sd[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) sd[j][x] = 0.f;
        for (int pt = 0; pt < n_pt; ++pt) {
          tile(pt);
#pragma unroll
          for (int kp = 0; kp < kPW / 16; ++kp) {
            uint32_t af[4];
            ldmatrix_x4(af, dys + swz<kPW / 8>(16 * warp + (lane & 15), 2 * kp + (lane >> 4)));
#pragma unroll
            for (int dn = 0; dn < N / 16; ++dn) {
              uint32_t bh[4], bl[4];
              ldmatrix_x4_trans(bh, S0h + swz<CHN>(16 * kp + (lane & 15), 2 * dn + (lane >> 4)));
              mma_bf16(sd[2 * dn], af, bh[0], bh[1]);
              mma_bf16(sd[2 * dn + 1], af, bh[2], bh[3]);
              if (kStateLo) {
                ldmatrix_x4_trans(bl, S0l + swz<CHN>(16 * kp + (lane & 15), 2 * dn + (lane >> 4)));
                mma_bf16(sd[2 * dn], af, bl[0], bl[1]);
                mma_bf16(sd[2 * dn + 1], af, bl[2], bl[3]);
              }
            }
          }
          if (has_g)
            for (int e = tid; e < kPW * N / 8; e += 32 * kCW) {
              const uint4 z = make_uint4(0u, 0u, 0u, 0u);
              gs += dot8(reinterpret_cast<const uint4*>(Gh)[e],
                         kStateLo ? reinterpret_cast<const uint4*>(Gl)[e] : z,
                         reinterpret_cast<const uint4*>(S0h)[e],
                         kStateLo ? reinterpret_cast<const uint4*>(S0l)[e] : z);
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = 16 * warp + g + 8 * r;
          const float el = ex2(cum[t]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint32_t cv = *reinterpret_cast<const uint32_t*>(Cs + swz<CHN>(t, j) + 2 * qd);
            const float v0 = el * sd[j][2 * r], v1 = el * sd[j][2 * r + 1];
            ip[r] += v0 * bf_lo(cv) + v1 * bf_hi(cv);
            dCa[j][2 * r] += v0;
            dCa[j][2 * r + 1] += v1;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = ip[r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (qd == 0) itp[16 * warp + g + 8 * r] = v;
      }
      gs = warp_sum(gs);
      if (lane == 0) red[kCW + warp] = gs;
    }
    __syncthreads();                        // M of every warp is written; S0 is read
    if (ahead && has_s0) issue_state(h + 1, 0, 0);

    // (4) dx rows u = M^T dy + D dy_u + w_u G B_u, tile by tile of P;
    // x_u . G B_u; <G, S0>
    float wu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int u = 16 * warp + g + 8 * r;
      wu[r] = dts[u] * ex2(cumT - cum[u]);
    }
    {
      float xgb[2] = {0.f, 0.f};
      bf16* dxg = static_cast<bf16*>(a.dx) + (size_t(bi) * S + t0) * H * P + size_t(h) * P;
      for (int pt = 0; pt < n_pt; ++pt) {
        tile(pt);
        const int p0 = kPW * pt;
#pragma unroll
        for (int dp = 0; dp < kPW / 16; ++dp) {
          if (p0 + 16 * dp >= P) break;
          float acc[2][4] = {}, gb[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < kT / 16; ++kk) {
            if (kk < warp) continue;
            uint32_t ah[4], al[4], bfr[4];
            const int ro = 16 * kk + (lane & 7) + ((lane >> 4) << 3), co = 2 * warp + ((lane >> 3) & 1);
            ldmatrix_x4_trans(ah, Mh + swz<kT / 8>(ro, co));
            ldmatrix_x4_trans(al, Ml + swz<kT / 8>(ro, co));
            ldmatrix_x4_trans(bfr, dys + swz<kPW / 8>(16 * kk + (lane & 15), 2 * dp + (lane >> 4)));
            mma_bf16(acc[0], ah, bfr[0], bfr[1]);
            mma_bf16(acc[0], al, bfr[0], bfr[1]);
            mma_bf16(acc[1], ah, bfr[2], bfr[3]);
            mma_bf16(acc[1], al, bfr[2], bfr[3]);
          }
          if (has_g)
#pragma unroll
            for (int kn = 0; kn < N / 16; ++kn) {
              uint32_t af[4], bh[4], bl[4];
              ldmatrix_x4(af, Bs + swz<CHN>(16 * warp + (lane & 15), 2 * kn + (lane >> 4)));
              const int ro = 16 * dp + (lane & 7) + ((lane >> 4) << 3), co = 2 * kn + ((lane >> 3) & 1);
              ldmatrix_x4(bh, Gh + swz<CHN>(ro, co));
              mma_bf16(gb[0], af, bh[0], bh[1]);
              mma_bf16(gb[1], af, bh[2], bh[3]);
              if (kStateLo) {
                ldmatrix_x4(bl, Gl + swz<CHN>(ro, co));
                mma_bf16(gb[0], af, bl[0], bl[1]);
                mma_bf16(gb[1], af, bl[2], bl[3]);
              }
            }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int u = 16 * warp + g + 8 * r;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int p = p0 + 16 * dp + 8 * hh + 2 * qd;
              const int off = swz<kPW / 8>(u, 2 * dp + hh) + 2 * qd;
              const uint32_t dv = *reinterpret_cast<const uint32_t*>(dys + off);
              const uint32_t xv = *reinterpret_cast<const uint32_t*>(xs + off);
              const float g0 = gb[hh][2 * r], g1 = gb[hh][2 * r + 1];
              xgb[r] += bf_lo(xv) * g0 + bf_hi(xv) * g1;
              if (u < valid && p < P)
                *reinterpret_cast<uint32_t*>(dxg + size_t(u) * H * P + p) =
                    pack_bf16(acc[hh][2 * r] + Dh * bf_lo(dv) + wu[r] * g0,
                              acc[hh][2 * r + 1] + Dh * bf_hi(dv) + wu[r] * g1);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = xgb[r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (qd == 0) xGB[16 * warp + g + 8 * r] = v;
      }
    }

    // (5) dB rows u += w_u G^T x_u
    if (has_g) {
      float xgv[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) xgv[j][x] = 0.f;
      for (int pt = 0; pt < n_pt; ++pt) {
        tile(pt);
#pragma unroll
        for (int kp = 0; kp < kPW / 16; ++kp) {
          uint32_t af[4];
          ldmatrix_x4(af, xs + swz<kPW / 8>(16 * warp + (lane & 15), 2 * kp + (lane >> 4)));
#pragma unroll
          for (int dn = 0; dn < N / 16; ++dn) {
            uint32_t bh[4], bl[4];
            ldmatrix_x4_trans(bh, Gh + swz<CHN>(16 * kp + (lane & 15), 2 * dn + (lane >> 4)));
            mma_bf16(xgv[2 * dn], af, bh[0], bh[1]);
            mma_bf16(xgv[2 * dn + 1], af, bh[2], bh[3]);
            if (kStateLo) {
              ldmatrix_x4_trans(bl, Gl + swz<CHN>(16 * kp + (lane & 15), 2 * dn + (lane >> 4)));
              mma_bf16(xgv[2 * dn], af, bl[0], bl[1]);
              mma_bf16(xgv[2 * dn + 1], af, bl[2], bl[3]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) dBa[j][x] += wu[x >> 1] * xgv[j][x];
    }
    // x, dy and G are dead: the next head's load while this head's d cum
    // tail runs (its S0 is already on the way).
    prefetched = ahead;
    __syncthreads();
    if (ahead) {
      issue_xdy(h + 1, 0, dtw + ((hi + 1) & 1) * kT);
      if (has_g) issue_state(h + 1, 0, 1);
    }

    __syncthreads();                        // rowQ, colK, xGB, itp and red are complete

    // (6) d cum_t = rowQ_t - dt_t colK_t + itp_t - w_t xGB_t (+ at T: e^{cum_T}
    // <G, S0> + sum_t w_t xGB_t), its reverse running sum r, ddt and dA: every
    // warp the whole chunk (two tokens a lane), storing its own 16 tokens
    {
      float dc[2], kq[2], wx = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int t = 2 * lane + q;
        float ck = 0.f;
#pragma unroll
        for (int w = 0; w < kCW; ++w) ck += colK[w * kT + t];
        const float wt = dts[t] * ex2(cumT - cum[t]);
        dc[q] = rowQ[t] - dts[t] * ck + itp[t] - wt * xGB[t];
        kq[q] = ck;
        wx += wt * xGB[t];
      }
      wx = warp_sum(wx);
      float gs = 0.f, ddh = 0.f;
#pragma unroll
      for (int w = 0; w < kCW; ++w) {
        gs += red[kCW + w];
        ddh += red[w];
      }
      if (lane == 31) dc[1] += ex2(cumT) * gs + wx;
      float suf = dc[0] + dc[1];              // sum over lanes >= this one
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane + off < 32) suf += v;
      }
      float after = __shfl_down_sync(0xffffffffu, suf, 1);
      if (lane == 31) after = 0.f;
      const float r1 = dc[1] + after, r0 = dc[0] + r1;
      const float rr[2] = {r0, r1};
      float da = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int t = 2 * lane + q;
        if (t < valid && lane / 8 == warp)
          a.ddt[(size_t(bi) * S + t0 + t) * H + h] =
              kq[q] + ex2(cumT - cum[t]) * xGB[t] + Ah * rr[q];
        da += dts[t] * rr[q];
      }
      da = warp_sum(da);
      if (tid == 0) {
        float* ad = a.ad_part + ((size_t(bi) * nc + c) * H + h) * 2;
        ad[0] = da;
        ad[1] = ddh;
      }
    }
  }

  // (7) dC rows t += (sum_h W_h) B; dB rows u += (sum_h W_h)^T C, the sum
  // taken from shared memory as rounding and remainder
  {
    __syncthreads();
    float2 v[kT / 8][2];
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) v[j][r] = *wsum_at(16 * warp + g + 8 * r, j);
    __syncthreads();                        // the sum is read; its space takes the planes
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = swz<kT / 8>(16 * warp + g + 8 * r, j) + 2 * qd;
        uint32_t h0, l0;
        hi_lo(v[j][r].x, v[j][r].y, h0, l0);
        *reinterpret_cast<uint32_t*>(Wh + off) = h0;
        *reinterpret_cast<uint32_t*>(Wl + off) = l0;
      }
    __syncthreads();
  }
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    if (kk > warp) continue;
    uint32_t ah[4], al[4];
    ldmatrix_x4(ah, Wh + swz<kT / 8>(16 * warp + (lane & 15), 2 * kk + (lane >> 4)));
    ldmatrix_x4(al, Wl + swz<kT / 8>(16 * warp + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int dn = 0; dn < N / 16; ++dn) {
      uint32_t bfr[4];
      ldmatrix_x4_trans(bfr, Bs + swz<CHN>(16 * kk + (lane & 15), 2 * dn + (lane >> 4)));
      mma_bf16(dCa[2 * dn], ah, bfr[0], bfr[1]);
      mma_bf16(dCa[2 * dn], al, bfr[0], bfr[1]);
      mma_bf16(dCa[2 * dn + 1], ah, bfr[2], bfr[3]);
      mma_bf16(dCa[2 * dn + 1], al, bfr[2], bfr[3]);
    }
  }
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    if (kk < warp) continue;
    uint32_t ah[4], al[4];
    const int ro = 16 * kk + (lane & 7) + ((lane >> 4) << 3), co = 2 * warp + ((lane >> 3) & 1);
    ldmatrix_x4_trans(ah, Wh + swz<kT / 8>(ro, co));
    ldmatrix_x4_trans(al, Wl + swz<kT / 8>(ro, co));
#pragma unroll
    for (int dn = 0; dn < N / 16; ++dn) {
      uint32_t bfr[4];
      ldmatrix_x4_trans(bfr, Cs + swz<CHN>(16 * kk + (lane & 15), 2 * dn + (lane >> 4)));
      mma_bf16(dBa[2 * dn], ah, bfr[0], bfr[1]);
      mma_bf16(dBa[2 * dn], al, bfr[0], bfr[1]);
      mma_bf16(dBa[2 * dn + 1], ah, bfr[2], bfr[3]);
      mma_bf16(dBa[2 * dn + 1], al, bfr[2], bfr[3]);
    }
  }

  // the group's dB and dC of this chunk's rows
  const size_t half = size_t(a.groups) * a.batch * S * N;
  float* pB = a.dbc_part + (size_t(grp) * a.batch + bi) * S * N + size_t(t0) * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = 16 * warp + g + 8 * r;
    if (t >= valid) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + 2 * qd;
      *reinterpret_cast<float2*>(pB + size_t(t) * N + n) = make_float2(dBa[j][2 * r], dBa[j][2 * r + 1]);
      *reinterpret_cast<float2*>(pB + half + size_t(t) * N + n) =
          make_float2(dCa[j][2 * r], dCa[j][2 * r + 1]);
    }
  }
}

// ---- The CUDA-core states kernel: per (slice of kFSP rows of P and
// direction, h, b), the state in shared memory in AccOf<T>.
template <typename Acc>
struct FmaDecays {
  Acc *cum, *ecum, *erev, *w;
  float* dt;
};

// cum (the inclusive running sum of dt_u A over the chunk), e^{cum_t},
// e^{cum_T - cum_t} and w_t = dt_t e^{cum_T - cum_t} in Acc, by one warp
// (two tokens a lane).
template <typename Acc>
__device__ __forceinline__ void fma_decays(const FmaDecays<Acc>& s, float Ah, int lane) {
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
  const Acc cs[2] = {ex + a0, ex + a0 + a1}, ds[2] = {d0, d1};
  const Acc total = __shfl_sync(0xffffffffu, cs[1], 31);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int t = 2 * lane + q;
    const Acc r = acc_exp(total - cs[q]);
    s.cum[t] = cs[q];
    s.ecum[t] = acc_exp(cs[q]);
    s.erev[t] = r;
    s.w[t] = r * ds[q];
  }
}

template <typename Acc>
inline size_t states_fma_smem(int N) {
  return sizeof(Acc) * (size_t(kFSP) * (N + 4) + 4 * kT) +
         4 * (size_t(kT) * (kFSP + 4) + size_t(kT) * (N + 4) + kT);
}

template <typename T>
__global__ void __launch_bounds__(kThr) ssd_bwd_states_fma(ChunkArgs a) {
  using Acc = AccOf<T>;
  extern __shared__ float4 smem_raw[];
  const int N = a.N, pN = N + 4, P = a.P, H = a.H, nc = a.nc;
  Acc* St = reinterpret_cast<Acc*>(smem_raw);            // [kFSP][N + 4]
  FmaDecays<Acc> s;
  s.cum = St + kFSP * pN;
  s.ecum = s.cum + kT;
  s.erev = s.ecum + kT;
  s.w = s.erev + kT;
  float* V = reinterpret_cast<float*>(s.w + kT);         // [kT][kFSP + 4]
  float* U = V + kT * (kFSP + 4);                        // [kT][N + 4]
  s.dt = U + kT * pN;                                    // [kT]
  const int tid = threadIdx.x;
  const int dir = blockIdx.x & 1, p0 = (blockIdx.x >> 1) * kFSP, h = blockIdx.y, bi = blockIdx.z;
  const int rows = min(kFSP, P - p0);
  const T *Vg, *Ug;
  long long sv, su;
  if (dir == 0) {
    Vg = static_cast<const T*>(a.x) + bi * a.sx_b + size_t(h) * P + p0;
    sv = a.sx_s;
    Ug = static_cast<const T*>(a.B) + bi * a.sB_b;
    su = a.sB_s;
  } else {
    Vg = static_cast<const T*>(a.dy) + size_t(bi) * a.S * H * P + size_t(h) * P + p0;
    sv = (long long)H * P;
    Ug = static_cast<const T*>(a.C) + bi * a.sC_b;
    su = a.sC_s;
  }
  const float* dtg = a.dt + bi * a.sdt_b + h;
  Acc* ws = static_cast<Acc*>(a.states) + (dir ? g_part(a, false) : 0) +
            (size_t(bi) * H + h) * nc * state_unit(a, false);
  for (int e = tid; e < kFSP * N; e += kThr) {
    const int p = e / N, n = e % N;
    St[p * pN + n] = dir == 0 && a.init != nullptr && p < rows
                         ? Acc(a.init[((size_t(bi) * H + h) * P + p0 + p) * N + n]) : Acc(0);
  }
  for (int i = 0; i < nc; ++i) {
    const int c = dir ? nc - 1 - i : i, t0 = c * kT, valid = min(kT, a.S - t0);
    __syncthreads();                        // St holds the state entering step i
    if (dir == 0 ? (c > 0 || a.init != nullptr) : c < nc - 1) {
      Acc* dst = ws + size_t(c) * state_unit(a, false) + size_t(p0) * N;
      for (int e = tid; e < rows * N; e += kThr) dst[e] = St[(e / N) * pN + e % N];
    }
    if (dir == 0 && c == nc - 1) break;
    stage<T>(V, kFSP + 4, Vg + t0 * sv, sv, valid, rows, kFSP);
    stage<T>(U, pN, Ug + t0 * su, su, valid, N, N);
    for (int t = tid; t < kT; t += kThr) s.dt[t] = t < valid ? dtg[(t0 + t) * a.sdt_s] : 0.f;
    __syncthreads();
    if (tid < 32) fma_decays(s, a.A[h], tid);
    __syncthreads();
    state_update(St, pN, V, kFSP + 4, U, dir ? s.ecum : s.w, s.ecum[kT - 1], kFSP, N);
  }
  if (dir == 1) {
    __syncthreads();
    for (int e = tid; e < rows * N; e += kThr)
      a.dinit[((size_t(bi) * H + h) * P + p0) * N + e] = float(St[(e / N) * pN + e % N]);
  }
}

// ---- The CUDA-core chunk kernel: per (chunk, group of heads, b), 256
// threads. B, C, the coefficients and the group's dB / dC in shared memory;
// x and dy staged kFPT columns at a time for dy.x^T and read through L1
// elsewhere, and so are S0 and G (AccOf<T>).
template <typename Acc>
inline size_t chunk_fma_smem(int N) {
  const int NP = N >= 32 ? N / 32 : 1;
  return sizeof(Acc) * (size_t(9) * kT + size_t(2) * 16 * kT + size_t(kT) * NP + 32) +
         4 * (size_t(2) * kT * (N + 4) + size_t(2) * kT * (kFPT + 4) + size_t(2) * kT * kTP +
              size_t(2) * kT * N + kT);
}

template <typename T>
__global__ void __launch_bounds__(kThr) ssd_bwd_chunk_fma(ChunkArgs a) {
  using Acc = AccOf<T>;
  extern __shared__ float4 smem_raw[];
  const int N = a.N, pN = N + 4, P = a.P, H = a.H, S = a.S, nc = a.nc;
  const int NP = N >= 32 ? N / 32 : 1, width = N >= 32 ? 32 : N;
  FmaDecays<Acc> s;
  s.cum = reinterpret_cast<Acc*>(smem_raw);
  s.ecum = s.cum + kT;
  s.erev = s.ecum + kT;
  s.w = s.erev + kT;
  Acc* rowQ = s.w + kT;                                   // [kT]
  Acc* xgbp = rowQ + kT;                                  // [4][kT]: x_u . G B_u, 4 parts
  Acc* colQ = xgbp + 4 * kT;                              // [16][kT]
  Acc* colK = colQ + 16 * kT;                             // [16][kT]
  Acc* itpp = colK + 16 * kT;                             // [kT][NP]
  Acc* red = itpp + kT * NP;                              // [32]: <G, S0>, dD per warp
  float* Bs = reinterpret_cast<float*>(red + 32);         // [kT][N + 4]
  float* Cs = Bs + kT * pN;
  float* xt = Cs + kT * pN;                               // [kT][kFPT + 4]
  float* dyt = xt + kT * (kFPT + 4);
  float* Mm = dyt + kT * (kFPT + 4);                      // [kT][kTP] M[t][u]
  float* Wm = Mm + kT * kTP;                              // [kT][kTP] W[t][u]
  float* dBs = Wm + kT * kTP;                             // [kT][N] the group's dB
  float* dCs = dBs + kT * N;                              // [kT][N] and dC
  s.dt = dCs + kT * N;                                    // [kT]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = tid / 16, xl = tid % 16;
  const int c = blockIdx.x, grp = blockIdx.y, bi = blockIdx.z;
  const int t0 = c * kT, valid = min(kT, S - t0);
  const bool has_g = c < nc - 1, has_s0 = c > 0 || a.init != nullptr;
  const T* xg = static_cast<const T*>(a.x) + bi * a.sx_b + t0 * a.sx_s;
  const T* dyg = static_cast<const T*>(a.dy) + (size_t(bi) * S + t0) * H * P;
  const Acc* ws = static_cast<const Acc*>(a.states);
  stage<T>(Bs, pN, static_cast<const T*>(a.B) + bi * a.sB_b + t0 * a.sB_s, a.sB_s, valid, N, N);
  stage<T>(Cs, pN, static_cast<const T*>(a.C) + bi * a.sC_b + t0 * a.sC_s, a.sC_s, valid, N, N);
  for (int e = tid; e < kT * N; e += kThr) dBs[e] = dCs[e] = 0.f;
  __syncthreads();
  int rt[4], ru[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rt[i] = g + 16 * i;
    ru[i] = xl + 16 * i;
  }
  Acc cb[4][4] = {};
  nt_tile<true>(cb, Cs, pN, rt, Bs, pN, ru, N);

  for (int hi = 0; hi < a.hg; ++hi) {
    const int h = grp * a.hg + hi;
    if (h >= H) break;
    const size_t unit = ((size_t(bi) * H + h) * nc + c) * state_unit(a, false);
    const Acc* S0 = ws + unit;
    const Acc* G = ws + g_part(a, false) + unit;
    const T* xh = xg + size_t(h) * P;
    const T* dyh = dyg + size_t(h) * P;
    const float Ah = a.A[h], Dh = a.D[h];
    __syncthreads();                        // the previous head is done with shared memory
    for (int t = tid; t < kT; t += kThr)
      s.dt[t] = t < valid ? a.dt[bi * a.sdt_b + (t0 + t) * a.sdt_s + h] : 0.f;
    __syncthreads();
    if (tid < 32) fma_decays(s, Ah, tid);

    // (1) dy.x^T over staged tiles of kFPT columns of P
    Acc dxy[4][4] = {};
    for (int p0 = 0; p0 < P; p0 += kFPT) {
      __syncthreads();
      const int cols = min(kFPT, P - p0);
      stage<T>(xt, kFPT + 4, xh + p0, a.sx_s, valid, cols, kFPT);
      stage<T>(dyt, kFPT + 4, dyh + p0, (long long)H * P, valid, cols, kFPT);
      __syncthreads();
      nt_tile<true>(dxy, dyt, kFPT + 4, rt, xt, kFPT + 4, ru, kFPT);
    }

    // (2) the coefficients M, W (fp32) and the sums of K and Q, as in the
    // two-sweep kernel
    {
      Acc rq[4] = {}, cq[4] = {}, ck[4] = {}, dd = 0;
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
            if (u == t) dd += dxy[i][j];
          }
          Mm[t * kTP + u] = m;
          Wm[t * kTP + u] = wv;
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Acc r = sum16(rq[i]);
        if (xl == 0) rowQ[rt[i]] = r;
        colQ[g * kT + ru[i]] = cq[i];
        colK[g * kT + ru[i]] = ck[i];
      }
      dd = sum32(dd);
      if (lane == 0) red[8 + warp] = dd;
    }
    __syncthreads();

    // (3) dx_u = sum_{t>=u} M[t][u] dy_t + D dy_u + w_u (G B_u) and x_u.(G B_u),
    // element (u, p) with u = tid % kT on every pass
    {
      const int u = tid % kT;
      const Acc wu = s.w[u];
      Acc xgb = 0;
      T* dxh = static_cast<T*>(a.dx) + (size_t(bi) * S + t0) * H * P + size_t(h) * P;
      for (int p = tid / kT; p < P; p += kThr / kT) {
        float acc = 0.f;
        for (int t = u; t < valid; ++t)
          acc = fmaf(Mm[t * kTP + u], to_float<T>(dyh[size_t(t) * H * P + p]), acc);
        Acc gb = 0;
        if (has_g)
          for (int n = 0; n < N; ++n) gb = fma(Acc(Bs[u * pN + n]), G[size_t(p) * N + n], gb);
        if (u < valid) {
          const float dyu = to_float<T>(dyh[size_t(u) * H * P + p]);
          xgb = fma(Acc(to_float<T>(xh[size_t(u) * a.sx_s + p])), gb, xgb);
          dxh[size_t(u) * H * P + p] = from_float<T>(float(Acc(acc + Dh * dyu) + wu * gb));
        }
      }
      xgbp[(tid / kT) * kT + u] = xgb;
    }

    // (4) dB_u += sum_{t>=u} W[t][u] C_t + w_u G^T x_u and dC_t += sum_{u<=t}
    // W[t][u] B_u + e^{cum_t} S0^T dy_t, element (row, n) with n = e % N; the
    // C_t . e^{cum_t} S0^T dy_t parts summed by the lanes of one row, NP a row
    for (int e = tid; e < kT * N; e += kThr) {
      const int r = e / N, n = e % N;
      float acc = 0.f;
      for (int t = r; t < kT; ++t) acc = fmaf(Wm[t * kTP + r], Cs[t * pN + n], acc);
      Acc xgv = 0;
      if (has_g && r < valid)
        for (int p = 0; p < P; ++p)
          xgv = fma(Acc(to_float<T>(xh[size_t(r) * a.sx_s + p])), G[size_t(p) * N + n], xgv);
      dBs[e] += float(fma(s.w[r], xgv, Acc(acc)));
      float acc2 = 0.f;
      for (int u = 0; u <= r; ++u) acc2 = fmaf(Wm[r * kTP + u], Bs[u * pN + n], acc2);
      Acc sd = 0;
      if (has_s0 && r < valid)
        for (int p = 0; p < P; ++p)
          sd = fma(Acc(to_float<T>(dyh[size_t(r) * H * P + p])), S0[size_t(p) * N + n], sd);
      const Acc ev = s.ecum[r] * sd;
      dCs[e] += float(Acc(acc2) + ev);
      Acc ip = Acc(Cs[r * pN + n]) * ev;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        if (off < width) ip += __shfl_xor_sync(0xffffffffu, ip, off);
      if (lane % width == 0) itpp[r * NP + n / 32] = ip;
    }

    // (5) <G, S0>
    {
      Acc gs = 0;
      if (has_g && has_s0)
        for (size_t e = tid; e < size_t(P) * N; e += kThr) gs = fma(G[e], S0[e], gs);
      gs = sum32(gs);
      if (lane == 0) red[warp] = gs;
    }
    __syncthreads();

    // (6) d cum, its reverse running sum r, ddt and dA, by warp 0
    if (warp == 0) {
      Acc gs = 0, ddh = 0;
      for (int k = 0; k < kThr / 32; ++k) {
        gs += red[k];
        ddh += red[8 + k];
      }
      Acc dc[2], kk[2], wx = 0;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int t = 2 * lane + q;
        Acc cq = 0, ck = 0, it = 0, xgbt = 0;
        for (int k = 0; k < 16; ++k) {
          cq += colQ[k * kT + t];
          ck += colK[k * kT + t];
        }
        for (int k = 0; k < NP; ++k) it += itpp[t * NP + k];
        for (int k = 0; k < kThr / kT; ++k) xgbt += xgbp[k * kT + t];
        const Acc wxt = s.w[t] * xgbt;
        dc[q] = rowQ[t] - cq + it - wxt;
        kk[q] = ck + s.erev[t] * xgbt;
        wx += wxt;
      }
      wx = sum32(wx);
      if (lane == 31) dc[1] += s.ecum[kT - 1] * gs + wx;
      Acc suf = dc[0] + dc[1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const Acc v = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane + off < 32) suf += v;
      }
      Acc after = __shfl_down_sync(0xffffffffu, suf, 1);
      if (lane == 31) after = Acc(0);
      const Acc r1 = dc[1] + after, r0 = dc[0] + r1;
      const Acc rr[2] = {r0, r1};
      Acc da = 0;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int t = 2 * lane + q;
        if (t < valid) a.ddt[(size_t(bi) * S + t0 + t) * H + h] = float(kk[q] + Acc(Ah) * rr[q]);
        da = fma(Acc(s.dt[t]), rr[q], da);
      }
      da = sum32(da);
      if (lane == 0) {
        float* ad = a.ad_part + ((size_t(bi) * nc + c) * H + h) * 2;
        ad[0] = float(da);
        ad[1] = float(ddh);
      }
    }
  }
  __syncthreads();
  const size_t half = size_t(a.groups) * a.batch * S * N;
  float* pB = a.dbc_part + (size_t(grp) * a.batch + bi) * S * N + size_t(t0) * N;
  for (int e = tid; e < valid * N; e += kThr) {
    pB[e] = dBs[e];
    pB[half + e] = dCs[e];
  }
}

// dB, dC: the groups' partials added in order; the last block adds each
// head's dA and dD partials over (b, chunk) in order.
template <typename T>
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ dbc_part,
                                      const float* __restrict__ ad_part, void* dB, void* dC,
                                      float* dA, float* dD, int batch, int S, int H, int N, int nc,
                                      int groups) {
  const size_t E = size_t(batch) * S * N;
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float sa = 0.f, sd = 0.f;
      for (int k = 0; k < batch * nc; ++k) {
        sa += ad_part[(size_t(k) * H + h) * 2];
        sd += ad_part[(size_t(k) * H + h) * 2 + 1];
      }
      dA[h] = sa;
      dD[h] = sd;
    }
    return;
  }
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= 2 * E) return;
  const size_t which = i / E, e = i % E;
  const float* part = dbc_part + which * groups * E + e;
  float acc = 0.f;
  for (int k = 0; k < groups; ++k) acc += part[size_t(k) * E];
  static_cast<T*>(which ? dC : dB)[e] = from_float<T>(acc);
}

template <typename F>
cudaError_t launch_smem(F kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                        const ChunkArgs& a) {
  if (smem > size_t(kMaxSmem)) return cudaErrorInvalidValue;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reduce(const ChunkArgs& a, float* dA, float* dD, void* dB, void* dC,
                          cudaStream_t stream) {
  const size_t n = size_t(2) * a.batch * a.S * a.N;
  ssd_bwd_reduce_kernel<T><<<unsigned((n + 255) / 256 + 1), 256, 0, stream>>>(
      a.dbc_part, a.ad_part, dB, dC, dA, dD, a.batch, a.S, a.H, a.N, a.nc, a.groups);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_mma_n(const ChunkArgs& a, cudaStream_t stream) {
  cudaError_t err = launch_smem(ssd_bwd_states_mma<N>,
                                dim3(2 * cdiv(cdiv(a.P, kPW) * kPW, kSP), a.H, a.batch),
                                32 * kCW, StatesSmem<N>::bytes(), stream, a);
  if (err != cudaSuccess) return err;
  return launch_smem(ssd_bwd_chunk_mma<N>, dim3(a.nc, a.groups, a.batch), 32 * kCW,
                     ChunkSmem<N>::bytes(), stream, a);
}

cudaError_t launch_chunked_mma(const ChunkArgs& a, float* dA, float* dD, void* dB, void* dC,
                               cudaStream_t stream) {
  cudaError_t err;
  switch (a.N) {
    case 16: err = launch_mma_n<16>(a, stream); break;
    case 32: err = launch_mma_n<32>(a, stream); break;
    case 64: err = launch_mma_n<64>(a, stream); break;
    case 128: err = launch_mma_n<128>(a, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_reduce<__nv_bfloat16>(a, dA, dD, dB, dC, stream);
}

template <typename T>
cudaError_t launch_chunked_fma(const ChunkArgs& a, float* dA, float* dD, void* dB, void* dC,
                               cudaStream_t stream) {
  using Acc = AccOf<T>;
  cudaError_t err = launch_smem(ssd_bwd_states_fma<T>, dim3(2 * cdiv(a.P, kFSP), a.H, a.batch),
                                kThr, states_fma_smem<Acc>(a.N), stream, a);
  if (err != cudaSuccess) return err;
  err = launch_smem(ssd_bwd_chunk_fma<T>, dim3(a.nc, a.groups, a.batch), kThr,
                    chunk_fma_smem<Acc>(a.N), stream, a);
  if (err != cudaSuccess) return err;
  return launch_reduce<T>(a, dA, dD, dB, dC, stream);
}

}  // namespace
}  // namespace repro

// x (B,S,H,P), B/C (B,S,N) and dy (B,S,H,P) of one dtype (repro::DType); x,
// B, C with a contiguous last axis (x's (H,P) contiguous) and the given batch
// and sequence strides in elements, dy contiguous. dt (B,S,H) fp32 with the
// given strides (H contiguous); A, D (H,), init (B,H,P,N) or null, fp32
// contiguous. Writes dx (B,S,H,P) and dB, dC (B,S,N) in that dtype, ddt
// (B,S,H), dA, dD (H,) and dinit (B,H,P,N) in fp32, all contiguous. N in
// {16, 32, 64, 128}; B, H <= 65535. Workspaces (contiguous; ops.bwd_plan
// gives their sizes), by variant:
// - 0, the two-sweep kernel: states (B,H,ceil(S/64),pad4(P),N), fp64 for fp32
//   inputs and fp32 for bf16 ones; dbc_part (2,B,H,S,N) and ad_part (B,H,2)
//   fp32; its block's shared memory (smem_bytes) at most 227 KB.
// - 1, the chunked backward on the CUDA cores (either dtype), and 2, on the
//   tensor cores (bf16; P and the strides of x, B and C multiples of 8, x, B,
//   C and dy 16-byte aligned): states 2 x (B,H,ceil(S/64),P,N) elements of 4
//   bytes (variant 2: two bf16 planes) or of 8 / 4 (variant 1: fp64 for fp32
//   inputs, fp32 for bf16); dbc_part (2,groups,B,S,N) with groups =
//   ceil(H / heads_per_group) and ad_part (B,ceil(S/64),H,2), fp32.
// Launches on `stream` of `device` and returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int repro_ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* B,
                                  const void* C, const void* D, const void* init, const void* dy,
                                  void* dx, void* ddt, void* dA, void* dB, void* dC, void* dD,
                                  void* dinit, void* states, void* dbc_part, void* ad_part,
                                  int batch, int S, int H, int P, int N, long long sx_b,
                                  long long sx_s, long long sdt_b, long long sdt_s,
                                  long long sB_b, long long sB_s, long long sC_b, long long sC_s,
                                  int heads_per_group, int dtype, int variant, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch <= 0 || S <= 0 || H <= 0 || P <= 0 || batch > 65535 || H > 65535 ||
      (N != 16 && N != 32 && N != 64 && N != 128))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* fA = static_cast<float*>(dA);
  auto* fD = static_cast<float*>(dD);
  if (variant == 0) {
    const repro::BwdArgs a{x, static_cast<const float*>(dt), static_cast<const float*>(A), B, C,
                           static_cast<const float*>(D), static_cast<const float*>(init), dy, dx,
                           static_cast<float*>(ddt), static_cast<float*>(dbc_part),
                           static_cast<float*>(ad_part), static_cast<float*>(dinit), states, S, H,
                           P, repro::pad4(P), N, sx_b, sx_s, sdt_b, sdt_s, sB_b, sB_s, sC_b, sC_s};
    if (dtype == repro::kFloat32) return repro::launch<float>(a, fA, fD, dB, dC, batch, s);
    if (dtype == repro::kBFloat16) return repro::launch<__nv_bfloat16>(a, fA, fD, dB, dC, batch, s);
    return cudaErrorInvalidValue;
  }
  if (heads_per_group <= 0) return cudaErrorInvalidValue;
  const int nc = (S + repro::kT - 1) / repro::kT;
  const int groups = (H + heads_per_group - 1) / heads_per_group;
  const repro::ChunkArgs a{x, static_cast<const float*>(dt), static_cast<const float*>(A), B, C,
                           static_cast<const float*>(D), static_cast<const float*>(init), dy, dx,
                           static_cast<float*>(ddt), static_cast<float*>(dinit), states,
                           static_cast<float*>(dbc_part), static_cast<float*>(ad_part), batch, S,
                           H, P, N, nc, heads_per_group, groups, sx_b, sx_s, sdt_b, sdt_s, sB_b,
                           sB_s, sC_b, sC_s};
  if (variant == 2) {
    const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
    if (dtype != repro::kBFloat16 || P % 8 || (sx_b | sx_s | sB_b | sB_s | sC_b | sC_s) % 8 ||
        misaligned(x) || misaligned(B) || misaligned(C) || misaligned(dy))
      return cudaErrorInvalidValue;
    return repro::launch_chunked_mma(a, fA, fD, dB, dC, s);
  }
  if (variant != 1) return cudaErrorInvalidValue;
  if (dtype == repro::kFloat32) return repro::launch_chunked_fma<float>(a, fA, fD, dB, dC, s);
  if (dtype == repro::kBFloat16)
    return repro::launch_chunked_fma<__nv_bfloat16>(a, fA, fD, dB, dC, s);
  return cudaErrorInvalidValue;
}
