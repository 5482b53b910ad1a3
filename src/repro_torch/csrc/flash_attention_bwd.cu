// Flash attention backward for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention/ops.py, _pallas_attn_bwd, the
// jax.custom_vjp rule of flash_attention_fwd, which recomputes through
// ref.mha_reference. Computes dq, dk and dv, the VJP of the plain attention
// (repro_torch/kernels/flash_attention/ref.py, mha_reference): causal or not,
// sliding window, GQA (dk and dv sum over the G = H / KH query heads of each
// KV head), any Sq and Sk (causal: Sq <= Sk) with query i at absolute
// position Sk - Sq + i, D in {32, 64, 128}.
//
// Algorithm (FlashAttention-2's backward): the forward kernel saved each
// row's log-sum-exp L (flash_attention.cu, `lse`), so P = exp(s - L) is
// recomputed tile by tile and never stored, s the scaled score.
//   1. delta: D_i = sum_d dO_id O_id, D / 8 lanes per (b, query, head) row
//      in bf16.
//   2. dk/dv: one block per (key tile, part of a KV head's query heads, KV
//      head, b); it loops over the query tiles of its heads that can see
//      its keys: dP = dO V^T, dS = P (dP - D), dV += P^T dO,
//      dK += scale dS^T Q. Where a KV head's heads are split into parts,
//      each part's fp32 sums go to scratch and a second pass adds the parts
//      in a fixed order.
//   3. dq: one block per tile of (query, head) rows of one KV head; it loops
//      over the key tiles its rows can see: dQ += scale dS K.
// No atomics: every output is one block's sum, or a fixed-order sum of
// blocks' sums, so results repeat bit for bit.
//
// What bounds it on the H100: operations. Per head the backward does 10 D
// operations per (query, key) pair it keeps (s, dP, dV, dK, dQ), against 4 in
// the forward; this design recomputes s and dP in the dq kernel, 14 D. At
// qwen2-1.5b's training shape (B=4, S=512, H=12, KH=2, D=128, causal) 10 D
// is 8.1 GFLOP, 8.2 us on the bf16 tensor cores, while q, k, v, o, dO and
// the three gradients are 17 MB, 5 us at 3.35 TB/s.
//
// Design of the bf16 kernels (flash_bwd_dq_mma_kernel, _dkdv_mma_kernel):
// the products run on the tensor cores (mma.sync m16n8k16, operands from
// XOR-swizzled shared memory through ldmatrix, fp32 accumulators), as in the
// forward's flash_mma_kernel. What limits them is how many blocks keep the
// SMs busy, and registers:
// - The dk/dv kernel holds 64 keys (16 per warp) of one KV head and streams
//   tiles of 32 (query, head) rows of its part's heads, with their L and D,
//   through a 3-stage cp.async ring; it computes s^T = K Q^T and dP^T =
//   V dO^T with the keys as the rows, so P^T and dS^T are already the A
//   operands of dV and dK. One block for all G heads of a KV head left 64
//   blocks at qwen2's shape on 132 SMs, the first key tile streaming 3072
//   rows; the host's rule (ops.py dkdv_splits) splits the G heads into the
//   fewest parts that give every SM two blocks (qwen2: 6 parts, 384
//   blocks), and the partial sums cost 2 B KH parts Sk D fp32 written and
//   read once (25 MB at qwen2's shape, most of it from L2).
// - Both grids are 1-D and start with the heaviest blocks: under a causal
//   mask the first key tiles and the last query tiles see 8x the work of
//   the lightest at S = 512, so the long blocks start first and the short
//   ones fill in behind them.
// - At D = 128 the dk/dv kernel's two D-wide accumulators take 128
//   registers a thread: its D loop is unrolled by 2 and the block's
//   coordinates are re-read after the loop, or ptxas spills. The dq kernel
//   there takes K/V tiles of 32 keys and reads the queries' fragments from
//   shared memory at every tile (DqTiling), 64 keys and held fragments at
//   D <= 64.
// P and dS are rounded to bf16 for the products; s, P and dS stay fp32.
//
// The fp32 kernels (flash_bwd_dq_kernel, flash_bwd_dkdv_kernel, any dtype)
// follow the same split on the CUDA cores: tiles of 32 queries and 32 keys
// staged as fp32 in shared memory, fp32 FMA throughout (no TF32, so the
// reference's 1e-4 gradient check holds).
#include <climits>

#include "common.cuh"
#include "mma.cuh"

namespace repro {
namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------------------
// 1. D_i = sum_d dO_id O_id (fp32), stored (B, H, Sq) as the LSE is: a
// group of D / VEC lanes per (b, query, head) row, one 16-byte load of o and
// of dO each per lane, the group's sum by shuffles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int Sq, int H, int rows) {
  constexpr int VEC = 16 / sizeof(T), TPR = D / VEC, RPB = kThreads / TPR;
  static_assert(TPR <= 32 && 32 % TPR == 0, "a row's lanes lie in one warp");
  const int row = blockIdx.x * RPB + threadIdx.x / TPR, c = threadIdx.x % TPR;
  float a[VEC], b[VEC], acc = 0.f;
  if (row < rows) {
    unpack<T>(__ldg(reinterpret_cast<const uint4*>(o + size_t(row) * D) + c), a);
    unpack<T>(__ldg(reinterpret_cast<const uint4*>(dout + size_t(row) * D) + c), b);
#pragma unroll
    for (int x = 0; x < VEC; ++x) acc = fmaf(a[x], b[x], acc);
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && c == 0) {
    const int b_ = row / (Sq * H), qi = (row / H) % Sq, h = row % H;
    delta[(size_t(b_) * H + h) * Sq + qi] = acc;
  }
}

// ------------------------------------------------------------------------
// The CUDA-core kernels: 4 warps, tiles of kBT queries and kBT keys as fp32
// rows of pitch D + 1 (a lane reading row `lane` across d is conflict-free).
constexpr int kBT = 32;
constexpr int kRowsPerWarp = kBT / kWarps;

template <int D>
constexpr int fma_smem_bytes() {
  return 4 * (4 * kBT * (D + 1) + 2 * kBT * (kBT + 1) + 2 * kBT);
}

// Rows r0 .. r0 + kBT - 1 of a (row, stride) layout into a fp32 tile of pitch
// D + 1, times `scale`; rows at or past n read as zeros.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src, size_t base,
                                           size_t stride, int r0, int n, float scale) {
  for (int i = threadIdx.x; i < kBT * D; i += kThreads) {
    const int r = i / D, d = i % D, row = r0 + r;
    dst[r * (D + 1) + d] = row < n ? to_float<T>(src[base + size_t(row) * stride + d]) * scale : 0.f;
  }
}

// P and dS of the staged (kBT queries from q0) x (kBT keys from k0) tile:
// lane j takes key k0 + j, warp w rows w, w + 4, ...; qs holds the queries
// times the scale, so s sums in the forward kernel's order and P = exp(s - L)
// repeats its probabilities. A pair that is not kept, or a query or key that
// does not exist, has P = dS = 0.
template <int D>
__device__ __forceinline__ void probs_tile(const float* qs, const float* dos, const float* ks,
                                           const float* vs, const float* lse_s, const float* dl_s,
                                           float* ps, float* dss, int q0, int k0, int Sq, int Sk,
                                           int shift, int causal, int window) {
  constexpr int P = D + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float kd = ks[lane * P + d], vd = vs[lane * P + d];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      s[r] = fmaf(qs[(warp + kWarps * r) * P + d], kd, s[r]);
      dp[r] = fmaf(dos[(warp + kWarps * r) * P + d], vd, dp[r]);
    }
  }
  const int key = k0 + lane;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp + kWarps * r, qi = q0 + row, qpos = shift + qi;
    const bool keep = qi < Sq && key < Sk && (!causal || key <= qpos) &&
                      (window <= 0 || key > qpos - window);
    const float p = keep ? expf(s[r] - lse_s[row]) : 0.f;
    ps[row * (kBT + 1) + lane] = p;
    dss[row * (kBT + 1) + lane] = p * (dp[r] - dl_s[row]);
  }
}

// 2 (CUDA cores). Block (key tile, KV head kh, batch b); warp w owns keys
// w * 8 .. w * 8 + 7 of the tile, lane `lane` their columns lane + 32 c.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int Sq, int Sk, int H, int KH, int causal, int window, float scale) {
  constexpr int P = D + 1;
  extern __shared__ float fsm[];
  float* qs = fsm;
  float* dos = qs + kBT * P;
  float* ks = dos + kBT * P;
  float* vs = ks + kBT * P;
  float* ps = vs + kBT * P;
  float* dss = ps + kBT * (kBT + 1);
  float* lse_s = dss + kBT * (kBT + 1);
  float* dl_s = lse_s + kBT;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kBT, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH, shift = Sk - Sq;
  const size_t kv_base = (size_t(b) * Sk * KH + kh) * D, kv_stride = size_t(KH) * D;
  stage_rows<T, D>(ks, k, kv_base, kv_stride, k0, Sk, 1.f);
  stage_rows<T, D>(vs, v, kv_base, kv_stride, k0, Sk, 1.f);

  // Queries that can see a key of this tile.
  const int kmax = min(k0 + kBT, Sk) - 1;
  int i_lo = causal ? max(0, k0 - shift) : 0;
  const int i_hi = window > 0 ? min(Sq, kmax + window - shift) : Sq;
  i_lo -= i_lo % kBT;

  float acc_k[kRowsPerWarp][D / 32], acc_v[kRowsPerWarp][D / 32];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j)
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t q_base = (size_t(b) * Sq * H + h) * D, q_stride = size_t(H) * D;
    for (int q0 = i_lo; q0 < i_hi; q0 += kBT) {
      __syncthreads();                  // the previous tile is consumed
      stage_rows<T, D>(qs, q, q_base, q_stride, q0, Sq, scale);
      stage_rows<T, D>(dos, dout, q_base, q_stride, q0, Sq, 1.f);
      if (threadIdx.x < kBT) {
        const int qi = q0 + threadIdx.x;
        const size_t idx = (size_t(b) * H + h) * Sq + qi;
        lse_s[threadIdx.x] = qi < Sq ? lse[idx] : 0.f;
        dl_s[threadIdx.x] = qi < Sq ? delta[idx] : 0.f;
      }
      __syncthreads();
      probs_tile<D>(qs, dos, ks, vs, lse_s, dl_s, ps, dss, q0, k0, Sq, Sk, shift, causal, window);
      __syncthreads();
      for (int r = 0; r < kBT; ++r) {
        float qv[D / 32], ov[D / 32];
#pragma unroll
        for (int c = 0; c < D / 32; ++c) {
          qv[c] = qs[r * P + lane + 32 * c];
          ov[c] = dos[r * P + lane + 32 * c];
        }
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const float p = ps[r * (kBT + 1) + warp * kRowsPerWarp + j];
          const float ds = dss[r * (kBT + 1) + warp * kRowsPerWarp + j];
#pragma unroll
          for (int c = 0; c < D / 32; ++c) {
            acc_v[j][c] = fmaf(p, ov[c], acc_v[j][c]);
            acc_k[j][c] = fmaf(ds, qv[c], acc_k[j][c]);   // qs holds q * scale
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int key = k0 + warp * kRowsPerWarp + j;
    if (key >= Sk) continue;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      const size_t off = kv_base + size_t(key) * kv_stride + lane + 32 * c;
      dk[off] = from_float<T>(acc_k[j][c]);
      dv[off] = from_float<T>(acc_v[j][c]);
    }
  }
}

// 3 (CUDA cores). Block (query tile, head h, batch b); warp w owns queries
// w * 8 .. w * 8 + 7 of the tile, lane `lane` their columns lane + 32 c.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int H,
                    int KH, int causal, int window, float scale) {
  constexpr int P = D + 1;
  extern __shared__ float fsm[];
  float* qs = fsm;
  float* dos = qs + kBT * P;
  float* ks = dos + kBT * P;
  float* vs = ks + kBT * P;
  float* ps = vs + kBT * P;
  float* dss = ps + kBT * (kBT + 1);
  float* lse_s = dss + kBT * (kBT + 1);
  float* dl_s = lse_s + kBT;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH), shift = Sk - Sq;
  const size_t q_base = (size_t(b) * Sq * H + h) * D, q_stride = size_t(H) * D;
  const size_t kv_base = (size_t(b) * Sk * KH + kh) * D, kv_stride = size_t(KH) * D;
  stage_rows<T, D>(qs, q, q_base, q_stride, q0, Sq, scale);
  stage_rows<T, D>(dos, dout, q_base, q_stride, q0, Sq, 1.f);
  if (threadIdx.x < kBT) {
    const int qi = q0 + threadIdx.x;
    const size_t idx = (size_t(b) * H + h) * Sq + qi;
    lse_s[threadIdx.x] = qi < Sq ? lse[idx] : 0.f;
    dl_s[threadIdx.x] = qi < Sq ? delta[idx] : 0.f;
  }

  // Keys any query of this tile may attend.
  const int last = min(q0 + kBT, Sq) - 1;
  int lo = window > 0 ? max(0, shift + q0 - window + 1) : 0;
  const int hi = causal ? min(Sk, shift + last + 1) : Sk;
  lo -= lo % kBT;

  float acc[kRowsPerWarp][D / 32];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc[r][c] = 0.f;

  for (int k0 = lo; k0 < hi; k0 += kBT) {
    __syncthreads();                    // the previous tile is consumed
    stage_rows<T, D>(ks, k, kv_base, kv_stride, k0, Sk, 1.f);
    stage_rows<T, D>(vs, v, kv_base, kv_stride, k0, Sk, 1.f);
    __syncthreads();
    probs_tile<D>(qs, dos, ks, vs, lse_s, dl_s, ps, dss, q0, k0, Sq, Sk, shift, causal, window);
    __syncthreads();
    for (int j = 0; j < kBT; ++j) {
      float kv[D / 32];
#pragma unroll
      for (int c = 0; c < D / 32; ++c) kv[c] = ks[j * P + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float ds = dss[(warp * kRowsPerWarp + r) * (kBT + 1) + j];
#pragma unroll
        for (int c = 0; c < D / 32; ++c) acc[r][c] = fmaf(ds, kv[c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    if (qi >= Sq) continue;
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
      dq[q_base + size_t(qi) * q_stride + lane + 32 * c] = from_float<T>(acc[r][c] * scale);
  }
}

template <typename T, int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, int Sq, int Sk, int H, int KH, int causal, int window,
                       float scale, cudaStream_t s) {
  constexpr int smem = fma_smem_bytes<D>();
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v), *dop = static_cast<const T*>(dout);
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<T, D><<<cdiv(rows, kThreads / (D * int(sizeof(T)) / 16)), kThreads, 0, s>>>(
      static_cast<const T*>(o), dop, delta, Sq, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D><<<dim3(cdiv(Sk, kBT), KH, B), kThreads, smem, s>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KH,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<dim3(cdiv(Sq, kBT), H, B), kThreads, smem, s>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), Sq, Sk, H, KH, causal, window, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// The bf16 tensor-core kernels (see the note at the top). Fragments as in
// mma.cuh: g = lane / 4, qd = lane % 4; a thread holds rows g and g + 8 of
// each 16-row tile, columns 2 qd and 2 qd + 1 of each 8-column block.
constexpr int kFW = 4;                  // warps per block
constexpr int kNT = 32 * kFW;
constexpr int kBM = 16 * kFW;           // dq: (query, head) rows per block
constexpr int kKVStages = 2;            // dq: K/V tiles in the ring
constexpr int kKB = 16 * kFW;           // dk/dv: keys per block, 16 per warp
constexpr int kQT = 32;                 // dk/dv: (query, head) rows per staged tile
constexpr int kQStages = 3;             // dk/dv: row tiles in the ring

// dq's keys per K/V tile, and whether the queries' A fragments stay in
// registers across tiles: beside D-wide accumulators, s and dP of 64 keys
// and the held fragments spill at D = 128 (ptxas), so there the tile is 32
// keys and the fragments are read from shared memory at every tile.
template <int D> struct DqTiling {
  static constexpr int KT = D >= 128 ? 32 : 64;
  static constexpr bool kHoldQ = D < 128;
};
template <int D>
constexpr int dq_smem_bytes() { return (2 * kBM + 2 * kKVStages * DqTiling<D>::KT) * D * 2; }
template <int D>
constexpr int dkdv_smem_bytes() {
  return (2 * kKB + 2 * kQStages * kQT) * D * 2 + 2 * kQStages * kQT * 4;
}

// Block i of the 1-D grid, heaviest first: row tile cdiv(Sq G, kBM) - 1 -
// i / (KH B) (under a causal mask the last rows see the most keys), then KV
// head kh and batch b. Its rows R0 .. R0 + kBM - 1 of the Sq * G (query,
// head) pairs of kh, r = query * G + (h - kh * G), as in the forward's
// flash_mma_kernel.
template <int D>
__global__ void __launch_bounds__(kNT)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int B, int Sq, int Sk, int H, int KH, int causal,
                        int window, float scale) {
  constexpr int CH = D / 8, KT = DqTiling<D>::KT;       // 16-byte chunks per row
  constexpr bool kHoldQ = DqTiling<D>::kHoldQ;
  extern __shared__ __align__(128) unsigned char smem[];
  auto qs = reinterpret_cast<bf16*>(smem);              // [kBM][D]
  auto dos = qs + kBM * D;                              // [kBM][D]
  auto ks = dos + kBM * D;                              // [kKVStages][KT][D]
  auto vs = ks + kKVStages * KT * D;                    // [kKVStages][KT][D]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int G = H / KH, rows = Sq * G, shift = Sk - Sq;
  const int tiles = (rows + kBM - 1) / kBM, rest = blockIdx.x % (KH * B);
  const int kh = rest % KH, b = rest / KH;
  const int R0 = (tiles - 1 - blockIdx.x / (KH * B)) * kBM;
  const int qa = R0 / G, qb = (min(R0 + kBM, rows) - 1) / G;
  int lo = 0, hi = Sk;
  if (causal) hi = min(Sk, shift + qb + 1);
  if (window > 0) lo = max(0, shift + qa - window + 1);
  lo -= lo % KT;

  const size_t kv_base = (size_t(b) * Sk * KH + kh) * D, kv_stride = size_t(KH) * D;
  auto load_kv = [&](int t) {
    const int k0 = lo + t * KT;
    if (k0 >= hi) return;
    bf16* kt = ks + (t % kKVStages) * KT * D;
    bf16* vt = vs + (t % kKVStages) * KT * D;
    for (int i = tid; i < KT * CH; i += kNT) {
      const int r = i / CH, c = i % CH, key = k0 + r;
      const bool ok = key < Sk;
      const size_t off = ok ? kv_base + size_t(key) * kv_stride + 8 * c : 0;
      cp_async16(kt + swz<CH>(r, c), k + off, ok);
      cp_async16(vt + swz<CH>(r, c), v + off, ok);
    }
  };
  for (int i = tid; i < kBM * CH; i += kNT) {
    const int r = i / CH, c = i % CH, row = R0 + r;
    const bool ok = row < rows;
    const size_t off = ok ? ((size_t(b) * Sq + row / G) * H + kh * G + row % G) * D + 8 * c : 0;
    cp_async16(qs + swz<CH>(r, c), q + off, ok);
    cp_async16(dos + swz<CH>(r, c), dout + off, ok);
  }
  // Group i holds K/V tile i (group 0 the queries and dO too); one group per
  // tile even where nothing is left to load.
#pragma unroll
  for (int i = 0; i < kKVStages - 1; ++i) {
    load_kv(i);
    cp_async_commit();
  }

  // This thread's two rows: warp rows g and g + 8.
  int qpos0, qpos1;
  bool live0, live1;
  float lse0, lse1, dlt0, dlt1;
  {
    const int row0 = R0 + 16 * warp + g, row1 = row0 + 8;
    live0 = row0 < rows;
    live1 = row1 < rows;
    const size_t i0 = live0 ? (size_t(b) * H + kh * G + row0 % G) * Sq + row0 / G : 0;
    const size_t i1 = live1 ? (size_t(b) * H + kh * G + row1 % G) * Sq + row1 / G : 0;
    lse0 = live0 ? lse[i0] * kLog2e : 0.f;
    lse1 = live1 ? lse[i1] * kLog2e : 0.f;
    dlt0 = live0 ? delta[i0] : 0.f;
    dlt1 = live1 ? delta[i1] : 0.f;
    qpos0 = shift + row0 / G;
    qpos1 = shift + row1 / G;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;
  // The queries as A fragments, once (group 0 has landed), or from shared
  // memory at every tile.
  uint32_t qf[kHoldQ ? D / 16 : 1][4];
  if constexpr (kHoldQ) {
    cp_async_wait<kKVStages - 2>();
    __syncthreads();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      ldmatrix_x4(qf[kd], qs + swz<CH>(16 * warp + (lane & 15), 2 * kd + (lane >> 4)));
  }
  const float sl2 = scale * kLog2e;

  for (int it = 0, k0 = lo; k0 < hi; ++it, k0 += KT) {
    load_kv(it + kKVStages - 1);        // into the slot tile it - 1 left
    cp_async_commit();
    cp_async_wait<kKVStages - 1>();
    __syncthreads();
    const bf16* kt = ks + (it % kKVStages) * KT * D;
    const bf16* vt = vs + (it % kKVStages) * KT * D;

    // s = Q K^T and dP = dO V^T for this warp's 16 rows and the tile's keys.
    float s[KT / 8][4], dp[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[j][x] = dp[j][x] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t oa[4];
      ldmatrix_x4(oa, dos + swz<CH>(16 * warp + (lane & 15), 2 * kd + (lane >> 4)));
      if constexpr (!kHoldQ)
        ldmatrix_x4(qf[0], qs + swz<CH>(16 * warp + (lane & 15), 2 * kd + (lane >> 4)));
      const uint32_t (&qa)[4] = qf[kHoldQ ? kd : 0];
#pragma unroll
      for (int jj = 0; jj < KT / 16; ++jj) {
        uint32_t kb[4], vb[4];
        const int r = 16 * jj + (lane & 7) + ((lane >> 4) << 3), c = 2 * kd + ((lane >> 3) & 1);
        ldmatrix_x4(kb, kt + swz<CH>(r, c));
        ldmatrix_x4(vb, vt + swz<CH>(r, c));
        mma_bf16(s[2 * jj], qa, kb[0], kb[1]);
        mma_bf16(s[2 * jj + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[2 * jj], oa, vb[0], vb[1]);
        mma_bf16(dp[2 * jj + 1], oa, vb[2], vb[3]);
      }
    }

    // P = 2^(s * scale * log2(e) - L * log2(e)) where kept, then dS into s.
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int key = k0 + 8 * j + 2 * qd + x;
        const bool in = key < Sk;
        const bool keep0 = live0 && in && (!causal || key <= qpos0) &&
                           (window <= 0 || key > qpos0 - window);
        const bool keep1 = live1 && in && (!causal || key <= qpos1) &&
                           (window <= 0 || key > qpos1 - window);
        const float p0 = keep0 ? ex2(s[j][x] * sl2 - lse0) : 0.f;
        const float p1 = keep1 ? ex2(s[j][2 + x] * sl2 - lse1) : 0.f;
        s[j][x] = p0 * (dp[j][x] - dlt0);
        s[j][2 + x] = p1 * (dp[j][2 + x] - dlt1);
      }

    // dQ += dS K (dS rounded to bf16, K the transposed operand).
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, kt + swz<CH>(16 * kk + (lane & 15), 2 * dn + (lane >> 4)));
        mma_bf16(acc[2 * dn], pa, kb[0], kb[1]);
        mma_bf16(acc[2 * dn + 1], pa, kb[2], kb[3]);
      }
    }
    __syncthreads();                    // this slot is refilled by the next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!(h ? live1 : live0)) continue;
    const int row = R0 + 16 * warp + g + 8 * h;
    bf16* out = dq + ((size_t(b) * Sq + row / G) * H + kh * G + row % G) * D + 2 * qd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
  }
}

// Block i of the 1-D grid, heaviest first: key tile i / (NS KH B) of kKB
// keys (under a causal mask the first keys are seen by the most queries),
// then part p of NS, KV head kh and batch b. Warp w owns keys 16 w .. 16 w
// + 15 of the tile. The part's GP = G / NS query heads h0 .. h0 + GP - 1
// (h0 = kh G + p GP) stream through as (query, head) rows, r = query * GP +
// (h - h0), in tiles of kQT from the first query that can see the tile's
// first key. Per tile: s^T = K Q^T and dP^T = V dO^T in one pass over D
// (two of its steps unrolled: a full unroll spills at D = 128), P^T and
// dS^T = P^T (dP^T - D), then dV += P^T dO and dK += dS^T Q. With NS = 1 the block writes dk and dv; else its fp32 sums (dK not yet
// scaled) go to part[(b, kh, p)] and flash_bwd_dkdv_sum_kernel adds the
// parts.
template <int D>
__global__ void __launch_bounds__(kNT)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
                          int B, int Sq, int Sk, int H, int KH, int NS, int causal, int window,
                          float scale) {
  constexpr int CH = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  auto ks = reinterpret_cast<bf16*>(smem);              // [kKB][D]
  auto vs = ks + kKB * D;                               // [kKB][D]
  auto qs = vs + kKB * D;                               // [kQStages][kQT][D]
  auto dos = qs + kQStages * kQT * D;                   // [kQStages][kQT][D]
  auto ls = reinterpret_cast<float*>(dos + kQStages * kQT * D);   // [kQStages][kQT] L
  auto dls = ls + kQStages * kQT;                       // [kQStages][kQT] D

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int G = H / KH, GP = G / NS, rest = blockIdx.x % (NS * KH * B);
  const int p = rest % NS, kh = (rest / NS) % KH, b = rest / (NS * KH);
  const int k0 = blockIdx.x / (NS * KH * B) * kKB, h0 = kh * G + p * GP;
  const int rows = Sq * GP, shift = Sk - Sq;
  const size_t kv_base = (size_t(b) * Sk * KH + kh) * D, kv_stride = size_t(KH) * D;
  for (int i = tid; i < kKB * CH; i += kNT) {
    const int r = i / CH, c = i % CH, key = k0 + r;
    const bool ok = key < Sk;
    const size_t off = ok ? kv_base + size_t(key) * kv_stride + 8 * c : 0;
    cp_async16(ks + swz<CH>(r, c), k + off, ok);
    cp_async16(vs + swz<CH>(r, c), v + off, ok);
  }

  // The (query, head) rows that can see a key of this tile.
  const int kmax = min(k0 + kKB, Sk) - 1;
  const int i_lo = causal ? max(0, k0 - shift) : 0;
  const int i_hi = window > 0 ? min(Sq, kmax + window - shift) : Sq;
  const int r_lo = i_lo * GP - (i_lo * GP) % kQT;
  const int r_hi = i_hi > i_lo ? i_hi * GP : r_lo;
  auto load_q = [&](int t) {
    const int R = r_lo + t * kQT;
    if (R >= r_hi) return;
    bf16* qt = qs + (t % kQStages) * kQT * D;
    bf16* ot = dos + (t % kQStages) * kQT * D;
    for (int i = tid; i < kQT * CH; i += kNT) {
      const int r = i / CH, c = i % CH, row = R + r;
      const bool ok = row < rows;
      const size_t off = ok ? ((size_t(b) * Sq + row / GP) * H + h0 + row % GP) * D + 8 * c : 0;
      cp_async16(qt + swz<CH>(r, c), q + off, ok);
      cp_async16(ot + swz<CH>(r, c), dout + off, ok);
    }
    for (int i = tid; i < kQT; i += kNT) {
      const int row = R + i;
      const bool ok = row < rows;
      const size_t idx = ok ? (size_t(b) * H + h0 + row % GP) * Sq + row / GP : 0;
      cp_async4(ls + (t % kQStages) * kQT + i, lse + idx, ok);
      cp_async4(dls + (t % kQStages) * kQT + i, delta + idx, ok);
    }
  };
  // Group i holds row tile i (group 0 the keys and values too).
#pragma unroll
  for (int i = 0; i < kQStages - 1; ++i) {
    load_q(i);
    cp_async_commit();
  }

  const int key0 = k0 + 16 * warp + g, key1 = key0 + 8;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) dka[j][x] = dva[j][x] = 0.f;
  const float sl2 = scale * kLog2e;

  // acc += t^T Z, t rounded to bf16, Z (dO or Q) the transposed operand.
  auto accumulate = [&](float (&acc)[D / 8][4], const float (&t)[kQT / 8][4], const bf16* zs) {
#pragma unroll
    for (int kk = 0; kk < kQT / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(t[2 * kk][0], t[2 * kk][1]),
                              pack_bf16(t[2 * kk][2], t[2 * kk][3]),
                              pack_bf16(t[2 * kk + 1][0], t[2 * kk + 1][1]),
                              pack_bf16(t[2 * kk + 1][2], t[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, zs + swz<CH>(16 * kk + (lane & 15), 2 * dn + (lane >> 4)));
        mma_bf16(acc[2 * dn], pa, bb[0], bb[1]);
        mma_bf16(acc[2 * dn + 1], pa, bb[2], bb[3]);
      }
    }
  };

  for (int it = 0, R = r_lo; R < r_hi; ++it, R += kQT) {
    load_q(it + kQStages - 1);
    cp_async_commit();
    cp_async_wait<kQStages - 1>();
    __syncthreads();
    const bf16* qt = qs + (it % kQStages) * kQT * D;
    const bf16* ot = dos + (it % kQStages) * kQT * D;
    const float* lt = ls + (it % kQStages) * kQT;
    const float* dt = dls + (it % kQStages) * kQT;

    // s^T = K Q^T and dP^T = V dO^T in one pass over D.
    float pt[kQT / 8][4], dst[kQT / 8][4];
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) pt[j][x] = dst[j][x] = 0.f;
#pragma unroll 2
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, ks + swz<CH>(16 * warp + (lane & 15), 2 * kd + (lane >> 4)));
      ldmatrix_x4(va, vs + swz<CH>(16 * warp + (lane & 15), 2 * kd + (lane >> 4)));
#pragma unroll
      for (int jj = 0; jj < kQT / 16; ++jj) {
        uint32_t qb[4], ob[4];
        const int r = 16 * jj + (lane & 7) + ((lane >> 4) << 3), c = 2 * kd + ((lane >> 3) & 1);
        ldmatrix_x4(qb, qt + swz<CH>(r, c));
        ldmatrix_x4(ob, ot + swz<CH>(r, c));
        mma_bf16(pt[2 * jj], ka, qb[0], qb[1]);
        mma_bf16(pt[2 * jj + 1], ka, qb[2], qb[3]);
        mma_bf16(dst[2 * jj], va, ob[0], ob[1]);
        mma_bf16(dst[2 * jj + 1], va, ob[2], ob[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int n = 8 * j + 2 * qd + x, row = R + n, qpos = shift + row / GP;
        const float l2 = lt[n] * kLog2e, dl = dt[n];
        const bool in = row < rows;
        const bool keep0 = in && key0 < Sk && (!causal || key0 <= qpos) &&
                           (window <= 0 || key0 > qpos - window);
        const bool keep1 = in && key1 < Sk && (!causal || key1 <= qpos) &&
                           (window <= 0 || key1 > qpos - window);
        const float p0 = keep0 ? ex2(pt[j][x] * sl2 - l2) : 0.f;
        const float p1 = keep1 ? ex2(pt[j][2 + x] * sl2 - l2) : 0.f;
        dst[j][x] = p0 * (dst[j][x] - dl);
        dst[j][2 + x] = p1 * (dst[j][2 + x] - dl);
        pt[j][x] = p0;
        pt[j][2 + x] = p1;
      }
    accumulate(dva, pt, ot);
    accumulate(dka, dst, qt);
    __syncthreads();                    // this slot is refilled by the next iteration
  }
  cp_async_wait<0>();                   // no row tile: the keys' copy is still owed

  // The block's coordinates again, from a fresh read of its index, so that
  // they hold no registers through the loop (at D = 128 the accumulators
  // leave none to spare: ptxas spilled).
  unsigned bx;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bx));
  {
    const int rest = bx % (NS * KH * B);
    const int p = rest % NS, kh = (rest / NS) % KH, b = rest / (NS * KH);
    const int key0 = bx / (NS * KH * B) * kKB + 16 * warp + g, key1 = key0 + 8;
    const size_t kv_base = (size_t(b) * Sk * KH + kh) * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = h ? key1 : key0;
      if (key >= Sk) continue;
      if (NS == 1) {
        const size_t off = kv_base + size_t(key) * kv_stride + 2 * qd;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
              pack_bf16(dka[j][2 * h] * scale, dka[j][2 * h + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + off + 8 * j) = pack_bf16(dva[j][2 * h], dva[j][2 * h + 1]);
        }
      } else {
        const size_t half = size_t(B) * KH * NS * Sk * D;
        float* pk = part + ((size_t(b) * KH + kh) * NS * Sk + size_t(p) * Sk + key) * D + 2 * qd;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<float2*>(pk + 8 * j) = make_float2(dka[j][2 * h], dka[j][2 * h + 1]);
          *reinterpret_cast<float2*>(pk + half + 8 * j) = make_float2(dva[j][2 * h], dva[j][2 * h + 1]);
        }
      }
    }
  }
}

// dk = scale * (sum of the NS parts' dK) and dv = sum of their dV, the parts
// added in order p = 0 .. NS - 1: four columns of one (b, key, KV head) row
// per thread.
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int B, int Sk, int KH, int NS, int D,
                          float scale) {
  const size_t n4 = size_t(B) * Sk * KH * D / 4, half = size_t(B) * KH * NS * Sk * D;
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += size_t(gridDim.x) * blockDim.x) {
    const size_t e = 4 * i;                             // element of dk (B, Sk, KH, D)
    const int c = int(e % D), kh = int(e / D % KH), key = int(e / D / KH % Sk);
    const int b = int(e / (size_t(D) * KH * Sk));
    const float* pk = part + ((size_t(b) * KH + kh) * NS * Sk + key) * D + c;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int p = 0; p < NS; ++p) {
      const float4 a = *reinterpret_cast<const float4*>(pk + size_t(p) * Sk * D);
      const float4 o = *reinterpret_cast<const float4*>(pk + half + size_t(p) * Sk * D);
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += o.x; sv.y += o.y; sv.z += o.z; sv.w += o.w;
    }
    *reinterpret_cast<uint2*>(dk + e) = make_uint2(pack_bf16(sk.x * scale, sk.y * scale),
                                                   pack_bf16(sk.z * scale, sk.w * scale));
    *reinterpret_cast<uint2*>(dv + e) = make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, float* part, int B, int Sq, int Sk, int H, int KH, int NS,
                       int causal, int window, float scale, cudaStream_t s) {
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkdv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkdv_smem_bytes<D>());
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem_bytes<D>());
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *dop = static_cast<const bf16*>(dout);
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<bf16, D><<<cdiv(rows, kThreads / (D / 8)), kThreads, 0, s>>>(
      static_cast<const bf16*>(o), dop, delta, Sq, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long kv_blocks = (long long)cdiv(Sk, kKB) * NS * KH * B;
  const long long q_blocks = (long long)cdiv(Sq * (H / KH), kBM) * KH * B;
  if (kv_blocks > INT_MAX || q_blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_bwd_dkdv_mma_kernel<D><<<int(kv_blocks), kNT, dkdv_smem_bytes<D>(), s>>>(
      qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), part, B, Sq,
      Sk, H, KH, NS, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (NS > 1) {
    const size_t n4 = size_t(B) * Sk * KH * D / 4;
    const int grid = int(n4 / 256 + 1 < 65536 ? n4 / 256 + 1 : 65536);
    flash_bwd_dkdv_sum_kernel<<<grid, 256, 0, s>>>(part, static_cast<bf16*>(dk),
                                                    static_cast<bf16*>(dv), B, Sk, KH, NS, D,
                                                    scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dq_mma_kernel<D><<<int(q_blocks), kNT, dq_smem_bytes<D>(), s>>>(
      qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dq), B, Sq, Sk, H, KH, causal, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fma(int D, const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* delta, void* dq, void* dk,
                         void* dv, int B, int Sq, int Sk, int H, int KH, int causal, int window,
                         float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch_fma<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KH, causal, window, scale, s);
    case 64: return launch_fma<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KH, causal, window, scale, s);
    case 128: return launch_fma<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KH, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// q, o, dout, dq (B,Sq,H,D); k, v, dk, dv (B,Sk,KH,D): contiguous, of one
// dtype (repro::DType); lse (B,H,Sq) fp32 from the forward kernel; delta
// (B,H,Sq) fp32 scratch. Causal needs Sq <= Sk (every query keeps a key).
// variant 0 is the CUDA-core kernels (either dtype), variant 1 the bf16
// tensor-core kernels, whose dk/dv kernel splits each KV head's G query
// heads into `splits` parts (a divisor of G); with splits > 1, `part` is
// fp32 scratch of 2 * B * KH * splits * Sk * D elements. Launches the
// kernels on `stream` of `device` and returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const float* lse,
                                         float* delta, void* dq, void* dk, void* dv, float* part,
                                         int B, int Sq, int Sk, int H, int KH, int D, int dtype,
                                         int causal, int window, float scale, int variant,
                                         int splits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || H % KH || (causal && Sq > Sk) || B > 65535 ||
      H > 65535 || size_t(B) * Sq * H > INT_MAX)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != repro::kBFloat16 || splits <= 0 || (H / KH) % splits ||
        (splits > 1 && part == nullptr))
      return cudaErrorInvalidValue;
    switch (D) {
      case 32: return repro::launch_mma<32>(q, k, v, o, dout, lse, delta, dq, dk, dv, part, B, Sq, Sk, H, KH, splits, causal, window, scale, s);
      case 64: return repro::launch_mma<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, part, B, Sq, Sk, H, KH, splits, causal, window, scale, s);
      case 128: return repro::launch_mma<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, part, B, Sq, Sk, H, KH, splits, causal, window, scale, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (variant != 0) return cudaErrorInvalidValue;
  if (dtype == repro::kFloat32)
    return repro::dispatch_fma<float>(D, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KH, causal, window, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch_fma<__nv_bfloat16>(D, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KH, causal, window, scale, s);
  return cudaErrorInvalidValue;
}
