// Flash attention forward (prefill) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, flash_attention_fwd
// (body _flash_fwd_kernel). Online-softmax GQA attention; query head h reads
// KV head h / (H / KH); suffix-aligned causal mask (query i sits at absolute
// position Sk - Sq + i); optional sliding window (keys k > q - window); fp32
// accumulation; output divided by (l + 1e-30). Unlike the TPU kernel it
// reads q (B,Sq,H,D) and k/v (B,Sk,KH,D) in place, with no transposes, and
// masks ragged tails, so any Sq and Sk work (Sq != Sk without causality too).
//
// What bounds it on the H100: at the 64-token bucket (qwen2-1.5b: H=12,
// KH=2, D=128) one causal call is 13 MFLOP and 0.5 MB: nanoseconds of
// tensor-core and HBM time, far below a launch, so latency bounds it: the
// chain of dependent loads and products in one block. At long prompts the
// operations grow with S^2 (12.9 GFLOP at S=2048, 13 us on the tensor cores
// but 190 us or more as fp32 FMA on the CUDA cores): there the tensor cores
// bound it.
//
// Design of the bf16 kernel (flash_mma_kernel):
// - QK^T and P.V run on the tensor cores (mma.sync m16n8k16, operands from
//   shared memory through ldmatrix), with fp32 accumulators in registers and
//   the online softmax on the accumulator fragments. bf16 products are exact
//   in fp32; the scale is applied to the fp32 scores; P is rounded to bf16
//   for P.V, the one rounding the CUDA-core kernel does not make.
// - One block serves all G = H / KH query heads of one KV head: its rows are
//   (query, head) pairs of G consecutive heads, 16 rows per warp, so each
//   K/V tile is loaded once for G heads (G = 6 for qwen2, 3 for granite).
// - K/V stay bf16 in shared memory (XOR-swizzled, conflict-free ldmatrix),
//   staged by cp.async 64 keys at a time, double-buffered: the next tile is
//   in flight while this one is computed. KV tiles wholly above the causal
//   diagonal or below the window are never loaded, and the row tiles with
//   the most keys start first.
// - 4 warps per block at every length. Fewer warps (more blocks, to fill
//   the card at short buckets) won at most 0.6 us at S=64, where latency
//   bounds the call, and lost up to 2.3x at S=2048; chip_variants.py times
//   these and the other tilings.
//
// The fp32 variant is the earlier kernel (flash_fwd_kernel): one block of 128
// threads per (batch, head, 16-query tile), keys staged 32 at a time as fp32
// through shared memory, all arithmetic fp32 FMA on the CUDA cores (no TF32,
// so the fp32 sweeps' 2e-5 holds) with the next tile's 16-byte loads in
// flight (common.cuh, RowStager / attend_range).
#include "common.cuh"
#include "mma.cuh"

namespace repro {
namespace {

constexpr int kRows = 4;               // query rows per warp
constexpr int kBQ = kWarps * kRows;    // query rows per block

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Sk, int H, int KH, int causal, int window, float scale) {
  __shared__ float sq[kBQ][D];
  __shared__ KVTile<D> tile;
  __shared__ float sp[kWarps][kRows][kBK];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int shift = Sk - Sq;            // suffix alignment of the queries

  RowStager<T, kBQ, D> qs;
  qs.fetch(q, ((size_t(b) * Sq + q0) * H + h) * D, size_t(H) * D, Sq - q0);

  // Keys any row of this block may attend (causal / window tile pruning).
  const int last = min(q0 + kBQ, Sq) - 1;
  int lo = 0, hi = Sk;
  if (causal) hi = min(Sk, shift + last + 1);
  if (window > 0) lo = max(0, shift + q0 - window + 1);
  lo -= lo % kBK;

  float m[kRows], l[kRows], acc[kRows][D / 32];
  init_state<kRows, D>(m, l, acc);
  const int row0 = q0 + warp * kRows;
  attend_range<T, D, kRows>(
      sq + warp * kRows, tile, sp[warp], k, v, (size_t(b) * Sk * KH + kh) * D,
      size_t(KH) * D, lo, hi, Sk,
      [&] { qs.template store<D>(&sq[0][0], Sq - q0, scale); },
      [&](int r, int key) {
        const int qpos = shift + row0 + r;
        return (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
      },
      m, l, acc);

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row >= Sq) continue;
    if (lse != nullptr && lane == 0) lse[(size_t(b) * H + h) * Sq + row] = m[r] + logf(l[r]);
    T* out = o + ((size_t(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
      out[lane + 32 * c] = from_float<T>(acc[r][c] / (l[r] + 1e-30f));
  }
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
                     int B, int Sq, int Sk, int H, int KH, int D, int causal, int window,
                     float scale, cudaStream_t stream) {
  const dim3 grid(cdiv(Sq, kBQ), H, B);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (D) {
    case 32:
      flash_fwd_kernel<T, 32><<<grid, kThreads, 0, stream>>>(qp, kp, vp, op, lse, Sq, Sk, H, KH, causal, window, scale);
      break;
    case 64:
      flash_fwd_kernel<T, 64><<<grid, kThreads, 0, stream>>>(qp, kp, vp, op, lse, Sq, Sk, H, KH, causal, window, scale);
      break;
    case 128:
      flash_fwd_kernel<T, 128><<<grid, kThreads, 0, stream>>>(qp, kp, vp, op, lse, Sq, Sk, H, KH, causal, window, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// The bf16 tensor-core kernel (see the note at the top).
constexpr int kFW = 4;                  // warps per block, 16 (query, head) rows each
constexpr int kBM = 16 * kFW;           // rows per block
constexpr int kKT = 64;                 // keys per K/V tile
constexpr int kKVStages = 2;            // K/V tiles in the ring

template <int D>
constexpr int mma_smem_bytes() { return (kBM + 2 * kKVStages * kKT) * D * 2; }   // Q, K, V

// Block (row tile, KV head kh, batch b): rows r = R0 .. R0 + kBM - 1 of the
// Sq * G (query, head) pairs of kh, r = query * G + (h - kh * G).
template <int D>
__global__ void __launch_bounds__(32 * kFW)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KH, int causal, int window,
                 float scale) {
  constexpr int CH = D / 8, NT = 32 * kFW;              // CH: 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  auto qs = reinterpret_cast<__nv_bfloat16*>(smem);     // [kBM][D]
  auto ks = qs + kBM * D;                               // [kKVStages][kKT][D]
  auto vs = ks + kKVStages * kKT * D;                   // [kKVStages][kKT][D]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int G = H / KH, kh = blockIdx.y, b = blockIdx.z;
  // The last row tiles see the most keys under a causal mask: they start
  // first, so that the short ones fill the tail.
  const int R0 = (gridDim.x - 1 - blockIdx.x) * kBM, rows = Sq * G, shift = Sk - Sq;
  const int qa = R0 / G, qb = (min(R0 + kBM, rows) - 1) / G;   // the block's queries
  // Keys any row of this block may attend (causal / window tile pruning).
  int lo = 0, hi = Sk;
  if (causal) hi = min(Sk, shift + qb + 1);
  if (window > 0) lo = max(0, shift + qa - window + 1);
  lo -= lo % kKT;

  const size_t kv_base = (size_t(b) * Sk * KH + kh) * D, kv_stride = size_t(KH) * D;
  // Tile i of the block's range into its slot of the ring (nothing past hi).
  auto load_kv = [&](int t) {
    const int k0 = lo + t * kKT;
    if (k0 >= hi) return;
    __nv_bfloat16* kt = ks + (t % kKVStages) * kKT * D;
    __nv_bfloat16* vt = vs + (t % kKVStages) * kKT * D;
    for (int i = tid; i < kKT * CH; i += NT) {
      const int r = i / CH, c = i % CH, key = k0 + r;
      const bool ok = key < Sk;
      const size_t off = ok ? kv_base + size_t(key) * kv_stride + 8 * c : 0;
      cp_async16(kt + swz<CH>(r, c), k + off, ok);
      cp_async16(vt + swz<CH>(r, c), v + off, ok);
    }
  };
  for (int i = tid; i < kBM * CH; i += NT) {
    const int r = i / CH, c = i % CH, row = R0 + r;
    const bool ok = row < rows;
    const int qi = row / G, h = kh * G + row % G;
    const size_t off = ok ? ((size_t(b) * Sq + qi) * H + h) * D + 8 * c : 0;
    cp_async16(qs + swz<CH>(r, c), q + off, ok);
  }
  // Group i holds tile i (group 0 the queries too); one group is committed
  // per tile even where there is nothing left to load, so that waiting for
  // all but the newest kKVStages - 1 groups always means tile i has landed.
#pragma unroll
  for (int i = 0; i < kKVStages - 1; ++i) {
    load_kv(i);
    cp_async_commit();
  }

  // This thread's two rows: warp rows g and g + 8. Every tile holds a key
  // below Sk, so each row's tile maximum is finite and m leaves -inf at the
  // first tile.
  const float inf = __uint_as_float(0x7f800000u);
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qpos[h] = shift + (R0 + 16 * warp + g + 8 * h) / G;
  float m[2] = {-inf, -inf}, l[2] = {0.f, 0.f}, acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;
  uint32_t qf[D / 16][4];
  const float sl2 = scale * kLog2e;

  for (int it = 0, k0 = lo; k0 < hi; ++it, k0 += kKT) {
    load_kv(it + kKVStages - 1);        // into the slot tile it - 1 left
    cp_async_commit();
    cp_async_wait<kKVStages - 1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        ldmatrix_x4(qf[kd], qs + swz<CH>(16 * warp + (lane & 15), 2 * kd + (lane >> 4)));
    }
    const __nv_bfloat16* kt = ks + (it % kKVStages) * kKT * D;
    const __nv_bfloat16* vt = vs + (it % kKVStages) * kKT * D;

    // Scores of this warp's 16 rows against the tile's keys.
    float s[kKT / 8][4];
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[j][x] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
#pragma unroll
      for (int jj = 0; jj < kKT / 16; ++jj) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + swz<CH>(16 * jj + (lane & 7) + ((lane >> 4) << 3),
                                     2 * kd + ((lane >> 3) & 1)));
        mma_bf16(s[2 * jj], qf[kd], kf[0], kf[1]);
        mma_bf16(s[2 * jj + 1], qf[kd], kf[2], kf[3]);
      }

    // Online softmax on the fragments, in base 2: x = score * scale * log2(e).
    // A key that is not kept scores kNegInf (as in the plain version); a key
    // past Sk does not exist and weighs exactly zero.
    const bool edge = k0 + kKT > Sk || (causal && k0 + kKT - 1 > shift + qa) ||
                      (window > 0 && k0 <= shift + qb - window);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -inf;
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float& e = s[j][2 * h + x];
          e *= sl2;
          if (edge) {
            const int key = k0 + 8 * j + 2 * qd + x;
            const bool keep = (!causal || key <= qpos[h]) && (window <= 0 || key > qpos[h] - window);
            e = key >= Sk ? -inf : keep ? e : kNegInf;
          }
          mx = fmaxf(mx, e);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(m[h], mx);
      const float alpha = ex2(m[h] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float& e = s[j][2 * h + x];
          e = ex2(e - mx);              // exactly 0 for a key past Sk
          sum += e;
        }
      l[h] = l[h] * alpha + sum;
      m[h] = mx;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * h] *= alpha;
        acc[j][2 * h + 1] *= alpha;
      }
    }

    // P (rounded to bf16) times the tile's values.
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + swz<CH>(16 * kk + (lane & 15), 2 * dn + (lane >> 4)));
        mma_bf16(acc[2 * dn], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dn + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();                    // this slot is refilled by the next iteration
  }
  cp_async_wait<0>();                   // no tile: the queries' copy is still owed

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = R0 + 16 * warp + g + 8 * h;
    if (row >= rows) continue;
    // m is in base-2 units of the scaled scores (uniform over the quad)
    if (lse != nullptr && qd == 0)
      lse[(size_t(b) * H + kh * G + row % G) * Sq + row / G] = (m[h] + log2f(sum)) * kLn2;
    const float inv = 1.f / (sum + 1e-30f);
    __nv_bfloat16* out = o + ((size_t(b) * Sq + row / G) * H + kh * G + row % G) * D + 2 * qd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int Sq, int Sk, int H, int KH, int causal, int window, float scale,
                       cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(cdiv(Sq * (H / KH), kBM), KH, B);
  flash_mma_kernel<D><<<grid, 32 * kFW, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H,
      KH, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q (B,Sq,H,D), k/v (B,Sk,KH,D), o (B,Sq,H,D), all contiguous and of one
// dtype (repro::DType); lse (B,H,Sq) fp32 or null: where given, each row's
// log-sum-exp of its kept scaled scores (natural log), which the backward
// (flash_attention_bwd.cu) recomputes P from. variant 0 is the CUDA-core
// kernel (either dtype), variant 1 the bf16 tensor-core kernel. Launches on
// `stream` of `device` and returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, float* lse, int B, int Sq, int Sk, int H, int KH,
                                     int D, int dtype, int causal, int window,
                                     float scale, int variant, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != repro::kBFloat16 || size_t(Sq) * (H / KH) > 0x7fffffff)
      return cudaErrorInvalidValue;
    switch (D) {
      case 32: return repro::launch_mma<32>(q, k, v, o, lse, B, Sq, Sk, H, KH, causal, window, scale, s);
      case 64: return repro::launch_mma<64>(q, k, v, o, lse, B, Sq, Sk, H, KH, causal, window, scale, s);
      case 128: return repro::launch_mma<128>(q, k, v, o, lse, B, Sq, Sk, H, KH, causal, window, scale, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (variant != 0) return cudaErrorInvalidValue;
  if (dtype == repro::kFloat32)
    return repro::dispatch<float>(q, k, v, o, lse, B, Sq, Sk, H, KH, D, causal, window, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, H, KH, D, causal, window, scale, s);
  return cudaErrorInvalidValue;
}
