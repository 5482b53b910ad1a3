// Decode attention (one query token per sequence over a padded KV cache)
// for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
// decode_attention_pallas (body _decode_kernel). q (B,H,D) against k/v
// caches (B,Smax,KH,D) with per-sequence lengths (B,) int32: key positions
// below the length attend, optionally only the last `window` of them; the
// G = H/KH query heads of one KV head share every KV tile loaded; fp32
// accumulation; output divided by (l + 1e-30). Unlike the TPU kernel it
// takes any Smax (Whisper's 1500-frame cross cache too), reads the caches
// in place with no transposes, and stops at min(length, Smax): an idle
// serving slot's length keeps growing past Smax, and nothing past the
// cache is ever read.
//
// What bounds it on the H100: HBM. Per call it must read the live cache,
// 2 * sum(len) * KH * D * sizeof(T) bytes, against 4 * sum(len) * H * D
// operations -- about one operation per byte. At a long cache (Smax 4096,
// B 8) that is 34-268 MB, 10-80 us at 3.35 TB/s; at the serving path's
// shapes well under a microsecond, where latency bounds it.
//
// Design of the bf16 kernel (decode_split_kernel), split-KV:
// - The grid is (split, KV head, sequence). Each split takes a contiguous
//   span of whole 64-key units of the cache; the host picks the number of
//   splits from B, KH and Smax alone (never from the lengths, which live on
//   the device): enough that B * KH * splits covers the SMs, but never a
//   span under 4 units (256 keys), below which a split's fixed costs (the
//   queries, the merges, the combine) outweigh what it saves
//   (chip_variants.py at granite-moe-3b-a800m's serving cache, B = 8,
//   Smax = 256: 8.2 us in one split, 10.8 in two, 11.1 in four). So the
//   serving path takes one split and no combine. A block whose span
//   holds no live key (past min(len, Smax), or below the window) loads
//   nothing and reports m = -1e30, l = 0: weight zero in the combine.
// - K/V stay bf16 in shared memory (XOR-swizzled, conflict-free
//   ldmatrix), staged kDT keys at a time by cp.async in a ring of kDStages
//   tiles. With a span of one tile, every load is issued before the first
//   wait.
// - Scores and P.V run on the tensor cores (mma.sync m16n8k16, bf16
//   operands, fp32 sums), the G <= 16 query heads of the KV head as the
//   rows of one 16-row tile; each of the 4 warps takes 16 keys of every
//   64-key tile, so all warps work at any G. The work is about one
//   operation per byte, so the tensor cores buy no rate here: they cut the
//   instructions, which bound a block's chain of latencies. The first
//   version's fp32 FMA inner loop, about 1650 instructions per 16 keys at
//   G = 6, D = 128 by a count of its source, took 43.2 us at qwen2-1.5b's
//   heads, B = 1, Smax = 4096, where SDPA takes 22.2 (chip_variants.py,
//   chip_smoke.py). P is rounded to bf16 for P.V, as in flash; the scale
//   is applied to the fp32 scores.
//   The warps' (m, l, acc) merge in shared memory in a fixed order.
// - The splits of one (sequence, KV head) combine inside the same launch,
//   in split order, so results repeat bit for bit: each block writes its
//   (m, l, acc) to a workspace, and the last block to finish (an atomic
//   counter, which that block resets to zero) merges them, one warp per
//   query head forming the splits' weights. chip_variants.py times the
//   split counts, tile depths and ring depths.
//
// The fp32 variant, and the bf16 `before` time in chip_smoke.py, is the
// earlier kernel (decode_kernel): one block of 128 threads per (KV head,
// sequence), keys staged 32 at a time through shared memory as fp32, the
// next tile's loads in flight, all arithmetic fp32 FMA (so the fp32
// sweeps' 2e-5 holds). Only B * KH blocks run, each streaming its cache
// tile after tile: one block's chain of memory latencies bounds it.
#include "common.cuh"
#include "mma.cuh"

namespace repro {
namespace {

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lengths,
              T* __restrict__ o, int Smax, int H, int KH, int window, float scale) {
  __shared__ float sq[kWarps * R][D];
  __shared__ KVTile<D> tile;
  __shared__ float sp[kWarps][R][kBK];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / KH;
  const size_t q_base = (size_t(b) * H + size_t(kh) * G) * D;  // head kh*G of seq b

  const int length = lengths[b];
  RowStager<T, kWarps * R, D> qs;
  qs.fetch(q, q_base, D, G);

  const int n = min(length, Smax);      // positions past the cache hold nothing
  int lo = window > 0 ? max(0, length - window) : 0;
  lo -= lo % kBK;

  float m[R], l[R], acc[R][D / 32];
  init_state<R, D>(m, l, acc);
  attend_range<T, D, R>(
      sq + warp * R, tile, sp[warp], kc, vc, (size_t(b) * Smax * KH + kh) * D,
      size_t(KH) * D, lo, n, n,
      [&] { qs.template store<D>(&sq[0][0], G, scale); },
      [&](int, int key) { return window <= 0 || key > length - 1 - window; },
      m, l, acc);

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = warp * R + r;
    if (g >= G) continue;
    T* out = o + q_base + size_t(g) * D;
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
      out[lane + 32 * c] = from_float<T>(acc[r][c] / (l[r] + 1e-30f));
  }
}

template <typename T, int D>
cudaError_t dispatch_rows(const T* q, const T* kc, const T* vc, const int* len,
                          T* o, int B, int Smax, int H, int KH, int window,
                          float scale, cudaStream_t stream) {
  const dim3 grid(KH, B);
  const int G = H / KH;
  if (G <= kWarps)
    decode_kernel<T, D, 1><<<grid, kThreads, 0, stream>>>(q, kc, vc, len, o, Smax, H, KH, window, scale);
  else if (G <= 2 * kWarps)
    decode_kernel<T, D, 2><<<grid, kThreads, 0, stream>>>(q, kc, vc, len, o, Smax, H, KH, window, scale);
  else if (G <= 4 * kWarps)
    decode_kernel<T, D, 4><<<grid, kThreads, 0, stream>>>(q, kc, vc, len, o, Smax, H, KH, window, scale);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* kc, const void* vc, const int* len,
                     void* o, int B, int Smax, int H, int KH, int D, int window,
                     float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(kc);
  const T* vp = static_cast<const T*>(vc);
  T* op = static_cast<T*>(o);
  switch (D) {
    case 32: return dispatch_rows<T, 32>(qp, kp, vp, len, op, B, Smax, H, KH, window, scale, stream);
    case 64: return dispatch_rows<T, 64>(qp, kp, vp, len, op, B, Smax, H, KH, window, scale, stream);
    case 128: return dispatch_rows<T, 128>(qp, kp, vp, len, op, B, Smax, H, KH, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ------------------------------------------------------------------------
// The bf16 split-KV kernel (see the note at the top).
constexpr int kDT = 64;                 // keys per K/V tile
constexpr int kDStages = 2;             // K/V tiles in the cp.async ring
constexpr int kSpanUnit = 64;           // a split's span is whole units of this many keys
constexpr int kMaxSplits = 256;         // the combine's weights fit the ring
constexpr int kSlice = 16;              // keys of one warp step
constexpr int kGRows = 16;              // mma rows: the G <= 16 query heads of a KV head
static_assert(kDT % kSlice == 0, "tiles are whole slices");

// Shared memory: region 0 holds the K/V ring during the loop, then the
// warps' partials, then the combine's weights; after it the queries and
// the block's merged partial.
template <int D>
__host__ __device__ constexpr int split_region0() {
  return cmax(cmax(2 * kDStages * kDT * D * 2, kWarps * kGRows * (D + 2) * 4),
              kMaxSplits * kGRows * 4);
}
template <int D>
constexpr int split_smem_bytes() { return split_region0<D>() + kGRows * D * 2 + kGRows * (D + 2) * 4; }

// Block (split, kh, b): keys [split * span, min((split + 1) * span, Smax))
// of KV head kh of sequence b, for its G <= 16 query heads, the rows of an
// mma tile (rows past G are zero). Warp w takes 16-key slices w, w + 4, ...
// of each tile: scores and P.V on the tensor cores (mma.sync m16n8k16, bf16
// operands, fp32 sums), the online softmax in base 2 on the fragments. m is
// kept in base-2 units throughout, and -1e30 marks "no key yet", so an
// empty block's weight in every merge is exactly zero and never NaN.
// ws: the splits' partials, (B, KH, splits, G, D) accumulators then
// (B, KH, splits, G) pairs (m, l); counters: (B, KH) int32, zero between
// calls. Both unused when there is one split.
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ vc, const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ ws, int* counters,
                    int Smax, int H, int KH, int window, float scale, int span) {
  constexpr int CH = D / 8;                                  // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  auto ks = reinterpret_cast<__nv_bfloat16*>(smem);          // [kDStages][kDT][D], swizzled
  auto vs = ks + kDStages * kDT * D;                         // [kDStages][kDT][D], swizzled
  auto mw = reinterpret_cast<float*>(smem);                  // [kWarps][kGRows][D + 2], after the loop
  auto wt = reinterpret_cast<float*>(smem);                  // [splits][kGRows], in the combine
  auto qs = reinterpret_cast<__nv_bfloat16*>(smem + split_region0<D>());   // [kGRows][D]
  auto part = reinterpret_cast<float*>(qs + kGRows * D);     // [kGRows][D + 2]: acc, m, l

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int split = blockIdx.x, splits = gridDim.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int length = lengths[b];
  const int n = min(length, Smax);
  const int lo = max(split * span, window > 0 ? length - window : 0);   // every key kept
  const int hi = min(min(split * span + span, Smax), n);
  const size_t kv_base = (size_t(b) * Smax * KH + kh) * D, kv_stride = size_t(KH) * D;
  const size_t q_base = (size_t(b) * H + size_t(kh) * G) * D;

  auto load_kv = [&](int t) {
    const int k0 = lo + t * kDT;
    if (k0 >= hi) return;
    __nv_bfloat16* kt = ks + (t % kDStages) * kDT * D;
    __nv_bfloat16* vt = vs + (t % kDStages) * kDT * D;
    for (int i = tid; i < kDT * CH; i += kThreads) {
      const int r = i / CH, c = i % CH, key = k0 + r;
      const bool ok = key < hi;
      const size_t off = ok ? kv_base + size_t(key) * kv_stride + 8 * c : 0;
      cp_async16(kt + swz<CH>(r, c), kc + off, ok);
      cp_async16(vt + swz<CH>(r, c), vc + off, ok);
    }
  };

  // This thread's rows g and g + 8 of the warp's tile.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;

  if (lo < hi) {
    for (int i = tid; i < kGRows * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      cp_async16(qs + swz<CH>(r, c), q + (r < G ? q_base + size_t(r) * D + 8 * c : 0), r < G);
    }
    // Group i holds tile i (group 0 the queries too); one group is
    // committed per tile even where nothing is left to load, so that
    // waiting for all but the newest kDStages - 1 groups means tile i has
    // landed. With a span of kDStages - 1 tiles or fewer, every load is
    // issued before the first wait.
#pragma unroll
    for (int i = 0; i < kDStages - 1; ++i) {
      load_kv(i);
      cp_async_commit();
    }
    const float inf = __uint_as_float(0x7f800000u);
    const float sl2 = scale * kLog2e;
    uint32_t qf[D / 16][4];
    for (int it = 0, k0 = lo; k0 < hi; ++it, k0 += kDT) {
      load_kv(it + kDStages - 1);
      cp_async_commit();
      cp_async_wait<kDStages - 1>();
      __syncthreads();
      if (it == 0) {
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd)
          ldmatrix_x4(qf[kd], qs + swz<CH>(lane & 15, 2 * kd + (lane >> 4)));
      }
      const __nv_bfloat16* kt = ks + (it % kDStages) * kDT * D;
      const __nv_bfloat16* vt = vs + (it % kDStages) * kDT * D;
      // A slice past hi holds no key and is skipped; every other slice
      // holds one, so each row's maximum below is finite.
      for (int sl = warp; sl < kDT / kSlice && k0 + kSlice * sl < hi; sl += kWarps) {
        float s[2][4] = {};
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          uint32_t kf[4];
          ldmatrix_x4(kf, kt + swz<CH>(kSlice * sl + (lane & 7) + ((lane >> 4) << 3),
                                       2 * kd + ((lane >> 3) & 1)));
          mma_bf16(s[0], qf[kd], kf[0], kf[1]);
          mma_bf16(s[1], qf[kd], kf[2], kf[3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -inf;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              float& e = s[j][2 * h + x];
              e = k0 + kSlice * sl + 8 * j + 2 * qd + x < hi ? e * sl2 : -inf;
              mx = fmaxf(mx, e);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          mx = fmaxf(m[h], mx);
          const float alpha = ex2(m[h] - mx);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              float& e = s[j][2 * h + x];
              e = ex2(e - mx);                  // exactly 0 for a key past hi
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
        // P (rounded to bf16) times the slice's values.
        const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vt + swz<CH>(kSlice * sl + (lane & 15), 2 * dn + (lane >> 4)));
          mma_bf16(acc[2 * dn], pa, vf[0], vf[1]);
          mma_bf16(acc[2 * dn + 1], pa, vf[2], vf[3]);
        }
      }
      __syncthreads();                          // this slot is refilled by the next iteration
    }
    cp_async_wait<0>();
    __syncthreads();                            // the ring is free: mw reuses it
  }

  // The warps' partials, merged in warp order into part[g] = (acc, m, l).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lsum = l[h];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    float* dst = mw + (warp * kGRows + g + 8 * h) * (D + 2);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j + 2 * qd) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    if (qd == 0) {
      dst[D] = m[h];
      dst[D + 1] = lsum;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * (D + 1); e += kThreads) {
    const int r = e / (D + 1), d = e % (D + 1);   // d == D: the pair (m, l)
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw[(w * kGRows + r) * (D + 2) + D]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* src = mw + (w * kGRows + r) * (D + 2);
      a += ex2(src[D] - mx) * src[d < D ? d : D + 1];
    }
    float* dst = part + r * (D + 2);
    if (d < D) {
      dst[d] = a;
    } else {
      dst[D] = mx;
      dst[D + 1] = a;
    }
  }
  __syncthreads();

  __nv_bfloat16* out = o + q_base;
  if (splits == 1) {
    for (int e = tid; e < G * D; e += kThreads) {
      const float* src = part + (e / D) * (D + 2);
      out[e] = __float2bfloat16(src[e % D] / (src[D + 1] + 1e-30f));
    }
    return;
  }

  // Combine the splits of (b, kh) in split order: sum_s 2^(m_s - M) acc_s
  // over sum_s 2^(m_s - M) l_s. An empty split (m = -1e30, l = 0, acc = 0)
  // weighs exactly zero next to any split that holds a key.
  const size_t pair = (size_t(b) * KH + kh) * splits;   // this (b, kh)'s first split
  float* ws_acc = ws + pair * G * D;
  float* ws_ml = ws + size_t(gridDim.z) * KH * splits * G * D + pair * G * 2;
  for (int e = tid; e < G * D; e += kThreads)
    ws_acc[size_t(split) * G * D + e] = part[(e / D) * (D + 2) + e % D];
  for (int r = tid; r < G; r += kThreads)
    *reinterpret_cast<float2*>(ws_ml + (size_t(split) * G + r) * 2) =
        make_float2(part[r * (D + 2) + D], part[r * (D + 2) + D + 1]);
  __shared__ int last;
  __threadfence();                            // the partials are visible before the count
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + size_t(b) * KH + kh;
    last = atomicAdd(cnt, 1) == splits - 1;
    if (last) *cnt = 0;                       // ready for the next call on the stream
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Per row r (one warp each): M_r, each split's weight 2^(m_s - M_r) into
  // wt, and the denominator into part; then each output sums over splits.
  for (int r = warp; r < G; r += kWarps) {
    float mx = kNegInf;
    for (int sp = lane; sp < splits; sp += 32) mx = fmaxf(mx, __ldcg(ws_ml + (size_t(sp) * G + r) * 2));
    mx = warp_max(mx);
    float den = 0.f;
    for (int sp = lane; sp < splits; sp += 32) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(ws_ml + (size_t(sp) * G + r) * 2));
      const float w = ex2(ml.x - mx);
      wt[sp * kGRows + r] = w;
      den += w * ml.y;
    }
    den = warp_sum(den);
    if (lane == 0) part[r * (D + 2) + D + 1] = den;
  }
  __syncthreads();
  for (int e = 4 * tid; e < G * D; e += 4 * kThreads) {   // 4 columns of one row
    const int r = e / D;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) {
      const float w = wt[sp * kGRows + r];
      const float4 v = __ldcg(reinterpret_cast<const float4*>(ws_acc + size_t(sp) * G * D + e));
      a = make_float4(fmaf(w, v.x, a.x), fmaf(w, v.y, a.y), fmaf(w, v.z, a.z), fmaf(w, v.w, a.w));
    }
    const float inv = 1.f / (part[r * (D + 2) + D + 1] + 1e-30f);
    *reinterpret_cast<uint2*>(out + e) = make_uint2(pack_bf16(a.x * inv, a.y * inv),
                                                    pack_bf16(a.z * inv, a.w * inv));
  }
}

template <int D>
cudaError_t launch_split(const void* q, const void* kc, const void* vc, const int* len, void* o,
                         float* ws, int* counters, int B, int Smax, int H, int KH, int window,
                         float scale, int splits, cudaStream_t stream) {
  constexpr int smem = split_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int span = cdiv(cdiv(Smax, kSpanUnit), splits) * kSpanUnit;
  decode_split_kernel<D><<<dim3(splits, KH, B), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), len, static_cast<__nv_bfloat16*>(o), ws, counters,
      Smax, H, KH, window, scale, span);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q (B,H,D), k/v caches (B,Smax,KH,D), lengths (B,) int32, o (B,H,D); all
// contiguous, q/k/v/o of one dtype (repro::DType). variant 0 is the
// CUDA-core kernel (either dtype; workspace, counters and splits unused),
// variant 1 the bf16 split-KV kernel: `splits` blocks per (sequence, KV
// head), each a span of cdiv(cdiv(Smax, 64), splits) * 64 keys, with
// `workspace` fp32 of B * KH * splits * (H / KH) * (D + 2) elements and
// `counters` int32 of B * KH elements, all zero, when splits > 1 (both
// unused with one split). Every launch leaves the counters at zero; two
// launches that may run at once (on two streams) need separate counters. Launches on `stream` of `device` and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_decode_attention(const void* q, const void* k_cache,
                                      const void* v_cache, const void* lengths,
                                      void* o, void* workspace, void* counters, int B,
                                      int Smax, int H, int KH, int D, int dtype, int window,
                                      float scale, int splits, int variant, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (variant == 1) {
    const int units = repro::cdiv(Smax, repro::kSpanUnit);
    if (dtype != repro::kBFloat16 || splits < 1 || splits > units ||
        splits > repro::kMaxSplits || H / KH > repro::kGRows || B > 65535 ||
        (splits > 1 && (workspace == nullptr || counters == nullptr)))
      return cudaErrorInvalidValue;
    auto* ws = static_cast<float*>(workspace);
    auto* cnt = static_cast<int*>(counters);
    switch (D) {
      case 32: return repro::launch_split<32>(q, k_cache, v_cache, len, o, ws, cnt, B, Smax, H, KH, window, scale, splits, s);
      case 64: return repro::launch_split<64>(q, k_cache, v_cache, len, o, ws, cnt, B, Smax, H, KH, window, scale, splits, s);
      case 128: return repro::launch_split<128>(q, k_cache, v_cache, len, o, ws, cnt, B, Smax, H, KH, window, scale, splits, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (variant != 0) return cudaErrorInvalidValue;
  if (dtype == repro::kFloat32)
    return repro::dispatch<float>(q, k_cache, v_cache, len, o, B, Smax, H, KH, D, window, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch<__nv_bfloat16>(q, k_cache, v_cache, len, o, B, Smax, H, KH, D, window, scale, s);
  return cudaErrorInvalidValue;
}
