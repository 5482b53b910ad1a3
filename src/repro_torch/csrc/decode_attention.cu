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
// in place with no transposes, and stops its loop at min(length, Smax): an
// idle serving slot's length keeps growing past Smax, and nothing past the
// cache is ever read.
//
// What bounds it on the H100: HBM. Per call it must read the live cache,
// 2 * sum(len) * KH * D * sizeof(T) bytes, against 4 * sum(len) * H * D
// operations -- about one operation per byte. At the serving path's shapes
// (qwen2-1.5b, B=8, KH=2, D=128, bf16) that is of the order of a megabyte
// per layer, well under a microsecond at 3.35 TB/s.
//
// Design: one block of 128 threads per (KV head, sequence), so the KV tile
// is loaded once for all G query heads; each warp owns up to R of those
// heads (R = 1, 2 or 4, so G <= 16). Keys are staged 32 at a time through
// shared memory as fp32 with 16-byte loads, the next tile's loads in flight
// while the current one is computed; arithmetic is fp32 FMA on the CUDA
// cores. Only B * KH blocks run -- 16 of the 132 SMs at B=8, KH=2 -- and each
// streams its cache tile after tile, so the kernel is bound by one block's
// chain of memory latencies, far from the HBM bound. Splitting the sequence
// across blocks (split-KV) and TMA staging are later work.
#include "common.cuh"

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

}  // namespace
}  // namespace repro

// q (B,H,D), k/v caches (B,Smax,KH,D), lengths (B,) int32, o (B,H,D); all
// contiguous, q/k/v/o of one dtype (repro::DType). Launches on `stream` of
// `device` and returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_decode_attention(const void* q, const void* k_cache,
                                      const void* v_cache, const void* lengths,
                                      void* o, int B, int Smax, int H, int KH, int D,
                                      int dtype, int window, float scale, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == repro::kFloat32)
    return repro::dispatch<float>(q, k_cache, v_cache, len, o, B, Smax, H, KH, D, window, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch<__nv_bfloat16>(q, k_cache, v_cache, len, o, B, Smax, H, KH, D, window, scale, s);
  return cudaErrorInvalidValue;
}
