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
// What bounds it on the H100: at the serving path's prefill buckets (16 to
// 64 tokens, qwen2-1.5b: H=12, KH=2, D=128) one causal call is about
// 4 * S^2/2 * H * D operations (13 MFLOP at S=64) and 0.5 MB of q/k/v/o:
// nanoseconds of tensor-core time and a tenth of a microsecond of HBM time,
// far below the few microseconds of a launch. It is launch-bound.
//
// Design: simple and exact first. One block of 128 threads per
// (batch, head, 16-query tile): each warp owns 4 query rows. Keys are staged
// 32 at a time through shared memory as fp32 (one key per lane for the
// scores, one output column per lane and 32 for P.V). All arithmetic is fp32
// FMA on the CUDA cores -- no tensor cores, so no TF32 rounding on the fp32
// path. KV tiles wholly above the causal diagonal or below the window are
// never loaded. Since each block is a short chain of dependent memory
// stages, latency is what a block waits on: every stage's loads are 16-byte
// vectors issued together with no branch around them, and the next KV
// tile's loads are in flight while the current tile is computed (common.cuh,
// RowStager / attend_range). Tensor cores (wgmma), TMA and one block per KV
// head (sharing K/V across the G query heads) are later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kRows = 4;               // query rows per warp
constexpr int kBQ = kWarps * kRows;    // query rows per block

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int KH, int causal, int window, float scale) {
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
    T* out = o + ((size_t(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
      out[lane + 32 * c] = from_float<T>(acc[r][c] / (l[r] + 1e-30f));
  }
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B,
                     int Sq, int Sk, int H, int KH, int D, int causal, int window,
                     float scale, cudaStream_t stream) {
  const dim3 grid(cdiv(Sq, kBQ), H, B);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (D) {
    case 32:
      flash_fwd_kernel<T, 32><<<grid, kThreads, 0, stream>>>(qp, kp, vp, op, Sq, Sk, H, KH, causal, window, scale);
      break;
    case 64:
      flash_fwd_kernel<T, 64><<<grid, kThreads, 0, stream>>>(qp, kp, vp, op, Sq, Sk, H, KH, causal, window, scale);
      break;
    case 128:
      flash_fwd_kernel<T, 128><<<grid, kThreads, 0, stream>>>(qp, kp, vp, op, Sq, Sk, H, KH, causal, window, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q (B,Sq,H,D), k/v (B,Sk,KH,D), o (B,Sq,H,D), all contiguous and of one
// dtype (repro::DType). Launches on `stream` of `device` and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, int B, int Sq, int Sk, int H, int KH,
                                     int D, int dtype, int causal, int window,
                                     float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::dispatch<float>(q, k, v, o, B, Sq, Sk, H, KH, D, causal, window, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KH, D, causal, window, scale, s);
  return cudaErrorInvalidValue;
}
