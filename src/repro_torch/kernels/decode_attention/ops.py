"""Public decode-attention entry point (inference only).

A CUDA tensor goes to a hand-written kernel (``csrc/decode_attention.cu``)
or the call raises; a CPU tensor goes to the plain version in ``ref.py``.
The kernel has no backward: a CUDA call that would need one (grad mode on
and an input that requires grad) raises NotImplementedError, where the
plain version on the CPU stays differentiable.
``decode_attention.launches`` counts kernel launches, and nothing else.
A call that a CUDA graph's capture only records counts in
``decode_attention.captured`` instead (``common.count_launch``).

bf16 goes to the split-KV kernel: ``split_count`` picks its splits per
(sequence, KV head) on the host from B, KH and Smax alone; fp32 to the
CUDA-core kernel of one block per (sequence, KV head), which keeps the fp32
sweeps' 2e-5.

The serving engine captures this wrapper in a CUDA graph. Its first call
on a stream does what a stream capture forbids or must not bake in: it
builds and loads the kernel, reads the SM count (``_sm_count``), sets the
split kernel's shared-memory attribute (a function-static
``cudaFuncSetAttribute`` in the C entry point) and makes that stream's
arrival counters (``_counters``). A warm-up call on the capture stream
runs it all before capture; the calls inside a capture then reach only
``cudaSetDevice`` (to the current device), the launch and
``cudaGetLastError``, which a capture allows.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODES, HEAD_DIMS, cdiv, check_aligned,
                                        check_launch, check_operands, count_launch,
                                        kernel_route, plain)
from repro_torch.kernels.decode_attention import ref as _ref

MAX_GROUP = 16   # query heads per KV head the kernel keeps in one block
VARIANTS = {"fma": 0, "split": 1}   # the C entry point's `variant`
SPAN_UNIT = _ref.SPAN_UNIT          # kSpanUnit in csrc/decode_attention.cu
MIN_UNITS_PER_SPLIT = 4             # 256 keys: shorter splits cost more than they save
MAX_SPLITS = 256                    # kMaxSplits in csrc/decode_attention.cu


def split_count(B: int, KH: int, Smax: int, sms: int) -> int:
    """Splits per (sequence, KV head) of the bf16 kernel, from the shapes
    alone (the lengths stay on the device): enough that B * KH * splits
    covers ``sms`` SMs, but no split shorter than MIN_UNITS_PER_SPLIT
    64-key units (so the serving path's 256-key cache takes one split), at
    most MAX_SPLITS, and never so many that a split's span holds no unit
    of the cache."""
    units = cdiv(Smax, SPAN_UNIT)
    per = max(MIN_UNITS_PER_SPLIT, units // cdiv(sms, B * KH), cdiv(units, MAX_SPLITS))
    return cdiv(units, per)


@lru_cache(None)
def _sm_count(index: int) -> int:
    """The card's SM count, read once (before any stream capture)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


_COUNTERS: dict = {}


def _counters(device, stream: int, n: int) -> torch.Tensor:
    """The split kernel's per-(sequence, KV head) arrival counters for
    launches on ``stream`` (a raw stream handle) of ``device``: zeroed once
    when allocated, and left at zero by every launch (its last block resets
    them), so no call needs a memset. Launches on one stream run in order,
    so they never share a counter at the same time; launches on two streams
    may overlap, so each stream has its own buffer.

    A CUDA graph captured on a stream bakes in that stream's buffer, which
    must exist before capture (a warm-up call on the stream makes it):
    made during capture it would come from the graph's private pool. The
    invariant: a buffer baked into a graph is never shared by two graphs
    or streams that can run at the same time. Each serving engine captures
    on a side stream of its own; stream handles come from a pool and may
    recur, so two engines on one card (the multi-LLM driver) can share a
    buffer, and they replay in turn on one stream."""
    key = (device, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
    return buf


@lru_cache(None)
def _lib():
    lib = build.load("decode_attention")
    fn = lib.repro_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + \
        [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k_cache, v_cache, lengths, *, scale=None, window=0):
    """q: (B, H, D); k/v_cache: (B, Smax, KH, D); lengths: (B,) int32
    -> (B, H, D). Any Smax; a length past Smax attends the whole cache."""
    route = kernel_route(q, k_cache, v_cache, lengths)
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: bad shapes q{tuple(q.shape)} "
                         f"cache{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    B, H, D = q.shape
    Bc, Smax, KH, Dc = k_cache.shape
    if Bc != B or Dc != D or H % KH:
        raise ValueError(f"decode_attention: q{tuple(q.shape)} does not match "
                         f"cache{tuple(k_cache.shape)} (need equal B, D and H % KH == 0)")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 \
            or not lengths.is_contiguous():
        raise ValueError(f"decode_attention: lengths must be contiguous int32 "
                         f"({B},), got {lengths.dtype}{tuple(lengths.shape)}")
    if window < 0:
        raise ValueError(f"decode_attention: window {window} < 0")
    check_operands("decode_attention", q, k_cache, v_cache)
    if route == "cpu":
        return plain(_ref.decode_attention_reference, q, k_cache, v_cache, lengths,
                     scale=scale, window=window)

    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k_cache, v_cache)):
        raise NotImplementedError("decode_attention: the CUDA kernel has no backward; "
                                  "call it under torch.no_grad() or with inputs that "
                                  "do not require grad")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")
    if H // KH > MAX_GROUP or B > 65535:
        raise ValueError(f"decode_attention: group {H // KH} > {MAX_GROUP} "
                         f"or B={B} > 65535")
    check_aligned("decode_attention", q, k_cache, v_cache)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    work = cnt = None
    splits = 1
    if q.dtype == torch.bfloat16:
        splits = split_count(B, KH, Smax, _sm_count(q.device.index))
        if splits > 1:   # each split's (acc, m, l) per query head
            work = torch.empty(B * KH * splits * (H // KH) * (D + 2), dtype=torch.float32,
                               device=q.device)
            cnt = _counters(q.device, stream, B * KH)
    err = _lib()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(),
                 None if work is None else work.data_ptr(),
                 None if cnt is None else cnt.data_ptr(), B, Smax, H, KH, D,
                 DTYPE_CODES[q.dtype], int(window),
                 scale if scale is not None else D ** -0.5, splits,
                 VARIANTS["split" if q.dtype == torch.bfloat16 else "fma"],
                 q.device.index, stream)
    check_launch(err, "decode_attention kernel launch")
    count_launch(decode_attention)
    return out


decode_attention.launches = decode_attention.captured = 0
