"""Public decode-attention entry point (inference only).

A CUDA tensor goes to the hand-written kernel (``csrc/decode_attention.cu``)
or the call raises; a CPU tensor goes to the plain version in ``ref.py``.
``decode_attention.launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODES, HEAD_DIMS, check_aligned,
                                        check_launch, check_operands, kernel_route)
from repro_torch.kernels.decode_attention import ref as _ref

MAX_GROUP = 16   # query heads per KV head the kernel keeps in one block


@lru_cache(None)
def _lib():
    lib = build.load("decode_attention")
    fn = lib.repro_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
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
        return _ref.decode_attention_reference(q, k_cache, v_cache, lengths,
                                               scale=scale, window=window)

    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")
    if H // KH > MAX_GROUP or B > 65535:
        raise ValueError(f"decode_attention: group {H // KH} > {MAX_GROUP} "
                         f"or B={B} > 65535")
    check_aligned("decode_attention", q, k_cache, v_cache)
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), B, Smax, H, KH, D,
                 DTYPE_CODES[q.dtype], int(window),
                 scale if scale is not None else D ** -0.5, q.device.index,
                 torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, "decode_attention kernel launch")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
