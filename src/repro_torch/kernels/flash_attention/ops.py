"""Public flash-attention entry point.

A CUDA tensor goes to a hand-written kernel (``csrc/flash_attention.cu``)
or the call raises; a CPU tensor goes to the plain version in ``ref.py``.
``flash_attention.launches`` counts kernel launches, and nothing else.

bf16 goes to the tensor-core kernel, whose blocks serve all query heads of
one KV head; fp32 to the CUDA-core kernel, which keeps the fp32 sweeps'
2e-5.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODES, HEAD_DIMS, check_aligned,
                                        check_launch, check_operands, kernel_route)
from repro_torch.kernels.flash_attention import ref as _ref

VARIANTS = {"fma": 0, "mma": 1}   # the C entry point's `variant`


@lru_cache(None)
def _lib():
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """q: (B, Sq, H, D); k/v: (B, Sk, KH, D) -> (B, Sq, H, D).

    Any Sq and Sk; query i sits at absolute position Sk - Sq + i.
    """
    route = kernel_route(q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Sk, KH, Dk = k.shape
    if Bk != B or Dk != D or H % KH:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} does not match "
                         f"k/v{tuple(k.shape)} (need equal B, D and H % KH == 0)")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    check_operands("flash_attention", q, k, v)
    if route == "cpu":
        return _ref.mha_reference(q, k, v, causal=causal, window=window,
                                  scale=scale)

    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention: B={B}, H={H} exceed the grid limit")
    check_aligned("flash_attention", q, k, v)
    variant = "mma" if q.dtype == torch.bfloat16 else "fma"
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, H, KH, D, DTYPE_CODES[q.dtype], int(causal),
                 int(window), scale if scale is not None else D ** -0.5, VARIANTS[variant],
                 q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, "flash_attention kernel launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
