"""Public grouped-matmul entry point for the MoE experts (inference only).

A CUDA tensor goes to a hand-written kernel (``csrc/moe_gmm.cu``) or the
call raises; a CPU tensor goes to the plain version in ``ref.py``.
``grouped_matmul.launches`` counts kernel launches, and nothing else.

bf16 operands with 16-byte rows (``takes_mma``) go to the tensor-core
kernel, everything else to the CUDA-core kernel.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODES, check_launch, check_operands,
                                        kernel_route)
from repro_torch.kernels.moe_gmm import ref as _ref

VARIANTS = {"fma": 0, "mma": 1}   # the C entry point's `variant`


def takes_mma(dtype, d: int, f: int, aligned: bool) -> bool:
    """Whether the tensor-core kernel takes these operands: bf16, rows of
    whole 16-byte vectors, operands 16-byte aligned."""
    return dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0 and aligned


@lru_cache(None)
def _lib():
    lib = build.load("moe_gmm")
    fn = lib.repro_grouped_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def grouped_matmul(x, w):
    """x: (E, C, d); w: (E, d, f) -> (E, C, f) in x's dtype, with fp32
    accumulation. Any C, d and f."""
    route = kernel_route(x, w)
    if x.dim() != 3 or w.dim() != 3 or w.shape[:2] != x.shape[::2]:
        raise ValueError(f"grouped_matmul: x{tuple(x.shape)} and w{tuple(w.shape)} "
                         "must be (E, C, d) and (E, d, f)")
    check_operands("grouped_matmul", x, w)
    if route == "cpu":
        return _ref.gmm_reference(x, w)

    E, C, d = x.shape
    f = w.shape[2]
    if E > 65535:
        raise ValueError(f"grouped_matmul: E={E} exceeds the grid limit")
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    variant = "mma" if takes_mma(x.dtype, d, f, aligned) else "fma"
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    err = _lib()(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f, DTYPE_CODES[x.dtype],
        VARIANTS[variant], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "grouped_matmul kernel launch")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
