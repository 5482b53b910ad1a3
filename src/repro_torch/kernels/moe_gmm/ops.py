"""Public grouped-matmul entry points for the MoE experts: the product and
its two gradients.

A CUDA tensor goes to a hand-written kernel (``csrc/moe_gmm.cu``) or the
call raises; a CPU tensor goes to the plain versions in ``ref.py``.
``grouped_matmul.launches`` counts the product's kernel launches,
``grouped_matmul_dx.launches`` and ``grouped_matmul_dw.launches`` those of
its gradients, and nothing else; a call that a CUDA graph's capture only
records counts in the wrapper's ``captured`` instead (``common.count_launch``).

bf16 operands with 16-byte rows (``takes_mma``) go to a tensor-core
kernel, everything else to the CUDA-core kernel: below TILED_MIN_C capacity
rows the weight-streaming kernel (``gmm_mma_kernel``), from there on (the
training capacities) the TMA/wgmma GEMM the gradients use (``route``).

Where x or w requires grad (and grad mode is on), the product runs inside
``_GroupedMatmul``, a ``torch.autograd.Function`` whose backward is the VJP
of ``ref.gmm_reference`` (the JAX package's rule, ``_gmm_bwd``): dx = g w^T
and dw = x^T g, each one launch of the grouped GEMM (``repro_grouped_gemm``)
on the untransposed tensors, the layout given by the operands' strides:
bf16 operands with 16-byte rows on the TMA/wgmma kernel, everything else on
its CUDA-core variant.

The serving engine captures the product in a CUDA graph (the MoE decode
step, C = 4 on ``gmm_mma_kernel``). The first call builds and loads the
kernel and runs the function-static ``cudaFuncSetAttribute`` of the C entry
point; a warm-up call before capture does both, and inside a capture the
entry point reaches only ``cudaSetDevice`` (to the current device), the
launch and ``cudaGetLastError``.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODES, check_launch, check_operands,
                                        count_launch, kernel_route, plain)
from repro_torch.kernels.moe_gmm import ref as _ref

VARIANTS = {"fma": 0, "mma": 1}   # the C entry points' `variant` (1: tensor cores)
LAYOUTS = {"nn": 0, "nt": 1, "tn": 2}   # repro_grouped_gemm's operand layouts
# Capacity from which the product takes the GEMM: chip_variants.py timed it
# ahead of gmm_mma_kernel at C = 128, 256 and 512 at granite-moe-3b-a800m's
# widths, and level or behind at C = 64.
TILED_MIN_C = 128


def takes_mma(dtype, d: int, f: int, aligned: bool) -> bool:
    """Whether the tensor-core kernel takes these operands: bf16, rows of
    whole 16-byte vectors, operands 16-byte aligned."""
    return dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0 and aligned


def route(dtype, C: int, d: int, f: int, aligned: bool) -> str:
    """The product's kernel for x (E, C, d) and w (E, d, f): "tiled" (the
    GEMM), "mma" (gmm_mma_kernel) or "fma" (the CUDA-core kernel); from the
    dtype, the shapes and the alignment only."""
    if not takes_mma(dtype, d, f, aligned):
        return "fma"
    return "tiled" if C >= TILED_MIN_C else "mma"


@lru_cache(None)
def _lib():
    lib = build.load("moe_gmm")
    fn = lib.repro_grouped_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(None)
def _gemm_lib():
    fn = build.load("moe_gmm").repro_grouped_gemm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _gemm(a, b, layout, M, N, K):
    """out (E, M, N) = A B per expert on the grouped GEMM, A and B read in
    ``layout`` ("nn": a (E, M, K), b (E, K, N); "nt": a (E, M, K),
    b (E, N, K); "tn": a (E, K, M), b (E, K, N)) with no copy; the
    tensor-core variant where a's rows and the output's (and so b's) are
    whole 16-byte vectors of bf16, else the CUDA-core one."""
    E = a.shape[0]
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    variant = "mma" if takes_mma(a.dtype, M if layout == "tn" else K, N, aligned) else "fma"
    out = torch.empty((E, M, N), dtype=a.dtype, device=a.device)
    err = _gemm_lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(), E, M, N, K, LAYOUTS[layout],
                      DTYPE_CODES[a.dtype], VARIANTS[variant], a.device.index,
                      torch.cuda.current_stream(a.device).cuda_stream)
    check_launch(err, "grouped GEMM kernel launch")
    return out


def _launch(x, w):
    """The kernel on x (E, C, d) and w (E, d, f), checked, on the card."""
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
    return out


class _GroupedMatmul(torch.autograd.Function):
    """The product on the kernel; dx and dw on the same kernel as its VJP."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _product(kernel_route(x, w), x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = grouped_matmul_dx(g, w) if ctx.needs_input_grad[0] else None
        dw = grouped_matmul_dw(x, g) if ctx.needs_input_grad[1] else None
        return dx, dw


def _product(device, x, w):
    if device == "cpu":
        return plain(_ref.gmm_reference, x, w)
    (_, C, d), f = x.shape, w.shape[2]
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    out = _gemm(x, w, "nn", C, f, d) if route(x.dtype, C, d, f, aligned) == "tiled" \
        else _launch(x, w)
    count_launch(grouped_matmul)
    return out


def grouped_matmul(x, w):
    """x: (E, C, d); w: (E, d, f) -> (E, C, f) in x's dtype, with fp32
    accumulation. Any C, d and f; differentiable in x and w."""
    route = kernel_route(x, w)
    if x.dim() != 3 or w.dim() != 3 or w.shape[:2] != x.shape[::2]:
        raise ValueError(f"grouped_matmul: x{tuple(x.shape)} and w{tuple(w.shape)} "
                         "must be (E, C, d) and (E, d, f)")
    check_operands("grouped_matmul", x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GroupedMatmul.apply(x, w)
    return _product(route, x, w)


grouped_matmul.launches = grouped_matmul.captured = 0


def grouped_matmul_dx(g, w):
    """g: (E, C, f); w: (E, d, f) -> dx = g w^T (E, C, d) in g's dtype: the
    gradient of ``grouped_matmul`` in x. The kernel reads w as it lies."""
    route = kernel_route(g, w)
    if g.dim() != 3 or w.dim() != 3 or g.shape[0] != w.shape[0] or g.shape[2] != w.shape[2]:
        raise ValueError(f"grouped_matmul_dx: g{tuple(g.shape)} and w{tuple(w.shape)} "
                         "must be (E, C, f) and (E, d, f)")
    check_operands("grouped_matmul_dx", g, w)
    if route == "cpu":
        return plain(_ref.gmm_dx_reference, g, w)
    C, f = g.shape[1:]
    out = _gemm(g, w, "nt", C, w.shape[1], f)
    count_launch(grouped_matmul_dx)
    return out


grouped_matmul_dx.launches = grouped_matmul_dx.captured = 0


def grouped_matmul_dw(x, g):
    """x: (E, C, d); g: (E, C, f) -> dw = x^T g (E, d, f) in x's dtype: the
    gradient of ``grouped_matmul`` in w, a sum over the C capacity rows. The
    kernel reads x as it lies."""
    route = kernel_route(x, g)
    if x.dim() != 3 or g.dim() != 3 or x.shape[:2] != g.shape[:2]:
        raise ValueError(f"grouped_matmul_dw: x{tuple(x.shape)} and g{tuple(g.shape)} "
                         "must be (E, C, d) and (E, C, f)")
    check_operands("grouped_matmul_dw", x, g)
    if route == "cpu":
        return plain(_ref.gmm_dw_reference, x, g)
    C, d = x.shape[1:]
    out = _gemm(x, g, "tn", d, g.shape[2], C)
    count_launch(grouped_matmul_dw)
    return out


grouped_matmul_dw.launches = grouped_matmul_dw.captured = 0
