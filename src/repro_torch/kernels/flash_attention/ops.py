"""Public flash-attention entry points: the forward and its backward.

A CUDA tensor goes to a hand-written kernel (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``) or the call raises; a CPU tensor goes to
the plain versions in ``ref.py``. ``flash_attention.launches`` counts
forward kernel launches and ``flash_attention_bwd.launches`` backward ones,
and nothing else; a call that a CUDA graph's capture only records counts in
the wrapper's ``captured`` instead (``common.count_launch``).

bf16 goes to the tensor-core kernels, whose blocks serve all query heads of
one KV head; fp32 to the CUDA-core kernels, which keep the fp32 sweeps'
2e-5 and the gradient check's 1e-4.

Where q, k or v requires grad (and grad mode is on), the forward runs inside
``_FlashAttention``, a ``torch.autograd.Function``: it also writes each
row's log-sum-exp, and its backward runs the backward kernel on it. Under
``torch.utils.checkpoint`` the forward runs again in the backward pass, and
the Function saves that run's LSE.

The bf16 backward's dk/dv kernel splits each KV head's G query heads into
``dkdv_splits`` parts, a function of the shapes and the SM count only, so
that its blocks fill the card; the parts' fp32 sums are added in a fixed
order by a second pass, and the gradients repeat bit for bit.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODES, HEAD_DIMS, cdiv, check_aligned,
                                        check_launch, check_operands, count_launch,
                                        kernel_route, plain)
from repro_torch.kernels.flash_attention import ref as _ref

VARIANTS = {"fma": 0, "mma": 1}   # the C entry points' `variant`
DKDV_KEYS = 64          # keys per block of the bf16 dk/dv kernel (csrc kKB)
DKDV_BLOCKS_PER_SM = 2  # resident dk/dv blocks per SM (registers and shared memory)


def dkdv_splits(B: int, Sk: int, KH: int, G: int, sms: int) -> int:
    """Parts into which the bf16 dk/dv kernel splits each KV head's G query
    heads: the fewest, a divisor of G, that give every SM its resident
    blocks (DKDV_BLOCKS_PER_SM), or G. Each part adds 2 B KH Sk D fp32 of
    partial sums that a second pass reads, so no more parts than that."""
    blocks = cdiv(Sk, DKDV_KEYS) * KH * B
    for n in range(1, G + 1):
        if G % n == 0 and blocks * n >= DKDV_BLOCKS_PER_SM * sms:
            return n
    return G


@lru_cache(None)
def _sm_count(index: int) -> int:
    """The card's SM count, read once (before any stream capture)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@lru_cache(None)
def _lib():
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(None)
def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    fn = lib.repro_flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + \
        [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_shapes(what, q, k, v, window):
    """The route, after the shape checks every entry point shares."""
    route = kernel_route(q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{what}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Sk, KH, Dk = k.shape
    if Bk != B or Dk != D or H % KH:
        raise ValueError(f"{what}: q{tuple(q.shape)} does not match "
                         f"k/v{tuple(k.shape)} (need equal B, D and H % KH == 0)")
    if window < 0:
        raise ValueError(f"{what}: window {window} < 0")
    return route


def _check_cuda(what, q, *tensors):
    B, _, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not in {HEAD_DIMS}")
    if B > 65535 or H > 65535:
        raise ValueError(f"{what}: B={B}, H={H} exceed the grid limit")
    check_aligned(what, q, *tensors)


def _scale(scale, D):
    return scale if scale is not None else D ** -0.5


def _forward(route, q, k, v, causal, window, scale, with_lse):
    """(out, lse or None); lse (B, H, Sq) fp32 only if ``with_lse``."""
    if route == "cpu":
        out = plain(_ref.mha_reference, q, k, v, causal=causal, window=window, scale=scale)
        if not with_lse:
            return out, None
        # contiguous, as the kernel's output is, for the backward's checks
        return out.contiguous(), plain(_ref.lse_reference, q, k, causal=causal,
                                       window=window, scale=scale)
    _check_cuda("flash_attention", q, k, v)
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1:3]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 B, Sq, Sk, H, KH, D, DTYPE_CODES[q.dtype], int(causal), int(window),
                 _scale(scale, D), VARIANTS["mma" if q.dtype == torch.bfloat16 else "fma"],
                 q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, "flash_attention kernel launch")
    count_launch(flash_attention)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its LSE saved; the backward kernel as the VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = _forward(kernel_route(q, k, v), q, k, v, causal, window, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         causal=causal, window=window, scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """q: (B, Sq, H, D); k/v: (B, Sk, KH, D) -> (B, Sq, H, D).

    Any Sq and Sk; query i sits at absolute position Sk - Sq + i.
    Differentiable in q, k and v, except causal with Sq > Sk.
    """
    route = _check_shapes("flash_attention", q, k, v, window)
    check_operands("flash_attention", q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if causal and q.shape[1] > k.shape[1]:
            raise ValueError(f"flash_attention: no backward for causal Sq={q.shape[1]} > "
                             f"Sk={k.shape[1]} (a query would keep no key)")
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(route, q, k, v, causal, window, scale, False)[0]


flash_attention.launches = flash_attention.captured = 0


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """(dq, dk, dv), the VJP of ``flash_attention`` at (q, k, v) for the
    cotangent ``dout``; ``out`` and ``lse`` (B, H, Sq) fp32 are the forward's.
    Causal needs Sq <= Sk, so that every query keeps a key."""
    route = _check_shapes("flash_attention_bwd", q, k, v, window)
    check_operands("flash_attention_bwd", q, k, v, out, dout)
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1:3]
    if out.shape != q.shape or dout.shape != q.shape or (causal and Sq > Sk):
        raise ValueError(f"flash_attention_bwd: out{tuple(out.shape)} and "
                         f"dout{tuple(dout.shape)} must match q{tuple(q.shape)}, "
                         f"and causal Sq={Sq} must not exceed Sk={Sk}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be contiguous fp32 {(B, H, Sq)}, "
                         f"got {lse.dtype}{tuple(lse.shape)}")
    if route == "cpu":
        return plain(_ref.mha_backward_reference, q, k, v, dout, causal=causal,
                     window=window, scale=scale)
    _check_cuda("flash_attention_bwd", q, k, v, out, dout)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    mma = q.dtype == torch.bfloat16
    splits = dkdv_splits(B, Sk, KH, H // KH, _sm_count(q.device.index)) if mma else 1
    part = torch.empty(2 * B * KH * splits * Sk * D, dtype=torch.float32,
                       device=q.device) if splits > 1 else None
    err = _bwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), None if part is None else part.data_ptr(), B, Sq, Sk, H, KH,
                     D, DTYPE_CODES[q.dtype], int(causal), int(window), _scale(scale, D),
                     VARIANTS["mma" if mma else "fma"], splits, q.device.index,
                     torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, "flash_attention_bwd kernel launch")
    count_launch(flash_attention_bwd)
    return dq, dk, dv


flash_attention_bwd.launches = flash_attention_bwd.captured = 0
