"""Public entry points of the Mamba2 SSD scan and its backward.

``ssd_scan``: a CUDA tensor goes to a hand-written kernel
(``csrc/mamba_scan.cu``) or the call raises; a CPU tensor goes to the plain
chunked version in ``ref.py``, which autograd differentiates. On the card,
under grad (grad mode on and an input that requires grad), the scan runs
inside ``_SSDScan``, a ``torch.autograd.Function`` whose backward is
``ssd_scan_bwd``: the hand-written backward kernel
(``csrc/mamba_scan_bwd.cu``, the port of the reference's ``_ssd_bwd``) on a
CUDA tensor, the plain chunked reverse pass (``ref.ssd_backward_reference``)
on a CPU one. As in the JAX package only y is differentiable there: a CUDA
call with ``with_state`` under grad raises NotImplementedError.
``ssd_scan.launches`` and ``ssd_scan_bwd.launches`` count kernel launches,
and nothing else. bf16 x/B/C go to the forward's tensor-core kernel where
``takes_mma`` holds (P and the strides of x, B and C multiples of 8, the
operands 16-byte aligned, as the model's conv-buffer slices are); fp32, and
bf16 operands it does not take, to the CUDA-core kernel. The backward
kernel takes both dtypes on the CUDA cores; for fp32 inputs it keeps the
state, its adjoint and the sums that set ddt and dA in fp64
(``state_dtype``).
``decode_step`` is the one-token recurrence, plain torch as in the JAX
package (which has no kernel for it).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODES, cdiv, check_launch,
                                        check_ssd_operands, kernel_route)
from repro_torch.kernels.mamba_scan import ref as _ref

STATE_DIMS = (16, 32, 64, 128)   # N the CUDA kernels are instantiated for
BWD_SMEM_LIMIT = 232448           # dynamic shared memory a block may take on sm_90
CHUNK = 64                        # tokens per chunk (csrc kT)
VARIANTS = {"fma": 0, "mma": 1}   # the C entry point's `variant`


def takes_mma(x, Bmat, Cmat) -> bool:
    """Whether the bf16 tensor-core kernel takes these operands: it stages
    rows of x, B and C in 16-byte pieces."""
    return (x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0
            and all(t.stride(i) % 8 == 0 for t in (x, Bmat, Cmat) for i in (0, 1))
            and all(t.data_ptr() % 16 == 0 for t in (x, Bmat, Cmat)))


@lru_cache(None)
def _lib():
    lib = build.load("mamba_scan")
    fn = lib.repro_ssd_scan
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + \
        [ctypes.c_int64] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(None)
def _bwd_lib():
    lib = build.load("mamba_scan_bwd")
    fn = lib.repro_ssd_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 8 + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def state_dtype(dtype: torch.dtype) -> torch.dtype:
    """The backward kernel's type for the state, its adjoint and the sums
    that set ddt and dA: fp64 for fp32 inputs (whose tolerance fp32 sums of
    those terms reach), fp32 for bf16 ones."""
    return torch.float64 if dtype == torch.float32 else torch.float32


def bwd_smem_bytes(P: int, N: int, dtype: torch.dtype) -> int:
    """Shared memory of one block of the backward kernel (csrc smem_bytes):
    in ``state_dtype(dtype)`` the state and its adjoint (pad4(P) x N, rows
    padded by 4) and 2528 elements of sums and per-token vectors; in fp32 x
    and dy (64 x pad4(P)), B and C (64 x N) and two 64 x 64 coefficient
    matrices, rows padded by 4, and dt."""
    Pp = cdiv(P, 4) * 4
    acc = torch.finfo(state_dtype(dtype)).bits // 8
    return acc * (2 * Pp * (N + 4) + 2 * 16 * CHUNK + 7 * CHUNK + 32) + \
        4 * (2 * CHUNK * (Pp + 4) + 2 * CHUNK * (N + 4) + 2 * CHUNK * (CHUNK + 4) + CHUNK)


def _check_inputs(what, x, dt, A, Bmat, Cmat, D, init_state):
    """The route, after the checks the scan and its backward share."""
    state_in = () if init_state is None else (init_state,)
    route = kernel_route(x, dt, A, Bmat, Cmat, D, *state_in)
    if x.dim() != 4:
        raise ValueError(f"{what}: x{tuple(x.shape)} must be (B, S, H, P)")
    Bsz, S, H, P = x.shape
    N = Bmat.shape[-1]
    if (dt.shape != (Bsz, S, H) or A.shape != (H,) or D.shape != (H,)
            or Bmat.shape != (Bsz, S, N) or Cmat.shape != (Bsz, S, N)
            or (init_state is not None and init_state.shape != (Bsz, H, P, N))):
        raise ValueError(
            f"{what}: x{tuple(x.shape)} dt{tuple(dt.shape)} A{tuple(A.shape)} "
            f"B{tuple(Bmat.shape)} C{tuple(Cmat.shape)} D{tuple(D.shape)} do not "
            "match (B,S,H,P), (B,S,H), (H,), (B,S,N), (B,S,N), (H,)")
    check_ssd_operands(what, (x, Bmat, Cmat), (dt, A, D, *state_in))
    if x.stride(2) != P or not A.is_contiguous() or not D.is_contiguous() \
            or (init_state is not None and not init_state.is_contiguous()):
        raise ValueError(f"{what}: x's (H, P) axes, A, D and init_state "
                         "must be contiguous")
    if route == "cuda" and N not in STATE_DIMS:
        raise ValueError(f"{what}: state size {N} not in {STATE_DIMS}")
    return route


def _launch(x, dt, A, Bmat, Cmat, D, init_state):
    """The forward kernel: (y, final state fp32)."""
    Bsz, S, H, P = x.shape
    N = Bmat.shape[-1]
    if Bsz > 65535 or H > 65535:
        raise ValueError(f"ssd_scan: B={Bsz}, H={H} exceed the grid limit")
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    final = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    err = _lib()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
                 Cmat.data_ptr(), D.data_ptr(),
                 None if init_state is None else init_state.data_ptr(),
                 y.data_ptr(), final.data_ptr(), Bsz, S, H, P, N,
                 x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
                 Bmat.stride(0), Bmat.stride(1), Cmat.stride(0), Cmat.stride(1),
                 DTYPE_CODES[x.dtype],
                 VARIANTS["mma" if takes_mma(x, Bmat, Cmat) else "fma"], x.device.index,
                 torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "ssd_scan kernel launch")
    ssd_scan.launches += 1
    return y, final


class _SSDScan(torch.autograd.Function):
    """The forward kernel (y only), with its inputs saved; the backward
    kernel as the VJP. Under ``torch.utils.checkpoint`` the forward runs
    again in the backward pass; the backward reads only the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, Bmat, Cmat, D, init_state):
        ctx.save_for_backward(x, dt, A, Bmat, Cmat, D, init_state)
        return _launch(x, dt, A, Bmat, Cmat, D, init_state)[0]

    @staticmethod
    def backward(ctx, dy):
        grads = ssd_scan_bwd(*ctx.saved_tensors, dy)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def ssd_scan(x, dt, A, Bmat, Cmat, D, init_state=None, *, with_state=False):
    """Chunked Mamba2 SSD scan over any S. x (B,S,H,P); dt (B,S,H) fp32,
    post-softplus; A, D (H,) fp32; B/C (B,S,N) in x's dtype; init_state
    (B,H,P,N) fp32 or None (zeros). Returns y (B,S,H,P) in x's dtype, or
    (y, final_state fp32) with ``with_state``. Differentiable in every
    input (y only: on the card ``with_state`` under grad raises).

    x, B, C and dt may be views sliced along their batch and sequence axes
    (as the model's column slices of one conv buffer are): the kernels read
    them through those strides, without a copy."""
    route = _check_inputs("ssd_scan", x, dt, A, Bmat, Cmat, D, init_state)
    if route == "cpu":
        y, state = _ref.ssd_chunked_reference(x, dt, A, Bmat, Cmat, D, init_state)
        return (y, state) if with_state else y
    state_in = () if init_state is None else (init_state,)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bmat, Cmat, D,
                                                                  *state_in)):
        if with_state:
            raise NotImplementedError("ssd_scan: only y is differentiable (as in the JAX "
                                      "package, whose with_state path has no VJP); call it "
                                      "under torch.no_grad() or without with_state")
        return _SSDScan.apply(x, dt, A, Bmat, Cmat, D, init_state)
    y, final = _launch(x, dt, A, Bmat, Cmat, D, init_state)
    return (y, final) if with_state else y


ssd_scan.launches = 0


def ssd_scan_bwd(x, dt, A, Bmat, Cmat, D, init_state, dy):
    """The VJP of ``ssd_scan``'s y at these inputs for the cotangent ``dy``
    (B,S,H,P) in x's dtype: (dx, ddt, dA, dB, dC, dD, dinit), dx, dB and dC
    in x's dtype, the rest fp32 (dinit, the initial state's gradient, also
    where ``init_state`` is None). The inputs are taken as ``ssd_scan``
    takes them; dy is made contiguous. On the card the kernel sums every
    gradient in a fixed order: two calls give the same bits."""
    route = _check_inputs("ssd_scan_bwd", x, dt, A, Bmat, Cmat, D, init_state)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssd_scan_bwd: dy {dy.dtype}{tuple(dy.shape)} must match x "
                         f"{x.dtype}{tuple(x.shape)}")
    if route == "cpu":
        return _ref.ssd_backward_reference(x, dt, A, Bmat, Cmat, D, init_state, dy)
    Bsz, S, H, P = x.shape
    N = Bmat.shape[-1]
    if Bsz > 65535:
        raise ValueError(f"ssd_scan_bwd: B={Bsz} exceeds the grid limit")
    smem = bwd_smem_bytes(P, N, x.dtype)
    if smem > BWD_SMEM_LIMIT:
        raise ValueError(f"ssd_scan_bwd: P={P}, N={N} ({x.dtype}) need {smem} bytes of "
                         f"shared memory a block, over {BWD_SMEM_LIMIT}")
    dy = dy.contiguous()
    dev, f32 = x.device, torch.float32
    dx = torch.empty_like(dy)
    ddt = torch.empty((Bsz, S, H), dtype=f32, device=dev)
    dA, dD = torch.empty(H, dtype=f32, device=dev), torch.empty(H, dtype=f32, device=dev)
    dB = torch.empty((Bsz, S, N), dtype=Bmat.dtype, device=dev)
    dC = torch.empty((Bsz, S, N), dtype=Cmat.dtype, device=dev)
    dinit = torch.empty((Bsz, H, P, N), dtype=f32, device=dev)
    # workspaces: each chunk's start state, the per-head partials of dB and
    # dC, and the per-(b, h) partials of dA and dD
    states = torch.empty(Bsz * H * cdiv(S, CHUNK) * cdiv(P, 4) * 4 * N,
                         dtype=state_dtype(x.dtype), device=dev)
    dbc_part = torch.empty(2 * Bsz * H * S * N, dtype=f32, device=dev)
    ad_part = torch.empty(Bsz * H * 2, dtype=f32, device=dev)
    err = _bwd_lib()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
                     Cmat.data_ptr(), D.data_ptr(),
                     None if init_state is None else init_state.data_ptr(), dy.data_ptr(),
                     dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                     dD.data_ptr(), dinit.data_ptr(), states.data_ptr(), dbc_part.data_ptr(),
                     ad_part.data_ptr(), Bsz, S, H, P, N,
                     x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
                     Bmat.stride(0), Bmat.stride(1), Cmat.stride(0), Cmat.stride(1),
                     DTYPE_CODES[x.dtype], dev.index, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "ssd_scan_bwd kernel launch")
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC, dD, dinit


ssd_scan_bwd.launches = 0

decode_step = _ref.ssd_decode_step
