"""Public entry points of the Mamba2 SSD scan (inference only).

``ssd_scan``: a CUDA tensor goes to a hand-written kernel
(``csrc/mamba_scan.cu``) or the call raises; a CPU tensor goes to the plain
chunked version in ``ref.py``. ``ssd_scan.launches`` counts kernel launches,
and nothing else. The kernel has no backward yet (the reference's
``_ssd_bwd`` is still to port): a CUDA call that would need one (grad mode
on and an input that requires grad) raises NotImplementedError, where the
plain version on the CPU stays differentiable. bf16 x/B/C go to the
tensor-core kernel where
``takes_mma`` holds (P and the strides of x, B and C multiples of 8, the
operands 16-byte aligned, as the model's conv-buffer slices are); fp32, and
bf16 operands it does not take, to the CUDA-core kernel. ``decode_step`` is the one-token recurrence, plain torch
as in the JAX package (which has no kernel for it).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODES, check_launch,
                                        check_ssd_operands, kernel_route)
from repro_torch.kernels.mamba_scan import ref as _ref

STATE_DIMS = (16, 32, 64, 128)   # N the CUDA kernel is instantiated for
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


def ssd_scan(x, dt, A, Bmat, Cmat, D, init_state=None, *, with_state=False):
    """Chunked Mamba2 SSD scan over any S. x (B,S,H,P); dt (B,S,H) fp32,
    post-softplus; A, D (H,) fp32; B/C (B,S,N) in x's dtype; init_state
    (B,H,P,N) fp32 or None (zeros). Returns y (B,S,H,P) in x's dtype, or
    (y, final_state fp32) with ``with_state``.

    x, B, C and dt may be views sliced along their batch and sequence axes
    (as the model's column slices of one conv buffer are): the kernel reads
    them through those strides, without a copy."""
    state_in = () if init_state is None else (init_state,)
    route = kernel_route(x, dt, A, Bmat, Cmat, D, *state_in)
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x{tuple(x.shape)} must be (B, S, H, P)")
    Bsz, S, H, P = x.shape
    N = Bmat.shape[-1]
    if (dt.shape != (Bsz, S, H) or A.shape != (H,) or D.shape != (H,)
            or Bmat.shape != (Bsz, S, N) or Cmat.shape != (Bsz, S, N)
            or (init_state is not None and init_state.shape != (Bsz, H, P, N))):
        raise ValueError(
            f"ssd_scan: x{tuple(x.shape)} dt{tuple(dt.shape)} A{tuple(A.shape)} "
            f"B{tuple(Bmat.shape)} C{tuple(Cmat.shape)} D{tuple(D.shape)} do not "
            "match (B,S,H,P), (B,S,H), (H,), (B,S,N), (B,S,N), (H,)")
    check_ssd_operands("ssd_scan", (x, Bmat, Cmat), (dt, A, D, *state_in))
    if x.stride(2) != P or not A.is_contiguous() or not D.is_contiguous() \
            or (init_state is not None and not init_state.is_contiguous()):
        raise ValueError("ssd_scan: x's (H, P) axes, A, D and init_state "
                         "must be contiguous")
    if route == "cpu":
        y, state = _ref.ssd_chunked_reference(x, dt, A, Bmat, Cmat, D, init_state)
        return (y, state) if with_state else y

    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bmat, Cmat, D,
                                                                  *state_in)):
        raise NotImplementedError("ssd_scan: the CUDA kernel has no backward yet (the "
                                  "SSD scan's gradient is not ported); call it under "
                                  "torch.no_grad() or with inputs that do not require grad")
    if N not in STATE_DIMS:
        raise ValueError(f"ssd_scan: state size {N} not in {STATE_DIMS}")
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
    return (y, final) if with_state else y


ssd_scan.launches = 0

decode_step = _ref.ssd_decode_step
