"""Public entry points of the Mamba2 SSD scan and its backward.

``ssd_scan``: a CUDA tensor goes to a hand-written kernel
(``csrc/mamba_scan.cu``) or the call raises; a CPU tensor goes to the plain
chunked version in ``ref.py``, which autograd differentiates. On the card,
under grad (grad mode on and an input that requires grad), the scan runs
inside ``_SSDScan``, a ``torch.autograd.Function`` whose backward is
``ssd_scan_bwd``: the hand-written backward (``csrc/mamba_scan_bwd.cu``, the
port of the reference's ``_ssd_bwd``) on a CUDA tensor, the plain chunked
reverse pass (``ref.ssd_backward_reference``) on a CPU one. As in the JAX
package only y is differentiable there: a CUDA call with ``with_state``
under grad raises NotImplementedError.
``ssd_scan.launches`` and ``ssd_scan_bwd.launches`` count kernel launches,
and nothing else; a call that a CUDA graph's capture only records counts in
the wrapper's ``captured`` instead (``common.count_launch``). bf16 x/B/C go to the forward's tensor-core kernel where
``takes_mma`` holds (P and the strides of x, B and C multiples of 8, the
operands 16-byte aligned, as the model's conv-buffer slices are); fp32, and
bf16 operands it does not take, to the CUDA-core kernel. The backward is
the chunk-parallel decomposition (``bwd_plan`` sets its launch from the
shapes alone): on the tensor cores where ``bwd_takes_mma`` holds (the
forward's rule, and dy 16-byte aligned), else on the CUDA cores, where fp32
inputs keep the state, its adjoint and the sums that set ddt and dA in fp64
(``state_dtype``). Every head the forward takes runs.
``decode_step`` is the one-token recurrence, plain torch as in the JAX
package (which has no kernel for it).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODES, cdiv, check_launch,
                                        check_ssd_operands, count_launch, kernel_route,
                                        plain)
from repro_torch.kernels.mamba_scan import ref as _ref

STATE_DIMS = (16, 32, 64, 128)   # N the CUDA kernels are instantiated for
CHUNK = 64                        # tokens per chunk (csrc kT)
VARIANTS = {"fma": 0, "mma": 1}   # the forward C entry point's `variant`
# The backward C entry point's `variant`: the two-sweep kernel (two sweeps per
# (b, h), kept for comparison), and the chunked backward on the CUDA cores
# or on the tensor cores.
BWD_VARIANTS = {"sweep": 0, "fma": 1, "mma": 2}
SM_SMEM = 233472                  # shared memory of one SM on sm_90 (228 KB)
BLOCK_SMEM_RESERVED = 1024        # the runtime's share of it for each block
PW = 64                           # columns of P in a tile of the tensor-core chunk kernel (csrc kPW)
# Per variant of the chunked backward: rows of P in one block of its states
# kernel (csrc kSP, kFSP) and the most chunk-kernel blocks an SM runs (the
# tensor-core kernel's __launch_bounds__ minimum; the CUDA-core one takes
# 256 threads and most of an SM's shared memory)
STATE_ROWS = {"mma": 64, "fma": 32}
MAX_BLOCKS_PER_SM = {"mma": 2, "fma": 1}


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
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def state_dtype(dtype: torch.dtype) -> torch.dtype:
    """The backward kernel's type for the state, its adjoint and the sums
    that set ddt and dA: fp64 for fp32 inputs (whose tolerance fp32 sums of
    those terms reach), fp32 for bf16 ones."""
    return torch.float64 if dtype == torch.float32 else torch.float32


def bwd_takes_mma(x, Bmat, Cmat, dy) -> bool:
    """Whether the tensor-core backward takes these operands: the forward's
    rule, and dy (contiguous) 16-byte aligned."""
    return takes_mma(x, Bmat, Cmat) and dy.data_ptr() % 16 == 0


def chunk_smem_bytes(N: int, variant: str, dtype: torch.dtype) -> int:
    """Shared memory of one block of the chunked backward's chunk kernel
    (csrc ChunkSmem, chunk_fma_smem). Tensor cores: in bf16 B and C (64 x
    N), a 64-column tile of x and dy, those rows of S0 and G (rounding and
    remainder, 64 x N each), M (64 x 64, rounding and remainder) and W
    summed over the group's heads (64 x 64 fp32, the same bytes); two
    mbarriers; in fp32 dt (this head's and the next), four copies of cum
    (one a warp), and per-token sums. CUDA cores: nine
    per-token vectors, two 16 x 64 column-sum arrays, the d cum parts and 32
    sums in ``state_dtype(dtype)``; in fp32 B and C (rows padded by 4), a
    32-column tile of x and dy, M and W, the group's dB and dC, and dt."""
    T = CHUNK
    if variant == "mma":
        return 2 * (2 * T * N + 2 * T * 64 + 4 * 64 * N + 4 * T * T) + 16 + 4 * (13 * T + 8)
    acc = torch.finfo(state_dtype(dtype)).bits // 8
    parts = N // 32 if N >= 32 else 1
    return acc * (9 * T + 2 * 16 * T + T * parts + 32) + \
        4 * (2 * T * (N + 4) + 2 * T * 36 + 2 * T * (T + 4) + 2 * T * N + T)


@dataclass(frozen=True)
class BwdPlan:
    """The backward's launch at one shape: which kernels, how many heads each
    chunk block loops over, the grids and every workspace's bytes."""
    variant: str                       # a key of BWD_VARIANTS
    chunks: int
    heads_per_group: int               # 0 for "sweep"
    groups: int                        # chunk blocks per (b, chunk)
    blocks_per_sm: int                 # chunk-kernel blocks one SM runs
    states_grid: Tuple[int, int, int]  # (2 x slices of P, H, B); "sweep": (H, B, 1)
    chunk_grid: Tuple[int, int, int]   # (chunks, groups, B); "sweep": ()
    state_bytes: int                   # S0 and G of every (b, h, chunk)
    state_traffic: int                 # of those, bytes written (each read back once)
    dbc_bytes: int                     # dB / dC partials
    ad_bytes: int                      # dA / dD partials

    @property
    def workspace_bytes(self) -> int:
        return self.state_bytes + self.dbc_bytes + self.ad_bytes

    @property
    def workspace_traffic(self) -> int:
        """Workspace bytes written and read back in one call."""
        return 2 * (self.state_traffic + self.dbc_bytes + self.ad_bytes)


@lru_cache(None)
def bwd_plan(B: int, S: int, H: int, P: int, N: int, dtype: torch.dtype, variant: str,
             sms: int, init: bool = False, heads_per_group: int = 0) -> BwdPlan:
    """The launch of ``variant`` from the shapes alone. The chunked variants
    take as many heads per chunk block as one wave of blocks on ``sms`` SMs
    leaves (each (b, chunk) gets ``groups`` blocks: at most the SMs' slots
    over B x chunks, at least one), unless ``heads_per_group`` is given.
    The states kernel writes S0 of every chunk but the first (the first
    too with an initial state) and G of every chunk but the last; on the
    tensor cores each as its bf16 rounding and remainder over P padded to
    whole tiles of PW rows. "sweep" is the two-sweep kernel: one block per (b, h), its workspaces
    the chunk start states ((B, H, chunks, P padded to 4, N) in
    ``state_dtype``), per-head dB / dC partials (2, B, H, S, N) and per-(b,
    h) dA / dD, fp32."""
    nc = cdiv(S, CHUNK)
    acc = torch.finfo(state_dtype(dtype)).bits // 8
    if variant == "sweep":
        states = B * H * nc * cdiv(P, 4) * 4 * N * acc
        return BwdPlan(variant, nc, 0, H, 1, (H, B, 1), (), states, states,
                       2 * B * H * S * N * 4, B * H * 2 * 4)
    if variant not in ("mma", "fma"):
        raise ValueError(f"bwd_plan: variant {variant!r} not in {list(BWD_VARIANTS)}")
    smem = chunk_smem_bytes(N, variant, dtype)
    per_sm = min(MAX_BLOCKS_PER_SM[variant], SM_SMEM // (smem + BLOCK_SMEM_RESERVED))
    if heads_per_group <= 0:
        groups = max(1, min(H, sms * per_sm // (B * nc)))
        heads_per_group = cdiv(H, groups)
    groups = cdiv(H, heads_per_group)
    # tensor cores: P in whole tiles of PW rows, two bf16 planes; CUDA
    # cores: P rows in state_dtype
    rows = cdiv(P, PW) * PW if variant == "mma" else P
    unit = rows * N * (4 if variant == "mma" else acc)
    written = B * H * (2 * (nc - 1) + int(init)) * unit
    return BwdPlan(variant, nc, heads_per_group, groups, per_sm,
                   (2 * cdiv(rows, STATE_ROWS[variant]), H, B), (nc, groups, B),
                   2 * B * H * nc * unit, written, 2 * groups * B * S * N * 4,
                   B * nc * H * 2 * 4)


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
    count_launch(ssd_scan)
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
        y, state = plain(_ref.ssd_chunked_reference, x, dt, A, Bmat, Cmat, D, init_state)
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


ssd_scan.launches = ssd_scan.captured = 0


def ssd_scan_bwd(x, dt, A, Bmat, Cmat, D, init_state, dy):
    """The VJP of ``ssd_scan``'s y at these inputs for the cotangent ``dy``
    (B,S,H,P) in x's dtype: (dx, ddt, dA, dB, dC, dD, dinit), dx, dB and dC
    in x's dtype, the rest fp32 (dinit, the initial state's gradient, also
    where ``init_state`` is None). The inputs are taken as ``ssd_scan``
    takes them, any head included; dy is made contiguous. On the card the
    kernels sum every gradient in a fixed order: two calls give the same
    bits. The route (tensor cores or CUDA cores) follows the dtype and the
    operands' layout (``bwd_takes_mma``); a failed launch raises."""
    route = _check_inputs("ssd_scan_bwd", x, dt, A, Bmat, Cmat, D, init_state)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssd_scan_bwd: dy {dy.dtype}{tuple(dy.shape)} must match x "
                         f"{x.dtype}{tuple(x.shape)}")
    if route == "cpu":
        return plain(_ref.ssd_backward_reference, x, dt, A, Bmat, Cmat, D, init_state, dy)
    dy = dy.contiguous()
    Bsz, S, H, P = x.shape
    variant = "mma" if bwd_takes_mma(x, Bmat, Cmat, dy) else "fma"
    plan = bwd_plan(Bsz, S, H, P, Bmat.shape[-1], x.dtype, variant, _sm_count(x.device.index),
                    init=init_state is not None)
    grads = _bwd_launch(plan, x, dt, A, Bmat, Cmat, D, init_state, dy)
    count_launch(ssd_scan_bwd)
    return grads


def _bwd_launch(plan, x, dt, A, Bmat, Cmat, D, init_state, dy):
    """One call of the backward's C entry point as ``plan`` lays it out (dy
    contiguous): the seven gradients."""
    Bsz, S, H, P = x.shape
    N = Bmat.shape[-1]
    if Bsz > 65535 or H > 65535:
        raise ValueError(f"ssd_scan_bwd: B={Bsz}, H={H} exceed the grid limit")
    dev, f32 = x.device, torch.float32
    dx = torch.empty_like(dy)
    ddt = torch.empty((Bsz, S, H), dtype=f32, device=dev)
    dA, dD = torch.empty(H, dtype=f32, device=dev), torch.empty(H, dtype=f32, device=dev)
    dB = torch.empty((Bsz, S, N), dtype=Bmat.dtype, device=dev)
    dC = torch.empty((Bsz, S, N), dtype=Cmat.dtype, device=dev)
    dinit = torch.empty((Bsz, H, P, N), dtype=f32, device=dev)
    states = torch.empty(plan.state_bytes, dtype=torch.uint8, device=dev)
    dbc_part = torch.empty(plan.dbc_bytes, dtype=torch.uint8, device=dev)
    ad_part = torch.empty(plan.ad_bytes, dtype=torch.uint8, device=dev)
    err = _bwd_lib()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
                     Cmat.data_ptr(), D.data_ptr(),
                     None if init_state is None else init_state.data_ptr(), dy.data_ptr(),
                     dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                     dD.data_ptr(), dinit.data_ptr(), states.data_ptr(), dbc_part.data_ptr(),
                     ad_part.data_ptr(), Bsz, S, H, P, N,
                     x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
                     Bmat.stride(0), Bmat.stride(1), Cmat.stride(0), Cmat.stride(1),
                     plan.heads_per_group, DTYPE_CODES[x.dtype], BWD_VARIANTS[plan.variant],
                     dev.index, _stream(dev))
    check_launch(err, f"ssd_scan_bwd kernel launch ({plan.variant})")
    return dx, ddt, dA, dB, dC, dD, dinit


ssd_scan_bwd.launches = ssd_scan_bwd.captured = 0

decode_step = _ref.ssd_decode_step
