"""Shared kernel utilities: the masking constant, ceiling division and the
device rule every entry point follows."""
from __future__ import annotations

import threading

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # repro::DType in csrc/common.cuh
HEAD_DIMS = (32, 64, 128)   # head dims the CUDA kernels are instantiated for


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def check_launch(err: int, what: str) -> None:
    """Raise on the cudaGetLastError() code a C entry point returned."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def check_aligned(what: str, *tensors: torch.Tensor) -> None:
    """The kernels stage rows with 16-byte loads."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: operands must start on a 16-byte boundary")


def check_operands(what: str, *tensors: torch.Tensor) -> None:
    """One supported dtype, contiguous, non-empty: what the kernels take
    (checked on the CPU path too, so CPU tests see what the card gets)."""
    dtype = tensors[0].dtype
    if dtype not in DTYPE_CODES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{what}: operands must share one dtype of "
                        f"{list(DTYPE_CODES)}, got {[t.dtype for t in tensors]}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
        if t.numel() == 0:
            raise ValueError(f"{what}: empty operand of shape {tuple(t.shape)}")


def check_ssd_operands(what: str, compute, fp32) -> None:
    """The SSD scan's mixed dtypes: x, B and C (``compute``) share one dtype
    of DTYPE_CODES, while dt, A, D and the initial state (``fp32``) are
    float32, as the model keeps them. Every operand is non-empty and its
    last axis is contiguous; x, B, C and dt may be sliced along their batch
    and sequence axes (the kernel takes those strides), A, D and the state
    are contiguous. Checked on the CPU path too, so CPU tests see what the
    card gets."""
    dtype = compute[0].dtype
    if dtype not in DTYPE_CODES or any(t.dtype != dtype for t in compute):
        raise TypeError(f"{what}: x, B and C must share one dtype of "
                        f"{list(DTYPE_CODES)}, got {[t.dtype for t in compute]}")
    if any(t.dtype != torch.float32 for t in fp32):
        raise TypeError(f"{what}: dt, A, D and the state must be float32, "
                        f"got {[t.dtype for t in fp32]}")
    for t in (*compute, *fp32):
        if t.numel() == 0:
            raise ValueError(f"{what}: empty operand of shape {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: operands must be contiguous in their last axis")


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel: in ``wrapper.launches``
    where it ran, in ``wrapper.captured`` where a CUDA graph's capture only
    recorded it (it runs at each replay of the graph, which no wrapper
    sees). A build of torch without CUDA (a test that stubs the C entry
    point) captures nothing."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


_observer = threading.local()


def plain(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``: a kernel's plain version, the route of a tensor
    on the CPU or the meta device. An observer installed by ``observe_plain``
    (the dry-run's cost analysis, or ``distributed.shard_kernels.per_shard``,
    which runs it on each rank's shards) is handed the call instead."""
    obs = getattr(_observer, "fn", None)
    if obs is None:
        return fn(*args, **kwargs)
    return obs(fn, args, kwargs)


def observe_plain(obs):
    """Install ``obs(fn, args, kwargs)`` around every ``plain`` call of this
    thread (None removes it); returns the one it replaces, which ``obs``
    calls in its turn where it runs ``fn``."""
    prev = getattr(_observer, "fn", None)
    _observer.fn = obs
    return prev


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises if CUDA is
    asked for and absent (there is no silent move to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda.is_available() "
                           "is false; pass device='cpu' to run on the CPU")
    return dev


def kernel_route(*tensors: torch.Tensor) -> str:
    """'cuda' when every tensor lies on one CUDA device; 'cpu', the plain
    version's route and its only use, when every tensor lies on the CPU or
    on the meta device (shapes without data: the dry-run's tensors, whose
    costs are the plain version's); raises else, and for a DTensor on the
    card (a kernel takes the local tensors of one rank, never a DTensor)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no kernel for device {dev}")
    if dev.type == "cuda" and any(type(t) is not torch.Tensor and _is_dtensor(t)
                                  for t in tensors):
        raise TypeError("no kernel takes a DTensor on the card: pass its local tensor")
    return "cuda" if dev.type == "cuda" else "cpu"


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)
