"""Device meshes over the current ``torch.distributed`` process group.

``make_production_mesh`` is a function, not a module-level constant, so
importing this module touches no process group. The single-pod mesh is
16x16 = 256 ranks ("data", "model"); the multi-pod mesh adds a leading
"pod" axis (2x16x16 = 512 ranks). When the group has more ranks than the
mesh needs (the dry-run's fake group has 512), the first ``prod(shape)``
ranks are used. ``process_group`` sets up and tears down the group itself:
a fake one of any size for the dry-run on the CPU (no collective moves a
byte), or a one-rank group on the card.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from repro_torch.kernels.common import resolve_device

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


@contextlib.contextmanager
def process_group(world_size: int = 1, backend: str = "fake"):
    """This process as rank 0 of a new default group, destroyed on
    exit. ``backend="fake"`` gives a group of any size whose collectives
    return at once (the dry-run's); "nccl" or "gloo" with world size 1 gives
    a real one-rank group. The store is in-process (no address, no port)."""
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists; destroy it first")
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    else:
        if world_size != 1:
            raise ValueError(f"an in-process store serves one rank, not {world_size}")
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=0, world_size=world_size)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _mesh(device_type: str, shape, axes):
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    have = dist.get_world_size()
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {have} — "
            "run through launch/dryrun.py which sets up a fake process group of 512 ranks")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The 16x16 ("data", "model") mesh, or 2x16x16 ("pod", "data",
    "model") with ``multi_pod``, over the first ranks of the current group."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return _mesh(device_type, shape, axes)


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A mesh of any shape over the first ranks of the current group."""
    return _mesh(device_type, tuple(shape), tuple(axes))


def make_debug_mesh(axis: str = "data", device=None):
    """A one-rank mesh on the card (``device`` None), or on the device the
    caller names (``"cpu"``), for smoke tests of sharded code paths."""
    return _mesh(resolve_device(device).type, (1,), (axis,))
