"""Sharding rules and helpers on ``torch.distributed`` device meshes.

The models are written without reference to a mesh, as in the JAX
package: each family's ``param_specs`` / ``cache_specs`` give a tree of
``P`` specs parallel to its params and cache, and activations pass through
``constrain(x, *spec)``, which returns ``x`` itself unless a mesh is active
and ``x`` is a DTensor. Served and trained tensors are plain tensors, so
every ``constrain`` site is the identity for them, with a mesh or without;
the dry-run (``launch/dryrun.py``) builds its params and inputs as DTensors
and installs the production mesh.

Axis convention (the JAX package's):
  * "data"  -- batch / FSDP shard axis (16 in production)
  * "model" -- TP / EP axis (16 in production)
  * "pod"   -- outer data axis across pods (2 in the multi-pod dry-run)
Batch dims use ("pod", "data") when the pod axis exists.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Sequence

import torch

_state = threading.local()


class P(tuple):
    """A partition spec: one entry per tensor dim, each None (replicated),
    a mesh axis name, or a tuple of axis names (the dim is split over all
    of them, the first the outermost). Trailing dims without an entry are
    replicated. Mirrors ``jax.sharding.PartitionSpec``, which also stores a
    one-name tuple as the bare name."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, (tuple, list)) and len(e) == 1
                                     else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def current_mesh():
    """The mesh installed by ``use_mesh``, or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` (a ``DeviceMesh`` with named dims) for this thread."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a named mesh, in mesh-dim order (a dict of them
    is taken as it is)."""
    if isinstance(mesh, dict):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(name: str) -> int:
    mesh = current_mesh()
    if mesh is None:
        return 1
    return mesh_axes(mesh).get(name, 1)


def batch_axes():
    """Logical batch partition: ("pod","data") if pod exists else ("data",)."""
    mesh = current_mesh()
    if mesh is not None and "pod" in mesh.mesh_dim_names:
        return ("pod", "data")
    return ("data",)


def _flatten_spec_axes(entry):
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def sanitize_spec(spec: Sequence, shape, mesh=None) -> P:
    """Drop mesh axes that do not evenly divide the corresponding dim.

    Lets one spec tree serve every mesh: e.g. a (12*128) fused-head dim
    shards over model=16, while a 12-head axis would not and falls back
    to replicated. Unknown axes (mesh without 'pod') are dropped too.
    Without a mesh (``mesh``, a mesh or {axis: size}, or the installed one)
    the spec is P().
    """
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return P()
    sizes = mesh_axes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        kept, prod = [], 1
        for a in _flatten_spec_axes(entry):
            if a in sizes and dim % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return P(*out)


def placements(spec: Sequence, mesh, shape):
    """One DTensor placement per mesh dim for ``spec`` (sanitized against
    ``shape`` on ``mesh`` first): ``Shard(d)`` on each mesh dim of more than
    one rank that an entry of tensor dim d names, ``Replicate()`` on the
    others. Two mesh
    dims may shard one tensor dim, as ("pod", "data") does; the outer one
    is the one first in the mesh, which is the spec's order for every spec
    of this package."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    names, sizes = list(mesh.mesh_dim_names), mesh_axes(mesh)
    for d, entry in enumerate(sanitize_spec(spec, shape, mesh)):
        for a in _flatten_spec_axes(entry):
            if sizes[a] > 1:           # a shard of one is the whole: Replicate
                out[names.index(a)] = Shard(d)
    return out


_DTensor = None      # torch.distributed.tensor.DTensor, imported on first need


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor; a plain tensor is told apart by its type
    alone (the served and trained path asks at every site)."""
    global _DTensor
    if type(x) is torch.Tensor:
        return False
    if _DTensor is None:
        from torch.distributed.tensor import DTensor
        _DTensor = DTensor
    return isinstance(x, _DTensor)


def constrain(x, *spec_entries):
    """Redistribute a DTensor ``x`` to ``spec_entries`` (sanitized) when a
    mesh is active; the counterpart of ``with_sharding_constraint``. Any
    other ``x`` (a plain tensor, served or trained on one card) comes back
    as it is: never copied, never moved."""
    if type(x) is torch.Tensor:
        return x
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    y = x.redistribute(mesh, placements(spec_entries, mesh, x.shape))
    local = y.to_local()
    if local.is_contiguous():
        return y
    # a shard that DTensor cut out of a gathered tensor may be strided (and
    # some local ops then cannot view it): made whole, as a collective's
    # output is
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local.contiguous(), mesh, y.placements, run_check=False,
                              shape=y.shape, stride=y.stride())


def reshape(x, *shape):
    """``x.reshape(*shape)``. A DTensor dim that the reshape splits or merges
    keeps its sharding only where DTensor can view it so: the first dim of a
    merged group, split into an outer size the shard count divides (a fused
    (12*128) head dim over model=16 cannot be split into 12 heads of 128 on
    the shards). Such a dim is gathered first; the others stay sharded.
    The result's gradient is laid out as the result is (``grad_as_input``),
    so that the reshape's backward undoes it on the same layout."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    from torch.distributed.tensor import Replicate

    out = list(shape)
    if -1 in out:
        known = math.prod(d for d in out if d != -1)
        out[out.index(-1)] = x.numel() // known if known else 0
    shards: Dict[int, int] = {}
    for mdim, p in enumerate(x.placements):
        if p.is_shard():
            shards[p.dim] = shards.get(p.dim, 1) * x.device_mesh.size(mdim)
    keep = set()
    i = j = 0
    while i < x.dim() and j < len(out):      # groups of dims with equal products
        i0, j0, pi, pj = i, j, x.shape[i], out[j]
        i, j = i + 1, j + 1
        while pi != pj:
            if pi < pj:
                pi, i = pi * x.shape[i], i + 1
            else:
                pj, j = pj * out[j], j + 1
        if i - i0 == 1 and j - j0 == 1 or out[j0] % shards.get(i0, 1) == 0:
            keep.add(i0)
    placements = [Replicate() if p.is_shard() and p.dim not in keep else p
                  for p in x.placements]
    if placements != list(x.placements):
        x = x.redistribute(x.device_mesh, placements)
    return grad_as_input(x.reshape(*shape))


def rows(x):
    """``x`` constrained to the batch over its dim 0 and every other dim
    whole: where a row-parallel product's partial sums are summed (DTensor
    lays layouts out forward only, and a partial sum left in place makes a
    later product gather its weights in its stead); ``x`` itself for a
    plain tensor."""
    if type(x) is torch.Tensor:
        return x
    return constrain(x, batch_axes(), *([None] * (x.dim() - 1)))


def replicated(fn, *args):
    """``fn(*args)``; where some arg is a DTensor under a mesh, every
    DTensor arg is first gathered to a full replica (the collective is
    issued, so the dry-run counts it), ``fn`` runs on the local replicas,
    and each tensor it returns comes back as a replicated DTensor. The
    fallback for a site whose op has no DTensor sharding rule; for plain
    tensors it is ``fn(*args)`` itself."""
    mesh = current_mesh()
    if mesh is None or not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate

    local = [a.redistribute(mesh, [Replicate()] * mesh.ndim).to_local() if is_dtensor(a)
             else a for a in args]
    out = fn(*local)
    wrap = lambda t: DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,   # noqa: E731
                                        run_check=False) if isinstance(t, torch.Tensor) else t
    return tuple(wrap(t) for t in out) if isinstance(out, tuple) else wrap(out)


def like(g, p):
    """A DTensor gradient ``g`` laid out as its param ``p`` (the data-parallel
    gradient all-reduce, or reduce-scatter under fsdp, of a sharded step);
    any other ``g`` as it is."""
    if not is_dtensor(g) or not is_dtensor(p):
        return g
    return g.redistribute(p.device_mesh, p.placements)


class _GradAsInput(torch.autograd.Function):
    """The identity, whose backward lays the gradient out as the input is."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        # the gradient of a partial sum is the same on every rank
        ctx.layout = (x.device_mesh, [Replicate() if p.is_partial() else p
                                      for p in x.placements])
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.layout)


def grad_as_input(t):
    """``t`` itself for a plain tensor; for a DTensor, a view whose gradient
    is reduced to ``t``'s own layout where it arrives (one layer's slice of
    a stacked param: each layer's gradient synced alike, at any depth,
    before the layers' gradients are stacked)."""
    return _GradAsInput.apply(t) if is_dtensor(t) and t.requires_grad else t


def local(t):
    """A DTensor's shard on this rank, else ``t`` itself."""
    return t.to_local() if is_dtensor(t) else t


def shard_sum(t, fn):
    """``fn(shard)`` (a 0-d tensor) summed over the shards of a DTensor
    ``t``: all-reduced over the mesh dims that shard it, as a plain tensor
    on this rank; ``fn(t)`` for any other ``t``."""
    if not is_dtensor(t):
        return fn(t)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = t.device_mesh
    part = DTensor.from_local(fn(t.to_local()), mesh,
                              [Partial() if p.is_shard() else Replicate() for p in t.placements],
                              run_check=False)
    return part.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def tree_shardings(spec_tree: Dict, shape_tree: Dict) -> Dict:
    """Flat key -> spec and flat key -> shape (or anything with ``.shape``)
    -> flat key -> placements on the installed mesh (dry-run inputs)."""
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("tree_shardings needs a mesh (use_mesh)")
    return {k: placements(spec, mesh, _shape(shape_tree[k])) for k, spec in spec_tree.items()}


def _shape(s):
    return tuple(s.shape) if hasattr(s, "shape") else tuple(s)


def distribute(tree: Dict, spec_tree: Dict) -> Dict:
    """Flat key -> tensor (any device, ``meta`` included) -> flat key ->
    DTensor laid out on the installed mesh by ``spec_tree`` (flat, same
    keys). A ``meta`` tensor gives a meta DTensor: shapes, no storage."""
    from torch.distributed.tensor import distribute_tensor

    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("distribute needs a mesh (use_mesh)")
    return {k: distribute_tensor(t, mesh, placements(spec_tree[k], mesh, t.shape))
            for k, t in tree.items()}
