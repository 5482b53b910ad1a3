"""Loop-aware cost analysis of a step traced in PyTorch: the counterpart of
the JAX package's ``launch/hlo_analysis.py``, which reads the same four
quantities out of XLA's optimized HLO.

``CostMode`` is one ``TorchDispatchMode``. It sees each op on the tensors
that one rank holds: a DTensor op is let through to DTensor's own dispatch
(the mode declines it), which runs it as ops on the local shards and as
the collectives its redistributions need, and the mode counts those. So
every count is per rank, and an op is never counted twice at the global
and the local shape. It counts:

  * flops            -- matmul and attention FLOPs, by the formulas of
                        ``torch.utils.flop_counter`` (2 x M x N x K a
                        product; the rest of the ops count none, as the
                        reference counts only dots)
  * traffic          -- HBM traffic proxy: operand plus result bytes of
                        every op that computes (views, metadata ops,
                        factories and the collectives excluded, as the
                        reference's ``_VIEW_OPS`` exclude theirs)
  * collectives      -- result bytes of each all-gather, all-reduce,
                        reduce-scatter, all-to-all and permute, by kind
  * peak_bytes       -- the peak of live bytes: each op's new outputs are
                        added when made and taken off when their storage
                        is freed, on top of ``base_bytes`` (what lived
                        before the trace: params, optimizer state, inputs);
                        ``segment_peaks`` has the peak of each stretch of
                        ops inside and outside autograd's backward (a train
                        step: forward and loss, backward, optimizer), so
                        that traces of several depths can be combined
                        stretch by stretch

A kernel's plain version (``kernels.common.plain``: the route of a meta
tensor) counts as the kernel it stands for, as the reference counts a
fusion: its FLOPs are the plain version's (flash attention's full S x S
product, which the kernel halves under a causal mask), its traffic that of
its inputs and outputs once, and its temporaries (the S x S scores) are not
live memory; its collectives are counted.

Loops. The reference multiplies a ``while`` body by its trip count. The
port's models run Python loops (over layers, over the sLSTM's tokens, over
scan chunks), so the dry-run traces the step at a few small depths (and,
for the xLSTM, two sequence lengths) and combines the traces linearly
(``launch/dryrun.py``, ``trace_plan``): each count is an exact linear
function of the layer counts (and of S where the dry-run extrapolates in
S), so a few traces give it at any depth.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collectives (what DTensor's redistributions issue) by kind
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")

# ops that move no data: they read metadata, make a view, wait on a
# collective already counted, or only reserve memory
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "wait_tensor", "detach", "alias", "lift_fresh", "_local_scalar_dense",
               "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "size",
               "stride", "is_contiguous", "set_", "resize_", "copy_for_view"}


def _tensors(tree) -> Iterable[torch.Tensor]:
    return (t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank, else ``t``."""
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def nbytes(t: torch.Tensor) -> int:
    """Bytes this rank holds of ``t``."""
    t = _local(t)
    return t.numel() * t.element_size()


@dataclass
class Cost:
    flops: float = 0.0
    traffic: float = 0.0
    collectives: Dict[str, float] = field(default_factory=dict)
    peak_bytes: float = 0.0
    segment_peaks: List[float] = field(default_factory=list)

    def add(self, other: "Cost", mult: float = 1.0):
        """Add ``mult`` x ``other`` to every count, the peaks included (a
        linear combination of traces; see the module docstring)."""
        self.flops += mult * other.flops
        self.traffic += mult * other.traffic
        self.peak_bytes += mult * other.peak_bytes
        if not self.segment_peaks:
            self.segment_peaks = [0.0] * len(other.segment_peaks)
        if len(other.segment_peaks) != len(self.segment_peaks):
            raise ValueError("costs of steps with different segments cannot be combined")
        self.segment_peaks = [a + mult * b for a, b in
                              zip(self.segment_peaks, other.segment_peaks)]
        for k, v in other.collectives.items():
            self.collectives[k] = self.collectives.get(k, 0.0) + mult * v

    @property
    def collective_total(self) -> float:
        return sum(self.collectives.values())


def combine(terms: Iterable[Tuple[float, Cost]]) -> Cost:
    """sum_i coef_i x cost_i."""
    out = Cost()
    for coef, cost in terms:
        out.add(cost, coef)
    return out


class CostMode(TorchDispatchMode):
    """Counts flops, traffic, collective bytes and the peak of live bytes of
    every op run under it, per rank (see the module docstring). Use as a
    context manager; ``cost`` holds the counts."""

    def __init__(self, base_bytes: float = 0.0):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor = DTensor
        self._fake = FakeTensor
        self._flops = flop_registry
        self.cost = Cost(peak_bytes=base_bytes)
        self.live = base_bytes
        self._seen: Dict[int, int] = {}     # id(storage) -> bytes, while it lives
        self._inside = 0                    # depth of plain-version calls
        self._prev = None
        self._backward = False              # whether the current segment is a backward's
        self._window = base_bytes           # the current segment's peak so far

    def _segment(self):
        """Start a new segment when the op stream enters or leaves
        autograd's backward."""
        backward = torch._C._current_graph_task_id() != -1
        if backward != self._backward:
            self.cost.segment_peaks.append(self._window)
            self._window, self._backward = self.live, backward

    def finish(self):
        """Close the last segment (``analyse`` does)."""
        self.cost.segment_peaks.append(self._window)

    def __enter__(self):
        from repro_torch.kernels.common import observe_plain
        self._prev = observe_plain(self._plain)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels.common import observe_plain
        observe_plain(self._prev)
        return super().__exit__(*exc)

    def _plain(self, fn, args, kwargs):
        """One kernel's plain version: see the module docstring."""
        self._inside += 1
        try:
            out = fn(*args, **kwargs) if self._prev is None else self._prev(fn, args, kwargs)
        finally:
            self._inside -= 1
        if not self._inside:
            self.cost.traffic += sum(nbytes(t) for t in _tensors((args, kwargs, out)))
            self._track(out, (args, kwargs))
        return out

    def _release(self, key: int):
        self.live -= self._seen.pop(key, 0)

    def _track(self, out, inputs=()):
        """Count each new storage among ``out``'s tensors as live until it
        is freed; one that an input holds (an in-place op's result, a
        tensor the trace did not make) is not new."""
        held = {id(_local(t).untyped_storage()) for t in _tensors(inputs)}
        for t in _tensors(out):
            st = _local(t).untyped_storage()
            key = id(st)
            if key in self._seen or key in held:
                continue
            size = st.nbytes()
            self._seen[key] = size
            self.live += size
            weakref.finalize(st, self._release, key)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)
        self._window = max(self._window, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented          # let DTensor run it on the local shards
        out = func(*args, **kwargs)
        if any(isinstance(t, self._fake) for t in _tensors((out, args, kwargs))):
            return out                     # DTensor's shape propagation, global shapes
        self._segment()
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        if ns in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                self.cost.collectives[kind] = self.cost.collectives.get(kind, 0.0) \
                    + sum(nbytes(t) for t in _tensors(out))
                if not self._inside:
                    self._track(out, (args, kwargs))
            return out
        if packet in self._flops:
            self.cost.flops += self._flops[packet](*args, **kwargs, out_val=out)
        if func.is_view or name in _NO_TRAFFIC or ns == "prim" or self._inside:
            return out
        self.cost.traffic += sum(nbytes(t) for t in _tensors((args, kwargs))) \
            + sum(nbytes(t) for t in _tensors(out))
        self._track(out, (args, kwargs))
        return out


def analyse(fn, *args, base_bytes: float = 0.0, **kwargs) -> Tuple[object, Cost]:
    """Run ``fn(*args, **kwargs)`` under a ``CostMode``; (its result, the cost)."""
    with CostMode(base_bytes) as mode:
        out = fn(*args, **kwargs)
    mode.finish()
    return out, mode.cost
