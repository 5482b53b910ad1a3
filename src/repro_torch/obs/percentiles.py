"""Percentile semantics shared by the simulator, the SLO report and the
engine: nearest-rank with round-half-even over the sorted samples --
``sorted(xs)[round(q * (n - 1))]`` for ``q`` in ``[0, 1]`` -- so every
reported percentile is an observed sample, and engine and simulator
numbers line up.

``percentiles`` takes a Python iterable or a 1-d tensor (sorted where it
lies); ``weighted_percentiles`` reads the same rule off run-length
compressed samples -- exactly ``percentiles(np.repeat(values, weights),
q)`` without the expansion -- the bridge from the simulator's
``TokenRuns`` records (weight ``k * b`` tokens a record) to token-level
time-between-token percentiles. Tensors stay on their device; every
result is a Python float.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import torch


def percentile(xs: Iterable[float], q: float) -> float:
    """Nearest-rank percentile of ``xs`` at fraction ``q`` in [0, 1]."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    return float(xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))])


def percentiles(xs: Iterable[float],
                qs: Sequence[float]) -> Tuple[float, ...]:
    """``percentile`` at several fractions with a single sort."""
    if isinstance(xs, torch.Tensor):
        n = xs.numel()
        if not n:
            return tuple(0.0 for _ in qs)
        idx = [min(n - 1, int(round(q * (n - 1)))) for q in qs]
        srt = torch.sort(xs.reshape(-1)).values
        return tuple(float(v) for v in srt[idx].tolist())
    xs = sorted(xs)
    if not xs:
        return tuple(0.0 for _ in qs)
    top = len(xs) - 1
    return tuple(float(xs[min(top, int(round(q * top)))]) for q in qs)


def weighted_percentiles(values, weights,
                         qs: Sequence[float]) -> Tuple[float, ...]:
    """Nearest-rank percentiles of the run-length expansion
    ``np.repeat(values, weights)``, computed from the compressed form.

    ``weights`` are positive integer multiplicities. ``values`` may be a
    tensor (float64) on any device; the weights go to its device."""
    v = torch.as_tensor(values, dtype=torch.float64)
    w = torch.as_tensor(weights, dtype=torch.int64, device=v.device)
    if v.numel() == 0:
        return tuple(0.0 for _ in qs)
    order = torch.sort(v, stable=True).indices
    cw = torch.cumsum(w[order], 0)
    top = int(cw[-1]) - 1
    if top < 0:
        return tuple(0.0 for _ in qs)
    # first compressed entry whose cumulative weight exceeds the expanded
    # index h -- the sample the expansion would hold there
    h = torch.tensor([min(top, int(round(q * top))) for q in qs],
                     dtype=torch.int64, device=v.device)
    at = torch.searchsorted(cw, h, right=True)
    return tuple(float(x) for x in v[order[at]].tolist())


def weighted_percentile(values, weights, q: float) -> float:
    return weighted_percentiles(values, weights, (q,))[0]
