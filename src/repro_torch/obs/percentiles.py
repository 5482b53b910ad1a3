"""Percentile semantics shared with the ``repro`` simulator and engine
(an own copy of ``repro.obs.percentiles.percentile``/``percentiles``).

Nearest-rank with round-half-even over the sorted samples --
``sorted(xs)[round(q * (n - 1))]`` for ``q`` in ``[0, 1]`` -- so every
reported percentile is an observed sample, and engine and simulator
numbers line up.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple


def percentile(xs: Iterable[float], q: float) -> float:
    """Nearest-rank percentile of ``xs`` at fraction ``q`` in [0, 1]."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    return float(xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))])


def percentiles(xs: Iterable[float],
                qs: Sequence[float]) -> Tuple[float, ...]:
    """``percentile`` at several fractions with a single sort."""
    xs = sorted(xs)
    if not xs:
        return tuple(0.0 for _ in qs)
    top = len(xs) - 1
    return tuple(float(xs[min(top, int(round(q * top)))]) for q in qs)
