"""Runtime invariant checks of the control plane (enable with
``CORAL_SANITIZE=1``).

Every check is gated on :func:`sanitize_enabled`, read once per call so
tests can flip the environment variable. A violation raises
:class:`InvariantViolation`, an ``AssertionError`` subclass so test
harnesses treat it like a failed assert.

Checked invariants:

* **demands**: every demand is finite and non-negative;
* **allocation**: a solved allocation uses only nodes its availability
  offered, with non-negative integer instance counts.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Tuple


class InvariantViolation(AssertionError):
    """A Coral accounting/lifecycle contract was broken at runtime."""


def sanitize_enabled() -> bool:
    return os.environ.get("CORAL_SANITIZE", "") not in ("", "0")


def _fail(msg: str):
    raise InvariantViolation(msg)


# ------------------------------------------------------------ control plane
def check_demands(demands):
    """Estimator/oracle demands are finite and non-negative."""
    for d in demands:
        v = d.tokens_per_s
        if not math.isfinite(v) or v < 0.0:
            _fail(f"demand ({d.model}, {d.phase}) has invalid "
                  f"tokens_per_s={v!r}")


def _node_usage(alloc) -> Dict[Tuple[str, str], int]:
    used: Dict[Tuple[str, str], int] = {}
    for (rname, tkey), n in alloc.instances.items():
        t = alloc.templates.get(tkey)
        if t is None:
            _fail(f"allocation references unknown template {tkey}")
        for cname, k in t.counts:
            key = (rname, cname)
            used[key] = used.get(key, 0) + n * k
    return used


def check_allocation(alloc, availability: Dict[Tuple[str, str], int]):
    """A *solved* allocation stays within the availability it saw."""
    for key in sorted(alloc.instances):
        n = alloc.instances[key]
        if not isinstance(n, int) or n < 0:
            _fail(f"allocation count for {key} is {n!r} "
                  "(must be a non-negative int)")
    used = _node_usage(alloc)
    for key in sorted(used):
        if used[key] > availability.get(key, 0):
            _fail(f"allocation uses {used[key]} x {key} but only "
                  f"{availability.get(key, 0)} were available")
