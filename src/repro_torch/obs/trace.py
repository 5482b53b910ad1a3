"""Structured control-plane tracing (observability pillar (b)).

``TraceLog`` collects typed event/span records from the epoch loop —
``ClusterRuntime`` (solve spans, reconcile actions, preemptions,
restarts, detections), ``ReSolveController`` (trigger decisions with
their reason and drift diagnostics) and ``FaultInjector`` (planned
injections) — and writes them as JSONL to ``artifacts/trace_*.jsonl``.

Each record is a flat JSON object with three required envelope fields
(``kind``, ``t`` — simulation seconds — and ``epoch``) plus the
kind-specific fields listed in :data:`TRACE_SCHEMA`.  Validation is
two-layered: ``emit`` checks the envelope and required fields at write
time (cheap, always on), and a reader (``validate_record``) re-validates the
full schema plus *causal ordering* when reading a file back — e.g.
every ``fault_detect`` must name a prior ``fault_inject`` for its
instance, every ``restart`` a prior detection.

A subtlety the causal checker must honor: ``fault_inject`` records are
emitted when the injector *plans* an epoch, so they carry a future
``t`` and appear in the file before records with smaller timestamps.
Causal order is therefore judged on the ``t`` fields, never on record
position in the file.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

# kind -> required kind-specific fields (beyond the envelope).
TRACE_SCHEMA: Dict[str, tuple] = {
    # epoch solve span: the three-stage breakdown and which ladder
    # tier produced the allocation
    "solve": ("path", "solve_ms", "assembly_ms", "extract_ms",
              "total_ms", "alloc_source"),
    # controller (or fixed-cadence fallback) decision for the epoch
    "trigger": ("resolve", "reason"),
    # mid-epoch event-driven re-solve actually performed
    "mid_resolve": ("reason", "solve_ms"),
    # reconcile summary after an allocation lands
    "reconcile": ("n_new", "n_drained", "n_kept"),
    # capacity reclaimed by the market (spot preemption)
    "preempt": ("iid",),
    # a fault the injector planned (t is the *future* injection time);
    # ``fault`` is the fault class: crash | degrade | flake
    "fault_inject": ("fault", "iid"),
    # the control plane noticed a dead/straggling instance
    "fault_detect": ("iid", "detect_lag_s"),
    # restart attempt outcome for a detected failure
    "restart": ("for_iid", "outcome"),
}

_ENVELOPE = ("kind", "t", "epoch")


class TraceError(ValueError):
    """A trace record broke the schema at emit or read time."""


class TraceLog:
    """In-memory list of trace records with schema-checked ``emit``
    and JSONL ``write``.  Pure observation: emitters never read it."""

    __slots__ = ("records",)

    def __init__(self):
        self.records: List[dict] = []

    def emit(self, kind: str, t: float, epoch: int, **fields):
        if kind not in TRACE_SCHEMA:
            raise TraceError(f"unknown trace record kind {kind!r}")
        missing = [f for f in TRACE_SCHEMA[kind] if f not in fields]
        if missing:
            raise TraceError(
                f"trace record {kind!r} missing fields {missing}")
        rec = {"kind": kind, "t": float(t), "epoch": int(epoch)}
        rec.update(fields)
        self.records.append(rec)

    def by_kind(self, kind: str) -> List[dict]:
        return [r for r in self.records if r["kind"] == kind]

    def write(self, path) -> int:
        """Write all records as JSONL; returns the record count."""
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        return len(self.records)


def validate_record(rec: dict) -> Optional[str]:
    """Full-schema check of one parsed record; returns an error
    string or ``None`` (shared by TraceLog.emit's cheap path and the
    trace_tools reader)."""
    for f in _ENVELOPE:
        if f not in rec:
            return f"missing envelope field {f!r}"
    kind = rec["kind"]
    if kind not in TRACE_SCHEMA:
        return f"unknown kind {kind!r}"
    if not isinstance(rec["t"], (int, float)):
        return f"non-numeric t {rec['t']!r}"
    if not isinstance(rec["epoch"], int):
        return f"non-integer epoch {rec['epoch']!r}"
    missing = [f for f in TRACE_SCHEMA[kind] if f not in rec]
    if missing:
        return f"kind {kind!r} missing fields {missing}"
    return None
