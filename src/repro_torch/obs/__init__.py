"""Coral observability layer: shared percentile semantics,
per-request SLO latency records and structured control-plane tracing.

Everything in this package is observation-only — importing or enabling
it never changes a simulation outcome.  The query side of the request
log is tensors on the run's device; the trace is host records.
"""
from repro_torch.obs.percentiles import (percentile, percentiles,
                                         weighted_percentile,
                                         weighted_percentiles)
from repro_torch.obs.reqlog import (QS, RequestLog, SLOReport, SLOTargets)
from repro_torch.obs.trace import TRACE_SCHEMA, TraceError, TraceLog, \
    validate_record

__all__ = [
    "percentile", "percentiles", "weighted_percentile",
    "weighted_percentiles", "QS", "RequestLog", "SLOReport",
    "SLOTargets", "TRACE_SCHEMA", "TraceError", "TraceLog",
    "validate_record",
]
