"""Per-request latency records and SLO summaries (observability
pillar (a)).

``RequestLog`` is the simulator's per-request lifecycle record, built
for a near-free event path and lazily-built, cached tensors on the run's
device on the query side (``cuda`` unless the caller names another).  Two tables per model:

* **first-token table** — one ``(rid, arrival, t_first)`` tuple per
  request at its first generated token; TTFT is ``t_first - arrival``.
  In this simulator the first token lands at prefill completion (the
  decode pipeline latency is the *per-token* SLO), so ``t_first`` is
  the request's ``prefill_done`` stamp and a request that loses a
  prefill pass to a node failure records nothing for the lost pass —
  exactly the retired ``Simulator.prefill_lat`` semantics, minus the
  unbounded per-model Python float lists.  Tuples are snapshotted
  eagerly because a re-prefill after a kill overwrites the request's
  ``prefill_done`` field.
* **terminal table** — one row per request outcome: ``finished``,
  ``dropped`` (no pool and none initializing) or ``shed`` (admission
  control).  The event path appends only the ``Request`` object itself
  (the simulator keeps finished requests alive anyway); columns are
  synthesized on first query, and lost rows always read
  ``(-1, -1, 0, 0, 0)`` for the post-arrival fields regardless of how
  far the request got — so batched and oracle runs, which may drop a
  request at different internal points, still produce identical
  records.  The per-model outcome counters mirror the simulator's
  ``dropped_by_model``/``shed_by_model``/``finished`` accounting and
  are cross-checked against them by the ``CORAL_SANITIZE=1`` sanitizer
  (``repro_torch.debug.invariants``).

Time-between-tokens (TBT) needs no per-token instrumentation at all:
``TokenRuns.gap_samples`` serves iteration-gap samples straight from
the existing run-length token records (one ``(dt, k*b)`` pair per
segment), and ``weighted_percentiles`` reads token-level percentiles
off the compressed form.  Batched mode therefore pays near-zero
logging overhead.

``SLOReport`` combines both: per-(model, window) TTFT and TBT
p50/p95/p99, SLO-attainment fractions against configurable
``SLOTargets`` (defaulting to each model's ``prefill_slo_ms`` /
``decode_slo_ms``), and windowed tail series.  Everything here is
observation-only: nothing feeds back into simulation decisions, so the
batched-vs-oracle bit-identity contract is untouched.

Every query is a sort, a ``searchsorted``, an elementwise comparison or
a sum of integer-valued float64 or int64 on the device, so its result is
the host's to the bit; each returns Python numbers (attainment fractions
are ``count / n`` in Python).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Tuple

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.obs.percentiles import percentiles, weighted_percentiles

# statuses of a terminal record
FINISHED, DROPPED, SHED = 0, 1, 2

# the percentile grid every SLO summary reports
QS = (0.50, 0.95, 0.99)


class _ModelLog:
    """One model's lifecycle tables: first-token tuples (snapshotted)
    plus the terminal ``Request`` references, with a lazy tensor view
    over the first-token table on ``device``."""

    __slots__ = ("first", "fin", "drop", "shd", "_np", "device")

    def __init__(self, device: torch.device):
        self.device = device
        self.first: List[Tuple[int, float, float]] = []
        self.fin: list = []     # finished Request objects
        self.drop: list = []    # dropped Request objects
        self.shd: list = []     # shed Request objects
        self._np = None         # cached (t_first sorted, ttft sorted)

    def first_arrays(self):
        if self._np is None:
            f64 = dict(dtype=torch.float64, device=self.device)
            if self.first:
                a = torch.tensor(self.first, dtype=torch.float64).to(
                    self.device)
                t = a[:, 2]
                ttft = t - a[:, 1]
                order = torch.sort(t, stable=True).indices
                self._np = (t[order].contiguous(), ttft[order].contiguous())
            else:
                self._np = (torch.zeros(0, **f64), torch.zeros(0, **f64))
        return self._np


class RequestLog:
    """Per-request lifecycle log for one ``Simulator``.  The event-path
    methods do one list append each — priced under the <5% budget on
    the sim_loop bench's pure-decode drain."""

    __slots__ = ("models", "_logs", "device")

    def __init__(self, models: Iterable[str], device=None):
        self.models = tuple(models)
        self.device = resolve_device(device)
        self._logs: Dict[str, _ModelLog] = {m: _ModelLog(self.device)
                                            for m in self.models}

    # ------------------------------------------------------ event path
    def note_first(self, model: str, rid: int, arrival: float, t: float):
        lg = self._logs[model]
        lg.first.append((rid, arrival, t))
        lg._np = None

    def note_finished(self, req):
        self._logs[req.model].fin.append(req)

    def finished_sink(self, model: str) -> list:
        """The raw finished-request list for ``model``: the simulator's
        finish boundary binds it once per settle and appends Request
        objects directly (same effect as ``note_finished``, minus a
        method call per request on the hottest path)."""
        return self._logs[model].fin

    def note_dropped(self, req):
        self._logs[req.model].drop.append(req)

    def note_shed(self, req):
        self._logs[req.model].shd.append(req)

    # ------------------------------------------------------- counters
    # built on demand so the event path never touches a dict counter
    @property
    def n_first(self) -> Dict[str, int]:
        return {m: len(lg.first) for m, lg in self._logs.items()}

    @property
    def n_finished(self) -> Dict[str, int]:
        return {m: len(lg.fin) for m, lg in self._logs.items()}

    @property
    def n_dropped(self) -> Dict[str, int]:
        return {m: len(lg.drop) for m, lg in self._logs.items()}

    @property
    def n_shed(self) -> Dict[str, int]:
        return {m: len(lg.shd) for m, lg in self._logs.items()}

    # ------------------------------------------------------ query side
    def ttft_values(self, model: str) -> torch.Tensor:
        """Every recorded TTFT (first-token time minus arrival), sorted
        by first-token time, on the log's device."""
        return self._logs[model].first_arrays()[1]

    def ttft_in(self, model: str, t0: float, t1: float) -> torch.Tensor:
        """TTFT samples whose first-token time lies in [t0, t1)."""
        t, ttft = self._logs[model].first_arrays()
        i0, i1 = torch.searchsorted(
            t, torch.tensor([t0, t1], dtype=torch.float64,
                            device=t.device)).tolist()
        return ttft[i0:i1]

    def first_records(self, model: str) -> List[Tuple]:
        """Sorted (rid, arrival, t_first) rows — the batched and oracle
        loops may record them in a different order, but the *sets* must
        be identical (equivalence tests sort before comparing)."""
        return sorted(self._logs[model].first)

    def terminal_records(self, model: str) -> List[Tuple]:
        """Sorted (rid, status, arrival, prefill_done, finish,
        output_len, tokens_ok, slo_ok) rows.  Lost rows read constant
        post-arrival fields (see module docstring) so batched and
        oracle runs compare equal."""
        lg = self._logs[model]
        rows = [(r.rid, FINISHED, r.arrival, r.prefill_done, r.finish,
                 r.output_len, r.decode_tokens_ok, r.decode_slo_ok)
                for r in lg.fin]
        rows += [(r.rid, DROPPED, r.arrival, -1.0, -1.0, 0, 0, 0)
                 for r in lg.drop]
        rows += [(r.rid, SHED, r.arrival, -1.0, -1.0, 0, 0, 0)
                 for r in lg.shd]
        return sorted(rows)


# --------------------------------------------------------------- targets
@dataclass(frozen=True)
class SLOTargets:
    """Per-model latency targets the attainment fractions score
    against: TTFT (seconds) and time-between-tokens (seconds)."""

    ttft_s: Mapping[str, float]
    tbt_s: Mapping[str, float]

    @staticmethod
    def from_models(models: Mapping[str, object]) -> "SLOTargets":
        """Defaults from each ServedModel's paper SLOs: the prefill
        latency SLO bounds TTFT, the decode SLO bounds the token gap."""
        return SLOTargets(
            ttft_s={m: sm.prefill_slo_ms / 1e3
                    for m, sm in models.items()},
            tbt_s={m: sm.decode_slo_ms / 1e3 for m, sm in models.items()})


# ---------------------------------------------------------------- report
class SLOReport:
    """Windowed TTFT / TBT percentile + attainment summaries over a
    simulator's ``RequestLog`` and ``TokenRuns`` tables.

    Window semantics: a TTFT sample belongs to the window containing
    its *first-token* time; a TBT sample (one iteration gap, weighted
    by the tokens it emitted) to the window containing its iteration
    boundary — matching ``goodput``'s token-window rule.  Empty windows
    report 0.0 percentiles and vacuous attainment 1.0 with
    ``n_ttft``/``n_tbt_tokens`` saying how many samples backed the
    numbers.
    """

    def __init__(self, reqlog: RequestLog, tokens: Dict[str, object],
                 targets: SLOTargets):
        self.reqlog = reqlog
        self.tokens = tokens
        self.targets = targets

    def model_window(self, model: str, t0: float,
                     t1: float) -> Dict[str, float]:
        ttft = self.reqlog.ttft_in(model, t0, t1)
        n_ttft = ttft.numel()
        p50, p95, p99 = percentiles(ttft, QS)
        tgt_f = self.targets.ttft_s.get(model, float("inf"))
        attain_f = int((ttft <= tgt_f).sum()) / n_ttft if n_ttft else 1.0
        vals, wts = self.tokens[model].gap_samples(t0, t1)
        g50, g95, g99 = weighted_percentiles(vals, wts, QS)
        tgt_g = self.targets.tbt_s.get(model, float("inf"))
        n_tok, n_ok = (int(x) for x in torch.stack(
            [wts.sum(), wts[vals <= tgt_g].sum()]).tolist())
        attain_g = float(n_ok) / n_tok if n_tok else 1.0
        return {
            "ttft_p50": p50, "ttft_p95": p95, "ttft_p99": p99,
            "tbt_p50": g50, "tbt_p95": g95, "tbt_p99": g99,
            "ttft_attain": attain_f, "tbt_attain": attain_g,
            "n_ttft": float(n_ttft), "n_tbt_tokens": float(n_tok),
        }

    def window(self, t0: float, t1: float) -> Dict[str, Dict[str, float]]:
        return {m: self.model_window(m, t0, t1)
                for m in self.reqlog.models}

    def series(self, model: str, window_s: float, t0: float,
               t1: float) -> List[Dict[str, float]]:
        """Windowed tail series: one summary per ``window_s`` stretch
        of [t0, t1), each tagged with its window edges."""
        out = []
        n = max(int(round((t1 - t0) / window_s)), 1)
        for w in range(n):
            w0 = t0 + w * window_s
            w1 = min(w0 + window_s, t1)
            d = self.model_window(model, w0, w1)
            d["t0"], d["t1"] = w0, w1
            out.append(d)
        return out
