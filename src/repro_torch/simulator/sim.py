"""Event-based multi-LLM serving simulator (paper §5.2, §6.2).

Faithful to the Coral runtime design (Fig. 5): a coordinator hosts the
router (weighted round-robin by template throughput, with EWMA straggler
feedback); each Serving Instance runs chunked-prefill or
continuous-batching decode iterations whose durations come from the
stage-granularity cost model; KV caches are transferred prefill->decode
with a bandwidth/latency model; scale-down drains, scale-up pays an
initialization delay.

Event-loop performance: the decode hot
path is batched.  Decode dynamics are piecewise-deterministic — between
KV joins, the resident set only changes at *known* iteration counts
(each request finishes after its remaining output tokens) — so instead
of one heap event per iteration the simulator schedules a *span*: a
segment schedule (batch size, iteration time, SLO verdict per segment)
covering many iterations, ending where the schedule would be
invalidated (an admission from a non-empty queue at the first finisher,
the run horizon, or the adaptive span budget).  A KV join or a node
failure mid-span settles the iterations whose boundaries have already
passed and converts the in-flight iteration back into a per-iteration
event; a join that lands on a *full* instance merely queues (it cannot
change the running batch) and is logged for the EWMA replay, leaving
the span intact.  Iteration boundaries are accumulated sequentially
(``t += dt``, never reconstructed as ``t0 + i*dt``), so the batched
loop reproduces the reference per-iteration loop's accounting
bit-for-bit.  ``batched=False`` keeps the one-event-per-iteration loop
as the equivalence oracle.

Two data-structure choices keep span bookkeeping off the O(batch) path:

* Residents are a list sorted by *absolute finish iteration* (the
  instance's cumulative iteration counter at join + the request's
  output length).  Settling a span pops finishers off the front;
  requests that did not finish are untouched.  Per-request token/SLO
  counters derive in O(1) at finish from the instance's cumulative
  ``iters``/``ok_iters`` counters snapshotted at join time (they
  materialize when a request finishes or is re-routed by a failure).
* Token accounting is run-length compressed (``TokenRuns``): one
  record per span segment instead of ``k * batch`` per-token objects;
  ``goodput``/``throughput`` queries count whole runs with masks on
  the device, expanding only the (rare) runs that straddle a query
  edge on the host.

Where it runs: the event queue, the per-request objects, the span
schedule and the cost model's floats are host Python (every event
branches on them; a device op per event would cost a launch and a sync
thousands of times an epoch).  The observables' query side -- the token
runs, the arrival table and the request log's first-token table -- is
float64/int64 tensors on the simulator's ``device`` (``cuda`` unless the
caller names another), built lazily at query time; every query returns
Python numbers equal to the host's to the bit.
"""
from __future__ import annotations

import heapq
import itertools
from bisect import bisect_right
from collections import deque
from dataclasses import dataclass
from itertools import accumulate, islice, repeat
from typing import Callable, Deque, Dict, List, Optional, Tuple

import torch

from repro_torch.core.hardware import NodeConfig, Region
from repro_torch.core.modelspec import ServedModel
from repro_torch.core.templates import ServingTemplate
from repro_torch.debug import invariants as _inv
from repro_torch.kernels.common import resolve_device
from repro_torch.obs.reqlog import RequestLog
from repro_torch.simulator.costmodel import InstanceCostModel
from repro_torch.traces.workloads import Request

INIT_DELAY_S = 90.0           # node start + weight load + warmup (§5.1)

SPAN_MAX = 4096               # hard cap on the adaptive span budget


@dataclass
class ShedPolicy:
    """Admission control: shed a new arrival when its prefill pool's
    total queued requests exceed ``max_queue_per_instance`` per live
    *ready* instance — a drain bound: backlog beyond it cannot be
    worked off before it goes stale, so accepting it only inflates
    every queue behind it.  Shedding applies to fresh arrivals at
    admission (``_on_arrival``) only; requests already admitted —
    including cold-start holds being flushed and a killed instance's
    re-routed queue — are never shed.  With no ready prefill instance
    the cold-start hold/drop path decides instead."""

    max_queue_per_instance: float = 32.0


class EventQueue:
    def __init__(self):
        self._q: List = []
        self._c = itertools.count()

    def push(self, t: float, fn: Callable, *args):
        heapq.heappush(self._q, (t, next(self._c), fn, args))

    def pop(self):
        return heapq.heappop(self._q)

    def __bool__(self):
        return bool(self._q)


class TokenRuns:
    """Generated-token accounting for one model, as run-length records.

    A run is ``k`` consecutive decode iterations of constant batch size
    ``b`` and constant SLO verdict ``ok``; its iteration boundaries are
    ``t0 + dt, (t0 + dt) + dt, ...`` accumulated *sequentially* (the
    floats the per-iteration loop would have produced) with the last
    boundary stored as ``end``.  The event path appends to Python lists;
    ``count`` resolves window queries from the run table as tensors on
    ``device``: runs entirely inside the window contribute ``k * b``
    through one mask; only runs straddling a window edge are copied to
    the host and expanded boundary-by-boundary there.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._t0: List[float] = []
        self._dt: List[float] = []
        self._k: List[int] = []
        self._b: List[int] = []
        self._ok: List[bool] = []
        self._end: List[float] = []
        self._total = 0
        self._np = None         # cached device view (invalidated on add)

    def add(self, t0: float, dt: float, k: int, b: int, ok: bool,
            end: float):
        self._t0.append(t0)
        self._dt.append(dt)
        self._k.append(k)
        self._b.append(b)
        self._ok.append(ok)
        self._end.append(end)
        self._total += k * b
        self._np = None

    def __len__(self) -> int:
        """Total generated tokens (sum of k*b over runs)."""
        return self._total

    @property
    def n_runs(self) -> int:
        return len(self._t0)

    def _arrays(self):
        if self._np is None:
            f = torch.tensor([self._t0, self._dt, self._end],
                             dtype=torch.float64).to(self.device)
            i = torch.tensor([self._k, self._b, self._ok],
                             dtype=torch.int64).to(self.device)
            self._np = (f[0], f[1], i[0], i[1], i[2].bool(), f[2])
        return self._np

    def _straddlers(self, sel: torch.Tensor, q0: float, q1: float):
        """(dt, tokens) of each run in ``sel`` whose boundaries fall in
        [q0, q1), expanded on the host with ``t = t + dt``: the few rows
        that cross a window edge."""
        t0, dt, k, b, _ok, _end = self._arrays()
        idx = torch.nonzero(sel).flatten()
        if not idx.numel():
            return []
        fl = torch.stack([t0[idx], dt[idx]]).tolist()
        it = torch.stack([k[idx], b[idx]]).tolist()
        out = []
        for t, d, k_i, b_i in zip(fl[0], fl[1], it[0], it[1]):
            c = 0
            for _ in range(k_i):
                t = t + d
                if t >= q1:
                    break
                if t >= q0:
                    c += 1
            out.append((d, c * b_i))
        return out

    def count(self, q0: float, q1: float, ok_only: bool = False) -> int:
        """Tokens whose iteration boundary lies in [q0, q1)."""
        if not self._t0:
            return 0
        t0, dt, k, b, ok, end = self._arrays()
        first = t0 + dt
        hit = (end >= q0) & (first < q1)
        if ok_only:
            hit &= ok
        full = hit & (first >= q0) & (end < q1)
        total = int((k[full] * b[full]).sum())
        return total + sum(n for _d, n in self._straddlers(hit & ~full, q0, q1))

    def gap_samples(self, q0: float,
                    q1: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """Time-between-tokens samples for boundaries in [q0, q1), in
        run-length form: (iteration gaps, token weights), float64 and
        int64 on the device.  Each run contributes its ``dt`` weighted by
        the tokens whose boundary falls inside the window (``k * b`` for
        fully-covered runs; straddlers expand boundary-by-boundary like
        ``count``).  Feeds ``obs.weighted_percentiles`` for token-level
        TBT percentiles with zero per-token bookkeeping."""
        f64 = dict(dtype=torch.float64, device=self.device)
        i64 = dict(dtype=torch.int64, device=self.device)
        if not self._t0:
            return torch.empty(0, **f64), torch.empty(0, **i64)
        t0, dt, k, b, ok, end = self._arrays()
        first = t0 + dt
        hit = (end >= q0) & (first < q1)
        full = hit & (first >= q0) & (end < q1)
        part = [(d, n) for d, n in self._straddlers(hit & ~full, q0, q1)
                if n]
        vals = torch.cat([dt[full],
                          torch.tensor([d for d, _ in part], **f64)])
        wts = torch.cat([k[full] * b[full],
                         torch.tensor([n for _, n in part], **i64)])
        return vals, wts


class _ObsLog:
    """Append-only (time, prompt tokens, output tokens) event log with
    O(log n) window queries — the windowed observable feed for the
    control plane's demand estimator (``repro_torch.control.estimator``).
    Events may be appended out of time order (requests are submitted up
    front); the query side sorts lazily on the device (stable sort,
    prefix sums, ``searchsorted``) and caches until the next append."""

    __slots__ = ("_t", "_p", "_o", "_np", "n_total", "prompt_total",
                 "output_total", "device")

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._t: List[float] = []
        self._p: List[int] = []
        self._o: List[int] = []
        self._np = None
        self.n_total = 0
        self.prompt_total = 0
        self.output_total = 0

    def add(self, t: float, prompt: int, output: int):
        self._t.append(t)
        self._p.append(prompt)
        self._o.append(output)
        self.n_total += 1
        self.prompt_total += prompt
        self.output_total += output
        self._np = None

    def _arrays(self):
        if self._np is None:
            t = torch.tensor(self._t, dtype=torch.float64).to(self.device)
            order = torch.sort(t, stable=True).indices
            # prefix sums of integer-valued float64 below 2**53: exact
            # in any order of summation
            po = torch.tensor([self._p, self._o],
                              dtype=torch.float64).to(self.device)
            self._np = (t[order], torch.cumsum(po[:, order], dim=1))
        return self._np

    def window(self, t0: float, t1: float) -> Tuple[int, float, float]:
        """(events, prompt tokens, output tokens) with time in [t0, t1)."""
        if not self._t:
            return 0, 0.0, 0.0
        t, cs = self._arrays()
        i0, i1 = torch.searchsorted(
            t, torch.tensor([t0, t1], dtype=torch.float64,
                            device=t.device)).tolist()
        if i1 <= i0:
            return 0, 0.0, 0.0
        (p1, p0), (o1, o0) = cs[:, [i1 - 1, max(i0 - 1, 0)]].tolist()
        if not i0:
            p0 = o0 = 0.0
        return i1 - i0, float(p1 - p0), float(o1 - o0)


class ModelObs:
    """Per-model control-plane observables: the request arrival stream
    (prompt lengths are visible at arrival; output lengths are the
    eventual commitment the estimator learns from finished requests)."""

    __slots__ = ("arrival",)

    def __init__(self, device=None):
        self.arrival = _ObsLog(device)


class _Span:
    """An in-flight batched stretch of decode iterations.

    ``segs`` is the piecewise-constant schedule: (off, k, b, dt, lat,
    ok) — k iterations at batch size b starting after ``off`` earlier
    span iterations.  ``bounds`` holds every iteration boundary,
    sequentially accumulated.  ``single`` marks a constant-batch span
    created with a non-empty admission queue (resident set pinned at
    capacity): each finisher is virtually backfilled from the queue
    (``adm`` logs the admission boundaries for the settle replay), so
    neither finishers nor joins — which can only queue — invalidate the
    schedule (``join_times`` feeds the EWMA replay).
    """
    __slots__ = ("gen", "start", "bounds", "segs", "single", "q0",
                 "adm", "join_times", "ecache")

    def __init__(self, gen, start, bounds, segs, single, q0, adm):
        self.gen = gen
        self.start = start
        self.bounds = bounds
        self.segs = segs
        self.single = single
        self.q0 = q0
        self.adm = adm          # sorted admission boundaries (iterations)
        self.join_times: List[float] = []
        # incremental EWMA replay state: (updates applied, value,
        # join_times index, admission index, current queue depth)
        self.ecache = (0, None, 0, 0, q0)

    def ok_upto(self, n: int) -> int:
        """SLO-meeting iterations among the span's first n."""
        good = 0
        for off, k_j, _b, _dt, _lat, ok in self.segs:
            c = min(n - off, k_j)
            if c <= 0:
                break
            if ok:
                good += c
        return good


class SimInstance:
    """One Serving Instance (prefill or decode role).

    Decode residents live in ``resident`` sorted by absolute finish
    iteration: entries are (finish_iter, req, join_iters, join_ok) with
    ``res_keys`` the parallel finish_iter list for bisecting.  The
    request's emitted count is ``iters - join_iters``; its token/SLO
    counters materialize from the cumulative ``iters``/``ok_iters``
    when it finishes or is re-routed.
    """

    def __init__(self, iid: int, region: str, template: ServingTemplate,
                 model: ServedModel, cm: InstanceCostModel, ready_at: float):
        self.iid = iid
        self.region = region
        self.template = template
        self.model = model
        self.cm = cm
        self.ready_at = ready_at
        self.draining = False
        self.dead = False
        self.failed = False     # crashed but not yet health-check detected
        self.slow_factor = 1.0  # straggler: iteration times scale by this
        self._degrade_gen = 0   # cancels stale straggler-recovery events
        self.busy = False
        self.queue: Deque[Request] = deque()    # prefill / decode admission
        self.resident: List[Tuple[int, Request, int, int]] = []
        self.res_keys: List[int] = []           # finish iters, sorted
        self.iters = 0                          # settled decode iterations
        self.ok_iters = 0                       # ... of which met the SLO
        self.ewma_load = 0.0
        self.tokens_out = 0                     # generated tokens served here
        self.span: Optional[_Span] = None       # batched decode state
        self._gen = 0                           # span generation counter
        self._spanlen = 8                       # adaptive span budget
        self._kavg = 8.0                        # EWMA of settled span length
        self._quiet = 0                         # join-free iteration streak
        self._joined = False                    # a join landed mid-iteration
        self._dtc: Dict[int, Tuple[float, float]] = {}  # b -> (iter, lat)

    @property
    def phase(self) -> str:
        return self.template.phase

    def idle(self) -> bool:
        return not self.queue and not self.resident and not self.busy


class Simulator:
    def __init__(self, models: Dict[str, ServedModel],
                 config_by_name: Dict[str, NodeConfig],
                 workloads: Dict[str, "WorkloadStats"],
                 batched: bool = True,
                 reqlog: bool = True, device=None):
        self.device = dev = resolve_device(device)
        self.models = models
        self.configs = config_by_name
        self.workloads = workloads
        self.batched = batched
        self.ev = EventQueue()
        self.now = 0.0
        self.horizon = float("inf")
        self._iid = itertools.count()
        self.instances: Dict[int, SimInstance] = {}
        self._by_pool: Dict[Tuple[str, str], List[SimInstance]] = {}
        self.tokens: Dict[str, TokenRuns] = {m: TokenRuns(dev)
                                             for m in models}
        self.obs: Dict[str, ModelObs] = {m: ModelObs(dev) for m in models}
        # per-request lifecycle records (observation-only; on by default)
        self.reqlog: Optional[RequestLog] = \
            RequestLog(models, dev) if reqlog else None
        self.finished: List[Request] = []
        self.dropped: int = 0
        self.shed_policy: Optional[ShedPolicy] = None
        self.shed: int = 0                      # cumulative shed arrivals
        self.shed_by_model: Dict[str, int] = {m: 0 for m in models}
        self.dropped_by_model: Dict[str, int] = {m: 0 for m in models}
        # CORAL_SANITIZE=1: runtime invariant checks (repro_torch.debug)
        self._san = _inv.SimSanitizer() if _inv.sanitize_enabled() else None
        # router knows per-node degradation (health telemetry); a naive
        # runtime (no straggler telemetry) turns this off
        self.straggler_aware = True

    # ------------------------------------------------------------ cluster
    def add_instance(self, region: str, template: ServingTemplate,
                     ready_delay: float = INIT_DELAY_S,
                     cm: Optional[object] = None) -> SimInstance:
        """cm: override the cost model (e.g. a profiling-fitted one for the
        simulator-fidelity study, §6.2)."""
        model = self.models[template.model]
        if cm is None:
            cm = InstanceCostModel(model, template.phase, template.placement,
                                   self.configs,
                                   self.workloads[template.model])
        inst = SimInstance(next(self._iid), region, template, model, cm,
                           self.now + ready_delay)
        self.instances[inst.iid] = inst
        self._by_pool.setdefault((template.model, template.phase),
                                 []).append(inst)
        return inst

    def drain_instance(self, inst: SimInstance):
        inst.draining = True

    def kill_instance(self, inst: SimInstance):
        """Node failure: settle any in-flight batched accounting up to
        ``now`` (the in-flight partial iteration yields nothing, as in
        the per-iteration loop where the cleared resident set makes its
        pending event a no-op), mark the instance dead and re-route its
        work — decode requests (already prefilled) via ``_join_decode``
        whether resident *or* queued for admission, prefill requests
        back through ``_on_arrival``.
        """
        if inst.dead:
            return
        sp = inst.span
        if sp is not None:
            n = min(bisect_right(sp.bounds, self.now), len(sp.bounds) - 1)
            self._settle_runs(inst, sp, n)
            inst._gen += 1
            inst.span = None
        inst.dead = True        # a prefill batch in flight is cancelled
        # by the dead-check in _prefill_done and re-routed there
        self._pool_remove(inst)
        res, q = inst.resident, inst.queue
        inst.resident = []
        inst.res_keys = []
        inst.queue = deque()
        if inst.phase == "decode":
            for _f, req, j_it, j_ok in res:
                # partial credit for tokens generated here before the
                # failure (the per-iteration loop counted them live)
                req.decode_tokens_ok += inst.iters - j_it
                req.decode_slo_ok += inst.ok_iters - j_ok
                self.ev.push(self.now, self._join_decode, inst, req)
            for req in q:
                self.ev.push(self.now, self._join_decode, inst, req)
        else:
            for req in q:
                self.ev.push(self.now, self._on_arrival, req)

    def crash_instance(self, inst: SimInstance,
                       detect_s: float = 0.0) -> float:
        """Node failure with health-check detection latency.  The node
        stops serving immediately — in-flight batched accounting is
        settled exactly as in ``kill_instance`` — but the coordinator
        does not know yet: the instance stays in its routing pool,
        black-holing routed requests into its queue, until the health
        probe fires ``detect_s`` later and ``kill_instance`` re-routes
        everything it accumulated.  ``detect_s <= 0`` is instant
        detection (identical to ``kill_instance``).  Returns the
        detection time."""
        if inst.dead or inst.failed:
            return self.now
        if detect_s <= 0.0:
            self.kill_instance(inst)
            return self.now
        sp = inst.span
        if sp is not None:
            # settle like _interrupt_span, but the in-flight iteration
            # is lost instead of converted: the crashed node never
            # completes it (the oracle's pending event no-ops on the
            # failed flag).  The EWMA still advances through its start,
            # since the per-iteration loop updated it there.
            n = min(bisect_right(sp.bounds, self.now), len(sp.bounds) - 1)
            inst.ewma_load = self._ewma_replay(inst, sp, n + 1)
            self._settle_runs(inst, sp, n)
            inst._gen += 1
            inst.span = None
        inst.failed = True
        inst.busy = False
        t = self.now + detect_s
        self.ev.push(t, self.kill_instance, inst)
        return t

    def degrade_instance(self, inst: SimInstance, factor: float,
                         duration_s: Optional[float] = None):
        """Straggler injection: scale the instance's iteration and
        pipeline times by ``factor`` (>= 1) starting with the *next*
        iteration — the in-flight one keeps the timing it was started
        with, in both the batched and the per-iteration loop.  With
        ``duration_s`` the node recovers to full speed that much later;
        ``factor=1.0`` restores it immediately."""
        if inst.dead or inst.failed:
            return
        factor = max(float(factor), 1.0)
        if factor != inst.slow_factor and inst.span is not None:
            self._interrupt_span(inst)
        inst.slow_factor = factor
        inst._dtc.clear()
        inst._degrade_gen += 1
        if duration_s is not None and factor != 1.0:
            self.ev.push(self.now + duration_s, self._restore_speed,
                         inst, inst._degrade_gen)

    def _restore_speed(self, inst: SimInstance, gen: int):
        if gen != inst._degrade_gen or inst.dead:
            return          # superseded by a newer degrade, or gone
        self.degrade_instance(inst, 1.0)

    def _pool_remove(self, inst: SimInstance):
        """Evict a dead instance from its routing pool so the router's
        per-request scan stays proportional to live instances."""
        pool = self._by_pool.get((inst.template.model, inst.phase))
        if pool is not None and inst in pool:
            pool.remove(inst)

    def _earliest_ready(self, model: str, phase: str) -> Optional[float]:
        """Earliest ready_at among still-initializing pool members."""
        cut = self.now + 1e-9
        best = None
        for i in self._by_pool.get((model, phase), ()):
            if not i.draining and not i.dead and not i.failed \
                    and i.ready_at > cut:
                if best is None or i.ready_at < best:
                    best = i.ready_at
        return best

    # ------------------------------------------------------------- router
    def _ewma_at(self, inst: SimInstance) -> float:
        """EWMA load as the per-iteration loop would see it *now*: a
        batched span applies its updates lazily, one per iteration
        started (n completed boundaries => n+1 started iterations), with
        queue-depth changes from logged joins replayed in order."""
        sp = inst.span
        if sp is None:
            return inst.ewma_load
        n = min(bisect_right(sp.bounds, self.now) + 1, len(sp.bounds))
        return self._ewma_replay(inst, sp, n)

    def _ewma_replay(self, inst: SimInstance, sp: _Span, n: int) -> float:
        """Value of the EWMA after the first ``n`` iteration starts of
        the span, replayed incrementally (update j at time ``start`` for
        j=0 else ``bounds[j-1]`` sees the queue depth at that instant:
        logged joins grow it, virtual admissions shrink it)."""
        done, e, ji, ai, q = sp.ecache
        if e is None:
            e = inst.ewma_load
        if n == done:
            return e
        if n < done:            # unreachable (n is monotone in time);
            done, e, ji, ai, q = 0, inst.ewma_load, 0, 0, sp.q0
        jt = sp.join_times
        adm = sp.adm
        if not jt and not adm and q == 0.0 and e == 0.0:
            sp.ecache = (n, 0.0, 0, 0, 0.0)
            return 0.0
        if not jt:
            # no logged joins: q is piecewise-constant between
            # admission boundaries — run tight constant-q stretches
            la = len(adm)
            j = done
            while j < n:
                while ai < la and adm[ai] <= j:
                    q -= 1.0
                    ai += 1
                nxt = adm[ai] if ai < la and adm[ai] < n else n
                for _ in range(j, nxt):
                    e = 0.9 * e + 0.1 * q
                j = nxt
        else:
            for j in range(done, n):
                t = sp.start if j == 0 else sp.bounds[j - 1]
                while ji < len(jt) and jt[ji] <= t:
                    q += 1.0
                    ji += 1
                while ai < len(adm) and adm[ai] <= j:
                    q -= 1.0
                    ai += 1
                e = 0.9 * e + 0.1 * q
        sp.ecache = (n, e, ji, ai, q)
        return e

    def _depth_at(self, inst: SimInstance) -> int:
        """Queue + resident depth as the per-iteration loop would see it
        now: residents whose finish boundary already passed inside an
        unsettled span no longer count."""
        d = len(inst.queue) + len(inst.resident)
        sp = inst.span
        if sp is not None:
            n = bisect_right(sp.bounds, self.now)
            if n:
                if sp.single:
                    # every mid-span finisher was backfilled: departures
                    # so far == admissions so far
                    d -= bisect_right(sp.adm, n)
                else:
                    d -= bisect_right(inst.res_keys, inst.iters + n)
        return d

    def route(self, model: str, phase: str) -> Optional[SimInstance]:
        # weighted selection: least (queue depth / weight) — weighted-RR
        # with EWMA straggler correction.  Inlined hot
        # loop: routing runs twice per request, so skip the pool-list
        # allocation and take the span-free fast path when possible.
        cut = self.now + 1e-9
        best = None
        best_load = 0.0
        for i in self._by_pool.get((model, phase), ()):
            if i.draining or i.dead or i.ready_at > cut:
                continue
            if i.span is None:
                depth = len(i.queue) + len(i.resident)
                e = i.ewma_load
            else:
                depth = self._depth_at(i)
                e = self._ewma_at(i)
            w = i.template.throughput / (1.0 + e)
            if i.slow_factor != 1.0 and self.straggler_aware:
                # node health telemetry: a straggler's effective
                # throughput is scaled down before the EWMA correction
                # even notices the queues growing
                w /= i.slow_factor
            ld = (depth + 1.0) / (w if w > 1e-9 else 1e-9)
            if best is None or ld < best_load:
                best, best_load = i, ld
        return best

    # ------------------------------------------------------------ arrival
    def submit(self, req: Request):
        ob = self.obs.get(req.model)
        if ob is not None:
            ob.arrival.add(req.arrival, req.prompt_len, req.output_len)
        self.ev.push(req.arrival, self._on_arrival, req)

    def _on_arrival(self, req: Request):
        # admission control applies to *fresh* arrivals only: a request
        # re-entering here (a cold-start hold flushed at ready_at, or a
        # killed prefill instance's re-routed queue) was admitted once
        # already and its arrival time lies in the past
        if self.shed_policy is not None \
                and req.arrival >= self.now - 1e-9 \
                and self._should_shed(req.model):
            self.shed += 1
            self.shed_by_model[req.model] += 1
            if self.reqlog is not None:
                self.reqlog.note_shed(req)
            return
        inst = self.route(req.model, "prefill")
        if inst is None:
            # cold start / pool re-initialization: hold the request and
            # flush it when an instance becomes ready instead of
            # dropping it (requests are lost only when no instance is
            # even initializing)
            t = self._earliest_ready(req.model, "prefill")
            if t is None:
                self.dropped += 1
                self.dropped_by_model[req.model] = \
                    self.dropped_by_model.get(req.model, 0) + 1
                if self.reqlog is not None:
                    self.reqlog.note_dropped(req)
            else:
                self.ev.push(t, self._on_arrival, req)
            return
        inst.queue.append(req)
        self._maybe_start(inst)

    def _should_shed(self, model: str) -> bool:
        bound = self.shed_policy.max_queue_per_instance
        cut = self.now + 1e-9
        n_live = backlog = 0
        for i in self._by_pool.get((model, "prefill"), ()):
            if i.dead or i.draining or i.ready_at > cut:
                # a still-initializing instance is cold start, not
                # overload: its held arrivals will be flushed at
                # ready_at, so they must not count against the drain
                # bound (nor the instance toward capacity)
                continue
            n_live += 1         # failed-but-undetected counts as live:
            backlog += len(i.queue)     # its stuck queue IS the backlog
        return n_live > 0 and backlog > bound * n_live

    # ------------------------------------------------------------ prefill
    def _maybe_start(self, inst: SimInstance):
        if inst.busy or inst.dead or inst.failed \
                or self.now < inst.ready_at:
            if not inst.busy and not inst.dead and not inst.failed \
                    and self.now < inst.ready_at \
                    and (inst.queue or inst.resident):
                self.ev.push(inst.ready_at, self._maybe_start, inst)
            return
        if inst.phase == "prefill" and inst.queue:
            batch, tokens = [], 0
            chunk = inst.cm.prefill_chunk
            while inst.queue and tokens < chunk:
                r = inst.queue.popleft()
                batch.append(r)
                tokens += r.prompt_len
            # successive iterations pipeline across stages: the instance
            # re-admits after the bottleneck-stage time, while the batch
            # completes after the full pipeline traversal.
            free = inst.cm.prefill_iter_time(tokens)
            done = inst.cm.prefill_pipeline_latency(tokens)
            if inst.slow_factor != 1.0:
                free *= inst.slow_factor
                done *= inst.slow_factor
            inst.busy = True
            inst.ewma_load = 0.9 * inst.ewma_load + 0.1 * len(inst.queue)
            self.ev.push(self.now + free, self._free, inst)
            self.ev.push(self.now + done, self._prefill_done, inst, batch)
        elif inst.phase == "decode" and (inst.resident or inst.queue):
            self._start_decode(inst)

    def _free(self, inst: SimInstance):
        inst.busy = False
        self._maybe_start(inst)

    def _prefill_done(self, inst: SimInstance, batch: List[Request]):
        if inst.dead:
            # the node failed mid-batch: nothing was produced — the
            # batch re-enters the router (prefill runs again elsewhere;
            # no latency was recorded for the lost pass)
            for r in batch:
                self.ev.push(self.now, self._on_arrival, r)
            return
        if inst.failed:
            # crashed but not yet detected: the batch is lost in place.
            # Its requests rejoin the stuck queue until the health
            # probe fires and kill_instance re-routes them.
            inst.queue.extendleft(reversed(batch))
            return
        rl = self.reqlog
        for r in batch:
            r.prefill_done = self.now
            if rl is not None:
                # first token lands at prefill completion (TTFT)
                rl.note_first(r.model, r.rid, r.arrival, self.now)
            # KV transfer to a decode instance
            dst = self.route(r.model, "decode")
            delay = inst.cm.kv_transfer_time(r.prompt_len)
            if dst is None:
                t = self._earliest_ready(r.model, "decode")
                if t is None:
                    self.dropped += 1
                    self.dropped_by_model[r.model] = \
                        self.dropped_by_model.get(r.model, 0) + 1
                    if rl is not None:
                        rl.note_dropped(r)
                else:           # decode pool still initializing: hold
                    self.ev.push(max(t, self.now + delay),
                                 self._dispatch_decode, r)
                continue
            self.ev.push(self.now + delay, self._join_decode, dst, r)

    # ------------------------------------------------------------- decode
    def _decode_times(self, inst: SimInstance, b: int) -> Tuple[float, float]:
        """(iteration time, pipeline latency) for batch b, memoized per
        instance; tolerates duck-typed cost models without the combined
        ``decode_times`` API (e.g. the fitted model of fig6)."""
        c = inst._dtc.get(b)
        if c is None:
            cm = inst.cm
            if hasattr(cm, "decode_times"):
                c = cm.decode_times(b)
            else:
                c = (cm.decode_iter_time(b), cm.decode_pipeline_latency(b))
            if inst.slow_factor != 1.0:
                # straggler: both the iteration time and the perceived
                # latency inflate, so a degraded node can fall out of
                # SLO (the memo is cleared whenever the factor changes)
                c = (c[0] * inst.slow_factor, c[1] * inst.slow_factor)
            inst._dtc[b] = c
        return c

    def _res_add(self, inst: SimInstance, req: Request):
        """Insert a request into the finish-iteration-sorted residents."""
        f = inst.iters + req.output_len
        i = bisect_right(inst.res_keys, f)
        inst.res_keys.insert(i, f)
        inst.resident.insert(i, (f, req, inst.iters, inst.ok_iters))

    def _start_decode(self, inst: SimInstance):
        cap = inst.cm.decode_capacity
        while inst.queue and len(inst.resident) < cap:
            self._res_add(inst, inst.queue.popleft())
        b = len(inst.resident)
        if b == 0:
            return
        # Per-iteration scheduling: always in oracle mode, and in
        # batched mode when the instance's queue is empty (no
        # join-proof constant-batch span possible) AND recent history
        # says a join lands every couple of iterations — there a span
        # would be built only to be interrupted, costing more than the
        # heap events it removes.  A streak of join-free iterations
        # (or a risen settle average) re-enters span mode.
        if not self.batched or \
                (not inst.queue and inst._kavg < 3.0 and inst._quiet < 4):
            dt, lat = self._decode_times(inst, b)
            inst.busy = True
            # EWMA straggler feedback on *decode* iterations too (the
            # seed only updated it for prefill, leaving the router's
            # correction dead for decode pools)
            inst.ewma_load = 0.9 * inst.ewma_load + 0.1 * len(inst.queue)
            self.ev.push(self.now + dt, self._decode_done, inst, lat,
                         self.now, dt)
            return
        self._build_span(inst)

    def _build_span(self, inst: SimInstance):
        """Schedule a batched span from the current resident set.

        Queue empty: the resident set evolves deterministically until
        the instance drains — segment the schedule at each distinct
        finish iteration (batch size steps down as requests finish), up
        to the adaptive span budget (a KV join would invalidate the
        schedule, so interrupt-heavy instances keep spans short).
        Queue non-empty (resident set pinned at capacity): a
        constant-batch span — every finisher is backfilled from the
        queue at its boundary, so the batch size, iteration time and
        SLO verdict never change; the walk below merges resident and
        admitted finish offsets to find where the queue runs dry (the
        first unfilled departure ends the span).  Joins cannot break a
        constant-batch span: they land in the queue, only extending its
        validity.  Either way the span is capped at the run horizon so
        epoch metrics never miss settled tokens.
        """
        keys = inst.res_keys
        n_res = len(keys)
        iters0 = inst.iters
        single = bool(inst.queue)
        slo = inst.model.decode_slo_ms / 1e3
        horizon = self.horizon
        bounds: List[float] = []
        segs: List[Tuple[int, int, int, float, float, bool]] = []
        t = self.now
        adm: List[int] = []
        if single:
            # constant-batch walk over merged finish offsets
            dt, lat = self._decode_times(inst, n_res)
            ok = lat <= slo
            queue = inst.queue
            m0 = len(queue)
            adm_fins: List[int] = []            # admitted finish offsets
            ri = qi = 0
            while True:
                o = keys[ri] - iters0 if ri < n_res else None
                if adm_fins and (o is None or adm_fins[0] < o):
                    o = heapq.heappop(adm_fins)
                else:
                    ri += 1
                if o >= SPAN_MAX:
                    k_end = SPAN_MAX
                    break
                if qi >= m0:
                    k_end = o           # departure with a dry queue:
                    break               # the batch shrinks after this
                adm.append(o)
                heapq.heappush(adm_fins, o + queue[qi].output_len)
                qi += 1
            # C-speed sequential accumulation — bit-identical to the
            # oracle's repeated `t += dt`
            bounds = list(islice(accumulate(repeat(dt, k_end),
                                            initial=t), 1, None))
            cut = bisect_right(bounds, horizon)
            if cut < k_end:
                del bounds[max(cut, 1):]
            segs.append((0, len(bounds), n_res, dt, lat, ok))
        else:
            # adaptive budget tracking the observed settle distance:
            # interrupt-heavy instances schedule short spans (building
            # a long schedule per KV join costs more than it saves),
            # quietly draining ones grow geometrically
            cap_iters = inst._spanlen
            # distinct finish offsets = segment ends, capped
            targets: List[int] = []
            i = 0
            while i < n_res:
                L = keys[i] - iters0
                if L >= cap_iters:
                    targets.append(cap_iters)
                    break
                targets.append(L)
                i = bisect_right(keys, keys[i])
            off = 0
            for L in targets:
                b_j = n_res - bisect_right(keys, iters0 + off)
                dt, lat = self._decode_times(inst, b_j)
                ok = lat <= slo
                seg = list(islice(accumulate(repeat(dt, L - off),
                                             initial=t), 1, None))
                cut = bisect_right(seg, horizon)
                capped = cut < len(seg)
                if capped and cut == 0 and not bounds:
                    cut = 1             # always schedule >= 1 iteration
                if cut:
                    bounds.extend(seg[:cut])
                    t = bounds[-1]
                    segs.append((off, cut, b_j, dt, lat, ok))
                    off += cut
                if capped:
                    break
        inst._gen += 1
        inst.span = _Span(inst._gen, self.now, bounds, segs, single,
                          float(len(inst.queue)), adm)
        inst.busy = True
        self.ev.push(bounds[-1], self._span_done, inst, inst._gen)

    def _settle_runs(self, inst: SimInstance, sp: _Span, n: int):
        """Account the first n iterations of a span: one TokenRuns
        record per (partially) covered segment, pop finishers off the
        sorted residents (finish stamped at the exact boundary,
        counters materialized from the cumulative iteration counters);
        everything still resident is untouched."""
        if n <= 0:
            return
        if self._san is not None:
            self._san.check_settle(self, inst, sp, n)
        bounds = sp.bounds
        runs = self.tokens[inst.template.model]
        ok_gain = 0
        for off, k_j, b_j, dt, _lat, ok in sp.segs:
            s_j = min(n - off, k_j)
            if s_j <= 0:
                break
            t0 = bounds[off - 1] if off else sp.start
            runs.add(t0, dt, s_j, b_j, ok, bounds[off + s_j - 1])
            inst.tokens_out += s_j * b_j
            if ok:
                ok_gain += s_j
        iters0 = inst.iters
        cut = iters0 + n
        for o in sp.adm:
            # replay the virtual admissions of a constant-batch span:
            # each backfills the finisher departing at boundary o
            if o > n:
                break
            req = inst.queue.popleft()
            f = iters0 + o + req.output_len
            i = bisect_right(inst.res_keys, f)
            inst.res_keys.insert(i, f)
            inst.resident.insert(
                i, (f, req, iters0 + o, inst.ok_iters + sp.ok_upto(o)))
        self._pop_finishers(
            inst, cut,
            lambda f: bounds[f - iters0 - 1],
            lambda f: inst.ok_iters + sp.ok_upto(f - iters0))
        inst.iters = cut
        inst.ok_iters += ok_gain

    def _pop_finishers(self, inst: SimInstance, cut: int, finish_at,
                       ok_at):
        """Pop residents whose finish iteration is <= ``cut`` and
        materialize their counters from the cumulative per-instance
        iteration counters — the single place both the batched settle
        and the per-iteration oracle credit finished requests, keeping
        their accounting in lockstep.  ``finish_at(f)``/``ok_at(f)``
        supply the timestamp and cumulative ok-iteration count at
        finish iteration ``f``."""
        i = bisect_right(inst.res_keys, cut)
        if i:
            rl = self.reqlog
            fin = None if rl is None \
                else rl.finished_sink(inst.model.name)
            for f, req, j_it, j_ok in inst.resident[:i]:
                req.finish = finish_at(f)
                req.decode_tokens_ok += f - j_it
                req.decode_slo_ok += ok_at(f) - j_ok
                self.finished.append(req)
                if fin is not None:
                    fin.append(req)
            del inst.resident[:i]
            del inst.res_keys[:i]

    def _interrupt_span(self, inst: SimInstance):
        """A join arrived mid-span and changes the schedule: settle the
        boundaries that already passed and convert the in-flight
        iteration into a per-iteration event (same batch/latency it was
        started with), exactly as the reference loop would run it."""
        sp = inst.span
        n = min(bisect_right(sp.bounds, self.now), len(sp.bounds) - 1)
        inst.ewma_load = self._ewma_replay(inst, sp, n + 1)
        self._settle_runs(inst, sp, n)
        # locate the in-flight iteration's segment for its batch timing
        lat = dt = None
        for off, k_j, _b, dt_j, lat_j, _ok in sp.segs:
            if off <= n < off + k_j:
                dt, lat = dt_j, lat_j
                break
        start = sp.bounds[n - 1] if n > 0 else sp.start
        inst._gen += 1
        inst.span = None
        self._adapt_spanlen(inst, n)
        self.ev.push(sp.bounds[n], self._decode_done, inst, lat, start, dt)
        # inst.busy stays True until that event fires

    @staticmethod
    def _adapt_spanlen(inst: SimInstance, settled: int):
        """Track the observed settle distance so the next span buys
        about as many iterations as interrupts allow it to keep."""
        inst._kavg = a = 0.7 * inst._kavg + 0.3 * settled
        s = int(1.5 * a) + 1
        inst._spanlen = s if s < SPAN_MAX else SPAN_MAX

    def _span_done(self, inst: SimInstance, gen: int):
        sp = inst.span
        if inst.dead or sp is None or sp.gen != gen:
            return                              # superseded / failed
        inst.ewma_load = self._ewma_replay(inst, sp, len(sp.bounds))
        self._settle_runs(inst, sp, len(sp.bounds))
        inst.span = None
        inst.busy = False
        if not sp.single:       # constant-batch spans are join-proof;
            # only queue-empty spans inform the interrupt-risk budget
            self._adapt_spanlen(inst, len(sp.bounds))
        self._after_decode_iter(inst)

    def _dispatch_decode(self, req: Request):
        """Route a prefilled request into the decode pool, holding it
        while the pool is (re-)initializing."""
        dst = self.route(req.model, "decode")
        if dst is not None:
            self._join_decode(dst, req)
            return
        t = self._earliest_ready(req.model, "decode")
        if t is None:
            self.dropped += 1
            self.dropped_by_model[req.model] = \
                self.dropped_by_model.get(req.model, 0) + 1
            if self.reqlog is not None:
                self.reqlog.note_dropped(req)
        else:
            self.ev.push(t, self._dispatch_decode, req)

    def _join_decode(self, inst: SimInstance, req: Request):
        if inst.dead:
            self._dispatch_decode(req)
            return
        if inst.failed:
            # the router still believes this node is alive: the request
            # is stuck in its queue until the health probe fires and
            # kill_instance re-routes it
            inst.queue.append(req)
            return
        inst._joined = True
        sp = inst.span
        if sp is not None:
            if sp.single and len(inst.resident) >= inst.cm.decode_capacity:
                # resident set is pinned at capacity until the span's
                # finisher: queueing cannot change the running batch, so
                # the span stays valid — just log the depth change for
                # the EWMA replay
                inst.queue.append(req)
                sp.join_times.append(self.now)
                return
            self._interrupt_span(inst)
        if len(inst.resident) < inst.cm.decode_capacity:
            self._res_add(inst, req)
        else:
            inst.queue.append(req)      # SLO-aware admission control
        self._maybe_start(inst)

    def _decode_done(self, inst: SimInstance, lat: float, start: float,
                     dt: float):
        if inst.failed:
            return      # crashed mid-iteration: the work is lost
        inst.busy = False
        slo = inst.model.decode_slo_ms / 1e3
        ok = lat <= slo
        b = len(inst.resident)
        if b:
            self.tokens[inst.template.model].add(start, dt, 1, b, ok,
                                                 self.now)
            inst.tokens_out += b
            inst.iters += 1
            if ok:
                inst.ok_iters += 1
            now = self.now
            self._pop_finishers(inst, inst.iters,
                                lambda _f: now,
                                lambda _f: inst.ok_iters)
        if inst._joined:
            inst._quiet = 0
            inst._joined = False
        else:
            inst._quiet += 1
        self._after_decode_iter(inst)

    def _after_decode_iter(self, inst: SimInstance):
        # admit pending requests up to the SLO/memory cap
        cap = inst.cm.decode_capacity
        while inst.queue and len(inst.resident) < cap:
            self._res_add(inst, inst.queue.popleft())
        if inst.draining and not inst.resident and not inst.queue:
            inst.dead = True
            self._pool_remove(inst)
        self._maybe_start(inst)

    # ---------------------------------------------------------------- run
    def run_until(self, t_end: float):
        self.horizon = t_end
        san = self._san
        while self.ev and self.ev._q[0][0] <= t_end:
            t, _, fn, args = self.ev.pop()
            if san is not None:
                san.note_pop(t, self.now)
            self.now = max(self.now, t)
            fn(*args)
        self.now = t_end
        if san is not None:
            san.check_sim(self)

    def pool_backlog(self, model: str, phase: str) -> Tuple[int, int]:
        """Queue snapshot over a pool's live instances: (queued requests,
        queued prompt tokens).  Resident decode requests are in-flight
        work, not backlog, and are excluded."""
        n = ptok = 0
        for i in self._by_pool.get((model, phase), ()):
            if i.dead or i.draining:
                continue
            n += len(i.queue)
            for r in i.queue:
                ptok += r.prompt_len
        return n, ptok

    # ------------------------------------------------------------ metrics
    def goodput(self, model: str, t0: float, t1: float) -> float:
        """Generated tokens/s within [t0, t1) meeting the decode SLO."""
        return self.tokens[model].count(t0, t1, ok_only=True) \
            / max(t1 - t0, 1e-9)

    def throughput(self, model: str, t0: float, t1: float) -> float:
        return self.tokens[model].count(t0, t1) / max(t1 - t0, 1e-9)
