"""Runtime invariant sanitizer (enable with ``CORAL_SANITIZE=1``).

The control plane rests on exact accounting contracts: the batched
simulator is *bit-identical* to the per-iteration oracle, token and
request counters are conserved integers, and the epoch loop never holds
or places capacity that the market does not supply.  This module guards
them at runtime, at the natural seams — span settlement, event-queue
pops, epoch edges — where a violation is still attributable to the step
that caused it.  The checks read host state and the observables' Python
results; none adds device work beyond the arrival-window query of the
request audit.

Every check is gated on :func:`sanitize_enabled`, read once per call so
tests can flip the environment variable; hooks in the simulator bind a
``SimSanitizer`` at construction time instead (one env read per
``Simulator``).  A violation raises :class:`InvariantViolation`, an
``AssertionError`` subclass so test harnesses treat it like a failed
assert.

Checked invariants:

* **request conservation** (per model): arrivals observed up to ``now``
  equal finished + dropped + shed + queued + resident + in-flight
  requests still travelling through the event heap;
* **token conservation** (per model): the ``TokenRuns`` total equals the
  sum of per-instance ``tokens_out`` — including dead instances, whose
  produced tokens stay counted;
* **occupancy**: decode residents never exceed ``decode_capacity``, and
  every settled span segment's batch fits it too;
* **heap-time monotonicity**: the event queue never hands back a
  timestamp behind the simulation clock;
* **lifecycle**: dead instances leave the routing pools and never come
  back to life;
* **allocation/holdings**: a solved allocation uses only nodes its
  availability offered, and the cluster's held nodes fit the epoch's
  physical supply;
* **metrics sanity**: ``EpochMetrics`` counters are non-negative and
  per-model goodput never exceeds throughput.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Tuple

EPS = 1e-6


class InvariantViolation(AssertionError):
    """A Coral accounting/lifecycle contract was broken at runtime."""


def sanitize_enabled() -> bool:
    return os.environ.get("CORAL_SANITIZE", "") not in ("", "0")


def _fail(msg: str):
    raise InvariantViolation(msg)


# ---------------------------------------------------------------- simulator
class SimSanitizer:
    """Per-``Simulator`` runtime checks.

    ``note_pop`` runs on every event pop (cheap: two comparisons);
    ``check_settle`` at every span settlement; ``check_sim`` — the full
    conservation audit, which scans the heap — only at ``run_until``
    boundaries.
    """

    def __init__(self):
        self._dead_seen = set()

    # ------------------------------------------------------- hot hooks
    def note_pop(self, t: float, now: float):
        # ``Simulator.now`` only ever advances (now = max(now, t)), so
        # a popped timestamp behind the clock means the heap returned
        # events out of order — the determinism contract is void
        if t < now - EPS:
            _fail(f"event heap time went backwards: popped t={t:.9f} "
                  f"behind sim clock now={now:.9f}")

    def check_settle(self, sim, inst, sp, n: int):
        cap = inst.cm.decode_capacity
        for off, k_j, b_j, dt, _lat, _ok in sp.segs:
            if min(n - off, k_j) <= 0:
                break
            if b_j < 0 or b_j > cap:
                _fail(f"span segment batch {b_j} outside [0, "
                      f"decode_capacity={cap}] on instance {inst.iid}")
            if dt < 0.0:
                _fail(f"negative iteration time {dt} in settled span "
                      f"on instance {inst.iid}")

    # ------------------------------------------------------ epoch edge
    def check_sim(self, sim):
        self._check_lifecycle(sim)
        self._check_occupancy(sim)
        self._check_tokens(sim)
        self._check_requests(sim)
        self._check_reqlog(sim)

    def _check_reqlog(self, sim):
        """RequestLog conservation: the observability layer's per-model
        outcome counters must mirror the simulator's own accounting
        exactly (a divergence means a lifecycle note was missed or
        double-recorded)."""
        rl = sim.reqlog
        if rl is None:
            return
        fin: Dict[str, int] = {}
        for r in sim.finished:
            fin[r.model] = fin.get(r.model, 0) + 1
        for m in sorted(rl.models):
            if rl.n_finished[m] != fin.get(m, 0):
                _fail(f"RequestLog finished count {rl.n_finished[m]} != "
                      f"simulator finished {fin.get(m, 0)} for {m!r}")
            if rl.n_dropped[m] != sim.dropped_by_model.get(m, 0):
                _fail(f"RequestLog dropped count {rl.n_dropped[m]} != "
                      f"simulator dropped "
                      f"{sim.dropped_by_model.get(m, 0)} for {m!r}")
            if rl.n_shed[m] != sim.shed_by_model.get(m, 0):
                _fail(f"RequestLog shed count {rl.n_shed[m]} != "
                      f"simulator shed {sim.shed_by_model.get(m, 0)} "
                      f"for {m!r}")
            # every finished request passed its first-token stamp, but
            # not vice versa (decode still in flight, or a request
            # dropped after prefill at the decode-dispatch edge)
            if rl.n_finished[m] > rl.n_first[m]:
                _fail(f"RequestLog records {rl.n_finished[m]} finished "
                      f"but only {rl.n_first[m]} first tokens for {m!r}")

    def _check_lifecycle(self, sim):
        for iid in sorted(sim.instances):
            inst = sim.instances[iid]
            if inst.dead:
                self._dead_seen.add(iid)
            elif iid in self._dead_seen:
                _fail(f"instance {iid} resurrected: dead flag cleared "
                      "after death")
        for pool_key in sorted(sim._by_pool):
            for inst in sim._by_pool[pool_key]:
                if inst.dead:
                    _fail(f"dead instance {inst.iid} still routable in "
                          f"pool {pool_key}")

    def _check_occupancy(self, sim):
        for iid in sorted(sim.instances):
            inst = sim.instances[iid]
            if len(inst.resident) != len(inst.res_keys):
                _fail(f"instance {iid}: resident/res_keys desync "
                      f"({len(inst.resident)} vs {len(inst.res_keys)})")
            if inst.phase == "decode" \
                    and len(inst.resident) > inst.cm.decode_capacity:
                _fail(f"instance {iid}: {len(inst.resident)} residents "
                      f"exceed decode_capacity "
                      f"{inst.cm.decode_capacity}")

    def _check_tokens(self, sim):
        by_model: Dict[str, int] = {}
        for iid in sorted(sim.instances):
            inst = sim.instances[iid]
            m = inst.template.model
            by_model[m] = by_model.get(m, 0) + inst.tokens_out
        for m in sorted(sim.tokens):
            logged = sim.tokens[m]._total
            produced = by_model.get(m, 0)
            if logged != produced:
                _fail(f"token conservation broken for {m!r}: TokenRuns "
                      f"total {logged} != sum of instance tokens_out "
                      f"{produced}")

    def _check_requests(self, sim):
        now = sim.now
        cut = now + EPS
        # requests still travelling through the event heap: re-pushed
        # arrival holds, prefill batches in flight, KV transfers.
        # Future arrivals (arrival > now) are not yet "arrived".
        heap_cnt: Dict[str, int] = {}
        for _t, _c, _fn, fargs in sim.ev._q:
            for a in fargs:
                if isinstance(a, list):
                    for r in a:
                        if hasattr(r, "arrival") and r.arrival <= cut:
                            heap_cnt[r.model] = heap_cnt.get(r.model, 0) + 1
                elif hasattr(a, "arrival") and hasattr(a, "model") \
                        and a.arrival <= cut:
                    heap_cnt[a.model] = heap_cnt.get(a.model, 0) + 1
        fin: Dict[str, int] = {}
        for r in sim.finished:
            fin[r.model] = fin.get(r.model, 0) + 1
        pend: Dict[str, int] = {}
        for iid in sorted(sim.instances):
            inst = sim.instances[iid]
            m = inst.template.model
            pend[m] = pend.get(m, 0) \
                + len(inst.queue) + len(inst.resident)
        for m in sorted(sim.obs):
            arrived, _p, _o = sim.obs[m].arrival.window(-math.inf, cut)
            accounted = (fin.get(m, 0)
                         + sim.dropped_by_model.get(m, 0)
                         + sim.shed_by_model.get(m, 0)
                         + pend.get(m, 0)
                         + heap_cnt.get(m, 0))
            if arrived != accounted:
                _fail(
                    f"request conservation broken for {m!r} at "
                    f"t={now:.3f}: {arrived} arrived != {accounted} "
                    f"accounted (finished={fin.get(m, 0)} "
                    f"dropped={sim.dropped_by_model.get(m, 0)} "
                    f"shed={sim.shed_by_model.get(m, 0)} "
                    f"queued+resident={pend.get(m, 0)} "
                    f"in_heap={heap_cnt.get(m, 0)})")


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


def check_holdings(held: Dict[Tuple[str, str], int],
                   availability: Dict[Tuple[str, str], int]):
    """Held (live, non-draining) nodes fit the epoch's physical supply."""
    for key in sorted(held):
        if held[key] > availability.get(key, 0):
            _fail(f"cluster holds {held[key]} x {key} but the epoch's "
                  f"physical supply is {availability.get(key, 0)}")


def check_epoch_metrics(m):
    """EpochMetrics sanity: non-negative accounting, goodput below
    throughput (SLO-ok tokens are a subset of all tokens)."""
    for f in ("cost_per_hour", "init_cost", "solve_seconds",
              "assembly_ms", "solve_ms", "extract_ms"):
        v = getattr(m, f)
        if not math.isfinite(v) or v < -EPS:
            _fail(f"EpochMetrics.{f} = {v!r} (epoch {m.epoch})")
    for f in ("n_instances", "n_new", "n_drained", "n_preempted",
              "n_failed", "n_restarted", "n_shed", "n_mid_resolves"):
        if getattr(m, f) < 0:
            _fail(f"EpochMetrics.{f} = {getattr(m, f)} (epoch {m.epoch})")
    if m.solve_path not in ("", "decomposed", "rounded_lp", "monolithic",
                            "fallback"):
        _fail(f"EpochMetrics.solve_path = {m.solve_path!r} "
              f"(epoch {m.epoch})")
    for name in sorted(m.goodput):
        g, t = m.goodput[name], m.throughput.get(name, 0.0)
        if g < -EPS or t < -EPS:
            _fail(f"negative goodput/throughput for {name!r} "
                  f"(epoch {m.epoch}): {g}, {t}")
        if g > t + EPS + 1e-9 * max(abs(t), 1.0):
            _fail(f"goodput {g} exceeds throughput {t} for {name!r} "
                  f"(epoch {m.epoch})")
    for key in sorted(m.unmet):
        if m.unmet[key] < -EPS:
            _fail(f"negative unmet demand {m.unmet[key]} for {key} "
                  f"(epoch {m.epoch})")
    slo = getattr(m, "slo", None) or {}     # tolerate duck-typed stubs
    for name in sorted(slo):
        s = slo[name]
        for f in sorted(s):
            v = s[f]
            if not math.isfinite(v) or v < -EPS:
                _fail(f"EpochMetrics.slo[{name!r}][{f!r}] = {v!r} "
                      f"(epoch {m.epoch})")
        for fam in ("ttft", "tbt"):
            if not (s[f"{fam}_p50"] <= s[f"{fam}_p95"] + EPS
                    and s[f"{fam}_p95"] <= s[f"{fam}_p99"] + EPS):
                _fail(f"non-monotone {fam} percentiles for {name!r} "
                      f"(epoch {m.epoch}): p50={s[f'{fam}_p50']} "
                      f"p95={s[f'{fam}_p95']} p99={s[f'{fam}_p99']}")
            if s[f"{fam}_attain"] > 1.0 + EPS:
                _fail(f"{fam} SLO attainment {s[f'{fam}_attain']} > 1 "
                      f"for {name!r} (epoch {m.epoch})")
