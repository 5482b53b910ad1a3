"""Event-driven re-solve policy + churn-aware transition planning
(paper §5.1; ShuntServe motivates the churn case: spot preemptions make
reactive re-allocation pay exactly when re-solving is most disruptive).

``ReSolveController`` decides, once per epoch, whether the allocator
ILP should run at all:

* **demand-drift trigger** — the worst symmetric relative change of any
  (model, phase) demand against the demand at the last solve;
* **availability-delta trigger** — the max of the global L1 shift and
  the worst per-(region, config) relative change of the availability
  vector against the last solve;
* both triggers are *hysteretic* (Schmitt-style: fire above the ``_up``
  threshold, re-arm only after dropping below ``_down``) and share a
  post-solve **cooldown**, so a noisy-but-stationary signal hovering at
  the threshold cannot thrash the solver;
* a fixed **cadence** fallback (``max_interval_epochs``) guarantees the
  cluster is periodically re-optimized even with no trigger.

``TransitionPlanner`` scores candidate target allocations by *reconcile
churn* — the amortized INIT_DELAY cost of instances that would be
started plus a discounted drain cost for instances that would be torn
down — and feeds the cheapest-to-reach recent target to
``AllocatorState.set_incumbent`` as the warm start, so the solver's
incumbent bound reflects the cheapest transition, not just the last
solution.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.allocator import Allocation, Demand


@dataclass
class ControllerConfig:
    drift_up: float = 0.3           # demand trigger (symmetric rel. change)
    drift_down: float = 0.1         # demand re-arm level
    avail_up: float = 0.3           # availability trigger
    avail_down: float = 0.1         # availability re-arm level
    cooldown_epochs: int = 1        # min epochs between trigger solves
    max_interval_epochs: int = 4    # cadence fallback: always re-solve
    min_nodes: float = 4.0          # ignore per-key wiggle below this
    emergency_mult: float = 2.0     # a drift this many times the trigger
    #                                 threshold bypasses the cooldown
    #                                 (storm onset/recovery, demand cliffs)
    # -- mid-epoch (event-driven) evaluation, affordable now that a
    # re-solve is sub-second: ``decide_event`` fires once the capacity
    # lost to availability events (preemptions, failed restarts) since
    # the last solve reaches ``event_loss_frac`` of the held fleet, at
    # most ``max_mid_resolves`` times per epoch and never two solves
    # closer than ``min_event_gap_s`` of simulated time
    event_loss_frac: float = 0.1
    max_mid_resolves: int = 2
    min_event_gap_s: float = 30.0


@dataclass(frozen=True)
class ResolveDecision:
    resolve: bool
    reason: str                     # initial/demand_drift/avail_delta/
    #                                 preempted/failure/cadence/
    #                                 cooldown/steady/event


class ReSolveController:
    """Per-epoch re-solve gate.  Call ``decide`` once per epoch; call
    ``notify_solved`` after every *successful* solve so the reference
    demand/availability snapshots advance."""

    def __init__(self, cfg: Optional[ControllerConfig] = None):
        self.cfg = cfg or ControllerConfig()
        # observability: a repro_torch.obs.TraceLog (and a sim-time clock
        # callable), wired by ClusterRuntime.run; every decide() then
        # emits a "trigger" record with its reason and drift readings
        self.trace = None
        self.clock = None
        self._ref_demand: Optional[Dict[Tuple[str, str], float]] = None
        self._ref_avail: Optional[Dict[Tuple[str, str], float]] = None
        self._since = 0
        self._armed_demand = True
        self._armed_avail = True
        # mid-epoch (event-driven) state
        self._event_losses = 0
        self._mid_this_epoch = 0
        self._last_mid_t = -float("inf")

    # ----------------------------------------------------------- drifts
    def demand_drift(self, demands: Sequence[Demand]) -> float:
        """Worst symmetric relative change vs the last-solved demand:
        |d - ref| / max(d, ref) — bounded in [0, 1], so doubling and
        halving both read 0.5."""
        if self._ref_demand is None:
            return 1.0
        worst = 0.0
        for d in demands:
            ref = self._ref_demand.get((d.model, d.phase), 0.0)
            base = max(d.tokens_per_s, ref, 1e-9)
            worst = max(worst, abs(d.tokens_per_s - ref) / base)
        return worst

    def avail_delta(self, availability: Dict[Tuple[str, str], int]) -> float:
        if self._ref_avail is None:
            return 1.0
        # sorted: the union's hash order would make the float l1
        # accumulation (and thus the trigger) PYTHONHASHSEED-dependent
        keys = sorted(set(availability) | set(self._ref_avail))
        total_ref = sum(self._ref_avail.values())
        l1 = 0.0
        worst_key = 0.0
        for k in keys:
            a = float(availability.get(k, 0))
            r = float(self._ref_avail.get(k, 0))
            l1 += abs(a - r)
            if max(a, r) >= self.cfg.min_nodes:
                worst_key = max(worst_key, abs(a - r) / max(a, r))
        return max(l1 / max(total_ref, 1.0), worst_key)

    # ----------------------------------------------------------- decide
    def decide(self, epoch: int, demands: Sequence[Demand],
               availability: Dict[Tuple[str, str], int],
               n_preempted: int = 0,
               n_failed: int = 0) -> ResolveDecision:
        dec, dd, da = self._decide(demands, availability,
                                   n_preempted, n_failed)
        if self.trace is not None:
            # drift readings are null on the emergency short-circuits
            # (initial/preempted/failure), which fire before drifts
            # are evaluated
            self.trace.emit(
                "trigger",
                self.clock() if self.clock is not None else 0.0,
                epoch, resolve=dec.resolve, reason=dec.reason,
                demand_drift=dd, avail_delta=da)
        return dec

    def _decide(self, demands: Sequence[Demand],
                availability: Dict[Tuple[str, str], int],
                n_preempted: int, n_failed: int
                ) -> Tuple[ResolveDecision, Optional[float],
                           Optional[float]]:
        cfg = self.cfg
        self._since += 1
        self._mid_this_epoch = 0        # fresh mid-epoch budget
        if self._ref_demand is None:
            return ResolveDecision(True, "initial"), None, None
        if n_preempted > 0:
            # lost held capacity is an emergency: reactive re-allocation
            # (ShuntServe's case for spot churn) overrides cooldown and
            # arming — the reconcile loop cannot replace nodes whose
            # supply is gone; only a re-solve can move the capacity
            return ResolveDecision(True, "preempted"), None, None
        if n_failed > 0:
            # detected node failures get the same emergency treatment:
            # the restart path may have been blocked (backoff, budget,
            # vanished availability), so re-place the lost capacity now
            return ResolveDecision(True, "failure"), None, None
        dd = self.demand_drift(demands)
        da = self.avail_delta(availability)
        # Schmitt re-arming: a trigger that fired stays disarmed until
        # its signal falls back below the low threshold
        if dd <= cfg.drift_down:
            self._armed_demand = True
        if da <= cfg.avail_down:
            self._armed_avail = True
        fire_d = self._armed_demand and dd >= cfg.drift_up
        fire_a = self._armed_avail and da >= cfg.avail_up
        if self._since <= cfg.cooldown_epochs:
            # an extreme excursion (supply storm hitting/recovering, a
            # demand cliff) is worth a back-to-back solve; ordinary
            # trigger-level drift waits the cooldown out
            if fire_a and da >= cfg.emergency_mult * cfg.avail_up:
                self._armed_avail = False
                return ResolveDecision(True, "avail_delta"), dd, da
            if fire_d and dd >= cfg.emergency_mult * cfg.drift_up:
                self._armed_demand = False
                return ResolveDecision(True, "demand_drift"), dd, da
            return ResolveDecision(False,
                                   "cooldown" if (fire_d or fire_a)
                                   else "steady"), dd, da
        if fire_d:
            self._armed_demand = False
            return ResolveDecision(True, "demand_drift"), dd, da
        if fire_a:
            self._armed_avail = False
            return ResolveDecision(True, "avail_delta"), dd, da
        if self._since >= cfg.max_interval_epochs:
            return ResolveDecision(True, "cadence"), dd, da
        return ResolveDecision(False, "steady"), dd, da

    def decide_event(self, now: float, n_lost: int,
                     n_held: int) -> ResolveDecision:
        """Sub-epoch evaluation hook, driven by availability events.

        The runtime calls this the moment capacity is lost *inside* an
        epoch (a detected node failure, a replacement blocked by
        vanished supply) instead of waiting for the epoch edge.  Losses
        accumulate across calls; a re-solve fires once they reach
        ``event_loss_frac`` of the held fleet — throttled by the
        per-epoch ``max_mid_resolves`` budget and the
        ``min_event_gap_s`` spacing so a storm of events cannot thrash
        the solver.  ``now`` is simulated time (seconds)."""
        cfg = self.cfg
        self._event_losses += max(int(n_lost), 0)
        if self._ref_avail is None:
            # no standing solve yet: the epoch loop's "initial" decision
            # owns the first solve
            return ResolveDecision(False, "steady")
        if self._mid_this_epoch >= cfg.max_mid_resolves:
            return ResolveDecision(False, "cooldown")
        if now - self._last_mid_t < cfg.min_event_gap_s:
            return ResolveDecision(False, "cooldown")
        need = max(1.0, cfg.event_loss_frac * max(n_held, 1))
        if self._event_losses < need:
            return ResolveDecision(False, "steady")
        self._mid_this_epoch += 1
        self._last_mid_t = now
        return ResolveDecision(True, "event")

    def notify_solved(self, demands: Sequence[Demand],
                      availability: Dict[Tuple[str, str], int]):
        self._ref_demand = {(d.model, d.phase): d.tokens_per_s
                            for d in demands}
        self._ref_avail = {k: float(v) for k, v in availability.items()}
        self._since = 0
        self._event_losses = 0          # the solve absorbed the losses
        # the drift references just moved: any future excursion is fresh
        # information, so re-arm both triggers.  The Schmitt disarm
        # therefore only throttles a trigger whose solve *failed* (the
        # reference could not advance) — exactly the repeat-fire case
        # hysteresis is for.
        self._armed_demand = True
        self._armed_avail = True


class TransitionPlanner:
    """Scores candidate allocations by reconcile churn and picks the
    cheapest-to-reach one as the allocator's incumbent warm start.

    Churn from ``current`` to ``target`` counts, per (region, template):
    ``(target - current)+ * price * init_k`` for instances that must be
    started (the INIT_DELAY cost the runtime will amortize) plus
    ``(current - target)+ * price * init_k * drain_weight`` for
    instances that must drain (lost warm capacity, discounted because a
    drain finishes its in-flight work).
    """

    def __init__(self, library, regions: Sequence, init_k: float,
                 drain_weight: float = 0.5, history: int = 4):
        self._cfg = library.config_by_name
        self._region_by_name = {r.name: r for r in regions}
        self._init_k = init_k
        self._drain_weight = drain_weight
        self._max_hist = history
        self._hist: List[Dict[Tuple[str, Tuple], int]] = []
        self._tmpl: Dict[Tuple, object] = {}

    def record(self, alloc: Allocation):
        """Remember a solved target as a future transition candidate."""
        self._tmpl.update(alloc.templates)
        counts = dict(alloc.instances)
        if counts in self._hist:
            self._hist.remove(counts)
        self._hist.append(counts)
        del self._hist[:-self._max_hist]

    def _price(self, region_name: str, tkey: Tuple) -> float:
        t = self._tmpl.get(tkey)
        region = self._region_by_name.get(region_name)
        if t is None or region is None:
            return 0.0
        return t.cost(region, self._cfg)

    def churn_cost(self, target: Dict[Tuple[str, Tuple], int],
                   current: Dict[Tuple[str, Tuple], int]) -> float:
        cost = 0.0
        # sorted: float accumulation order must not depend on hash seed
        for key in sorted(set(target) | set(current)):
            tgt = target.get(key, 0)
            cur = current.get(key, 0)
            if tgt == cur:
                continue
            price = self._price(key[0], key[1])
            if tgt > cur:
                cost += (tgt - cur) * price * self._init_k
            else:
                cost += (cur - tgt) * price * self._init_k \
                    * self._drain_weight
        return cost

    def choose_incumbent(self, current: Dict[Tuple[str, Tuple], int]
                         ) -> Optional[Dict[Tuple[str, Tuple], int]]:
        """Cheapest-to-reach recent target (ties: most recent)."""
        if not self._hist:
            return None
        return min(reversed(self._hist),
                   key=lambda t: self.churn_cost(t, current))
