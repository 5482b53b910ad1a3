"""Cluster runtime: epoch-loop orchestration (paper §5.1 instance
life-cycle + §6.1 evaluation protocol).

Every epoch: estimate demand, read availability, re-solve allocation
(Coral ILP or a baseline), reconcile the running cluster (graceful drain
on scale-down, INIT_DELAY on scale-up), then advance the event simulator
through the epoch while accounting hourly cost (provisioning + amortized
initialization).

The loop closes without oracle inputs (repro_torch.control): leave
``demands_per_epoch`` unset and demands come from a ``DemandEstimator``
fed by the simulator's windowed observables; install a
``ReSolveController`` to gate solves behind demand-drift /
availability-delta triggers, and a ``TransitionPlanner`` to warm-start
``AllocatorState.set_incumbent`` with the cheapest-to-reach target.
``spot_market=True`` reinterprets the availability series as *total*
reclaimable supply: held instances that no longer fit are preempted
(killed, never auto-replaced), and reconcile scale-up is capped by the
epoch's availability.

Pass a persistent ``repro_torch.core.allocator.AllocatorState`` as
``allocator_fn`` to reuse the assembled ILP structure across epoch
re-solves (incumbent warm-start included).  A failed or timed-out solve
(``Allocation.ok == False``) is *not* a scale-to-zero target: the
runtime keeps the previous epoch's allocation and flags the epoch via
``EpochMetrics.solver_failed``.

Fault tolerance: ``fail_instance`` kills a running instance (node
failure) at a random time *within* the epoch via
``Simulator.kill_instance``, which settles the batched event loop's
in-flight accounting and re-routes the victim's work (decode requests
— resident and admission-queued alike — rejoin the decode pool
directly; they never pass through prefill again).  The coordinator
immediately restarts a replacement instance toward the standing
allocation target (paying the initialization delay and amortized init
cost), and the next epoch re-solve re-optimizes the whole cluster
(paper §5.1).

Where it runs: the epoch loop, reconcile, the fault paths and the event
simulator are host Python, as in the reference; the re-solves run on the
library's device (``AllocatorState``'s columns, caps and selection) and
the simulator's observables (goodput, throughput, the SLO report) are
queried as tensors there.  The runtime runs on the library's device.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.allocator import AllocProblem, Allocation, Demand
from repro_torch.core.hardware import NodeConfig, Region
from repro_torch.debug import invariants as _inv
from repro_torch.kernels.common import resolve_device
from repro_torch.core.modelspec import ServedModel
from repro_torch.core.templates import TemplateLibrary
from repro_torch.obs.percentiles import percentiles as _percentiles
from repro_torch.obs.reqlog import SLOReport, SLOTargets
from repro_torch.simulator.sim import INIT_DELAY_S, SimInstance, Simulator
from repro_torch.traces.workloads import Request


@dataclass
class EpochMetrics:
    epoch: int
    cost_per_hour: float
    init_cost: float
    goodput: Dict[str, float]
    throughput: Dict[str, float]
    n_instances: int
    n_new: int
    n_drained: int
    solve_seconds: float
    unmet: Dict
    # the epoch's solve failed/timed out and the previous epoch's
    # allocation (or an incumbent fallback) was kept instead
    solver_failed: bool = False
    # controller observability: did this epoch run the allocator, and
    # why (initial/epoch/demand_drift/avail_delta/preempted/cadence/
    # cooldown/steady/bootstrap) — "epoch" is the fixed every-epoch
    # cadence used when no ReSolveController is installed
    resolve_triggered: bool = True
    trigger_reason: str = "epoch"
    # spot-market preemptions suffered this epoch (reclaimed instances)
    n_preempted: int = 0
    # fault-recovery observability: failures *detected* this epoch (the
    # coordinator's view — a crash is counted when its health probe
    # fires, which may be the epoch after the node actually died),
    # replacements started mid-epoch, and arrivals shed by admission
    # control
    n_failed: int = 0
    n_restarted: int = 0
    n_shed: int = 0
    # the epoch touched fault recovery: a failure was detected, a
    # replacement started, or a crashed-but-undetected node is still
    # black-holing requests at the epoch edge
    recovering: bool = False
    # degradation-ladder provenance of the epoch's allocation target:
    # solved / fallback (solver timed out, incumbent returned) /
    # last_good (solve failed outright, previous target kept) / kept
    # (trigger-gated skip) / none (failed with no previous target)
    alloc_source: str = "solved"
    # solve-time breakdown of the epoch's allocator call (all zero when
    # the solve was trigger-gated away) and the tier that produced the
    # target, so scenarios and fault_bench can attribute regressions
    assembly_ms: float = 0.0
    solve_ms: float = 0.0               # pure solver time across tiers
    extract_ms: float = 0.0
    solve_path: str = ""    # decomposed|rounded_lp|monolithic|fallback|""
    # event-driven re-solves run *inside* this epoch (availability
    # events: detected failures, blocked restarts)
    n_mid_resolves: int = 0
    # per-model SLO latency summary for the epoch window (repro_torch.obs):
    # model -> {ttft_p50/p95/p99, tbt_p50/p95/p99, ttft_attain,
    # tbt_attain, n_ttft, n_tbt_tokens}
    slo: Dict[str, Dict[str, float]] = field(default_factory=dict)


@dataclass
class RunResult:
    epochs: List[EpochMetrics] = field(default_factory=list)
    # the run's SLOReport, for arbitrary-window / tail-series queries
    # beyond the per-epoch EpochMetrics.slo summaries
    slo_report: Optional[SLOReport] = None

    def avg_cost(self) -> float:
        if not self.epochs:
            return 0.0
        return sum(e.cost_per_hour for e in self.epochs) / len(self.epochs)

    def avg_goodput(self, model: str) -> float:
        if not self.epochs:
            return 0.0
        return sum(e.goodput[model] for e in self.epochs) / len(self.epochs)

    def n_resolves(self) -> int:
        return sum(1 for e in self.epochs if e.resolve_triggered)

    def total_failed(self) -> int:
        if not self.epochs:
            return 0
        return sum(e.n_failed for e in self.epochs)

    def total_restarted(self) -> int:
        if not self.epochs:
            return 0
        return sum(e.n_restarted for e in self.epochs)

    def total_shed(self) -> int:
        if not self.epochs:
            return 0
        return sum(e.n_shed for e in self.epochs)

    def recovery_epochs(self) -> int:
        if not self.epochs:
            return 0
        return sum(1 for e in self.epochs if e.recovering)

    def solve_path_counts(self) -> Dict[str, int]:
        """How many epoch solves each tier served (skips excluded)."""
        out: Dict[str, int] = {}
        for e in self.epochs:
            if e.solve_path:
                out[e.solve_path] = out.get(e.solve_path, 0) + 1
        return out

    def solve_ms_percentiles(self) -> Tuple[float, float]:
        """(p50, p95) of per-epoch solver time, solved epochs only
        (obs.percentiles nearest-rank semantics)."""
        return _percentiles(
            (e.solve_ms for e in self.epochs if e.resolve_triggered),
            (0.50, 0.95))

    def total_mid_resolves(self) -> int:
        return sum(e.n_mid_resolves for e in self.epochs)


AllocatorFn = Callable[[AllocProblem], Allocation]


class ClusterRuntime:
    def __init__(self, models: Dict[str, ServedModel],
                 regions: Sequence[Region], configs: Sequence[NodeConfig],
                 library: TemplateLibrary, allocator_fn: AllocatorFn,
                 workloads: Dict, epoch_s: float = 360.0,
                 init_amortize_s: float = 3600.0,
                 allocator_time_limit: float = 60.0,
                 sim_batched: bool = True, spot_market: bool = False,
                 health_check_s: float = 0.0, restart_policy=None,
                 shed_policy=None, trace=None, slo_targets=None):
        # the runtime, its simulator and its observables live where the
        # library was built
        self.device = resolve_device(library.device)
        self.models = models
        self.regions = regions
        self.configs = configs
        self.library = library
        self.allocator_fn = allocator_fn
        self.workloads = workloads
        self.epoch_s = epoch_s
        # spot-market availability semantics: the per-epoch availability
        # series is the provider's *total* reclaimable supply (held
        # nodes included) — held instances exceeding it are preempted
        # at the epoch edge.  Default (False) keeps the classic "we
        # keep what we hold" reading where the series is free supply.
        self.spot_market = spot_market
        self.init_k = INIT_DELAY_S / init_amortize_s
        self.time_limit = allocator_time_limit
        # failure-detection latency: a crashed node black-holes routed
        # work for this long before its health probe fires and the
        # queue is re-routed (0 = the seed's instant detection)
        self.health_check_s = health_check_s
        # repro_torch.control.faults.RestartPolicy (backoff + budget +
        # availability check); None = immediate availability-checked
        # restart on every detected failure
        self.restart_policy = restart_policy
        self.sim = Simulator(models, {c.name: c for c in configs}, workloads,
                             batched=sim_batched, device=self.device)
        if shed_policy is not None:     # admission control / load shed
            self.sim.shed_policy = shed_policy
        # observability (repro_torch.obs): structured control-plane tracing
        # (a TraceLog, or None for no tracing) and the run's SLO
        # report over the simulator's request/token records
        self.trace = trace
        self.slo = SLOReport(self.sim.reqlog, self.sim.tokens,
                             slo_targets if slo_targets is not None
                             else SLOTargets.from_models(models))
        self._epoch_idx = 0             # current epoch, for trace records
        self.region_by_name: Dict[str, Region] = {r.name: r for r in regions}
        self.running: Dict[Tuple[str, Tuple], List[SimInstance]] = {}
        # last successful allocation, kept as the target when a later
        # epoch's solve fails (never scale-to-zero on solver failure)
        self._last_alloc: Optional[Allocation] = None
        # mid-epoch failure-replacement accounting (folded into the
        # current epoch's n_new / init_cost by run())
        self._epoch_new = 0
        self._epoch_init_cost = 0.0
        # fault-recovery accounting for the running epoch
        self._epoch_failed = 0
        self._epoch_restarted = 0
        self._epoch_failed_keys: set = set()
        self._fail_pending = 0          # detections since the last decide
        self._epoch_avail: Optional[Dict[Tuple[str, str], int]] = None
        self._injector = None
        # mid-epoch (event-driven) re-solve wiring: run() installs the
        # controller + the epoch's demand/raw-availability snapshots so
        # availability events can trigger a solve inside the epoch
        self._controller = None
        self._epoch_demands: Optional[Sequence[Demand]] = None
        self._epoch_raw_avail: Optional[Dict[Tuple[str, str], int]] = None
        self._epoch_mid_resolves = 0
        self._epoch_mid_drained = 0

    # ------------------------------------------------------------ helpers
    def _emit(self, kind: str, **fields):
        """Trace a control-plane event at the simulator's current time
        in the current epoch (no-op without a TraceLog)."""
        if self.trace is not None:
            self.trace.emit(kind, self.sim.now, self._epoch_idx, **fields)

    def _held_nodes(self) -> Dict[Tuple[str, str], int]:
        held: Dict[Tuple[str, str], int] = {}
        for (region, key), insts in self.running.items():
            live = [i for i in insts if not i.dead and not i.draining]
            for inst in live:
                for c, n in inst.template.counts:
                    held[(region, c)] = held.get((region, c), 0) + n
        return held

    def _current_counts(self) -> Dict[Tuple[str, Tuple], int]:
        return {k: len([i for i in v if not i.dead and not i.draining])
                for k, v in self.running.items()}

    def reconcile(self, alloc: Allocation,
                  avail: Optional[Dict[Tuple[str, str], int]] = None
                  ) -> Tuple[int, int, float]:
        """Scale instances toward the target allocation. Returns
        (n_new, n_drained, init_cost_per_hour_amortized).

        When ``avail`` is given (the same (region, config) -> nodes map
        the allocator solved against), scale-up is capped by it: an
        instance whose node usage no longer fits is *not* started (the
        capacity it wanted was lost — e.g. preempted spot supply — and
        cannot be conjured back by reconciliation).  ILP targets always
        fit their own availability, so the cap only binds for targets
        computed against stale supply (static baselines, kept
        allocations on skipped/failed solves)."""
        n_new = n_drained = 0
        init_cost = 0.0
        cfg = self.library.config_by_name
        targets = dict(alloc.instances)
        # scale down / drain extras (lowest load first, §5.1)
        for key, insts in list(self.running.items()):
            live = [i for i in insts if not i.dead and not i.draining]
            tgt = targets.get(key, 0)
            if len(live) > tgt:
                live.sort(key=lambda i: len(i.queue) + len(i.resident))
                for inst in live[:len(live) - tgt]:
                    self.sim.drain_instance(inst)
                    n_drained += 1
        # scale up
        held = self._held_nodes() if avail is not None else None
        for (region_name, tkey), tgt in targets.items():
            key = (region_name, tkey)
            live = [i for i in self.running.get(key, [])
                    if not i.dead and not i.draining]
            template = alloc.templates[tkey]
            region = self.region_by_name[region_name]
            for _ in range(tgt - len(live)):
                if held is not None:
                    if any(held.get((region_name, c), 0) + n
                           > avail.get((region_name, c), 0)
                           for c, n in template.counts):
                        break               # this template no longer fits
                    for c, n in template.counts:
                        held[(region_name, c)] = \
                            held.get((region_name, c), 0) + n
                inst = self.sim.add_instance(region_name, template)
                self.running.setdefault(key, []).append(inst)
                n_new += 1
                init_cost += template.cost(region, cfg) * self.init_k
        return n_new, n_drained, init_cost

    def _reclaim(self, avail: Dict[Tuple[str, str], int]) -> int:
        """Spot-market preemption: kill held instances until every
        (region, config) holding fits inside the epoch's *total* supply
        (``spot_market`` semantics).  Victims are the least-loaded
        instances using the over-held (region, config); there is no
        automatic replacement — recovering capacity is the allocator's
        job at the next (trigger-driven) re-solve."""
        killed = 0
        while True:
            held = self._held_nodes()
            over = [k for k, h in held.items()
                    if h > avail.get(k, 0)]
            if not over:
                return killed
            region, cname = over[0]
            cands = [i for (rname, _tk), insts in self.running.items()
                     if rname == region
                     for i in insts
                     if not i.dead and not i.draining
                     and any(c == cname for c, _n in i.template.counts)]
            if not cands:       # defensive hang-guard: unreachable while
                return killed   # _held_nodes excludes draining/dead
            victim = min(cands,
                         key=lambda i: len(i.queue) + len(i.resident))
            self.sim.kill_instance(victim)
            self._emit("preempt", iid=victim.iid, region=victim.region,
                       model=victim.template.model)
            killed += 1

    def _shortfall(self, alloc: Allocation,
                   demands: Sequence[Demand]) -> Dict:
        """Unmet tokens/s of a kept allocation against fresh demands."""
        unmet = {}
        for d in demands:
            short = d.tokens_per_s - alloc.served(d.model, d.phase)
            if short > 1e-6:
                unmet[(d.model, d.phase)] = short
        return unmet

    def fail_instance(self, rng: random.Random) -> Optional[SimInstance]:
        """Kill one random live instance (node-failure injection) and
        start a replacement toward the allocation target — if the
        epoch's availability admits one.

        Victims are drawn from *serving* (ready) instances when any
        exist — a node that is still initializing has nothing to lose to
        a failure, and the seed behavior of repeatedly striking the
        just-started replacement at the epoch boundary left the cluster
        permanently without capacity. The replacement pays the usual
        ``INIT_DELAY_S`` and its amortized init cost is charged to the
        current epoch.  Under ``spot_market=True`` the replacement goes
        through the same availability check ``reconcile`` applies: a
        fully-reclaimed (region, config) cannot conjure one back.
        """
        live = [i for i in self.sim.instances.values()
                if not i.dead and not i.draining]
        ready = [i for i in live if i.ready_at <= self.sim.now + 1e-9]
        pool = ready or live
        if not pool:
            return None
        inst = rng.choice(pool)
        # kill_instance settles the batched loop's in-flight accounting
        # and re-routes the victim's work: decode requests (resident AND
        # queued for admission — both already prefilled) rejoin the
        # decode pool via _join_decode, never back through prefill
        self.sim.kill_instance(inst)
        # the legacy fail_rate path bypasses the injector and the
        # health probe: trace the injection and its instant detection
        # here so every restart still follows a detect
        self._emit("fault_inject", fault="crash", iid=inst.iid)
        self._emit("fault_detect", iid=inst.iid, detect_lag_s=0.0)
        self._epoch_failed += 1
        self._epoch_failed_keys.add((inst.region, inst.template.key))
        # immediate replacement: the standing allocation still targets
        # this (region, template); do not wait for the next re-solve
        self._restart(inst)
        self._maybe_mid_resolve()
        return inst

    # ----------------------------------------------- crash / detection
    def _crash(self, inst: SimInstance):
        """Node failure with health-check detection latency: the
        simulator black-holes the node until the probe fires, then the
        coordinator notices (``_on_failure_detected``) and the restart
        policy decides what happens."""
        if inst.dead or inst.failed:
            return
        t_detect = self.sim.crash_instance(inst, self.health_check_s)
        # pushed after crash_instance's own kill event at t_detect, so
        # the queue has been re-routed by the time the coordinator acts
        self.sim.ev.push(t_detect, self._on_failure_detected, inst)

    def _on_failure_detected(self, inst: SimInstance):
        self._epoch_failed += 1
        self._fail_pending += 1
        key = (inst.region, inst.template.key)
        self._epoch_failed_keys.add(key)
        self._emit("fault_detect", iid=inst.iid,
                   detect_lag_s=max(self.health_check_s, 0.0))
        pol = self.restart_policy
        if pol is None:
            self._restart(inst)
        elif pol.allow():
            delay = pol.delay(key)
            pol.note_restart(key)
            if delay > 0.0:
                self.sim.ev.push(self.sim.now + delay, self._restart, inst)
            else:
                self._restart(inst)
        else:
            # restart budget exhausted — the failure-driven re-solve
            # below (or the epoch-edge reconcile) heals it
            self._emit("restart", for_iid=inst.iid,
                       outcome="budget_exhausted")
        self._maybe_mid_resolve()

    def _maybe_mid_resolve(self):
        """Sub-epoch trigger evaluation: ask the controller whether the
        availability event that just fired (a detected failure, a
        blocked restart) warrants re-solving *now* instead of at the
        epoch edge — affordable since the decomposed tier made the
        online solve sub-second.  A successful solve immediately
        becomes the reconcile target, so replacement capacity is placed
        mid-epoch (where ThunderServe's lightweight re-deployment wins
        live)."""
        ctl = self._controller
        if ctl is None or not hasattr(ctl, "decide_event") \
                or self._epoch_raw_avail is None \
                or self._epoch_demands is None:
            return
        n_held = sum(len([i for i in v if not i.dead and not i.draining])
                     for v in self.running.values())
        dec = ctl.decide_event(self.sim.now, 1, n_held)
        if not dec.resolve:
            return
        raw = self._epoch_raw_avail
        if self.spot_market:
            avail = dict(raw)
        else:
            avail = dict(raw)           # we keep what we hold
            for k, n in self._held_nodes().items():
                avail[k] = avail.get(k, 0) + n
        demands = self._epoch_demands
        prob = AllocProblem(
            self.regions, self.configs, avail, demands, self.library,
            current=self._current_counts(), init_penalty_k=self.init_k,
            time_limit=self.time_limit)
        alloc = self.allocator_fn(prob)
        self._epoch_mid_resolves += 1
        self._emit("mid_resolve", reason="availability_event",
                   solve_ms=getattr(alloc, "solver_seconds", 0.0) * 1e3,
                   ok=bool(alloc.ok
                           and not getattr(alloc, "fallback", False)))
        if not alloc.ok or getattr(alloc, "fallback", False):
            return      # a failed mid-epoch solve keeps the standing
            # target; the epoch-edge decide() sees the losses anyway
        if _inv.sanitize_enabled():
            _inv.check_allocation(alloc, avail)
        self._last_alloc = alloc
        n_new, n_drained, init_cost = self.reconcile(
            alloc, self._epoch_avail)
        self._epoch_new += n_new
        self._epoch_mid_drained += n_drained
        self._epoch_init_cost += init_cost
        ctl.notify_solved(demands, raw)

    def _restart(self, inst: SimInstance) -> Optional[SimInstance]:
        """Start a replacement for a failed instance, bounded by the
        epoch's availability; charges the amortized init cost to the
        current epoch and draws the injector's flaky-restart outcome."""
        if not self._restart_fits(inst.region, inst.template):
            # the capacity is gone (e.g. fully-reclaimed spot supply):
            # only a re-solve can move the load somewhere that exists
            self._emit("restart", for_iid=inst.iid, outcome="blocked")
            return None
        key = (inst.region, inst.template.key)
        repl = self.sim.add_instance(inst.region, inst.template)
        self.running.setdefault(key, []).append(repl)
        region = self.region_by_name[inst.region]
        self._epoch_new += 1
        self._epoch_restarted += 1
        self._epoch_init_cost += inst.template.cost(
            region, self.library.config_by_name) * self.init_k
        self._emit("restart", for_iid=inst.iid, outcome="started",
                   new_iid=repl.iid, ready_at=repl.ready_at)
        if self._injector is not None:
            flake = self._injector.restart_outcome()
            if flake is not None:       # crash loop: it dies again
                self.sim.ev.push(repl.ready_at + flake, self._crash, repl)
                if self.trace is not None:
                    # planned like the injector's records: t is the
                    # *future* re-crash time of the flaky replacement
                    self.trace.emit("fault_inject",
                                    repl.ready_at + flake,
                                    self._epoch_idx, fault="flake",
                                    iid=repl.iid)
        return repl

    def _restart_fits(self, region_name: str, template) -> bool:
        """Same availability bound ``reconcile`` applies to scale-up:
        current holdings plus the replacement must fit the availability
        the epoch solved against (which includes held nodes outside the
        spot market, so non-spot replacements always fit)."""
        pol = self.restart_policy
        if pol is not None and not pol.check_availability:
            return True
        avail = self._epoch_avail
        if avail is None:       # outside run(): nothing to check against
            return True
        held = self._held_nodes()
        return all(held.get((region_name, c), 0) + n
                   <= avail.get((region_name, c), 0)
                   for c, n in template.counts)

    # ---------------------------------------------------------------- run
    def run(self, requests: List[Request],
            availability_per_epoch: List[Dict[Tuple[str, str], int]],
            demands_per_epoch: Optional[List[List[Demand]]] = None,
            fail_rate_per_epoch: float = 0.0, seed: int = 0,
            estimator=None, controller=None, planner=None,
            fault_injector=None) -> RunResult:
        """Run the epoch loop.

        Demand source: pass oracle ``demands_per_epoch`` (the classic
        path), or leave it ``None`` to close the loop — demands then
        come from a ``repro_torch.control.estimator.DemandEstimator`` (the
        given one, or a default-configured one) fed by the simulator's
        observables after every epoch.

        Re-solve policy: with a ``repro_torch.control.controller``
        ``ReSolveController`` the allocator only runs on demand-drift /
        availability-delta triggers (or the cadence fallback); skipped
        epochs keep the standing allocation.  A ``TransitionPlanner``
        additionally feeds the allocator the cheapest-to-reach recent
        target as its incumbent warm start (requires an allocator with
        ``set_incumbent``, e.g. ``AllocatorState``).

        Fault injection: a ``repro_torch.control.faults.FaultInjector`` plans
        per-epoch crash / straggler events (scheduled mid-epoch into
        the simulator), may serve the control plane a stale
        availability feed (the physical market — spot reclaim,
        reconcile caps, restart checks — always uses the true series),
        and draws flaky-restart outcomes for every replacement the
        restart path starts.
        """
        rng = random.Random(seed)
        self._injector = fault_injector
        self._controller = controller
        # hand the control-plane components this run's TraceLog unless
        # the caller already wired their own
        if self.trace is not None:
            if controller is not None \
                    and getattr(controller, "trace", None) is None:
                controller.trace = self.trace
                if getattr(controller, "clock", None) is None:
                    controller.clock = lambda: self.sim.now
            if fault_injector is not None \
                    and getattr(fault_injector, "trace", None) is None:
                fault_injector.trace = self.trace
        if demands_per_epoch is not None and estimator is not None:
            raise ValueError("pass oracle demands_per_epoch OR an "
                             "estimator, not both")
        if demands_per_epoch is None and estimator is None:
            from repro_torch.control.estimator import DemandEstimator
            estimator = DemandEstimator(list(self.models), self.workloads)
        for r in requests:
            self.sim.submit(r)
        result = RunResult()
        n_epochs = len(availability_per_epoch)
        can_warm = planner is not None \
            and hasattr(self.allocator_fn, "set_incumbent")
        for e in range(n_epochs):
            self._epoch_idx = e
            t0 = e * self.epoch_s
            t1 = t0 + self.epoch_s
            if estimator is not None:
                demands = estimator.estimate(horizon_s=self.epoch_s)
            else:
                demands = demands_per_epoch[e]
            if _inv.sanitize_enabled():
                _inv.check_demands(demands)
            true_avail = dict(availability_per_epoch[e])
            n_preempted = 0
            if self.spot_market:
                # the series is total supply: shed preempted holdings,
                # then solve against the supply itself.  Preemption is
                # physical — it uses the true series even when the
                # control plane's feed is stale.
                n_preempted = self._reclaim(true_avail)
            if fault_injector is not None:
                raw = dict(fault_injector.observed_availability(
                    e, true_avail))
            else:
                raw = true_avail
            if self.spot_market:
                avail = raw
                rec_avail = true_avail
            else:
                avail = dict(raw)       # the controller drifts on the
                # raw market series; only the solver sees held nodes
                rec_avail = dict(true_avail)
                for k, n in self._held_nodes().items():
                    avail[k] = avail.get(k, 0) + n  # we keep what we hold
                    rec_avail[k] = rec_avail.get(k, 0) + n
            # physical capacity bound for reconcile scale-up and
            # mid-epoch restarts: the provider grants what exists, not
            # what a stale feed claims
            self._epoch_avail = rec_avail
            # snapshots for the event-driven mid-epoch re-solve hook
            self._epoch_demands = demands
            self._epoch_raw_avail = raw
            self._epoch_mid_resolves = 0
            self._epoch_mid_drained = 0
            n_failed_detected = self._fail_pending
            self._fail_pending = 0
            if controller is not None:
                decision = controller.decide(e, demands, raw,
                                             n_preempted=n_preempted,
                                             n_failed=n_failed_detected)
                resolve, reason = decision.resolve, decision.reason
            else:
                # no controller: fixed every-epoch cadence — the
                # runtime traces the decision itself (a controller
                # emits its own trigger records from decide())
                resolve, reason = True, "epoch"
                self._emit("trigger", resolve=True, reason="epoch")
            if not resolve and self._last_alloc is None:
                resolve, reason = True, "bootstrap"
                self._emit("trigger", resolve=True, reason="bootstrap")
            solver_failed = False
            alloc_source = "kept"
            if resolve:
                prob = AllocProblem(
                    self.regions, self.configs, avail, demands,
                    self.library, current=self._current_counts(),
                    init_penalty_k=self.init_k, time_limit=self.time_limit)
                if can_warm:
                    inc = planner.choose_incumbent(self._current_counts())
                    if inc is not None:
                        self.allocator_fn.set_incumbent(inc)
                alloc = self.allocator_fn(prob)
                solver_failed = not alloc.ok \
                    or getattr(alloc, "fallback", False)
                solve_s, unmet = alloc.solve_seconds, alloc.unmet
                # breakdown captured before any fallback reassignment
                solve_path = getattr(alloc, "solve_path", "monolithic")
                assembly_ms = getattr(alloc, "build_seconds", 0.0) * 1e3
                solve_ms = getattr(alloc, "solver_seconds", 0.0) * 1e3
                extract_ms = getattr(alloc, "extract_seconds", 0.0) * 1e3
                if not alloc.ok:
                    # bottom rungs of the degradation ladder: the solve
                    # failed outright (no incumbent to fall back on) —
                    # an empty allocation is NOT a scale-to-zero
                    # target, keep the previous epoch's allocation (if
                    # any) instead of draining the cluster, reporting
                    # its shortfall against *this* epoch's demands
                    if self._last_alloc is not None:
                        alloc = self._last_alloc
                        unmet = self._shortfall(alloc, demands)
                        alloc_source = "last_good"
                    else:
                        alloc_source = "none"
                else:
                    # middle rung: a deadline-bounded solve that timed
                    # out returns the incumbent (Allocation.fallback)
                    alloc_source = "fallback" if solver_failed \
                        else "solved"
                    if alloc_source == "solved" \
                            and _inv.sanitize_enabled():
                        # a fresh solve must fit the availability it
                        # saw; kept/fallback targets may legitimately
                        # overshoot a shrunken market (reconcile caps
                        # them), so only "solved" is checked
                        _inv.check_allocation(alloc, avail)
                    self._last_alloc = alloc
                    # a fallback (failed-HiGHS) result is a usable
                    # target but NOT a solve: the controller's drift
                    # references must not advance (the trigger should
                    # keep firing until a real re-solve lands), and the
                    # planner must not score it as a reached optimum
                    if not solver_failed:
                        if controller is not None:
                            controller.notify_solved(demands, raw)
                        if planner is not None:
                            planner.record(alloc)
            else:
                # trigger-gated skip: keep the standing allocation as
                # the target (reconcile still replaces lost capacity)
                alloc = self._last_alloc
                solve_s = 0.0
                unmet = self._shortfall(alloc, demands)
                solve_path = ""
                assembly_ms = solve_ms = extract_ms = 0.0
            if resolve:
                self._emit("solve", path=solve_path, solve_ms=solve_ms,
                           assembly_ms=assembly_ms,
                           extract_ms=extract_ms, total_ms=solve_s * 1e3,
                           alloc_source=alloc_source,
                           solver_failed=solver_failed)
            n_new, n_drained, init_cost = self.reconcile(alloc, rec_avail)
            self._emit("reconcile", n_new=n_new, n_drained=n_drained,
                       n_kept=max(
                           len([i for i in self.sim.instances.values()
                                if not i.dead and not i.draining])
                           - n_new, 0))
            self._epoch_new = 0
            self._epoch_init_cost = 0.0
            self._epoch_failed = 0
            self._epoch_restarted = 0
            prev_failed_keys = self._epoch_failed_keys
            self._epoch_failed_keys = set()
            shed0 = self.sim.shed
            if self.restart_policy is not None:
                self.restart_policy.begin_epoch(prev_failed_keys)
            if fail_rate_per_epoch > 0 and rng.random() < fail_rate_per_epoch:
                # the node dies at a random point of the epoch, not at
                # the reconcile instant
                self.sim.ev.push(t0 + rng.random() * self.epoch_s,
                                 self.fail_instance, rng)
            if fault_injector is not None:
                for f in fault_injector.plan_epoch(
                        e, t0, self.epoch_s,
                        self.sim.instances.values()):
                    if f.kind == "crash":
                        self.sim.ev.push(f.t, self._crash, f.inst)
                    else:
                        self.sim.ev.push(f.t, self.sim.degrade_instance,
                                         f.inst, f.factor, f.duration_s)
            self.sim.run_until(t1)
            if _inv.sanitize_enabled():
                pol = self.restart_policy
                if pol is None or pol.check_availability:
                    # a restart policy that skips availability checks
                    # deliberately over-holds; everyone else must fit
                    # the epoch's physical supply
                    _inv.check_holdings(self._held_nodes(), rec_avail)
            if estimator is not None:
                estimator.observe(self.sim, t0, t1)
            n_new += self._epoch_new
            n_drained += self._epoch_mid_drained
            init_cost += self._epoch_init_cost
            # provisioning cost of the live cluster
            cfg = self.library.config_by_name
            cost = 0.0
            for (region_name, tkey), insts in self.running.items():
                region = self.region_by_name[region_name]
                live = [i for i in insts if not i.dead]
                for inst in live:
                    cost += inst.template.cost(region, cfg)
            em = EpochMetrics(
                epoch=e, cost_per_hour=cost + init_cost, init_cost=init_cost,
                goodput={m: self.sim.goodput(m, t0, t1) for m in self.models},
                throughput={m: self.sim.throughput(m, t0, t1)
                            for m in self.models},
                n_instances=len([i for i in self.sim.instances.values()
                                 if not i.dead]),
                n_new=n_new, n_drained=n_drained,
                solve_seconds=solve_s, unmet=unmet,
                solver_failed=solver_failed,
                resolve_triggered=resolve, trigger_reason=reason,
                n_preempted=n_preempted,
                n_failed=self._epoch_failed,
                n_restarted=self._epoch_restarted,
                n_shed=self.sim.shed - shed0,
                recovering=(self._epoch_failed > 0
                            or self._epoch_restarted > 0
                            or any(i.failed and not i.dead
                                   for i in self.sim.instances.values())),
                alloc_source=alloc_source,
                assembly_ms=assembly_ms, solve_ms=solve_ms,
                extract_ms=extract_ms, solve_path=solve_path,
                n_mid_resolves=self._epoch_mid_resolves,
                slo=self.slo.window(t0, t1))
            if _inv.sanitize_enabled():
                _inv.check_epoch_metrics(em)
            result.epochs.append(em)
        result.slo_report = self.slo
        return result
