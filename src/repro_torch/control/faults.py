"""Seeded, composable fault-injection subsystem (ThunderServe/ShuntServe motivate the fault classes: mid-tier cloud GPUs
fail in correlated bursts, degrade into stragglers, and lie about
supply — they do not flip i.i.d. coins).

``FaultInjector`` turns a ``FaultConfig`` into a deterministic
per-epoch plan of fault events over the currently live instances:

* **independent crashes** — each live instance crashes this epoch with
  ``crash_rate``, at a uniform time within the epoch;
* **correlated bursts** — with ``burst_rate`` one (region,
  device-family) failure domain loses ``burst_frac`` of its instances
  at a single instant (family = the template's primary node config, a
  proxy for shared racks/host pools of one GPU SKU);
* **stragglers** — with ``straggler_rate`` an instance serves at
  ``1/straggler_factor`` of its speed for ``straggler_duration_s``
  (iteration *and* perceived latency inflate, so degraded nodes can
  fall out of SLO);
* **flaky restarts / crash loops** — each replacement the runtime
  starts re-crashes shortly after becoming ready with
  ``restart_flake_p`` (the crash-loop fuel that makes restart backoff
  and budgets pay);
* **stale availability feed** — the solver-visible availability lags
  the true supply by ``feed_lag_epochs`` and/or fails to refresh with
  ``feed_stale_p`` (the physical market — reclaim, reconcile caps —
  always uses the truth; only the control plane is lied to).

Three independent RNG streams (plan / feed / restart) keep each fault
class reproducible in isolation: adding restarts never perturbs which
instances the next epoch's burst hits.

``RestartPolicy`` is the runtime's hardened recovery half: exponential
backoff per (region, template) crash streak plus a per-epoch restart
budget, with an availability check so replacements are never conjured
past the supply the solver saw.  A naive baseline is this policy with
everything switched off (instant unconditional restarts).

``time_to_recover`` / ``goodput_lost`` are the recovery-observability
helpers a fault study gates on.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclass
class FaultConfig:
    """Knobs for one composed fault process (all default to off)."""

    seed: int = 0
    # independent crashes: per-instance, per-epoch crash probability
    crash_rate: float = 0.0
    # correlated bursts: per-epoch probability that one (region,
    # device-family) domain bursts, losing burst_frac of its instances
    burst_rate: float = 0.0
    burst_frac: float = 0.6
    # stragglers: per-instance, per-epoch degradation probability
    straggler_rate: float = 0.0
    straggler_factor: float = 3.0
    straggler_duration_s: float = 300.0
    # flaky restarts: probability a replacement crashes again shortly
    # after becoming ready (crash-loop fuel)
    restart_flake_p: float = 0.0
    flake_after_s: float = 30.0
    # stale availability feed: observed supply lags truth by this many
    # epochs, and/or fails to refresh with this probability
    feed_lag_epochs: int = 0
    feed_stale_p: float = 0.0
    # fault window: crash/straggler planning fires only in epochs
    # [start_epoch, stop_epoch) — a warmed-up cluster plus a post-fault
    # tail is what makes time-to-recover measurable
    start_epoch: int = 0
    stop_epoch: int = 1_000_000_000


@dataclass(frozen=True)
class FaultEvent:
    """One planned fault: a crash or a straggler degradation."""

    t: float
    kind: str                   # "crash" | "degrade"
    inst: object                # SimInstance
    factor: float = 1.0         # degrade only
    duration_s: Optional[float] = None


def _family(inst) -> str:
    """Failure-domain device family: the template's primary config —
    instances of one GPU SKU in one region share racks/host pools."""
    counts = inst.template.counts
    return counts[0][0] if counts else "?"


class FaultInjector:
    """Deterministic fault planner.  The runtime calls, per epoch and
    in this order: ``observed_availability`` (what the solver may see)
    and ``plan_epoch`` (which instances crash/degrade when); mid-epoch
    it calls ``restart_outcome`` once per replacement it starts."""

    def __init__(self, cfg: Optional[FaultConfig] = None):
        self.cfg = cfg or FaultConfig()
        seed = self.cfg.seed
        self._rng_plan = random.Random(seed)
        self._rng_feed = random.Random(seed ^ 0x5DEECE66D)
        self._rng_restart = random.Random(seed ^ 0x9E3779B9)
        self._feed_hist: List[Dict] = []
        self._last_obs: Optional[Dict] = None
        # observability: (t, kind, instance id) of every planned fault,
        # plus an optional repro_torch.obs.TraceLog (wired by
        # ClusterRuntime.run) that receives a "fault_inject" record per
        # planned event — emitted at PLAN time, so its ``t`` is the
        # *future* injection instant
        self.events: List[Tuple[float, str, int]] = []
        self.trace = None
        self.first_fault_t: Optional[float] = None
        self._epoch = 0                 # advanced by plan_epoch

    # ------------------------------------------------------ stale feed
    def observed_availability(self, epoch: int, true_avail: Dict) -> Dict:
        """The availability map the control plane sees this epoch —
        possibly lagged or stuck.  ``true_avail`` is never mutated; the
        caller keeps using it for the physical market."""
        cfg = self.cfg
        self._feed_hist.append(dict(true_avail))
        if epoch < cfg.start_epoch \
                or (cfg.feed_lag_epochs <= 0 and cfg.feed_stale_p <= 0.0):
            self._last_obs = self._feed_hist[-1]
            return true_avail
        if cfg.feed_stale_p > 0.0 and self._last_obs is not None \
                and self._rng_feed.random() < cfg.feed_stale_p:
            obs = self._last_obs            # feed failed to refresh
        else:
            i = max(0, len(self._feed_hist) - 1 - cfg.feed_lag_epochs)
            obs = self._feed_hist[i]
        self._last_obs = obs
        return obs

    # ------------------------------------------------------- planning
    def plan_epoch(self, epoch: int, t0: float, epoch_s: float,
                   instances: Iterable) -> List[FaultEvent]:
        """This epoch's crash/degrade events over the live instances,
        sorted by time.  Crashing an already-failed instance is a no-op
        downstream, so overlapping processes compose safely."""
        cfg = self.cfg
        self._epoch = epoch     # restart_outcome gates on the window
        if not cfg.start_epoch <= epoch < cfg.stop_epoch:
            return []
        rng = self._rng_plan
        live = sorted((i for i in instances
                       if not i.dead and not i.draining and not i.failed),
                      key=lambda i: i.iid)
        out: List[FaultEvent] = []
        if cfg.crash_rate > 0.0:
            for inst in live:
                if rng.random() < cfg.crash_rate:
                    out.append(FaultEvent(t0 + rng.random() * epoch_s,
                                          "crash", inst))
        if cfg.burst_rate > 0.0 and live \
                and rng.random() < cfg.burst_rate:
            domains: Dict[Tuple[str, str], List] = {}
            for inst in live:
                domains.setdefault((inst.region, _family(inst)),
                                   []).append(inst)
            dom = sorted(domains)[rng.randrange(len(domains))]
            members = domains[dom]
            k = max(1, int(round(cfg.burst_frac * len(members))))
            t = t0 + rng.random() * epoch_s
            for inst in rng.sample(members, k):
                out.append(FaultEvent(t, "crash", inst))
        if cfg.straggler_rate > 0.0:
            for inst in live:
                if rng.random() < cfg.straggler_rate:
                    out.append(FaultEvent(
                        t0 + rng.random() * epoch_s, "degrade", inst,
                        factor=cfg.straggler_factor,
                        duration_s=cfg.straggler_duration_s))
        out.sort(key=lambda f: (f.t, f.inst.iid, f.kind))
        for f in out:
            self.events.append((f.t, f.kind, f.inst.iid))
            if self.trace is not None:
                self.trace.emit("fault_inject", f.t, epoch,
                                fault=f.kind, iid=f.inst.iid)
            if self.first_fault_t is None:
                self.first_fault_t = f.t
        return out

    # ------------------------------------------------------- restarts
    def restart_outcome(self) -> Optional[float]:
        """Flaky-restart draw for one replacement: ``None`` when it
        comes up healthy, else the post-ready delay after which it
        crashes again.  Gated on the fault window: flaky restarts model
        a correlated cause (bad image, failing rack) that clears when
        the fault process stops, so once the window closes the tail
        measures recovery discipline — not an unbounded crash loop
        that no discipline could ever win."""
        cfg = self.cfg
        if not cfg.start_epoch <= self._epoch < cfg.stop_epoch:
            return None
        if cfg.restart_flake_p > 0.0 \
                and self._rng_restart.random() < cfg.restart_flake_p:
            return cfg.flake_after_s * (0.5 + self._rng_restart.random())
        return None


class RestartPolicy:
    """Failure-domain-aware restart discipline for ``ClusterRuntime``.

    Each detected failure asks the policy for permission (per-epoch
    ``budget`` of restarts) and a delay (exponential backoff
    ``backoff_base_s * backoff_mult**streak`` capped at
    ``backoff_max_s``, streak counted per (region, template) and reset
    at any epoch edge where that domain suffered no failure).  With
    ``check_availability`` the replacement is also bounded by the
    availability the solver saw — capacity that is gone cannot be
    conjured back.  The defaults (no backoff, effectively unlimited
    budget, availability check on) reproduce the seed's immediate
    restart, minus its conjuring bug.
    """

    def __init__(self, backoff_base_s: float = 0.0,
                 backoff_mult: float = 2.0,
                 backoff_max_s: float = 600.0,
                 budget_per_epoch: int = 1_000_000,
                 check_availability: bool = True):
        self.backoff_base_s = backoff_base_s
        self.backoff_mult = backoff_mult
        self.backoff_max_s = backoff_max_s
        self.budget_per_epoch = budget_per_epoch
        self.check_availability = check_availability
        self._streak: Dict[Tuple, int] = {}
        self._used = 0

    def begin_epoch(self, failed_keys: Sequence[Tuple] = ()):
        """Epoch edge: refill the budget; domains with no failure last
        epoch forget their crash streak (they proved stable)."""
        self._used = 0
        failed = set(failed_keys)
        for k in [k for k in self._streak if k not in failed]:
            del self._streak[k]

    def allow(self) -> bool:
        """Consume one unit of this epoch's restart budget."""
        if self._used >= self.budget_per_epoch:
            return False
        self._used += 1
        return True

    def delay(self, key: Tuple) -> float:
        """Backoff before restarting ``key``'s next replacement."""
        if self.backoff_base_s <= 0.0:
            return 0.0
        s = self._streak.get(key, 0)
        return min(self.backoff_base_s * (self.backoff_mult ** s),
                   self.backoff_max_s)

    def note_restart(self, key: Tuple):
        self._streak[key] = self._streak.get(key, 0) + 1


# ------------------------------------------------------ recovery metrics
def time_to_recover(times: Sequence[float], values: Sequence[float],
                    t_fault: float, threshold: float,
                    sustain: int = 1) -> float:
    """Seconds from ``t_fault`` until *sustained* recovery.

    The outage opens at the first sample at/after ``t_fault`` below
    ``threshold`` (a fault's dip usually starts after the fault
    instant — detection lag, queues draining — so naive first-crossing
    semantics would declare recovery on a pre-dip sample).  Recovery is
    the start of the first run of ``sustain`` consecutive samples at or
    above ``threshold`` after the onset; a terminal all-good run
    shorter than ``sustain`` (the series ended while still recovered)
    also counts, so the metric composes with bounded runs.  Later
    isolated noise dips do not re-open the fault's outage — they are
    the service's ambient variance, not the fault.  ``0`` when coverage
    never dips; ``inf`` when the series ends still below threshold."""
    pts = [(t, v) for t, v in zip(times, values) if t >= t_fault]
    onset = next((i for i, (_t, v) in enumerate(pts) if v < threshold),
                 None)
    if onset is None:
        return 0.0
    run = 0
    for i in range(onset + 1, len(pts)):
        run = run + 1 if pts[i][1] >= threshold else 0
        if run == sustain or (run > 0 and i == len(pts) - 1):
            return pts[i - run + 1][0] - t_fault
    return float("inf")


def goodput_lost(times: Sequence[float], values: Sequence[float],
                 baseline: float, t_fault: float,
                 epoch_s: float) -> float:
    """Integrated shortfall below ``baseline`` (goodput tokens, i.e.
    coverage-points x seconds) over the epochs at or after the fault."""
    return sum((baseline - v) * epoch_s
               for t, v in zip(times, values)
               if t >= t_fault and v < baseline)
