"""Adaptive control plane (paper §5): closes the loop between the
simulator's observables and the online allocator.

* ``estimator`` — online per-(model, phase) demand estimation from the
  observed arrival / queue / token streams (no oracle demands).
* ``controller`` — churn-aware re-solve policy: demand-drift and
  availability-delta triggers with hysteresis + cooldown over a fixed
  cadence fallback, plus a transition planner that feeds the allocator
  the cheapest-to-reach incumbent.
* ``scenarios`` — named, seeded scenario generators (diurnal demand,
  flash crowd, popularity shift, spot-preemption storms, region
  outage), each producing (requests, availability, truth-demand).
* ``faults`` — seeded fault injection (independent crashes, correlated
  per-(region, device-family) bursts, stragglers, flaky restarts,
  stale availability feeds) plus the hardened ``RestartPolicy`` and
  the time-to-recover / goodput-lost recovery metrics.

All of it is host Python with the reference's generators
(``random.Random``, numpy's ``default_rng``), so one seed replays the
reference's scenario and fault streams draw for draw.
"""
from repro_torch.control.controller import (ControllerConfig,
                                            ReSolveController,
                                            ResolveDecision,
                                            TransitionPlanner)
from repro_torch.control.estimator import DemandEstimator, EstimatorConfig
from repro_torch.control.faults import (FaultConfig, FaultEvent,
                                        FaultInjector, RestartPolicy,
                                        goodput_lost, time_to_recover)
from repro_torch.control.scenarios import (FAULT_SCENARIO_NAMES,
                                           SCENARIO_NAMES, Scenario,
                                           make_scenario)

__all__ = [
    "ControllerConfig", "DemandEstimator", "EstimatorConfig",
    "FAULT_SCENARIO_NAMES", "FaultConfig", "FaultEvent", "FaultInjector",
    "ReSolveController", "ResolveDecision", "RestartPolicy",
    "SCENARIO_NAMES", "Scenario", "TransitionPlanner", "goodput_lost",
    "make_scenario", "time_to_recover",
]
