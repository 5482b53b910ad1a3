"""Named, seeded control-plane scenarios (paper §6.4 "shifting
throughput demand and resource availability").

Each generator produces a ``Scenario`` triple — the request trace, the
per-epoch availability series, and the *truth* per-epoch demands (what
an oracle controller would feed the allocator) — plus the underlying
per-model rate schedule for reference.  Estimator-driven runs ignore
the truth demands; oracle runs consume them; both replay the identical
seeded request/availability streams, so the benchmark's comparison is
apples-to-apples.

Availability semantics: demand-side scenarios (``diurnal``,
``flash_crowd``, ``popularity_shift``) use the default bounded
availability walk with the repo's usual "we keep what we hold" reading
(the series is *free market supply on top of held nodes*).  Supply-side
scenarios (``spot_preemption``, ``region_outage``) set
``spot_market=True``: the series is the *total* reclaimable supply per
(region, config), and ``ClusterRuntime`` preempts held instances that
no longer fit (ShuntServe's stress case).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.control.faults import FaultConfig
from repro_torch.core.allocator import Demand
from repro_torch.traces.workloads import (Request, default_base_availability,
                                    gen_availability, gen_requests_schedule)

SCENARIO_NAMES = ("diurnal", "flash_crowd", "popularity_shift",
                  "spot_preemption", "region_outage")

# fault-injection scenarios: flat demand, the fault
# process is the stressor.  Kept out of SCENARIO_NAMES — they need a
# FaultInjector wired into ClusterRuntime.run to mean anything, and
# their runs are judged on time-to-recover, not on the
# estimated-vs-oracle parities of the closed-loop scenarios.
FAULT_SCENARIO_NAMES = ("crash_storm", "straggler", "crash_loop",
                        "stale_feed")


@dataclass
class Scenario:
    name: str
    n_epochs: int
    epoch_s: float
    requests: List[Request]
    availability: List[Dict[Tuple[str, str], int]]
    truth_demands: List[List[Demand]]
    rates: Dict[str, List[float]]           # req/s per model per epoch
    spot_market: bool = False               # availability = total supply
    meta: Dict = field(default_factory=dict)
    # fault-process knobs for a FaultInjector (None = fault-free);
    # every run of the scenario should build its own injector from
    # this so hardened/naive comparisons replay identical faults
    faults: "FaultConfig" = None


# ------------------------------------------------------ rate schedules
def _rate_schedules(name: str, models: Sequence[str], n_epochs: int,
                    base_rate: float, rng: np.random.Generator
                    ) -> Tuple[Dict[str, List[float]], Dict]:
    names = sorted(models)
    rates = {m: [base_rate] * n_epochs for m in names}
    meta: Dict = {}
    if name == "diurnal":
        # one "day" per run, per-model phase offsets (peaks disagree)
        for i, m in enumerate(names):
            phase = i / max(len(names), 1)
            rates[m] = [base_rate * (0.55 + 0.45 * np.sin(
                2 * np.pi * (e / n_epochs + phase)))
                for e in range(n_epochs)]
    elif name == "flash_crowd":
        # one model's traffic ramps x4 over an epoch, holds, ramps back
        # (real flash crowds build over minutes — a step would be
        # unreactable at epoch granularity for *any* online controller)
        target = names[0]
        peak = 4.0
        s = max(n_epochs // 3, 1)
        hold = range(s + 1, min(s + 1 + max(n_epochs // 4, 2), n_epochs))
        mult = [1.0] * n_epochs
        if s < n_epochs:
            mult[s] = (1.0 + peak) / 2.0            # ramp up
        for e in hold:
            mult[e] = peak
        if hold and hold[-1] + 1 < n_epochs:
            mult[hold[-1] + 1] = (1.0 + peak) / 2.0  # ramp down
        rates[target] = [base_rate * m for m in mult]
        meta = {"target": target, "hot_epochs": [s] + list(hold)}
    elif name == "popularity_shift":
        # traffic migrates from the first model to the last over the run
        src, dst = names[0], names[-1]
        for e in range(n_epochs):
            w = min(max((e - n_epochs / 4) / (n_epochs / 2), 0.0), 1.0)
            rates[src][e] = base_rate * (1.6 - 1.2 * w)
            rates[dst][e] = base_rate * (0.4 + 1.2 * w)
        meta = {"src": src, "dst": dst}
    elif name in ("spot_preemption", "region_outage") \
            or name in FAULT_SCENARIO_NAMES:
        pass                # supply/fault-side: rates stay flat
    else:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"choose from {SCENARIO_NAMES + FAULT_SCENARIO_NAMES}")
    return rates, meta


# --------------------------------------------------- availability paths
def _flat_supply(regions, configs, base: Dict[str, int]
                 ) -> Dict[Tuple[str, str], int]:
    return {(r.name, c.name): base.get(c.name, 0)
            for r in regions for c in configs}


def _storm_availability(regions, configs, n_epochs: int,
                        base: Dict[str, int], rng: np.random.Generator,
                        p_storm: float = 0.15,
                        depth: Tuple[float, float] = (0.0, 0.05),
                        length: Tuple[int, int] = (1, 2)):
    """Spot-preemption storms: per (region, device family), supply of
    every config of that family collapses to ``depth`` of its base for
    ``length`` epochs, then recovers.  Preemptions correlate per
    instance family in real clouds (a capacity crunch on H100s hits
    1x/2x/4x/8x alike), and family-wide storms guarantee the scenario
    stresses whichever configs the allocator actually holds.  Every
    family is hit at least once mid-run (a quiet roll injects one), so
    the scenario never degenerates into a flat-supply run."""
    flat = _flat_supply(regions, configs, base)
    out = [dict(flat) for _ in range(n_epochs)]
    storms = []
    families = sorted({(r.name, c.device.name) for r in regions
                       for c in configs})
    cfg_of = {d: [c.name for c in configs if c.device.name == d]
              for d in sorted({c.device.name for c in configs})}

    def _apply(rname, dev, e):
        d = rng.uniform(*depth)
        ln = int(rng.integers(length[0], length[1] + 1))
        for j in range(e, min(e + ln, n_epochs)):
            for cname in cfg_of[dev]:
                k = (rname, cname)
                out[j][k] = int(round(flat[k] * d))
        storms.append({"region": rname, "device": dev, "epoch": e,
                       "len": ln, "depth": round(float(d), 3)})
        return ln

    for rname, dev in families:
        e = 0
        hit = False
        while e < n_epochs:
            if rng.random() < p_storm:
                e += _apply(rname, dev, e) + 1  # family storms don't
                hit = True                      # overlap themselves
            else:
                e += 1
        if not hit and n_epochs >= 3:
            lo, hi = n_epochs // 3, max(2 * n_epochs // 3, n_epochs // 3 + 1)
            _apply(rname, dev, int(rng.integers(lo, hi)))
    return out, storms


def _outage_availability(regions, configs, n_epochs: int,
                         base: Dict[str, int]):
    """The *primary* region (cheapest mean price multiplier — where the
    allocator concentrates capacity) loses all supply mid-run."""
    flat = _flat_supply(regions, configs, base)
    out = [dict(flat) for _ in range(n_epochs)]
    devices = sorted({c.device.name for c in configs})
    victim = min(sorted(regions, key=lambda r: r.name),
                 key=lambda r: sum(r.price_mult.get(d, 1.0)
                                   for d in devices)).name
    start = n_epochs // 2
    down = list(range(start, min(start + max(n_epochs // 4, 1), n_epochs)))
    for e in down:
        for c in configs:
            out[e][(victim, c.name)] = 0
    return out, {"region": victim, "down_epochs": down}


# ------------------------------------------------------ fault processes
def _fault_config(name: str, n_epochs: int, epoch_s: float,
                  seed: int) -> FaultConfig:
    """The fault process behind each FAULT_SCENARIO_NAMES entry.  The
    fault window opens after a warm-up third of the run and (except
    for the stale feed, which lies for the whole run) closes again so
    the tail measures recovery, not steady-state attrition."""
    start = max(n_epochs // 3, 1)
    # stable full-name hash: len(name) collided for same-length
    # scenario names (crash_loop/stale_feed), giving them identical
    # fault-plan RNG streams; the "fault:" prefix keeps this stream
    # distinct from make_scenario's workload rng for the same name
    fseed = seed * 7919 + zlib.crc32(f"fault:{name}".encode())
    if name == "crash_storm":
        # one correlated (region, device-family) burst, plus light
        # independent attrition while the window is open
        return FaultConfig(seed=fseed, burst_rate=1.0, burst_frac=0.7,
                           crash_rate=0.05, start_epoch=start,
                           stop_epoch=start + 1)
    if name == "straggler":
        return FaultConfig(seed=fseed, straggler_rate=0.3,
                           straggler_factor=4.0,
                           straggler_duration_s=2.0 * epoch_s,
                           start_epoch=start, stop_epoch=start + 2)
    if name == "crash_loop":
        # heavy crashes whose replacements usually die again — restart
        # discipline fuel (a light rate never dents coverage on a
        # provisioned-with-headroom cluster, so the TTR gate would
        # measure nothing)
        return FaultConfig(seed=fseed, crash_rate=0.5,
                           restart_flake_p=0.7, flake_after_s=20.0,
                           start_epoch=start, stop_epoch=start + 3)
    if name == "stale_feed":
        return FaultConfig(seed=fseed, feed_lag_epochs=2,
                           feed_stale_p=0.3, start_epoch=1)
    raise ValueError(f"unknown fault scenario {name!r}; "
                     f"choose from {FAULT_SCENARIO_NAMES}")


# -------------------------------------------------------------- builder
def make_scenario(name: str, models: Dict, regions: Sequence,
                  configs: Sequence, workloads: Dict, *,
                  n_epochs: int = 12, epoch_s: float = 240.0,
                  base_rate: float = 2.0, abundance: float = 24.0,
                  seed: int = 0) -> Scenario:
    """Build one named scenario over the given (models, regions,
    configs) universe.  Deterministic in ``seed``."""
    # stable full-name hash: the old len(name) term seeded same-length
    # scenario names (flash_crowd/crash_storm) with identical streams
    rng = np.random.default_rng(seed * 7919 + zlib.crc32(name.encode()))
    rates, meta = _rate_schedules(name, list(models), n_epochs,
                                  base_rate, rng)
    base = default_base_availability(configs, abundance=abundance)
    # the stale-feed scenario only bites when supply actually moves
    # under the lying feed: run it on the spot-preemption storm market
    spot = name in ("spot_preemption", "region_outage", "stale_feed")
    faults = None
    if name in FAULT_SCENARIO_NAMES:
        faults = _fault_config(name, n_epochs, epoch_s, seed)
        meta = {"faults": name, "start_epoch": faults.start_epoch,
                "stop_epoch": faults.stop_epoch}
    if name in ("spot_preemption", "stale_feed"):
        avail, storms = _storm_availability(regions, configs, n_epochs,
                                            base, rng)
        meta["storms"] = storms
    elif name == "region_outage":
        avail, meta = _outage_availability(regions, configs, n_epochs, base)
    else:
        avail = gen_availability(regions, configs, n_epochs, base,
                                 seed=seed * 13 + 1)

    reqs: List[Request] = []
    for i, m in enumerate(sorted(models)):
        reqs += gen_requests_schedule(
            m, models[m].trace, rates[m], epoch_s,
            seed=seed * 101 + i * 17 + 3, rid0=i * 100_000_000)
    reqs.sort(key=lambda r: r.arrival)

    truth = []
    for e in range(n_epochs):
        row = []
        for m in sorted(models):
            wl = workloads[m]
            r = rates[m][e]
            row.append(Demand(m, "prefill", r * wl.avg_prompt))
            row.append(Demand(m, "decode", r * wl.avg_output))
        truth.append(row)
    return Scenario(name, n_epochs, epoch_s, reqs, avail, truth, rates,
                    spot_market=spot, meta=meta, faults=faults)
