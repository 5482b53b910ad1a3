"""Synthetic request/availability traces.

Request traces mimic the three public datasets the paper evaluates on
(§6.1): Azure Code (long prompts, short outputs), Azure Conversation
(medium prompts, long outputs), BurstGPT (bursty gamma arrivals).
Availability follows an Alibaba-style bounded random walk per
(region, config). All generators are seeded and deterministic.

A trace is data, not a library-sized computation: it stays numpy on the
host, drawn from ``np.random.default_rng(seed)`` in the reference's order,
so one seed gives the reference's requests and availability draw for
draw. Nothing here runs on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.hardware import NodeConfig, Region
from repro_torch.core.profiles import WorkloadStats


@dataclass(frozen=True)
class TraceSpec:
    name: str
    prompt_mean: float
    prompt_cv: float
    output_mean: float
    output_cv: float
    burstiness: float      # CV of inter-arrival times (1 = Poisson)


TRACES: Dict[str, TraceSpec] = {
    "azure_code": TraceSpec("azure_code", 2048, 0.9, 36, 0.8, 1.0),
    "azure_conv": TraceSpec("azure_conv", 1024, 1.1, 240, 0.9, 1.0),
    "burstgpt": TraceSpec("burstgpt", 620, 1.0, 250, 0.9, 2.2),
}


def workload_stats(trace: str) -> WorkloadStats:
    t = TRACES[trace]
    return WorkloadStats(avg_prompt=t.prompt_mean, avg_output=t.output_mean)


@dataclass
class Request:
    rid: int
    model: str
    arrival: float
    prompt_len: int
    output_len: int
    # filled by the runtime/simulator:
    prefill_done: float = -1.0
    finish: float = -1.0
    decode_slo_ok: int = 0
    decode_tokens_ok: int = 0


def _lognormal(rng, mean, cv, size):
    sigma2 = np.log(1 + cv * cv)
    mu = np.log(mean) - sigma2 / 2
    return np.exp(rng.normal(mu, np.sqrt(sigma2), size))


def gen_requests(model: str, trace: str, rate: float, duration: float,
                 seed: int, rid0: int = 0) -> List[Request]:
    """Poisson/gamma arrival process at ``rate`` req/s for ``duration`` s."""
    t = TRACES[trace]
    if rate <= 0.0 or duration <= 0.0:
        return []
    rng = np.random.default_rng(seed)
    n = int(rate * duration * 1.5) + 16
    shape = 1.0 / (t.burstiness ** 2)
    scale = 1.0 / (rate * shape)
    gaps = rng.gamma(shape, scale, n)
    arr = np.cumsum(gaps)
    # bursty traces (CV > 1) can draw a gap sample whose sum falls short
    # of ``duration`` — the old fixed 1.5x buffer then silently ended
    # the trace early.  Extend the renewal process until it passes the
    # horizon, so the filter below always trims, never truncates.
    while arr[-1] < duration:
        more = rng.gamma(shape, scale, max(n // 2, 16))
        arr = np.concatenate([arr, arr[-1] + np.cumsum(more)])
    arr = arr[arr < duration]
    prompts = np.maximum(_lognormal(rng, t.prompt_mean, t.prompt_cv,
                                    len(arr)).astype(int), 8)
    outs = np.maximum(_lognormal(rng, t.output_mean, t.output_cv,
                                 len(arr)).astype(int), 4)
    return [Request(rid0 + i, model, float(a), int(p), int(o))
            for i, (a, p, o) in enumerate(zip(arr, prompts, outs))]


def gen_availability(regions: Sequence[Region], configs: Sequence[NodeConfig],
                     n_epochs: int, base: Dict[str, int], seed: int,
                     scarcity: Dict[str, float] | None = None
                     ) -> List[Dict[Tuple[str, str], int]]:
    """Alibaba-style availability walk: per (region, config), a bounded
    random walk around ``base[config]`` x regional factor, optionally
    scaled down per device type (``scarcity``, e.g. H100 constrained).

    The walk is bounded relative to the per-(region, config) *base*
    level: multiplicative steps are clipped to ``[0, 4 x base]``.  (The
    old code recomputed the ceiling from the current level each epoch,
    so the "bound" drifted with the walk and long horizons could grow
    without limit.)
    """
    rng = np.random.default_rng(seed)
    scarcity = scarcity or {}
    out = []
    level = {}
    bound = {}
    for r in regions:
        for c in configs:
            b = base.get(c.name, 0) * scarcity.get(c.device.name, 1.0)
            level[(r.name, c.name)] = b * rng.uniform(0.85, 1.15)
            bound[(r.name, c.name)] = 4.0 * max(b, 1.0)
    for _ in range(n_epochs):
        epoch = {}
        for k in level:
            level[k] = np.clip(level[k] * rng.uniform(0.88, 1.12),
                               0.0, bound[k])
            epoch[k] = int(round(level[k]))
        out.append(epoch)
    return out


def gen_requests_schedule(model: str, trace: str, rates: Sequence[float],
                          epoch_s: float, seed: int, rid0: int = 0,
                          rid_stride: int = 100_000) -> List[Request]:
    """Piecewise-constant rate schedule: one ``gen_requests`` stretch per
    epoch (rate ``rates[e]`` over ``[e*epoch_s, (e+1)*epoch_s)``), with
    per-epoch seeds so a scenario's epochs are individually
    reproducible.  Used by the control-plane scenario generators."""
    reqs: List[Request] = []
    for e, r in enumerate(rates):
        if r <= 1e-12:
            continue
        part = gen_requests(model, trace, float(r), epoch_s,
                            seed=seed * 1009 + e, rid0=rid0 + e * rid_stride)
        for q in part:
            q.arrival += e * epoch_s
        reqs += part
    return reqs


def default_base_availability(configs: Sequence[NodeConfig],
                              abundance: float = 8.0) -> Dict[str, int]:
    """Baseline node counts per config; top-tier GPUs are supply-constrained
    (paper §1: 'often supply-constrained')."""
    scarce = {"H100": 0.35, "A100": 0.6}
    out = {}
    for c in configs:
        per = abundance * scarce.get(c.device.name, 1.0)
        out[c.name] = max(int(round(per / max(c.n_devices // 2, 1))), 1)
    return out
