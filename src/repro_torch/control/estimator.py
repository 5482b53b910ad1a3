"""Online demand estimation (paper §5, Mélange §3: the request rate and
size mix drive the cost-optimal GPU mix, so demand must be *measured*).

``DemandEstimator`` converts the simulator's observables — the windowed
request-arrival stream (count + prompt tokens; prompt lengths are
visible at arrival), the finished-request output lengths, and the pool
queue snapshots — into the per-(model, phase) ``Demand`` rows the
allocator consumes, replacing the oracle ``demands_per_epoch`` input of
``ClusterRuntime.run``.

Per model the estimator keeps:

* a sliding window of per-sub-window arrival *rates* (req/s), sampled
  ``window_s`` apart so the quantile headroom sees burst structure
  inside an epoch, not just epoch means;
* an EWMA *level* and an EWMA *trend* (req/s per second) over those
  samples — the point forecast is ``level + trend * horizon``;
* a configurable *quantile headroom*: the estimate never falls below
  the ``headroom_q`` quantile of the recent window rates, so goodput
  targets survive bursts (monotone in ``headroom_q``, tested);
* EWMA estimates of the request *shape* (prompt tokens from arrivals,
  output tokens from finished requests; priors come from the offline
  ``WorkloadStats``);
* queued-backlog correction: standing queue tokens are spread over
  ``backlog_drain_s`` and added to demand, so accumulated shortfall is
  drained instead of ignored.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.allocator import Demand
from repro_torch.debug import invariants as _inv


@dataclass
class EstimatorConfig:
    window_s: float = 60.0          # sub-epoch sampling window
    n_windows: int = 6              # sliding rate-sample history (short:
    #                                 it must forget a spike within ~1.5
    #                                 epochs or the headroom quantile
    #                                 pins demand at the spike level)
    level_alpha: float = 0.35       # EWMA weight of a new rate sample
    trend_alpha: float = 0.2        # EWMA weight of the level delta
    shape_alpha: float = 0.15       # EWMA weight of prompt/output means
    headroom_q: float = 0.7         # burst-headroom quantile over history
    backlog_drain_s: float = 360.0  # horizon to drain standing queues
    prior_rate: float = 1.0         # req/s per model before any sample
    min_rate: float = 0.05          # floor: never estimate a dead model


class _ModelState:
    __slots__ = ("rates", "level", "trend", "prompt_mean", "out_mean",
                 "pre_backlog", "dec_backlog")

    def __init__(self, n_windows: int, prompt_mean: float, out_mean: float):
        self.rates: deque = deque(maxlen=n_windows)
        self.level: Optional[float] = None
        self.trend = 0.0
        self.prompt_mean = float(prompt_mean)
        self.out_mean = float(out_mean)
        self.pre_backlog = 0.0
        self.dec_backlog = 0.0


class DemandEstimator:
    """Online per-(model, phase) demand estimator.

    Drive it with ``observe(sim, t0, t1)`` after each simulated epoch
    and read ``estimate(horizon_s)`` before the next allocator solve.
    ``ingest_window`` is the low-level feed (used by ``observe`` and by
    tests).  The emitted ``Demand`` list has a stable (model, phase)
    order across calls, so a persistent ``AllocatorState`` never
    rebuilds its structure between epochs.
    """

    def __init__(self, models: Sequence[str], workloads: Dict,
                 cfg: Optional[EstimatorConfig] = None):
        self.cfg = cfg or EstimatorConfig()
        self._names = list(models)
        self._st: Dict[str, _ModelState] = {
            m: _ModelState(self.cfg.n_windows, workloads[m].avg_prompt,
                           workloads[m].avg_output)
            for m in self._names}
        self._fin_cursor = 0

    # ------------------------------------------------------------- feed
    def ingest_window(self, model: str, dt: float, n_req: int,
                      prompt_tokens: float = 0.0):
        """One observation window: ``n_req`` arrivals carrying
        ``prompt_tokens`` over ``dt`` seconds."""
        st = self._st[model]
        cfg = self.cfg
        rate = n_req / max(dt, 1e-9)
        st.rates.append(rate)
        if st.level is None:
            st.level = rate
        else:
            prev = st.level
            st.level = (1 - cfg.level_alpha) * st.level \
                + cfg.level_alpha * rate
            st.trend = (1 - cfg.trend_alpha) * st.trend \
                + cfg.trend_alpha * (st.level - prev) / max(dt, 1e-9)
        if n_req > 0:
            st.prompt_mean = (1 - cfg.shape_alpha) * st.prompt_mean \
                + cfg.shape_alpha * (prompt_tokens / n_req)

    def observe(self, sim, t0: float, t1: float):
        """Fold one epoch of simulator observables into the estimate:
        sub-window arrival rates, finished-request output lengths, and
        the standing queue backlogs at ``t1``."""
        cfg = self.cfg
        nw = max(1, int(round((t1 - t0) / cfg.window_s)))
        edges = np.linspace(t0, t1, nw + 1)
        for m in self._names:
            ob = sim.obs[m]
            st = self._st[m]
            for w0, w1 in zip(edges[:-1], edges[1:]):
                n, p, _o = ob.arrival.window(float(w0), float(w1))
                self.ingest_window(m, float(w1 - w0), n, p)
            nq_p, ptok = sim.pool_backlog(m, "prefill")
            nq_d, _ = sim.pool_backlog(m, "decode")
            st.pre_backlog = float(ptok)
            st.dec_backlog = nq_d * st.out_mean
        fin = sim.finished
        for r in fin[self._fin_cursor:]:
            st = self._st.get(r.model)
            if st is not None:
                st.out_mean = (1 - cfg.shape_alpha) * st.out_mean \
                    + cfg.shape_alpha * r.output_len
        self._fin_cursor = len(fin)

    # --------------------------------------------------------- estimate
    def rate(self, model: str, horizon_s: float = 0.0,
             q: Optional[float] = None) -> float:
        """Request-rate estimate ``horizon_s`` ahead: the max of the
        trend-extrapolated EWMA level and the ``q`` quantile of the
        recent window rates (burst headroom; monotone in ``q``)."""
        st = self._st[model]
        cfg = self.cfg
        if st.level is None:
            return max(cfg.prior_rate, cfg.min_rate)
        base = max(st.level + st.trend * horizon_s, 0.0)
        head = 0.0
        if st.rates:
            head = float(np.quantile(np.asarray(st.rates),
                                     cfg.headroom_q if q is None else q))
        return max(base, head, cfg.min_rate)

    def estimate(self, horizon_s: float = 0.0) -> List[Demand]:
        """Per-(model, phase) token demand for the next interval."""
        drain = max(self.cfg.backlog_drain_s, 1.0)
        out: List[Demand] = []
        for m in self._names:
            st = self._st[m]
            r = self.rate(m, horizon_s)
            out.append(Demand(m, "prefill",
                              r * st.prompt_mean + st.pre_backlog / drain))
            out.append(Demand(m, "decode",
                              r * st.out_mean + st.dec_backlog / drain))
        if _inv.sanitize_enabled():
            _inv.check_demands(out)
        return out
