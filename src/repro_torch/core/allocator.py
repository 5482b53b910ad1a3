"""Online resource allocation ILP (paper §4.3) — columnar pipeline.

Decision vars: integer v_r(tau) = #Serving Instances of template tau in
region r; continuous I_r(tau) >= (v - v')·p_r(tau)·K models the
initialization penalty charged only on newly added instances.
Constraints: per-(region, config) availability; per-(model, phase)
throughput demand. Objective: provisioning cost + init penalty
(+ big-M shortfall slack so scarce-availability instances always return
a best-effort allocation instead of INFEASIBLE — mirroring §6.4 where
methods are compared by how much demand they actually satisfy).

Two assembly paths build the same model:

* ``allocate_reference`` — the seed per-var path (one ``add_var`` /
  ``add_constr`` Python call per (region, template) pair).  Kept as the
  equivalence oracle; at 20-config/6-model scale its *build* time
  dominates the HiGHS solve.
* ``AllocatorState`` (and the ``allocate`` convenience wrapper) — the
  columnar path.  Template sets are consumed as ``LibraryColumns``
  tensors (usage matrix, throughput vector, per-region cost from one
  ``usage @ price.T`` matmul); the Pareto/var-cap selection, shortfall
  penalties and per-var bounds are vectorized; and the whole constraint
  matrix is assembled once as COO triplets fed straight into
  ``scipy.sparse``/HiGHS via ``MilpModel.add_vars`` /
  ``add_constrs_coo``.

Where it runs: the columns (``LibraryColumns`` on the library's device),
the per-region costs, the Pareto/var-cap selection, the shortfall
penalties, the variable costs, the COO pattern and the per-epoch
availability caps are tensors on the library's device. The solves run on
the host: HiGHS, the decomposed tier's ``cover_bb`` and the greedy
repairs (``_incumbent``, ``_round_lp``) take host copies, made at two
named crossings (``to_host``): once per build for the static structure,
once per solve for the epoch's caps. ``Allocation.device_seconds`` is the
device part of a solve; ``build_seconds`` holds it and the host assembly.

``AllocatorState`` persists *across epochs*: the assembled structure
(variable layout, COO pattern, selection) is reused, and each re-solve
only rewrites availability bounds, demand right-hand sides and
``current`` counts.  The previous epoch's solution — clamped to the new
availability and greedily repaired to feasibility — seeds the solve as
an *incumbent*: its objective value is a valid upper bound, so
``v <= floor(z_inc / price)`` prunes dominated variables and
``s <= z_inc / penalty`` tightens the shortfall big-M before HiGHS
runs; if the solver fails or times out, the incumbent is returned as a
best-effort fallback (``Allocation.fallback``) instead of draining the
cluster.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hardware import NodeConfig, Region
from repro_torch.core.placement import _stable_argsort
from repro_torch.core.profiles import exact_div
from repro_torch.core.templates import (LibraryColumns, ServingTemplate,
                                        TemplateLibrary)
from repro_torch.debug import invariants as _inv
from repro_torch.solver import decompose as _dec
from repro_torch.solver.milp import MilpModel, to_host

MIP_GAP = 1e-4
# acceptance gap of the fast tiers (decomposed / rounded-LP): a tier's
# solution is only returned when its objective provably sits within
# this relative gap of a valid lower bound on the monolithic optimum —
# otherwise the solve escalates (the "lossless escape hatch")
ACCEPT_GAP = 5e-4


@dataclass(frozen=True)
class Demand:
    model: str
    phase: str
    tokens_per_s: float


@dataclass
class AllocProblem:
    regions: Sequence[Region]
    configs: Sequence[NodeConfig]
    availability: Dict[Tuple[str, str], int]      # (region, config) -> nodes
    demands: Sequence[Demand]
    library: TemplateLibrary
    current: Dict[Tuple[str, Tuple], int] = field(default_factory=dict)
    init_penalty_k: float = 0.1                    # K (init time / interval)
    time_limit: float = 60.0
    max_templates_per_demand: int = 1200           # solver-scaling knob
    # solve-path selector: "auto" runs the three-tier ladder
    # (decomposed -> rounded LP -> monolithic MIP, escalating only when
    # a tier cannot certify its objective within ACCEPT_GAP); the other
    # values force a single tier (benchmarks, tests, A/B comparisons)
    solve_mode: str = "auto"       # auto|decomposed|rounded_lp|monolithic


@dataclass
class Allocation:
    instances: Dict[Tuple[str, Tuple], int]        # (region, template.key) -> n
    templates: Dict[Tuple, ServingTemplate]        # template.key -> template
    cost_per_hour: float
    init_penalty: float
    unmet: Dict[Tuple[str, str], float]            # (model, phase) -> tok/s
    solve_seconds: float
    n_vars: int
    ok: bool
    objective: float = np.nan                      # full MILP objective
    build_seconds: float = 0.0                     # model assembly (excl. solve)
    fallback: bool = False                         # incumbent returned on failure
    solve_path: str = "monolithic"                 # tier that produced it
    solver_seconds: float = 0.0                    # pure solver time
    extract_seconds: float = 0.0                   # solution extraction
    device_seconds: float = 0.0                    # device part of build_seconds

    @property
    def total_nodes(self) -> int:
        return sum(self.templates[k].n_nodes * n
                   for (_, k), n in self.instances.items())

    def served(self, model: str, phase: str) -> float:
        return sum(self.templates[k].throughput * n
                   for (_, k), n in self.instances.items()
                   if k[0] == model and k[1] == phase)


# --------------------------------------------------------------- selection
def select_template_indices(cost: torch.Tensor, thr: torch.Tensor,
                            cap: int) -> torch.Tensor:
    """Vectorized var-count cap: 2-D (cost, throughput) Pareto frontier
    first — the solver needs cheap low-throughput templates to match
    demand tightly, not just the best $/tok/s — then fill by
    cost-efficiency.  ``cost`` is the (T, R) per-region cost matrix,
    ``thr`` the (T,) throughput vector; returns kept indices (on their
    device)."""
    n = thr.shape[0]
    if n <= cap:
        return torch.arange(n, device=thr.device)
    mincost = cost.amin(dim=1)
    # stable sort by (mincost, -throughput) — two stable sorts, the minor
    # key first — then a running-max scan: a template is on the frontier
    # iff it is strictly faster than every cheaper-or-equal one before it
    by_thr = _stable_argsort(-thr)
    order = by_thr[_stable_argsort(mincost[by_thr])]
    thr_sorted = thr[order]
    prev_max = torch.cat([thr_sorted.new_full((1,), -np.inf),
                          torch.cummax(thr_sorted, dim=0).values[:-1]])
    frontier = order[thr_sorted > prev_max]
    chosen = frontier[:cap]
    if chosen.shape[0] < cap:
        picked = torch.zeros(n, dtype=torch.bool, device=thr.device)
        picked[chosen] = True
        eff_order = _stable_argsort(mincost / torch.clamp_min(thr, 1e-9))
        fill = eff_order[~picked[eff_order]][:cap - chosen.shape[0]]
        chosen = torch.cat([chosen, fill])
    return chosen


def availability_caps(avail_mat: torch.Tensor,
                      usage: torch.Tensor) -> torch.Tensor:
    """(R, n) max instances per region: min over used configs of
    floor(available nodes / nodes per instance).  Shared by the Coral
    columnar allocator and the Cauchy baseline."""
    per_cfg = torch.where(usage > 0,
                          torch.floor(avail_mat[:, None, :] / usage),
                          np.inf)                           # (R, n, C)
    return per_cfg.amin(dim=2)


def availability_row_index(usage_blocks: Sequence[torch.Tensor],
                           n_regions: int, n_cfg: int):
    """Row layout of the per-(region, used-config) availability
    constraints: a (R, C) row-id matrix (-1 for unused configs) plus
    the region/config index arrays of each row, in row order.  Shared
    by the Coral columnar allocator and the Cauchy baseline."""
    dev = usage_blocks[0].device
    used = torch.zeros(n_cfg, dtype=torch.bool, device=dev)
    for u in usage_blocks:
        used |= (u > 0).any(dim=0)
    used_idx = torch.nonzero(used)[:, 0].tolist()
    row_of = -torch.ones((n_regions, n_cfg), dtype=torch.int64, device=dev)
    rix, cix = [], []
    for r in range(n_regions):
        for c in used_idx:
            row_of[r, c] = len(rix)
            rix.append(r)
            cix.append(c)
    return row_of, torch.tensor(rix, dtype=torch.int64, device=dev), \
        torch.tensor(cix, dtype=torch.int64, device=dev)


def availability_row_coo(usage: torch.Tensor, base: int, n_regions: int,
                         row_of: torch.Tensor):
    """COO triplet segments tying one pair block's region-major vars
    into the per-(region, config) availability rows."""
    nz_t, nz_c = torch.nonzero(usage, as_tuple=True)
    vals = usage[nz_t, nz_c]
    n = usage.shape[0]
    d, r, c = [], [], []
    for reg in range(n_regions):
        d.append(vals)
        r.append(row_of[reg, nz_c])
        c.append(base + reg * n + nz_t)
    return d, r, c


@dataclass
class _PairBlock:
    """Static per-(model, phase) slice of the assembled structure."""
    model: str
    phase: str
    cols: LibraryColumns           # identity-checked for staleness
    sel: torch.Tensor              # indices into cols tensors (device)
    base: int                      # first v-var index of this pair
    thr: torch.Tensor              # (n,) selected throughput (device)
    cost: torch.Tensor             # (n, R) selected per-region cost (device)
    usage: torch.Tensor            # (n, C) selected usage (device)
    templates: List[ServingTemplate]
    keys: List[Tuple]              # template keys, selection order
    key_local: Dict[Tuple, int]    # template key -> local index

    thr_h: Optional[np.ndarray] = None   # host copy of thr (build crossing)

    @property
    def n(self) -> int:
        return self.sel.shape[0]


class AllocatorState:
    """Persistent cross-epoch columnar allocator (callable AllocatorFn).

    The first call assembles the full structure from ``LibraryColumns``;
    later calls with the same shape (regions, demand keys, library,
    caps) reuse it and only rewrite bounds/RHS — plus the incumbent
    warm-start described in the module docstring.  Any shape change
    triggers a transparent rebuild.
    """

    def __init__(self, max_templates_per_demand: Optional[int] = None):
        self._cap_override = max_templates_per_demand
        self._sig = None
        self._prev_x: Optional[np.ndarray] = None
        self._pending_inc: Optional[Dict[Tuple[str, Tuple], int]] = None

    # -------------------------------------------------------- incumbent
    def set_incumbent(self, counts: Optional[Dict[Tuple[str, Tuple], int]]):
        """Seed the *next* solve's warm start from an external target —
        e.g. the churn-scored cheapest-to-reach allocation picked by
        ``repro.control.controller.TransitionPlanner`` — instead of the
        previous solution.  ``counts`` maps (region name, template key)
        to instance counts; entries whose template is not in the
        current selection are ignored.  Pass ``None`` to clear."""
        self._pending_inc = dict(counts) if counts else None

    def _counts_to_x(self, counts: Dict[Tuple[str, Tuple], int]
                     ) -> np.ndarray:
        x = np.zeros(self._V, dtype=np.int64)
        for (rname, tkey), n in counts.items():
            pb = self._pair_by_mp.get((tkey[0], tkey[1]))
            r = self._region_idx.get(rname)
            loc = pb.key_local.get(tkey) if pb is not None else None
            if r is not None and loc is not None:
                x[pb.base + r * pb.n + loc] = n
        return x

    # ------------------------------------------------------------- build
    def _signature(self, p: AllocProblem):
        return (
            tuple((r.name, tuple(sorted(r.price_mult.items())))
                  for r in p.regions),
            tuple((d.model, d.phase) for d in p.demands),
            self._cap_override or p.max_templates_per_demand,
            p.init_penalty_k,
            id(p.library),
        )

    def _stale(self, p: AllocProblem) -> bool:
        if self._sig != self._signature(p):
            return True
        # library content may have changed in place: columns() returns a
        # cached object per (model, phase), so identity is a freshness
        # check; pairs that were empty at build time must re-check too
        # (lib.add may have filled them since)
        for pb, dem in zip(self._pairs, p.demands):
            cols = p.library.columns(dem.model, dem.phase)
            if (cols is not pb.cols) if pb is not None else (cols.n > 0):
                return True
        return False

    def _build(self, p: AllocProblem) -> None:
        t_dev = time.perf_counter()
        cap = self._cap_override or p.max_templates_per_demand
        regions = list(p.regions)
        R = len(regions)
        self._regions = regions
        self._pairs: List[Optional[_PairBlock]] = []
        self._pen: Dict[Tuple[str, str], float] = {}
        V = 0
        for dem in p.demands:
            cols = p.library.columns(dem.model, dem.phase)
            if cols.n == 0:
                self._pairs.append(None)
                continue
            cost_all = cols.region_cost(regions)
            sel = select_template_indices(cost_all, cols.throughput, cap)
            thr = cols.throughput[sel]
            cost = cost_all[sel]
            sel_h = sel.tolist()
            keys = [cols.keys[i] for i in sel_h]
            pb = _PairBlock(dem.model, dem.phase, cols, sel, V, thr, cost,
                            cols.usage[sel],
                            [cols.templates[i] for i in sel_h], keys,
                            {k: i for i, k in enumerate(keys)})
            # shortfall penalty: ~100x the worst $/tok/s so meeting
            # demand wins
            self._pen[(dem.model, dem.phase)] = 100.0 * float(
                (cost / torch.clamp_min(thr, 1e-9)[:, None]).max())
            self._pairs.append(pb)
            V += pb.n * R
        self._V = V
        self._cap = cap
        self._k = p.init_penalty_k
        if V == 0:                       # no templates for any demand
            self._sig = self._signature(p)
            self._prev_x = None
            self._build_device_s = time.perf_counter() - t_dev
            return
        dev = next(pb for pb in self._pairs if pb is not None).cost.device

        # variable metadata (region-major inside each pair block); var
        # index = pb.base + r * pb.n + local — no per-var Python objects
        tmpl_by_key: Dict[Tuple, ServingTemplate] = {}
        for pb in self._pairs:
            if pb is not None:
                tmpl_by_key.update(zip(pb.keys, pb.templates))
        self._pair_list = [pb for pb in self._pairs if pb is not None]
        # region-major ravel: [r0 templates..., r1 templates..., ...]
        v_obj = torch.cat([pb.cost.T.reshape(-1) for pb in self._pair_list])
        self._tmpl_by_key = tmpl_by_key
        self._pair_by_mp = {(pb.model, pb.phase): pb
                            for pb in self._pair_list}
        self._pair_bases = np.array([pb.base for pb in self._pair_list])
        self._region_idx = {r.name: i for i, r in enumerate(regions)}

        # slack vars: one shortfall fraction per model (first-occurrence
        # order), shared across phases (§3: a request not prefilled is
        # never decoded, so phase shortfalls move together)
        self._slack_models: List[str] = []
        for dem in p.demands:
            if dem.model not in self._slack_models:
                self._slack_models.append(dem.model)
        self._slack_of = {m: 2 * V + i
                          for i, m in enumerate(self._slack_models)}
        self._M = len(self._slack_models)

        # config column universe (library-wide, sorted)
        cnames = self._pair_list[0].cols.config_names
        self._cnames = cnames
        self._cfg_idx = {c: i for i, c in enumerate(cnames)}
        self._n_cfg = len(cnames)

        # availability rows: one per (region, config) used by any
        # selected template; the integer index arrays make the RHS a
        # single fancy-index per epoch
        row_of, avail_rix, avail_cix = availability_row_index(
            [pb.usage for pb in self._pair_list], R, self._n_cfg)
        n_avail = avail_rix.shape[0]

        n_dem = len(p.demands)
        self._n_dem = n_dem
        # row layout: [init (V)] [avail (n_avail)] [demand (n_dem)]
        self._n_rows = V + n_avail + n_dem

        # ---- static COO segments -------------------------------------
        i64 = dict(dtype=torch.int64, device=dev)
        seg_d, seg_r, seg_c = [], [], []
        # init penalty rows: price*K*v - I <= price*K*cur
        ar = torch.arange(V, **i64)
        seg_d += [v_obj * p.init_penalty_k,
                  -torch.ones(V, dtype=torch.float64, device=dev)]
        seg_r += [ar, ar]
        seg_c += [ar, ar + V]
        # availability rows (also kept separately, 0-based, for the
        # incumbent-repair CSR)
        av_d, av_r, av_c = [], [], []
        for pb in self._pair_list:
            d, r_, c_ = availability_row_coo(pb.usage, pb.base, R, row_of)
            av_d += d
            av_r += r_
            av_c += c_
        seg_d += av_d
        seg_r += [a + V for a in av_r]
        seg_c += av_c
        # demand rows (var entries)
        for di, pb in enumerate(self._pairs):
            if pb is None:
                continue
            seg_d.append(pb.thr.repeat(R))
            seg_r.append(torch.full((pb.n * R,), V + n_avail + di, **i64))
            seg_c.append(pb.base + torch.arange(pb.n * R, **i64))
        # demand rows (slack entries, rewritten each epoch) — LAST so
        # they occupy the data array's tail
        seg_d.append(torch.zeros(n_dem, dtype=torch.float64, device=dev))
        seg_r.append(V + n_avail + torch.arange(n_dem, **i64))
        seg_c.append(torch.tensor([self._slack_of[d.model]
                                   for d in p.demands], **i64))

        # crossing: the static structure's host copies, for HiGHS
        # (MilpModel), cover_bb (DecomposeProblem) and the greedy repairs
        self._v_obj = to_host(v_obj)
        self._coo_data = to_host(torch.cat(seg_d))
        self._coo_rows = to_host(torch.cat(seg_r))
        self._coo_cols = to_host(torch.cat(seg_c))
        self._avail_rix = to_host(avail_rix)
        self._avail_cix = to_host(avail_cix)
        for pb in self._pair_list:
            pb.thr_h = to_host(pb.thr)
        # 0-based availability COO, reused by the decomposed tier
        # (DecomposeProblem) and the rounding tier's slack accounting
        self._av_coo = (to_host(torch.cat(av_d)), to_host(torch.cat(av_r)),
                        to_host(torch.cat(av_c)))
        self._build_device_s = time.perf_counter() - t_dev
        # column-major layout (data, rows, indptr over vars) so the
        # greedy rounding fill can query one var's availability rows
        c_ord = np.argsort(self._av_coo[2], kind="stable")
        self._av_csc = (
            self._av_coo[0][c_ord], self._av_coo[1][c_ord],
            np.searchsorted(self._av_coo[2][c_ord], np.arange(V + 1)))

        # sparse availability matrix for incumbent repair
        try:
            from scipy import sparse
            self._A_avail = sparse.csr_matrix(
                (self._av_coo[0], (self._av_coo[1], self._av_coo[2])),
                shape=(n_avail, V))
        except Exception:                              # pragma: no cover
            self._A_avail = None

        self._sig = self._signature(p)
        self._prev_x = None

    # ------------------------------------------------------- epoch solve
    def _epoch_arrays(self, p: AllocProblem):
        """Availability / demand / current-dependent arrays; the caps are
        computed on the library's device and cross to the host here."""
        R = len(self._regions)
        avail = np.zeros((R, self._n_cfg))
        for (rname, cname), nodes in p.availability.items():
            r = self._region_idx.get(rname)
            c = self._cfg_idx.get(cname)
            if r is not None and c is not None:
                avail[r, c] = nodes
        tokens = np.array([d.tokens_per_s for d in p.demands])
        dev = self._pair_list[0].thr.device
        avail_d = torch.as_tensor(avail).to(dev)
        v_ub = torch.empty(self._V, dtype=torch.float64, device=dev)
        for di, pb in enumerate(self._pairs):
            if pb is None:
                continue
            dem_cap = torch.ceil(exact_div(float(tokens[di]),
                                           torch.clamp_min(pb.thr, 1e-9))) + 1
            ub = torch.minimum(availability_caps(avail_d, pb.usage), dem_cap)
            v_ub[pb.base:pb.base + pb.n * R] = ub.reshape(-1)
        # crossing: the epoch's caps, for the host solves
        v_ub = to_host(torch.clamp_min(v_ub, 0.0))

        cur = self._counts_to_x(p.current).astype(float)

        # per-model slack penalty: sum over the model's demands of
        # pen(dkey) * tokens (missing pairs default to 1e5, as seed)
        pen_vec = np.zeros(self._M)
        for di, d in enumerate(p.demands):
            m = self._slack_of[d.model] - 2 * self._V
            pen_vec[m] += self._pen.get((d.model, d.phase), 1e5) \
                * d.tokens_per_s
        return avail, v_ub, cur, tokens, pen_vec

    def _incumbent(self, v_ub: np.ndarray, cur: np.ndarray,
                   tokens: np.ndarray, pen_vec: np.ndarray,
                   avail_rhs: np.ndarray):
        """Clamp the previous solution to the new bounds, repair
        availability feasibility greedily, and return (x, z_inc).

        Requires the repair matrix: per-var clamping alone cannot fix a
        *joint* (region, config) availability violation, and an
        infeasible incumbent would make z_inc an invalid bound.
        """
        x = np.minimum(self._prev_x.astype(float), v_ub)
        A = self._A_avail
        usage = A @ x
        for i in np.nonzero(usage > avail_rhs + 1e-9)[0]:
            lo, hi = A.indptr[i], A.indptr[i + 1]
            idx = A.indices[lo:hi]
            coef = A.data[lo:hi]
            s = float(usage[i])
            # drop the most expensive instances first
            order = np.argsort(-self._v_obj[idx], kind="stable")
            for k in order:
                if s <= avail_rhs[i] + 1e-9:
                    break
                v = idx[k]
                if x[v] <= 0:
                    continue
                dec = min(x[v], np.ceil((s - avail_rhs[i]) / coef[k]))
                x[v] -= dec
                s -= dec * coef[k]
            usage = A @ x
        cost = float(self._v_obj @ x)
        init_pen = float(np.maximum(0.0, x - cur) @ self._v_obj) * self._k
        z = cost + init_pen
        s_inc = np.zeros(self._M)
        for di, pb in enumerate(self._pairs):
            if pb is None:
                served = 0.0
            else:
                R = len(self._regions)
                served = float(np.tile(pb.thr_h, R)
                               @ x[pb.base:pb.base + pb.n * R])
            if tokens[di] > 1e-12:
                frac = max(0.0, 1.0 - served / tokens[di])
                m = self._dem_model_idx[di]
                s_inc[m] = max(s_inc[m], frac)
        z += float(pen_vec @ s_inc)
        return x, s_inc, z

    # --------------------------------------------------- decomposed tier
    def _decompose_problem(self, v_ub: np.ndarray, cur: np.ndarray,
                           tokens: np.ndarray, pen_vec: np.ndarray,
                           avail_rhs: np.ndarray) -> "_dec.DecomposeProblem":
        """Mirror this epoch's arrays as a ``DecomposeProblem``: one
        ``RowSpec`` per (model, phase) demand (empty for pairs with no
        templates — their forced full shortfall must still be priced),
        grouped into per-model ``ModelSpec``s by slack index."""
        R = len(self._regions)
        rows_by_m: List[List[_dec.RowSpec]] = [[] for _ in range(self._M)]
        e = np.zeros(0)
        for di, pb in enumerate(self._pairs):
            m = self._dem_model_idx[di]
            if pb is None:
                rows_by_m[m].append(_dec.RowSpec(
                    np.zeros(0, dtype=np.int64), e, e, e, e,
                    float(tokens[di])))
                continue
            lo, hi = pb.base, pb.base + pb.n * R
            rows_by_m[m].append(_dec.RowSpec(
                np.arange(lo, hi), self._v_obj[lo:hi], np.tile(pb.thr_h, R),
                v_ub[lo:hi], cur[lo:hi], float(tokens[di])))
        models = [_dec.ModelSpec(i, rows, float(pen_vec[i]))
                  for i, rows in enumerate(rows_by_m)]
        d, r, c = self._av_coo
        return _dec.DecomposeProblem(self._V, models, self._k, d, r, c,
                                     avail_rhs.astype(float))

    def _round_lp(self, xv_lp: np.ndarray, v_ub: np.ndarray,
                  dp: "_dec.DecomposeProblem", avail_rhs: np.ndarray,
                  tokens: np.ndarray) -> np.ndarray:
        """Round the LP relaxation down (always availability-feasible),
        then re-fill each demand's deficit in two greedy phases.

        Phase 1 bulk-fills in marginal cost-efficiency (cost/token)
        order but never overshoots the target: an LP vertex routinely
        serves a small demand with a tiny *fraction* of one huge
        template, and "one whole instance of the most efficient
        column" can over-provision such a pair by orders of magnitude.
        Phase 2 closes the sub-instance residual by the cheapest
        *total* addition — min over columns of ceil(residual/thr)*cost
        — which picks the small cheap instance the MIP would.  Both
        phases cap takes by the remaining availability slack of every
        config row the candidate column touches."""
        R = len(self._regions)
        v = np.clip(np.floor(xv_lp + 1e-6), 0.0, v_ub)
        slack = (avail_rhs - dp.usage(v)).astype(float)
        dcs, rcs, indptr = self._av_csc

        def room_of(j):
            r = v_ub[j] - v[j]
            a, b_ = indptr[j], indptr[j + 1]
            if b_ > a:
                r = min(r, float(np.min(slack[rcs[a:b_]] / dcs[a:b_])))
            return float(np.floor(r + 1e-9))

        def apply(j, take, thr_j):
            v[j] += take
            a, b_ = indptr[j], indptr[j + 1]
            if b_ > a:
                slack[rcs[a:b_]] -= take * dcs[a:b_]
            return take * thr_j

        for di, pb in enumerate(self._pairs):
            if pb is None:
                continue
            lo, hi = pb.base, pb.base + pb.n * R
            thr = np.tile(pb.thr_h, R)
            deficit = tokens[di] - float(thr @ v[lo:hi])
            if deficit <= 1e-9:
                continue
            cost = self._v_obj[lo:hi]
            eff = np.argsort(cost / np.maximum(thr, 1e-12), kind="stable")
            # phase 1: bulk fill, rounding the take *down* (no overshoot)
            for jl in eff:
                if deficit <= 1e-9:
                    break
                if thr[jl] <= 1e-12:
                    continue
                j = lo + int(jl)
                take = min(room_of(j), np.floor(deficit / thr[jl] + 1e-9))
                if take >= 1.0:
                    deficit -= apply(j, take, thr[jl])
            # phase 2: close the residual at minimum total cost
            while deficit > 1e-9:
                best_jl, best_tot, best_take = -1, np.inf, 0.0
                part_jl, part_take = -1, 0.0
                for jl in eff:
                    if thr[jl] <= 1e-12:
                        continue
                    room = room_of(lo + int(jl))
                    if room < 1.0:
                        continue
                    need = np.ceil(deficit / thr[jl])
                    if room >= need:
                        tot = need * cost[jl]
                        if tot < best_tot - 1e-12:
                            best_jl, best_tot, best_take = int(jl), tot, need
                    elif part_jl < 0:
                        # most efficient partial cover as a last resort
                        part_jl, part_take = int(jl), room
                if best_jl >= 0:
                    jl, take = best_jl, best_take
                elif part_jl >= 0:
                    jl, take = part_jl, part_take
                else:
                    break               # supply exhausted: leave shortfall
                deficit -= apply(lo + jl, take, thr[jl])
        return v

    def _finish(self, xv, xi, xs, objective, tokens, cur, p, t0,
                n_vars, solver_s, path, fallback=False) -> Allocation:
        """Common epilogue of every successful tier: extract, stamp the
        solve-path/time breakdown, advance the warm start, sanitize."""
        build_s = time.time() - t0 - solver_s
        te = time.time()
        alloc = self._extract(xv, xi, xs, tokens, cur, p, t0, n_vars,
                              build_s)
        alloc.extract_seconds = time.time() - te
        alloc.solver_seconds = solver_s
        alloc.solve_path = path
        alloc.device_seconds = self._dev_s
        alloc.objective = objective
        alloc.fallback = fallback
        self._prev_x = np.rint(np.asarray(xv)).astype(np.int64)
        if not fallback and _inv.sanitize_enabled():
            # CORAL_SANITIZE=1: a successful solve must honor the
            # availability constraint it was handed — on *every* tier
            _inv.check_allocation(alloc, p.availability)
        return alloc

    def solve(self, p: AllocProblem) -> Allocation:
        t0 = time.time()
        self._dev_s = 0.0
        if self._sig is None or self._stale(p):
            self._build(p)
            self._dev_s = self._build_device_s
        V = self._V
        if V == 0:
            # an external incumbent has no meaning for an empty model —
            # drop it rather than let it leak into a later solve
            self._pending_inc = None
            unmet = {(d.model, d.phase): d.tokens_per_s for d in p.demands}
            return Allocation({}, {}, 0.0, 0.0, unmet, time.time() - t0,
                              0, True, objective=0.0)
        M = self._M
        self._dem_model_idx = [self._slack_of[d.model] - 2 * V
                               for d in p.demands]
        if self._pending_inc is not None:
            # externally chosen (churn-scored) warm start overrides the
            # previous solution; it is clamped/repaired like any other
            # incumbent before its bound is trusted
            self._prev_x = self._counts_to_x(self._pending_inc)
            self._pending_inc = None
        te = time.perf_counter()
        avail, v_ub, cur, tokens, pen_vec = self._epoch_arrays(p)
        self._dev_s += time.perf_counter() - te
        avail_rhs = self._avail_rhs(avail)

        # epoch rewrites into the static COO structure
        n_dem = self._n_dem
        self._coo_data[-n_dem:] = tokens
        row_lb = np.full(self._n_rows, -np.inf)
        row_ub = np.full(self._n_rows, np.inf)
        row_ub[:V] = self._v_obj * self._k * cur
        row_ub[V:V + len(avail_rhs)] = avail_rhs
        row_lb[V + len(avail_rhs):] = tokens

        # incumbent warm-start: prune + tighten with the previous
        # epoch's (clamped, repaired) solution
        s_ub = np.ones(M)
        inc = None
        if self._prev_x is not None and self._A_avail is not None:
            x_inc, s_inc, z_inc = self._incumbent(
                v_ub, cur, tokens, pen_vec, avail_rhs)
            inc = (x_inc, s_inc, z_inc)
            margin = z_inc * (1.0 + 1e-9) + 1e-9
            v_ub = np.minimum(
                v_ub, np.floor(margin / np.maximum(self._v_obj, 1e-12)))
            s_ub = np.minimum(s_ub,
                              margin / np.maximum(pen_vec, 1e-12))

        mode = p.solve_mode
        deadline = t0 + max(p.time_limit, 0.0)
        solver_s = 0.0
        n_vars_full = 2 * V + M
        # best feasible candidate so far: (v, s, honest objective) —
        # seeds warm starts downward and is the fallback of last resort
        best = inc

        # ---- tier 1: per-model price-coordinated decomposition -------
        dp = None
        if mode in ("auto", "decomposed"):
            dp = self._decompose_problem(v_ub, cur, tokens, pen_vec,
                                         avail_rhs)
            prev = self._prev_x.astype(float) \
                if self._prev_x is not None else None
            rem = max(deadline - time.time(), min(p.time_limit, 1.0))
            try:
                dres = _dec.solve_decomposed(dp, prev_v=prev,
                                             accept_gap=ACCEPT_GAP,
                                             time_limit=rem)
            except Exception:
                # same degradation discipline as the solvers below: a
                # crashing tier escalates, it never raises upward
                dres = _dec.DecomposeResult(False, False, None, None)
            solver_s += dres.seconds
            if dres.ok and dres.objective < (best[2] if best else np.inf):
                best = (dres.v, dres.s, dres.objective)
            if dres.ok and (dres.certified or mode == "decomposed"):
                return self._finish(dres.v, None, dres.s, dres.objective,
                                    tokens, cur, p, t0, n_vars_full,
                                    solver_s, "decomposed")

        if mode != "decomposed":
            if best is not None and best is not inc:
                # a fast-tier candidate cheaper than the incumbent
                # re-tightens the bound pruning before assembly
                margin = best[2] * (1.0 + 1e-9) + 1e-9
                v_ub = np.minimum(v_ub, np.floor(
                    margin / np.maximum(self._v_obj, 1e-12)))
                s_ub = np.minimum(s_ub,
                                  margin / np.maximum(pen_vec, 1e-12))
            mdl = MilpModel()
            mdl.add_vars(self._v_obj, 0.0, v_ub, True)          # v
            mdl.add_vars(np.ones(V), 0.0, np.inf, False)        # I
            mdl.add_vars(pen_vec, 0.0, s_ub, False)             # s_m
            mdl.add_constrs_coo(self._coo_data, self._coo_rows,
                                self._coo_cols, lb=row_lb, ub=row_ub)

            # ---- tier 2: LP relaxation + greedy rounding -------------
            if mode in ("auto", "rounded_lp"):
                if dp is None:
                    dp = self._decompose_problem(v_ub, cur, tokens,
                                                 pen_vec, avail_rhs)
                rem = max(deadline - time.time(), min(p.time_limit, 1.0))
                try:
                    lp = mdl.solve(time_limit=rem, gap=MIP_GAP,
                                   relax=True)
                except Exception:
                    lp = None
                if lp is not None:
                    # failed solves still burn solver time (HiGHS
                    # presolve is not interruptible): always count it,
                    # or it leaks into the assembly metric
                    solver_s += lp.seconds
                if lp is not None and lp.ok:
                    v_r = self._round_lp(lp.x[:V], v_ub, dp, avail_rhs,
                                         tokens)
                    z_r, s_r = _dec._honest(dp, v_r)
                    if z_r < (best[2] if best else np.inf):
                        best = (v_r, s_r, z_r)
                    # the LP optimum is a valid lower bound on the MIP:
                    # certify only when rounding provably lost < gap
                    z_lp = lp.dual_bound if lp.dual_bound is not None \
                        else lp.obj
                    if (z_r - z_lp) <= ACCEPT_GAP * max(abs(z_lp), 1e-9) \
                            or mode == "rounded_lp":
                        return self._finish(v_r, None, s_r, z_r, tokens,
                                            cur, p, t0, n_vars_full,
                                            solver_s, "rounded_lp")

            # ---- tier 3: monolithic MIP, warm-started ----------------
            if mode in ("auto", "monolithic"):
                x0 = None
                if best is not None:
                    bv = np.rint(best[0])
                    x0 = np.concatenate([
                        bv,
                        self._k * self._v_obj * np.maximum(0.0, bv - cur),
                        best[1]])
                rem = max(deadline - time.time(), min(p.time_limit, 1.0))
                try:
                    res = mdl.solve(time_limit=rem, gap=MIP_GAP,
                                    incumbent=x0)
                except Exception:
                    res = None
                if res is not None:
                    solver_s += res.seconds     # count failures too
                if res is not None and res.ok:
                    return self._finish(res.x[:V], res.x[V:2 * V],
                                        res.x[2 * V:], res.obj, tokens,
                                        cur, p, t0, n_vars_full,
                                        solver_s, "monolithic")

        # ---- degradation ladder: every tier failed or timed out ------
        if best is not None:
            return self._finish(best[0], None, best[1], best[2], tokens,
                                cur, p, t0, n_vars_full, solver_s,
                                "fallback", fallback=True)
        t_now = time.time()
        return Allocation({}, {}, np.inf, 0.0,
                          {(d.model, d.phase): d.tokens_per_s
                           for d in p.demands},
                          t_now - t0, n_vars_full, False,
                          build_seconds=t_now - t0 - solver_s,
                          solve_path="fallback", solver_seconds=solver_s)

    def _avail_rhs(self, avail: np.ndarray) -> np.ndarray:
        return avail[self._avail_rix, self._avail_cix]

    def _extract(self, xv, xi, xs, tokens, cur, p, t0, n_vars,
                 build_s) -> Allocation:
        counts = np.rint(xv).astype(np.int64)
        nz = np.nonzero(counts > 0)[0]
        instances = {}
        for i in nz:
            pb = self._pair_list[
                int(np.searchsorted(self._pair_bases, i, side="right")) - 1]
            r, loc = divmod(int(i) - pb.base, pb.n)
            instances[(self._regions[r].name, pb.keys[loc])] = int(counts[i])
        cost = float(self._v_obj[nz] @ counts[nz])
        if xi is not None:
            init_pen = float(np.sum(xi[nz]))
        else:
            init_pen = float(np.maximum(0.0, counts - cur)[nz]
                             @ self._v_obj[nz]) * self._k
        unmet = {}
        for di, d in enumerate(p.demands):
            s = float(xs[self._dem_model_idx[di]])
            if s > 1e-6:
                unmet[(d.model, d.phase)] = s * tokens[di]
        return Allocation(instances, dict(self._tmpl_by_key), cost,
                          init_pen, unmet, time.time() - t0, n_vars, True,
                          build_seconds=build_s)

    __call__ = solve


def allocate(p: AllocProblem) -> Allocation:
    """One-shot columnar allocation (fresh ``AllocatorState``).

    Epoch loops should hold an ``AllocatorState`` instead, to reuse the
    assembled structure and the incumbent warm-start across re-solves.
    """
    return AllocatorState()(p)


# ------------------------------------------------------- reference path
def allocate_reference(p: AllocProblem) -> Allocation:
    """Seed per-var assembly — the equivalence oracle for the columnar
    path (same model, one Python call per variable/row). It reads the
    template objects, not the library's columns, and runs on the host."""
    t0 = time.time()
    cfg_by_name = p.library.config_by_name
    mdl = MilpModel()

    v_vars: Dict[Tuple[str, Tuple], int] = {}
    i_vars: Dict[Tuple[str, Tuple], int] = {}
    tmpl_by_key: Dict[Tuple, ServingTemplate] = {}
    avail_rows: Dict[Tuple[str, str], Dict[int, float]] = {}
    demand_rows: Dict[Tuple[str, str], Dict[int, float]] = {}
    shortfall_pen: Dict[Tuple[str, str], float] = {}

    for dem in p.demands:
        temps = p.library.get(dem.model, dem.phase)
        if not temps:
            continue
        # var-count cap: keep the 2-D (cost, throughput) Pareto frontier
        # first — the solver needs cheap low-throughput templates to match
        # demand tightly, not just the best $/tok/s — then fill by
        # cost-efficiency.
        if len(temps) > p.max_templates_per_demand:
            # hoist per-template min-region cost into one usage x price
            # matmul instead of a per-sort-key loop over regions
            cnames = sorted({c for t in temps for c, _ in t.counts})
            cidx = {c: i for i, c in enumerate(cnames)}
            usage = np.zeros((len(temps), len(cnames)))
            for i, t in enumerate(temps):
                for c, n in t.counts:
                    usage[i, cidx[c]] = n
            price = np.array([[r.node_usd_per_hour(cfg_by_name[c])
                               for c in cnames] for r in p.regions])
            mc = (usage @ price.T).min(axis=1)
            mincost = {t.key: mc[i] for i, t in enumerate(temps)}
            by_cost = sorted(temps, key=lambda t: (mincost[t.key],
                                                   -t.throughput))
            frontier, best_t = [], -1.0
            for t in by_cost:
                if t.throughput > best_t:
                    frontier.append(t)
                    best_t = t.throughput
            chosen = dict.fromkeys(frontier[:p.max_templates_per_demand])
            if len(chosen) < p.max_templates_per_demand:
                def eff(t):
                    return mincost[t.key] / max(t.throughput, 1e-9)
                for t in sorted(temps, key=eff):
                    if len(chosen) >= p.max_templates_per_demand:
                        break
                    chosen.setdefault(t)
            temps = list(chosen)
        dkey = (dem.model, dem.phase)
        demand_rows[dkey] = {}
        # shortfall penalty: ~100x the worst $/tok/s so meeting demand wins
        worst = max(t.cost(r, cfg_by_name) / max(t.throughput, 1e-9)
                    for t in temps for r in p.regions)
        shortfall_pen[dkey] = 100.0 * worst

        for region in p.regions:
            for t in temps:
                usage = t.usage()
                ub = min((p.availability.get((region.name, c), 0) // n
                          for c, n in usage.items() if n > 0), default=0)
                ub = min(ub, int(np.ceil(dem.tokens_per_s
                                         / max(t.throughput, 1e-9))) + 1)
                if ub <= 0:
                    continue
                price = t.cost(region, cfg_by_name)
                key = (region.name, t.key)
                v = mdl.add_var(obj=price, ub=ub, integer=True)
                v_vars[key] = v
                tmpl_by_key[t.key] = t
                # init penalty: I >= (v - v_cur) * price * K
                cur = p.current.get(key, 0)
                iv = mdl.add_var(obj=1.0, lb=0.0)
                i_vars[key] = iv
                mdl.add_constr({v: price * p.init_penalty_k, iv: -1.0},
                               ub=price * p.init_penalty_k * cur)
                for c, n in usage.items():
                    avail_rows.setdefault((region.name, c), {})[v] = float(n)
                demand_rows[dkey][v] = demand_rows[dkey].get(v, 0.0) \
                    + float(t.throughput)

    # availability constraints (insertion-ordered build dict; the
    # per-var oracle path is sanctioned, see allocate_reference doc)
    for (rname, cname), coeffs in avail_rows.items():
        mdl.add_constr(coeffs, ub=float(p.availability.get((rname, cname), 0)))
    # demand constraints with a *coupled per-model* shortfall fraction
    # s_m in [0,1] (the paper has a single T_m per model, §3: a request
    # not prefilled is never decoded, so phase shortfalls move together)
    model_slack = {}
    for dem in p.demands:
        m = dem.model
        if m not in model_slack:
            pen = sum(shortfall_pen.get((d.model, d.phase), 1e5)
                      * d.tokens_per_s for d in p.demands if d.model == m)
            model_slack[m] = mdl.add_var(obj=pen, lb=0.0, ub=1.0)
        coeffs = dict(demand_rows.get((m, dem.phase), {}))
        coeffs[model_slack[m]] = dem.tokens_per_s
        mdl.add_constr(coeffs, lb=dem.tokens_per_s)

    build_s = time.time() - t0
    res = mdl.solve(time_limit=p.time_limit, gap=MIP_GAP)
    if not res.ok:
        return Allocation({}, {}, np.inf, 0.0,
                          {(d.model, d.phase): d.tokens_per_s
                           for d in p.demands},
                          time.time() - t0, mdl.n, False,
                          build_seconds=build_s)

    region_by_name = {r.name: r for r in p.regions}
    instances = {}
    cost = init_pen = 0.0
    for key, v in v_vars.items():
        n = int(round(res.x[v]))
        if n > 0:
            instances[key] = n
            t = tmpl_by_key[key[1]]
            region = region_by_name[key[0]]
            cost += n * t.cost(region, cfg_by_name)
            init_pen += res.x[i_vars[key]]
    unmet = {}
    for dem in p.demands:
        s = res.x[model_slack[dem.model]]
        if s > 1e-6:
            unmet[(dem.model, dem.phase)] = float(s * dem.tokens_per_s)
    return Allocation(instances, tmpl_by_key, cost, init_pen, unmet,
                      time.time() - t0, mdl.n, True, objective=res.obj,
                      build_seconds=build_s)
