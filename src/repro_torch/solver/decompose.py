"""Per-model price-coordinated decomposition of the online allocation
ILP (paper §4.3; the "lossless two-stage" claim made operational).

The monolithic epoch model couples (model, phase) demand rows only
through the shared per-(region, config) availability rows and the
per-model shortfall fraction.  Relaxing availability with a price
vector λ ≥ 0 (Lagrangian) makes the epoch problem separable per model,
and each model's subproblem decomposes further — once the shortfall
fraction is pinned (see below) — into independent *single-row bounded
knapsack-cover* problems:

    min  Σ_j c̃_j v_j     s.t.  Σ_j t_j v_j >= T,   0 <= v_j <= u_j int

solved *exactly* by ``cover_bb``: a dependency-free branch-and-bound
whose node relaxation is the fractional greedy cover (a cumsum over
efficiency-sorted columns), with two structural accelerations:

* **Pareto column dominance** — a column is dropped when a
  cheaper-or-equal, faster-or-equal column has enough capacity to fully
  substitute for it (``u * t >= T``); this cuts the ~10^3 columns of a
  paper-scale row to a few dozen;
* **incumbent pruning** — a feasible warm start (the previous epoch's
  solution) bounds the search from node zero.

Initialization penalty (``I = K c (v - cur)+``) is folded exactly by
*column splitting*: each column with running instances becomes a
cheap slice (ub = cur, cost c) and a full-price slice
(ub = u - cur, cost c (1 + K)); the split model's optimum equals the
true model's because the cheap slice strictly dominates.

Shortfall handling is where discreteness bites: the per-model slack
``s_m`` (penalty ≈ 100x the worst $/tok/s) couples the model's rows,
and the provably-optimal *continuous* choice ``s̄ = max_d
(1 - cap_d/T_d)+`` can be beaten by up to ~1% of one instance's
coverage when shaving the last sliver of a row saves a whole instance.
``_solve_model`` therefore brackets the flex: rows are solved at
``s = s̄`` (the primal candidate) and once more at the window edge
``s_hi = s̄ + Z/pen`` (any larger s is dominated because the penalty
alone exceeds the total cover cost Z), giving a *valid* per-model dual
bound — tight whenever no row drops an instance inside the <=1% target
window, which is the common case.

The coordination loop (``solve_decomposed``):

  1. solve every model at λ = 0 — a pure relaxation, so Σ duals is a
     valid lower bound on the monolithic optimum;
  2. if the combined solution violates no availability row, the primal
     is feasible; certify when (primal - dual)/|dual| <= accept_gap;
  3. otherwise repair greedily (un-assign the lowest-value violators,
     most expensive first — the same discipline as the allocator's
     incumbent repair), take a subgradient step
     λ <- max(0, λ + θ (z_UB - L)/||g||² g) on the violated rows, and
     re-solve with priced costs c̃ = c + Aᵀλ;
  4. give up after ``max_iters`` (or on a node/time budget hit) and
     return the best feasible primal *uncertified* — the caller
     escalates (LP-round, then the monolithic MIP) with this solution
     as its warm start, so non-convergence costs time, never quality.

Everything here runs on the host, in plain numpy: ``cover_bb`` is a
node-by-node depth-first search whose every node decides the next, and the
coordination loop around it works on vectors of a few dozen availability
rows. A ``DecomposeProblem`` takes its columns as tensors of the library's
device or as numpy arrays and makes host copies of them once, when it is
built (``to_host``, the crossing named in ``repro_torch.solver.milp``);
the allocator builds one per solve.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.solver.milp import to_host

# per-row branch-and-bound budget: measured paper-scale rows close in
# <= ~1.5k nodes after Pareto reduction; the budget is a runaway guard,
# and a hit voids the certificate (never the correctness of the primal)
MAX_NODES_PER_ROW = 20000


# --------------------------------------------------------------- problem
@dataclass
class RowSpec:
    """One (model, phase) demand row, region-major over its columns."""
    cols: np.ndarray               # (n,) global v-var indices
    cost: np.ndarray               # (n,) base per-instance $/h
    thr: np.ndarray                # (n,) tokens/s per instance
    ub: np.ndarray                 # (n,) availability/demand cap
    cur: np.ndarray                # (n,) currently running instances
    target: float                  # demanded tokens/s


@dataclass
class ModelSpec:
    """A model's rows plus its shortfall penalty coefficient."""
    index: int                     # slack index m
    rows: List[RowSpec]
    pen: float                     # objective coeff of s_m


@dataclass
class DecomposeProblem:
    """Arrays mirroring one ``AllocatorState`` epoch (see
    ``AllocatorState._decompose_problem``)."""
    n_vars: int
    models: List[ModelSpec]
    init_k: float
    # availability rows as COO over the v-vars + RHS
    av_data: np.ndarray
    av_rows: np.ndarray
    av_cols: np.ndarray
    b: np.ndarray

    def __post_init__(self):
        # host copies of the device columns, once per solve
        self.av_data = to_host(self.av_data).astype(float)
        self.av_rows = to_host(self.av_rows).astype(np.int64)
        self.av_cols = to_host(self.av_cols).astype(np.int64)
        self.b = to_host(self.b).astype(float)
        for ms in self.models:
            for r in ms.rows:
                r.cols = to_host(r.cols).astype(np.int64)
                for f in ("cost", "thr", "ub", "cur"):
                    setattr(r, f, to_host(getattr(r, f)).astype(float))
        # CSR-ish layout for usage folds and per-row repair scans
        order = np.argsort(self.av_rows, kind="stable")
        self._od = self.av_data[order]
        self._or = self.av_rows[order]
        self._oc = self.av_cols[order]
        self._indptr = np.searchsorted(self._or, np.arange(len(self.b) + 1))

    def usage(self, v: np.ndarray) -> np.ndarray:
        out = np.zeros(len(self.b))
        np.add.at(out, self.av_rows, self.av_data * v[self.av_cols])
        return out

    def priced_costs(self, lam: np.ndarray) -> np.ndarray:
        """Per-v-var cost increment Aᵀλ."""
        out = np.zeros(self.n_vars)
        np.add.at(out, self.av_cols, self.av_data * lam[self.av_rows])
        return out


@dataclass
class DecomposeResult:
    ok: bool                       # a feasible primal exists
    certified: bool                # primal within accept_gap of the dual
    v: Optional[np.ndarray]        # (n_vars,) integer counts
    s: Optional[np.ndarray]        # per-model shortfall fractions
    objective: float = np.inf      # honest primal objective
    dual_bound: float = -np.inf    # best valid Lagrangian bound
    gap: float = np.inf
    iters: int = 0
    nodes: int = 0
    seconds: float = 0.0
    reason: str = ""               # certified/gap/budget/deadline/infeasible


# ----------------------------------------------------- single-row solver
def pareto_keep(cost: np.ndarray, thr: np.ndarray, ub: np.ndarray,
                target: float) -> np.ndarray:
    """Boolean mask of columns that can appear in *some* optimal cover.

    A column is dominated when a cheaper-or-equal column with >=
    throughput can substitute for every unit of it; substitution is
    only safe when the dominator alone could cover the whole target
    (``u * t >= target``), because a saturated dominator already proves
    the dominated column's units redundant.
    """
    n = len(cost)
    keep = np.ones(n, dtype=bool)
    order = np.lexsort((-thr, cost))       # cost asc, throughput desc
    best_t = -np.inf
    for j in order:
        if thr[j] <= best_t:
            keep[j] = False
        elif ub[j] * thr[j] >= target - 1e-9:
            best_t = thr[j]
    return keep


def cover_bb(cost: np.ndarray, thr: np.ndarray, ub: np.ndarray,
             target: float, incumbent: Optional[np.ndarray] = None,
             rel_gap: float = 1e-9, max_nodes: int = MAX_NODES_PER_ROW,
             deadline: Optional[float] = None
             ) -> Tuple[Optional[np.ndarray], float, float, int, bool]:
    """Exact bounded knapsack-cover:  min c·v, t·v >= target, 0<=v<=u int.

    Returns ``(v, obj, dual, nodes, complete)``.  ``dual`` is a valid
    lower bound on the row optimum (= obj - rel_gap·|obj| when the
    search completed, -inf when a budget/deadline hit voided it).  A
    target beyond total capacity is clipped to it by the caller (the
    shortfall fraction absorbs the remainder), so feasibility here
    means ``sum(t·u) >= target``.
    """
    n = len(cost)
    if target <= 1e-9:
        return np.zeros(n), 0.0, 0.0, 0, True
    live = (ub > 0) & (thr > 1e-12)
    keep = np.zeros(n, dtype=bool)
    keep[live] = pareto_keep(cost[live], thr[live], ub[live], target)
    idx = np.nonzero(keep)[0]
    if not len(idx):
        return None, np.inf, -np.inf, 0, True
    c, t, u = cost[idx], thr[idx], ub[idx].astype(float)
    order = np.argsort(c / t, kind="stable")
    cs, ts, us = c[order], t[order], u[order]
    best, best_buy = np.inf, None
    if incumbent is not None:
        xi = np.minimum(incumbent[idx][order].astype(float), us)
        if ts @ xi >= target - 1e-9:
            best = float(cs @ xi)
            best_buy = {int(j): float(q)
                        for j, q in enumerate(xi) if q > 0}
    m_cols = len(cs)
    # DFS node: (committed cost, residual target, ub overrides, buys);
    # diving the ceil child first reaches feasible leaves near the
    # greedy-ceil solution immediately, so pruning starts early
    stack = [(0.0, float(target), {}, {})]
    nodes, complete = 0, True
    while stack:
        nodes += 1
        if nodes > max_nodes or (
                deadline is not None and time.time() > deadline):
            complete = False
            break
        cost0, resid, ovr, buy = stack.pop()
        tol = max(rel_gap * abs(best), 1e-12) if np.isfinite(best) else 0.0
        if cost0 >= best - tol:
            continue
        if resid <= 1e-9:
            best, best_buy = cost0, buy
            continue
        eub = us if not ovr else us.copy()
        for j, q in ovr.items():
            eub[j] = q
        cap = ts * eub
        cum = np.cumsum(cap)
        k = int(np.searchsorted(cum, resid - 1e-12))
        if k >= m_cols:
            continue                       # cannot cover the residual
        prev = cum[k - 1] if k else 0.0
        x_lp = (resid - prev) / ts[k]
        ccost = np.cumsum(cs * eub)
        lp = cost0 + (ccost[k - 1] if k else 0.0) + x_lp * cs[k]
        if lp >= best - tol:
            continue
        if abs(x_lp - round(x_lp)) < 1e-9:
            nb = dict(buy)
            for j in range(k):
                if eub[j] > 0:
                    nb[j] = nb.get(j, 0.0) + float(eub[j])
            q = float(round(x_lp))
            if q > 0:
                nb[k] = nb.get(k, 0.0) + q
            best, best_buy = lp, nb
            continue
        up, dn = float(np.ceil(x_lp)), float(np.floor(x_lp))
        o2 = dict(ovr)
        o2[k] = dn
        stack.append((cost0, resid, o2, buy))        # v_k <= floor
        o1 = dict(ovr)
        o1[k] = float(eub[k]) - up
        b1 = dict(buy)
        b1[k] = b1.get(k, 0.0) + up
        stack.append((cost0 + up * cs[k], resid - up * ts[k], o1, b1))
    if best_buy is None:
        return None, np.inf, -np.inf, nodes, complete
    v = np.zeros(n)
    gidx = idx[order]
    for j, q in best_buy.items():
        v[gidx[j]] += q
    dual = best - max(rel_gap * abs(best), 1e-12) if complete else -np.inf
    return v, float(best), dual, nodes, complete


# --------------------------------------------------- per-model subproblem
def _split_row(row: RowSpec, k: float, lam_add: np.ndarray):
    """Exact init-penalty reformulation: columns with running instances
    split into a protected slice (no init charge) and a full-price
    slice; ``lam_add`` is the availability price Aᵀλ of each column."""
    lo_ub = np.minimum(row.cur, row.ub)
    add = lam_add[row.cols]
    cost = np.concatenate([row.cost + add, row.cost * (1.0 + k) + add])
    thr = np.concatenate([row.thr, row.thr])
    ub = np.concatenate([lo_ub, row.ub - lo_ub])
    return cost, thr, ub


def _merge_split(x: np.ndarray, n: int) -> np.ndarray:
    return x[:n] + x[n:]


def _solve_model(ms: ModelSpec, k: float, lam_add: np.ndarray,
                 prev_v: Optional[np.ndarray], rel_gap: float,
                 deadline: Optional[float]):
    """Exact subproblem at prices λ: returns ``(v, s, z_primal, L_m,
    nodes, complete)`` with ``L_m`` a valid lower bound on the priced
    subproblem optimum (see the module docstring's s-window argument)."""
    caps = np.array([float(r.thr @ r.ub) for r in ms.rows])
    tgts = np.array([r.target for r in ms.rows])
    with np.errstate(divide="ignore", invalid="ignore"):
        s_bar = float(np.max(np.where(
            tgts > 1e-12, np.maximum(0.0, 1.0 - caps / tgts), 0.0),
            initial=0.0))
    nodes, complete = 0, True
    covers, duals, Z = [], 0.0, 0.0
    for ri, r in enumerate(ms.rows):
        cost, thr, ub = _split_row(r, k, lam_add)
        inc = None
        if prev_v is not None:
            pv = np.minimum(prev_v[r.cols], r.ub)
            lo = np.minimum(pv, np.minimum(r.cur, r.ub))
            inc = np.concatenate([lo, pv - lo])
        # clip to capacity: s̄ makes the reduced target feasible by
        # construction, but float dust must not turn it infeasible
        x, z, dual, nd, comp = cover_bb(
            cost, thr, ub, min(r.target * (1.0 - s_bar), caps[ri]),
            incumbent=inc, rel_gap=rel_gap, deadline=deadline)
        nodes += nd
        complete &= comp and x is not None
        if x is None:
            covers.append(np.zeros(len(r.cols)))
            continue
        covers.append(_merge_split(x, len(r.cols)))
        duals += dual if comp else 0.0
        Z += z
    # s-flex window: any s above s_hi pays more penalty than the whole
    # cover costs, so re-solving each row at the window edge bounds the
    # subproblem from below across every admissible s
    L_m = ms.pen * s_bar + duals
    if complete and ms.pen > 1e-12 and Z > 1e-12:
        s_hi = min(1.0, s_bar + Z / ms.pen)
        if s_hi > s_bar + 1e-12:
            duals_lo = 0.0
            for ri, (r, cv) in enumerate(zip(ms.rows, covers)):
                cost, thr, ub = _split_row(r, k, lam_add)
                lo = np.minimum(cv, np.minimum(r.cur, r.ub))
                inc = np.concatenate([lo, cv - lo])
                _x, _z, dual, nd, comp = cover_bb(
                    cost, thr, ub,
                    min(r.target * (1.0 - s_hi), caps[ri]),
                    incumbent=inc, rel_gap=rel_gap, deadline=deadline)
                nodes += nd
                if not comp:
                    complete = False
                    break
                duals_lo += dual
            else:
                L_m = ms.pen * s_bar + duals_lo
    if not complete:
        L_m = -np.inf
    # honest primal at the (unpriced) true objective is assembled by
    # the caller; here we report the priced subproblem value
    z_primal = ms.pen * s_bar + Z
    return covers, s_bar, z_primal, L_m, nodes, complete


# ------------------------------------------------------------- repair
def _repair(dp: DecomposeProblem, v: np.ndarray,
            cost_of: np.ndarray) -> np.ndarray:
    """Greedy feasibility repair: for each violated availability row,
    un-assign the lowest-value (most expensive per instance) violators
    until holdings fit — the same discipline as ``AllocatorState``'s
    incumbent repair."""
    v = v.copy()
    usage = dp.usage(v)
    for i in np.nonzero(usage > dp.b + 1e-9)[0]:
        lo, hi = dp._indptr[i], dp._indptr[i + 1]
        cols = dp._oc[lo:hi]
        coef = dp._od[lo:hi]
        s = float(usage[i])
        for j in np.argsort(-cost_of[cols], kind="stable"):
            if s <= dp.b[i] + 1e-9:
                break
            cj = cols[j]
            if v[cj] <= 0:
                continue
            dec = min(v[cj], np.ceil((s - dp.b[i]) / coef[j]))
            v[cj] -= dec
            s -= dec * coef[j]
        usage = dp.usage(v)
    return v


def _honest(dp: DecomposeProblem, v: np.ndarray) -> Tuple[float, np.ndarray]:
    """True (unpriced) objective of integer counts ``v``: provisioning
    cost + init penalty + shortfall penalty, with each model's slack at
    its minimum feasible level for this v."""
    obj = 0.0
    s = np.zeros(len(dp.models))
    for ms in dp.models:
        worst = 0.0
        for r in ms.rows:
            x = v[r.cols]
            obj += float(r.cost @ x) \
                + dp.init_k * float(r.cost @ np.maximum(0.0, x - r.cur))
            if r.target > 1e-12:
                worst = max(worst, max(
                    0.0, 1.0 - float(r.thr @ x) / r.target))
        s[ms.index] = worst
        obj += ms.pen * worst
    return obj, s


# ------------------------------------------------------- coordination
def solve_decomposed(dp: DecomposeProblem,
                     prev_v: Optional[np.ndarray] = None,
                     accept_gap: float = 5e-4, max_iters: int = 6,
                     rel_gap: float = 1e-6, theta: float = 1.0,
                     time_limit: Optional[float] = None
                     ) -> DecomposeResult:
    """Price-coordination loop over the per-model subproblems."""
    t0 = time.time()
    deadline = t0 + time_limit if time_limit is not None else None
    n_avail = len(dp.b)
    lam = np.zeros(n_avail)
    cost_of = np.zeros(dp.n_vars)
    for ms in dp.models:
        for r in ms.rows:
            cost_of[r.cols] = r.cost
    best_obj, best_v, best_s = np.inf, None, None
    best_dual = -np.inf
    nodes_total = 0
    reason = "gap"
    it = 0
    for it in range(1, max_iters + 1):
        if deadline is not None and time.time() > deadline:
            reason = "deadline"
            break
        lam_add = dp.priced_costs(lam) if lam.any() \
            else np.zeros(dp.n_vars)
        v = np.zeros(dp.n_vars)
        dual_it, complete_all = 0.0, True
        for ms in dp.models:
            covers, s_bar, _zp, L_m, nd, comp = _solve_model(
                ms, dp.init_k, lam_add, prev_v, rel_gap, deadline)
            nodes_total += nd
            complete_all &= comp
            for r, cv in zip(ms.rows, covers):
                v[r.cols] += cv
            if comp:
                dual_it += L_m
        if complete_all:
            dual_it -= float(lam @ dp.b)
            best_dual = max(best_dual, dual_it)
        usage = dp.usage(v)
        g = usage - dp.b
        feasible = bool(np.all(g <= 1e-9))
        v_try = v if feasible else _repair(dp, v, cost_of)
        obj, s = _honest(dp, v_try)
        if obj < best_obj:
            best_obj, best_v, best_s = obj, v_try, s
        if np.isfinite(best_obj) and best_dual > -np.inf:
            denom = max(abs(best_dual), 1e-9)
            if (best_obj - best_dual) / denom <= accept_gap:
                reason = "certified"
                break
        if feasible:
            # λ's subgradient points no further up: the dual cannot
            # improve from here, so a surviving gap is integrality —
            # escalation's job, not more iterations'
            reason = "gap" if complete_all else "budget"
            break
        step = theta * max(best_obj - dual_it, 1e-9) \
            / max(float(g @ g), 1e-12)
        lam = np.maximum(0.0, lam + step * g)
        prev_v = best_v if best_v is not None else prev_v
    certified = reason == "certified"
    gap = np.inf
    if np.isfinite(best_obj) and best_dual > -np.inf:
        gap = (best_obj - best_dual) / max(abs(best_dual), 1e-9)
    return DecomposeResult(
        ok=best_v is not None, certified=certified, v=best_v, s=best_s,
        objective=best_obj, dual_bound=best_dual, gap=gap, iters=it,
        nodes=nodes_total, seconds=time.time() - t0,
        reason=reason if best_v is not None else "infeasible")
