"""Generic MILP substrate, on the host.

A tiny modeling API (variables / linear constraints / objective) with two
backends:
  * scipy.optimize.milp (HiGHS) — default, exact, scales to the online
    allocator's ~10^5-variable instances;
  * a pure-numpy branch-and-bound over a dense-simplex LP relaxation —
    dependency-free fallback for small problems.

Model construction comes in two granularities:
  * per-var (``add_var`` / ``add_constr``) — one Python call per
    variable/row; kept for the baselines and small models;
  * batched (``add_vars`` / ``add_constrs_coo``) — whole blocks of
    variables and COO constraint triplets appended at once.  ``solve``
    hands the accumulated triplets straight to ``scipy.sparse`` without
    ever materializing per-row dicts.  The numpy branch-and-bound
    backend densifies COO blocks into per-row dicts on demand, so both
    APIs solve on either backend.

Why this module stays on the host: HiGHS is a CPU library, and the
branch-and-bound (``_solve_bb``) and its dense simplex (``_simplex_min``)
are sequential searches, one branch or pivot at a time, whose every step
decides the next; there is no batch of work in them for a card. A model
therefore holds numpy arrays. ``to_host`` is the one way a tensor of the
library's device enters it: every caller that hands device columns to a
solve goes through it, so the crossings can be found by its name. The
HiGHS call keeps the reference's options as they are, ``presolve: True``
included, so the port solves the same models to the same points.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

try:
    from scipy import sparse
    from scipy.optimize import Bounds, LinearConstraint, milp
    HAVE_SCIPY = True
except Exception:                                     # pragma: no cover
    HAVE_SCIPY = False


def to_host(x) -> np.ndarray:
    """The crossing from the library's device to the host: a numpy copy of
    a tensor (any device), or ``x`` itself as a numpy array. Called where
    columns enter a solve that runs on the host (HiGHS, the
    branch-and-bound searches, the greedy repairs)."""
    if hasattr(x, "detach"):
        return x.detach().to("cpu").numpy()
    return np.asarray(x)


@dataclass
class MilpModel:
    """minimize c.x  s.t.  lb_i <= A_i.x <= ub_i, bounds, integrality."""
    obj: List[float] = field(default_factory=list)
    lb: List[float] = field(default_factory=list)
    ub: List[float] = field(default_factory=list)
    integer: List[bool] = field(default_factory=list)
    rows: List[Dict[int, float]] = field(default_factory=list)
    row_lb: List[float] = field(default_factory=list)
    row_ub: List[float] = field(default_factory=list)
    # COO constraint blocks: (data, global_row_idx, col_idx) triplets
    coo_blocks: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = field(
        default_factory=list)

    def add_var(self, obj: float = 0.0, lb: float = 0.0,
                ub: float = np.inf, integer: bool = False) -> int:
        self.obj.append(obj)
        self.lb.append(lb)
        self.ub.append(ub)
        self.integer.append(integer)
        return len(self.obj) - 1

    def add_vars(self, obj, lb=0.0, ub=np.inf, integer=False) -> np.ndarray:
        """Append a whole block of variables; returns their indices.

        ``obj``/``lb``/``ub``/``integer`` are scalars or 1-D arrays of a
        common length (scalars broadcast).
        """
        k = max((np.asarray(a).shape[0]
                 for a in (obj, lb, ub, integer)
                 if np.ndim(a) == 1), default=1)
        obj = np.broadcast_to(np.asarray(obj, dtype=float), (k,))
        lb = np.broadcast_to(np.asarray(lb, dtype=float), (k,))
        ub = np.broadcast_to(np.asarray(ub, dtype=float), (k,))
        integer = np.broadcast_to(np.asarray(integer, dtype=bool), (k,))
        start = len(self.obj)
        self.obj.extend(obj.tolist())
        self.lb.extend(lb.tolist())
        self.ub.extend(ub.tolist())
        self.integer.extend(integer.tolist())
        return np.arange(start, start + k)

    def add_constr(self, coeffs: Dict[int, float], lb: float = -np.inf,
                   ub: float = np.inf) -> int:
        self.rows.append(coeffs)
        self.row_lb.append(lb)
        self.row_ub.append(ub)
        return len(self.rows) - 1

    def add_constrs_coo(self, data, rows, cols, lb=-np.inf,
                        ub=np.inf) -> np.ndarray:
        """Append a block of constraint rows given as COO triplets.

        ``rows`` are 0-based *within the block*; ``lb``/``ub`` are
        scalars or arrays of length ``n_rows = max(rows) + 1`` (or the
        length of whichever of lb/ub is an array).  Returns the global
        row indices of the block.
        """
        data = np.asarray(data, dtype=float)
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        n_rows = 0
        for b in (lb, ub):
            if np.ndim(b) == 1:
                n_rows = max(n_rows, len(b))
        if n_rows == 0:
            n_rows = int(rows.max()) + 1 if rows.size else 0
        lb = np.broadcast_to(np.asarray(lb, dtype=float), (n_rows,))
        ub = np.broadcast_to(np.asarray(ub, dtype=float), (n_rows,))
        base = len(self.row_lb)
        # placeholder dicts keep per-var row indexing aligned; the COO
        # entries live in coo_blocks until _densify()/solve
        self.rows.extend({} for _ in range(n_rows))
        self.row_lb.extend(lb.tolist())
        self.row_ub.extend(ub.tolist())
        self.coo_blocks.append((data, rows + base, cols))
        return np.arange(base, base + n_rows)

    @property
    def n(self) -> int:
        return len(self.obj)

    def _matrix(self):
        data, ri, ci = [], [], []
        for i, row in enumerate(self.rows):
            for j, v in row.items():
                ri.append(i)
                ci.append(j)
                data.append(v)
        if self.coo_blocks:
            data = np.concatenate(
                [np.asarray(data, dtype=float)]
                + [b[0] for b in self.coo_blocks])
            ri = np.concatenate(
                [np.asarray(ri, dtype=np.int64)]
                + [b[1] for b in self.coo_blocks])
            ci = np.concatenate(
                [np.asarray(ci, dtype=np.int64)]
                + [b[2] for b in self.coo_blocks])
        return data, ri, ci

    def _densify(self) -> None:
        """Fold COO blocks into the per-row dicts (numpy backend)."""
        for data, ri, ci in self.coo_blocks:
            for v, i, j in zip(data.tolist(), ri.tolist(), ci.tolist()):
                row = self.rows[i]
                row[j] = row.get(j, 0.0) + v
        self.coo_blocks = []

    # ---------------------------------------------------------- backends
    def solve(self, time_limit: float = 120.0, gap: float = 1e-6,
              backend: str = "auto", incumbent: Optional[np.ndarray] = None,
              relax: bool = False):
        """Solve the model.

        ``incumbent`` is an optional warm-start point: the numpy
        branch-and-bound verifies it and, when feasible, prunes against
        its objective from node zero; the scipy/HiGHS backend has no
        warm-start API, so it is ignored there (callers still use it to
        pre-tighten bounds).  ``relax=True`` solves the LP relaxation
        (integrality dropped) on either backend — the result's
        ``dual_bound`` then equals its objective, a valid lower bound
        for the integer model.
        """
        if backend == "numpy" or (backend == "auto" and not HAVE_SCIPY):
            return self._solve_bb(time_limit, incumbent=incumbent,
                                  relax=relax)
        return self._solve_scipy(time_limit, gap, relax=relax)

    def _solve_scipy(self, time_limit: float, gap: float,
                     relax: bool = False):
        """HiGHS through scipy: the host crossing of every model solved
        with the default backend (its arrays are numpy by construction)."""
        t0 = time.time()
        data, ri, ci = self._matrix()
        A = sparse.csr_matrix((data, (ri, ci)), shape=(len(self.rows), self.n))
        cons = LinearConstraint(A, np.array(self.row_lb), np.array(self.row_ub))
        integrality = np.zeros(self.n, dtype=np.uint8) if relax \
            else np.array(self.integer, dtype=np.uint8)
        res = milp(
            c=np.array(self.obj),
            constraints=cons,
            integrality=integrality,
            bounds=Bounds(np.array(self.lb), np.array(self.ub)),
            options={"time_limit": time_limit, "mip_rel_gap": gap,
                     "presolve": True},
        )
        ok = res.status == 0 and res.x is not None
        if relax:
            dual = res.fun if ok else None
        else:
            dual = getattr(res, "mip_dual_bound", None)
        return SolveResult(ok, res.x if ok else None,
                           res.fun if ok else np.inf, time.time() - t0,
                           res.status, dual_bound=dual)

    # -------------------------------------------- numpy branch-and-bound
    def _lp_relax(self, extra_lb, extra_ub):
        """Dense LP relaxation via scipy-free projected subgradient is too
        weak; use a simple big-M simplex on the standard form. Suitable
        only for small models (tests)."""
        # convert to: min c x, A_eq x = b (with slacks), x >= 0, x <= ub
        n = self.n
        lb = np.maximum(self.lb, extra_lb)
        ub = np.minimum(self.ub, extra_ub)
        if np.any(lb > ub + 1e-12):
            return None, np.inf
        rows, rl, ru = [], [], []
        for row, l, u in zip(self.rows, self.row_lb, self.row_ub):
            dense = np.zeros(n)
            for j, v in row.items():
                dense[j] = v
            if u < np.inf:
                rows.append(dense.copy())
                rl.append(-np.inf)
                ru.append(u)
            if l > -np.inf:
                rows.append(-dense)
                rl.append(-np.inf)
                ru.append(-l)
        # shift x = y + lb, y in [0, ub-lb]
        shift = np.where(np.isfinite(lb), lb, 0.0)
        span = ub - shift
        A, b = [], []
        for dense, u in zip(rows, ru):
            A.append(dense)
            b.append(u - dense @ shift)
        for j in range(n):
            if np.isfinite(span[j]):
                e = np.zeros(n)
                e[j] = 1.0
                A.append(e)
                b.append(span[j])
        A = np.array(A) if A else np.zeros((0, n))
        b = np.array(b) if b else np.zeros((0,))
        y, obj = _simplex_min(np.array(self.obj), A, b)
        if y is None:
            return None, np.inf
        return y + shift, obj + np.dot(self.obj, shift)

    def _check_feasible(self, x: np.ndarray, tol: float = 1e-6) -> bool:
        """Bounds + rows + integrality check of a candidate point."""
        if x is None or len(x) != self.n:
            return False
        x = np.asarray(x, dtype=float)
        if np.any(x < np.array(self.lb) - tol) \
                or np.any(x > np.array(self.ub) + tol):
            return False
        for j, is_int in enumerate(self.integer):
            if is_int and abs(x[j] - round(x[j])) > tol:
                return False
        for row, l, u in zip(self.rows, self.row_lb, self.row_ub):
            a = sum(v * x[j] for j, v in row.items())
            if a < l - tol or a > u + tol:
                return False
        return True

    def _solve_bb(self, time_limit: float,
                  incumbent: Optional[np.ndarray] = None,
                  relax: bool = False):
        t0 = time.time()
        self._densify()
        n = self.n
        if relax:
            x, obj = self._lp_relax(np.full(n, -np.inf), np.full(n, np.inf))
            ok = x is not None
            t_s = time.time() - t0
            return SolveResult(ok, x, obj if ok else np.inf,
                               t_s, 0 if ok else 2,
                               dual_bound=obj if ok else None)
        best_x, best_obj = None, np.inf
        if incumbent is not None and self._check_feasible(incumbent):
            # bound pruning from node zero: the warm start's objective
            # is a valid upper bound before the first relaxation runs
            best_x = np.asarray(incumbent, dtype=float).copy()
            best_obj = float(np.dot(self.obj, best_x))
        stack = [(np.full(n, -np.inf), np.full(n, np.inf))]
        # deadline-bounded search is inherently wall-clock; callers
        # treat a timeout like a failed solve (Allocation.fallback)
        while stack and time.time() - t0 < time_limit:
            elb, eub = stack.pop()
            x, obj = self._lp_relax(elb, eub)
            if x is None or obj >= best_obj - 1e-9:
                continue
            frac_j, frac_v = -1, 0.0
            for j in range(n):
                if self.integer[j]:
                    f = abs(x[j] - round(x[j]))
                    if f > 1e-6 and f > frac_v:
                        frac_j, frac_v = j, f
            if frac_j < 0:
                if obj < best_obj:
                    best_obj, best_x = obj, x.copy()
                continue
            lo = np.floor(x[frac_j])
            l1, u1 = elb.copy(), eub.copy()
            u1[frac_j] = min(u1[frac_j], lo)
            l2, u2 = elb.copy(), eub.copy()
            l2[frac_j] = max(l2[frac_j], lo + 1)
            stack.append((l1, u1))
            stack.append((l2, u2))
        ok = best_x is not None
        # an exhausted stack proves optimality (within the node pruning
        # tolerance); a deadline exit leaves the bound unknown
        dual = best_obj if ok and not stack else None
        return SolveResult(ok, best_x, best_obj, time.time() - t0,
                           0 if ok else 2, dual_bound=dual)


@dataclass
class SolveResult:
    ok: bool
    x: Optional[np.ndarray]
    obj: float
    seconds: float
    status: int
    # valid lower bound on the integer optimum when the backend proved
    # one (HiGHS' MIP dual bound / an exhausted numpy search / the LP
    # relaxation's own objective); None when unknown
    dual_bound: Optional[float] = None


def _simplex_min(c, A, b) -> Tuple[Optional[np.ndarray], float]:
    """min c.x s.t. A x <= b, x >= 0 — two-phase dense simplex (small)."""
    m, n = A.shape
    # add slacks
    T = np.hstack([A, np.eye(m), b.reshape(-1, 1)])
    # make b >= 0 via artificial handling: if b_i < 0, phase-1 needed;
    # for our test-scale problems all b >= 0 after shifting. Guard:
    if np.any(b < -1e-9):
        # phase 1 with artificials
        neg = b < 0
        T[neg, :] *= -1
        n_art = int(neg.sum())
        art = np.zeros((m, n_art))
        k = 0
        for i in range(m):
            if neg[i]:
                art[i, k] = 1.0
                k += 1
        T = np.hstack([T[:, :-1], art, T[:, -1:]])
        cost1 = np.zeros(T.shape[1] - 1)
        cost1[n + m:] = 1.0
        basis = []
        k = 0
        for i in range(m):
            if neg[i]:
                basis.append(n + m + k)
                k += 1
            else:
                basis.append(n + i)
        T, basis, ok = _pivot_loop(T, np.array(basis), cost1)
        if not ok or _objective(T, basis, cost1) > 1e-7:
            return None, np.inf
        # pivot remaining (zero-level) artificials out of the basis
        for i in range(m):
            if basis[i] >= n + m:
                row = T[i, :n + m]
                js = np.flatnonzero(np.abs(row) > 1e-9)
                if len(js):
                    j = int(js[0])
                    T[i, :] /= T[i, j]
                    for r in range(m):
                        if r != i and abs(T[r, j]) > 1e-12:
                            T[r, :] -= T[r, j] * T[i, :]
                    basis[i] = j
        keep = basis < n + m
        T = np.hstack([T[keep][:, :n + m], T[keep][:, -1:]])
        basis = basis[keep]
        m = T.shape[0]
    else:
        basis = np.array([n + i for i in range(m)])
    n_cols = T.shape[1] - 1
    cost = np.concatenate([c, np.zeros(n_cols - n)])
    T, basis, ok = _pivot_loop(T, basis, cost)
    if not ok:
        return None, np.inf
    x = np.zeros(n_cols)
    x[basis] = T[:, -1]
    return x[:n], float(cost @ x)


def _objective(T, basis, cost):
    x = np.zeros(T.shape[1] - 1)
    x[basis] = T[:, -1]
    return float(cost @ x)


def _pivot_loop(T, basis, cost, max_iter=2000):
    m = T.shape[0]
    for _ in range(max_iter):
        cb = cost[basis]
        red = cost[: T.shape[1] - 1] - cb @ T[:, :-1]
        j = int(np.argmin(red))
        if red[j] >= -1e-9:
            return T, basis, True
        col = T[:, j]
        pos = col > 1e-12
        if not np.any(pos):
            return T, basis, False          # unbounded
        ratios = np.where(pos, T[:, -1] / np.where(pos, col, 1.0), np.inf)
        i = int(np.argmin(ratios))
        T[i, :] /= T[i, j]
        for r in range(m):
            if r != i and abs(T[r, j]) > 1e-12:
                T[r, :] -= T[r, j] * T[i, :]
        basis[i] = j
    return T, basis, False
