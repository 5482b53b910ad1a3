"""Throughput-optimal model placement on a node combination (paper §4.2).

Three solvers that agree, as in the reference:

1. ``optimal_placement_ilp`` — the paper's exact formulation: binaries
   x_sj (stage s holds j layers), y_sk (node k in stage s), linearized
   z_sjk, maximize T with per-stage constraints
   T <= sum_jk z_sjk * T̂_j(g_k); optimum over S in [1, |G'|].
   Solved with HiGHS (``repro_torch.solver.milp``, on the host).

2. ``optimal_placement_exact`` — the combinatorial oracle: node->stage
   assignments reduce to *multiset partitions* of G', and for a fixed
   partition the optimal layer split is found by binary-searching the
   bottleneck throughput (T̂_j is non-increasing in j). One combo at a
   time, on the device its table rows lie on; kept to check the fast
   path.

3. ``PlacementCache`` / ``optimal_placement_fast`` — the production path
   of library generation. For a partition with stacked per-stage rows A
   (S x L, each non-increasing) the optimum is the closed form

       T* = min( L-th largest positive entry of A, min_s A[s,0] )

   (infeasible iff A has < L positive entries or some row is all zero),
   evaluated for a (combos, partitions) grid at once: a gather of summed
   group rows, an L-th-largest selection and a minimum over stages. The
   group rows, the per-config base rows and the aggregate bound R_S live
   on the cache's device (``cuda`` unless the caller asks for another);
   the registries that intern stage groups (by name tuple and by packed
   integer code) are Python dicts on the host, and a batch's unique codes
   cross to the host once per (shape, S) to be looked up there.

Group rows are summed one member at a time in sorted-name order, as the
reference does (``_flush``: one vectorized add per member position over
all new groups), so every throughput equals the reference's to the last
bit on either device. R_S is a bound, inflated by ``_UB_INFLATE``, so it
may come from a matmul.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.solver.milp import MilpModel, to_host


@dataclass(frozen=True)
class Placement:
    n_stages: int
    layer_counts: Tuple[int, ...]           # per stage, sums to L
    stage_nodes: Tuple[Tuple[str, ...], ...]  # node-config names per stage
    throughput: float                        # tokens/s of the pipeline


def _layer_split(S: int, L: int, js: Sequence[int]) -> Optional[List[int]]:
    """Distribute L layers over S stages: one each, then fill stage i up to
    its ``js[i]`` (the reference's rule); None if some layers are left."""
    counts = [1] * S
    rest = L - S
    for i in range(S):
        add = min(rest, int(js[i]) - 1)
        counts[i] += add
        rest -= add
    return None if rest > 0 else counts


# ------------------------------------------------------------ exact solver
def _multiset_partitions(items: Tuple[str, ...]):
    """All partitions of a multiset into unordered non-empty groups."""
    items = tuple(sorted(items))

    def rec(remaining: Tuple[str, ...], groups: Tuple[Tuple[str, ...], ...]):
        if not remaining:
            yield groups
            return
        x, rest = remaining[0], remaining[1:]
        seen = set()
        for i, g in enumerate(groups):
            key = g
            if key in seen:
                continue
            seen.add(key)
            yield from rec(rest, tuple(sorted(
                groups[:i] + (tuple(sorted(g + (x,))),) + groups[i + 1:])))
        yield from rec(rest, tuple(sorted(groups + ((x,),))))

    out = set()
    for p in rec(items, ()):
        out.add(p)
    return out


def _bottleneck_search(arrs: List[torch.Tensor], L: int
                       ) -> Optional[Tuple[float, List[int]]]:
    """Largest bottleneck T over the distinct positive entries of the stage
    rows ``arrs`` such that every stage fits >= 1 layer at T and the stages
    fit >= L layers in all; returns ``(T, per-stage max layers)``."""
    pos = [a[a > 0] for a in arrs]
    if not any(p.numel() for p in pos):
        return None
    cand = torch.unique(torch.cat(pos))          # ascending
    neg = [-a for a in arrs]                      # non-decreasing

    def feasible(T: torch.Tensor) -> Optional[List[int]]:
        js = []
        for a in neg:
            # largest j (1-indexed) with a[j-1] >= T; a non-increasing
            jmax = int(torch.searchsorted(a, -T, right=True))
            if jmax == 0:
                return None
            js.append(jmax)
        return js if sum(js) >= L else None

    lo, hi = 0, cand.numel() - 1
    if feasible(cand[0]) is None:
        return None
    while lo < hi:                       # largest feasible candidate
        mid = (lo + hi + 1) // 2
        if feasible(cand[mid]) is not None:
            lo = mid
        else:
            hi = mid - 1
    js = feasible(cand[lo])
    return None if js is None else (float(cand[lo]), js)


def optimal_placement_exact(node_names: Sequence[str],
                            tables: Callable[[str, int], torch.Tensor],
                            L: int,
                            max_stages: Optional[int] = None) -> Optional[Placement]:
    """node_names: node-config names of G'. tables(name, S) -> length-L
    non-increasing row of T̂_j (j = 1..L) under per-stage budget slo/S."""
    names = tuple(sorted(node_names))
    K = len(names)
    max_stages = min(max_stages or K, K)
    best: Optional[Placement] = None

    for groups in _multiset_partitions(names):
        S = len(groups)
        if S > max_stages or S > L:
            continue
        # per-stage throughput rows under the S-stage budget
        found = _bottleneck_search(
            [sum(tables(n, S) for n in g) for g in groups], L)
        if found is None:
            continue
        T, js = found
        counts = _layer_split(S, L, js)
        if counts is None:
            continue
        if best is None or T > best.throughput:
            best = Placement(S, tuple(counts), groups, T)
    return best


# ------------------------------------------------------- fast cached solver
@lru_cache(maxsize=None)
def _partitions_by_shape(shape: Tuple[int, ...]):
    """Partition structures for any multiset with count signature ``shape``
    (counts sorted descending, e.g. (A,A,A,B,C,C) -> (3,2,1)).

    Structurally identical combos share their partition set up to a
    relabeling, so this is computed once per shape. Returns
    ``(cgroups, by_S)`` where ``cgroups`` is the list of distinct
    canonical groups — each a tuple of (label, count) pairs, labels being
    indices into ``shape`` — and ``by_S[S] = (used, local_idx)``:
    ``used`` the int array of cgroup indices appearing in S-part
    partitions, ``local_idx`` an int32 array (P_S, S) indexing into
    ``used``, one row per partition into S groups. Host structure, made
    once per shape; ``_shape_plan`` holds its device copy.
    """
    items = tuple(lbl for lbl, n in enumerate(shape) for _ in range(n))
    cg_index: Dict[Tuple[Tuple[int, int], ...], int] = {}
    cgroups: List[Tuple[Tuple[int, int], ...]] = []
    rows_by_S: Dict[int, List[List[int]]] = {}
    for part in _multiset_partitions(items):
        row = []
        for g in part:
            key = tuple(sorted((lbl, g.count(lbl))
                               for lbl in sorted(set(g))))
            gid = cg_index.get(key)
            if gid is None:
                gid = cg_index[key] = len(cgroups)
                cgroups.append(key)
            row.append(gid)
        rows_by_S.setdefault(len(part), []).append(sorted(row))
    by_S = {}
    for S, rows in rows_by_S.items():
        idx = np.array(rows, dtype=np.int32)
        used, local = np.unique(idx, return_inverse=True)
        by_S[S] = (used, local.reshape(idx.shape).astype(np.int32))
    return cgroups, by_S


@lru_cache(maxsize=None)
def _shape_plan(shape: Tuple[int, ...], device: torch.device):
    """``_partitions_by_shape`` on ``device``: the (cgroups, labels) count
    matrix CG and, per S, ``used`` and ``local_idx`` as int64 tensors."""
    cgroups, by_S = _partitions_by_shape(shape)
    CG = np.zeros((len(cgroups), len(shape)), dtype=np.int64)
    for u, key in enumerate(cgroups):
        for lbl, cnt in key:
            CG[u, lbl] = cnt
    dev = {S: (torch.as_tensor(used, dtype=torch.int64, device=device),
               torch.as_tensor(local, dtype=torch.int64, device=device))
           for S, (used, local) in by_S.items()}
    return cgroups, torch.as_tensor(CG, device=device), dev


CODE_BITS = 3                 # packed stage-group codes: 3 bits per config
CODE_MASK = (1 << CODE_BITS) - 1
# multiplicative slack covering the fp error of the vectorized R_S bound
# (a <= 21-term matvec; worst-case relative error ~2e-15) so the bound
# stays a true upper bound on the sequentially-accumulated stage rows
_UB_INFLATE = 1.0 + 1e-12
# elements of the (live pairs, S * L) gather evaluated at once; the result
# does not depend on it (a combo's incumbent only moves between passes)
_GRID_ELEMS = 1 << 24


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for int64 matrices, exact: CUDA has no int64 matmul, so
    the products are summed one inner index at a time."""
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64,
                      device=a.device)
    for k in range(a.shape[1]):
        out += a[:, k, None] * b[None, k, :]
    return out


def _stable_argsort(x: torch.Tensor, dim: int = -1,
                    descending: bool = False) -> torch.Tensor:
    return torch.sort(x, dim=dim, stable=True, descending=descending).indices


class PlacementCache:
    """Shared-subproblem store for ``optimal_placement_fast`` across a
    whole enumeration (one instance per (model, phase, SLO, workload);
    threaded through ``generate_templates`` from ``build_library``).

    Per stage count S it keeps a growing (G, L) tensor of summed T̂ rows
    on ``device``, one row per distinct stage group (sub-multiset of
    configs) seen so far, plus the per-config base rows. ``solve`` gathers
    the rows of every partition of a combo and applies the closed-form
    bottleneck optimum (module docstring, solver 3) in one batched pass
    per S.

    ``solve_batch``/``solve_batch_counts`` accept per-combo *incumbent*
    throughputs: a combo's search starts from its incumbent and only
    partitions whose upper bound exceeds it are evaluated; the result is
    ``None`` when nothing strictly beats the incumbent (a lossless
    dominated-combo prune: throughput is monotone non-decreasing under
    adding nodes). Two bounds do the partition-level pruning:

    * ``tcap`` — min over stages of the 1-layer row value (exact cap);
    * the aggregate bound ``R_S[ceil(L/S)-1]`` where ``R_S`` is the
      pointwise sum of *all* member rows at budget S, computed for a
      batch as one matvec per S and inflated by ``_UB_INFLATE``.

    Stage groups are interned by packed integer code (``CODE_BITS`` bits
    per config) so batch lookups are tensor ops; combos whose counts or
    config universe overflow the packing take the tuple-keyed path
    (``_solve_legacy``), which shares the same row store.
    """

    def __init__(self, tables: Callable[[str, int], torch.Tensor], L: int,
                 device=None):
        self.tables = tables
        self.L = L
        self.device = resolve_device(device)
        self._base: Dict[int, Dict[str, torch.Tensor]] = {}  # S -> name -> row
        self._gid: Dict[int, Dict[Tuple, int]] = {}         # S -> group -> gid
        self._codegid: Dict[int, Dict[int, int]] = {}       # S -> code -> gid
        self._key: Dict[int, List[Tuple]] = {}              # S -> gid -> group
        self._rows: Dict[int, torch.Tensor] = {}            # S -> (cap, L)
        self._n: Dict[int, int] = {}                        # S -> used rows
        self._pending: Dict[int, List[int]] = {}            # S -> unsummed gids
        self._cfg_idx: Dict[str, int] = {}                  # name -> code slot
        self._cfg_names: List[str] = []
        self._stage_names: Dict[int, Dict[int, Tuple[str, ...]]] = {}

    # ------------------------------------------------------ group registry
    def _base_row(self, name: str, S: int) -> torch.Tensor:
        per = self._base.setdefault(S, {})
        row = per.get(name)
        if row is None:
            row = per[name] = torch.as_tensor(
                self.tables(name, S), dtype=torch.float64).to(self.device)
        return row

    def _register_cfgs(self, names: Sequence[str]) -> List[int]:
        """Packed-code slots for ``names``, assigning new slots on first
        appearance. Slot order is first-appearance order; only identity
        matters (codes are internal to this cache instance)."""
        idx = self._cfg_idx
        for nm in names:
            if nm not in idx:
                idx[nm] = len(self._cfg_names)
                self._cfg_names.append(nm)
        return [idx[nm] for nm in names]

    def _register_key(self, S: int, key: Tuple[Tuple[str, int], ...]) -> int:
        """gid for group ``key`` ((name, count) tuples, name-sorted),
        registering it if unseen; its row is summed at the next
        ``_flush``."""
        gid = self._gid.setdefault(S, {})
        g = gid.get(key)
        if g is not None:
            return g
        rows = self._rows.get(S)
        if rows is None:
            rows = self._rows[S] = torch.zeros((64, self.L),
                                               dtype=torch.float64,
                                               device=self.device)
            self._n[S] = 0
        g = gid[key] = self._n[S]
        self._key.setdefault(S, []).append(key)
        self._n[S] += 1
        if g >= rows.shape[0]:
            self._rows[S] = torch.cat([rows, torch.zeros_like(rows)])
        self._pending.setdefault(S, []).append(g)
        return g

    def _flush(self, S: int) -> None:
        """Sum the rows of every group registered since the last flush:
        member by member in sorted-name order — the reference's
        ``acc += base`` sequence, one vectorized add per member position
        over all new groups (a padded position adds an exact 0)."""
        gids = self._pending.pop(S, None)
        if not gids:
            return
        keys = [self._key[S][g] for g in gids]
        names = sorted({nm for key in keys for nm, _ in key})
        slot = {nm: i + 1 for i, nm in enumerate(names)}
        base = torch.stack([torch.zeros(self.L, dtype=torch.float64,
                                        device=self.device)]
                           + [self._base_row(nm, S) for nm in names])
        members = [[slot[nm] for nm, cnt in key for _ in range(cnt)]
                   for key in keys]
        width = max(len(m) for m in members)
        idx = torch.tensor([m + [0] * (width - len(m)) for m in members],
                           dtype=torch.int64, device=self.device)
        acc = torch.zeros((len(gids), self.L), dtype=torch.float64,
                          device=self.device)
        for k in range(width):
            acc = acc + base[idx[:, k]]
        self._rows[S][torch.tensor(gids, device=self.device)] = acc

    def _rows_of(self, S: int) -> torch.Tensor:
        self._flush(S)
        return self._rows[S][:self._n[S]]

    def _group_rows(self, S: int, keys: List[Tuple[Tuple[str, int], ...]]
                    ) -> List[int]:
        """gids for group ``keys``, registering unseen groups."""
        return [self._register_key(S, key) for key in keys]

    def _map_codes(self, S: int, codes: torch.Tensor) -> torch.Tensor:
        """gids for a tensor of packed group codes, registering unseen
        codes (decoded into name-sorted keys, so rows are accumulated
        exactly as in the tuple-keyed path). The batch's unique codes
        cross to the host for the dict lookup."""
        cg = self._codegid.setdefault(S, {})
        uniq, inv = torch.unique(codes.reshape(-1), return_inverse=True)
        gid_u = []
        for c in uniq.tolist():
            g = cg.get(c)
            if g is None:
                items = []
                for k, nm in enumerate(self._cfg_names):
                    cnt = (c >> (CODE_BITS * k)) & CODE_MASK
                    if cnt:
                        items.append((nm, cnt))
                g = cg[c] = self._register_key(S, tuple(sorted(items)))
            gid_u.append(g)
        gid_u = torch.tensor(gid_u, dtype=torch.int64, device=self.device)
        return gid_u[inv].reshape(codes.shape)

    # -------------------------------------------------------------- solve
    def solve(self, node_names: Sequence[str],
              max_stages: Optional[int] = None) -> Optional[Placement]:
        return self.solve_batch([node_names], max_stages=max_stages)[0]

    def solve_batch(self, combos: Sequence[Sequence[str]],
                    max_stages: Optional[int] = None,
                    incumbents=None) -> List[Optional[Placement]]:
        """``solve`` over many combos at once, batched by shape (combos
        with the same count signature share their partition structure, so
        the whole (combo, partition) grid evaluates in a few tensor ops).
        ``incumbents`` (optional, per combo): only return a placement when
        its throughput strictly beats the incumbent."""
        combos = [list(names) for names in combos]
        uni = sorted({n for names in combos for n in names})
        counts = np.zeros((len(combos), len(uni)), dtype=np.int64)
        ix = {n: i for i, n in enumerate(uni)}
        for ci, names in enumerate(combos):
            for n in names:
                counts[ci, ix[n]] += 1
        return self.solve_batch_counts(counts, uni, max_stages=max_stages,
                                       incumbents=incumbents)

    def solve_batch_counts(self, counts, names: Sequence[str],
                           max_stages: Optional[int] = None,
                           incumbents=None) -> List[Optional[Placement]]:
        """Tensor-native ``solve_batch``: ``counts`` is an (N, len(names))
        matrix of node counts per combo (numpy or a tensor)."""
        return self.placements(*self.solve_counts(
            counts, names, max_stages=max_stages, incumbents=incumbents))

    def solve_counts(self, counts, names: Sequence[str],
                     max_stages: Optional[int] = None, incumbents=None):
        """The device half of ``solve_batch_counts``: returns ``(bestT,
        bestS, bestG)`` on the cache's device — per combo the best
        throughput (the incumbent where nothing beat it), its stage count
        (0: nothing beat the incumbent) and its stage groups' gids in the
        first ``bestS`` columns."""
        dev = self.device
        counts = torch.as_tensor(counts, dtype=torch.int64).to(dev)
        N, K = counts.shape
        bestT = (torch.zeros(N, dtype=torch.float64, device=dev)
                 if incumbents is None else
                 torch.as_tensor(incumbents, dtype=torch.float64)
                 .to(dev).clone())
        names = list(names)
        if N == 0:
            return bestT, torch.zeros(0, dtype=torch.int64, device=dev), \
                torch.zeros((0, 0), dtype=torch.int64, device=dev)
        slots = self._register_cfgs(names)
        if (int(counts.max()) > CODE_MASK
                or len(self._cfg_names) * CODE_BITS > 62):
            rows = counts.tolist()
            name_lists = [[names[i] for i in range(K) for _ in range(row[i])]
                          for row in rows]
            return self._solve_legacy(name_lists, max_stages, bestT)
        L = self.L
        sizes = counts.sum(dim=1)
        width = min(max_stages or L, L, int(sizes.max()))
        bestS = torch.zeros(N, dtype=torch.int64, device=dev)
        bestG = torch.zeros((N, max(width, 1)), dtype=torch.int64, device=dev)
        # canonical per-row label order: count desc, then name asc
        order = torch.tensor(sorted(range(K), key=lambda i: names[i]),
                             dtype=torch.int64, device=dev)
        perm = order[_stable_argsort(-counts[:, order], dim=1)]
        csort = torch.gather(counts, 1, perm)
        shapes, sinv = torch.unique(csort, dim=0, return_inverse=True)
        by_shape = _stable_argsort(sinv)
        n_per = torch.bincount(sinv, minlength=shapes.shape[0]).tolist()
        pow_slot = torch.tensor([1 << (CODE_BITS * s) for s in slots],
                                dtype=torch.int64, device=dev)
        counts_f = counts.to(torch.float64)
        ub_cols: Dict[int, torch.Tensor] = {}     # S -> per-name R_S[kidx]
        off = 0
        for srow, n_members in zip(shapes.tolist(), n_per):
            members = by_shape[off:off + n_members]
            off += n_members
            m = sum(1 for x in srow if x)
            if m == 0:
                continue
            shape = tuple(srow[:m])
            Kn = sum(srow)
            smax = min(max_stages or Kn, Kn, L)
            cgroups, CG, plan = _shape_plan(shape, dev)
            lab_pow = pow_slot[perm[members][:, :m]]       # (C, m)
            codes_all = _int_matmul(lab_pow, CG.T)         # (C, cgroups)
            # pass 1: per-S aggregate bound, group registration and the
            # per-partition cap for combos still above their incumbent
            passes = []
            for S in sorted(plan):
                if S > smax:
                    continue
                col = ub_cols.get(S)
                if col is None:
                    kidx = (L + S - 1) // S - 1
                    col = ub_cols[S] = torch.stack(
                        [self._base_row(nm, S)[kidx] for nm in names])
                ub = (counts_f[members] @ col) * _UB_INFLATE
                aidx = torch.nonzero(ub > bestT[members])[:, 0]
                if not aidx.numel():
                    continue
                used, local_idx = plan[S]
                gids = self._map_codes(S, codes_all[aidx][:, used])
                rows = self._rows_of(S)
                grid = gids[:, local_idx]                  # (A, P, S)
                bound = rows[:, 0][grid].amin(dim=2)       # (A, P)
                bound = torch.minimum(bound, ub[aidx, None])
                passes.append((float(bound.max()), S, members[aidx], grid,
                               bound, rows))
            # pass 2: visit S levels best-bound-first so the strongest
            # incumbent forms early; bound <= bestT prunes the rest
            passes.sort(key=lambda p: -p[0])
            for _, S, gidx, grid, bound, rows in passes:
                self._select(S, gidx, grid, bound, rows, bestT, bestS, bestG)
        return bestT, bestS, bestG

    def _select(self, S, gidx, grid, bound, rows, bestT, bestS, bestG):
        """The L-th-largest selection over the live (combo, partition)
        pairs of one S, updating the best of each combo in place."""
        L = self.L
        A, P = bound.shape
        chunk = max(1, _GRID_ELEMS // max(P * S * L, 1))
        for c0 in range(0, A, chunk):
            gi = gidx[c0:c0 + chunk]
            bc = bound[c0:c0 + chunk]
            live = torch.nonzero(bc > bestT[gi, None])
            if not live.shape[0]:
                continue
            idx = (live[:, 0], live[:, 1])
            g = grid[c0:c0 + chunk]
            vals = rows[g[idx]].reshape(live.shape[0], S * L)
            # the L-th largest entry: the least of the L largest (equal to
            # the reference's np.partition pick; faster than kthvalue)
            vL = torch.topk(vals, L, dim=1, sorted=False).values.amin(dim=1)
            T = torch.where(vL <= 0, 0.0, torch.minimum(vL, bc[idx]))
            Tf = torch.zeros(bc.shape, dtype=torch.float64, device=bc.device)
            Tf[idx] = T
            pbest = torch.argmax(Tf, dim=1)
            tbest = Tf.gather(1, pbest[:, None])[:, 0]
            imp = torch.nonzero(tbest > bestT[gi])[:, 0]
            ci = gi[imp]
            bestT[ci] = tbest[imp]
            bestS[ci] = S
            bestG[ci, :S] = g[imp, pbest[imp]]

    def _solve_legacy(self, combos: Sequence[Sequence[str]],
                      max_stages: Optional[int], bestT: torch.Tensor):
        """Tuple-keyed path for combos whose counts or config universe
        overflow the packed codes. Same optima (and the same row store)
        as the packed path; no aggregate R_S bound. Returns ``(bestT,
        bestS, bestG)`` as ``solve_counts`` does."""
        dev = self.device
        N = len(combos)
        L = self.L
        by_shape: Dict[Tuple[int, ...], List[Tuple[int, List[str]]]] = {}
        for ci, names in enumerate(combos):
            counts: Dict[str, int] = {}
            for n in names:
                counts[n] = counts.get(n, 0) + 1
            by_count = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
            shape = tuple(n for _, n in by_count)
            labels = [name for name, _ in by_count]
            by_shape.setdefault(shape, []).append((ci, labels))
        width = min(max_stages or L, L, max(len(c) for c in combos))
        bestS = torch.zeros(N, dtype=torch.int64, device=dev)
        bestG = torch.zeros((N, max(width, 1)), dtype=torch.int64, device=dev)
        for shape, members in by_shape.items():
            cgroups, _, plan = _shape_plan(shape, dev)
            K = sum(shape)
            smax = min(max_stages or K, K, L)
            gidx = torch.tensor([ci for ci, _ in members], dtype=torch.int64,
                                device=dev)
            keys_per = [[None] * len(cgroups) for _ in members]
            # pass 1: register groups and compute the cheap tcap bound
            # (min over stages of the 1-layer value) for every S
            passes = []
            for S in sorted(plan):
                if S > smax:
                    continue
                used, local_idx = plan[S]
                lookups = []
                for i, (ci, labels) in enumerate(members):
                    keys = keys_per[i]
                    for u in used.tolist():
                        if keys[u] is None:
                            keys[u] = tuple(sorted(
                                (labels[lbl], cnt)
                                for lbl, cnt in cgroups[u]))
                    lookups.append(self._group_rows(
                        S, [keys[u] for u in used.tolist()]))
                rows = self._rows_of(S)
                gids = torch.tensor(lookups, dtype=torch.int64,
                                    device=dev)[:, local_idx]   # (C, P, S)
                tcap = rows[:, 0][gids].amin(dim=2)             # (C, P)
                passes.append((float(tcap.max()), S, gids, tcap, rows))
            passes.sort(key=lambda p: -p[0])
            for _, S, gids, tcap, rows in passes:
                self._select(S, gidx, gids, tcap, rows, bestT, bestS, bestG)
        return bestT, bestS, bestG

    def _names_of(self, S: int, gid: int) -> Tuple[str, ...]:
        memo = self._stage_names.setdefault(S, {})
        out = memo.get(gid)
        if out is None:
            out = memo[gid] = tuple(sorted(
                n for name, cnt in self._key[S][gid] for n in [name] * cnt))
        return out

    def placements(self, bestT: torch.Tensor, bestS: torch.Tensor,
                   bestG: torch.Tensor) -> List[Optional[Placement]]:
        """The host half: one ``Placement`` per combo whose stage count is
        set, ``None`` for the rest. Each stage's layer budget (how many
        entries of its row reach T) is counted on the device for all
        combos of one S at once; the groups' names and the layer split
        come from the host registries."""
        N = bestS.shape[0]
        results: List[Optional[Placement]] = [None] * N
        found = torch.nonzero(bestS > 0)[:, 0]
        if not found.numel():
            return results
        S_f = bestS[found]
        for S in torch.unique(S_f).tolist():
            ci = found[S_f == S]
            T = bestT[ci]
            g = bestG[ci, :S]
            js = (self._rows_of(S)[g] >= T[:, None, None]).sum(dim=2)
            for c, t, gl, jl in zip(ci.tolist(), T.tolist(), g.tolist(),
                                    js.tolist()):
                named = sorted((self._names_of(S, gid), gid, j)
                               for gid, j in zip(gl, jl))
                # layer split: same distribution rule as the reference
                counts = _layer_split(S, self.L, [j for _, _, j in named])
                results[c] = Placement(S, tuple(counts),
                                       tuple(n for n, _, _ in named), t)
        return results


def optimal_placement_fast(node_names: Sequence[str],
                           tables: Callable[[str, int], torch.Tensor],
                           L: int,
                           max_stages: Optional[int] = None,
                           cache: Optional[PlacementCache] = None
                           ) -> Optional[Placement]:
    """Drop-in equivalent of ``optimal_placement_exact`` (same optimum;
    stage grouping may differ only between equal-throughput ties). Pass a
    shared ``cache`` when solving many combos over one config universe;
    without one, the cache lies on the tables' device."""
    if cache is None:
        cache = PlacementCache(tables, L,
                               device=tables(node_names[0], 1).device)
    return cache.solve(node_names, max_stages=max_stages)


# -------------------------------------------------------------- paper ILP
def optimal_placement_ilp(node_names: Sequence[str],
                          tables: Callable[[str, int], torch.Tensor],
                          L: int,
                          max_stages: Optional[int] = None,
                          time_limit: float = 30.0) -> Optional[Placement]:
    """The paper's ILP, solved per S and maximized over S in [1, |G'|].
    The rows cross to the host (``to_host``) for HiGHS."""
    names = list(node_names)
    K = len(names)
    max_stages = min(max_stages or K, K)
    best: Optional[Placement] = None

    for S in range(1, max_stages + 1):
        that = np.stack([to_host(tables(n, S)) for n in names])   # (K, L)
        tmax = float(that.sum(0).max())
        if tmax <= 0:
            continue
        mdl = MilpModel()
        T = mdl.add_var(obj=-1.0, lb=0.0, ub=tmax * K)
        x = [[mdl.add_var(integer=True, ub=1) for _ in range(L)]
             for _ in range(S)]
        y = [[mdl.add_var(integer=True, ub=1) for _ in range(K)]
             for _ in range(S)]
        z = {}
        for s in range(S):
            for j in range(L):
                for k in range(K):
                    if that[k, j] <= 0:
                        continue
                    v = mdl.add_var(integer=True, ub=1)
                    z[s, j, k] = v
                    mdl.add_constr({v: 1, x[s][j]: -1}, ub=0)
                    mdl.add_constr({v: 1, y[s][k]: -1}, ub=0)
                    mdl.add_constr({v: 1, x[s][j]: -1, y[s][k]: -1}, lb=-1)
        for s in range(S):
            mdl.add_constr({x[s][j]: 1 for j in range(L)}, lb=1, ub=1)
            coeffs = {T: 1.0}
            for (s2, j, k), v in z.items():
                if s2 == s:
                    coeffs[v] = coeffs.get(v, 0.0) - float(that[k, j])
            mdl.add_constr(coeffs, ub=0)
        for k in range(K):
            mdl.add_constr({y[s][k]: 1 for s in range(S)}, lb=1, ub=1)
        mdl.add_constr({x[s][j]: j + 1 for s in range(S) for j in range(L)},
                       lb=L, ub=L)
        res = mdl.solve(time_limit=time_limit)
        if not res.ok:
            continue
        tput = -res.obj
        if tput <= 0:
            continue
        counts, stage_nodes = [], []
        for s in range(S):
            j = int(np.argmax([res.x[x[s][j]] for j in range(L)])) + 1
            counts.append(j)
            stage_nodes.append(tuple(sorted(
                names[k] for k in range(K) if res.x[y[s][k]] > 0.5)))
        cand = Placement(S, tuple(counts), tuple(stage_nodes), float(tput))
        if best is None or cand.throughput > best.throughput + 1e-9:
            best = cand
    return best
