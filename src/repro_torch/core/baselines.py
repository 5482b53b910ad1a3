"""Baselines from the paper's evaluation (§6.1, §6.6).

* Homo — SkyServe/SageServe-style: each replica on homogeneous hardware
  (heterogeneity only across replicas); greedily instantiates the most
  cost-efficient (throughput per USD) homogeneous template per model, in
  isolation, consuming availability in sequence.
* Cauchy — per-model ILP over homogeneous-per-replica templates with
  phase-specific GPU combos (prefill and decode pools may differ; a
  prefill replica may feed multiple decode replicas), cost-efficiency in
  the objective, still no cross-model coordination.
* Helix-style — single-model monolithic placement over a *fixed* node
  pool: all nodes in one PP x DP pipeline, stages grouped by device type
  (an approximation of Helix's max-flow placement).

Where they run: the libraries and columns on the library's device, as
Coral's; the greedy Homo allocation is a Python loop over template objects
on the host, and the Cauchy ILPs cross to HiGHS with ``to_host``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.allocator import (MIP_GAP, Allocation, AllocProblem,
                                        availability_caps,
                                        availability_row_coo,
                                        availability_row_index)
from repro_torch.core.hardware import NodeConfig
from repro_torch.core.modelspec import ServedModel
from repro_torch.core.placement import (Placement, PlacementCache,
                                        _bottleneck_search, _layer_split)
from repro_torch.core.profiles import ProfileTable, WorkloadStats, exact_div
from repro_torch.core.templates import (ServingTemplate, TemplateLibrary,
                                        generate_templates)
from repro_torch.kernels.common import resolve_device
from repro_torch.solver.milp import MilpModel, to_host


def homo_library(models: Sequence[ServedModel], configs: Sequence[NodeConfig],
                 workloads: Dict[str, WorkloadStats], n_max: int = 6,
                 rho: float = 12.0, device=None) -> TemplateLibrary:
    """Template library restricted to single-config-type combinations.

    Goes through the same fast placement path as ``build_library``: one
    ``PlacementCache`` per (model, phase) is shared across the per-config
    sub-universes, so the homogeneous stage groups (k identical nodes
    under a given S) are solved once each. ``device``: ``cuda`` unless
    the caller passes another.
    """
    dev = resolve_device(device)
    lib = TemplateLibrary(config_by_name={c.name: c for c in configs},
                          device=dev)
    by_name = {c.name: c for c in configs}
    for m in models:
        wl = workloads[m.name]
        for phase in ("prefill", "decode"):
            slo = m.prefill_slo_ms if phase == "prefill" else m.decode_slo_ms
            pt = ProfileTable(m, phase, slo, wl, device=dev)
            cache = PlacementCache(
                lambda n, S, _pt=pt: _pt.table(by_name[n], S), m.n_layers,
                device=dev)
            temps: List[ServingTemplate] = []
            for c in configs:
                t, _ = generate_templates(m, phase, [c], wl, n_max=n_max,
                                          rho=rho, prune=True, cache=cache)
                temps.extend(t)
            lib.add((m.name, phase), temps, {"homo": True})
    return lib


def _consume(avail: Dict, region: str, t: ServingTemplate, n: int):
    for c, k in t.counts:
        avail[(region, c)] -= k * n


def _max_instances(avail: Dict, region: str, t: ServingTemplate) -> int:
    return min((avail.get((region, c), 0) // k for c, k in t.counts
                if k > 0), default=0)


def homo_allocate(p: AllocProblem, lib: TemplateLibrary) -> Allocation:
    """Greedy per-model best cost-efficiency homogeneous allocation."""
    avail = dict(p.availability)
    cfg = lib.config_by_name
    instances: Dict[Tuple[str, Tuple], int] = {}
    tmpl: Dict[Tuple, ServingTemplate] = {}
    cost = 0.0
    unmet: Dict[Tuple[str, str], float] = {}
    for dem in p.demands:
        left = dem.tokens_per_s
        cands = []
        for t in lib.get(dem.model, dem.phase):
            for r in p.regions:
                price = t.cost(r, cfg)
                cands.append((price / max(t.throughput, 1e-9), r, t))
        cands.sort(key=lambda x: x[0])
        for _, r, t in cands:
            if left <= 1e-9:
                break
            n = min(_max_instances(avail, r.name, t),
                    int(np.ceil(left / t.throughput)))
            if n <= 0:
                continue
            _consume(avail, r.name, t, n)
            instances[(r.name, t.key)] = instances.get((r.name, t.key), 0) + n
            tmpl[t.key] = t
            cost += n * t.cost(r, cfg)
            left -= n * t.throughput
        if left > 1e-6:
            unmet[(dem.model, dem.phase)] = left
    return Allocation(instances, tmpl, cost, 0.0, unmet, 0.0, 0, True)


def cauchy_allocate(p: AllocProblem, lib: TemplateLibrary) -> Allocation:
    """Per-model ILP over homogeneous templates (phases jointly, models
    sequentially — cost efficiency in the objective, no cross-model
    coordination).

    Assembled columnar: each (model, phase) block comes straight from
    ``lib.columns()`` tensors on the library's device (per-region cost
    via one ``usage @ price.T`` matmul, vectorized availability/demand
    caps) and crosses to the host once per model (``to_host``) for the
    MILP's batched ``add_vars`` / ``add_constrs_coo``.
    """
    regions = list(p.regions)
    R = len(regions)
    avail = dict(p.availability)
    instances: Dict[Tuple[str, Tuple], int] = {}
    tmpl: Dict[Tuple, ServingTemplate] = {}
    total_cost = 0.0
    unmet: Dict[Tuple[str, str], float] = {}
    models = sorted({d.model for d in p.demands})
    for mname in models:
        dems = [d for d in p.demands if d.model == mname]
        mdl = MilpModel()
        blocks = []                 # (dem, cols, cost (T,R), base)
        V = 0
        for dem in dems:
            cols = lib.columns(dem.model, dem.phase)
            if cols.n == 0:
                blocks.append((dem, None, None, V))
                continue
            cost = cols.region_cost(regions)
            blocks.append((dem, cols, cost, V))
            V += cols.n * R
        if V == 0:
            for dem in dems:
                unmet[(dem.model, dem.phase)] = dem.tokens_per_s
            continue
        cnames = next(c for _, c, _, _ in blocks
                      if c is not None).config_names
        C = len(cnames)
        dev = next(c for _, c, _, _ in blocks if c is not None).device
        avail_mat = torch.zeros((R, C), dtype=torch.float64, device=dev)
        for r in range(R):
            for ci, cn in enumerate(cnames):
                avail_mat[r, ci] = avail.get((regions[r].name, cn), 0)

        v_obj = torch.empty(V, dtype=torch.float64, device=dev)
        v_ub = torch.empty(V, dtype=torch.float64, device=dev)
        v_keys: List[Tuple[str, Tuple]] = [None] * V
        coo_d, coo_r, coo_c = [], [], []
        for dem, cols, cost, base in blocks:
            if cols is None:
                continue
            n = cols.n
            dem_cap = torch.ceil(exact_div(
                float(dem.tokens_per_s),
                torch.clamp_min(cols.throughput, 1e-9))) + 1
            caps = torch.clamp_min(torch.minimum(
                availability_caps(avail_mat, cols.usage), dem_cap), 0)
            for t in cols.templates:
                tmpl[t.key] = t
            for r in range(R):
                lo = base + r * n
                v_obj[lo:lo + n] = cost[:, r]
                v_ub[lo:lo + n] = caps[r]
                rname = regions[r].name
                for i, t in enumerate(cols.templates):
                    v_keys[lo + i] = (rname, t.key)

        # availability rows, one per (region, used config)
        row_of, a_rix, a_cix = availability_row_index(
            [cols.usage for _, cols, _, _ in blocks if cols is not None],
            R, C)
        avail_rhs = avail_mat[a_rix, a_cix]
        for dem, cols, cost, base in blocks:
            if cols is None:
                continue
            d, r_, c_ = availability_row_coo(cols.usage, base, R, row_of)
            coo_d += d
            coo_r += r_
            coo_c += c_
        n_avail = avail_rhs.shape[0]

        # demand rows: served + s >= tokens, shortfall penalized at
        # ~100x the worst $/tok/s of the model's own template pool
        s_obj, s_ub, dem_rhs = [], [], []
        i64 = dict(dtype=torch.int64, device=dev)
        for di, (dem, cols, cost, base) in enumerate(blocks):
            if cols is not None:
                worst = float((cost / torch.clamp_min(
                    cols.throughput, 1e-9)[:, None]).max())
                s_obj.append(100.0 * worst)
                coo_d.append(cols.throughput.repeat(R))
                coo_r.append(torch.full((cols.n * R,), n_avail + di, **i64))
                coo_c.append(base + torch.arange(cols.n * R, **i64))
            else:
                s_obj.append(1e5)
            s_ub.append(dem.tokens_per_s)
            dem_rhs.append(dem.tokens_per_s)
            coo_d.append(torch.ones(1, dtype=torch.float64, device=dev))
            coo_r.append(torch.tensor([n_avail + di], **i64))
            coo_c.append(torch.tensor([V + di], **i64))

        # crossing: the model's columns to the host, for HiGHS
        v_obj, v_ub = to_host(v_obj), to_host(v_ub)
        avail_rhs = to_host(avail_rhs)
        coo_d = to_host(torch.cat(coo_d))
        coo_r = to_host(torch.cat(coo_r))
        coo_c = to_host(torch.cat(coo_c))
        mdl.add_vars(v_obj, 0.0, v_ub, True)
        mdl.add_vars(np.array(s_obj), 0.0, np.array(s_ub), False)
        row_lb = np.concatenate([np.full(n_avail, -np.inf),
                                 np.array(dem_rhs)])
        row_ub = np.concatenate([np.array(avail_rhs),
                                 np.full(len(dems), np.inf)])
        mdl.add_constrs_coo(coo_d, coo_r, coo_c, lb=row_lb, ub=row_ub)
        res = mdl.solve(time_limit=p.time_limit, gap=MIP_GAP)
        if not res.ok:
            for dem in dems:
                unmet[(dem.model, dem.phase)] = dem.tokens_per_s
            continue
        counts = np.rint(res.x[:V]).astype(np.int64)
        for i in np.nonzero(counts > 0)[0]:
            rname, tkey = v_keys[i]
            t = tmpl[tkey]
            n = int(counts[i])
            _consume(avail, rname, t, n)
            instances[(rname, tkey)] = instances.get((rname, tkey), 0) + n
            total_cost += n * float(v_obj[i])
        for di, dem in enumerate(dems):
            s = res.x[V + di]
            if s > 1e-6:
                unmet[(dem.model, dem.phase)] = float(s)
    return Allocation(instances, tmpl, total_cost, 0.0, unmet, 0.0, 0, True)


# ------------------------------------------------------------- Helix-style
def helix_placement(model: ServedModel, phase: str, wl: WorkloadStats,
                    nodes: List[NodeConfig], slo_ms: Optional[float] = None,
                    device=None) -> Optional[Placement]:
    """Monolithic pipeline over the full pool, nodes grouped by type.

    Enumerates ordered merges of the type groups into stages (devices of
    one type stay together) and optimizes the layer split with the same
    bottleneck search as the exact solver, on ``device`` (``cuda``
    unless the caller passes another).
    """
    slo = slo_ms if slo_ms is not None else (
        model.prefill_slo_ms if phase == "prefill" else model.decode_slo_ms)
    pt = ProfileTable(model, phase, slo, wl, max_stages=32, device=device)
    by_name = {}
    for n in nodes:
        by_name[n.name] = n
    names = [n.name for n in nodes]
    types: Dict[str, List[str]] = {}
    for n in names:
        types.setdefault(n, []).append(n)
    groups = list(types.values())
    G = len(groups)
    best = None

    def split_variants(i, cur):
        """Each type group may split into 1..4 near-equal sub-stages
        (Helix's max-flow lets same-type nodes hold different layer
        ranges; strict type-grouped stages can be infeasible when no
        single node class can hold L/G layers)."""
        if i == G:
            yield [list(st) for st in cur]
            return
        g = groups[i]
        for s in range(1, min(4, len(g)) + 1):
            size = len(g) // s
            subs, off = [], 0
            for k in range(s):
                extra = 1 if k < len(g) % s else 0
                subs.append(g[off:off + size + extra])
                off += size + extra
            cur.extend(subs)
            yield from split_variants(i + 1, cur)
            del cur[-len(subs):]

    for stages in split_variants(0, []):
        S = len(stages)
        if S > model.n_layers:
            continue
        tables = lambda nm, S_: pt.table(by_name[nm], S_)
        found = _bottleneck_search(
            [sum(tables(nm, S) for nm in st) for st in stages],
            model.n_layers)
        if found is None:
            continue
        T, js = found
        counts = _layer_split(S, model.n_layers, js)
        if counts is None:
            continue
        pl = Placement(S, tuple(counts),
                       tuple(tuple(sorted(st)) for st in stages), T)
        if best is None or pl.throughput > best.throughput:
            best = pl
    return best
