"""Serving Template generation (paper §4.2).

Offline: for each (model, phase, SLO), enumerate node combinations with
at most ``n_max`` nodes and total memory within [fit, rho x model size],
and compute the throughput-optimal placement on each — yielding the
Serving Template Library the online allocator consumes.

Usage-dominance Pareto pruning (as in the reference): a template is
dropped if another template of the same (model, phase) has >= throughput
and <= node usage of *every* config; lossless for the online ILP.
Throughput ties break toward the smaller usage (``_template_order_key``).

The default ``solver="fast"`` path threads one ``PlacementCache`` per
(model, phase) through a *level-wise frontier* (``_frontier_generate``):
combos grow one node at a time and each is solved with its best
enumerated sub-combo throughput as the incumbent, so dominated combos are
discharged at the partition-bound stage and the post-prune template set
falls out of the enumeration directly.

Where it runs: ``build_library`` and ``generate_templates`` take
``device`` (``cuda`` unless the caller passes another; no card raises).
The frontier's count rows, codes, memory sums and master arrays, the
placement cache's rows and the library's columns are tensors there. The
host builds one ``Placement`` and one ``ServingTemplate`` per emitted
combo in Python, after the device work; ``stats`` holds the two times
apart (``device_seconds``, ``host_seconds``). Template sets equal the
reference's bit for bit: keys, counts, placements and throughputs.
"""
from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hardware import NodeConfig
from repro_torch.core.modelspec import ServedModel
from repro_torch.core.placement import (Placement, PlacementCache,
                                        _int_matmul, _stable_argsort,
                                        optimal_placement_exact,
                                        optimal_placement_ilp)
from repro_torch.core.profiles import ProfileTable, WorkloadStats
from repro_torch.kernels.common import resolve_device


@dataclass(frozen=True)
class ServingTemplate:
    model: str
    phase: str                              # prefill | decode
    slo_ms: float
    counts: Tuple[Tuple[str, int], ...]     # sorted (config_name, n)
    placement: Placement
    throughput: float

    @property
    def key(self) -> Tuple:
        return (self.model, self.phase, self.counts)

    @property
    def n_nodes(self) -> int:
        return sum(n for _, n in self.counts)

    def usage(self) -> Dict[str, int]:
        return dict(self.counts)

    def cost(self, region, config_by_name: Dict[str, NodeConfig]) -> float:
        return sum(region.node_usd_per_hour(config_by_name[c]) * n
                   for c, n in self.counts)


def enumerate_combos(configs: Sequence[NodeConfig], n_max: int,
                     mem_lo_gb: float, mem_hi_gb: float
                     ) -> Iterable[Tuple[NodeConfig, ...]]:
    """Multisets of <= n_max nodes with total memory in [lo, hi]."""
    cfgs = sorted(configs, key=lambda c: c.mem_gb)

    def rec(start: int, left: int, mem: float, acc):
        if mem >= mem_lo_gb:
            yield tuple(acc)
        if left == 0:
            return
        for i in range(start, len(cfgs)):
            m = cfgs[i].mem_gb
            if mem + m > mem_hi_gb:
                continue
            acc.append(cfgs[i])
            yield from rec(i, left - 1, mem + m, acc)
            acc.pop()

    yield from rec(0, n_max, 0.0, [])


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (a time read after it is true)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class LibraryColumns:
    """Columnar (tensor) view of one (model, phase) template set.

    The online allocator consumes templates as tensors on the library's
    device, not objects: ``usage`` is the (templates x configs) node-usage
    matrix over the library-wide sorted config universe, ``throughput``
    the matching tokens/s vector. ``region_cost(regions)`` collapses
    per-template per-region provisioning cost into one
    ``usage @ price.T`` matmul.
    """
    templates: List[ServingTemplate]
    keys: List[Tuple]
    config_names: Tuple[str, ...]
    config_by_name: Dict[str, NodeConfig]
    usage: torch.Tensor        # (T, C) float64, counts per config
    throughput: torch.Tensor   # (T,)  float64

    @property
    def n(self) -> int:
        return len(self.templates)

    @property
    def device(self) -> torch.device:
        return self.usage.device

    def price_matrix(self, regions) -> torch.Tensor:
        """(R, C) node $/h per (region, config)."""
        return torch.tensor([[r.node_usd_per_hour(self.config_by_name[c])
                              for c in self.config_names] for r in regions],
                            dtype=torch.float64, device=self.device)

    def region_cost(self, regions) -> torch.Tensor:
        """(T, R) instance $/h of each template in each region."""
        return self.usage @ self.price_matrix(regions).T


def template_columns(temps: Sequence[ServingTemplate],
                     config_by_name: Dict[str, NodeConfig],
                     device=None) -> LibraryColumns:
    """Build the columnar view of a template list (see LibraryColumns) on
    ``device``."""
    dev = resolve_device(device)
    names = tuple(sorted(config_by_name))
    cidx = {c: i for i, c in enumerate(names)}
    usage = np.zeros((len(temps), len(names)))
    for i, t in enumerate(temps):
        for c, k in t.counts:
            usage[i, cidx[c]] = k
    thr = np.array([t.throughput for t in temps], dtype=float)
    return LibraryColumns(list(temps), [t.key for t in temps], names,
                          config_by_name,
                          torch.as_tensor(usage).to(dev),
                          torch.as_tensor(thr).to(dev))


@dataclass
class TemplateLibrary:
    templates: Dict[Tuple[str, str], List[ServingTemplate]] = field(
        default_factory=dict)
    config_by_name: Dict[str, NodeConfig] = field(default_factory=dict)
    stats: Dict[Tuple[str, str], Dict] = field(default_factory=dict)
    device: Optional[torch.device] = None   # the columns' (None: cuda)

    def get(self, model: str, phase: str) -> List[ServingTemplate]:
        return self.templates.get((model, phase), [])

    def add(self, key, temps: List[ServingTemplate], stats: Dict):
        self.templates[key] = temps
        self.stats[key] = stats
        self.__dict__.get("_columns_cache", {}).pop(key, None)

    def columns(self, model: str, phase: str) -> LibraryColumns:
        """Cached columnar view of one (model, phase) template set, on the
        library's device; ``add`` invalidates the affected pair."""
        cache = self.__dict__.setdefault("_columns_cache", {})
        key = (model, phase)
        cols = cache.get(key)
        if cols is None:
            cols = template_columns(self.get(model, phase),
                                    self.config_by_name, self.device)
            cache[key] = cols
        return cols

    @property
    def size(self) -> int:
        return sum(len(v) for v in self.templates.values())


def _template_order_key(t: ServingTemplate):
    """Deterministic dominance-compatible total order: descending
    throughput, then ascending node count, then counts. Any potential
    dominator (usage <=, throughput >=) of a template sorts strictly
    before it — equal-throughput ties are broken toward the *smaller*
    usage, so a superset that gains nothing over a sub-combo is always
    dropped."""
    return (-t.throughput, t.n_nodes, t.counts)


def pareto_prune(temps: List[ServingTemplate],
                 config_names: Sequence[str],
                 device=None) -> List[ServingTemplate]:
    """Drop usage-dominated templates (lossless, see module docstring).

    A template is dominated iff another template's usage is a
    sub-multiset of its own with throughput >= (equal-usage duplicates
    kept once). The pruned set is found by *box enumeration* on
    ``device``: hash every usage vector (packed integer code) to its best
    throughput, then probe each template's sub-multiset codes, per usage
    shape. Inputs whose counts or dimensions overflow the packing (or
    whose boxes are too large) take the blocked pairwise SWAR scan, which
    implements the same semantics.

    Output is sorted by ``_template_order_key`` (deterministic).
    """
    if not temps:
        return temps
    dev = resolve_device(device)
    order = sorted(temps, key=_template_order_key)
    names = list(config_names)
    usage = torch.tensor([[t.usage().get(c, 0) for c in names]
                          for t in order], dtype=torch.int64, device=dev)
    thr = torch.tensor([t.throughput for t in order], dtype=torch.float64,
                       device=dev)
    kept = _pareto_mask_boxes(usage, thr)
    if kept is None:
        kept = _pareto_mask_pairwise(usage)
    return [t for t, k in zip(order, kept.tolist()) if k]


def _pareto_mask_boxes(usage: torch.Tensor, thr: torch.Tensor,
                       budget: float = 5e7) -> Optional[torch.Tensor]:
    """Keep-mask over rows sorted by ``_template_order_key`` via
    sub-multiset (box) probing; ``None`` when the input doesn't fit the
    packed codes or the total box volume exceeds ``budget``."""
    n, d = usage.shape
    dev = usage.device
    bits = max(int(usage.max()).bit_length(), 1)
    if d * bits > 62:
        return None
    boxes = torch.prod(usage + 1.0, dim=1)
    if float(boxes.sum()) > budget:
        return None
    pw = torch.tensor([1 << (bits * k) for k in range(d)], dtype=torch.int64,
                      device=dev)
    codes = _int_matmul(usage, pw[:, None])[:, 0]
    uniq, inv = torch.unique(codes, return_inverse=True)
    # rows are throughput-sorted, so the first row of a code group has
    # the group's max throughput (and is the one duplicate kept)
    first = torch.full((uniq.shape[0],), n, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, inv, torch.arange(n, device=dev), "amin")
    bestT = thr[first]
    kept = torch.zeros(n, dtype=torch.bool, device=dev)
    kept[first] = True
    # per usage-shape: one delta matrix enumerates every proper
    # sub-multiset; probe codes come from one exact int product
    perm = _stable_argsort(-usage, dim=1)
    us = torch.gather(usage, 1, perm)
    shapes, sinv = torch.unique(us, dim=0, return_inverse=True)
    by_shape = _stable_argsort(sinv)
    n_per = torch.bincount(sinv, minlength=shapes.shape[0]).tolist()
    off = 0
    for srow, n_members in zip(shapes.tolist(), n_per):
        members = by_shape[off:off + n_members]
        off += n_members
        m = sum(1 for c in srow if c)
        if m == 0:
            continue
        deltas = np.array(list(itertools.product(
            *(range(c + 1) for c in srow[:m]))), dtype=np.int64)[1:]
        if not len(deltas):
            continue
        deltas = torch.from_numpy(deltas).to(dev)
        lab_pw = pw[perm[members][:, :m]]              # (C, m)
        step = max(1, int(2_000_000 // len(deltas)))
        for c0 in range(0, n_members, step):
            mem = members[c0:c0 + step]
            sub = codes[mem, None] - _int_matmul(lab_pw[c0:c0 + step],
                                                 deltas.T)
            pos = torch.searchsorted(uniq, sub)
            pos_c = torch.clamp_max(pos, uniq.shape[0] - 1)
            hit = (uniq[pos_c] == sub) & (bestT[pos_c] >= thr[mem, None])
            kept[mem] = kept[mem] & ~hit.any(dim=1)
    return kept


def _pareto_mask_pairwise(usage: torch.Tensor) -> torch.Tensor:
    """Keep-mask over rows sorted by ``_template_order_key`` via the
    blocked pairwise scan (SWAR-packed when counts <= 15): every
    already-kept row sorts before the candidate, so dominance reduces
    to componentwise usage <=. Reference semantics for the box path.
    The packing uses int64 words: 12 five-bit fields fill bits 0-59, so
    no word or difference below reaches the sign bit."""
    n, d = usage.shape
    dev = usage.device
    if int(usage.max()) <= 15:
        # pack counts into 5-bit fields, 12 configs per int64 word
        W = (d + 11) // 12
        packed = torch.zeros((n, W), dtype=torch.int64, device=dev)
        guard = [0] * W
        for c in range(d):
            w, off = divmod(c, 12)
            packed[:, w] |= usage[:, c] << (5 * off)
            guard[w] |= 1 << (5 * off + 4)

        def dominates(ku, blk):
            # (kept, cand): every 5-bit field of kept <= field of cand;
            # the guard bit of (cand | H) - kept survives iff no borrow,
            # i.e. cand_field >= kept_field
            ok = torch.ones((ku.shape[0], blk.shape[0]), dtype=torch.bool,
                            device=dev)
            for w in range(W):
                t = (blk[None, :, w] | guard[w]) - ku[:, None, w]
                ok &= (t & guard[w]) == guard[w]
            return ok
    else:
        # counts too large for the SWAR fields: plain broadcast
        # comparison, same semantics
        packed = usage

        def dominates(ku, blk):
            return (ku[:, None, :] <= blk[None, :, :]).all(dim=2)

    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    kept = torch.empty_like(packed)
    k = 0
    B, C = 256, 2048
    for b0 in range(0, n, B):
        blk = packed[b0:min(b0 + B, n)]
        cand = torch.arange(blk.shape[0], device=dev)
        # early-kept (high-throughput, low-usage) rows eliminate most of
        # a block, so scan the kept set in chunks and shrink the block
        for c0 in range(0, k, C):
            dom = dominates(kept[c0:min(c0 + C, k)], blk[cand]).any(dim=0)
            cand = cand[~dom]
            if not cand.numel():
                break
        k0 = k
        for i in cand.tolist():
            if k > k0 and bool(dominates(kept[k0:k], blk[i:i + 1]).any()):
                continue
            mask[b0 + i] = True
            kept[k] = blk[i]
            k += 1
    return mask


# bump when the produced template set changes for identical inputs, so
# cached libraries and ``build_library(reuse=...)`` invalidate cleanly
GENERATION_VERSION = 2


def generation_fingerprint(model: ServedModel, phase: str,
                           configs: Sequence[NodeConfig], wl: WorkloadStats,
                           n_max: int, rho: float, prune: bool, solver: str,
                           max_stages: Optional[int]) -> Tuple:
    """Everything the template set of one (model, phase) depends on (the
    device is not among it: every device gives the same set).

    Two generation requests with equal fingerprints produce equal
    template sets, which is what lets ``build_library(reuse=...)`` skip
    pairs whose config universe (or any other input) did not change.
    """
    cfg = tuple(sorted(configs, key=lambda c: c.name))
    return (GENERATION_VERSION, model, phase, cfg, wl, n_max, rho, prune,
            solver, max_stages)


def _frontier_generate(model: ServedModel, phase: str, slo_ms: float,
                       configs: Sequence[NodeConfig], n_max: int,
                       lo: float, hi: float, max_stages: Optional[int],
                       cache: PlacementCache,
                       solve_chunk: int = 32768) -> Optional[Tuple]:
    """Level-wise (n -> n+1) pruned enumeration + solve (fast path), on
    the cache's device.

    Grows combos one node at a time (canonical non-decreasing config
    order — the same multiset universe, memory window and fp memory
    sums as ``enumerate_combos``), carrying the best throughput of every
    *enumerated* combo in a code-indexed master array. A level-n combo is
    solved with its best enumerated immediate sub-combo throughput as the
    incumbent: a solve that fails to strictly beat it proves the combo
    usage-dominated, and a strict improvement proves no enumerated
    sub-multiset dominates it, so the emitted set *is* the
    post-``pareto_prune`` set. Dominated combos stay on the frontier (an
    extension of one can beat all its sub-combos).

    Returns ``(templates, n_combos, n_raw, n_dominated, device_s,
    host_s)`` or ``None`` when the config universe does not fit the
    frontier's packed codes (caller falls back to exhaustive
    enumeration). ``host_s`` is the Python time that builds one
    ``Placement`` and one ``ServingTemplate`` per emitted combo;
    ``device_s`` everything before it.
    """
    t0 = time.perf_counter()
    dev = cache.device
    cfgs = sorted(configs, key=lambda c: c.mem_gb)
    names = [c.name for c in cfgs]
    K = len(cfgs)
    bits = max(int(n_max).bit_length(), 1)
    if K * bits > 62:
        return None
    i64, f64 = torch.int64, torch.float64
    mems = torch.tensor([c.mem_gb for c in cfgs], dtype=f64, device=dev)
    pw = torch.tensor([1 << (bits * k) for k in range(K)], dtype=i64,
                      device=dev)
    master_codes = torch.zeros(0, dtype=i64, device=dev)
    master_T = torch.zeros(0, dtype=f64, device=dev)
    emitted = []            # (count rows, bestT, bestS, bestG) per solve
    n_combos = n_raw = 0
    cur_counts = torch.eye(K, dtype=i64, device=dev)
    cur_codes = pw.clone()
    cur_mem = mems.clone()
    cur_max = torch.arange(K, device=dev)
    keep = cur_mem <= hi
    cur_counts, cur_codes = cur_counts[keep], cur_codes[keep]
    cur_mem, cur_max = cur_mem[keep], cur_max[keep]
    for level in range(1, n_max + 1):
        if level > 1:
            parts = []
            for i in range(K):
                mask = (cur_max <= i) & (cur_mem + mems[i] <= hi)
                nc = cur_counts[mask]
                if not nc.shape[0]:
                    continue
                nc[:, i] += 1
                parts.append((nc, cur_codes[mask] + pw[i],
                              cur_mem[mask] + mems[i],
                              torch.full((nc.shape[0],), i, device=dev)))
            if not parts:
                break
            cur_counts = torch.cat([p[0] for p in parts])
            cur_codes = torch.cat([p[1] for p in parts])
            cur_mem = torch.cat([p[2] for p in parts])
            cur_max = torch.cat([p[3] for p in parts])
        sol = torch.nonzero(cur_mem >= lo)[:, 0]
        n_sol = sol.shape[0]
        if n_sol:
            sc, scode = cur_counts[sol], cur_codes[sol]
            n_combos += n_sol
            inc = torch.zeros(n_sol, dtype=f64, device=dev)
            if master_codes.numel():
                last = master_codes.shape[0] - 1
                for i in range(K):
                    hidx = torch.nonzero(sc[:, i] > 0)[:, 0]
                    if not hidx.numel():
                        continue
                    sub = scode[hidx] - pw[i]
                    pos = torch.searchsorted(master_codes, sub)
                    pos_c = torch.clamp_max(pos, last)
                    vals = torch.where(master_codes[pos_c] == sub,
                                       master_T[pos_c], 0.0)
                    inc[hidx] = torch.maximum(inc[hidx], vals)
            Ts = inc.clone()
            for c0 in range(0, n_sol, solve_chunk):
                cs = slice(c0, c0 + solve_chunk)
                # a combo's best is its incumbent unless a placement
                # strictly beat it (then bestS > 0): the reference's Ts
                bT, bS, bG = cache.solve_counts(
                    sc[cs], names, max_stages=max_stages, incumbents=inc[cs])
                Ts[cs] = bT
                emitted.append((sc[cs], bT, bS, bG))
            n_raw += int((Ts > 0).sum())
            master_codes = torch.cat([master_codes, scode])
            master_T = torch.cat([master_T, Ts])
            o = torch.argsort(master_codes)
            master_codes, master_T = master_codes[o], master_T[o]
    found = []
    for sc, bT, bS, bG in emitted:
        f = torch.nonzero(bS > 0)[:, 0]
        found.append((sc[f], bT[f], bS[f], bG[f]))
    _sync(dev)
    t1 = time.perf_counter()
    temps = []
    for sc, bT, bS, bG in found:
        for crow, pl in zip(sc.tolist(), cache.placements(bT, bS, bG)):
            cnts = tuple(sorted((names[i], c) for i, c in enumerate(crow)
                                if c))
            temps.append(ServingTemplate(model.name, phase, slo_ms, cnts,
                                         pl, pl.throughput))
    temps.sort(key=_template_order_key)
    n_dom = n_raw - len(temps)
    return temps, n_combos, n_raw, n_dom, t1 - t0, time.perf_counter() - t1


def generate_templates(model: ServedModel, phase: str,
                       configs: Sequence[NodeConfig], wl: WorkloadStats,
                       n_max: int = 6, rho: float = 12.0,
                       solver: str = "fast", prune: bool = True,
                       max_stages: Optional[int] = None,
                       cache: Optional[PlacementCache] = None,
                       cross_check: bool = False,
                       device=None,
                       ) -> Tuple[List[ServingTemplate], Dict]:
    """The Serving Template generator for one (model, SLO, phase).

    ``solver``: "fast" (default; cached/vectorized, same optimum),
    "exact" (reference per-combo combinatorial solver) or "ilp" (paper
    formulation). ``cache`` lets callers reuse a ``PlacementCache``
    across calls that share (model, phase, SLO, workload) — e.g. the
    per-config sub-universes of ``homo_library``; its device is then the
    generation's. ``device``: ``cuda`` unless the caller passes another
    (no card raises).

    The default ``solver="fast", prune=True`` path runs the level-wise
    dominance-pruned frontier (``_frontier_generate``).
    ``cross_check=True`` (or env ``CORAL_TEMPLATE_CROSSCHECK=1``)
    additionally runs the exhaustive enumerate-all + ``pareto_prune``
    path on a fresh cache and asserts the two template sets are identical
    (keys and bit-exact throughputs); ``stats["cross_check"] == "ok"``
    records the proof.
    """
    t0 = time.time()
    dev = cache.device if (cache is not None and device is None) \
        else resolve_device(device)
    slo_ms = model.prefill_slo_ms if phase == "prefill" else model.decode_slo_ms
    pt = ProfileTable(model, phase, slo_ms, wl, device=dev)
    by_name = {c.name: c for c in configs}
    tables = lambda name, S: pt.table(by_name[name], S)

    model_gb = model.bytes_total / 1e9
    lo = model_gb * (0.9 if phase == "prefill" else 1.0)
    # tiny models: rho x model_size can undershoot even one node's HBM;
    # a single smallest node must always be admissible
    hi = max(model_gb * rho, min(c.mem_gb for c in configs) + 1e-9)
    if solver not in ("fast", "exact", "ilp"):
        raise ValueError(f"unknown solver {solver!r}; "
                         f"expected 'fast', 'exact' or 'ilp'")

    def _stats(n_combos, n_raw, n_temps, extra=None):
        s = {"combos": n_combos, "templates_raw": n_raw,
             "templates": n_temps, "seconds": time.time() - t0,
             "n_max": n_max, "rho": rho, "device": str(dev),
             "fingerprint": generation_fingerprint(
                 model, phase, configs, wl, n_max, rho, prune, solver,
                 max_stages)}
        if extra:
            s.update(extra)
        return s

    check = cross_check or (os.environ.get("CORAL_TEMPLATE_CROSSCHECK")
                            not in (None, "", "0"))
    if solver == "fast" and prune:
        if cache is None:
            cache = PlacementCache(tables, model.n_layers, device=dev)
        fr = _frontier_generate(model, phase, slo_ms, configs, n_max,
                                lo, hi, max_stages, cache)
        if fr is not None:
            out, n_combos, n_raw, n_dom, dev_s, host_s = fr
            extra = {"dominated": n_dom, "frontier": True,
                     "device_seconds": dev_s, "host_seconds": host_s}
            if check:
                ref, ref_stats = _exhaustive_generate(
                    model, phase, slo_ms, configs, wl, n_max, rho, lo, hi,
                    "fast", True, max_stages,
                    PlacementCache(tables, model.n_layers, device=dev),
                    tables)
                _assert_template_sets_equal(out, ref, n_raw,
                                            ref_stats["templates_raw"])
                extra["cross_check"] = "ok"
            return out, _stats(n_combos, n_raw, len(out), extra)
    if cache is None:
        cache = PlacementCache(tables, model.n_layers, device=dev)
    out, ex_stats = _exhaustive_generate(model, phase, slo_ms, configs, wl,
                                         n_max, rho, lo, hi, solver, prune,
                                         max_stages, cache, tables)
    return out, _stats(ex_stats["combos"], ex_stats["templates_raw"],
                       len(out))


def _exhaustive_generate(model, phase, slo_ms, configs, wl, n_max, rho,
                         lo, hi, solver, prune, max_stages, cache, tables):
    """Reference path: enumerate every combo, solve, then prune (on the
    cache's device)."""
    out: List[ServingTemplate] = []
    if solver == "fast":
        names_list = [[c.name for c in combo]
                      for combo in enumerate_combos(configs, n_max, lo, hi)]
        n_combos = len(names_list)
        placements = zip(names_list,
                         cache.solve_batch(names_list,
                                           max_stages=max_stages))
    else:
        solve = optimal_placement_exact if solver == "exact" \
            else optimal_placement_ilp

        def _solve_all():
            for combo in enumerate_combos(configs, n_max, lo, hi):
                names = [c.name for c in combo]
                yield names, solve(names, tables, model.n_layers,
                                   max_stages=max_stages)
        n_combos = 0
        placements = _solve_all()
    for names, pl in placements:
        if solver != "fast":
            n_combos += 1
        if pl is None or pl.throughput <= 0:
            continue
        counts: Dict[str, int] = {}
        for n in names:
            counts[n] = counts.get(n, 0) + 1
        out.append(ServingTemplate(
            model.name, phase, slo_ms,
            tuple(sorted(counts.items())), pl, pl.throughput))
    n_raw = len(out)
    if prune:
        out = pareto_prune(out, sorted(c.name for c in configs),
                           device=cache.device)
    return out, {"combos": n_combos, "templates_raw": n_raw}


def _assert_template_sets_equal(got: List[ServingTemplate],
                                ref: List[ServingTemplate],
                                got_raw: int, ref_raw: int) -> None:
    """Cross-check: the frontier's template set must be bit-identical
    (keys and throughputs, in the same deterministic order) to the
    exhaustive-enumeration + pareto_prune reference."""
    ga = [(t.key, t.throughput) for t in got]
    ra = [(t.key, t.throughput) for t in ref]
    if got_raw != ref_raw or ga != ra:
        only_g = set(ga) - set(ra)
        only_r = set(ra) - set(ga)
        raise AssertionError(
            f"frontier/exhaustive template-set mismatch: "
            f"raw {got_raw} vs {ref_raw}, kept {len(ga)} vs {len(ra)}, "
            f"{len(only_g)} frontier-only (e.g. {sorted(only_g)[:2]}), "
            f"{len(only_r)} reference-only (e.g. {sorted(only_r)[:2]})")


def build_library(models: Sequence[ServedModel],
                  configs: Sequence[NodeConfig],
                  workloads: Dict[str, WorkloadStats],
                  n_max: int = 6, rho: float = 12.0,
                  prune: bool = True, solver: str = "fast",
                  max_stages: Optional[int] = None,
                  reuse: Optional[TemplateLibrary] = None,
                  device=None) -> TemplateLibrary:
    """Build the full Serving Template Library on ``device`` (``cuda``
    unless the caller passes another; no card raises).

    ``reuse``: a previously built library; any (model, phase) whose
    generation fingerprint matches is copied over instead of re-solved
    (incremental rebuild when only part of the config universe or model
    set changed).
    """
    dev = resolve_device(device)
    lib = TemplateLibrary(config_by_name={c.name: c for c in configs},
                          device=dev)
    for m in models:
        wl = workloads[m.name]
        for phase in ("prefill", "decode"):
            fp = generation_fingerprint(m, phase, configs, wl, n_max, rho,
                                        prune, solver, max_stages)
            if reuse is not None:
                old = reuse.stats.get((m.name, phase))
                if old is not None and old.get("fingerprint") == fp:
                    lib.add((m.name, phase),
                            list(reuse.templates[(m.name, phase)]),
                            dict(old, reused=True))
                    continue
            temps, stats = generate_templates(
                m, phase, configs, wl, n_max=n_max, rho=rho, prune=prune,
                solver=solver, max_stages=max_stages, device=dev)
            lib.add((m.name, phase), temps, stats)
    return lib
