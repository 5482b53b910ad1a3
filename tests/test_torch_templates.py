"""The port's offline stage against the JAX package's (both on the CPU):
profile rows, the placement solvers, the placement cache (with and without
incumbents, and its tuple-keyed path), template generation on every path,
the core library at the paper defaults and the example over the served
archs. Template sets are compared bit for bit: keys, counts, placements
and throughputs."""
from dataclasses import astuple

import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.core import hardware as RH
from repro.core import modelspec as RM
from repro.core import placement as RP
from repro.core import profiles as RPr
from repro.core import templates as RT
from repro.traces import workloads as RW

from repro_torch.configs import hardware as card
from repro_torch.configs.registry import get_config
from repro_torch.core import hardware as PH
from repro_torch.core import modelspec as PM
from repro_torch.core import placement as PP
from repro_torch.core import profiles as PPr
from repro_torch.core import templates as PT
from repro_torch.traces import workloads as PW

CPU = "cpu"
SMALL_R = RH.make_node_configs(["L40S", "L4", "A10G"], sizes=(1, 2))
SMALL_P = PH.make_node_configs(["L40S", "L4", "A10G"], sizes=(1, 2))
# the reference's template counts of the core library at the paper
# defaults (CORE_MODELS x CORE_CONFIGS, n_max=6, rho=12): 28,074 in all
CORE_COUNTS = {("qwen3-32b", "prefill"): 12974, ("qwen3-32b", "decode"): 4049,
               ("gpt-oss-20b", "prefill"): 5677, ("gpt-oss-20b", "decode"): 2421,
               ("phi4-14b", "prefill"): 2268, ("phi4-14b", "decode"): 685}


@pytest.fixture(autouse=True)
def _two_threads():
    """The control plane's CPU ops are small: two intra-op threads a test
    keep parallel test workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _pl(p):
    return None if p is None else astuple(p)


def _tset(temps):
    """Everything a template holds, in order: bit-exact comparison."""
    return [(t.model, t.phase, t.slo_ms, t.counts, astuple(t.placement),
             t.throughput) for t in temps]


def _wl(trace):
    return RW.workload_stats(trace), PW.workload_stats(trace)


def test_h100_row_is_the_cards_row():
    """configs/hardware.H100 and core/hardware's H100 are one fact."""
    row, c = PH.DEVICE_TYPES["H100"], card.H100
    assert (row.name, row.mem_gb, row.bw_tbps, row.tflops,
            row.intra_node_gbps) == (c.name, c.mem_gb, c.bw_tbps, c.tflops,
                                     c.intra_node_gbps)
    # and both are the reference's Table 1 row, price included
    assert astuple(row) == astuple(RH.DEVICE_TYPES["H100"])
    assert "TPUv5e" not in PH.DEVICE_TYPES
    assert [astuple(c) for c in PH.EXT_CONFIGS] == \
        [astuple(c) for c in RH.EXT_CONFIGS]


def test_model_specs_match_the_reference():
    for name, m in RM.PAPER_MODELS.items():
        assert astuple(PM.PAPER_MODELS[name]) == astuple(m)
    assert PM.CORE_MODELS == RM.CORE_MODELS
    assert PM.EXT_MODELS == RM.EXT_MODELS
    for arch in ("qwen2-1.5b", "granite-moe-3b-a800m", "zamba2-1.2b",
                 "xlstm-350m", "glm4-9b"):
        assert astuple(PM.from_model_config(get_config(arch))) == \
            astuple(RM.from_model_config(ref_get_config(arch)))


@pytest.mark.parametrize("name", list(RM.PAPER_MODELS))
def test_profile_rows_bit_for_bit(name):
    """Every row for EXT_CONFIGS x both phases x S = 1..8."""
    rm, pm = RM.PAPER_MODELS[name], PM.PAPER_MODELS[name]
    wr, wp = _wl(rm.trace)
    for phase in ("prefill", "decode"):
        slo = rm.prefill_slo_ms if phase == "prefill" else rm.decode_slo_ms
        rt = RPr.ProfileTable(rm, phase, slo, wr)
        pt = PPr.ProfileTable(pm, phase, slo, wp, device=CPU)
        for rc, pc in zip(RH.EXT_CONFIGS, PH.EXT_CONFIGS):
            for S in range(1, 9):
                want, got = rt.table(rc, S), pt.table(pc, S)
                assert got.dtype == torch.float64 and got.device.type == CPU
                assert got.numpy().tobytes() == want.tobytes(), \
                    (phase, rc.name, S)


def test_profile_table_memo_keys_on_the_device():
    m = PM.PAPER_MODELS["phi4-14b"]
    wl = PW.workload_stats(m.trace)
    row = PPr.ProfileTable(m, "decode", 60, wl, device=CPU).table(
        PH.CORE_CONFIGS[0], 2)
    keys = [k for k in PPr.ProfileTable._shared
            if k[0] == m and k[4] == PH.CORE_CONFIGS[0] and k[5] == 2]
    assert keys and all(k[-1] == torch.device(CPU) for k in keys)
    assert row is PPr.ProfileTable(m, "decode", 60, wl, device=CPU).table(
        PH.CORE_CONFIGS[0], 2)


def _synthetic_tables(names, L, seed):
    """The reference's synthetic tables (tests/test_placement.py) as numpy
    rows, and the same rows as tensors for the port."""
    r = np.random.default_rng(seed)
    base = {n: r.uniform(10, 200) for n in sorted(set(names))}
    cache = {}

    def tables(name, S):
        key = (name, S)
        if key not in cache:
            j = np.arange(1, L + 1)
            v = base[name] / (j ** (0.7 + 0.05 * S))
            cut = r.integers(max(L // 2, 1), L + 1)
            v = np.where(j <= cut, v, 0.0)
            cache[key] = np.minimum.accumulate(v)
        return cache[key]

    return tables, lambda name, S: torch.from_numpy(tables(name, S).copy())


@pytest.mark.parametrize("seed", range(6))
def test_exact_ilp_and_fast_placements_match(seed):
    r = np.random.default_rng(seed)
    K, L = int(r.integers(2, 5)), int(r.integers(3, 9))
    names = [["A", "B", "C"][int(r.integers(0, 3))] for _ in range(K)]
    rt, pt = _synthetic_tables(names, L, seed)
    want = RP.optimal_placement_exact(names, rt, L)
    assert _pl(PP.optimal_placement_exact(names, pt, L)) == _pl(want)
    assert _pl(PP.optimal_placement_fast(names, pt, L)) == \
        _pl(RP.optimal_placement_fast(names, rt, L))
    ti = PP.optimal_placement_ilp(names, pt, L)
    wi = RP.optimal_placement_ilp(names, rt, L)
    assert (ti is None) == (wi is None)
    if ti is not None:
        assert ti.throughput == pytest.approx(wi.throughput, rel=1e-9)
        te = want.throughput if want else 0.0
        assert ti.throughput == pytest.approx(te, rel=1e-6)


def _profile_pair(name, phase, configs_r, configs_p):
    rm, pm = RM.PAPER_MODELS[name], PM.PAPER_MODELS[name]
    wr, wp = _wl(rm.trace)
    slo = rm.prefill_slo_ms if phase == "prefill" else rm.decode_slo_ms
    rt = RPr.ProfileTable(rm, phase, slo, wr)
    pt = PPr.ProfileTable(pm, phase, slo, wp, device=CPU)
    br = {c.name: c for c in configs_r}
    bp = {c.name: c for c in configs_p}
    return (lambda n, S: rt.table(br[n], S)), \
        (lambda n, S: pt.table(bp[n], S)), rm.n_layers


@pytest.mark.parametrize("with_incumbents", [False, True])
def test_solve_batch_counts_matches_the_reference(with_incumbents):
    rt, pt, L = _profile_pair("qwen3-32b", "decode", RH.CORE_CONFIGS,
                              PH.CORE_CONFIGS)
    names = sorted(c.name for c in RH.CORE_CONFIGS)
    rng = np.random.default_rng(7)
    counts = np.zeros((300, len(names)), dtype=np.int64)
    for row in counts:
        for _ in range(int(rng.integers(1, 6))):
            row[rng.integers(0, len(names))] += 1
    inc = None
    if with_incumbents:
        full = RP.PlacementCache(rt, L).solve_batch_counts(counts, names)
        inc = np.array([(p.throughput if p else 0.0) for p in full]) \
            * rng.uniform(0.6, 1.05, len(counts))
    want = RP.PlacementCache(rt, L).solve_batch_counts(counts, names,
                                                       incumbents=inc)
    got = PP.PlacementCache(pt, L, device=CPU).solve_batch_counts(
        torch.from_numpy(counts), names,
        incumbents=None if inc is None else torch.from_numpy(inc))
    assert [_pl(p) for p in got] == [_pl(p) for p in want]
    assert sum(p is not None for p in want) > 50


def test_tuple_keyed_path_of_an_overflowing_universe():
    """Counts above CODE_MASK and a universe over 20 configs overflow the
    packed codes: both caches take their tuple-keyed path."""
    cfg_r = RH.make_node_configs(["L40S", "L4", "A10G", "H100", "A100",
                                  "T4"], sizes=(1, 2, 4, 8))
    cfg_p = PH.make_node_configs(["L40S", "L4", "A10G", "H100", "A100",
                                  "T4"], sizes=(1, 2, 4, 8))
    rt, pt, L = _profile_pair("phi4-14b", "prefill", cfg_r, cfg_p)
    names = sorted(c.name for c in cfg_r)
    assert len(names) * PP.CODE_BITS > 62
    rng = np.random.default_rng(3)
    combos = [[names[int(i)] for i in rng.integers(0, len(names), k)]
              for k in rng.integers(1, 5, 40)]
    combos += [["1xT4"] * 9, ["1xL4"] * 8 + ["2xA10G"]]
    inc = np.zeros(len(combos))
    inc[::3] = 500.0
    want = RP.PlacementCache(rt, L).solve_batch(combos, incumbents=inc)
    got = PP.PlacementCache(pt, L, device=CPU).solve_batch(combos,
                                                           incumbents=inc)
    assert [_pl(p) for p in got] == [_pl(p) for p in want]


@pytest.mark.parametrize("kw", [dict(), dict(solver="exact"),
                                dict(prune=False), dict(cross_check=True),
                                dict(max_stages=2)],
                         ids=["frontier", "exact", "unpruned", "cross_check",
                              "max_stages"])
@pytest.mark.parametrize("name", ["phi4-14b", "gpt-oss-20b"])
def test_generate_templates_every_path(name, kw):
    rm, pm = RM.PAPER_MODELS[name], PM.PAPER_MODELS[name]
    wr, wp = _wl(rm.trace)
    for phase in ("prefill", "decode"):
        want, ws = RT.generate_templates(rm, phase, SMALL_R, wr, n_max=3,
                                         rho=8.0, **kw)
        got, gs = PT.generate_templates(pm, phase, SMALL_P, wp, n_max=3,
                                        rho=8.0, device=CPU, **kw)
        assert _tset(got) == _tset(want)
        assert [gs[k] for k in ("combos", "templates_raw", "templates")] == \
            [ws[k] for k in ("combos", "templates_raw", "templates")]


def test_exhaustive_path_of_an_overflowing_frontier():
    """A config universe too wide for the frontier's codes falls back to
    exhaustive enumeration + pareto_prune, in both packages."""
    cfg_r = RH.make_node_configs(["L40S", "L4", "A10G", "H100", "A100",
                                  "T4", "V100-16G", "A100-40G"], sizes=(1, 2))
    cfg_p = PH.make_node_configs(["L40S", "L4", "A10G", "H100", "A100",
                                  "T4", "V100-16G", "A100-40G"], sizes=(1, 2))
    rm, pm = RM.PAPER_MODELS["phi4-14b"], PM.PAPER_MODELS["phi4-14b"]
    wr, wp = _wl(rm.trace)
    want, ws = RT.generate_templates(rm, "decode", cfg_r, wr, n_max=15,
                                     rho=1.4)
    got, gs = PT.generate_templates(pm, "decode", cfg_p, wp, n_max=15,
                                    rho=1.4, device=CPU)
    assert "frontier" not in ws and "frontier" not in gs
    assert _tset(got) == _tset(want) and want


def _random_templates(seed, hi, n=150, d=5):
    rng = np.random.default_rng(seed)
    names = [f"c{i}" for i in range(d)]
    temps_r, temps_p, seen = [], [], set()
    while len(temps_r) < n:
        counts = tuple((c, int(k)) for c, k in
                       zip(names, rng.integers(0, hi, d)) if k)
        if not counts or counts in seen:
            continue
        seen.add(counts)
        thr = float(rng.integers(1, 40)) * 10.0
        temps_r.append(RT.ServingTemplate(
            "m", "decode", 60.0, counts,
            RP.Placement(1, (4,), (("x",),), thr), thr))
        temps_p.append(PT.ServingTemplate(
            "m", "decode", 60.0, counts,
            PP.Placement(1, (4,), (("x",),), thr), thr))
    return names, temps_r, temps_p


@pytest.mark.parametrize("seed", range(3))
def test_pareto_prune_matches_the_reference(seed):
    """The box path, and the pairwise scan forced by a zero box budget."""
    names, temps_r, temps_p = _random_templates(seed, hi=4)
    want = RT.pareto_prune(temps_r, names)
    assert _tset(PT.pareto_prune(temps_p, names, device=CPU)) == _tset(want)
    order = sorted(temps_p, key=PT._template_order_key)
    usage = torch.tensor([[t.usage().get(c, 0) for c in names]
                          for t in order])
    thr = torch.tensor([t.throughput for t in order], dtype=torch.float64)
    assert PT._pareto_mask_boxes(usage, thr, budget=0.0) is None
    pair = PT._pareto_mask_pairwise(usage)
    assert torch.equal(pair, PT._pareto_mask_boxes(usage, thr))
    assert _tset([t for t, k in zip(order, pair.tolist()) if k]) == \
        _tset(want)


@pytest.mark.parametrize("hi", [4, 20], ids=["swar", "broadcast"])
def test_pairwise_scan_matches_the_reference(hi):
    """Counts up to 15 take the packed SWAR scan, larger ones the plain
    broadcast comparison: each against the reference's on the same rows."""
    names, temps_r, _ = _random_templates(7, hi=hi)
    order = sorted(temps_r, key=RT._template_order_key)
    usage = np.array([[t.usage().get(c, 0) for c in names] for t in order],
                     dtype=np.int64)
    want = RT._pareto_mask_pairwise(usage)
    got = PT._pareto_mask_pairwise(torch.from_numpy(usage))
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("pair", list(CORE_COUNTS), ids=lambda p: "-".join(p))
def test_core_library_at_the_paper_defaults(pair):
    """The core library (CORE_MODELS x CORE_CONFIGS, n_max=6, rho=12),
    one (model, phase) per case: 28,074 templates in all, bit for bit,
    with the library's columns on its device."""
    name, phase = pair
    rm, pm = RM.PAPER_MODELS[name], PM.PAPER_MODELS[name]
    wr, wp = _wl(rm.trace)
    want, _ = RT.generate_templates(rm, phase, RH.CORE_CONFIGS, wr)
    lib = PT.build_library([pm], PH.CORE_CONFIGS, {pm.name: wp}, device=CPU)
    got = lib.get(name, phase)
    assert len(want) == CORE_COUNTS[pair]
    assert _tset(got) == _tset(want)
    st = lib.stats[pair]
    assert st["frontier"] and st["device_seconds"] > 0 and st["host_seconds"] > 0
    cols = lib.columns(name, phase)
    assert cols.usage.device.type == CPU and cols.throughput.dtype == torch.float64
    assert cols.throughput.tolist() == [t.throughput for t in want]
    assert sum(CORE_COUNTS.values()) == 28074


def test_build_library_reuse_skips_unchanged_pairs():
    models = [PM.PAPER_MODELS["phi4-14b"]]
    wls = {m.name: PW.workload_stats(m.trace) for m in models}
    lib = PT.build_library(models, SMALL_P, wls, n_max=3, rho=8.0,
                           device=CPU)
    again = PT.build_library(models, SMALL_P, wls, n_max=3, rho=8.0,
                             device=CPU, reuse=lib)
    assert all(again.stats[k].get("reused") for k in again.stats)
    assert _tset(again.get("phi4-14b", "decode")) == \
        _tset(lib.get("phi4-14b", "decode"))


def test_templates_for_the_served_archs_match_the_reference():
    """The example's template sets, from the port's own configs."""
    from repro_torch.examples import templates_for_archs as ex
    got = ex.run(device=CPU)
    wl = RW.workload_stats("burstgpt")
    for arch in ex.ARCHS:
        sm = RM.from_model_config(ref_get_config(arch), prefill_slo_ms=1200,
                                  decode_slo_ms=60, trace="burstgpt")
        for phase in ("prefill", "decode"):
            want, _ = RT.generate_templates(sm, phase, SMALL_R, wl, n_max=3,
                                            rho=10.0)
            assert _tset(got[(arch, phase)]) == _tset(want), (arch, phase)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only case")
def test_generation_defaults_to_cuda_and_raises_without_a_card():
    m = PM.PAPER_MODELS["phi4-14b"]
    wls = {m.name: PW.workload_stats(m.trace)}
    with pytest.raises(RuntimeError, match="CUDA"):
        PT.build_library([m], SMALL_P, wls, n_max=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        PT.generate_templates(m, "decode", SMALL_P, wls[m.name], n_max=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        PPr.ProfileTable(m, "decode", 60, wls[m.name])
    from repro_torch.examples import templates_for_archs
    with pytest.raises(RuntimeError, match="CUDA"):
        templates_for_archs.main([])
