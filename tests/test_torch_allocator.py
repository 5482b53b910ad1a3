"""The port's online stage against the JAX package's (both on the CPU):
the allocation on every solve path, the per-var oracle, the persistent
allocator across epochs (warm start, external incumbent, a rebuild on a
library change), the decomposition's row solver and coordination loop,
the baselines, the traces, the sanitizer's checks and the quickstart.

Allocations must agree in ``ok``, ``unmet`` and ``solve_path``, in
``cost_per_hour`` within 1e-9 and in the objective within 5e-4 relative
(the reference's own bound between solve paths, tests/test_allocator.py);
the instances are compared where the instance has no equal-cost tie and
are otherwise held to the reference's feasibility check."""
import os
import re
import subprocess
import sys
from dataclasses import astuple
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import allocator as RA
from repro.core import baselines as RB
from repro.core import hardware as RH
from repro.core import modelspec as RM
from repro.core import templates as RT
from repro.solver import decompose as RD
from repro.traces import workloads as RW

from repro_torch.core import allocator as PA
from repro_torch.core import baselines as PB
from repro_torch.core import hardware as PH
from repro_torch.core import modelspec as PM
from repro_torch.core import templates as PT
from repro_torch.debug import invariants as PI
from repro_torch.solver import decompose as PD
from repro_torch.traces import workloads as PW

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
CR = RH.make_node_configs(["L40S", "L4", "A10G"], sizes=(1, 2))
CP = PH.make_node_configs(["L40S", "L4", "A10G"], sizes=(1, 2))
NAMES = ["phi4-14b", "gpt-oss-20b"]
MR = [RM.PAPER_MODELS[n] for n in NAMES]
MP = [PM.PAPER_MODELS[n] for n in NAMES]
WR = {m.name: RW.workload_stats(m.trace) for m in MR}
WP = {m.name: PW.workload_stats(m.trace) for m in MP}
MODES = ("auto", "decomposed", "rounded_lp", "monolithic")


@pytest.fixture(autouse=True)
def _two_threads():
    """Small CPU ops: two intra-op threads a test (see
    tests/test_torch_templates.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def libs():
    return (RT.build_library(MR, CR, WR, n_max=3, rho=8.0),
            PT.build_library(MP, CP, WP, n_max=3, rho=8.0, device=CPU))


@pytest.fixture(scope="module")
def homo_libs():
    return (RB.homo_library(MR, CR, WR, n_max=3, rho=8.0),
            PB.homo_library(MP, CP, WP, n_max=3, rho=8.0, device=CPU))


def _demands(dec):
    dr, dp = [], []
    for m in MR:
        wl = WR[m.name]
        for phase, tok in (("prefill", dec * wl.avg_prompt / wl.avg_output),
                           ("decode", dec)):
            dr.append(RA.Demand(m.name, phase, tok))
            dp.append(PA.Demand(m.name, phase, tok))
    return dr, dp


def _instance(seed):
    rng = np.random.default_rng(seed)
    abundance, dec = int(rng.integers(2, 30)), float(rng.uniform(100, 3000))
    avail = {(r.name, c.name): int(rng.integers(0, abundance))
             for r in RH.CORE_REGIONS for c in CR}
    return avail, *_demands(dec)


def _check_alloc(alloc, avail, demands):
    """The reference's feasibility check (tests/test_allocator.py)."""
    used = {}
    for (region, key), n in alloc.instances.items():
        for c, k in alloc.templates[key].counts:
            used[(region, c)] = used.get((region, c), 0) + k * n
    for k, v in used.items():
        assert v <= avail.get(k, 0), (k, v, avail.get(k, 0))
    for d in demands:
        served = alloc.served(d.model, d.phase)
        short = alloc.unmet.get((d.model, d.phase), 0.0)
        assert served + short >= d.tokens_per_s - 1e-3


def _same_allocation(got, want, avail, demands, tie_free=True):
    assert got.ok == want.ok
    assert sorted(got.unmet) == sorted(want.unmet)
    assert got.solve_path == want.solve_path
    assert got.cost_per_hour == pytest.approx(want.cost_per_hour, rel=1e-9)
    if np.isfinite(want.objective):
        assert got.objective == pytest.approx(want.objective, rel=5e-4)
    if tie_free:
        assert sorted(got.instances.items()) == sorted(want.instances.items())
    _check_alloc(got, avail, demands)


@pytest.mark.parametrize("seed", range(8))
def test_allocate_matches_the_reference_on_every_path(libs, seed):
    lr, lp = libs
    avail, dr, dp = _instance(seed)
    for mode in MODES:
        want = RA.allocate(RA.AllocProblem(RH.CORE_REGIONS, CR, dict(avail),
                                           dr, lr, time_limit=30,
                                           solve_mode=mode))
        got = PA.allocate(PA.AllocProblem(PH.CORE_REGIONS, CP, dict(avail),
                                          dp, lp, time_limit=30,
                                          solve_mode=mode))
        _same_allocation(got, want, avail, dp)
        assert got.n_vars == want.n_vars and got.device_seconds > 0
    want = RA.allocate_reference(RA.AllocProblem(RH.CORE_REGIONS, CR,
                                                 dict(avail), dr, lr,
                                                 time_limit=30))
    got = PA.allocate_reference(PA.AllocProblem(PH.CORE_REGIONS, CP,
                                                dict(avail), dp, lp,
                                                time_limit=30))
    _same_allocation(got, want, avail, dp)


def test_var_cap_selection_matches_the_reference(libs):
    """A cap below the template count takes the Pareto/fill selection."""
    lr, lp = libs
    for key in lr.templates:
        cr, cp = lr.columns(*key), lp.columns(*key)
        cost_r = cr.region_cost(RH.CORE_REGIONS)
        cost_p = cp.region_cost(PH.CORE_REGIONS)
        assert np.allclose(cost_p.numpy(), cost_r, rtol=1e-15, atol=0)
        for cap in (5, 40, cr.n):
            want = RA.select_template_indices(cost_r, cr.throughput, cap)
            got = PA.select_template_indices(cost_p, cp.throughput, cap)
            assert got.tolist() == want.tolist()
    avail, dr, dp = _instance(3)
    want = RA.allocate(RA.AllocProblem(RH.CORE_REGIONS, CR, dict(avail), dr,
                                       lr, max_templates_per_demand=30))
    got = PA.allocate(PA.AllocProblem(PH.CORE_REGIONS, CP, dict(avail), dp,
                                      lp, max_templates_per_demand=30))
    _same_allocation(got, want, avail, dp)


def _epochs(n, seed, scarcity=None):
    base = RW.default_base_availability(CR, abundance=6.0)
    assert PW.default_base_availability(CP, abundance=6.0) == base
    want = RW.gen_availability(RH.CORE_REGIONS, CR, n, base, seed, scarcity)
    got = PW.gen_availability(PH.CORE_REGIONS, CP, n, base, seed, scarcity)
    assert got == want
    return want


def test_allocator_state_across_epochs_and_a_library_change(libs):
    """Re-solves reuse the structure and warm-start from the previous
    epoch's solution; an external incumbent seeds one solve; a library
    changed in place makes both states rebuild."""
    lr, lp = libs
    lr2 = RT.build_library(MR, CR, WR, n_max=3, rho=8.0)
    lp2 = PT.build_library(MP, CP, WP, n_max=3, rho=8.0, device=CPU)
    sr, sp = RA.AllocatorState(), PA.AllocatorState()
    cur_r = cur_p = {}
    for e, avail in enumerate(_epochs(5, seed=11)):
        dr, dp = _demands(400.0 + 150.0 * e)
        if e == 2:
            inc = dict(cur_r)
            sr.set_incumbent(inc)
            sp.set_incumbent(inc)
        if e == 3:       # the library changes in place: a rebuild
            for lib in (lr2, lp2):
                key = ("phi4-14b", "decode")
                lib.add(key, lib.get(*key)[: len(lib.get(*key)) // 2],
                        {"trimmed": True})
        use_r, use_p = (lr, lp) if e < 3 else (lr2, lp2)
        want = sr(RA.AllocProblem(RH.CORE_REGIONS, CR, avail, dr, use_r,
                                  current=cur_r, time_limit=30))
        got = sp(PA.AllocProblem(PH.CORE_REGIONS, CP, avail, dp, use_p,
                                 current=cur_p, time_limit=30))
        _same_allocation(got, want, avail, dp)
        cur_r, cur_p = want.instances, got.instances


def test_scarce_availability_leaves_unmet_demand(libs):
    lr, lp = libs
    avail = {k: min(v, 1) for k, v in _epochs(1, seed=5,
                                              scarcity={"L40S": 0.1})[0].items()}
    dr, dp = _demands(5000.0)
    want = RA.allocate(RA.AllocProblem(RH.CORE_REGIONS, CR, dict(avail), dr,
                                       lr))
    got = PA.allocate(PA.AllocProblem(PH.CORE_REGIONS, CP, dict(avail), dp,
                                      lp))
    _same_allocation(got, want, avail, dp)
    assert got.unmet


@pytest.mark.parametrize("seed", range(4))
def test_baselines_match_the_reference(homo_libs, seed):
    hr, hp = homo_libs
    for key in hr.templates:
        assert [astuple(t.placement) + (t.counts, t.throughput)
                for t in hp.get(*key)] == \
            [astuple(t.placement) + (t.counts, t.throughput)
             for t in hr.get(*key)]
    avail, dr, dp = _instance(seed)
    for fr, fp in ((RB.homo_allocate, PB.homo_allocate),
                   (RB.cauchy_allocate, PB.cauchy_allocate)):
        want = fr(RA.AllocProblem(RH.CORE_REGIONS, CR, dict(avail), dr, hr,
                                  time_limit=30), hr)
        got = fp(PA.AllocProblem(PH.CORE_REGIONS, CP, dict(avail), dp, hp,
                                 time_limit=30), hp)
        assert got.ok == want.ok and sorted(got.unmet) == sorted(want.unmet)
        assert got.cost_per_hour == pytest.approx(want.cost_per_hour,
                                                  rel=1e-9)
        assert sorted(got.instances.items()) == sorted(want.instances.items())
        _check_alloc(got, avail, dp)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_helix_placement_matches_the_reference(phase):
    pool_r = [RH.NodeConfig(RH.DEVICE_TYPES[d], k) for d, k in
              (("A100-40G", 1), ("A100-40G", 1), ("V100-16G", 1),
               ("V100-16G", 2), ("T4", 1), ("T4", 1), ("L4", 1))]
    pool_p = [PH.NodeConfig(PH.DEVICE_TYPES[c.device.name], c.n_devices)
              for c in pool_r]
    for name in ("qwen3-32b", "llama3-70b"):
        rm, pm = RM.PAPER_MODELS[name], PM.PAPER_MODELS[name]
        want = RB.helix_placement(rm, phase, RW.workload_stats(rm.trace),
                                  pool_r)
        got = PB.helix_placement(pm, phase, PW.workload_stats(pm.trace),
                                 pool_p, device=CPU)
        assert (None if got is None else astuple(got)) == \
            (None if want is None else astuple(want))


def _rows(seed, n=60):
    rng = np.random.default_rng(seed)
    cost = rng.uniform(1.0, 20.0, n)
    thr = rng.uniform(50.0, 3000.0, n)
    ub = rng.integers(0, 6, n).astype(float)
    return cost, thr, ub, float(rng.uniform(0.2, 0.9) * (thr @ ub))


@pytest.mark.parametrize("seed", range(6))
def test_cover_bb_matches_the_reference(seed):
    cost, thr, ub, target = _rows(seed)
    inc = np.floor(ub / 2)
    for incumbent in (None, inc):
        want = RD.cover_bb(cost, thr, ub, target, incumbent=incumbent)
        got = PD.cover_bb(cost, thr, ub, target, incumbent=incumbent)
        assert got[1:] == want[1:]
        assert got[0].tolist() == want[0].tolist()
    assert PD.pareto_keep(cost, thr, ub, target).tolist() == \
        RD.pareto_keep(cost, thr, ub, target).tolist()


@pytest.mark.parametrize("seed", range(4))
def test_solve_decomposed_matches_the_reference(seed):
    """Two models sharing availability rows, the columns handed over as
    CPU tensors (the port copies them to the host once)."""
    rng = np.random.default_rng(100 + seed)
    n_av, per = 5, 24
    V = 4 * per
    rows_r, rows_p, models_r, models_p = [], [], [], []
    for m in range(2):
        rr, rp = [], []
        for k in range(2):
            cols = np.arange((2 * m + k) * per, (2 * m + k + 1) * per)
            cost, thr, ub, target = _rows(seed * 10 + 2 * m + k, per)
            cur = rng.integers(0, 2, per).astype(float)
            rr.append(RD.RowSpec(cols, cost, thr, ub, cur, target * 1.1))
            rp.append(PD.RowSpec(torch.from_numpy(cols),
                                 torch.from_numpy(cost), torch.from_numpy(thr),
                                 torch.from_numpy(ub), torch.from_numpy(cur),
                                 target * 1.1))
        pen = 100.0 * float(max(r.cost.max() / r.thr.min() for r in rr))
        models_r.append(RD.ModelSpec(m, rr, pen))
        models_p.append(PD.ModelSpec(m, rp, pen))
    nz = rng.integers(0, n_av, V)
    data = rng.integers(1, 3, V).astype(float)
    b = rng.integers(10, 30, n_av).astype(float)
    want = RD.solve_decomposed(RD.DecomposeProblem(
        V, models_r, 0.1, data, nz, np.arange(V), b))
    got = PD.solve_decomposed(PD.DecomposeProblem(
        V, models_p, 0.1, torch.from_numpy(data), torch.from_numpy(nz),
        torch.arange(V), torch.from_numpy(b)))
    assert (got.ok, got.certified, got.reason, got.iters, got.nodes) == \
        (want.ok, want.certified, want.reason, want.iters, want.nodes)
    assert got.objective == want.objective and got.dual_bound == want.dual_bound
    assert got.v.tolist() == want.v.tolist()


def test_traces_match_draw_for_draw():
    for trace in RW.TRACES:
        for seed in (0, 1, 7):
            want = RW.gen_requests("m", trace, 3.0, 40.0, seed)
            got = PW.gen_requests("m", trace, 3.0, 40.0, seed)
            assert [astuple(q) for q in got] == [astuple(q) for q in want]
        want = RW.gen_requests_schedule("m", trace, [1.0, 0.0, 4.0], 20.0, 5)
        got = PW.gen_requests_schedule("m", trace, [1.0, 0.0, 4.0], 20.0, 5)
        assert [astuple(q) for q in got] == [astuple(q) for q in want]
        assert astuple(PW.workload_stats(trace)) == \
            astuple(RW.workload_stats(trace))
    _epochs(12, seed=3, scarcity={"L40S": 0.5})


def test_sanitizer_checks(libs, monkeypatch):
    _, lp = libs
    avail, _, dp = _instance(2)
    monkeypatch.setenv("CORAL_SANITIZE", "1")
    assert PI.sanitize_enabled()
    alloc = PA.allocate(PA.AllocProblem(PH.CORE_REGIONS, CP, dict(avail), dp,
                                        lp, time_limit=30))
    PI.check_allocation(alloc, avail)
    PI.check_demands(dp)
    if alloc.instances:
        with pytest.raises(PI.InvariantViolation):
            PI.check_allocation(alloc, {k: 0 for k in avail})
    with pytest.raises(PI.InvariantViolation):
        PI.check_demands([PA.Demand("m", "decode", float("nan"))])


def _strip_times(text):
    return re.sub(r"\d+\.\d+s\b", "<t>s", text)


def test_quickstart_prints_what_the_reference_prints():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    want = subprocess.run([sys.executable, str(ROOT / "examples" / "quickstart.py")],
                          env=env, capture_output=True, text=True, timeout=300)
    got = subprocess.run([sys.executable, "-m", "repro_torch.examples.quickstart",
                          "--device", "cpu"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert want.returncode == 0 and got.returncode == 0, got.stderr
    assert "cost $" in got.stdout
    assert _strip_times(got.stdout) == _strip_times(want.stdout)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only case")
def test_allocation_defaults_to_cuda_and_raises_without_a_card(libs):
    lr, lp = libs
    lib = PT.TemplateLibrary(templates=dict(lp.templates),
                             config_by_name=lp.config_by_name)
    avail, _, dp = _instance(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        PA.allocate(PA.AllocProblem(PH.CORE_REGIONS, CP, avail, dp, lib))
    with pytest.raises(RuntimeError, match="CUDA"):
        PA.AllocatorState()(PA.AllocProblem(PH.CORE_REGIONS, CP, avail, dp,
                                            lib))
    from repro_torch.examples import quickstart
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main([])
