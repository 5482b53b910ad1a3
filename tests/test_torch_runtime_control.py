"""The port's epoch runtime and control loop against the JAX package's
(both on the CPU), bit for bit, wall-clock fields aside: the estimator,
the re-solve controller, the transition planner, the fault injector and
restart policy, the scenarios, ``ClusterRuntime`` over every scenario and
fault scenario on the ``phi4_runtime_library`` setup (built on each side
with the same parameters), a failed solve that keeps the previous
allocation, the sanitizer's verdicts, and the ``adaptive_cluster``
example."""
import runpy
from dataclasses import astuple
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_ctl import (MODEL, PORT, REF, SIDES, env, epoch_rows, first_diff,
                        run_digest, tset)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _two_threads():
    """Small CPU ops: two intra-op threads a test (see
    tests/test_torch_templates.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def libs(phi4_runtime_library):
    """The reference's runtime library and the port's, built on the CPU
    with the same parameters, asserted equal template for template."""
    models, configs, wls, _ = env(PORT)
    lib = PORT.T.build_library(list(models.values()), configs, wls,
                               n_max=3, rho=8.0, device="cpu")
    assert sorted(lib.templates) == sorted(phi4_runtime_library.templates)
    for key in lib.templates:
        assert tset(lib.templates[key]) == \
            tset(phi4_runtime_library.templates[key])
    return {id(REF): phi4_runtime_library, id(PORT): lib}


def _demand(side, n, p, d):
    return [side.A.Demand(MODEL, "prefill", p * n),
            side.A.Demand(MODEL, "decode", d * n)]


# ------------------------------------------------------------ estimator
def test_estimator_matches_the_reference():
    """Windows fed one by one: rates, quantile headroom, the shape EWMA
    and every estimate (``observe`` over the simulator's observables runs
    in every closed-loop test below)."""
    rng = np.random.default_rng(3)
    feeds = [(float(rng.uniform(20, 90)), int(rng.integers(0, 300)),
              float(rng.uniform(0, 9e4))) for _ in range(30)]
    out = []
    for side in SIDES:
        _, _, wls, _ = env(side)
        est = side.ctl.DemandEstimator([MODEL], wls)
        rows = [[astuple(d) for d in est.estimate(240.0)]]
        for dt, n, p in feeds:
            est.ingest_window(MODEL, dt, n, p)
            rows.append([astuple(d) for d in est.estimate(240.0)])
            rows.append((est.rate(MODEL), est.rate(MODEL, 120.0, q=0.3)))
        out.append(rows)
    assert out[1] == out[0]


# ----------------------------------------------------------- controller
def test_controller_and_planner_match_the_reference(libs):
    """Drift and availability triggers through hysteresis, cooldown and
    the cadence fallback, mid-epoch events, and the planner's churn
    scores and incumbent over recorded allocations."""
    rng = np.random.default_rng(5)
    seq = []
    for e in range(24):
        scale = float(rng.choice([1.0, 1.05, 1.6, 0.5]))
        av = int(rng.choice([20, 20, 12, 30]))
        seq.append((e, scale, av, int(rng.integers(0, 2)),
                    int(rng.integers(0, 2))))
    out = []
    for side in SIDES:
        _, configs, wls, _ = env(side)
        wl = wls[MODEL]
        lib = libs[id(side)]
        ctl = side.ctl.ReSolveController()
        plan = side.ctl.TransitionPlanner(lib, side.H.CORE_REGIONS, 0.025)
        state = side.A.AllocatorState()
        rows, current = [], {}
        for e, scale, av, pre, fail in seq:
            dem = _demand(side, scale * 2.0, wl.avg_prompt, wl.avg_output)
            avail = {(r.name, c.name): av for r in side.H.CORE_REGIONS
                     for c in configs}
            dec = ctl.decide(e, dem, avail, n_preempted=pre, n_failed=fail)
            rows.append((astuple(dec), ctl.demand_drift(dem),
                         ctl.avail_delta(avail)))
            rows.append(astuple(ctl.decide_event(e * 240.0 + 10.0, 1, 3)))
            if dec.resolve:
                inc = plan.choose_incumbent(current)
                state.set_incumbent(inc)
                alloc = state(side.A.AllocProblem(
                    side.H.CORE_REGIONS, configs, avail, dem, lib,
                    current=current, init_penalty_k=0.025))
                assert alloc.ok and not alloc.fallback
                ctl.notify_solved(dem, avail)
                plan.record(alloc)
                rows.append((sorted(alloc.instances.items()),
                             plan.churn_cost(alloc.instances, current),
                             None if inc is None else sorted(inc.items())))
                current = dict(alloc.instances)
        out.append(rows)
    assert out[1] == out[0]


# --------------------------------------------------------------- faults
def _stub(iid, region, family):
    return SimpleNamespace(
        iid=iid, region=region, dead=False, draining=False, failed=False,
        template=SimpleNamespace(counts=((family, 1),), key=(family,)))


def test_fault_injector_restart_policy_and_recovery_metrics():
    cfg = dict(seed=11, crash_rate=0.3, burst_rate=0.5, straggler_rate=0.2,
               restart_flake_p=0.5, feed_lag_epochs=1, feed_stale_p=0.3)
    insts = [_stub(i, f"r{i % 3}", "1xL40S" if i % 2 else "1xL4")
             for i in range(12)]
    rng = np.random.default_rng(2)
    times = [float(t) for t in np.arange(60.0, 3000.0, 60.0)]
    vals = [float(v) for v in np.clip(rng.normal(0.9, 0.2, len(times)), 0, 1)]
    out = []
    for side in SIDES:
        inj = side.ctl.FaultInjector(side.ctl.FaultConfig(**cfg))
        rows = []
        for e in range(6):
            rows.append([(f.t, f.kind, f.inst.iid, f.factor, f.duration_s)
                         for f in inj.plan_epoch(e, e * 240.0, 240.0,
                                                 insts)])
            rows.append(sorted(inj.observed_availability(
                e, {("r0", "1xL40S"): 10 + e, ("r1", "1xL4"): 3 * e}
            ).items()))
            rows.append([inj.restart_outcome() for _ in range(3)])
        rows.append(inj.first_fault_t)
        pol = side.ctl.RestartPolicy(backoff_base_s=20.0, backoff_mult=2.0,
                                     backoff_max_s=300.0, budget_per_epoch=3)
        for e in range(4):
            pol.begin_epoch([("r0", ("a",))] if e % 2 else [])
            for _ in range(4):
                ok = pol.allow()
                rows.append((ok, pol.delay(("r0", ("a",)))))
                if ok:
                    pol.note_restart(("r0", ("a",)))
        rows.append(side.ctl.time_to_recover(times, vals, 600.0, 0.95))
        rows.append(side.ctl.time_to_recover(times, vals, 600.0, 0.95,
                                             sustain=3))
        rows.append(side.ctl.goodput_lost(times, vals, 0.95, 600.0, 60.0))
        out.append(rows)
    assert out[1] == out[0]


# ------------------------------------------------------------ scenarios
@pytest.mark.parametrize("kind", ["closed", "fault"])
def test_scenarios_match_the_reference(kind):
    names = REF.ctl.SCENARIO_NAMES if kind == "closed" \
        else REF.ctl.FAULT_SCENARIO_NAMES
    assert names == (PORT.ctl.SCENARIO_NAMES if kind == "closed"
                     else PORT.ctl.FAULT_SCENARIO_NAMES)
    for name in names:
        sc = []
        for side in SIDES:
            models, configs, wls, _ = env(side)
            s = side.ctl.make_scenario(name, models, side.H.CORE_REGIONS,
                                       configs, wls, n_epochs=8,
                                       epoch_s=180.0, base_rate=1.5, seed=4)
            sc.append((s.name, s.n_epochs, s.epoch_s,
                       [astuple(r) for r in s.requests],
                       [sorted(a.items()) for a in s.availability],
                       [[astuple(d) for d in ds] for ds in s.truth_demands],
                       s.rates, s.spot_market, s.meta,
                       None if s.faults is None else astuple(s.faults)))
        assert sc[1] == sc[0], name


# -------------------------------------------------------------- runtime
def _closed(side, lib, name, trace=True, batched=True):
    models, configs, wls, _ = env(side)
    sc = side.ctl.make_scenario(name, models, side.H.CORE_REGIONS, configs,
                                wls, n_epochs=5, epoch_s=180.0,
                                base_rate=1.2, seed=2)
    tr = side.Tr.TraceLog() if trace else None
    rt = side.C.ClusterRuntime(models, side.H.CORE_REGIONS, configs, lib,
                               side.A.AllocatorState(), wls,
                               epoch_s=sc.epoch_s,
                               spot_market=sc.spot_market,
                               sim_batched=batched, trace=tr)
    res = rt.run(sc.requests, sc.availability,
                 estimator=side.ctl.DemandEstimator([MODEL], wls),
                 controller=side.ctl.ReSolveController(),
                 planner=side.ctl.TransitionPlanner(lib, side.H.CORE_REGIONS,
                                                    rt.init_k))
    return rt, res, tr


def _fault(side, lib, name, batched=True):
    models, configs, wls, _ = env(side)
    sc = side.ctl.make_scenario(name, models, side.H.CORE_REGIONS, configs,
                                wls, n_epochs=6, epoch_s=240.0,
                                base_rate=1.5, seed=3)
    tr = side.Tr.TraceLog()
    rt = side.C.ClusterRuntime(
        models, side.H.CORE_REGIONS, configs, lib, side.A.AllocatorState(),
        wls, epoch_s=sc.epoch_s, spot_market=sc.spot_market,
        health_check_s=15.0,
        restart_policy=side.ctl.RestartPolicy(backoff_base_s=20.0,
                                              backoff_mult=2.0,
                                              backoff_max_s=300.0,
                                              budget_per_epoch=4),
        shed_policy=side.S.ShedPolicy(32.0), sim_batched=batched, trace=tr)
    res = rt.run(sc.requests, sc.availability, sc.truth_demands,
                 controller=side.ctl.ReSolveController(),
                 fault_injector=side.ctl.FaultInjector(sc.faults))
    return rt, res, tr


def _no_fallback(res):
    assert not any(e.solver_failed for e in res.epochs)


@pytest.mark.parametrize("name", REF.ctl.SCENARIO_NAMES)
def test_closed_loop_matches_the_reference(libs, name):
    rt_r, res_r, tr_r = _closed(REF, libs[id(REF)], name)
    rt_p, res_p, tr_p = _closed(PORT, libs[id(PORT)], name)
    _no_fallback(res_r)
    want, got = run_digest(rt_r, res_r, tr_r), run_digest(rt_p, res_p, tr_p)
    assert first_diff(got, want) is None, first_diff(got, want)
    assert res_p.epochs[0].trigger_reason == "initial"


@pytest.mark.parametrize("name", REF.ctl.FAULT_SCENARIO_NAMES)
def test_fault_scenarios_match_the_reference(libs, name):
    rt_r, res_r, tr_r = _fault(REF, libs[id(REF)], name)
    rt_p, res_p, tr_p = _fault(PORT, libs[id(PORT)], name)
    want, got = run_digest(rt_r, res_r, tr_r), run_digest(rt_p, res_p, tr_p)
    assert first_diff(got, want) is None, first_diff(got, want)


def _truth(side, lib, name, batched=True):
    """A scenario on its truth demands (no estimator): the runs the
    batched/oracle contract covers end to end -- a closed loop's
    estimator reads the pools' queue snapshots, which the batched loop
    holds differently by design, in the reference as in the port."""
    models, configs, wls, _ = env(side)
    sc = side.ctl.make_scenario(name, models, side.H.CORE_REGIONS, configs,
                                wls, n_epochs=5, epoch_s=180.0,
                                base_rate=1.2, seed=2)
    rt = side.C.ClusterRuntime(models, side.H.CORE_REGIONS, configs, lib,
                               side.A.AllocatorState(), wls,
                               epoch_s=sc.epoch_s,
                               spot_market=sc.spot_market,
                               sim_batched=batched)
    return rt, rt.run(sc.requests, sc.availability, sc.truth_demands)


@pytest.mark.parametrize("name", ["flash_crowd", "crash_storm"])
def test_port_runtime_batched_equals_oracle(libs, name):
    run = _truth if name in REF.ctl.SCENARIO_NAMES else _fault
    a = run(PORT, libs[id(PORT)], name, batched=True)
    b = run(PORT, libs[id(PORT)], name, batched=False)
    da, db = run_digest(*a), run_digest(*b)
    for d in (da, db):
        d["sim"].pop("instances")       # span state differs by design
    assert first_diff(db, da) is None, first_diff(db, da)


def _oracle_run(side, lib, allocator_fn, fail_rate=0.0, n_epochs=3):
    """The reference's tests/test_runtime.py ``_run``: oracle demands,
    flat availability, the legacy per-epoch failure draw."""
    models, configs, wls, _ = env(side)
    wl = wls[MODEL]
    rt = side.C.ClusterRuntime(models, side.H.CORE_REGIONS, configs, lib,
                               allocator_fn, wls, epoch_s=240.0)
    m = models[MODEL]
    reqs = side.W.gen_requests(MODEL, m.trace, 2.0, n_epochs * 240.0, seed=0)
    avail = [{(r.name, c.name): 20 for r in side.H.CORE_REGIONS
              for c in configs} for _ in range(n_epochs)]
    demands = [_demand(side, 2.0, wl.avg_prompt, wl.avg_output)
               for _ in range(n_epochs)]
    res = rt.run(reqs, avail, demands, fail_rate_per_epoch=fail_rate,
                 seed=1)
    return rt, res


def test_oracle_demands_and_failure_draws_match_the_reference(libs):
    out = [run_digest(*_oracle_run(side, libs[id(side)], side.A.allocate,
                                   fail_rate=0.7, n_epochs=5))
           for side in SIDES]
    assert first_diff(out[1], out[0]) is None, first_diff(out[1], out[0])
    assert sum(e["n_failed"] for e in out[1]["epochs"]) > 0


def test_failed_solve_keeps_previous_allocation(libs):
    """Epoch 1's solve fails outright: both sides keep epoch 0's target,
    flag the epoch and report the same shortfall and metrics."""
    out = []
    for side in SIDES:
        calls = {"n": 0}

        def flaky(prob, side=side):
            calls["n"] += 1
            if calls["n"] == 2:
                return side.A.Allocation(
                    {}, {}, np.inf, 0.0,
                    {(d.model, d.phase): d.tokens_per_s
                     for d in prob.demands}, 0.0, 0, False)
            return side.A.allocate(prob)

        rt, res = _oracle_run(side, libs[id(side)], flaky)
        good, failed = res.epochs[0], res.epochs[1]
        assert failed.solver_failed and failed.alloc_source == "last_good"
        assert failed.n_drained == 0 and failed.n_new == 0
        assert failed.n_instances == good.n_instances > 0
        out.append(epoch_rows(res))
    assert out[1] == out[0]


# ------------------------------------------------------------ sanitizer
def test_sanitizer_passes_clean_runs_and_catches_a_broken_token_count(
        libs, monkeypatch):
    monkeypatch.setenv("CORAL_SANITIZE", "1")
    from repro.debug import invariants as RI
    from repro_torch.debug import invariants as PI
    digests = [run_digest(*_closed(side, libs[id(side)], "spot_preemption"))
               for side in SIDES]
    assert first_diff(digests[1], digests[0]) is None
    msgs = []
    for side, inv in ((REF, RI), (PORT, PI)):
        rt, _res, _tr = _closed(side, libs[id(side)], "diurnal")
        rt.sim.tokens[MODEL]._total += 1
        with pytest.raises(inv.InvariantViolation) as ei:
            rt.sim.run_until(rt.sim.now + 1.0)
        msgs.append(str(ei.value))
    assert "token conservation" in msgs[1] and msgs[1] == msgs[0]
    em = SimpleNamespace(epoch=0, cost_per_hour=1.0, init_cost=0.0,
                         solve_seconds=0.0, assembly_ms=0.0, solve_ms=0.0,
                         extract_ms=0.0, n_instances=1, n_new=0, n_drained=0,
                         n_preempted=0, n_failed=0, n_restarted=0, n_shed=0,
                         n_mid_resolves=0, solve_path="", unmet={},
                         goodput={MODEL: 2.0}, throughput={MODEL: 1.0},
                         slo={})
    verdicts = []
    for inv in (RI, PI):
        with pytest.raises(inv.InvariantViolation) as ei:
            inv.check_epoch_metrics(em)
        with pytest.raises(inv.InvariantViolation) as eh:
            inv.check_holdings({("r", "c"): 3}, {("r", "c"): 2})
        verdicts.append((str(ei.value), str(eh.value)))
    assert verdicts[1] == verdicts[0]


def test_runtime_takes_the_librarys_device(libs):
    models, configs, wls, _ = env(PORT)
    lib = libs[id(PORT)]
    rt = PORT.C.ClusterRuntime(models, PORT.H.CORE_REGIONS, configs, lib,
                               PORT.A.AllocatorState(), wls)
    assert rt.device == lib.device == torch.device("cpu") == rt.sim.device


# -------------------------------------------------------------- example
def test_adaptive_cluster_example_matches_the_reference(capsys):
    from repro_torch.examples import adaptive_cluster
    want = runpy.run_path(str(ROOT / "examples" / "adaptive_cluster.py"),
                          run_name="__main__")["res"]
    out_r = capsys.readouterr().out
    got = adaptive_cluster.run("cpu")
    out_p = capsys.readouterr().out
    assert epoch_rows(got) == epoch_rows(want)
    assert got.slo_report.window(0.0, 2400.0) == \
        want.slo_report.window(0.0, 2400.0)
    # the printed table, solve seconds aside
    strip = [line[:29] + line[37:] for line in out_p.splitlines()]
    assert strip == [line[:29] + line[37:] for line in out_r.splitlines()]
