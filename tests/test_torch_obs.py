"""The port's observability layer against the JAX package's (both on the
CPU), bit for bit: ``weighted_percentiles`` against the ``np.repeat``
expansion and the reference, ``RequestLog`` records and ``SLOReport``
windows and series over a seeded run with sheds and kills, the
``TraceLog`` round trip, and the port's closed-loop trace read back and
audited by the repo's trace reader (``tools/trace_tools.py``)."""
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from repro.obs import trace as RTr  # noqa: E402
from repro_torch import obs as PO  # noqa: E402
from repro_torch.kernels.common import resolve_device  # noqa: E402
from tools.trace_tools import assert_causal, read_trace  # noqa: E402

from _torch_ctl import (MODEL, PORT, REF, SIDES, env, first_diff,  # noqa: E402
                        run_digest, simulator, submit, templates,
                        trace_rows, tset)

# the module itself: ``repro.obs`` re-exports a function of its name
RPc = importlib.import_module("repro.obs.percentiles")


@pytest.fixture(autouse=True)
def _two_threads():
    """Small CPU ops: two intra-op threads a test (see
    tests/test_torch_templates.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


QS = (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0)


# ------------------------------------------------------------ percentiles
@pytest.mark.parametrize("seed", range(4))
def test_weighted_percentiles_match_expansion_and_reference(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 2, 5, 60, 400):
        vals = rng.exponential(0.05, n)
        vals[rng.integers(0, n, n // 3)] = vals[0]      # ties
        wts = rng.integers(1, 9, n).astype(np.int64)
        want = RPc.weighted_percentiles(vals, wts, QS)
        assert want == RPc.percentiles(np.repeat(vals, wts), QS)
        got = PO.weighted_percentiles(torch.from_numpy(vals),
                                      torch.from_numpy(wts), QS)
        assert got == want and all(type(x) is float for x in got)
        assert PO.weighted_percentiles(vals, wts, QS) == want
        assert PO.weighted_percentile(vals, wts, 0.95) == \
            RPc.weighted_percentile(vals, wts, 0.95)
        # the unweighted rule on a tensor: sorted on its device
        assert PO.percentiles(torch.from_numpy(vals), QS) == \
            RPc.percentiles(vals, QS)
    empty = (np.zeros(0), np.zeros(0, np.int64))
    assert PO.weighted_percentiles(*empty, QS) == \
        RPc.weighted_percentiles(*empty, QS)
    assert PO.percentiles(torch.zeros(0, dtype=torch.float64), QS) == \
        RPc.percentiles([], QS)


# ------------------------------------------- request log and SLO report
def _faulty_run(side):
    """Shed, drop, a crash with detection latency, a straggler, a kill of
    the lone decode instance and a late replacement."""
    pre, dec = templates(side)
    sim = simulator(side)
    sim.shed_policy = side.S.ShedPolicy(max_queue_per_instance=4.0)
    sim.add_instance("r0", pre[0], ready_delay=0.0)
    sim.add_instance("r0", pre[1], ready_delay=30.0)
    sim.add_instance("r0", dec[0], ready_delay=0.0)
    submit(side, sim, 30.0, 120, 12)
    sim.run_until(60.0)
    sim.crash_instance(sim.instances[1], 20.0)
    sim.degrade_instance(sim.instances[0], 2.5, 40.0)
    sim.run_until(90.0)
    sim.kill_instance(sim.instances[2])
    sim.run_until(150.0)
    sim.add_instance("r0", dec[1])
    sim.run_until(7200.0)
    return sim


def test_request_log_and_slo_report_match_the_reference():
    sims = [_faulty_run(side) for side in SIDES]
    reports = [side.R.SLOReport(sim.reqlog, sim.tokens,
                                side.R.SLOTargets.from_models(sim.models))
               for side, sim in zip(SIDES, sims)]
    (rr, rp), (sr, sp) = reports, sims
    for attr in ("n_first", "n_finished", "n_dropped", "n_shed"):
        assert getattr(sp.reqlog, attr) == getattr(sr.reqlog, attr)
    assert sp.reqlog.n_shed[MODEL] > 0 and sp.reqlog.n_dropped[MODEL] > 0
    assert sp.reqlog.first_records(MODEL) == sr.reqlog.first_records(MODEL)
    assert sp.reqlog.terminal_records(MODEL) == \
        sr.reqlog.terminal_records(MODEL)
    assert sp.reqlog.ttft_values(MODEL).numpy().tobytes() == \
        sr.reqlog.ttft_values(MODEL).tobytes()
    for t0, t1 in ((0.0, 7200.0), (0.0, 60.0), (45.5, 95.0), (500.0, 501.0),
                   (7000.0, 7200.0)):
        assert rp.window(t0, t1) == rr.window(t0, t1), (t0, t1)
        assert sp.reqlog.ttft_in(MODEL, t0, t1).numpy().tobytes() == \
            sr.reqlog.ttft_in(MODEL, t0, t1).tobytes()
    for w in (30.0, 120.0, 700.0):
        assert rp.series(MODEL, w, 0.0, 3600.0) == \
            rr.series(MODEL, w, 0.0, 3600.0)
    # targets on observed samples: a sample equal to its target meets it
    ttft = sorted(sr.reqlog.ttft_values(MODEL).tolist())
    gaps = sorted(sr.tokens[MODEL].gap_samples(0.0, 7200.0)[0].tolist())
    tight = [side.R.SLOTargets({MODEL: ttft[len(ttft) // 2]},
                               {MODEL: gaps[len(gaps) // 2]}) for side in SIDES]
    want = side_report(REF, sr, tight[0]).window(0.0, 7200.0)
    got = side_report(PORT, sp, tight[1]).window(0.0, 7200.0)
    assert got == want and 0.0 < got[MODEL]["tbt_attain"] < 1.0
    for v in got[MODEL].values():
        assert type(v) is float


def side_report(side, sim, targets):
    return side.R.SLOReport(sim.reqlog, sim.tokens, targets)


def test_request_log_device_and_empty_queries():
    rl = PORT.R.RequestLog([MODEL], device="cpu")
    assert rl.ttft_in(MODEL, 0.0, 1.0).numel() == 0
    rep = PORT.R.SLOReport(rl, {MODEL: PORT.S.TokenRuns("cpu")},
                           PORT.R.SLOTargets({MODEL: 1.0}, {MODEL: 0.1}))
    ref = REF.R.SLOReport(REF.R.RequestLog([MODEL]),
                          {MODEL: REF.S.TokenRuns()},
                          REF.R.SLOTargets({MODEL: 1.0}, {MODEL: 0.1}))
    assert rep.window(0.0, 10.0) == ref.window(0.0, 10.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PORT.R.RequestLog([MODEL])
    else:
        assert PORT.R.RequestLog([MODEL]).device == resolve_device()


# ---------------------------------------------------------------- trace
def test_tracelog_round_trip(tmp_path):
    recs = [("fault_inject", 130.0, 0, dict(fault="crash", iid=3)),
            ("trigger", 0.0, 0, dict(resolve=True, reason="epoch")),
            ("solve", 0.1, 0, dict(path="decomposed", solve_ms=12.0,
                                   assembly_ms=1.0, extract_ms=0.5,
                                   total_ms=14.0, alloc_source="solved")),
            ("reconcile", 0.2, 0, dict(n_new=4, n_drained=0, n_kept=0)),
            ("fault_detect", 145.0, 0, dict(iid=3, detect_lag_s=15.0)),
            ("restart", 146.0, 0, dict(for_iid=3, outcome="started")),
            ("preempt", 200.0, 0, dict(iid=5)),
            ("mid_resolve", 201.0, 0, dict(reason="availability_event",
                                           solve_ms=9.0))]
    paths = []
    for side in SIDES:
        tr = side.Tr.TraceLog()
        for kind, t, e, f in recs:
            tr.emit(kind, t, e, **f)
        paths.append(tmp_path / f"{id(side)}.jsonl")
        assert tr.write(paths[-1]) == len(recs)
    assert paths[1].read_text() == paths[0].read_text()
    records = read_trace(str(paths[1]))
    assert assert_causal(records) == []
    for r in records:
        assert PO.validate_record(r) is None and RTr.validate_record(r) is None
    assert PO.TRACE_SCHEMA == RTr.TRACE_SCHEMA
    tr = PO.TraceLog()
    with pytest.raises(PO.TraceError):
        tr.emit("no_such_kind", 0.0, 0)
    with pytest.raises(PO.TraceError):
        tr.emit("solve", 0.0, 0, path="decomposed")
    bad = {"kind": "preempt", "t": 1.0, "epoch": 0}
    assert PO.validate_record(bad) == RTr.validate_record(bad) is not None


def _traced_fault_run(side, lib):
    models, configs, wls, _ = env(side)
    sc = side.ctl.make_scenario("crash_storm", models, side.H.CORE_REGIONS,
                                configs, wls, n_epochs=6, epoch_s=240.0,
                                base_rate=1.5, seed=3)
    trace = side.Tr.TraceLog()
    rt = side.C.ClusterRuntime(
        models, side.H.CORE_REGIONS, configs, lib, side.A.AllocatorState(),
        wls, epoch_s=sc.epoch_s, health_check_s=15.0,
        restart_policy=side.ctl.RestartPolicy(backoff_base_s=20.0,
                                              budget_per_epoch=4),
        shed_policy=side.S.ShedPolicy(32.0), trace=trace)
    res = rt.run(sc.requests, sc.availability, sc.truth_demands,
                 controller=side.ctl.ReSolveController(),
                 fault_injector=side.ctl.FaultInjector(sc.faults))
    return rt, res, trace


def test_port_trace_passes_the_reader_and_equals_the_reference(
        phi4_runtime_library, tmp_path):
    models, configs, wls, _ = env(PORT)
    lib = PORT.T.build_library(list(models.values()), configs, wls,
                               n_max=3, rho=8.0, device="cpu")
    for key in phi4_runtime_library.templates:
        assert tset(lib.templates[key]) == \
            tset(phi4_runtime_library.templates[key])
    rt_r, res_r, tr_r = _traced_fault_run(REF, phi4_runtime_library)
    rt_p, res_p, tr_p = _traced_fault_run(PORT, lib)
    path = tmp_path / "port.jsonl"
    tr_p.write(path)
    records = read_trace(str(path))             # the reference's validator
    assert assert_causal(records) == []
    kinds = {r["kind"] for r in records}
    assert {"fault_inject", "fault_detect", "restart", "solve"} <= kinds
    assert trace_rows(records) == trace_rows(
        [json.loads(json.dumps(r, sort_keys=True)) for r in tr_r.records])
    want, got = run_digest(rt_r, res_r, tr_r), run_digest(rt_p, res_p, tr_p)
    assert first_diff(got, want) is None, first_diff(got, want)
