"""Shared setup of the port's simulator, runtime and control-loop parity
tests (tests/test_torch_sim.py, test_torch_obs.py,
test_torch_runtime_control.py): the JAX package's modules and the port's
side by side, the small phi4-14b template sets asserted equal on both
sides, and digests of everything a run produces except wall-clock fields,
compared with ``==`` (bit for bit, no tolerance)."""
from dataclasses import asdict, astuple
from types import SimpleNamespace

import repro.control as RCtl
import repro_torch.control as PCtl
from repro.core import allocator as RA
from repro.core import hardware as RH
from repro.core import modelspec as RM
from repro.core import templates as RT
from repro.obs import reqlog as RR
from repro.obs import trace as RTr
from repro.runtime import cluster as RC
from repro.simulator import costmodel as RCm
from repro.simulator import sim as RS
from repro.traces import workloads as RW
from repro_torch.core import allocator as PA
from repro_torch.core import hardware as PH
from repro_torch.core import modelspec as PM
from repro_torch.core import templates as PT
from repro_torch.obs import reqlog as PR
from repro_torch.obs import trace as PTr
from repro_torch.runtime import cluster as PC
from repro_torch.simulator import costmodel as PCm
from repro_torch.simulator import sim as PS
from repro_torch.traces import workloads as PW

CPU = "cpu"
REF = SimpleNamespace(ctl=RCtl, A=RA, H=RH, M=RM, T=RT, W=RW, C=RC, S=RS,
                      Cm=RCm, R=RR, Tr=RTr, dev={})
PORT = SimpleNamespace(ctl=PCtl, A=PA, H=PH, M=PM, T=PT, W=PW, C=PC, S=PS,
                       Cm=PCm, R=PR, Tr=PTr, dev={"device": CPU})
SIDES = (REF, PORT)
MODEL = "phi4-14b"

# wall-clock fields: the only numbers allowed to differ between two runs
WALL = ("solve_seconds", "solve_ms", "assembly_ms", "extract_ms")
TRACE_WALL = ("solve_ms", "assembly_ms", "extract_ms", "total_ms")


def tset(temps):
    """Everything a template holds, in order: bit-exact comparison."""
    return [(t.model, t.phase, t.slo_ms, t.counts, astuple(t.placement),
             t.throughput) for t in temps]


def env(side, model=MODEL):
    """(models, configs, workloads, config_by_name) of one side: the
    L40S/L4 pool the reference's simulator and runtime tests use."""
    m = side.M.PAPER_MODELS[model]
    configs = side.H.make_node_configs(["L40S", "L4"], sizes=(1, 2))
    return ({m.name: m}, configs, {m.name: side.W.workload_stats(m.trace)},
            {c.name: c for c in configs})


def templates(side, model=MODEL, n_max=2):
    """Prefill and decode templates, strongest first, as the reference's
    tests/test_sim.py takes them."""
    models, configs, wls, _ = env(side, model)
    m = models[model]
    out = []
    for phase in ("prefill", "decode"):
        temps, _ = side.T.generate_templates(m, phase, configs, wls[model],
                                             n_max=n_max, rho=8.0,
                                             **side.dev)
        temps.sort(key=lambda t: -t.throughput)
        out.append(temps)
    return out


def simulator(side, batched=True, **kw):
    models, _, wls, cfg = env(side)
    return side.S.Simulator(models, cfg, wls, batched=batched, **side.dev,
                            **kw)


def submit(side, sim, rate, duration, seed, model=MODEL):
    m = side.M.PAPER_MODELS[model]
    reqs = side.W.gen_requests(model, m.trace, rate, duration, seed=seed)
    for r in reqs:
        sim.submit(r)
    return reqs


def sim_digest(sim, windows=()):
    """Every observable of a simulator run: terminal and first-token
    records, per-request counters, token totals, instance counters, and
    goodput / throughput / arrival windows."""
    out = {"dropped": sim.dropped, "shed": sim.shed,
           "by_model": (dict(sim.dropped_by_model), dict(sim.shed_by_model)),
           "finished": sorted((r.rid, r.finish, r.prefill_done,
                               r.decode_slo_ok, r.decode_tokens_ok)
                              for r in sim.finished),
           "instances": [(i.iid, i.dead, i.failed, i.draining, i.tokens_out,
                          i.iters, i.ok_iters, i.ewma_load)
                         for i in sim.instances.values()]}
    for m in sim.models:
        tr = sim.tokens[m]
        out[m] = {
            "tokens": len(tr),
            "first": sim.reqlog.first_records(m) if sim.reqlog else None,
            "terminal": (sim.reqlog.terminal_records(m) if sim.reqlog
                         else None),
            "windows": [(sim.goodput(m, a, b), sim.throughput(m, a, b),
                         sim.obs[m].arrival.window(a, b)) for a, b in windows]}
    return out


def epoch_rows(res):
    return [{k: v for k, v in asdict(e).items() if k not in WALL}
            for e in res.epochs]


def trace_rows(records):
    return [{k: v for k, v in r.items() if k not in TRACE_WALL}
            for r in records]


def run_digest(rt, res, trace=None):
    """A ``ClusterRuntime`` run: epoch metrics, the whole-run SLO window
    and 60 s series, the simulator's digest and the trace records."""
    T = len(res.epochs) * rt.epoch_s
    rep = res.slo_report
    return {"epochs": epoch_rows(res),
            "aggregates": (res.avg_cost(), res.n_resolves(),
                           res.total_failed(), res.total_restarted(),
                           res.total_shed(), res.recovery_epochs(),
                           res.solve_path_counts(),
                           res.total_mid_resolves(),
                           {m: res.avg_goodput(m) for m in rt.models}),
            "slo": rep.window(0.0, T),
            "series": {m: rep.series(m, 60.0, 0.0, T) for m in rt.models},
            "sim": sim_digest(rt.sim, [(0.0, T)]),
            "trace": None if trace is None else trace_rows(trace.records)}


def first_diff(a, b, path=""):
    """The first path at which two digests differ (None when equal)."""
    if isinstance(a, dict) and isinstance(b, dict):
        if sorted(a, key=repr) != sorted(b, key=repr):
            return f"{path} keys"
        for k in sorted(a, key=repr):
            d = first_diff(a[k], b[k], f"{path}/{k}")
            if d:
                return d
        return None
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return f"{path} length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            d = first_diff(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else f"{path}: {a!r} != {b!r}"
