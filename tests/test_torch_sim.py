"""The port's event simulator against the JAX package's (both on the CPU),
bit for bit: the stage cost model's iteration times and caps, batched and
oracle runs, kills mid-span and exactly on a span boundary, cold-start
holds and drains, and the token-run and arrival-window queries (the
port's are tensors on the simulator's device) at seeded random windows."""
from dataclasses import astuple

import numpy as np
import pytest
import torch

from _torch_ctl import (MODEL, PORT, REF, SIDES, env, first_diff,
                        sim_digest, simulator, submit, templates, tset)

TEMPS = {}


@pytest.fixture(autouse=True)
def _two_threads():
    """Small CPU ops: two intra-op threads a test (see
    tests/test_torch_templates.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _temps(model=MODEL):
    """Both sides' template sets, asserted equal first."""
    if model not in TEMPS:
        r, p = templates(REF, model), templates(PORT, model)
        for a, b in zip(r, p):
            assert tset(b) == tset(a)
        TEMPS[model] = {id(REF): r, id(PORT): p}
    return TEMPS[model]


def _pre_dec(side):
    return _temps()[id(side)]


WINDOWS = [(float(a), float(a + 60)) for a in range(0, 3600, 60)]


# ------------------------------------------------------------ cost model
@pytest.mark.parametrize("model", ["phi4-14b", "gpt-oss-20b", "qwen3-32b"])
def test_cost_model_bit_for_bit(model):
    """Stages, iteration times, pipeline latencies, the prefill chunk and
    the decode cap of every template of both phases (gpt-oss-20b is a
    MoE: its decode reads saturate, the nonlinear stage path)."""
    pair = _temps(model)
    _, _, wr, cr = env(REF, model)
    _, _, wp, cp = env(PORT, model)
    mr, mp = REF.M.PAPER_MODELS[model], PORT.M.PAPER_MODELS[model]
    for tr, tp in zip(sum(pair[id(REF)], []), sum(pair[id(PORT)], [])):
        a = REF.Cm.InstanceCostModel(mr, tr.phase, tr.placement, cr,
                                     wr[model])
        b = PORT.Cm.InstanceCostModel(mp, tp.phase, tp.placement, cp,
                                      wp[model])
        assert [astuple(s) for s in b.stages] == \
            [astuple(s) for s in a.stages]
        assert b.slo_s == a.slo_s
        for n in (1, 2, 7, 64, 512, 4096):
            assert b.kv_transfer_time(n) == a.kv_transfer_time(n)
            if tr.phase == "prefill":
                assert b.prefill_iter_time(n) == a.prefill_iter_time(n)
                assert b.prefill_pipeline_latency(n) == \
                    a.prefill_pipeline_latency(n)
            else:
                assert b.decode_iter_time(n) == a.decode_iter_time(n)
                assert b.decode_times(n) == a.decode_times(n)
        if tr.phase == "prefill":
            assert b.prefill_chunk == a.prefill_chunk
        else:
            assert b.decode_capacity == a.decode_capacity
            assert type(b.decode_capacity) is int


# ------------------------------------------------------------- gauntlet
def _gauntlet(side, batched):
    """The reference's seeded gauntlet: cold start, decode and prefill
    kills mid-flight, a drain, a scale-up and epoch-style horizons."""
    pre, dec = _pre_dec(side)
    sim = simulator(side, batched)
    sim.add_instance("r0", pre[0], ready_delay=side.S.INIT_DELAY_S)
    sim.add_instance("r0", dec[0], ready_delay=side.S.INIT_DELAY_S)
    sim.add_instance("r0", dec[1], ready_delay=side.S.INIT_DELAY_S)
    sim.add_instance("r0", pre[1], ready_delay=side.S.INIT_DELAY_S)
    submit(side, sim, 3.0, 300, 7)
    sim.run_until(120.0)
    sim.kill_instance(sim.instances[1])
    sim.run_until(200.0)
    sim.kill_instance(sim.instances[0])
    sim.run_until(240.0)
    sim.drain_instance(sim.instances[2])
    sim.add_instance("r0", dec[0])
    for t in (360.0, 480.0, 3600.0):
        sim.run_until(t)
    return sim


_GAUNTLET = {}


def _gauntlet_cached(side, batched):
    key = (id(side), batched)
    if key not in _GAUNTLET:
        _GAUNTLET[key] = _gauntlet(side, batched)
    return _GAUNTLET[key]


@pytest.mark.parametrize("batched", [True, False])
def test_gauntlet_matches_the_reference(batched):
    want = sim_digest(_gauntlet_cached(REF, batched), WINDOWS)
    got = sim_digest(_gauntlet_cached(PORT, batched), WINDOWS)
    assert first_diff(got, want) is None, first_diff(got, want)


def test_port_batched_equals_its_oracle():
    """The port keeps the reference's own contract: the batched loop
    reproduces the per-iteration loop bit for bit, with far fewer runs."""
    s1, s2 = _gauntlet_cached(PORT, False), _gauntlet_cached(PORT, True)
    d1, d2 = sim_digest(s1, WINDOWS), sim_digest(s2, WINDOWS)
    for d in (d1, d2):
        d.pop("instances")      # span state differs by design
    assert first_diff(d2, d1) is None, first_diff(d2, d1)
    assert s2.tokens[MODEL].n_runs < s1.tokens[MODEL].n_runs


# ---------------------------------------------------- kills, holds, drains
def _four(side, batched, ready_delay=0.0):
    pre, dec = _pre_dec(side)
    sim = simulator(side, batched)
    for t in (pre[0], pre[1], dec[0], dec[1]):
        sim.add_instance("r0", t, ready_delay=ready_delay)
    return sim


def _kill_run(side, batched, t_kill, victim, drain_first=False, rate=3.0,
              seed=11):
    sim = _four(side, batched)
    submit(side, sim, rate, 120, seed)
    sim.run_until(t_kill)
    inst = sim.instances[victim]
    if drain_first:
        sim.drain_instance(inst)
    sim.kill_instance(inst)
    sim.run_until(7200.0)
    return sim


def _span_boundary(side):
    """The first decode span boundary ahead of t=60 on instance 2."""
    probe = _four(side, True)
    submit(side, probe, 3.0, 120, 11)
    probe.run_until(60.0)
    sp = probe.instances[2].span
    assert sp is not None, "expects an in-flight span"
    ahead = [b for b in sp.bounds if b > probe.now + 1e-9]
    assert ahead
    return ahead[0]


@pytest.mark.parametrize("case", ["mid_span", "draining", "prefill_queue",
                                  "span_boundary"])
def test_kills_match_the_reference_batched_and_oracle(case):
    kw = {"mid_span": dict(t_kill=90.0, victim=2),
          "draining": dict(t_kill=90.0, victim=2, drain_first=True),
          "prefill_queue": dict(t_kill=40.0, victim=0, rate=30.0, seed=12),
          "span_boundary": None}[case]
    if kw is None:
        t_star = _span_boundary(REF)
        assert _span_boundary(PORT) == t_star
        kw = dict(t_kill=t_star, victim=2)
    digests = {}
    for side in SIDES:
        for batched in (True, False):
            sim = _kill_run(side, batched, **kw)
            assert sim.instances[kw["victim"]].dead
            d = sim_digest(sim, [(0.0, 7200.0), (30.0, 95.5)])
            d.pop("instances")
            digests[(id(side), batched)] = d
    want = digests[(id(REF), True)]
    for key, d in digests.items():
        assert first_diff(d, want) is None, (key, first_diff(d, want))


def test_cold_start_holds_and_drain_match_the_reference():
    out = []
    for side in SIDES:
        sim = _four(side, True, ready_delay=side.S.INIT_DELAY_S)
        reqs = submit(side, sim, 1.0, 60, 3)
        assert all(r.arrival < side.S.INIT_DELAY_S for r in reqs)
        sim.run_until(200.0)
        sim.drain_instance(sim.instances[2])
        sim.run_until(3600.0)
        assert sim.dropped == 0
        assert {r.rid for r in sim.finished} == {r.rid for r in reqs}
        assert sim.instances[2].idle()
        out.append(sim_digest(sim, WINDOWS))
    assert first_diff(out[1], out[0]) is None, first_diff(out[1], out[0])


def test_no_pool_drops_like_the_reference():
    for side in SIDES:
        sim = simulator(side)
        sim.submit(side.W.Request(0, MODEL, 1.0, 64, 8))
        sim.run_until(100.0)
        assert sim.dropped == 1 and sim.dropped_by_model[MODEL] == 1


# ------------------------------------------------------ queries, seeded
def test_token_runs_and_arrival_windows_at_random_windows():
    """``TokenRuns.count`` (all and SLO-ok), ``gap_samples`` and the
    arrival windows at seeded random windows, edges on run boundaries
    included, against the reference's numpy queries; results are Python
    numbers."""
    ref = _gauntlet_cached(REF, True)
    port = _gauntlet_cached(PORT, True)
    rng = np.random.default_rng(0)
    tr_r, tr_p = ref.tokens[MODEL], port.tokens[MODEL]
    ends = np.array(tr_r._end)
    edges = np.concatenate([rng.uniform(-10.0, 3700.0, 120),
                            rng.choice(ends, 40), [-np.inf, np.inf]])
    for _ in range(150):
        q0, q1 = sorted(float(x) for x in rng.choice(edges, 2))
        for ok in (False, True):
            got = tr_p.count(q0, q1, ok_only=ok)
            assert type(got) is int
            assert got == tr_r.count(q0, q1, ok_only=ok), (q0, q1, ok)
        v_r, w_r = tr_r.gap_samples(q0, q1)
        v_p, w_p = tr_p.gap_samples(q0, q1)
        assert v_p.dtype == torch.float64 and w_p.dtype == torch.int64
        assert v_p.numpy().tobytes() == v_r.tobytes()
        assert w_p.numpy().tolist() == w_r.tolist()
        a_r = ref.obs[MODEL].arrival.window(q0, q1)
        a_p = port.obs[MODEL].arrival.window(q0, q1)
        assert a_p == a_r and [type(x) for x in a_p] == [int, float, float]


def test_token_runs_window_counts():
    tr = PORT.S.TokenRuns(device="cpu")
    tr.add(0.5, 1.0, 3, 2, True, 3.5)       # boundaries 1.5, 2.5, 3.5
    tr.add(3.0, 1.0, 1, 3, False, 4.0)      # one boundary at 4.0
    assert len(tr) == 9
    assert tr.count(0.0, 10.0) == 9
    assert tr.count(0.0, 10.0, ok_only=True) == 6
    assert tr.count(2.0, 3.6) == 4
    assert tr.count(3.9, 4.1) == 3
    assert tr.count(4.0, 10.0) == 3
    assert tr.count(0.0, 1.5) == 0
    v, w = tr.gap_samples(2.0, 3.6)
    assert v.tolist() == [1.0] and w.tolist() == [4]


def test_simulator_defaults_to_the_card():
    models, _, wls, cfg = env(PORT)
    if torch.cuda.is_available():
        assert PORT.S.Simulator(models, cfg, wls).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PORT.S.Simulator(models, cfg, wls)
        with pytest.raises(RuntimeError, match="CUDA"):
            PORT.S.TokenRuns()
