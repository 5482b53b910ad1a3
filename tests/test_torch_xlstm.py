"""The port's xLSTM (xlstm smoke, fp32) against the JAX package on the CPU:
the same params (JAX init, carried over through the checkpoint key layout)
and the same tokens give the same logits and the same mLSTM and sLSTM
state, through forward, prefill and decode, and the same greedy tokens
through the engines. atol 2e-4 / rtol 2e-3, the repo's own model bound
(tests/test_models.py); the chunked mLSTM against the token recurrence at
5e-4, the bound of the JAX package's own chunk-boundary test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import api as jax_api
from repro.models import xlstm as jax_xlstm
from repro.serving.engine import JaxEngine
from repro.train.checkpoint import Checkpointer as JaxCheckpointer
from repro.train.checkpoint import _flatten
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import api as mapi
from repro_torch.models import common as cm
from repro_torch.models import xlstm
from repro_torch.serving.engine import TorchEngine
from repro_torch.train.checkpoint import Checkpointer

ARCH = "xlstm-350m"
TOL = dict(atol=2e-4, rtol=2e-3)
STATE = ("mC", "mn", "mm", "conv", "sc", "sn", "sh", "sm")


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_config(ARCH)
    jmodel = jax_api.get_model(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(ARCH)
    params = params_from_numpy(_flatten(jparams), cfg, "cpu")
    return jcfg, jmodel, jparams, cfg, mapi.get_model(cfg), params


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)) \
        .astype(np.int32)


def _cache_close(tcache, jcache):
    assert set(tcache) == set(jcache)
    for name in STATE:
        assert tcache[name].shape == jcache[name].shape, name
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                   err_msg=name, **TOL)
    assert tcache["len"].tolist() == np.asarray(jcache["len"]).tolist()


def test_config_copies_match_the_reference():
    for ours, theirs in ((get_config(ARCH), jax_config(ARCH)),
                         (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_ff", "vocab_size", "resolved_head_dim", "rope", "norm_eps",
                  "tie_embeddings", "dtype", "param_dtype", "remat", "slstm_every",
                  "mlstm_expand", "mlstm_d_inner", "is_recurrent"):
            assert getattr(ours, f) == getattr(theirs, f), f
        assert xlstm._layout(ours) == jax_xlstm._layout(theirs)
    full = get_config(ARCH)
    assert (xlstm.n_mlstm(full), xlstm.n_slstm(full), full.mlstm_d_inner) == (20, 4, 2048)


def test_param_shapes_match_the_jax_init_and_gates_stay_fp32(setup):
    """Keys and shapes are the JAX init's; the gate projections and the
    sLSTM recurrence stay fp32 in a bf16 model, from the port's init and
    through params_from_numpy."""
    _, _, jparams, cfg, model, _ = setup
    want = {k: tuple(np.shape(v)) for k, v in _flatten(jparams).items()}
    assert model.param_shapes(cfg) == want
    bf = cfg.with_(dtype="bfloat16")
    for params in (params_from_numpy(params_to_numpy(model.init(
                       torch.Generator().manual_seed(0), bf)), bf, "cpu"),
                   model.init(torch.Generator().manual_seed(0), bf)):
        flat = {k: v.dtype for k, v in cm.flatten(params).items()}
        assert {flat[k] for k in xlstm.FP32_KEYS} == {torch.float32}
        assert {v for k, v in flat.items() if k not in xlstm.FP32_KEYS} == {torch.bfloat16}


def _token_recurrence(qh, kh, vh, li, lf):
    """The mLSTM's exact recurrent form, token by token, in numpy fp32
    (tests/test_models.py::test_mlstm_chunk_boundary_property)."""
    B, S, H, dh = qh.shape
    C = np.zeros((B, H, dh, dh), np.float32)
    n = np.zeros((B, H, dh), np.float32)
    m = np.full((B, H), -1e30, np.float32)
    outs = []
    for t in range(S):
        m_new = np.maximum(lf[:, t] + m, li[:, t])
        fs, i_s = np.exp(lf[:, t] + m - m_new), np.exp(li[:, t] - m_new)
        C = fs[..., None, None] * C + i_s[..., None, None] \
            * np.einsum("bhd,bhe->bhde", vh[:, t], kh[:, t])
        n = fs[..., None] * n + i_s[..., None] * kh[:, t]
        den = np.maximum(np.abs(np.einsum("bhd,bhd->bh", n, qh[:, t])), np.exp(-m_new))
        outs.append(np.einsum("bhde,bhe->bhd", C, qh[:, t]) / den[..., None])
        m = m_new
    return np.stack(outs, 1), (C, n, m)


@pytest.mark.parametrize("S", [512, 300])
def test_mlstm_chunked_matches_jax_and_the_token_recurrence(S):
    """S=512 runs as two chunks of 256 (the state crosses a chunk boundary),
    S=300 as one chunk that 256 does not divide."""
    rng = np.random.default_rng(3)
    B, H, dh = 2, 2, 8
    q, k, v = (rng.normal(size=(B, S, H, dh)).astype(np.float32) for _ in range(3))
    li = rng.normal(size=(B, S, H)).astype(np.float32)
    lf = np.array(jax.nn.log_sigmoid(jnp.asarray(rng.normal(size=(B, S, H)), jnp.float32) + 2))
    want, (jC, jn, jm) = jax_xlstm._mlstm_chunked(*map(jnp.asarray, (q, k, v, li, lf)))
    got, state = xlstm._mlstm_chunked(*map(torch.from_numpy, (q, k, v, li, lf)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name, ours, theirs in zip("Cnm", state, (jC, jn, jm)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), err_msg=name, **TOL)
    rec, _ = _token_recurrence(q, k, v, li, lf)
    np.testing.assert_allclose(got.numpy(), rec, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("S", [16, 512])
def test_forward_matches_jax(setup, S):
    jcfg, jmodel, jparams, cfg, model, params = setup
    toks = _tokens(cfg, 2, S)
    want, _ = jmodel.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = model.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert aux == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [1, 2, 5, 300])
def test_prefill_and_decode_match_jax(setup, S):
    """prefill with last_pos, then 4 decode steps; every state entry after
    each. S=1 and 2 leave the conv tail front-padded (S < CONV - 1)."""
    jcfg, jmodel, jparams, cfg, model, params = setup
    toks = _tokens(cfg, 2, S)
    last = np.array([S - 1, S // 2], np.int32)
    jl, jcache = jmodel.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, jnp.asarray(last))
    tl, tcache = model.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                               torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _cache_close(tcache, jcache)
    for step_toks in _tokens(cfg, 2, 4, seed=3).T:
        jl, jcache = jmodel.decode_step(jparams, jcfg, jcache, jnp.asarray(step_toks))
        tl, tcache = model.decode_step(params, cfg, tcache, torch.from_numpy(step_toks))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _cache_close(tcache, jcache)


def test_decode_matches_forward():
    """decode_step(prefill(prompt)) agrees with teacher forcing, on the port
    alone with its own init: the recurrent and the chunked forms agree."""
    cfg = get_smoke_config(ARCH)
    model = mapi.get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(_tokens(cfg, 2, 12))
    lp, cache = model.prefill(params, cfg, {"tokens": toks})
    logits, _ = model.forward(params, cfg, {"tokens": toks})
    np.testing.assert_allclose(lp.numpy(), logits[:, -1].numpy(), **TOL)
    for _ in range(3):
        nxt = lp[:, :cfg.vocab_size].argmax(-1)
        toks = torch.cat([toks, nxt[:, None]], 1)
        lp, cache = model.decode_step(params, cfg, cache, nxt)
        logits, _ = model.forward(params, cfg, {"tokens": toks})
        np.testing.assert_allclose(lp.numpy(), logits[:, -1].numpy(), **TOL)
    assert cache["len"].tolist() == [15, 15]


def test_params_round_trip_and_jax_checkpoint_loads(setup, tmp_path):
    """The port's params go back to the JAX keys unchanged, and a JAX
    Checkpointer's npz restores into the port's own init."""
    _, _, jparams, cfg, model, params = setup
    flat = _flatten(jparams)
    back = params_to_numpy(params)
    assert set(back) == set(flat)
    for key, a in flat.items():
        np.testing.assert_array_equal(back[key], np.asarray(a, np.float32), key)
    JaxCheckpointer(str(tmp_path)).save(3, {"p": jparams}, blocking=True)
    restored, step = Checkpointer(str(tmp_path)).restore(
        {"p": model.init(torch.Generator().manual_seed(1), cfg)})
    assert step == 3
    for key, t in params_to_numpy(restored["p"]).items():
        np.testing.assert_array_equal(t, np.asarray(flat[key], np.float32), key)


def test_init_reproduces_the_jax_constants(setup):
    """b_if, the sLSTM's b, conv_b and the norm scales are the JAX init's
    constants, and every random weight has the JAX init's scale (r: 0.1,
    conv_w: 1/sqrt(CONV), the rest 1/sqrt(fan_in))."""
    _, _, jparams, cfg, model, _ = setup
    ours = params_to_numpy(model.init(torch.Generator().manual_seed(0), cfg))
    theirs = _flatten(jparams)
    for key in ("mlstm/b_if", "slstm/b", "mlstm/conv_b", "mlstm/ln/scale", "mlstm/norm/scale",
                "slstm/ln/scale", "ln_f/scale"):
        np.testing.assert_allclose(ours[key], np.asarray(theirs[key]), rtol=1e-6, err_msg=key)
    for key in ("mlstm/up", "mlstm/conv_w", "mlstm/wq", "mlstm/w_if", "mlstm/down",
                "slstm/W", "slstm/r", "slstm/out", "emb/embed", "emb/unembed"):
        ratio = ours[key].std() / np.asarray(theirs[key]).std()
        assert 0.8 < ratio < 1.25, (key, ratio)


def test_bf16_model_runs_and_keeps_a_fp32_state():
    """A bf16 smoke model end to end on the CPU: finite logits, the mLSTM
    and sLSTM state in fp32 and the conv tail in bf16, through prefill and
    decode."""
    cfg = get_smoke_config(ARCH).with_(dtype="bfloat16")
    model = mapi.get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(_tokens(cfg, 2, 9))
    logits, cache = model.prefill(params, cfg, {"tokens": toks})
    for _ in range(2):
        assert bool(torch.isfinite(logits).all())
        assert cache["conv"].dtype == torch.bfloat16
        assert {cache[k].dtype for k in STATE if k != "conv"} == {torch.float32}
        logits, cache = model.decode_step(params, cfg, cache, logits.argmax(-1))


def test_fp64_model_stays_fp64_and_agrees_with_fp32():
    """An fp64 model keeps its gates, norms, loss and state in fp64 (the
    exact values chip_smoke.py holds the card's fp32 runs to); at smoke size
    the fp32 model agrees with it within the model bound."""
    cfg = get_smoke_config(ARCH)
    model = mapi.get_model(cfg)
    p32 = model.init(torch.Generator().manual_seed(0), cfg)
    c64 = cfg.with_(dtype="float64")
    p64 = cm.nest({k: v.double() for k, v in cm.flatten(p32).items()})
    assert {model.param_dtype(k, torch.float64) for k in xlstm.FP32_KEYS} == {torch.float64}
    toks = torch.from_numpy(_tokens(cfg, 2, 20))
    l32, c32 = model.prefill(p32, cfg, {"tokens": toks})
    l64, cache = model.prefill(p64, c64, {"tokens": toks})
    assert l64.dtype == torch.float64 and {cache[k].dtype for k in STATE} == {torch.float64}
    np.testing.assert_allclose(l32.numpy(), l64.numpy(), **TOL)
    l32, _ = model.decode_step(p32, cfg, c32, toks[:, 0])
    l64, _ = model.decode_step(p64, c64, cache, toks[:, 0])
    np.testing.assert_allclose(l32.numpy(), l64.numpy(), **TOL)
    logits, _ = model.forward(p64, c64, {"tokens": toks})
    assert cm.cross_entropy(logits, toks, cfg.vocab_size).dtype == torch.float64


def test_engine_tokens_equal_jax_engine():
    """xlstm smoke: more requests than slots, prompts of 1-40 tokens
    prefilled at their exact lengths, the whole state copied into each
    slot, and an idle slot whose length runs past max_len while the others
    decode."""
    jcfg = jax_smoke_config(ARCH)
    jparams, _ = jax_api.get_model(jcfg).init(jax.random.PRNGKey(3), jcfg)
    cfg = get_smoke_config(ARCH)
    params = params_from_numpy(_flatten(jparams), cfg, "cpu")
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, cfg.vocab_size, size=(int(n),)), int(m))
            for n, m in ((5, 30), (40, 2), (1, 4), (9, 3), (23, 5), (2, 2))]
    outs, logs = [], []
    for eng in (JaxEngine(jcfg, jparams, max_batch=3, max_len=32),
                TorchEngine(cfg, params, max_batch=3, max_len=32)):
        for i, (p, m) in enumerate(reqs):
            eng.submit(i, p, m)
        objs = list(eng.queue)
        for _ in range(3):
            eng.step()
        assert eng.queue                         # later requests wait for a slot
        eng.drain()
        assert int(np.asarray(eng.cache["len"]).max()) > 32   # an idle slot ran past
        outs.append([r.out_tokens for r in objs])
        logs.append([n for k, n, _ in eng.iteration_log if k == "prefill"])
    assert [len(t) for t in outs[1]] == [m + 1 for _, m in reqs]
    assert outs[1] == outs[0]
    assert sorted(logs[1]) == sorted(len(p) for p, _ in reqs)   # exact lengths


def test_launchers_run_on_the_cpu():
    """launch.serve and launch.train take the xLSTM on the CPU when asked."""
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train_loop
    cfg = get_smoke_config(ARCH)
    finished, summary = serve(cfg, n_requests=3, rate=1e3, max_batch=2, device="cpu")
    assert len(finished) == 3 and summary["tokens"] == sum(
        len(r.out_tokens) for r in finished.values())
    _, _, losses = train_loop(cfg, steps_total=2, batch_size=2, seq_len=16, log_every=10,
                              device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
