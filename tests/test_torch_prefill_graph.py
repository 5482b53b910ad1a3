"""The engine's prefill body and slot insert on the CPU, held against the JAX
package at smoke size for each served family: dense qwen2, MoE granite,
hybrid zamba2 and ssm xlstm.

- ``prefill_body``, which TorchEngine captures in one CUDA graph per prefill
  shape on the card, runs under FakeTensorMode, where any host read of
  tensor data raises; the negative cases insert one into the prefill step.
- ``insert_slot`` (a device slot index, in place) equals the reference's
  ``JaxEngine._insert_impl`` on the same prefill caches, bit for bit, also
  into a slot that held a longer prompt before.
- Across admissions that reuse one shape, a shorter prompt after a longer
  one among them, the engine's static buffers keep their storage, its cache
  (pads included) equals JaxEngine's after every step within atol 2e-4 /
  rtol 2e-3 (tests/test_torch_serve_step.py), and its tokens equal
  JaxEngine's.
- A prompt the cache cannot hold is turned away at ``submit``; the
  reference's answer to one (a first token read past its bucket) is pinned.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           DynamicOutputShapeException, FakeTensorMode)

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import api as jax_api
from repro.serving.engine import JaxEngine
from repro.train.checkpoint import _flatten
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import common as cm
from repro_torch.serving.engine import TorchEngine, insert_slot, prefill_body

ARCHS = ["qwen2-1.5b", "granite-moe-3b-a800m", "zamba2-1.2b", "xlstm-350m"]
TOL = dict(atol=2e-4, rtol=2e-3)


def _setup(arch, key=0):
    jcfg = jax_smoke_config(arch)
    jparams, _ = jax_api.get_model(jcfg).init(jax.random.PRNGKey(key), jcfg)
    cfg = get_smoke_config(arch)
    return jcfg, jparams, cfg, params_from_numpy(_flatten(jparams), cfg, "cpu")


def _fake_prefill(eng, prefill_step, n):
    """``prefill_body`` over fake copies of the engine's params, cache and
    static prefill buffers of shape ``n``, under FakeTensorMode; returns the
    logits."""
    mode = FakeTensorMode()
    fake = {k: mode.from_tensor(t) for k, t in cm.flatten(eng.params).items()}
    cache = {k: mode.from_tensor(t) for k, t in eng.cache.items()}
    row = mode.from_tensor(eng._prefill_in[n])
    first, logits = mode.from_tensor(eng.first_token), mode.from_tensor(eng.prefill_logits)
    with mode:
        return prefill_body(prefill_step, eng.cfg.vocab_size, cm.nest(fake), cache,
                            row[3:].view(1, n), row[0:1], row[1:2], row[2:3], first, logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_body_reads_nothing_back_to_the_host(arch):
    _, _, cfg, params = _setup(arch)
    eng = TorchEngine(cfg, params, max_batch=3, max_len=32)
    n = eng._load_prompt(1, np.arange(1, 12))
    assert n == (11 if cfg.is_recurrent else 16)
    logits = _fake_prefill(eng, eng._prefill, n)
    assert tuple(logits.shape) == tuple(eng.prefill_logits.shape)
    assert eng.prefill_graphs == {} and eng.prefill_replays == 0   # the CPU runs it eagerly


HOST_READS = {"item": (lambda t: t[0].item(), DataDependentOutputException),
              "bool": (lambda t: bool(t[0] > 0), DataDependentOutputException),
              "int": (lambda t: int(t.max()), DataDependentOutputException),
              "tolist": (lambda t: t.tolist(), DataDependentOutputException),
              "nonzero": (lambda t: t.nonzero(), DynamicOutputShapeException)}


@pytest.mark.parametrize("read", sorted(HOST_READS))
def test_prefill_body_check_catches_a_host_read(read):
    """The same check on a prefill step with one host read of ``last``
    inserted: it raises where the read is."""
    _, _, cfg, params = _setup("qwen2-1.5b")
    eng = TorchEngine(cfg, params, max_batch=3, max_len=32)
    n = eng._load_prompt(0, np.arange(1, 6))
    fn, exc = HOST_READS[read]

    def prefill_with_read(params, batch, last):
        fn(last)
        return eng._prefill(params, batch, last)

    with pytest.raises(exc):
        _fake_prefill(eng, prefill_with_read, n)


def _jax_prefill(jcfg, jparams, prompt, n):
    toks = np.zeros((1, n), np.int32)
    toks[0, :len(prompt)] = prompt
    _, pre = jax_api.get_model(jcfg).prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                                             jnp.full((1,), len(prompt) - 1, jnp.int32))
    return pre


@pytest.mark.parametrize("arch", ARCHS)
def test_insert_equals_reference_insert(arch):
    """Prefill caches of a 20-token prompt, then of a 5-token one, into slot
    1 of three (max_len 32), each inserted by the reference's
    ``_insert_impl`` and by ``insert_slot`` with the slot and length as
    device tensors: equal bit for bit after each insert, so the shorter
    prompt leaves nothing of the longer one (K/V zeroed past its shape)."""
    jcfg, jparams, cfg, _ = _setup(arch)
    jeng = JaxEngine(jcfg, jparams, max_batch=3, max_len=32)
    jcache = jeng.cache
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    slot = torch.tensor([1])
    for S in (20, 5):
        n = S if cfg.is_recurrent else 32 if S > 16 else 16
        pre = _jax_prefill(jcfg, jparams, np.arange(3, 3 + S), n)
        jcache = JaxEngine._insert_impl(jeng, jcache, pre, 1, S)
        insert_slot(cache, {k: torch.from_numpy(np.array(v)) for k, v in pre.items()},
                    slot, torch.tensor([S]))
        assert set(cache) == set(jcache)
        for name, t in cache.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(jcache[name]),
                                          err_msg=f"{arch} S={S} {name}")
    assert cache["len"].tolist() == [0, 5, 0]


def _storage(eng):
    bufs = {**{f"cache/{k}": t for k, t in eng.cache.items()},
            **{f"prefill_in/{n}": t for n, t in eng._prefill_in.items()},
            "first_token": eng.first_token, "prefill_logits": eng.prefill_logits,
            "tokens": eng.tokens, "next_tokens": eng.next_tokens}
    return {k: (t, t.data_ptr()) for k, t in bufs.items()}


def _caches_close(what, tcache, jcache):
    assert set(tcache) == set(jcache)
    for name, t in tcache.items():
        if name == "len":
            assert t.tolist() == np.asarray(jcache[name]).tolist(), what
        else:
            np.testing.assert_allclose(t.float().numpy(), np.asarray(jcache[name], np.float32),
                                       err_msg=f"{what} {name}", **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_reused_shapes_keep_buffers_and_equal_jax_engine(arch):
    """Two slots, four requests of 14, 30, 14 and 5 tokens: the third
    reuses the first's shape in the first's slot, and the fourth is the
    shortest (attention families: the 16-token bucket again, after a
    14-token prompt in it). Stepped in lockstep with JaxEngine: after every
    step the caches agree, pads and idle slots included; the static buffers
    of each shape keep their storage from its first admission on; the
    tokens are equal."""
    jcfg, jparams, cfg, params = _setup(arch, key=5)
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(1, cfg.vocab_size, size=(n,)), m)
            for n, m in ((14, 2), (30, 4), (14, 3), (5, 3))]
    jeng = JaxEngine(jcfg, jparams, max_batch=2, max_len=64)
    eng = TorchEngine(cfg, params, max_batch=2, max_len=64)
    objs = []
    for e in (jeng, eng):
        for i, (p, m) in enumerate(reqs):
            e.submit(i, p, m)
        objs.append(list(e.queue))
    seen = {}
    for k in range(40):
        if not (eng.queue or any(eng.slots)):
            break
        jeng.step()
        eng.step()
        _caches_close(f"{arch} step {k}", eng.cache, jeng.cache)
        for name, (t, ptr) in _storage(eng).items():
            t0, ptr0 = seen.setdefault(name, (t, ptr))
            assert t is t0 and ptr == ptr0, (arch, k, name)
    assert not (jeng.queue or any(jeng.slots))
    shapes = [n for kind, n, _ in eng.iteration_log if kind == "prefill"]
    assert shapes == ([14, 30, 14, 5] if cfg.is_recurrent else [16, 32, 16, 16])
    assert sorted(eng._prefill_in) == sorted(set(shapes))
    assert eng.prefill_graphs == {} and eng.prefill_replays == 0
    want, got = ([r.out_tokens for r in o] for o in objs)
    assert [len(t) for t in got] == [m + 1 for _, m in reqs]
    assert got == want


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-1.2b"])
def test_submit_turns_away_a_prompt_the_cache_cannot_hold(arch):
    """K/V of max_len positions: a longer prompt, or an empty one, raises
    ValueError at submit, before any device work, and is not queued; a
    prompt of exactly max_len fills its shape (nothing left to zero) and
    gives JaxEngine's tokens. (The xLSTM's cache holds no positions: it
    takes any length, tests/test_torch_xlstm.py.)"""
    jcfg, jparams, cfg, params = _setup(arch)
    eng = TorchEngine(cfg, params, max_batch=2, max_len=32)
    rng = np.random.default_rng(0)
    for S in (33, 40, 0):
        with pytest.raises(ValueError, match="max_len=32"):
            eng.submit(0, rng.integers(0, cfg.vocab_size, size=(S,)), 3)
    assert eng.queue == [] and eng._prefill_in == {} and eng.iteration_log == []
    prompt = rng.integers(0, cfg.vocab_size, size=(32,))
    outs = []
    for e in (JaxEngine(jcfg, jparams, max_batch=2, max_len=32), eng):
        e.submit(0, prompt, 3)
        outs.append(e.drain()[0].out_tokens)
    assert len(outs[1]) == 4 and outs[1] == outs[0]


def test_reference_reads_past_its_bucket():
    """The reference's answer to a prompt longer than max_len (ROADMAP §C):
    JaxEngine clips the tokens to the bucket but samples position S - 1,
    past it, and its first token is 0 (qwen2 smoke, seed 0, max_len 32)."""
    jcfg, jparams, _, _ = _setup("qwen2-1.5b")
    rng = np.random.default_rng(0)
    for S in (33, 40):
        eng = JaxEngine(jcfg, jparams, max_batch=2, max_len=32)
        eng.submit(0, rng.integers(0, jcfg.vocab_size, size=(S,)), 3)
        assert eng.drain()[0].out_tokens[0] == 0, S
