"""The port's serve and prefill steps and the engine's decode body on the CPU,
held against the JAX package at smoke size for each served family: dense
qwen2, MoE granite, hybrid zamba2 and ssm xlstm.

- ``make_prefill_step`` / ``make_serve_step`` of repro_torch.train.steps
  against those of repro.train.steps on the same params (JAX init, carried
  over through the checkpoint key layout): the same logits and caches,
  atol 2e-4 / rtol 2e-3, the repo's own model bound (tests/test_models.py).
- The body TorchEngine captures in a CUDA graph on the card (the serve
  step, the argmax into the next-token buffer, the copy of ``len``) runs
  under FakeTensorMode, where any host read of tensor data (``.item()``,
  ``bool()``, ``int()``, ``.tolist()``, a ``nonzero``) raises; the
  negative cases show that the check catches one. A device-to-host copy
  (``.cpu()``) is no read there, and capture itself refuses it on the card.
- Across steps and an admission between them, the engine's static buffers
  (tokens, next tokens, ``len``, K/V and state) keep their storage, and its
  greedy tokens equal JaxEngine's.
- ``all_cells`` yields the reference's 40 cells in its order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           DynamicOutputShapeException, FakeTensorMode)

from repro.configs.registry import all_cells as jax_all_cells
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import api as jax_api
from repro.serving.engine import JaxEngine
from repro.train import steps as jax_steps
from repro.train.checkpoint import _flatten
from repro_torch.configs import registry
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import common as cm
from repro_torch.serving.engine import TorchEngine, decode_body
from repro_torch.train import steps

ARCHS = ["qwen2-1.5b", "granite-moe-3b-a800m", "zamba2-1.2b", "xlstm-350m"]
TOL = dict(atol=2e-4, rtol=2e-3)
DECODE_STEPS = 3


def _setup(arch, key=0):
    jcfg = jax_smoke_config(arch)
    jparams, _ = jax_api.get_model(jcfg).init(jax.random.PRNGKey(key), jcfg)
    cfg = get_smoke_config(arch)
    return jcfg, jparams, cfg, params_from_numpy(_flatten(jparams), cfg, "cpu")


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)) \
        .astype(np.int32)


def _caches_close(tcache, jcache):
    assert set(tcache) == set(jcache)
    for name, t in tcache.items():
        assert tuple(t.shape) == tuple(jcache[name].shape), name
        if name == "len":
            assert t.tolist() == np.asarray(jcache[name]).tolist()
        else:
            np.testing.assert_allclose(t.float().numpy(), np.asarray(jcache[name], np.float32),
                                       err_msg=name, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch):
    """The factories' prefill (no ``last``: the last position's logits) and
    the port's ``last`` against the reference model's ``last_pos``."""
    jcfg, jparams, cfg, params = _setup(arch)
    toks = _tokens(cfg, 2, 12)
    jl, jcache = jax_steps.make_prefill_step(jcfg)(jparams, {"tokens": jnp.asarray(toks)})
    prefill = steps.make_prefill_step(cfg)
    tl, tcache = prefill(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _caches_close(tcache, jcache)

    last = np.array([5, 11], np.int32)
    jl, _ = jax_api.get_model(jcfg).prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                                            jnp.asarray(last))
    tl, _ = prefill(params, {"tokens": torch.from_numpy(toks)}, torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_reference(arch):
    """Prefill two prompts, room in the K/V cache for the steps to come,
    then DECODE_STEPS greedy serve steps of both factories from the same
    cache: the same logits at every step and the same cache after."""
    jcfg, jparams, cfg, params = _setup(arch)
    toks = _tokens(cfg, 2, 12)
    _, jcache = jax_steps.make_prefill_step(jcfg)(jparams, {"tokens": jnp.asarray(toks)})
    for name in ("k", "v"):
        if name in jcache:
            pad = [(0, 0)] * jcache[name].ndim
            pad[2] = (0, DECODE_STEPS)
            jcache[name] = jnp.pad(jcache[name], pad)
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    jserve, serve = jax_steps.make_serve_step(jcfg), steps.make_serve_step(cfg)
    step_toks = _tokens(cfg, 2, 1, seed=3)[:, 0]
    for _ in range(DECODE_STEPS):
        jl, jcache = jserve(jparams, jcache, jnp.asarray(step_toks))
        tl, tcache = serve(params, tcache, torch.from_numpy(step_toks))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        step_toks = np.asarray(jnp.argmax(jl[:, :cfg.vocab_size], -1)).astype(np.int32)
    _caches_close(tcache, jcache)


def _fake_body(eng, serve_step):
    """``decode_body`` over fake copies of the engine's params, cache and
    buffers, under FakeTensorMode; returns the logits."""
    mode = FakeTensorMode()
    fake = {k: mode.from_tensor(t) for k, t in cm.flatten(eng.params).items()}
    cache = {k: mode.from_tensor(t) for k, t in eng.cache.items()}
    tokens, nxt = mode.from_tensor(eng.tokens), mode.from_tensor(eng.next_tokens)
    with mode:
        return decode_body(serve_step, eng.cfg.vocab_size, cm.nest(fake), cache, tokens, nxt)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_body_reads_nothing_back_to_the_host(arch):
    _, _, cfg, params = _setup(arch)
    eng = TorchEngine(cfg, params, max_batch=3, max_len=32)
    logits = _fake_body(eng, eng._serve)
    assert logits.shape[0] == 3 and logits.shape[1] >= cfg.vocab_size
    assert eng.graph is None and eng.replays == 0      # the CPU runs the body eagerly


HOST_READS = {"item": (lambda t: t[0].item(), DataDependentOutputException),
              "bool": (lambda t: bool(t[0] > 0), DataDependentOutputException),
              "int": (lambda t: int(t.max()), DataDependentOutputException),
              "tolist": (lambda t: t.tolist(), DataDependentOutputException),
              "nonzero": (lambda t: t.nonzero(), DynamicOutputShapeException)}


@pytest.mark.parametrize("read", sorted(HOST_READS))
def test_decode_body_check_catches_a_host_read(read):
    """The same check on a serve step with one host read of ``len``
    inserted: it raises where the read is."""
    _, _, cfg, params = _setup("qwen2-1.5b")
    eng = TorchEngine(cfg, params, max_batch=3, max_len=32)
    fn, exc = HOST_READS[read]

    def serve_with_read(params, cache, tokens):
        fn(cache["len"])
        return eng._serve(params, cache, tokens)

    with pytest.raises(exc):
        _fake_body(eng, serve_with_read)


def _storage(eng):
    return {**{f"cache/{k}": (t, t.data_ptr()) for k, t in eng.cache.items()},
            "tokens": (eng.tokens, eng.tokens.data_ptr()),
            "next_tokens": (eng.next_tokens, eng.next_tokens.data_ptr())}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_buffers_stay_put_and_tokens_equal_jax_engine(arch):
    """Three requests in two slots, stepped, then a fourth submitted while
    the first ones decode: after every step the engine's cache entries are
    the same tensors at the same addresses (``_insert`` writes into them,
    nothing rebinds them), and every request's tokens equal JaxEngine's."""
    jcfg, jparams, cfg, params = _setup(arch, key=4)
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, cfg.vocab_size, size=(int(n),)), int(m))
            for n, m in ((7, 5), (13, 3), (4, 4), (9, 3))]
    outs = []
    for eng in (JaxEngine(jcfg, jparams, max_batch=2, max_len=32),
                TorchEngine(cfg, params, max_batch=2, max_len=32)):
        torch_side = isinstance(eng, TorchEngine)
        before = _storage(eng) if torch_side else None
        for i, (p, m) in enumerate(reqs[:3]):
            eng.submit(i, p, m)
        objs = list(eng.queue)
        for k in range(6):
            if k == 2:
                eng.submit(3, *reqs[3])
                objs.append(eng.queue[-1])
            eng.step()
            if torch_side:
                now = _storage(eng)
                assert now.keys() == before.keys()
                for name, (t, ptr) in before.items():
                    assert now[name][0] is t and now[name][1] == ptr, (arch, k, name)
        eng.drain()
        outs.append([r.out_tokens for r in objs])
    assert [len(t) for t in outs[1]] == [m + 1 for _, m in reqs]
    assert outs[1] == outs[0]


def test_all_cells_yields_the_reference_cells():
    """The 40 (arch, shape, runnable, reason) cells in the reference's order;
    the reference's skip reason also points to a design document this repo
    does not have, which the port's leaves out."""
    got = [(a, s.name, ok, why) for a, s, ok, why in registry.all_cells()]
    want = [(a, s.name, ok, why.replace("; see DESIGN.md §4", ""))
            for a, s, ok, why in jax_all_cells()]
    assert len(got) == 40 and got == want
    assert "all_cells" in registry.__all__
