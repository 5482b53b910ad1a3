"""The port's serving engine on the CPU: continuous batching reproduces the
model's own greedy decoding, slots are reused, and on the same params its
greedy tokens equal JaxEngine's -- also when an idle slot's length has run
past the cache."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import api as jax_api
from repro.serving.engine import JaxEngine
from repro.train.checkpoint import _flatten
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import api as mapi
from repro_torch.serving.engine import TorchEngine


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("qwen2-1.5b")
    model = mapi.get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg)
    return cfg, model, params


@pytest.fixture(scope="module")
def shared():
    """JAX params and the same params converted into the port."""
    jcfg = jax_smoke_config("qwen2-1.5b")
    jparams, _ = jax_api.get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config("qwen2-1.5b")
    return jcfg, jparams, cfg, params_from_numpy(_flatten(jparams), cfg, "cpu")


def _direct_greedy(model, cfg, params, prompt, n_new):
    batch = {"tokens": torch.from_numpy(np.asarray(prompt, np.int32))[None, :]}
    logits, cache = model.prefill(params, cfg, batch)
    pad = torch.zeros(cache["k"].shape[:2] + (n_new + 1,) + cache["k"].shape[3:])
    cache = dict(cache, k=torch.cat([cache["k"], pad], 2),
                 v=torch.cat([cache["v"], pad], 2))
    toks = [int(torch.argmax(logits[0, :cfg.vocab_size]))]
    for _ in range(n_new):
        lg, cache = model.decode_step(params, cfg, cache,
                                      torch.tensor(toks[-1:], dtype=torch.int32))
        toks.append(int(torch.argmax(lg[0, :cfg.vocab_size])))
    return toks


def test_engine_matches_direct_greedy(setup):
    """Bucket padding must be invisible: the engine's outputs equal
    greedy decoding of the exact (unpadded) prompt."""
    cfg, model, params = setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(n),))
               for n in (5, 9, 16)]
    n_new = 6
    eng = TorchEngine(cfg, params, max_batch=4, max_len=64)
    for i, p in enumerate(prompts):
        eng.submit(i, p, n_new)
    finished = eng.drain()
    assert set(finished) == {0, 1, 2}
    for i, p in enumerate(prompts):
        want = _direct_greedy(model, cfg, params, p, n_new)
        got = finished[i].out_tokens
        assert got == want, (i, got, want)
    kinds = [k for k, _, _ in eng.iteration_log]
    assert kinds.count("prefill") == 3 and kinds.count("decode") == n_new


def test_engine_slot_reuse(setup):
    cfg, model, params = setup
    rng = np.random.default_rng(1)
    eng = TorchEngine(cfg, params, max_batch=2, max_len=64)
    for i in range(5):                      # more requests than slots
        eng.submit(i, rng.integers(0, cfg.vocab_size, size=(6,)), 3)
    finished = eng.drain()
    assert set(finished) == set(range(5))
    for r in finished.values():
        assert len(r.out_tokens) == 4       # first + 3 generated


def test_engine_tokens_equal_jax_engine(shared):
    jcfg, jparams, cfg, params = shared
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, cfg.vocab_size, size=(int(n),)), int(m))
            for n, m in ((5, 7), (17, 4), (9, 9), (30, 5), (3, 6))]
    outs = []
    for eng in (JaxEngine(jcfg, jparams, max_batch=3, max_len=64),
                TorchEngine(cfg, params, max_batch=3, max_len=64)):
        for i, (p, m) in enumerate(reqs):
            eng.submit(i, p, m)
        outs.append({rid: r.out_tokens for rid, r in eng.drain().items()})
    assert outs[1] == outs[0]


def test_idle_slot_length_past_max_len(shared):
    """Slot 0 finishes early and sits idle while slot 1 decodes; its length
    keeps growing past max_len=32 (every slot advances each step). The
    port must neither write nor read past the cache, and every token must
    equal JaxEngine's -- including those of a request later admitted into
    that slot."""
    jcfg, jparams, cfg, params = shared
    rng = np.random.default_rng(3)
    short = rng.integers(0, cfg.vocab_size, size=(16,))
    long_ = rng.integers(0, cfg.vocab_size, size=(3,))
    late = rng.integers(0, cfg.vocab_size, size=(7,))
    outs = []
    for eng in (JaxEngine(jcfg, jparams, max_batch=2, max_len=32),
                TorchEngine(cfg, params, max_batch=2, max_len=32)):
        eng.submit(0, short, 1)
        eng.submit(1, long_, 28)
        reqs = list(eng.queue)
        for _ in range(24):                  # slot 0 idle from step 2 on
            eng.step()
        assert int(np.asarray(eng.cache["len"])[0]) > 32
        eng.submit(2, late, 3)               # reuses the idle slot
        reqs.append(eng.queue[-1])
        eng.drain()
        outs.append([r.out_tokens for r in reqs])
    assert [len(t) for t in outs[1]] == [2, 29, 4]
    assert outs[1] == outs[0]


def test_moe_engine_tokens_equal_jax_engine():
    """granite smoke at its default capacity factor, more requests than
    slots: idle slots (token 0) route and take expert capacity in decode,
    bucket pads do in prefill, and the port must drop the same assignments
    as JAX to give the same tokens."""
    jcfg = jax_smoke_config("granite-moe-3b-a800m")
    jparams, _ = jax_api.get_model(jcfg).init(jax.random.PRNGKey(1), jcfg)
    cfg = get_smoke_config("granite-moe-3b-a800m")
    params = params_from_numpy(_flatten(jparams), cfg, "cpu")
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, cfg.vocab_size, size=(int(n),)), int(m))
            for n, m in ((5, 7), (17, 4), (9, 12), (30, 5), (3, 6), (12, 3),
                         (7, 9), (20, 2), (4, 5))]
    outs = []
    for eng in (JaxEngine(jcfg, jparams, max_batch=6, max_len=64),
                TorchEngine(cfg, params, max_batch=6, max_len=64)):
        for i, (p, m) in enumerate(reqs):
            eng.submit(i, p, m)
        outs.append({rid: r.out_tokens for rid, r in eng.drain().items()})
    assert len(outs[1]) == len(reqs)
    assert outs[1] == outs[0]


def test_moe_idle_slot_length_past_max_len():
    """The idle-slot case above on granite smoke, widened to granite's
    head dim 64 and group G = 3: a slot whose length runs past max_len
    neither writes nor reads past the cache, and its MoE routing (token 0)
    keeps taking expert capacity exactly as in JaxEngine."""
    shape = dict(d_model=96, n_heads=6, n_kv_heads=2, head_dim=64)
    jcfg = jax_smoke_config("granite-moe-3b-a800m").with_(**shape)
    jparams, _ = jax_api.get_model(jcfg).init(jax.random.PRNGKey(2), jcfg)
    cfg = get_smoke_config("granite-moe-3b-a800m").with_(**shape)
    params = params_from_numpy(_flatten(jparams), cfg, "cpu")
    rng = np.random.default_rng(5)
    short, long_, late = (rng.integers(0, cfg.vocab_size, size=(n,)) for n in (16, 3, 7))
    outs = []
    for eng in (JaxEngine(jcfg, jparams, max_batch=2, max_len=32),
                TorchEngine(cfg, params, max_batch=2, max_len=32)):
        eng.submit(0, short, 1)
        eng.submit(1, long_, 28)
        reqs = list(eng.queue)
        for _ in range(24):
            eng.step()
        assert int(np.asarray(eng.cache["len"])[0]) > 32
        eng.submit(2, late, 3)
        reqs.append(eng.queue[-1])
        eng.drain()
        outs.append([r.out_tokens for r in reqs])
    assert [len(t) for t in outs[1]] == [2, 29, 4]
    assert outs[1] == outs[0]


def test_hybrid_engine_tokens_equal_jax_engine():
    """zamba2 smoke: more requests than slots, prompts of 5-40 tokens
    prefilled at their exact lengths (a recurrent state would absorb bucket
    pads), the SSM and conv state copied whole into each slot, and an idle
    slot whose length runs past max_len while the others decode."""
    jcfg = jax_smoke_config("zamba2-1.2b")
    jparams, _ = jax_api.get_model(jcfg).init(jax.random.PRNGKey(3), jcfg)
    cfg = get_smoke_config("zamba2-1.2b")
    params = params_from_numpy(_flatten(jparams), cfg, "cpu")
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, cfg.vocab_size, size=(int(n),)), int(m))
            for n, m in ((5, 30), (40, 2), (17, 4), (9, 3), (23, 5), (12, 2))]
    outs, logs = [], []
    for eng in (JaxEngine(jcfg, jparams, max_batch=3, max_len=48),
                TorchEngine(cfg, params, max_batch=3, max_len=48)):
        for i, (p, m) in enumerate(reqs):
            eng.submit(i, p, m)
        objs = list(eng.queue)
        for _ in range(3):
            eng.step()
        assert eng.queue                         # later requests wait for a slot
        eng.drain()
        assert int(np.asarray(eng.cache["len"]).max()) > 48   # an idle slot ran past
        outs.append([r.out_tokens for r in objs])
        logs.append([n for k, n, _ in eng.iteration_log if k == "prefill"])
    assert [len(t) for t in outs[1]] == [m + 1 for _, m in reqs]
    assert outs[1] == outs[0]
    assert sorted(logs[1]) == sorted(len(p) for p, _ in reqs)   # exact lengths
