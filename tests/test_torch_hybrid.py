"""The port's hybrid Mamba2 + shared-attention model (zamba2 smoke, fp32)
against the JAX package on the CPU: the same params (JAX init, carried
over through the checkpoint key layout) and the same tokens give the same
logits and the same SSM, conv and K/V caches. atol 2e-4 / rtol 2e-3, the
repo's own model bound (tests/test_models.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import api as jax_api
from repro.train.checkpoint import _flatten
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import api as mapi
from repro_torch.models import hybrid

ARCH = "zamba2-1.2b"
TOL = dict(atol=2e-4, rtol=2e-3)


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
    for name in ("ssm", "conv", "k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                   err_msg=name, **TOL)
    assert tcache["len"].tolist() == np.asarray(jcache["len"]).tolist()


def test_config_copies_match_the_reference():
    for ours, theirs in ((get_config(ARCH), jax_config(ARCH)),
                         (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_ff", "vocab_size", "resolved_head_dim", "qkv_bias", "rope",
                  "rope_theta", "sliding_window", "norm_eps", "tie_embeddings",
                  "dtype", "ssm_state", "ssm_head_dim", "ssm_expand", "ssm_conv",
                  "attn_every", "d_inner", "ssm_nheads", "is_recurrent"):
            assert getattr(ours, f) == getattr(theirs, f), f
    assert hybrid._groups(get_smoke_config(ARCH))[-1] == (6, 7, False)
    assert hybrid.n_insertions(get_config(ARCH)) == 6


def test_forward_matches_jax(setup):
    jcfg, jmodel, jparams, cfg, model, params = setup
    toks = _tokens(cfg, 2, 16)
    want, _ = jmodel.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = model.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert aux == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,last", [(16, (9, 15)), (100, (99, 40)), (2, (1, 0))])
def test_prefill_and_decode_match_jax(setup, S, last):
    """prefill with last_pos, then two decode steps over a padded cache; S=2
    leaves the conv tail left-padded (S < ssm_conv - 1 = 3)."""
    jcfg, jmodel, jparams, cfg, model, params = setup
    toks = _tokens(cfg, 2, S)
    last = np.array(last, np.int32)
    jl, jcache = jmodel.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                                jnp.asarray(last))
    tl, tcache = model.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                               torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _cache_close(tcache, jcache)

    pad = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
    jcache = dict(jcache, k=jnp.pad(jcache["k"], pad), v=jnp.pad(jcache["v"], pad))
    tcache = dict(tcache, k=torch.from_numpy(np.array(jcache["k"])),
                  v=torch.from_numpy(np.array(jcache["v"])))
    for step_toks in _tokens(cfg, 2, 2, seed=3).T:
        jl, jcache = jmodel.decode_step(jparams, jcfg, jcache, jnp.asarray(step_toks))
        tl, tcache = model.decode_step(params, cfg, tcache, torch.from_numpy(step_toks))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _cache_close(tcache, jcache)


def test_decode_matches_forward():
    """decode_step(prefill(prompt)) agrees with teacher forcing, on the port
    alone with its own init."""
    cfg = get_smoke_config(ARCH)
    model = mapi.get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(_tokens(cfg, 2, 12))
    lp, cache = model.prefill(params, cfg, {"tokens": toks})
    nxt = lp[:, :cfg.vocab_size].argmax(-1)
    pad = torch.zeros(cache["k"].shape[:2] + (4,) + cache["k"].shape[3:])
    cache = dict(cache, k=torch.cat([cache["k"], pad], 2), v=torch.cat([cache["v"], pad], 2))
    ld, cache = model.decode_step(params, cfg, cache, nxt)
    logits2, _ = model.forward(params, cfg, {"tokens": torch.cat([toks, nxt[:, None]], 1)})
    np.testing.assert_allclose(ld.numpy(), logits2[:, -1].numpy(), **TOL)


def test_params_round_trip(setup):
    _, _, jparams, _, _, params = setup
    flat = _flatten(jparams)
    back = params_to_numpy(params)
    assert set(back) == set(flat)
    for key, a in flat.items():
        np.testing.assert_array_equal(back[key], np.asarray(a, np.float32), key)


def test_init_reproduces_the_jax_constants(setup):
    """A_log, D, dt_bias and conv_b are the JAX init's constants, and every
    random weight has the JAX init's scale (std 1/sqrt(fan_in))."""
    _, _, jparams, cfg, model, _ = setup
    ours = params_to_numpy(model.init(torch.Generator().manual_seed(0), cfg))
    theirs = _flatten(jparams)
    for key in ("mamba/A_log", "mamba/D", "mamba/dt_bias", "mamba/conv_b",
                "mamba/ln/scale", "shared/ln/scale", "ln_f/scale"):
        np.testing.assert_allclose(ours[key], np.asarray(theirs[key]), rtol=1e-6, err_msg=key)
    for key in ("mamba/in_proj", "mamba/conv_w", "mamba/out_proj", "shared/attn/wq",
                "shared/mlp/wd", "emb/embed"):
        ratio = ours[key].std() / np.asarray(theirs[key]).std()
        assert 0.8 < ratio < 1.25, (key, ratio)


def test_ssm_params_stay_fp32_in_a_bf16_model():
    cfg = get_smoke_config(ARCH).with_(dtype="bfloat16")
    model = mapi.get_model(cfg)
    for params in (params_from_numpy(params_to_numpy(model.init(
                       torch.Generator().manual_seed(0), cfg)), cfg, "cpu"),
                   model.init(torch.Generator().manual_seed(0), cfg)):
        mamba = params["mamba"]
        assert {mamba[k].dtype for k in ("A_log", "D", "dt_bias")} == {torch.float32}
        assert {mamba[k].dtype for k in ("in_proj", "conv_w", "out_proj")} == {torch.bfloat16}
        assert params["shared"]["attn"]["wq"].dtype == torch.bfloat16


def test_bf16_model_runs_and_keeps_a_fp32_state():
    """A bf16 smoke model end to end on the CPU: finite logits, the SSM cache
    in fp32 and the conv/KV caches in bf16, through prefill and decode."""
    cfg = get_smoke_config(ARCH).with_(dtype="bfloat16")
    model = mapi.get_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), cfg)
    lp, cache = model.prefill(params, cfg, {"tokens": torch.from_numpy(_tokens(cfg, 1, 70))})
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].dtype == cache["k"].dtype == torch.bfloat16
    ld, cache = model.decode_step(params, cfg, dict(cache), lp[:, :cfg.vocab_size].argmax(-1))
    assert bool(torch.isfinite(lp.float()).all()) and bool(torch.isfinite(ld.float()).all())
