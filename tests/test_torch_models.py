"""The port's dense and MoE models against the JAX package on the CPU: the
same params (JAX init, carried over through the checkpoint key layout) and
the same tokens give the same logits (and, for MoE, the same aux loss).
fp32 smoke configs; atol 2e-4 / rtol 2e-3, the repo's own model bound
(tests/test_models.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import api as jax_api
from repro.train.checkpoint import _flatten
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import api as mapi

ARCHS = ["qwen2-1.5b", "glm4-9b", "minicpm-2b", "mistral-nemo-12b",
         "granite-moe-3b-a800m", "dbrx-132b"]
TOL = dict(atol=2e-4, rtol=2e-3)


def _setup(arch):
    jcfg = jax_smoke_config(arch)
    jmodel = jax_api.get_model(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(arch)
    params = params_from_numpy(_flatten(jparams), cfg, "cpu")
    return jcfg, jmodel, jparams, cfg, mapi.get_model(cfg), params


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)) \
        .astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_the_reference(arch):
    from repro.configs.registry import get_config as jax_config
    from repro_torch.configs.registry import get_config
    for ours, theirs in ((get_config(arch), jax_config(arch)),
                         (get_smoke_config(arch), jax_smoke_config(arch))):
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab_size", "resolved_head_dim",
                  "qkv_bias", "rope", "rope_theta", "sliding_window",
                  "norm_eps", "tie_embeddings", "dtype", "n_experts", "top_k",
                  "moe_capacity_factor", "moe_impl", "param_dtype", "remat"):
            assert getattr(ours, f) == getattr(theirs, f), (arch, f)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, jmodel, jparams, cfg, model, params = _setup(arch)
    toks = _tokens(cfg, 2, 16)
    want, jaux = jmodel.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = model.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    if cfg.family == "dense":
        assert aux == 0.0
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """prefill (with last_pos) then two decode steps over a padded cache."""
    jcfg, jmodel, jparams, cfg, model, params = _setup(arch)
    toks = _tokens(cfg, 2, 16)
    last = np.array([9, 15], np.int32)
    jl, jcache = jmodel.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                                jnp.asarray(last))
    tl, tcache = model.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                               torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), **TOL)
    assert tcache["len"].tolist() == [16, 16]

    pad = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
    jcache = dict(jcache, k=jnp.pad(jcache["k"], pad), v=jnp.pad(jcache["v"], pad))
    tcache = dict(tcache, k=torch.from_numpy(np.array(jcache["k"])),
                  v=torch.from_numpy(np.array(jcache["v"])))
    for step_toks in _tokens(cfg, 2, 2, seed=3).T:
        jl, jcache = jmodel.decode_step(jparams, jcfg, jcache, jnp.asarray(step_toks))
        tl, tcache = model.decode_step(params, cfg, tcache,
                                       torch.from_numpy(step_toks))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]), **TOL)
    assert tcache["len"].tolist() == np.asarray(jcache["len"]).tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """decode_step(prefill(prompt)) agrees with teacher forcing, on the
    port alone with its own random init (MoE without capacity drops: the
    one-hot queue spans every token of a call, so a drop in the 26-token
    forward need not happen in the 2-token decode)."""
    cfg = get_smoke_config(arch).with_(moe_capacity_factor=100.0)
    model = mapi.get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(_tokens(cfg, 2, 12))
    lp, cache = model.prefill(params, cfg, {"tokens": toks})
    nxt = lp[:, :cfg.vocab_size].argmax(-1)
    pad = torch.zeros(cache["k"].shape[:2] + (4,) + cache["k"].shape[3:])
    cache = dict(cache, k=torch.cat([cache["k"], pad], 2),
                 v=torch.cat([cache["v"], pad], 2))
    ld, cache = model.decode_step(params, cfg, cache, nxt)
    logits2, _ = model.forward(params, cfg,
                               {"tokens": torch.cat([toks, nxt[:, None]], 1)})
    np.testing.assert_allclose(ld.numpy(), logits2[:, -1].numpy(), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    jcfg, _, jparams, cfg, _, params = _setup(arch)
    flat = _flatten(jparams)
    back = params_to_numpy(params)
    assert set(back) == set(flat)
    for key, a in flat.items():
        np.testing.assert_array_equal(back[key], np.asarray(a, np.float32), key)


def test_params_from_numpy_rejects_wrong_keys_and_shapes():
    cfg = get_smoke_config("qwen2-1.5b")
    flat = params_to_numpy(mapi.get_model(cfg).init(torch.Generator().manual_seed(0), cfg))
    with pytest.raises(KeyError):
        params_from_numpy({k: v for k, v in flat.items() if k != "ln_f/scale"},
                          cfg, "cpu")
    with pytest.raises(ValueError):
        params_from_numpy(dict(flat, **{"ln_f/scale": flat["ln_f/scale"][:-1]}),
                          cfg, "cpu")


def test_params_from_numpy_keeps_the_router_fp32():
    """The MoE router is fp32 in a bf16 model (the JAX init makes it so,
    and routing is computed in fp32); every other weight takes the model's
    dtype, in the port's init too."""
    cfg = get_smoke_config("granite-moe-3b-a800m").with_(dtype="bfloat16")
    model = mapi.get_model(cfg)
    for params in (params_from_numpy(params_to_numpy(model.init(
                       torch.Generator().manual_seed(0), cfg)), cfg, "cpu"),
                   model.init(torch.Generator().manual_seed(0), cfg)):
        moe = params["layers"]["moe"]
        assert moe["router"].dtype == torch.float32
        assert {moe[k].dtype for k in ("wg", "wu", "wd")} == {torch.bfloat16}
        assert params["emb"]["embed"].dtype == torch.bfloat16


def test_unported_families_and_devices_raise(monkeypatch):
    """Every arch and family of the reference is ported (xlstm-350m and
    family ssm last); an unknown arch or family still raises, and so does a
    CUDA device where there is none."""
    from repro.configs.registry import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.kernels.common import resolve_device
    from repro_torch.models import xlstm
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)
    assert mapi.get_model(get_config("xlstm-350m")) is xlstm
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    with pytest.raises(NotImplementedError):
        mapi.get_model(get_smoke_config("qwen2-1.5b").with_(family="no-such-family"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
