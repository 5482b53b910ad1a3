"""The port's Qwen2-VL (vlm family: the transformer with stub vision
embeddings and M-RoPE) against the JAX package on the CPU: the same params
(JAX init, carried over through the checkpoint key layout), vision
embeddings and tokens give the same positions and logits, in forward,
prefill and decode. fp32 smoke config; atol 2e-4 / rtol 2e-3, the repo's
own model bound (tests/test_models.py).

Decode gives the new token the cache length on all three M-RoPE rows,
which does not continue the prefill's positions; the port copies that, so
its decode matches JAX's decode and, like JAX's, not its own forward
(pinned below)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import api as jax_api
from repro.models import common as jax_cm
from repro.models import transformer as jax_transformer
from repro.train.checkpoint import _flatten
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import api as mapi
from repro_torch.models import common as cm
from repro_torch.models import transformer

ARCH = "qwen2-vl-2b"
TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_config(ARCH)
    jparams, _ = jax_api.get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(ARCH)
    return jcfg, jparams, cfg, params_from_numpy(_flatten(jparams), cfg, "cpu")


def _batch(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32),
            "vision_embeds": rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_model))
            .astype(np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_configs_load_and_match_the_reference():
    assert mapi.get_model(get_config(ARCH)) is transformer
    for ours, theirs in ((get_config(ARCH), jax_config(ARCH)),
                         (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab_size", "resolved_head_dim", "qkv_bias", "rope", "rope_theta",
                  "sliding_window", "norm_eps", "tie_embeddings", "dtype", "vision_stub",
                  "n_vision_tokens", "kv_seq_shard"):
            assert getattr(ours, f) == getattr(theirs, f), f


@pytest.mark.parametrize("head_dim", [8, 16, 32, 64, 128])
def test_mrope_sections_match_jax(head_dim):
    secs = cm.mrope_sections(head_dim)
    assert secs == tuple(jax_cm.mrope_sections(head_dim))
    assert sum(secs) == head_dim // 2


@pytest.mark.parametrize("head_dim,S", [(16, 5), (128, 40)])
def test_apply_mrope_matches_jax(head_dim, S):
    """Distinct positions on the three rows, so that a band taken from the
    wrong row shows."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, S, 3, head_dim)).astype(np.float32)
    pos3 = rng.integers(0, 300, size=(3, 2, S)).astype(np.int32)
    want = jax_cm.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6)
    got = cm.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_positions_and_embeds_match_jax(setup):
    jcfg, jparams, cfg, params = setup
    batch = _batch(cfg, 2, 12)
    jh, jpos, jm = jax_transformer._positions_and_embeds(jparams, jcfg, _jax(batch))
    h, pos, m = transformer._positions_and_embeds(params, cfg, _torch(batch))
    assert jpos is None and pos is None
    assert m.shape == (3, 2, cfg.n_vision_tokens + 12)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


def test_forward_matches_jax(setup):
    jcfg, jparams, cfg, params = setup
    batch = _batch(cfg, 2, 16)
    want, _ = jax_transformer.forward(jparams, jcfg, _jax(batch))
    got, aux = transformer.forward(params, cfg, _torch(batch))
    assert aux == 0.0
    assert got.shape[:2] == (2, cfg.n_vision_tokens + 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_match_jax(setup):
    """prefill (with last_pos into the vision + text sequence), then 4
    decode steps over a padded cache."""
    jcfg, jparams, cfg, params = setup
    batch = _batch(cfg, 2, 16)
    V = cfg.n_vision_tokens
    last = np.array([V + 9, V + 15], np.int32)
    jl, jcache = jax_transformer.prefill(jparams, jcfg, _jax(batch), jnp.asarray(last))
    tl, tcache = transformer.prefill(params, cfg, _torch(batch), torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), **TOL)
    assert tcache["len"].tolist() == [V + 16, V + 16]

    pad = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
    jcache = dict(jcache, k=jnp.pad(jcache["k"], pad), v=jnp.pad(jcache["v"], pad))
    tcache = dict(tcache, k=torch.from_numpy(np.array(jcache["k"])),
                  v=torch.from_numpy(np.array(jcache["v"])))
    steps = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(4, 2)).astype(np.int32)
    for step_toks in steps:
        jl, jcache = jax_transformer.decode_step(jparams, jcfg, jcache, jnp.asarray(step_toks))
        tl, tcache = transformer.decode_step(params, cfg, tcache, torch.from_numpy(step_toks))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]), **TOL)
    assert tcache["len"].tolist() == np.asarray(jcache["len"]).tolist()


def test_decode_position_gap_matches_jax(setup):
    """B=2, a 12-token prompt, V=8: prefill's last logits match forward, but
    the first decode step's are off forward's by a large amount (the decode
    position V + S, where forward puts side + S), and by what JAX's are off
    JAX's forward."""
    jcfg, jparams, cfg, params = setup
    batch = _batch(cfg, 2, 12)
    gaps = []
    for mod, c, p, conv in ((jax_transformer, jcfg, jparams, _jax),
                            (transformer, cfg, params, _torch)):
        lp, cache = mod.prefill(p, c, conv(batch))
        nxt = np.asarray(lp[:, :cfg.vocab_size].argmax(-1)).astype(np.int32)
        full, _ = mod.forward(p, c, conv(batch))
        np.testing.assert_allclose(np.asarray(lp), np.asarray(full[:, -1]), **TOL)
        pad = [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)]
        cache = dict(cache, k=np.pad(np.asarray(cache["k"]), pad),
                     v=np.pad(np.asarray(cache["v"]), pad))
        cache = {k: (jnp.asarray(v) if conv is _jax else torch.from_numpy(np.asarray(v)))
                 for k, v in cache.items()}
        ld, _ = mod.decode_step(p, c, cache, conv({"t": nxt})["t"])
        full2, _ = mod.forward(p, c, conv(dict(batch, tokens=np.concatenate(
            [batch["tokens"], nxt[:, None]], 1))))
        gaps.append(float(np.abs(np.asarray(ld) - np.asarray(full2[:, -1])).max()))
    jgap, tgap = gaps
    assert jgap > 0.1 and tgap > 0.1, gaps
    assert abs(tgap - jgap) <= 2e-3, gaps


def test_params_round_trip(setup):
    _, jparams, cfg, params = setup
    flat = _flatten(jparams)
    back = params_to_numpy(params)
    assert set(back) == set(flat)
    for key, a in flat.items():
        np.testing.assert_array_equal(back[key], np.asarray(a, np.float32), key)
