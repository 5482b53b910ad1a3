"""The port's Whisper (audio family) against the JAX package on the CPU: the
same params (JAX init, carried over through the checkpoint key layout),
frames and tokens give the same encoder states, cross K/V and logits, in
forward, prefill and decode. fp32 smoke config; atol 2e-4 / rtol 2e-3, the
repo's own model bound (tests/test_models.py). The JAX side runs its
kernels' ``ref`` path, its CPU default: its Pallas kernels take no
1500-frame shape (they assert Sq, Sk and Smax are multiples of their
tiles)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import api as jax_api
from repro.models import common as jax_cm
from repro.models import whisper as jax_whisper
from repro.train.checkpoint import _flatten
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import api as mapi
from repro_torch.models import common as cm
from repro_torch.models import whisper

ARCH = "whisper-base"
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
            "frames": rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_configs_load_and_match_the_reference():
    assert mapi.get_model(get_config(ARCH)) is whisper
    for ours, theirs in ((get_config(ARCH), jax_config(ARCH)),
                         (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab_size", "resolved_head_dim", "qkv_bias", "rope", "rope_theta",
                  "sliding_window", "norm_eps", "tie_embeddings", "dtype",
                  "is_encoder_decoder", "n_enc_layers", "enc_seq", "kv_seq_shard"):
            assert getattr(ours, f) == getattr(theirs, f), f


@pytest.mark.parametrize("S,d,offset", [(1, 64, 0), (32, 64, 0), (1500, 512, 0), (16, 512, 7)])
def test_sinusoidal_pos_matches_jax(S, d, offset):
    np.testing.assert_allclose(cm.sinusoidal_pos(S, d, offset).numpy(),
                               np.asarray(jax_cm.sinusoidal_pos(S, d, offset)), **TOL)


def test_sinusoidal_pos_per_sequence_offsets():
    """Decode's form: one position per sequence, as a (B, 1) offset."""
    lengths = torch.tensor([0, 5, 1499], dtype=torch.int32)
    got = cm.sinusoidal_pos(1, 64, lengths[:, None])[:, 0]
    want = np.stack([np.asarray(jax_cm.sinusoidal_pos(1, 64, int(n)))[0] for n in lengths])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_encoder_and_cross_kv_match_jax(setup):
    jcfg, jparams, cfg, params = setup
    batch = _batch(cfg, 2, 8)
    want = jax_whisper.encode(jparams, jcfg, jnp.asarray(batch["frames"]))
    enc = whisper.encode(params, cfg, torch.from_numpy(batch["frames"]))
    np.testing.assert_allclose(enc.numpy(), np.asarray(want), **TOL)
    for i, lp in enumerate(cm.layer_views(params["dec_layers"], cfg.n_layers)):
        jlp = jax.tree.map(lambda a: a[i], jparams["dec_layers"])
        for got, exp in zip(whisper._cross_kv(lp, cfg, enc), jax_whisper._cross_kv(jlp, jcfg, want)):
            np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


def test_forward_matches_jax(setup):
    jcfg, jparams, cfg, params = setup
    batch = _batch(cfg, 2, 16)
    want, jaux = jax_whisper.forward(jparams, jcfg, _jax(batch))
    got, aux = whisper.forward(params, cfg, _torch(batch))
    assert aux == 0.0 and float(jaux) == 0.0
    assert got.shape == (2, 16, cm.padded_vocab(cfg.vocab_size))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_match_jax(setup):
    """prefill (with last_pos), then 4 decode steps over a padded self cache;
    the cross cache is the prefill's, over all enc_seq frames."""
    jcfg, jparams, cfg, params = setup
    batch = _batch(cfg, 2, 16)
    last = np.array([9, 15], np.int32)
    jl, jcache = jax_whisper.prefill(jparams, jcfg, _jax(batch), jnp.asarray(last))
    tl, tcache = whisper.prefill(params, cfg, _torch(batch), torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)
    assert tcache["xk"].shape[2] == cfg.enc_seq
    assert tcache["len"].tolist() == [16, 16]

    pad = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
    jcache = dict(jcache, k=jnp.pad(jcache["k"], pad), v=jnp.pad(jcache["v"], pad))
    tcache = dict(tcache, k=torch.from_numpy(np.array(jcache["k"])),
                  v=torch.from_numpy(np.array(jcache["v"])))
    steps = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(4, 2)).astype(np.int32)
    for step_toks in steps:
        jl, jcache = jax_whisper.decode_step(jparams, jcfg, jcache, jnp.asarray(step_toks))
        tl, tcache = whisper.decode_step(params, cfg, tcache, torch.from_numpy(step_toks))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)
    assert tcache["len"].tolist() == np.asarray(jcache["len"]).tolist() == [20, 20]


def test_decode_matches_forward():
    """decode_step(prefill(prompt)) agrees with teacher forcing, on the port
    alone with its own random init."""
    cfg = get_smoke_config(ARCH)
    params = whisper.init(torch.Generator().manual_seed(0), cfg)
    batch = _torch(_batch(cfg, 2, 12))
    lp, cache = whisper.prefill(params, cfg, batch)
    toks = [lp[:, :cfg.vocab_size].argmax(-1)]
    pad = torch.zeros(cache["k"].shape[:2] + (4,) + cache["k"].shape[3:])
    cache = dict(cache, k=torch.cat([cache["k"], pad], 2), v=torch.cat([cache["v"], pad], 2))
    for _ in range(3):
        ld, cache = whisper.decode_step(params, cfg, cache, toks[-1])
        seq = torch.cat([batch["tokens"]] + [t[:, None] for t in toks], 1)
        logits, _ = whisper.forward(params, cfg, dict(batch, tokens=seq))
        np.testing.assert_allclose(ld.numpy(), logits[:, -1].numpy(), **TOL)
        toks.append(ld[:, :cfg.vocab_size].argmax(-1))


def test_init_cache_shapes():
    cfg = get_smoke_config(ARCH)
    cache = whisper.init_cache(cfg, 3, 40, torch.float32, "cpu")
    L, KH, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    assert cache["k"].shape == cache["v"].shape == (L, 3, 40, KH, hd)
    assert cache["xk"].shape == cache["xv"].shape == (L, 3, cfg.enc_seq, KH, hd)
    assert cache["len"].dtype == torch.int32 and cache["len"].tolist() == [0, 0, 0]


def test_params_round_trip(setup):
    """The port's keys and shapes are the JAX checkpoint's, at smoke and at
    full width (shapes only), and values cross unchanged."""
    _, jparams, cfg, params = setup
    flat = _flatten(jparams)
    back = params_to_numpy(params)
    assert set(back) == set(flat)
    for key, a in flat.items():
        np.testing.assert_array_equal(back[key], np.asarray(a, np.float32), key)
    jfull = jax_config(ARCH)
    shapes = jax.eval_shape(lambda: jax_api.get_model(jfull).init(jax.random.PRNGKey(0), jfull)[0])
    assert whisper.param_shapes(get_config(ARCH)) == {
        "/".join(str(getattr(p, "key", p)) for p in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
