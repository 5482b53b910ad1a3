"""The port's checkpointing and gradient compression on the CPU: the ports
of the JAX package's Checkpointer tests (tests/test_checkpoint.py) and of
its resume-equivalence test (a resumed run's loss within 1e-4 of an
uninterrupted one's), checkpoints written by either package restored in the
other (bf16 leaves included), the launcher's resume, and the int8
compression against the JAX package's on the same numpy gradients."""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train.checkpoint import Checkpointer as JaxCheckpointer
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.train import train_loop
from repro_torch.models import api as mapi
from repro_torch.models import common as cm
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.train import steps
from repro_torch.train.checkpoint import Checkpointer


def _state(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    params = {"layer": {"w": torch.randn(8, 8, generator=g).to(dtype),
                        "b": torch.zeros(8, dtype=dtype)}}
    return {"p": params, "o": opt.init_opt_state(params)}


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    st = _state()
    ck.save(10, st, blocking=True)
    restored, step = ck.restore(_state(seed=1))
    assert step == 10
    torch.testing.assert_close(restored["p"]["layer"]["w"], st["p"]["layer"]["w"])
    torch.testing.assert_close(restored["o"]["m"]["layer"]["w"], st["o"]["m"]["layer"]["w"])
    assert restored["o"]["step"].dtype == torch.int32


def test_retention_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(), blocking=True)
    assert ck.all_steps() == [3, 4]


def test_async_save_then_restore(tmp_path):
    ck = Checkpointer(str(tmp_path))
    st = _state()
    ck.save(5, st)             # async
    ck.wait()
    restored, step = ck.restore(_state(seed=2))
    assert step == 5
    torch.testing.assert_close(restored["p"]["layer"]["w"], st["p"]["layer"]["w"])


def test_restore_missing_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore(_state())


def test_save_copies_before_returning(tmp_path):
    """Training updates params in place: a save must hold the values it was
    given, whatever happens to the tensors after it returns."""
    ck = Checkpointer(str(tmp_path))
    st = _state()
    want = st["p"]["layer"]["w"].clone()
    ck.save(1, st)
    st["p"]["layer"]["w"].add_(1.0)
    restored, _ = ck.restore(_state(seed=3))
    torch.testing.assert_close(restored["p"]["layer"]["w"], want)


def test_train_resume_equivalence(tmp_path):
    """Training N steps == training k, restoring, training N-k (identical
    batches fed to both)."""
    cfg = get_smoke_config("qwen2-1.5b")
    model = mapi.get_model(cfg)
    oc = opt.OptConfig(total_steps=6, warmup_steps=1)
    ts = steps.make_train_step(cfg, oc)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(4):
        t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
        batches.append({"tokens": t, "labels": t})

    def fresh():
        p = model.init(torch.Generator().manual_seed(0), cfg)
        return p, opt.init_opt_state(p)

    p, o = fresh()
    for b in batches:
        p, o, _ = ts(p, o, b)
    direct_loss = float(ts(p, o, batches[0])[2]["loss"])

    ck = Checkpointer(str(tmp_path))
    p2, o2 = fresh()
    for b in batches[:2]:
        p2, o2, _ = ts(p2, o2, b)
    ck.save(2, {"p": p2, "o": o2}, blocking=True)
    p3, o3 = fresh()                       # a new process: fresh state, then restore
    restored, _ = ck.restore({"p": p3, "o": o3})
    p3, o3 = restored["p"], restored["o"]
    for b in batches[2:]:
        p3, o3, _ = ts(p3, o3, b)
    resumed_loss = float(ts(p3, o3, batches[0])[2]["loss"])
    assert abs(direct_loss - resumed_loss) < 1e-4


def _jax_state(seed=0, dtype=jnp.float32):
    k = jax.random.PRNGKey(seed)
    params = {"layer": {"w": jax.random.normal(k, (8, 8)).astype(dtype),
                        "b": jnp.zeros((8,), dtype)}}
    return {"p": params, "o": jopt.init_opt_state(params)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, dtype):
    """A JAX checkpoint (bf16 leaves as 2-byte void arrays) into the port."""
    st = _jax_state(dtype=jnp.dtype(dtype))
    JaxCheckpointer(str(tmp_path)).save(7, st, blocking=True)
    restored, step = Checkpointer(str(tmp_path)).restore(_state(dtype=getattr(torch, dtype)))
    assert step == 7
    w = restored["p"]["layer"]["w"]
    assert w.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(w.float().numpy(),
                                  np.asarray(st["p"]["layer"]["w"], np.float32))
    assert int(restored["o"]["step"]) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_jax(tmp_path, dtype):
    """A port checkpoint into the JAX package's restore, bf16 leaves exact."""
    st = _state(dtype=getattr(torch, dtype))
    st["o"]["step"] += 3
    Checkpointer(str(tmp_path)).save(9, st, blocking=True)
    restored, step = JaxCheckpointer(str(tmp_path)).restore(_jax_state(dtype=jnp.dtype(dtype)))
    assert step == 9
    w = restored["p"]["layer"]["w"]
    assert w.dtype == (ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    np.testing.assert_array_equal(np.asarray(w, np.float32),
                                  st["p"]["layer"]["w"].float().numpy())
    assert int(restored["o"]["step"]) == 3
    assert sorted(os.listdir(tmp_path / "step_00000009")) == ["manifest.json",
                                                                "shard_00000.npz"]


def test_launcher_resumes_from_the_latest_step(tmp_path):
    """The launcher restores params and optimizer state and goes on from
    the saved step (the reference's resume raises)."""
    cfg = get_smoke_config("qwen2-1.5b").with_(n_layers=1)
    kw = dict(batch_size=2, seq_len=16, ckpt_dir=str(tmp_path), ckpt_every=2,
              log_every=100, device="cpu")
    p1, o1, losses1 = train_loop(cfg, steps_total=2, **kw)
    p2, o2, losses2 = train_loop(cfg, steps_total=2, resume=True, **kw)
    assert len(losses1) == 2 and losses2 == []
    for key, t in cm.flatten(p1).items():
        torch.testing.assert_close(cm.flatten(p2)[key], t.detach(), atol=0, rtol=0)
    _, o3, losses3 = train_loop(cfg, steps_total=3, resume=True, **kw)
    assert len(losses3) == 1 and int(o3["step"]) == 3 and np.isfinite(losses3[0])


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((32, 32)) * 0.01).astype(np.float32),
            "b": (rng.standard_normal((32,)) * 0.1).astype(np.float32)}


def test_compression_matches_jax():
    g = _grads()
    ef0 = {k: (np.random.default_rng(9).standard_normal(v.shape) * 1e-3).astype(np.float32)
           for k, v in g.items()}
    q, s, err = comp.compress({k: torch.from_numpy(v) for k, v in g.items()},
                              {k: torch.from_numpy(v) for k, v in ef0.items()})
    jq, js, jerr = jcomp.compress({k: jnp.asarray(v) for k, v in g.items()},
                                  {k: jnp.asarray(v) for k, v in ef0.items()})
    for k in g:
        assert q[k].dtype == torch.int8
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
        np.testing.assert_allclose(float(s[k]), float(js[k]), rtol=1e-7)
        np.testing.assert_allclose(err[k].numpy(), np.asarray(jerr[k]), atol=1e-9)
    approx, new_ef = comp.compressed_roundtrip({k: torch.from_numpy(v) for k, v in g.items()},
                                               {k: torch.from_numpy(v) for k, v in ef0.items()})
    japprox, jnew_ef = jcomp.compressed_roundtrip({k: jnp.asarray(v) for k, v in g.items()},
                                                  {k: jnp.asarray(v) for k, v in ef0.items()})
    for k in g:
        assert approx[k].dtype == torch.float32
        np.testing.assert_allclose(approx[k].numpy(), np.asarray(japprox[k]), rtol=1e-7)
        np.testing.assert_allclose(new_ef[k].numpy(), np.asarray(jnew_ef[k]), atol=1e-9)


def test_compression_error_bounded_and_feedback_removes_bias():
    g = {k: torch.from_numpy(v) for k, v in _grads(2).items()}
    q, s, _ = comp.compress(g, comp.init_error_feedback(g))
    approx = comp.decompress(q, s)
    for k in g:
        scale = float(g[k].abs().max()) / 127.0
        assert float((approx[k] - g[k]).abs().max()) <= scale * 0.51 + 1e-9
    ef = comp.init_error_feedback(g)
    total_true = {k: torch.zeros_like(v) for k, v in g.items()}
    total_comp = {k: torch.zeros_like(v) for k, v in g.items()}
    for _ in range(50):
        approx, ef = comp.compressed_roundtrip(g, ef)
        for k in g:
            total_true[k] += g[k]
            total_comp[k] += approx[k]
    for k in g:
        rel = float((total_comp[k] - total_true[k]).norm() / total_true[k].norm())
        assert rel < 0.01, (k, rel)
