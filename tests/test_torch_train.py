"""The port's training path against the JAX package on the CPU: the loss and
every param's gradient against ``jax.grad`` of the JAX ``loss_fn``, and
three ``make_train_step`` steps (loss, grad norm, lr, params) against JAX's,
from the same params (JAX init, carried over through the checkpoint key
layout) and the same numpy batches. fp32 smoke configs. Tolerances: the
loss and the gradients atol 2e-4 / rtol 2e-3, the repo's fp32 model bound
(tests/test_models.py); the optimizer's lr rtol 1e-6 (both compute it in
fp32); AdamW on identical inputs atol 1e-7 / rtol 1e-6 (fp32 rounding);
params after three train steps atol 1e-5 / rtol 1e-4, except where a
step's gradient was within 10 eps of zero (see _ill_conditioned)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import api as jax_api
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro.train.checkpoint import _flatten
from repro.train.data import SyntheticLM as JaxSyntheticLM
from repro_torch.configs.registry import ARCH_IDS, get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import api as mapi
from repro_torch.models import common as cm
from repro_torch.train import optimizer as opt
from repro_torch.train import steps
from repro_torch.train.data import SyntheticLM

TOL = dict(atol=2e-4, rtol=2e-3)
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
# The xLSTM's global grad norm is 24-29 in the three JAX steps (the other
# archs': 5-7), so clipping to 1 scales its gradients down about 5x more,
# and 0.22% of its elements fall within 10 eps of zero (the others: 0.06-0.09%).
# zamba2's smoke config: 0.11% (311 of 283,336 elements in JAX's three steps,
# 155 of them embedding rows and 77 in the Mamba layers' in_proj)
ILL_SHARE = {"xlstm-350m": 3e-3, "zamba2-1.2b": 1.5e-3}
# (arch, moe_impl): dense, MoE on both dispatch paths, VLM, audio, xLSTM and
# the hybrid
LOSS_CASES = [("qwen2-1.5b", None), ("granite-moe-3b-a800m", "onehot"),
              ("granite-moe-3b-a800m", "sorted"), ("qwen2-vl-2b", None),
              ("whisper-base", None), ("xlstm-350m", None), ("zamba2-1.2b", None)]


def _configs(arch, moe_impl=None):
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    if moe_impl is not None:
        jcfg, cfg = jcfg.with_(moe_impl=moe_impl), cfg.with_(moe_impl=moe_impl)
    return jcfg, cfg


def _setup(arch, moe_impl=None):
    jcfg, cfg = _configs(arch, moe_impl)
    jparams, _ = jax_api.get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, cfg, params_from_numpy(_flatten(jparams), cfg, "cpu")


def _batch(cfg, B=2, S=16, seed=1):
    """numpy batch: tokens = labels, and the audio / vlm stub inputs."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks.copy()}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch,moe_impl", LOSS_CASES)
def test_loss_and_every_grad_match_jax(arch, moe_impl):
    jcfg, jparams, cfg, params = _setup(arch, moe_impl)
    batch = _batch(cfg)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jsteps.loss_fn(p, jcfg, _jax(batch)), has_aux=True)(jparams)
    flat = cm.flatten(params)
    for p in flat.values():
        p.requires_grad_(True)
    loss, met = steps.loss_fn(params, cfg, _torch(batch))
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    aux = met["aux"].detach() if torch.is_tensor(met["aux"]) else met["aux"]
    np.testing.assert_allclose(float(aux), float(jmet["aux"]), **TOL)
    want = _flatten(jgrads)
    assert set(grads) == set(want)
    for key, g in grads.items():
        assert float(g.abs().max()) > 0 or float(np.abs(want[key]).max()) == 0, key
        np.testing.assert_allclose(g.numpy(), np.asarray(want[key]), **TOL, err_msg=key)


def _ill_conditioned(m_prev, m_new, b1, eps):
    """Elements whose gradient this step, recovered from JAX's first moment
    (m_new = b1 m_prev + (1 - b1) g, in fp32), is not zero but lies within
    10 eps of it. AdamW divides by sqrt(v) + eps, so there the gradient's
    fp32 noise, which is relative to the terms that cancelled in it and not
    to its value, moves the update by a share of lr: a step's update
    lr g / (|g| + eps) moves by lr delta eps / (|g| + eps)^2 for an error
    delta of g, under lr 1e-3 for |g| >= 10 eps and delta <= 1e-9. (A
    gradient that is exactly zero, as an embedding row no token used, is
    zero on both sides.)"""
    g = (np.asarray(m_new) - np.float32(b1) * np.asarray(m_prev)) / np.float32(1 - b1)
    return (g != 0) & (np.abs(g) < 10 * eps)


def test_adamw_update_matches_jax():
    """The optimizer alone, on identical params, gradients and state: three
    updates agree with JAX's to fp32 rounding."""
    rng = np.random.default_rng(5)
    shapes = {"a": (4, 6), "b/c": (7,), "b/d": (3, 2, 5)}
    p_np = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    params = cm.nest({k: torch.from_numpy(v.copy()) for k, v in p_np.items()})
    jparams = cm.nest({k: jnp.asarray(v) for k, v in p_np.items()})
    oc, joc = opt.OptConfig(warmup_steps=2, total_steps=5), jopt.OptConfig(warmup_steps=2,
                                                                           total_steps=5)
    o, jo = opt.init_opt_state(params), jopt.init_opt_state(jparams)
    for _ in range(3):
        g_np = {k: (rng.standard_normal(s) * 3).astype(np.float32) for k, s in shapes.items()}
        params, o, m = opt.adamw_update(oc, params, cm.nest(
            {k: torch.from_numpy(v) for k, v in g_np.items()}), o)
        jparams, jo, jm = jopt.adamw_update(joc, jparams, cm.nest(
            {k: jnp.asarray(v) for k, v in g_np.items()}), jo)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    for tree, jtree in ((params, jparams), (o["m"], jo["m"]), (o["v"], jo["v"])):
        for k, v in cm.flatten(tree).items():
            np.testing.assert_allclose(v.numpy(), np.asarray(_flatten(jtree)[k]),
                                       atol=1e-7, rtol=1e-6, err_msg=k)
    assert int(o["step"]) == int(jo["step"]) == 3


@pytest.mark.parametrize("arch,schedule", [("qwen2-1.5b", "cosine"),
                                           ("granite-moe-3b-a800m", "cosine"),
                                           ("minicpm-2b", "wsd"),
                                           ("xlstm-350m", "cosine"),
                                           ("zamba2-1.2b", "cosine")])
def test_three_train_steps_match_jax(arch, schedule):
    """Three steps from the same params and batches. At most 1e-3 of the
    elements (ILL_SHARE for an arch named there) may be exempt as
    ill-conditioned; that share is read from the JAX run alone."""
    jcfg, jparams, cfg, params = _setup(arch)
    joc = jopt.OptConfig(total_steps=4, warmup_steps=1, schedule=schedule)
    oc = opt.OptConfig(total_steps=4, warmup_steps=1, schedule=schedule)
    jstep = jax.jit(jsteps.make_train_step(jcfg, joc))
    step = steps.make_train_step(cfg, oc)
    jo, o = jopt.init_opt_state(jparams), opt.init_opt_state(params)
    ill, lr_sum = {}, 0.0
    for i in range(3):
        batch = _batch(cfg, seed=10 + i)
        jm_prev = _flatten(jo["m"])
        jparams, jo, jm = jstep(jparams, jo, _jax(batch))
        for key, m_new in _flatten(jo["m"]).items():
            ill[key] = ill.get(key, False) | _ill_conditioned(jm_prev[key], m_new,
                                                              joc.betas[0], joc.eps)
        lr_sum += float(jm["lr"])
        params, o, m = step(params, o, _torch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), **TOL)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
        assert float(m["grad_sq_min"]) > 0
    assert int(o["step"]) == int(jo["step"]) == 3
    want = _flatten(jparams)
    n_ill = sum(int(v.sum()) for v in ill.values())
    assert n_ill <= ILL_SHARE.get(arch, 1e-3) * sum(v.size for v in ill.values()), n_ill
    for key, p in params_to_numpy(params).items():
        w = np.asarray(want[key])
        np.testing.assert_allclose(p[~ill[key]], w[~ill[key]], **PARAM_TOL, err_msg=key)
        # where AdamW's update was ill-conditioned: within the steps' sum of lr
        np.testing.assert_allclose(p[ill[key]], w[ill[key]], atol=lr_sum, err_msg=key)
    for key, m1 in params_to_numpy(o["m"]).items():
        np.testing.assert_allclose(m1, np.asarray(_flatten(jo["m"])[key]), **TOL, err_msg=key)


@pytest.mark.parametrize("schedule", ["cosine", "wsd"])
def test_lr_schedule_matches_jax(schedule):
    oc = opt.OptConfig(total_steps=50, warmup_steps=5, schedule=schedule)
    joc = jopt.OptConfig(total_steps=50, warmup_steps=5, schedule=schedule)
    for step in (0, 1, 4, 5, 20, 44, 45, 46, 50, 60):
        np.testing.assert_allclose(float(opt.lr_at(oc, step)), float(jopt.lr_at(joc, step)),
                                   rtol=1e-6, err_msg=str(step))


def test_cross_entropy_masks_labels_like_jax():
    """Labels outside [0, vocab) carry no loss, the mean is over the valid
    ones, and the padded vocab columns still enter the logsumexp."""
    from repro.models import common as jcm
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, 512)).astype(np.float32)
    labels = rng.integers(0, 500, size=(2, 7)).astype(np.int32)
    labels[0, :3] = [-1, 500, 511]          # masked (vocab 500, padded to 512)
    want = jcm.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 500)
    got = cm.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), 500)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = cm.cross_entropy(torch.from_numpy(logits), torch.full((2, 7), -1), 500)
    assert float(none) == 0.0


def test_remat_gives_the_same_grads(monkeypatch):
    """Activation checkpointing reruns each layer's forward in the backward
    pass (flash attention's Function saves that run's LSE); the gradients
    are the same as without it."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    real, calls = fa_ref.mha_reference, []
    monkeypatch.setattr(fa_ref, "mha_reference", lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = get_smoke_config("granite-moe-3b-a800m")
    batch = _torch(_batch(cfg))
    out, n_calls = [], []
    for remat in (True, False):
        calls.clear()
        c = cfg.with_(remat=remat)
        params = mapi.get_model(c).init(torch.Generator().manual_seed(0), c)
        flat = cm.flatten(params)
        for p in flat.values():
            p.requires_grad_(True)
        loss, _ = steps.loss_fn(params, c, batch)
        out.append(torch.autograd.grad(loss, list(flat.values())))
        n_calls.append(len(calls))
    # per layer: the forward, the backward's recompute of the plain version
    # and, under remat only, the layer's second forward
    assert n_calls == [3 * cfg.n_layers, 2 * cfg.n_layers], n_calls
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_xlstm_remat_gives_the_same_grads(monkeypatch):
    """Under activation checkpointing each mLSTM layer's forward runs again
    in the backward pass (the sLSTM layers are not checkpointed, as in the
    JAX package); the gradients are the same as without it."""
    from repro_torch.models import xlstm
    real, calls = xlstm._mlstm_chunked, []
    monkeypatch.setattr(xlstm, "_mlstm_chunked", lambda *a: calls.append(1) or real(*a))
    cfg = get_smoke_config("xlstm-350m")
    batch = _torch(_batch(cfg))
    out, n_calls = [], []
    for remat in (True, False):
        calls.clear()
        c = cfg.with_(remat=remat)
        params = mapi.get_model(c).init(torch.Generator().manual_seed(0), c)
        flat = cm.flatten(params)
        for p in flat.values():
            p.requires_grad_(True)
        loss, _ = steps.loss_fn(params, c, batch)
        out.append(torch.autograd.grad(loss, list(flat.values())))
        n_calls.append(len(calls))
    assert n_calls == [2 * xlstm.n_mlstm(cfg), xlstm.n_mlstm(cfg)], n_calls
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_hybrid_remat_gives_the_same_grads(monkeypatch):
    """Under activation checkpointing each Mamba layer, and only it, runs
    under torch.utils.checkpoint (the shared attention block is not
    checkpointed, as in the JAX package), so its forward runs again in the
    backward pass; the gradients are the same as without it."""
    from repro_torch.models import hybrid
    real, calls = hybrid.mamba_forward, []
    monkeypatch.setattr(hybrid, "mamba_forward", lambda *a: calls.append(1) or real(*a))
    real_ckpt, wrapped = cm.checkpoint, []
    monkeypatch.setattr(cm, "checkpoint",
                        lambda fn, *a, **k: wrapped.append(fn) or real_ckpt(fn, *a, **k))
    cfg = get_smoke_config("zamba2-1.2b")
    batch = _torch(_batch(cfg))
    out, n_calls, n_wrapped = [], [], []
    for remat in (True, False):
        calls.clear()
        wrapped.clear()
        c = cfg.with_(remat=remat)
        params = mapi.get_model(c).init(torch.Generator().manual_seed(0), c)
        flat = cm.flatten(params)
        for p in flat.values():
            p.requires_grad_(True)
        loss, _ = steps.loss_fn(params, c, batch)
        assert all(fn is hybrid.mamba_forward for fn in wrapped)
        n_wrapped.append(len(wrapped))
        out.append(torch.autograd.grad(loss, list(flat.values())))
        n_calls.append(len(calls))
    assert n_wrapped == [cfg.n_layers, 0], n_wrapped
    assert n_calls == [2 * cfg.n_layers, cfg.n_layers], n_calls
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_synthetic_data_matches_jax():
    ours, theirs = SyntheticLM(512, 32, 4, seed=3), JaxSyntheticLM(512, 32, 4, seed=3)
    try:
        for _ in range(3):
            a, b = next(ours), next(theirs)
            assert set(a) == set(b) == {"tokens", "labels"}
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    finally:
        ours.close()
        theirs.close()


def test_synthetic_data_does_not_depend_on_the_consumers_pace():
    """A consumer slower than the prefetch thread's half-second put timeout
    gets the same batches as a fast one (the reference's thread drops the
    batch it holds there and samples another)."""
    import time
    fast = SyntheticLM(512, 32, 4, seed=3)
    try:
        want = [next(fast)["tokens"] for _ in range(4)]
    finally:
        fast.close()
    slow = SyntheticLM(512, 32, 4, seed=3)
    try:
        for i in range(4):
            np.testing.assert_array_equal(next(slow)["tokens"], want[i], err_msg=str(i))
            time.sleep(0.7)
    finally:
        slow.close()


def _port_batch(cfg, B, S, seed=1):
    batch = _torch(_batch(cfg, B, S, seed))
    for k in ("frames", "vision_embeds"):
        if k in batch:
            batch[k] = batch[k].to(cm.compute_dtype(cfg))
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_and_train_step(arch):
    """One forward + one train step on the CPU: output shapes + no NaNs (the
    port of tests/test_models.py's test of the same name)."""
    cfg = get_smoke_config(arch)
    model = mapi.get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg)
    B, S = 2, 16
    batch = _port_batch(cfg, B, S)
    with torch.no_grad():
        logits, aux = model.forward(params, cfg, batch)
    S_total = S + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    assert logits.shape[0] == B and logits.shape[1] == S_total
    assert logits.shape[2] >= cfg.vocab_size
    assert not bool(torch.isnan(logits).any())

    oc = opt.OptConfig(total_steps=4, warmup_steps=1)
    p2, o2, m = steps.make_train_step(cfg, oc)(params, opt.init_opt_state(params), batch)
    assert np.isfinite(float(m["loss"]))
    assert np.isfinite(float(m["grad_norm"]))
    assert float(m["grad_sq_min"]) > 0            # every param got a gradient
