#!/usr/bin/env python3
"""fp32 against fp64 for xlstm-350m at full width, cut to 6 layers (5 mLSTM,
1 sLSTM), on the CPU: how far an fp32 run of the port and one of the JAX
package land from the exact (fp64) values of the same function, and why.
These are the numbers behind chip_smoke.py's xLSTM parity checks, which
hold the card in fp64 at the model bound and in fp32 in norm.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 xlstm_precision.py   # ~2 min, ~6 GB

Prints, for chip_smoke.py's inputs (seed 0; a 512-token prompt with
last_pos, then 4 decode steps; one train step on 2 x 512 tokens):
  1. the logits of each step and every state entry: the largest error of
     JAX fp32, port fp32 and port fp32 against JAX fp32;
  2. each param's gradient: the same three, with the excess over the fp32
     model bound (atol 2e-4 / rtol 2e-3);
  3. the token nearest to its denominator's clamp, max(|n.q|, exp(-m)):
     h is continuous there but its gradient is not, so an fp32 run that
     lands on the other side of it than the exact value changes the
     gradients of every layer before it.
"""
from __future__ import annotations

import numpy as np
import torch
import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jax_config
from repro.models import api as jax_api
from repro.train import steps as jax_steps
from repro.train.checkpoint import _flatten
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_to_numpy
from repro_torch.models import common as cm
from repro_torch.models import xlstm
from repro_torch.train import steps

ARCH, LAYERS, S = "xlstm-350m", 6, 512


def _serve(model, cfg, p, toks, last, dsteps):
    lg, c = model.prefill(p, cfg, {"tokens": toks}, last)
    out = {"logits prefill": np.asarray(lg, np.float64)}
    for i, t in enumerate(dsteps):
        lg, c = model.decode_step(p, cfg, c, t)
        out[f"logits decode {i + 1}"] = np.asarray(lg, np.float64)
    out.update({n: np.asarray(c[n], np.float64) for names in xlstm.STATE.values() for n in names})
    return out


def _grads(cfg, p, toks):
    flat = cm.flatten(p)
    for v in flat.values():
        v.requires_grad_(True)
    loss, _ = steps.loss_fn(p, cfg, {"tokens": toks, "labels": toks})
    return {k: g.double().numpy() for k, g in zip(flat, torch.autograd.grad(loss, list(flat.values())))}


def _clamp_margins(cfg, p, toks):
    """The smallest (|den| - exp(-m)) / exp(-m) over every mLSTM layer,
    token and head of the fp64 forward, recomputed from each layer's inputs
    to the chunked form."""
    seen, real = [], xlstm._mlstm_chunked

    def spy(*a):
        seen.append([t.detach() for t in a])
        return real(*a)

    xlstm._mlstm_chunked = spy
    try:
        with torch.no_grad():
            xlstm.forward(p, cfg, {"tokens": toks})
    finally:
        xlstm._mlstm_chunked = real
    best = (np.inf, None)
    for layer, (qh, kh, vh, li, lf) in enumerate(seen):
        B, _, H, dh = qh.shape
        T = xlstm.CHUNK
        C = qh.new_zeros((B, H, dh, dh))
        n = qh.new_zeros((B, H, dh))
        m0 = qh.new_full((B, H), xlstm.M_INIT)
        t = torch.arange(T)
        causal = (t[:, None] >= t[None, :])[None, :, :, None]
        for lo in range(0, S, T):
            qc, kc, lic, lfc = qh[:, lo:lo + T], kh[:, lo:lo + T], li[:, lo:lo + T], lf[:, lo:lo + T]
            F = torch.cumsum(lfc, 1)
            D = torch.where(causal, F[:, :, None] - F[:, None] + lic[:, None], -torch.inf)
            m_inter = F + m0[:, None]
            m = torch.maximum(torch.amax(D, 2), m_inter)
            sc = torch.einsum("bthd,buhd->btuh", qc, kc) * torch.exp(D - m[:, :, None])
            den = sc.sum(2) + torch.exp(m_inter - m) * torch.einsum("bhd,bthd->bth", n, qc)
            margin = ((den.abs() - torch.exp(-m)) / torch.exp(-m)).abs()
            i = int(margin.argmin())
            if float(margin.flatten()[i]) < best[0]:
                b, tt, h = np.unravel_index(i, margin.shape)
                best = (float(margin.flatten()[i]), (layer, b, lo + tt, h))
            _, (C, n, m0) = real(qh[:, :lo + T], kh[:, :lo + T], vh[:, :lo + T],
                                 li[:, :lo + T], lf[:, :lo + T])
    return best


def main():
    torch.set_num_threads(4)
    cfg = get_config(ARCH).with_(n_layers=LAYERS, dtype="float32")
    jcfg = jax_config(ARCH).with_(n_layers=LAYERS, dtype="float32")
    c64 = cfg.with_(dtype="float64")
    p32 = xlstm.init(torch.Generator().manual_seed(0), cfg)
    p64 = cm.nest({k: v.double() for k, v in cm.flatten(p32).items()})
    jp = cm.nest({k: jnp.asarray(v) for k, v in params_to_numpy(p32).items()})
    jmodel = jax_api.get_model(jcfg)

    rng = np.random.default_rng(0)            # chip_smoke.py's serving inputs
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    last = np.array([40, S - 1], np.int32)
    dsteps = rng.integers(0, cfg.vocab_size, (4, 2)).astype(np.int32)
    tt, tl, ts = torch.from_numpy(toks), torch.from_numpy(last), torch.from_numpy(dsteps)
    with torch.no_grad():
        exact = _serve(xlstm, c64, p64, tt, tl, ts)
        port = _serve(xlstm, cfg, p32, tt, tl, ts)
    ref = _serve(jmodel, jcfg, jp, jnp.asarray(toks), jnp.asarray(last), jnp.asarray(dsteps))
    print(f"1. {ARCH}, {LAYERS} layers, fp32, S={S}: max abs err of JAX fp32 / port fp32 "
          f"against fp64, and port fp32 against JAX fp32")
    for k, want in exact.items():
        print(f"   {k:18s} {np.abs(ref[k] - want).max():.3e} {np.abs(port[k] - want).max():.3e} "
              f"{np.abs(port[k] - ref[k]).max():.3e}   (max |value| {np.abs(want).max():.3e})")

    btoks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32))   # chip_smoke.py's train batch
    g64, g32 = _grads(c64, p64, btoks), _grads(cfg, p32, btoks)
    jb = {"tokens": jnp.asarray(btoks.numpy()), "labels": jnp.asarray(btoks.numpy())}
    gj = {k: np.asarray(v, np.float64) for k, v in _flatten(jax.grad(
        lambda p: jax_steps.loss_fn(p, jcfg, jb)[0])(jp)).items()}
    print("2. one train step's gradients: max abs err of JAX fp32 / port fp32 against fp64, "
          "port fp32 against JAX fp32 and its excess over atol 2e-4 + rtol 2e-3")
    for k, want in g64.items():
        d = np.abs(g32[k] - gj[k])
        print(f"   {k:18s} {np.abs(gj[k] - want).max():.3e} {np.abs(g32[k] - want).max():.3e} "
              f"{d.max():.3e} {(d - 2e-4 - 2e-3 * np.abs(gj[k])).max():+.3e}   "
              f"(max |g| {np.abs(want).max():.3e})")

    margin, (layer, b, t, h) = _clamp_margins(c64, p64, btoks)
    print(f"3. nearest clamp: mLSTM layer {layer}, sequence {b}, token {t}, head {h}: "
          f"|den| within {margin:.2e} of exp(-m), relative")


if __name__ == "__main__":
    main()
