"""Training launcher: the end-to-end training driver of the port.

A port of the JAX package's ``launch/train.py``: synthetic data with
prefetch, AdamW with a cosine (WSD for minicpm) schedule and clipping,
activation checkpointing from the config, async checkpoint/restore
(a restart resumes from the latest step), periodic metrics. It runs on the
card unless ``--device cpu`` is given; there the attention, expert
products and SSD scans run in the hand-written kernels and their backward
kernels.

    python -m repro_torch.launch.train --arch qwen2-1.5b --full     # one card
    python -m repro_torch.launch.train --arch zamba2-1.2b --full    # the hybrid, one card
    python -m repro_torch.launch.train --device cpu --steps 20      # smoke config

Unlike the reference, whose resume unpacks ``(None, 0)`` and raises, a
resume here restores params and optimizer state and goes on from the saved
step.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels.common import resolve_device
from repro_torch.models import api as mapi
from repro_torch.models import common as cm
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import optimizer as opt
from repro_torch.train import steps
from repro_torch.train.data import SyntheticLM


def to_device_batch(cfg, batch, device):
    """The data pipeline's numpy batch on ``device``, with the stub inputs
    the audio and vlm families take (zeros, as in the reference)."""
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    B = out["tokens"].shape[0]
    dt = cm.compute_dtype(cfg)
    if cfg.family == "audio":
        out["frames"] = torch.zeros((B, cfg.enc_seq, cfg.d_model), dtype=dt, device=device)
    if cfg.family == "vlm":
        out["vision_embeds"] = torch.zeros((B, cfg.n_vision_tokens, cfg.d_model), dtype=dt,
                                           device=device)
    return out


def train_loop(cfg, steps_total: int = 200, batch_size: int = 8,
               seq_len: int = 64, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 50, log_every: int = 10,
               seed: int = 0, resume: bool = False, device=None,
               on_step: Optional[Callable] = None):
    """Train ``cfg`` from a seeded init; returns (params, opt_state, losses).
    ``on_step(step, params, opt_state, metrics)``, if given, runs after each
    step (metrics are 0-d tensors)."""
    dev = resolve_device(device)
    model = mapi.get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), cfg)
    opt_state = opt.init_opt_state(params)
    oc = opt.OptConfig(total_steps=steps_total,
                       warmup_steps=max(steps_total // 20, 5),
                       schedule="wsd" if "minicpm" in cfg.name else "cosine")
    train_step = steps.make_train_step(cfg, oc)

    ckpt = ckpt_mod.Checkpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        state, start = ckpt.restore({"p": params, "o": opt_state})
        params, opt_state = state["p"], state["o"]
        print(f"[train] resumed from step {start}")

    data = SyntheticLM(cfg.vocab_size, seq_len, batch_size, seed=seed)
    losses = []
    t0 = time.time()
    try:
        for step_i in range(start, steps_total):
            batch = to_device_batch(cfg, next(data), dev)
            params, opt_state, metrics = train_step(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            if on_step is not None:
                on_step(step_i, params, opt_state, metrics)
            if (step_i + 1) % log_every == 0:
                rate = (step_i + 1 - start) / (time.time() - t0)
                print(f"[train] step {step_i+1}/{steps_total} "
                      f"loss={losses[-1]:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} {rate:.2f} it/s")
            if ckpt and (step_i + 1) % ckpt_every == 0:
                ckpt.save(step_i + 1, {"p": params, "o": opt_state})
    finally:
        data.close()
        if ckpt:
            ckpt.wait()
    return params, opt_state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="the published config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    _, _, losses = train_loop(cfg, args.steps, args.batch, args.seq,
                              ckpt_dir=args.ckpt_dir, resume=args.resume,
                              device=args.device)
    if losses:
        print(f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    else:
        print("[train] done: nothing left to train")


if __name__ == "__main__":
    main()
