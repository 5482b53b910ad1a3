"""Train a small LM for a few hundred steps with checkpoint/restart.

A copy of the JAX package's ``examples/train_small.py`` on the port: the
qwen2 family at a ~13M-parameter reduced width (pass --d-model 768
--layers 12 for ~100M). It runs on the card; pass --device cpu to run on
the CPU. Checkpoints go to the git-ignored ``build/`` of the checkout
unless --ckpt-dir says otherwise.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_small [--device cpu]
"""
import argparse
import math
from pathlib import Path

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.train import train_loop
from repro_torch.models.api import get_model

CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_small_ckpt"


def param_count(cfg) -> int:
    return sum(math.prod(s) for s in get_model(cfg).param_shapes(cfg).values())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_smoke_config("qwen2-1.5b").with_(
        name="qwen2-small", d_model=args.d_model, n_layers=args.layers,
        n_heads=8, n_kv_heads=2, d_ff=4 * args.d_model, vocab_size=8192)
    print(f"[example] training {cfg.name}: ~{param_count(cfg)/1e6:.1f}M "
          f"params, {args.steps} steps")
    _, _, losses = train_loop(cfg, steps_total=args.steps,
                              batch_size=args.batch, seq_len=args.seq,
                              ckpt_dir=args.ckpt_dir, ckpt_every=50,
                              resume=args.resume, device=args.device)
    print(f"[example] loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    if losses[-1] >= losses[0]:
        raise SystemExit("loss should decrease")


if __name__ == "__main__":
    main()
