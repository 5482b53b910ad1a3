"""Serving launcher: run a model behind the PyTorch serving engine with
batched synthetic requests (the end-to-end entry point).

Runs on CUDA unless ``--device cpu`` is given; use ``--smoke`` (the
default) for the reduced config and ``--full`` for the published width.

    PYTHONPATH=src python -m repro_torch.launch.serve --full
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels.common import resolve_device
from repro_torch.models import api as mapi
from repro_torch.obs.percentiles import percentiles
from repro_torch.serving.engine import TorchEngine


def serve(cfg, n_requests: int = 32, rate: float = 5.0, max_batch: int = 8,
          max_len: int = 256, seed: int = 0, device=None):
    """Serve ``n_requests`` Poisson arrivals at ``rate``/s on random weights
    from ``seed``. Returns (finished requests by rid, summary dict)."""
    model = mapi.get_model(cfg)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    params = model.init(gen, cfg)
    eng = TorchEngine(cfg, params, max_batch=max_batch, max_len=max_len)
    rng = np.random.default_rng(seed)

    prompts = rng.integers(8, 64, size=n_requests)
    outs = rng.integers(8, 32, size=n_requests)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))

    t0 = time.time()
    submitted, finished = 0, {}
    lat_first, lat_token = [], []
    sub_t = {}
    while len(finished) < n_requests:
        now = time.time() - t0
        while submitted < n_requests and arrivals[submitted] <= now:
            rid = submitted
            eng.submit(rid, rng.integers(0, cfg.vocab_size,
                                         size=(int(prompts[rid]),)),
                       int(outs[rid]))
            sub_t[rid] = time.time()
            submitted += 1
        if not any(eng.slots) and not eng.queue:
            if submitted < n_requests:
                time.sleep(0.005)
            continue
        reqs = {s.rid: s for s in eng.slots if s is not None}
        for rid, _tok, done in eng.step():
            if done:
                finished[rid] = reqs[rid]
    for rid, r in finished.items():
        lat_first.append(r.prefill_done - sub_t[rid])
        if len(r.token_times) > 1:
            lat_token += list(np.diff(r.token_times))
    wall = time.time() - t0
    total_tokens = sum(len(r.out_tokens) for r in finished.values())
    print(f"[serve] {n_requests} requests, {total_tokens} tokens "
          f"in {wall:.1f}s -> {total_tokens / wall:.1f} tok/s")
    # nearest-rank percentiles: the semantics of the simulator's SLOReport,
    # so engine and simulator numbers line up
    f50, f95 = percentiles(lat_first, (0.50, 0.95))
    print(f"[serve] TTFT   p50={f50*1e3:.1f}ms p95={f95*1e3:.1f}ms")
    summary = {"requests": n_requests, "tokens": total_tokens, "wall_s": wall,
               "tok_per_s": total_tokens / wall, "ttft_p50_s": f50,
               "ttft_p95_s": f95, "tpot_p50_s": None, "tpot_p95_s": None}
    if lat_token:
        t50, t95 = percentiles(lat_token, (0.50, 0.95))
        print(f"[serve] TPOT   p50={t50*1e3:.1f}ms p95={t95*1e3:.1f}ms")
        summary.update(tpot_p50_s=t50, tpot_p95_s=t95)
    return finished, summary


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=5.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises if absent)")
    args = ap.parse_args()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    serve(cfg, n_requests=args.requests, rate=args.rate,
          max_batch=args.max_batch, device=args.device)


if __name__ == "__main__":
    main()
