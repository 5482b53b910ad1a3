"""End-to-end multi-LLM serving example (the paper's serving story): two
models, each on its own TorchEngine, behind a round robin that steps
every engine with work once per round, fed one seeded Poisson trace;
reports per-model latency and throughput. The counterpart of
``examples/serve_multi_llm.py`` of the JAX package, with the same trace:
16 requests per model at 4 req/s per model, prompts of 8-47 tokens, 8-23
new tokens.

Runs on CUDA unless ``--device cpu`` is given; ``--smoke`` (the default)
takes the reduced configs, ``--full`` the published widths.

    PYTHONPATH=src python -m repro_torch.examples.serve_multi_llm --device cpu
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

ARCHS = ("qwen2-1.5b", "glm4-9b")
N_REQ, RATE = 16, 4.0          # requests per model, req/s per model
MAX_BATCH, MAX_LEN = 4, 128    # each engine's slots and cache length


def serve_multi_llm(n_req: int = N_REQ, rate: float = RATE, smoke: bool = True,
                    params=None, device=None, seed: int = 0):
    """Serve ``n_req`` requests per model of ARCHS, arrivals Poisson at
    ``rate`` per model, round-robin over the engines. ``params`` maps an
    arch to its params (on ``device``); an arch without them gets random
    weights from ``seed``. Returns (finished requests by rid, summary per
    arch)."""
    dev = resolve_device(device)
    engines = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
        p = (params or {}).get(arch)
        if p is None:
            p = mapi.get_model(cfg).init(torch.Generator(device=dev).manual_seed(seed), cfg)
        engines[arch] = (cfg, TorchEngine(cfg, p, max_batch=MAX_BATCH, max_len=MAX_LEN))
        print(f"[init] {arch}: {cfg.n_layers}L d={cfg.d_model} "
              f"({'reduced' if smoke else 'full width'}) on {dev}")

    # the trace: arrival times first, then each request's prompt and output
    # length drawn from the same generator as it is submitted
    rng = np.random.default_rng(seed)
    trace, t = [], 0.0
    for i in range(n_req * len(ARCHS)):
        t += rng.exponential(1.0 / (rate * len(ARCHS)))
        trace.append((t, ARCHS[i % len(ARCHS)], i))

    t0 = time.time()
    submitted, finished, sub_t = 0, {}, {}
    while len(finished) < len(trace):
        now = time.time() - t0
        while submitted < len(trace) and trace[submitted][0] <= now:
            _, arch, rid = trace[submitted]
            cfg, eng = engines[arch]
            n = int(rng.integers(8, 48))
            eng.submit(rid, rng.integers(0, cfg.vocab_size, size=(n,)), int(rng.integers(8, 24)))
            sub_t[rid] = (arch, time.time())
            submitted += 1
        progressed = False
        for _, eng in engines.values():
            if any(eng.slots) or eng.queue:
                reqs = {s.rid: s for s in eng.slots if s is not None}
                for rid, _tok, done in eng.step():
                    if done:
                        finished[rid] = reqs[rid]
                progressed = True
        if not progressed:
            time.sleep(0.004)

    wall = time.time() - t0
    print(f"[serve] {len(finished)} requests across {len(ARCHS)} models in {wall:.1f}s")
    summary = {}
    for arch in ARCHS:
        rids = [r for r, (a, _) in sub_t.items() if a == arch]
        ttft = [finished[r].prefill_done - sub_t[r][1] for r in rids]
        toks = sum(len(finished[r].out_tokens) for r in rids)
        p50, p95 = percentiles(ttft, (0.50, 0.95))
        summary[arch] = {"requests": len(rids), "tokens": toks, "wall_s": wall,
                         "tok_per_s": toks / wall, "ttft_p50_s": p50, "ttft_p95_s": p95}
        print(f"[serve]   {arch:12s} {len(rids):3d} reqs {toks:5d} tokens "
              f"{toks / wall:.1f} tok/s TTFT p50={p50 * 1e3:.0f}ms p95={p95 * 1e3:.0f}ms")
    return finished, summary


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=N_REQ, help="requests per model")
    ap.add_argument("--rate", type=float, default=RATE, help="req/s per model")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises if absent)")
    args = ap.parse_args()
    serve_multi_llm(n_req=args.requests, rate=args.rate, smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    main()
