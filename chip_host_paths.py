#!/usr/bin/env python3
"""Time the port's host-bound serving paths of one or more checkouts on one
NVIDIA GPU, each checkout in a child process of its own.

    python3 chip_host_paths.py                 # this checkout
    python3 chip_host_paths.py A B B A         # checkouts A and B, in that order

Each argument is the root of a checkout (its ``src/`` holds repro_torch);
to compare two commits, unpack the other into a directory that .gitignore
lists (``git archive``) and name both, the order interleaved. A run builds
the kernels of its checkout (untimed), then times, at full width in bf16 on
seeded random weights:

  * qwen2-1.5b's decode step at B=1 after a 64-token prefill: wall ms per
    step over 200 steps, the card synchronised once at the end (at this
    size the card waits on the host, so this is the host's cost of a step);
  * ``launch.serve.serve`` of qwen2-1.5b with chip_smoke.py's two traces
    (16 requests, max batch 8, Poisson arrivals at 5/s, and all at once)
    and of zamba2-1.2b with all at once: tok/s and TPOT p50;
  * where the checkout has ``distributed/sharding.py``: the calls of its
    helpers (``constrain``, ``rows``, ``reshape``, ``grad_as_input``) in one
    such decode step, each helper's host microseconds a call on a plain
    CUDA tensor, and the decode step timed in alternation (10 rounds of 50
    steps, medians) as it is and with the helpers replaced by what they
    return for a plain tensor.

It prints the card's name and power limit, then one JSON line per run.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

_CHILD = r'''
import json, sys, time
import numpy as np
import torch
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import serve
from repro_torch.models.api import get_model

torch.backends.cuda.matmul.allow_tf32 = False
out = {"tree": sys.argv[1]}


def decode_ms(arch, steps=200, warm=20, S=64):
    cfg = get_config(arch)
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S)).astype(np.int32)).cuda()
    logits, cache = model.prefill(params, cfg, {"tokens": toks})
    pad = torch.zeros(cache["k"].shape[:2] + (steps + warm,) + cache["k"].shape[3:],
                      dtype=cache["k"].dtype, device="cuda")
    cache = dict(cache, k=torch.cat([cache["k"], pad], 2), v=torch.cat([cache["v"], pad], 2))
    tok = logits[:, :cfg.vocab_size].argmax(-1).int()
    for i in range(warm + steps):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cfg, cache, tok)
        tok = logits[:, :cfg.vocab_size].argmax(-1).int()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    del params, cache
    torch.cuda.empty_cache()
    return ms


def served(arch, rate):
    cfg = get_config(arch)
    _, s = serve(cfg, n_requests=16, rate=rate, max_batch=8, max_len=256, seed=0,
                 device="cuda")
    torch.cuda.empty_cache()
    return {"tok_per_s": s["tok_per_s"], "tpot_p50_ms": 1e3 * s["tpot_p50_s"],
            "tokens": s["tokens"]}


def helpers(arch="qwen2-1.5b", rounds=10, steps=50, S=64):
    """Calls a decode step makes of the sharding helpers, their cost a call,
    and the step with and without them, alternated."""
    import importlib, timeit
    try:
        sh = importlib.import_module("repro_torch.distributed.sharding")
    except ImportError:
        return None
    plain = {"constrain": lambda x, *a: x, "rows": lambda x: x,
             "grad_as_input": lambda t: t, "reshape": lambda x, *s: x.reshape(*s)}
    mods = [sh] + [m for n, m in sorted(sys.modules.items())
                   if n.startswith("repro_torch.models.")]
    sites = [(m, k) for m in mods for k in plain if getattr(m, k, None) is getattr(sh, k)]
    real = {k: getattr(sh, k) for k in plain}

    def install(table):
        for m, k in sites:
            setattr(m, k, table[k])

    calls = dict.fromkeys(plain, 0)

    def counting(k):
        def f(*a):
            calls[k] += 1
            return real[k](*a)
        return f

    cfg = get_config(arch)
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S)).astype(np.int32)).cuda()
    logits, cache = model.prefill(params, cfg, {"tokens": toks})
    n = 2 * rounds * steps + 1
    pad = torch.zeros(cache["k"].shape[:2] + (n,) + cache["k"].shape[3:],
                      dtype=cache["k"].dtype, device="cuda")
    state = {"cache": dict(cache, k=torch.cat([cache["k"], pad], 2),
                           v=torch.cat([cache["v"], pad], 2)),
             "tok": logits[:, :cfg.vocab_size].argmax(-1).int()}

    def step():
        lg, state["cache"] = model.decode_step(params, cfg, state["cache"], state["tok"])
        state["tok"] = lg[:, :cfg.vocab_size].argmax(-1).int()

    install({k: counting(k) for k in plain})
    step()
    install(real)
    x = torch.zeros(1, 4, 8, device="cuda")
    per_call = {k: 10 * timeit.timeit(f, number=100000) for k, f in (   # us a call
        ("constrain", lambda: real["constrain"](x, "data", None, "model")),
        ("rows", lambda: real["rows"](x)), ("grad_as_input", lambda: real["grad_as_input"](x)),
        ("reshape", lambda: real["reshape"](x, 4, 8)), ("tensor.reshape", lambda: x.reshape(4, 8)))}
    ms = {"as_is": [], "plain": []}
    for _ in range(rounds):
        for label, table in (("as_is", real), ("plain", plain)):
            install(table)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            ms[label].append(1e3 * (time.perf_counter() - t0) / steps)
    install(real)
    del params, state
    torch.cuda.empty_cache()
    return {"calls_per_decode_step": calls, "us_per_call": per_call,
            "decode_ms_as_is": float(np.median(ms["as_is"])),
            "decode_ms_plain_helpers": float(np.median(ms["plain"])),
            "rounds": ms}


# warm-up: the kernels' build and first-call costs out of the numbers
serve(get_config("qwen2-1.5b"), n_requests=2, rate=1e3, max_len=256, seed=1, device="cuda")
serve(get_config("zamba2-1.2b"), n_requests=2, rate=1e3, max_len=256, seed=1, device="cuda")
decode_ms("qwen2-1.5b", steps=10, warm=2)
out["qwen2_decode_ms_B1"] = decode_ms("qwen2-1.5b")
out["qwen2_poisson5"] = served("qwen2-1.5b", 5.0)
out["qwen2_burst"] = served("qwen2-1.5b", 1e6)
out["zamba2_burst"] = served("zamba2-1.2b", 1e6)
out["helpers"] = helpers()
print("[host-paths] " + json.dumps(out), flush=True)
'''


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_host_paths: torch.cuda.is_available() is false; nothing was run")
    trees = [Path(a).resolve() for a in sys.argv[1:]] or [ROOT]
    for t in trees:
        if not (t / "src" / "repro_torch").is_dir():
            sys.exit(f"chip_host_paths: {t} holds no src/repro_torch")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    for t in trees:
        env = dict(os.environ, PYTHONPATH=str(t / "src"))
        proc = subprocess.run([sys.executable, "-c", _CHILD, str(t.relative_to(ROOT))
                               if t.is_relative_to(ROOT) else str(t)],
                              cwd=t, env=env, capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[host-paths] ")]
        if proc.returncode != 0 or not lines:
            sys.stderr.write(proc.stderr[-4000:])
            sys.exit(f"chip_host_paths: the run of {t} failed (exit {proc.returncode})")
        print(lines[-1], flush=True)


if __name__ == "__main__":
    main()
