#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases; any failure exits non-zero and no phase's failure is caught:
  1. device: the card's name and power limit; build every kernel from
     src/repro_torch/csrc (one nvcc per source, all at once).
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card (fp32 2e-5, bf16 2e-2, the repo's kernel tolerances), then its
     median time at the serving path's shapes beside the plain version's,
     scaled_dot_product_attention's (timed here only; the port never calls
     it) and the least time the card could take (the bound).
  3. parity: qwen2-1.5b at full width, cut to 2 layers, fp32, one seeded
     set of weights on the card and on the CPU: prefill logits and 4
     decode steps agree within atol 2e-4 / rtol 2e-3.
  4. serve: qwen2-1.5b at full width (28 layers, bf16, random weights)
     behind repro_torch.launch.serve: every request finishes, every logit
     is finite, and each kernel's launch count is 28 per prefill / decode
     step. Then one profiler window over full-width decode steps: wall
     time, device busy share, kernels by device time.
The line before the last is a JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor cores, H100 SXM data sheet
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
SERVE_MAX_LEN = 256


def _check(what, out, want, atol, rtol):
    out, want = out.float(), want.float()
    err = (out - want).abs()
    if not bool(torch.isfinite(out).all()) or not bool((err <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{what}: max abs err {err.max().item():.3e} "
                             f"exceeds atol {atol} + rtol {rtol}")
    return err.max().item()


def _randn(gen, *shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# ---------------------------------------------------------------- phase 1
def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {smi.splitlines()[0]}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from repro_torch.kernels import build
    t0 = time.time()
    libs = build.build()
    print(f"[build] {sorted(libs)} in {time.time() - t0:.1f}s")
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------- phase 2
def _time_ms(fn, flush, reps=30):
    """Median device time of one call, each after an L2 flush (a 256 MB
    memset). A spin kernel queued before the start event keeps the device
    busy until the host has enqueued the whole call, so the events bracket
    device work only, not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)          # about 1 ms of spinning
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_us(fn, n=200):
    """Host time to enqueue one call (no synchronisation inside the loop)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def _bound(nbytes, flops):
    """Least time (ms) for bf16 work: the larger of bytes over HBM rate and
    operations over the bf16 tensor-core rate, and which of the two."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels():
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_err = decode_err = 0.0
    n_flash = n_decode = 0
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(12, 2, 128, s, s, True) for s in (16, 64, 256, 100)]
        cases += [(12, 2, 128, 64, 100, False), (4, 2, 64, 48, 48, True),
                  (6, 6, 32, 80, 80, True)]
        for H, KH, D, Sq, Sk, causal in cases:
            for window in (0, 64):
                q = _randn(gen, 2, Sq, H, D, dtype=dtype)
                k = _randn(gen, 2, Sk, KH, D, dtype=dtype)
                v = _randn(gen, 2, Sk, KH, D, dtype=dtype)
                out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
                want = fa_ref.mha_reference(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                flash_err = max(flash_err, _check(
                    f"flash {dtype} H={H} KH={KH} D={D} Sq={Sq} Sk={Sk} causal={causal} "
                    f"window={window}", out, want, **TOL[dtype]))
                n_flash += 1
        for B, H, KH, D, S in ((8, 12, 2, 128, 256), (8, 12, 2, 128, 1500),
                               (3, 32, 2, 64, 200), (2, 6, 6, 32, 64)):
            lens = torch.randint(1, S + 1, (B,), generator=gen, device="cuda",
                                 dtype=torch.int32)
            lens[0] = S + 5                      # an idle slot past the cache
            q = _randn(gen, B, H, D, dtype=dtype)
            kc = _randn(gen, B, S, KH, D, dtype=dtype)
            vc = _randn(gen, B, S, KH, D, dtype=dtype)
            for window in (0, 64):
                out = da_ops.decode_attention(q, kc, vc, lens, window=window)
                want = da_ref.decode_attention_reference(q, kc, vc, lens, window=window)
                torch.cuda.synchronize()
                decode_err = max(decode_err, _check(
                    f"decode {dtype} B={B} H={H} KH={KH} D={D} Smax={S} window={window}",
                    out, want, **TOL[dtype]))
                n_decode += 1
    print(f"[kernels] flash: {n_flash} cases match the plain version, max abs err {flash_err:.3e}")
    print(f"[kernels] decode: {n_decode} cases match the plain version, max abs err {decode_err:.3e}")

    # Timing at the serving path's shapes: qwen2-1.5b, bf16. Prefill at the
    # 64-token bucket (prompts are 8-63 tokens); decode over the 8-slot,
    # 256-position cache with lengths in the path's range (prompt + up to
    # 31 generated tokens).
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    bf = torch.bfloat16
    B, S, H, KH, D = 1, 64, 12, 2, 128
    q, k, v = (_randn(gen, B, S, n, D, dtype=bf) for n in (H, KH, KH))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pairs = S * (S + 1) // 2
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bound, by = _bound(nbytes, 4 * B * pairs * H * D)
    flash = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:90",
        "max_abs_err": flash_err,
        "ms": _time_ms(lambda: fa_ops.flash_attention(q, k, v), flush),
        "plain_ms": _time_ms(lambda: fa_ref.mha_reference(q, k, v), flush),
        "bound_ms": bound, "bound_by": by,
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush),
        "host_us": _host_us(lambda: fa_ops.flash_attention(q, k, v)),
        "shape": f"B={B} S={S} H={H} KH={KH} D={D} bf16 causal",
    }

    B, S = 8, SERVE_MAX_LEN
    lens = torch.randint(9, 96, (B,), generator=gen, device="cuda", dtype=torch.int32)
    q = _randn(gen, B, H, D, dtype=bf)
    kc, vc = (_randn(gen, B, S, KH, D, dtype=bf) for _ in range(2))
    qs, ks, vs = q[:, :, None], kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    live = int(lens.clamp(max=S).sum())
    nbytes = 2 * (2 * q.numel() + 2 * live * KH * D) + 4 * B
    bound, by = _bound(nbytes, 4 * live * H * D)
    decode = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:79",
        "max_abs_err": decode_err,
        "ms": _time_ms(lambda: da_ops.decode_attention(q, kc, vc, lens), flush),
        "plain_ms": _time_ms(lambda: da_ref.decode_attention_reference(q, kc, vc, lens), flush),
        "bound_ms": bound, "bound_by": by,
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True), flush),
        "host_us": _host_us(lambda: da_ops.decode_attention(q, kc, vc, lens)),
        "shape": f"B={B} Smax={S} H={H} KH={KH} D={D} bf16 sum(len)={live}",
    }
    for r in (flash, decode):
        print(f"[kernels] {r['name']} at {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}); "
              f"host enqueue {r['host_us']:.1f} us/call")

    # How the kernel times scale: decode with the cache length (32 keys a
    # tile), flash with the prompt length, in both dtypes.
    sweep = []
    for L in (0, 32, 64, 128, 256):
        lens = torch.full((8,), L, dtype=torch.int32, device="cuda")
        sweep.append(f"len={L}:{1e3 * _time_ms(lambda: da_ops.decode_attention(q, kc, vc, lens), flush):.1f}")
    print(f"[kernels] decode bf16 B=8 Smax=256 us by length: {' '.join(sweep)}")
    for dtype in (torch.bfloat16, torch.float32):
        sweep = []
        for S in (16, 64, 256):
            x, y = _randn(gen, 1, S, H, D, dtype=dtype), _randn(gen, 1, S, KH, D, dtype=dtype)
            sweep.append(f"S={S}:{1e3 * _time_ms(lambda: fa_ops.flash_attention(x, y, y), flush):.1f}")
        print(f"[kernels] flash {str(dtype)[6:]} causal us by length: {' '.join(sweep)}")
    return [flash, decode]


# ---------------------------------------------------------------- phase 3
def phase_parity():
    from repro_torch.configs.registry import get_config
    from repro_torch.models import common as cm
    from repro_torch.models.api import get_model

    cfg = get_config("qwen2-1.5b").with_(n_layers=2, dtype="float32")
    model = get_model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(0), cfg)
    p_gpu = cm.nest({k: v.cuda() for k, v in cm.flatten(p_cpu).items()})
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32))
    last = torch.tensor([40, 63], dtype=torch.int32)
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 2)).astype(np.int32))
    tol = dict(atol=2e-4, rtol=2e-3)     # the repo's fp32 model bound

    logits, caches = {}, {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        lg, c = model.prefill(p, cfg, {"tokens": toks.to(dev)}, last.to(dev))
        pad = torch.zeros(c["k"].shape[:2] + (4,) + c["k"].shape[3:], device=dev)
        c = dict(c, k=torch.cat([c["k"], pad], 2), v=torch.cat([c["v"], pad], 2))
        logits[dev], caches[dev] = [lg], c
        for t in steps:
            lg, caches[dev] = model.decode_step(p, cfg, caches[dev], t.to(dev))
            logits[dev].append(lg)
    err = max(_check(f"parity {'prefill' if i == 0 else f'decode {i}'}",
                     g.cpu(), c, **tol)
              for i, (c, g) in enumerate(zip(logits["cpu"], logits["cuda"])))
    print(f"[parity] qwen2-1.5b full width, 2 layers, fp32: prefill + 4 decode "
          f"steps on the card match the CPU, max abs err {err:.3e} "
          f"(atol {tol['atol']}, rtol {tol['rtol']})")


# ---------------------------------------------------------------- phase 4
def phase_serve():
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer

    cfg = get_config("qwen2-1.5b")
    calls = {"prefill": 0, "decode": 0}
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    real_prefill, real_decode = transformer.prefill, transformer.decode_step

    def prefill(*a, **kw):
        logits, cache = real_prefill(*a, **kw)
        calls["prefill"] += 1
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, cache

    def decode_step(*a, **kw):
        logits, cache = real_decode(*a, **kw)
        calls["decode"] += 1
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, cache

    transformer.prefill, transformer.decode_step = prefill, decode_step
    try:
        # warm-up: first-call costs (cuBLAS handles, allocator) out of the numbers
        serve(cfg, n_requests=2, rate=1e3, max_len=SERVE_MAX_LEN, seed=1, device="cuda")
        runs = {}
        for label, rate in (("poisson5", 5.0), ("burst", 1e6)):
            calls.update(prefill=0, decode=0)
            fa_ops.flash_attention.launches = 0
            da_ops.decode_attention.launches = 0
            finished, summary = serve(cfg, n_requests=16, rate=rate, max_batch=8,
                                      max_len=SERVE_MAX_LEN, seed=0, device="cuda")
            launches = {"flash_attention": fa_ops.flash_attention.launches,
                        "decode_attention": da_ops.decode_attention.launches}
            assert len(finished) == 16, f"{label}: {len(finished)} of 16 requests finished"
            assert bool(finite), f"{label}: non-finite logits"
            want = {"flash_attention": cfg.n_layers * calls["prefill"],
                    "decode_attention": cfg.n_layers * calls["decode"]}
            assert calls["prefill"] == 16 and calls["decode"] > 0, calls
            assert launches == want, f"{label}: launches {launches}, want {want}"
            print(f"[serve] {label}: rate {rate}/s, {calls['prefill']} prefills, "
                  f"{calls['decode']} decode steps, kernels {json.dumps(launches)}")
            print(f"[serve] {label}: {json.dumps(summary)}")
            runs[label] = (launches, summary)
    finally:
        transformer.prefill, transformer.decode_step = real_prefill, real_decode
    return runs


def phase_profile(steps=4):
    """Where a full-width decode step's time goes: one torch.profiler window
    over `steps` engine steps with all 8 slots busy. Prints the wall time
    per step, the device's busy share and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import TorchEngine

    cfg = get_config("qwen2-1.5b")
    params = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = TorchEngine(cfg, params, max_batch=8, max_len=SERVE_MAX_LEN)
    rng = np.random.default_rng(0)
    for rid in range(8):
        eng.submit(rid, rng.integers(0, cfg.vocab_size, size=(48,)), 64)
    eng.step()                                   # 8 prefills + 1 decode step
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = {e.key: e.self_device_time_total / 1e3 / steps for e in kernels}   # ms per step
    busy = sum(dev.values())
    n_launch = sum(e.count for e in kernels) / steps
    print(f"[profile] decode step, 8 slots busy, qwen2-1.5b bf16: wall {wall_ms:.2f} ms, "
          f"device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{n_launch:.0f} device ops per step")
    for name, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[profile]   {ms:8.3f} ms/step  {name[:110]}")
    return wall_ms, busy


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; nothing was run")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: src/repro_torch is missing; run from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    phase_device()
    kernels = phase_kernels()
    phase_parity()
    runs = phase_serve()
    phase_profile()
    launches = runs["poisson5"][0]
    for r in kernels:
        r["launches"] = launches[r["name"]]
    print(f"[done] all phases passed in {time.time() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
