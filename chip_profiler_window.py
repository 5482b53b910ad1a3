"""Does a torch.profiler window keep every device event of what ran in it?

chip_smoke.py asserts exact kernel counts from profiler windows. This
script replays zamba2-1.2b's 64-token prefill graph 4 times per window
(full width, random weights from seed 0, the engine of chip_smoke.py's
phase 4 with 8 busy slots; two eager admissions and two replays before
each window, as in phase 4's timing turns) and counts each window's device
events (kernels and copies, from the raw kineto events) against a full
window's. Windows alternate between a plain one and chip_smoke.py's (its
marker kernels first, then the replays, then WINDOW_TAIL_S idle); for the
latter it counts the markers lost apart from the replays' events. Then it
runs chip_smoke.phase_profile("zamba2-1.2b"), whose windows assert exact
counts, and prints the markers each of them kept.

    python3 chip_profiler_window.py [--windows N] [--profiles N]

Needs one CUDA card and the repo's src/ (kernels build into build/).
"""
import argparse
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=30, help="windows of each kind")
    ap.add_argument("--profiles", type=int, default=3, help="runs of phase_profile")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_profiler_window: torch.cuda.is_available() is false")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import TorchEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_device()
    cfg = get_config("zamba2-1.2b")
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = TorchEngine(cfg, params, max_batch=8, max_len=cs.SERVE_MAX_LEN)
    rng = np.random.default_rng(0)
    for rid in range(8):
        eng.submit(rid, rng.integers(0, cfg.vocab_size, size=(48,)), 160)
    eng.step()
    eng.step()
    n = eng._load_prompt(0, rng.integers(0, cfg.vocab_size, size=(64,)))
    eng._prefill_into(n)                       # warm-up, capture, first replay

    def events(prelude):
        for _ in range(2):
            cs._eager_prefill(eng, n)
            int(eng.first_token)
            eng._prefill_into(n)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if prelude:
                cs._window_prelude()
            for _ in range(4):
                eng._prefill_into(n)
            torch.cuda.synchronize()
            time.sleep(cs.WINDOW_TAIL_S)
        ev = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.start_ns())
        names = [e.name() for e in ev]
        markers = sum(cs.PRELUDE_SYMBOL in x for x in names)
        return collections.Counter(x for x in names if cs.PRELUDE_SYMBOL not in x), markers

    full, _ = events(True)
    per = cs._per_call_launches(cfg)["prefill"]
    assert cs._symbol_launches(full) == {op: 4 * per[op] for op in cs.KERNEL_SYMBOLS}
    print(f"[window] 4 replays: {sum(full.values())} device events, kernels by symbol "
          f"{json.dumps(cs._symbol_launches(full))}", flush=True)
    short = {False: 0, True: 0}
    lost_markers = []
    for i in range(args.windows):
        for prelude in (False, True):
            got, markers = events(prelude)
            if prelude:
                lost_markers.append(cs.PRELUDE_KERNELS - markers)
            if got != full:
                short[prelude] += 1
                print(f"[window] {'with' if prelude else 'without'} the prelude, window {i}: "
                      f"{sum(got.values())} of {sum(full.values())} events, lost "
                      f"{[(k[:60], v) for k, v in (full - got).items()][:8]}", flush=True)
    print(f"[window] windows whose replays lost events: {short[False]} of {args.windows} without "
          f"the prelude, {short[True]} of {args.windows} with it; markers lost per window with "
          f"it {lost_markers}", flush=True)
    del eng, params
    torch.cuda.empty_cache()

    report = cs._report_profile
    kept = []

    def counting(what, prof, wall_ms, calls):
        kept.append(sum(e.count for e in prof.key_averages()
                        if cs.PRELUDE_SYMBOL in e.key))
        return report(what, prof, wall_ms, calls)

    cs._report_profile = counting
    for i in range(args.profiles):
        cs.phase_profile(cfg.name)
        print(f"[window] phase_profile {cfg.name} run {i}: every count exact; markers kept per "
              f"window {kept} of {cs.PRELUDE_KERNELS}", flush=True)
        kept.clear()
    print(f"[window] {cs._card()}")


if __name__ == "__main__":
    main()
