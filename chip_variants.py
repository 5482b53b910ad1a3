#!/usr/bin/env python3
"""Time other tilings of the two tensor-core kernels on one NVIDIA GPU.

    python3 chip_variants.py        # from the root of a checkout, on the card

The grouped matmul (csrc/moe_gmm.cu) and flash prefill (csrc/flash_attention.cu)
are built again with other values of their tiling constants (f tile width
and ring depth; warps per block, keys per tile, K/V ring depth, a register
cap) into build/repro_torch/variants/. Each variant is timed with
chip_smoke.py's _time_ms (L2 cold and clean, host enqueue hidden) at the
served models' shapes, bf16, beside torch.bmm /
scaled_dot_product_attention and two floors of the measurement itself: one
tiny launch (a one-element add) and one read of the expert weights by torch
(w.sum). Every variant is first held against the plain version at the
repo's tolerances. This is how the kernels' tilings were chosen; it is not
part of chip_smoke.py.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
# kernel source -> variant name -> {text in the source: replacement}
VARIANTS = {
    "moe_gmm": {"ft64": {}, "ft128": {"kMmaFT = 64;": "kMmaFT = 128;"},
                "ring8": {"kStages = 4;": "kStages = 8;"}},
    "flash_attention": {"w4kt64": {}, "w2kt64": {"kFW = 4;": "kFW = 2;"},
                        "w1kt64": {"kFW = 4;": "kFW = 1;"},
                        "w4kt32": {"kKT = 64;": "kKT = 32;"},
                        "w4kt128": {"kKT = 64;": "kKT = 128;"},
                        "w4kt64r3": {"kKVStages = 2;": "kKVStages = 3;"},
                        "w4kt64r4": {"kKVStages = 2;": "kKVStages = 4;"},
                        "w4kt64x3": {"__launch_bounds__(32 * kFW)":
                                     "__launch_bounds__(32 * kFW, D <= 64 ? 3 : 1)"}},
}
GMM_SHAPES = [(40, c, d, f) for c in (4, 16, 64) for d, f in ((1536, 512), (512, 1536))]
FLASH_HEADS = ((12, 2, 128), (24, 8, 64), (32, 32, 64))     # qwen2, granite, zamba2


def _build(build):
    """Every variant's library, built in parallel: {(source, variant): CDLL}."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, variants in VARIANTS.items():
        text = (build.CSRC / f"{src}.cu").read_text()
        for name, edits in variants.items():
            body = text
            for old, new in edits.items():
                assert old in body, (src, old)
                body = body.replace(old, new)
            cu, so = out_dir / f"{src}_{name}.cu", out_dir / f"{src}_{name}.so"
            cu.write_text(body)
            cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), str(cu)]
            procs.append(((src, name), so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for key, so, proc in procs:
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        libs[key] = ctypes.CDLL(str(so))
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_variants: torch.cuda.is_available() is false; nothing was run")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.moe_gmm import ref as gmm_ref

    cs.phase_device()
    libs = _build(build)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    one = torch.zeros(1, device="cuda")
    print(f"[variants] one tiny launch: {1e3 * cs._time_ms(lambda: one.add_(1), flush):.1f} us")

    for E, C, d, f in GMM_SHAPES:
        x = cs._randn(gen, E, C, d, dtype=torch.bfloat16)
        w = cs._randn(gen, E, d, f, dtype=torch.bfloat16)
        o = torch.empty(E, C, f, dtype=torch.bfloat16, device="cuda")
        want = gmm_ref.gmm_reference(x, w)
        row = [f"w.sum {1e3 * cs._time_ms(lambda: w.sum(dtype=torch.float32), flush):.1f}",
               f"bmm {1e3 * cs._time_ms(lambda: torch.bmm(x, w), flush):.1f}"]
        for name in VARIANTS["moe_gmm"]:
            fn = libs[("moe_gmm", name)].repro_grouped_matmul
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            call = lambda: fn(x.data_ptr(), w.data_ptr(), o.data_ptr(), E, C, d, f,  # noqa: E731
                              1, 1, 0, stream)
            assert call() == 0
            torch.cuda.synchronize()
            cs._check(f"gmm {name}", o, want, **cs.GMM_TOL[torch.bfloat16])
            row.append(f"{name} {1e3 * cs._time_ms(call, flush):.1f}")
        print(f"[variants] gmm E={E} C={C} d={d} f={f} us: {', '.join(row)}", flush=True)

    for H, KH, D in FLASH_HEADS:
        for S in cs.FLASH_TIMED_S:
            q = cs._randn(gen, 1, S, H, D, dtype=torch.bfloat16)
            k, v = (cs._randn(gen, 1, S, KH, D, dtype=torch.bfloat16) for _ in range(2))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            o, want = torch.empty_like(q), fa_ref.mha_reference(q, k, v)
            row = [f"sdpa {1e3 * cs._time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), flush):.1f}"]  # noqa: E501
            for name in VARIANTS["flash_attention"]:
                fn = libs[("flash_attention", name)].repro_flash_attention
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + \
                    [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                call = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),  # noqa: E731
                                  1, S, S, H, KH, D, 1, 1, 0, D ** -0.5, 1, 0, stream)
                assert call() == 0
                torch.cuda.synchronize()
                cs._check(f"flash {name}", o, want, **cs.TOL[torch.bfloat16])
                row.append(f"{name} {1e3 * cs._time_ms(call, flush):.1f}")
            print(f"[variants] flash H={H} KH={KH} D={D} S={S} us: {', '.join(row)}", flush=True)
    print("[variants] done")


if __name__ == "__main__":
    main()
