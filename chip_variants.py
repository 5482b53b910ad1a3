#!/usr/bin/env python3
"""Time other tilings of the bf16 kernels on one NVIDIA GPU.

    python3 chip_variants.py        # from the root of a checkout, on the card
    python3 chip_variants.py decode_attention mamba_scan    # only these sources

The grouped matmul (csrc/moe_gmm.cu), flash prefill (csrc/flash_attention.cu),
split-KV decode (csrc/decode_attention.cu) and the SSD scan
(csrc/mamba_scan.cu) are built again with other values of their constants
(gmm: f tile width and ring depth; flash: warps per block, keys per tile,
K/V ring depth, a register cap; decode: keys per tile, K/V ring depth, and
besides the host's split rule, fixed split counts, whisper-base's cross
decode over 1500 frames among them; SSD: columns of P per block) into
build/repro_torch/variants/. Each variant is timed with
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
    "decode_attention": {"kt64r2": {}, "kt64r3": {"kDStages = 2;": "kDStages = 3;"},
                         "kt64r4": {"kDStages = 2;": "kDStages = 4;"},
                         "kt32r2": {"kDT = 64;": "kDT = 32;"},
                         "kt128r2": {"kDT = 64;": "kDT = 128;"}},
    "mamba_scan": {"pw16": {}, "pw32": {"kPW = 16;": "kPW = 32;"},
                   "pw64": {"kPW = 16;": "kPW = 64;"}},
}
GMM_SHAPES = [(40, c, d, f) for c in (4, 16, 64) for d, f in ((1536, 512), (512, 1536))]
FLASH_HEADS = ((12, 2, 128), (24, 8, 64), (32, 32, 64))     # qwen2, granite, zamba2
DECODE_FIXED_SPLITS = (1, 2, 4, 8, 16, 32, 64)
WHISPER_CROSS_SPLITS = (1, 3, 6, 12)    # 24, 8, 4 and 2 units of 64 frames per split
# (B, H, KH, D, Smax, lengths, fixed split counts timed beside the rule's):
# granite's serving cache, each model's heads at Smax 4096, whisper-base's
# cross decode over its 1500 frames, and qwen2-vl-2b's cache after 256
# vision tokens, a 32-token prompt and 16 decode steps (5 units: the rule
# takes 2 splits, of 4 units and of 1)
DECODE_SHAPES = [(8, 24, 8, 64, 256, "serve", DECODE_FIXED_SPLITS)] + \
    [(B, H, KH, D, 4096, "full", DECODE_FIXED_SPLITS) for H, KH, D in FLASH_HEADS
     for B in (1, 8)] + \
    [(B, 8, 8, 64, 1500, "full", WHISPER_CROSS_SPLITS) for B in (1, 8)] + \
    [(2, 12, 2, 128, 304, "full", (1, 3, 5))]
SSD_S = (64, 256, 1000)        # zamba2's prefill chunk, then longer prompts


def _decode_variants(cs, libs, flush, gen, stream):
    """Split-KV decode: every built variant at the host's split rule, then
    the default build at fixed split counts; each held against the plain
    version first."""
    import ctypes
    from repro_torch.kernels.common import cdiv
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cnt = torch.zeros(4096, dtype=torch.int32, device="cuda")
    for B, H, KH, D, S, kind, fixed in DECODE_SHAPES:
        q = cs._randn(gen, B, H, D, dtype=torch.bfloat16)
        kc, vc = (cs._randn(gen, B, S, KH, D, dtype=torch.bfloat16) for _ in range(2))
        lens = torch.full((B,), S, dtype=torch.int32, device="cuda") if kind == "full" else \
            torch.randint(9, 96, (B,), generator=gen, device="cuda", dtype=torch.int32)
        o, want = torch.empty_like(q), da_ref.decode_attention_reference(q, kc, vc, lens)
        rule = da_ops.split_count(B, KH, S, sms)

        def timed(name, fn, splits):
            ws = torch.empty(B * KH * splits * (H // KH) * (D + 2), dtype=torch.float32, device="cuda")
            call = lambda: fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), lens.data_ptr(),  # noqa: E731
                              o.data_ptr(), ws.data_ptr(), cnt.data_ptr(), B, S, H, KH, D, 1, 0,
                              D ** -0.5, splits, 1, 0, stream)
            assert call() == 0, (name, splits)
            torch.cuda.synchronize()
            cs._check(f"decode {name} splits={splits}", o, want, **cs.TOL[torch.bfloat16])
            return f"{name}/s{splits} {1e3 * cs._time_ms(call, flush):.1f}"

        fns = {}
        for name in VARIANTS["decode_attention"]:
            fn = libs[("decode_attention", name)].repro_decode_attention
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + \
                [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fns[name] = fn
        row = [timed(name, fn, rule) for name, fn in fns.items()]
        units = cdiv(S, da_ops.SPAN_UNIT)
        row += [timed("kt64r2", fns["kt64r2"], n) for n in fixed if n <= units and n != rule]
        print(f"[variants] decode B={B} Smax={S} H={H} KH={KH} D={D} {kind} lengths "
              f"(rule: {rule} splits) us: {', '.join(row)}", flush=True)


def _ssd_variants(cs, libs, flush, gen, stream):
    """The SSD scan's variants at zamba2's heads (H = P = N = 64), B = 1,
    bf16, each held against the plain version at the repo's tolerance; the
    largest row error against the fp32 plain version is printed beside."""
    import ctypes
    from repro_torch.kernels.mamba_scan import ref as ms_ref

    H, P, N = 64, 64, 64
    for S in SSD_S:
        args = cs._ssd_inputs(gen, 1, S, H, P, N, torch.bfloat16)
        x, dt, A, Bm, Cm, D, _ = args
        yw, sw = ms_ref.ssd_chunked_reference(*args)
        y32, s32 = ms_ref.ssd_chunked_reference(x.float(), dt, A, Bm.float(), Cm.float(), D)
        y, st = torch.empty_like(x), torch.empty_like(sw)
        row = []
        for name in VARIANTS["mamba_scan"]:
            fn = libs[("mamba_scan", name)].repro_ssd_scan
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + \
                [ctypes.c_int64] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            call = lambda: fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),  # noqa: E731
                              Cm.data_ptr(), D.data_ptr(), None, y.data_ptr(), st.data_ptr(),
                              1, S, H, P, N, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
                              Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1), 1, 1, 0,
                              stream)
            assert call() == 0, name
            torch.cuda.synchronize()
            cs._check(f"ssd {name} S={S} y", y, yw, **cs.SSD_TOL[torch.bfloat16])
            cs._check(f"ssd {name} S={S} state", st, sw, **cs.SSD_TOL[torch.bfloat16])
            rel = max(cs._row_rel(y, y32), cs._row_rel(st, s32))
            row.append(f"{name} {1e3 * cs._time_ms(call, flush):.1f} (rows {rel:.2e})")
        print(f"[variants] ssd B=1 S={S} H={H} P={P} N={N} us: {', '.join(row)}", flush=True)


def _build(build, sources):
    """Every variant's library of ``sources``, built in parallel:
    {(source, variant): CDLL}."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        variants = VARIANTS[src]
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


def _gmm_variants(cs, libs, flush, gen, stream):
    """The grouped matmul's variants at granite's expert products, beside
    w.sum (one read of the weights) and torch.bmm."""
    from repro_torch.kernels.moe_gmm import ref as gmm_ref

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



def _flash_variants(cs, libs, flush, gen, stream):
    """Flash prefill's variants at each model's heads, beside SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ref as fa_ref

    for H, KH, D in FLASH_HEADS:
        for S in cs.FLASH_TIMED_S:
            q = cs._randn(gen, 1, S, H, D, dtype=torch.bfloat16)
            k, v = (cs._randn(gen, 1, S, KH, D, dtype=torch.bfloat16) for _ in range(2))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            o, want = torch.empty_like(q), fa_ref.mha_reference(q, k, v)
            row = [f"sdpa {1e3 * cs._time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), flush):.1f}"]  # noqa: E501
            for name in VARIANTS["flash_attention"]:
                fn = libs[("flash_attention", name)].repro_flash_attention
                fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + \
                    [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                call = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),  # noqa: E731
                                  None, 1, S, S, H, KH, D, 1, 1, 0, D ** -0.5, 1, 0, stream)
                assert call() == 0
                torch.cuda.synchronize()
                cs._check(f"flash {name}", o, want, **cs.TOL[torch.bfloat16])
                row.append(f"{name} {1e3 * cs._time_ms(call, flush):.1f}")
            print(f"[variants] flash H={H} KH={KH} D={D} S={S} us: {', '.join(row)}", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_variants: torch.cuda.is_available() is false; nothing was run")
    sources = sys.argv[1:] or list(VARIANTS)
    if not set(sources) <= set(VARIANTS):
        sys.exit(f"chip_variants: sources must be among {list(VARIANTS)}")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build

    cs.phase_device()
    libs = _build(build, sources)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    one = torch.zeros(1, device="cuda")
    print(f"[variants] one tiny launch: {1e3 * cs._time_ms(lambda: one.add_(1), flush):.1f} us")
    runs = {"moe_gmm": _gmm_variants, "flash_attention": _flash_variants,
            "decode_attention": _decode_variants, "mamba_scan": _ssd_variants}
    for src in sources:
        runs[src](cs, libs, flush, gen, stream)
    print("[variants] done")


if __name__ == "__main__":
    main()
