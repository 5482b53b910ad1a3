#!/usr/bin/env python3
"""Time other tilings of the bf16 kernels on one NVIDIA GPU.

    python3 chip_variants.py        # from the root of a checkout, on the card
    python3 chip_variants.py decode_attention mamba_scan    # only these sources
    python3 chip_variants.py mamba_scan_bwd                 # the SSD scan's backward

The grouped matmul (csrc/moe_gmm.cu), flash prefill (csrc/flash_attention.cu),
the flash backward (csrc/flash_attention_bwd.cu), split-KV decode
(csrc/decode_attention.cu) and the SSD scan (csrc/mamba_scan.cu) are built
again with other values of their constants (gmm: f tile width and ring
depth; its gradients' TMA/wgmma GEMM: tile width and ring depth, at dx, dw
and the forward at training capacities, beside the earlier path (a transposed
copy, then the forward kernel) and the copies alone; flash: warps per
block, keys per tile, K/V ring depth, a register cap; flash backward: keys
per dq tile, rows per dk/dv tile, both rings' depths, the dk/dv D loop's
unroll, and besides the host's split rule, fixed splits of the query
heads, with a per-kernel profile; decode: keys per tile,
K/V ring depth, and besides the host's split rule, fixed split counts,
whisper-base's cross decode over 1500 frames among them; SSD: columns of P
per block; the SSD scan's backward (csrc/mamba_scan_bwd.cu): rows of P per
block of its states kernel and S0 / G taken as a bf16 rounding alone instead
of rounding and remainder, and besides, on the default build, heads per
chunk block other than the launch plan's, the two-sweep kernel and the
chunked kernels on the CUDA cores, each with its workspace bytes) into
build/repro_torch/variants/, printing the registers and spills of each
variant's tensor-core kernels. Each variant is timed with
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
                "ring8": {"kStages = 4;": "kStages = 8;"},
                "tn128s5": {}, "tn128s4": {"kTStages = 5;": "kTStages = 4;"},
                "tn128s3": {"kTStages = 5;": "kTStages = 3;"},
                "tn64s5": {"kTBN = 128;": "kTBN = 64;"},
                "tn64s6": {"kTBN = 128;": "kTBN = 64;", "kTStages = 5;": "kTStages = 6;"}},
    "flash_attention_bwd": {"base": {}, "kdu1": {"#pragma unroll 2": "#pragma unroll 1"},
                            "kdu4": {"#pragma unroll 2": "#pragma unroll 4"},
                            "qr2": {"kQStages = 3;": "kQStages = 2;"},
                            "qr4": {"kQStages = 3;": "kQStages = 4;"},
                            "q16": {"kQT = 32;": "kQT = 16;"},
                            "dqr3": {"kKVStages = 2;": "kKVStages = 3;"},
                            "dq64": {"KT = D >= 128 ? 32 : 64;": "KT = 64;"}},
    "decode_attention": {"kt64r2": {}, "kt64r3": {"kDStages = 2;": "kDStages = 3;"},
                         "kt64r4": {"kDStages = 2;": "kDStages = 4;"},
                         "kt32r2": {"kDT = 64;": "kDT = 32;"},
                         "kt128r2": {"kDT = 64;": "kDT = 128;"}},
    "mamba_scan": {"pw16": {}, "pw32": {"kPW = 16;": "kPW = 32;"},
                   "pw64": {"kPW = 16;": "kPW = 64;"}},
    "mamba_scan_bwd": {"sp64": {}, "sp32": {"kSP = 64;": "kSP = 32;"},
                       "sp16": {"kSP = 64;": "kSP = 16;"},
                       "bf16state": {"kStateLo = true;": "kStateLo = false;"}},
}
GMM_SHAPES = [(40, c, d, f) for c in (4, 16, 64) for d, f in ((1536, 512), (512, 1536))]
GMM_MMA_VARIANTS = ("ft64", "ft128", "ring8")     # the forward kernel's; the rest the GEMM's
# granite's expert products at training capacities (C = 256 at B x S =
# 1024, 512 at 2048) and below, where the forward could take the GEMM too
GEMM_SHAPES = [(40, c, d, f) for c in (64, 128, 256, 512) for d, f in ((1536, 512), (512, 1536))]
# (name, B, S, H, KH, D, fixed split counts) of the flash backward: the train
# phase's qwen2-1.5b and granite-moe-3b-a800m, and glm4-9b's 16 query heads
# per KV head
FLASH_BWD_SHAPES = [("qwen2-1.5b", 4, 512, 12, 2, 128, (1, 2, 3, 6)),
                    ("granite-moe-3b-a800m", 2, 512, 24, 8, 64, (1, 3)),
                    ("glm4-9b", 2, 512, 32, 2, 128, (1, 2, 4, 8, 16))]
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
# the SSD scan's backward: zamba2-1.2b's train shape (B = 4, S = 512, H = P =
# N = 64; x, B and C slices of one conv buffer), and heads per chunk block
# timed beside the launch plan's
SSD_BWD_SHAPE = (4, 512, 64, 64, 64)
SSD_BWD_GROUPS = (2, 4, 8, 16, 32)


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


def _ssd_bwd_variants(cs, libs, flush, gen, stream):
    """The SSD scan's backward at zamba2-1.2b's train shape, bf16: every
    built variant at the launch plan's heads per group, the default build
    at other group sizes, on the CUDA cores, and the two-sweep kernel; each
    first held to the plain backward (bf16 tolerance, and dx, dB, dC rows
    within SSD_ROW_REL of the fp32 plain backward), then timed beside its
    workspace bytes (written and read back)."""
    import contextlib
    import ctypes
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.mamba_scan import ref as ms_ref

    B, S, H, P, N = SSD_BWD_SHAPE
    buf = cs._randn(gen, B, S, H * P + 2 * N, dtype=torch.bfloat16)
    _, dt, A, _, _, D, _ = cs._ssd_inputs(gen, B, S, H, P, N, torch.bfloat16)
    args = (buf[..., :H * P].view(B, S, H, P), dt, A, buf[..., H * P:H * P + N],
            buf[..., H * P + N:], D, None)
    dy = cs._randn(gen, B, S, H, P, dtype=torch.bfloat16)
    same = ms_ref.ssd_backward_reference(*args, dy)
    x, _, _, Bm, Cm, _, _ = args
    exact = ms_ref.ssd_backward_reference(x.float(), dt, A, Bm.float(), Cm.float(), D, None,
                                          dy.float())
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    @contextlib.contextmanager
    def library(fn):
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 8 + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        saved = ms_ops._bwd_lib
        ms_ops._bwd_lib = lambda: fn
        try:
            yield
        finally:
            ms_ops._bwd_lib = saved

    def timed(name, plan, traffic=None):
        call = lambda: ms_ops._bwd_launch(plan, *args, dy)  # noqa: E731
        got = call()
        torch.cuda.synchronize()
        rel = 0.0
        for what, g, w, e in zip(cs.SSD_BWD_NAMES, got, same, exact):
            cs._check(f"ssd bwd {name} {what}", g, w, **cs.SSD_BWD_TOL[torch.bfloat16])
            r = cs._row_rel(g, e) if what in ("dx", "dB", "dC") else cs._rel(g, e)
            assert r <= cs.SSD_ROW_REL, f"ssd bwd {name} {what}: {r:.3e} of the norm"
            rel = max(rel, r)
        mb = (plan.workspace_traffic if traffic is None else traffic) / 1e6
        return f"{name} {1e3 * cs._time_ms(call, flush):.1f} (rows {rel:.2e}, workspace {mb:.1f} MB)"

    row = []
    for name in VARIANTS["mamba_scan_bwd"]:
        plan = ms_ops.bwd_plan(B, S, H, P, N, torch.bfloat16, "mma", sms)
        # a bf16 rounding alone writes and reads one plane of S0 and G, not two
        traffic = plan.workspace_traffic - plan.state_traffic if name == "bf16state" else None
        with library(libs[("mamba_scan_bwd", name)].repro_ssd_scan_bwd):
            try:
                row.append(timed(f"{name}/hg{plan.heads_per_group}", plan, traffic))
            except AssertionError as err:    # a variant that misses the check is a finding
                row.append(f"{name} fails: {err}")
            if name == "sp64":
                for hg in SSD_BWD_GROUPS:
                    if hg != plan.heads_per_group:
                        row.append(timed(f"{name}/hg{hg}", ms_ops.bwd_plan(
                            B, S, H, P, N, torch.bfloat16, "mma", sms, heads_per_group=hg)))
                row.append(timed("cuda-cores", ms_ops.bwd_plan(B, S, H, P, N, torch.bfloat16,
                                                               "fma", sms)))
                row.append(timed("two-sweep", ms_ops.bwd_plan(B, S, H, P, N, torch.bfloat16,
                                                         "sweep", sms)))
    print(f"[variants] ssd bwd B={B} S={S} H={H} P={P} N={N} bf16 us: {', '.join(row)}",
          flush=True)


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
        _print_registers(key, log)
    return libs


def _print_registers(key, log):
    """ptxas's registers and spills of a variant's tensor-core kernels."""
    import chip_smoke as cs

    fn = None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = cs._demangle(line.split("Function properties for")[1].strip())
        elif fn and ("mma_kernel" in fn or "tiled_kernel" in fn or "_mma<" in fn) and \
                ("registers" in line or "spill" in line):
            print(f"[variants] {key[0]}/{key[1]} {fn}: {line.split(':', 1)[-1].strip()}")


def _gemm_variants(cs, libs, flush, gen, stream):
    """The gradients' GEMM variants at granite's training capacities: dx =
    g w^T, dw = x^T g and the forward x w (each held against the plain
    version first), beside torch.bmm, the forward kernel (gmm_mma_kernel)
    and the earlier path of each gradient (a contiguous transposed copy, then
    the forward kernel) and that copy alone."""
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.moe_gmm import ref as gmm_ref

    names = [n for n in VARIANTS["moe_gmm"] if n not in GMM_MMA_VARIANTS]
    us = lambda fn: f"{1e3 * cs._time_ms(fn, flush):.1f}"  # noqa: E731
    for E, C, d, f in GEMM_SHAPES:
        x, w, g = (cs._randn(gen, *s, dtype=torch.bfloat16) for s in ((E, C, d), (E, d, f), (E, C, f)))
        for what, (a, b, M, N, K, layout), want, bmm, before, copy in (
                ("dx", (g, w, C, d, f, 1), gmm_ref.gmm_dx_reference(g, w),
                 lambda: torch.bmm(g, w.transpose(1, 2)),
                 lambda: gmm_ops._launch(g, w.transpose(1, 2).contiguous()),
                 lambda: w.transpose(1, 2).contiguous()),
                ("dw", (x, g, d, f, C, 2), gmm_ref.gmm_dw_reference(x, g),
                 lambda: torch.bmm(x.transpose(1, 2), g),
                 lambda: gmm_ops._launch(x.transpose(1, 2).contiguous(), g),
                 lambda: x.transpose(1, 2).contiguous()),
                ("fwd", (x, w, C, f, d, 0), gmm_ref.gmm_reference(x, w), lambda: torch.bmm(x, w),
                 lambda: gmm_ops._launch(x, w), None)):
            o = torch.empty(E, M, N, dtype=torch.bfloat16, device="cuda")
            row = [f"bmm {us(bmm)}", f"{'mma' if copy is None else 'copy+mma'} {us(before)}"]
            if copy is not None:
                row.append(f"copy {us(copy)}")
            for name in names:
                fn = libs[("moe_gmm", name)].repro_grouped_gemm
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
                call = lambda: fn(a.data_ptr(), b.data_ptr(), o.data_ptr(), E, M, N, K,  # noqa: E731
                                  layout, 1, 1, 0, stream)
                assert call() == 0, name
                torch.cuda.synchronize()
                cs._check(f"gemm {name} {what}", o, want, **cs.GMM_BWD_TOL[torch.bfloat16])
                row.append(f"{name} {us(call)}")
            print(f"[variants] gemm {what} E={E} C={C} d={d} f={f} us: {', '.join(row)}", flush=True)


def _flash_bwd_variants(cs, libs, flush, gen, stream):
    """The flash backward's variants at the train shapes and glm4-9b's
    heads, causal, bf16, each held against the plain backward (the bf16
    tolerance in units of each row's RMS, and FLASH_BWD_REL of the fp32
    plain backward's norm) at the host's split rule; then the default build
    at fixed split counts; SDPA's backward beside."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    us = lambda fn: f"{1e3 * cs._time_ms(fn, flush):.1f}"  # noqa: E731
    for arch, B, S, H, KH, D, fixed in FLASH_BWD_SHAPES:
        q, dout = (cs._randn(gen, B, S, H, D, dtype=torch.bfloat16) for _ in range(2))
        k, v = (cs._randn(gen, B, S, KH, D, dtype=torch.bfloat16) for _ in range(2))
        out, lse = fa_ops._forward("cuda", q, k, v, True, 0, None, True)
        want = fa_ref.mha_backward_reference(q, k, v, dout)
        exact = fa_ref.mha_backward_reference(q.float(), k.float(), v.float(), dout.float())
        got = [torch.empty_like(t) for t in (q, k, v)]
        delta = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
        part = torch.empty(2 * B * KH * (H // KH) * S * D, dtype=torch.float32, device="cuda")
        rule = fa_ops.dkdv_splits(B, S, KH, H // KH, sms)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = dout.transpose(1, 2).contiguous()
        row = [f"sdpa {us(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True))}"]

        def timed(name, fn, splits):
            call = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),  # noqa: E731
                              dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                              *(t.data_ptr() for t in got), part.data_ptr(), B, S, S, H, KH, D, 1,
                              1, 0, D ** -0.5, 1, splits, 0, stream)
            assert call() == 0, (name, splits)
            torch.cuda.synchronize()
            for gname, a, b, c in zip(("dq", "dk", "dv"), got, want, exact):
                cs._check_rows(f"flash bwd {name} {arch} {gname}", a, b,
                               **cs.FLASH_BWD_TOL[torch.bfloat16])
                assert cs._rel(a, c) <= cs.FLASH_BWD_REL, (name, arch, gname)
            return f"{name}/s{splits} {us(call)}"

        fns = {}
        for name in VARIANTS["flash_attention_bwd"]:
            fn = libs[("flash_attention_bwd", name)].repro_flash_attention_bwd
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + \
                [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fns[name] = fn
        row += [timed(name, fn, rule) for name, fn in fns.items()]
        base = next(iter(fns))
        row += [timed(base, fns[base], n) for n in fixed if n != rule]
        print(f"[variants] flash bwd {arch} B={B} S={S} H={H} KH={KH} D={D} causal (rule: {rule} "
              f"splits) us: {', '.join(row)}", flush=True)
        print(f"[variants] flash bwd {arch} {base}/s{rule} by kernel (us, profiler, 5 calls): " +
              _by_kernel(lambda: fa_ops.flash_attention_bwd(q, k, v, out, lse, dout), 5), flush=True)


def _by_kernel(fn, calls):
    """Device time per call of each kernel ``fn`` launches, from one
    torch.profiler window over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = {e.key.replace("(anonymous namespace)::", "").replace("repro::", "").split("(")[0]
           .removeprefix("void "): e.self_device_time_total / calls
           for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}
    return ", ".join(f"{k} {v:.1f}" for k, v in sorted(dev.items(), key=lambda kv: -kv[1]))


def _gmm_variants(cs, libs, flush, gen, stream):
    """The grouped matmul's variants at granite's expert products, beside
    w.sum (one read of the weights) and torch.bmm; then the gradients'
    GEMM variants (_gemm_variants)."""
    from repro_torch.kernels.moe_gmm import ref as gmm_ref

    for E, C, d, f in GMM_SHAPES:
        x = cs._randn(gen, E, C, d, dtype=torch.bfloat16)
        w = cs._randn(gen, E, d, f, dtype=torch.bfloat16)
        o = torch.empty(E, C, f, dtype=torch.bfloat16, device="cuda")
        want = gmm_ref.gmm_reference(x, w)
        row = [f"w.sum {1e3 * cs._time_ms(lambda: w.sum(dtype=torch.float32), flush):.1f}",
               f"bmm {1e3 * cs._time_ms(lambda: torch.bmm(x, w), flush):.1f}"]
        for name in GMM_MMA_VARIANTS:
            fn = libs[("moe_gmm", name)].repro_grouped_matmul
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            call = lambda: fn(x.data_ptr(), w.data_ptr(), o.data_ptr(), E, C, d, f,  # noqa: E731
                              1, 1, 0, stream)
            assert call() == 0
            torch.cuda.synchronize()
            cs._check(f"gmm {name}", o, want, **cs.GMM_TOL[torch.bfloat16])
            row.append(f"{name} {1e3 * cs._time_ms(call, flush):.1f}")
        print(f"[variants] gmm E={E} C={C} d={d} f={f} us: {', '.join(row)}", flush=True)
    _gemm_variants(cs, libs, flush, gen, stream)



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
            "flash_attention_bwd": _flash_bwd_variants, "decode_attention": _decode_variants,
            "mamba_scan": _ssd_variants, "mamba_scan_bwd": _ssd_bwd_variants}
    for src in sources:
        runs[src](cs, libs, flush, gen, stream)
    print("[variants] done")


if __name__ == "__main__":
    main()
