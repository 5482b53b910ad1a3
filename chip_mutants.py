#!/usr/bin/env python3
"""Check that chip_smoke.py's decode checks catch faults in the split combine.

    python3 chip_mutants.py        # from the root of a checkout, on the card

Builds csrc/decode_attention.cu as it is ("control") and with one fault
planted in the last block's combine of the splits (split 0 weighted by 0.9;
e^x taken for 2^x in the splits' weights; the last split left out of the
sum) into a temporary directory outside the checkout. Each build runs
chip_smoke.py's bf16 split-path cases (_decode_split_inputs); the script
prints, per build, how many cases the element tolerance and the row check
(DECODE_ROW_REL) each reject, and then runs chip_smoke.py's
_decode_split_cases on it. It exits non-zero if the control fails a check
or a planted fault passes them all. Not part of chip_smoke.py.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
# mutant -> {text in csrc/decode_attention.cu: replacement}
MUTANTS = {
    "control": {},
    "split0_x0.9": {"const float w = ex2(ml.x - mx);":
                    "const float w = (sp == 0 ? 0.9f : 1.f) * ex2(ml.x - mx);"},
    "exp_for_ex2": {"const float w = ex2(ml.x - mx);": "const float w = __expf(ml.x - mx);"},
    "drop_last_split": {"    for (int sp = 0; sp < splits; ++sp) {\n      const float w = wt[":
                        "    for (int sp = 0; sp < splits - 1; ++sp) {\n      const float w = wt["},
}


def _build(build, out_dir):
    """Every mutant's library, built in parallel: {name: C entry point}."""
    text = (build.CSRC / "decode_attention.cu").read_text()
    procs = {}
    for name, edits in MUTANTS.items():
        body = text
        for old, new in edits.items():
            assert body.count(old) == 1, (name, old)
            body = body.replace(old, new)
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(body)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        fn = ctypes.CDLL(str(so)).repro_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + \
            [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _counts(cs, da_ops, da_ref, sms):
    """(cases, element check fails, row check fails, row check alone, largest
    row error) over the bf16 split-path cases."""
    n = elem = row = row_only = 0
    worst = 0.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    for what, dtype, _, q, kc, vc, lens, window in cs._decode_split_inputs(gen, sms):
        if dtype != torch.bfloat16:
            continue
        got = da_ops.decode_attention(q, kc, vc, lens, window=window)
        want = da_ref.decode_attention_reference(q, kc, vc, lens, window=window)
        torch.cuda.synchronize()
        try:
            cs._check(what, got, want, **cs.TOL[dtype])
            elem_ok = True
        except AssertionError:
            elem_ok = False
        rel = cs._row_rel(got, da_ref.decode_attention_reference(
            q.float(), kc.float(), vc.float(), lens, window=window))
        row_ok = rel <= cs.DECODE_ROW_REL
        worst = max(worst, rel)
        n += 1
        elem += not elem_ok
        row += not row_ok
        row_only += elem_ok and not row_ok
    return n, elem, row, row_only, worst


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_mutants: torch.cuda.is_available() is false; nothing was run")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref

    cs.phase_device()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = True
    with tempfile.TemporaryDirectory(prefix="decode_mutants_") as tmp:
        fns = _build(build, Path(tmp))
        for name, fn in fns.items():
            da_ops._lib = lambda fn=fn: fn
            n, elem, row, row_only, worst = _counts(cs, da_ops, da_ref, sms)
            print(f"[mutants] {name}: {n} bf16 split-path cases; element check rejects {elem}, "
                  f"row check rejects {row}, row check alone {row_only}; largest row error "
                  f"{worst:.3e}", flush=True)
            try:
                cs._decode_split_cases(torch.Generator(device="cuda").manual_seed(0))
                caught = False
            except AssertionError as e:
                caught = True
                print(f"[mutants] {name}: _decode_split_cases fails: {str(e)[:200]}")
            if caught != (name != "control"):
                ok = False
                print(f"[mutants] {name}: {'control failed' if caught else 'fault not caught'}")
    print("[mutants] done" if ok else "[mutants] FAILED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
