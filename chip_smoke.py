#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases; any failure exits non-zero and no phase's failure is caught:
  1. device: the card's name and power limit; build every kernel from
     src/repro_torch/csrc (one nvcc per source, all at once), print each
     kernel's registers and spills, and check the SASS of the bf16 kernels:
     HMMA and LDGSTS in flash (forward and backward), the grouped matmul and
     the SSD scan, and in the SSD scan backward's states and chunk kernels,
     HGMMA and UTMALDG in the grouped GEMM (the gmm's gradients and its
     forward at training capacities), LDGSTS in split-KV decode.
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at the served models' shapes and ragged ones (attention fp32
     2e-5, bf16 2e-2; grouped matmul fp32 1e-4, bf16 atol 1e-1 / rtol 5e-2;
     SSD scan fp32 1e-4, bf16 x/B/C 2e-2: the repo's kernel tolerances;
     besides, every bf16 flash row and every bf16 SSD row of y and of the
     final state within 1e-2 of its norm against the plain version in
     fp32). Flash also at glm4-9b's heads (16 query heads per KV head,
     D=128), at minicpm-2b's (MHA: H=KH=36, D=64) and mistral-nemo-12b's
     (H=32, KH=8, D=128), and at whisper-base's (H=KH=8, D=64) without
     causality at Sq = Sk = 1500 and Sq = 1, 16, 64 against Sk = 1500;
     decode also at the latter two's heads. Decode's split
     path is checked at lengths 1, 63, 64, 65, on, beside and across
     (window 64) a split's boundary, at and past Smax, for Smax 256, 1500
     and 4096 and B 1 and 8, glm4-9b's heads among them, and at
     whisper-base's cross cache (Smax 1500, every length 1500). Then each
     kernel's median time at each served model's shapes beside the plain
     version's, one PyTorch call's that computes the same function
     (scaled_dot_product_attention, torch.bmm: timed here only, the port
     never calls them; no single call computes the SSD scan), the least
     time the card could take (the bound) and the earlier CUDA-core kernel
     on the same bf16 inputs (before_ms). Flash is timed at S = 64, 256
     and 2048 and at whisper-base's encoder (B=8, S=1500, no causal mask),
     decode at the serving cache (Smax 256; glm4-9b's B=4, Smax 128), at
     Smax 4096 with every length full (B 1 and 8) and at whisper-base's
     cross cache (B=8, Smax 1500, 3 splits), the grouped matmul at C = 4,
     8, 16 and 64 and at the training capacities C = 256 and 512 (there on
     the grouped GEMM, beside gmm_mma_kernel), the SSD scan at S = 64, 256
     and 1000.
     The backward kernels the same way: the flash backward (dq, dk, dv) and
     the forward's LSE at qwen2-1.5b's, granite-moe-3b-a800m's and
     glm4-9b's heads (6, 3 and 16 query heads per KV head), a window, Sq <
     Sk, ragged lengths and whisper-base's heads without a mask (fp32 1e-4,
     bf16 2e-2 with atol in units of each gradient row's RMS above 1, and within
     1e-2 of the fp32 plain backward's norm),
     bit for bit the same through autograd and under a checkpoint; the
     grouped matmul's dx and dw (fp32 1e-5, bf16 atol 1e-1 / rtol 5e-2),
     at ragged shapes, past the GEMM's 128-row and 128-column tile edges and
     its 64-deep K steps, and at training capacities.
     Timed at the train phase's shapes beside the plain versions, SDPA's
     backward through autograd and torch.bmm (timed here only); dx and dw
     also beside the earlier path (a contiguous transposed copy of w or x,
     then the forward kernel: before_ms) and that copy alone (copy_ms).
     The SSD scan's backward (dx, ddt, dA, dB, dC, dD, dinit) at the
     forward's cases, zamba2-1.2b's conv-buffer layout, and heads the two-sweep
     kernel refused (P=64, N=128 in fp32; P=N=128 and P=200, N=64 in bf16;
     S = 63, 200, 1000): fp32 within 1e-4 of the plain backward in fp64 (the
     fp32 plain backward's own share of that tolerance printed beside),
     bf16 within 2e-2 of the plain backward on the same inputs and its dx,
     dB and dC rows (the rest in norm) within 1e-2 of the plain backward in
     fp32; two calls bit for bit; through autograd and under a checkpoint
     the kernel's, bit for bit, and near the plain version's autograd.
     Timed at zamba2's train shape (B=4, S=512, bf16) beside the two-sweep
     kernel on the same inputs (before_ms, through the C entry point, never
     counted as a launch), the plain backward (no single PyTorch call
     computes it) and the bound, with the workspace bytes of both, the
     chunked kernels' registers and spills and a profile of its three
     launches.
  3. parity: qwen2-1.5b, granite-moe-3b-a800m, qwen2-vl-2b (256 vision
     tokens) and glm4-9b at full width cut to 2 layers, whisper-base cut
     to 2 encoder and 2 decoder layers over its 1500 frames, and
     zamba2-1.2b cut to 12 layers (2 groups of 6 Mamba layers, each
     followed by the shared attention block), fp32, one seeded set of
     weights on the card and on the CPU: prefill logits (zamba2: a
     200-token prompt, 4 chunks with a ragged tail) and 4 decode steps
     agree within atol 2e-4 / rtol 2e-3, and so does zamba2's SSM state.
     xlstm-350m cut to 6 layers (5 mLSTM, 1 sLSTM), prompts of 512 tokens
     (2 mLSTM chunks) and 300 (one chunk), 4 decode steps: in fp64 the
     logits and every state entry (mLSTM C, n, m and conv tail, sLSTM c,
     n, h, m; after the prefill and after the decode steps) agree within
     the same bound; in fp32, where no fixed bound holds at this width,
     the card's are held to the CPU's fp64 values within 3x the CPU's own
     fp32 error (phase_parity_xlstm). Then one train step of qwen2-1.5b and
     granite-moe-3b-a800m (2 layers, fp32, B=2, S=64), of xlstm-350m
     (6 layers, fp64, B=2, S=512) and of zamba2-1.2b (6 Mamba layers and one
     insertion of the shared block, fp32, B=2, S=200: a ragged last chunk;
     the SSD scan's gradient in the backward kernel): the loss and every
     param's gradient agree within the same bound, and the card's AdamW step
     equals the CPU's on the same gradients (phase_train_parity).
  4. serve: qwen2-1.5b (28 layers), granite-moe-3b-a800m (32 layers),
     zamba2-1.2b (38 Mamba layers, 6 shared-attention insertions),
     xlstm-350m (20 mLSTM, 4 sLSTM layers), minicpm-2b (40 layers, MHA)
     and mistral-nemo-12b (40 layers) at full width, bf16, random
     weights, behind repro_torch.launch.serve (each serve's peak device
     memory printed); the
     multi-LLM example (repro_torch.examples.serve_multi_llm: qwen2-1.5b,
     28 layers, and glm4-9b, 40 layers, on two engines behind a round
     robin); whisper-base (6 + 6 layers, 1500 frames, B=8: a 16-token
     prompt, 16 decode steps) and qwen2-vl-2b (28 layers, B=2: 256 vision
     tokens and a 32-token prompt, 16 decode steps) through the model API.
     Every request finishes, every logit is finite, and every prefill and
     decode step launches each kernel of its path exactly as often as the
     model has attention layers (grouped matmul: 3 per layer; zamba2: 38
     SSD scans and 6 flash per prefill, 6 decode attention and no SSD scan
     per decode step; whisper-base: 18 flash per prefill, 12 decode
     attention per step, the 6 cross ones on 3 splits; xlstm-350m: no
     kernel at all, its path is plain torch in both packages; no serving
     path launches the SSD scan's backward). Each engine captures its
     decode step as one CUDA graph and decodes only by replays: decode_step
     is called twice per engine, to warm up (checked for its launches) and
     under capture (checked for what the wrappers record, and that nothing
     launches), the replays equal the engine's decode rows, and the
     isfinite check captured with the step holds every replay's logits.
     Each engine also captures one prefill graph per prompt shape (the
     bucket; a recurrent prompt's exact length) at its first admission (a
     warm-up prefill, checked for its launches, and one under capture,
     checked for what it records) and replays it at every later admission:
     captures + prefill replays = admissions.
     granite's and zamba2's poisson5 runs each run inside one profiler
     window, whose device launches of the kernels, by symbol, must be the
     wrappers' launches (the warm-ups) plus the decode replays x the
     per-step count plus the prefill graphs' runs x the per-prefill count
     (the kernels line's launches). Each served model's burst and poisson5
     traces also run with both captures skipped (eager prefills and steps,
     the harness's yardstick for tok/s, TTFT and TPOT), and the burst's
     requests are drained on one schedule by a captured and an eager
     engine: are the tokens equal, and where not, the step and the top-2
     logit margins. Then, for each served model and glm4-9b, an
     engine with 8 slots busy: one replay's logits against one eager
     decode_step's from copies of the same cache and tokens (bf16 2e-2),
     the step's wall eager and replayed in turns, and one profiler window
     over eager steps and one over replays (wall, device busy share,
     device ops per step, device time by kernel family and by kernel), in
     which the replays launch each kernel, counted by symbol, exactly
     steps x its per-step count; one [graph-table] line per model
     (the walls, busy shares, ops per step, tok/s and TPOT p50/p95 of its
     captured and eager serving runs). The same engine's prefill: one
     replay against one eager prefill_body of the same prompt into the
     same slot of a copy of the cache (first token, logits and cache bit
     for bit), the admission's wall eager and replayed in turns at 16, 32
     and 64 tokens, the first use's seconds, a profiler window over 4
     replays (its kernels by symbol = 4 x the per-prefill count); one
     [prefill-table] line per model (those walls, the captures of its
     serving runs and their seconds, TTFT p50/p95 captured and eager). Whisper-base's decode steps (the
     model API) are profiled too, and one zamba2 prefill of a 63-token
     prompt, the only place the SSD kernel runs.
  5. train: qwen2-1.5b (28 layers, B=4, S=512), granite-moe-3b-a800m
     (32 layers, B=2, S=512), xlstm-350m (24 layers, B=4, S=512) and
     zamba2-1.2b (38 Mamba layers, 6 insertions of the shared block, B=4,
     S=512) at full width, bf16, remat on, 4 AdamW steps each through
     repro_torch.launch.train's train_loop: finite losses and grad norms,
     a gradient for every param on every step, and each step's launches
     as counted (per layer: 2 flash forwards, 1 flash backward; granite
     also 6 grouped matmuls, 3 dx, 3 dw; xlstm none; zamba2 per Mamba
     layer 2 SSD scans and 1 SSD backward, per insertion 1 flash forward
     and 1 backward); step times, tokens/s, peak memory, and one profiled
     step of each.
  6. mesh and dry-run (phase_mesh): qwen2-1.5b served under a one-rank
     NCCL mesh (make_debug_mesh on the card, an in-process store) with
     phase 4's traces: every request's tokens and every call's launches as
     in phase 4 without a mesh (the params are plain tensors, so the engine
     captures its graphs under the mesh too: phase 4's prefill shapes and
     prefill replays, and in the burst run as many decode replays); the dry-run (launch/dryrun.py, in two child
     processes: the fake process group cannot share one with NCCL) of
     phase 5's qwen2-1.5b and granite-moe-3b-a800m steps on a 1x1 mesh,
     its params + optimizer bytes within 1% of what the card holds after
     init_opt_state and its peak estimate not more than 10% below phase 5's
     measured peak, beside 6 N tokens; mistral-nemo-12b's decode cell
     beside its phase-4 serving peak; and three production-mesh cells
     (qwen2-1.5b train_4k on 16x16, dbrx-132b train_4k on 2x16x16,
     zamba2-1.2b long_500k on 16x16), each record printed.
  7. control plane (phase_control_plane): Coral's two-stage optimiser on
     the card, no kernel of its own. Every ProfileTable row of the six
     paper models x EXT_CONFIGS x both phases x S = 1..8 built on the card
     equals the port's CPU row bit for bit; the core library (CORE_MODELS x
     CORE_CONFIGS, n_max=6, rho=12: 28,074 templates) and llama3-70b decode
     on EXT_CONFIGS (n_max=6) built on the card equal the port's CPU builds
     (keys, counts, placements, throughputs), the library's columns and the
     placement cache's rows on the card, each build's device and host
     seconds printed; allocate on the card-built and on the CPU-built core
     library (availability from gen_availability, seeded, and a scarce
     case; demand 20x each trace's mean): same ok, unmet and solve path,
     cost within 1e-9 and objective within 5e-4 relative, the instances
     compared and held to the availability and demand, the solve seconds
     split into device, assembly and solver; the quickstart and
     templates_for_archs examples on the card against their CPU runs. The
     CPU side runs in a child process (``--control-cpu``) beside the card's.
  8. closed loop (phase_closed_loop): the epoch runtime over phase 7's
     card-built core library, no kernel of its own (event loop on the
     host; re-solves and the observables' queries on the card). The five
     closed-loop scenarios (estimator, re-solve controller, transition
     planner; 10 epochs of 240 s, base rate 2.0, seed 2) and the four fault
     scenarios (truth demands, a FaultInjector, health probe 15 s, restart
     backoff, ShedPolicy(32); 12 epochs) equal the same runs on phase 7's
     CPU-built library in the child bit for bit, wall-clock fields aside:
     epoch metrics, the SLO report and its series, the request log, token
     and arrival totals, the trace; every solve's instances are equal and
     none fell back. batched=False equals batched on flash_crowd (truth
     demands) and crash_storm; spot_preemption under CORAL_SANITIZE=1
     raises nothing and equals its plain run; the adaptive_cluster example
     equals its CPU run. Per run: requests, re-solves, mean $/h, goodput,
     TTFT and TBT p95 and attainment per model, and the wall seconds split
     into simulator (host), solves (device, assembly, solver, extract) and
     observable queries.
The line before the last is a JSON object with every kernel's numbers
(before_ms: the earlier kernel on the same inputs: the CUDA-core kernel of
the forward kernels, the earlier copy-then-gmm path of dx and dw, the two-sweep
kernel of the SSD scan's backward): attention and
grouped matmul at granite-moe-3b-a800m's shapes with their launches from
granite's poisson5 run, the SSD scan at zamba2-1.2b's prefill shape with its
launches from zamba2's poisson5 run, the flash backward and the grouped
matmul's dx and dw at granite's training shapes with their launches from
granite's train run, the SSD scan's backward at zamba2-1.2b's training
shape with its launches from zamba2's train run. In serving, every
forward kernel launches from the graphs' replays (prefill and decode),
which no wrapper sees: there ``launches`` is the device's count by kernel
symbol in one profiler window over the poisson5 run, ``wrapper_launches``
the wrappers' own (the warm-ups before each capture) and ``captured``
what the captures recorded; in training all three come from the wrappers
(launches = wrapper_launches, captured 0). The last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import contextlib
import gc
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
GMM_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),      # tests/test_kernels.py
           torch.bfloat16: dict(atol=1e-1, rtol=5e-2)}
# The bf16 flash kernel's rows against the plain version on the same inputs
# in fp32: ||out - want|| / ||want|| per (batch, query, head) row. The
# output's rounding and P's (each 2^-9 relative) leave about 4e-3; an error
# in the softmax rescale or a dropped KV tile moves a long row far more.
FLASH_ROW_REL = 1e-2
# The same for bf16 decode, per (sequence, head) row: P's and the output's
# rounding leave about as much as in flash. At a long cache the outputs are
# small (about sqrt(e / len) with randn inputs), so the element tolerance
# above is about as large as a typical value and lets a split weighted
# 10-20 % wrong, or a dropped split, pass; the row check does not.
DECODE_ROW_REL = 1e-2
SSD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),      # tests/test_kernels.py
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# The bf16 SSD kernel's rows against the plain version on the same inputs in
# fp32: ||out - want|| / ||want|| per (b, t, h) row of y over P and per
# (b, h, p) row of the final state over N. y's rounding to bf16 leaves up to
# about 4e-3, and the operands the tensor cores take rounded once (the
# masked scores M, x * w and the state's copy, each 2^-9 relative) about as
# much again; a wrong decay, a dropped chunk or a lost state read moves a
# row by far more.
SSD_ROW_REL = 1e-2
# The backward kernels against their plain versions: flash dq/dk/dv at the
# reference's flash gradient check (fp32 1e-4, tests/test_kernels.py) and the
# attention tolerance in bf16, there with atol in units of each gradient
# row's RMS over D where that exceeds 1 (_check_rows). A row of dk or dv sums
# G x Sq terms of one key, and the tensor cores take P and dS rounded to
# bf16 (2^-9 relative each), so its error scales with the size of its terms
# and not with its own value: at glm4-9b's 16 query heads per KV head the
# first keys' dv rows (P near 1 for the first queries of every head) err by
# up to 0.07 against the fp32 plain backward where an element may be small
# (on an H100: 0.0625 on an element under 2 at S=100). The grouped
# matmul's dx/dw at its gradient check (fp32 1e-5) and the gmm's bf16
# tolerance. The forward's LSE within 1e-5 of the plain logsumexp.
FLASH_BWD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
                 torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
GMM_BWD_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
               torch.bfloat16: dict(atol=1e-1, rtol=5e-2)}
LSE_TOL = dict(atol=1e-5, rtol=1e-5)
# The SSD scan's backward at the reference's SSD tolerance (fp32 1e-4,
# tests/test_kernels.py, the test that holds the scan the reference
# differentiates), bf16 x/B/C/dy at the repo's bf16 one. The fp32 kernel is
# held to the plain backward in fp64: the plain backward in fp32 itself
# reaches the tolerance's edge at the train shape (ddt, whose terms are sums
# over a chunk of products of unit-sized values), so its own ratio is
# printed beside the kernel's. bf16 rows of dx, dB and dC (and dA, ddt, dD,
# dinit in norm) within SSD_ROW_REL of the plain backward in fp32: the
# outputs' rounding to bf16 (2^-9 relative) leaves about 2e-3.
SSD_BWD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
               torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dinit")
# Each bf16 flash gradient against the plain backward in fp32 on the same
# inputs, ||got - want|| / ||want||: the gradients' rounding to bf16 and P's
# and dS's (each 2^-9 relative) leave about 3e-3; a dropped tile, a wrong
# mask or a lost head of a KV head's sum moves it far more.
FLASH_BWD_REL = 1e-2
XLSTM = "xlstm-350m"       # no kernel on its path: its checks are its own
XLSTM_PARITY_LAYERS = 6    # one group of slstm_every = 6: 5 mLSTM layers, then an sLSTM
# The served models with attention, whose heads the kernel phase times.
ATTENTION_ARCHS = ("qwen2-1.5b", "granite-moe-3b-a800m", "zamba2-1.2b")
SERVE_ARCHS = ATTENTION_ARCHS + (XLSTM,)
# Served at full width with their own head layouts, beside the above:
# minicpm-2b's MHA (36 KV heads, D=64) and mistral-nemo-12b's D=128 at 4
# query heads per KV head (its fsdp spec tree is the dry-run's)
HEAD_ARCHS = ("minicpm-2b", "mistral-nemo-12b")
# The train phase: each model at full width and depth, bf16, (B, S).
TRAIN_SHAPES = {"qwen2-1.5b": (4, 512), "granite-moe-3b-a800m": (2, 512), XLSTM: (4, 512),
                "zamba2-1.2b": (4, 512)}
# The trained models with attention, whose flash backward the kernel phase
# times and whose train step phase 3 holds to the CPU's in fp32.
ATTENTION_TRAIN_ARCHS = ("qwen2-1.5b", "granite-moe-3b-a800m")
TRAIN_STEPS = 4
PARITY_ARCHS = ATTENTION_ARCHS + ("whisper-base", "qwen2-vl-2b", "glm4-9b")
# Each kernel's path: granite's runs attention and the grouped matmul,
# zamba2's the SSD scan (and attention).
MAIN_ARCH = "granite-moe-3b-a800m"
SSD_ARCH = "zamba2-1.2b"
# zamba2's train parity: one group of attn_every = 6 Mamba layers and the
# shared block's insertion; 200 tokens leave a ragged last chunk (3 x 64 + 8)
SSD_PARITY_LAYERS, SSD_PARITY_S = 6, 200
SERVE_MAX_LEN = 256


def _row_rel(out, want):
    """Largest ||out - want|| / ||want|| over the rows of the last axis."""
    out, want = out.float(), want.float()
    return (torch.linalg.vector_norm(out - want, dim=-1)
            / torch.linalg.vector_norm(want, dim=-1)).max().item()


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
def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_device():
    print(f"[device] {_card()}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from repro_torch.kernels import build
    t0 = time.time()
    libs = build.build()
    print(f"[build] {sorted(libs)} in {time.time() - t0:.1f}s")
    for name in libs:
        fn = "?"
        for line in build.build_log(name).splitlines():
            if "Function properties for" in line:
                fn = _demangle(line.split("Function properties for")[1].strip())
            elif "registers" in line or "spill" in line:
                print(f"[build] {name} {fn}: {line.strip()}")
    _sass_check(libs)


def _demangle(name):
    """A kernel's name and template arguments (repro::(anonymous namespace)::
    flash_mma_kernel<128, 4> and the like), or the mangled name where
    c++filt is missing."""
    try:
        full = subprocess.run(["c++filt", name], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except OSError:
        return name
    full = full.replace("(anonymous namespace)::", "").replace("repro::", "").split("(")[0]
    return full.removeprefix("void ") or name


# The bf16 kernels must stage their tiles with asynchronous copies (LDGSTS,
# or TMA: UTMALDG), and those built on the tensor cores must run there
# (HMMA, or wgmma: HGMMA).
SASS_CHECKS = [("moe_gmm", "gmm_mma_kernel", ("HMMA", "LDGSTS")),
               ("moe_gmm", "gmm_tiled_kernel", ("HGMMA", "UTMALDG")),
               ("flash_attention", "flash_mma_kernel", ("HMMA", "LDGSTS")),
               ("flash_attention_bwd", "mma_kernel", ("HMMA", "LDGSTS")),
               ("mamba_scan", "ssd_mma_kernel", ("HMMA", "LDGSTS")),
               ("mamba_scan_bwd", "ssd_bwd_states_mma", ("HMMA", "LDGSTS")),
               ("mamba_scan_bwd", "ssd_bwd_chunk_mma", ("HMMA", "LDGSTS")),
               ("decode_attention", "decode_split_kernel", ("LDGSTS",))]


def _sass_check(libs):
    """Count the named instructions in each bf16 kernel's SASS (cuobjdump of
    the built library); fail if any instantiation lacks one."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    for lib, kernel, ops in SASS_CHECKS:
        sass = subprocess.run([str(cuobjdump), "-sass", str(libs[lib])], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        counts = {}
        for fn in sass.split("Function : ")[1:]:
            name = fn.split(None, 1)[0]
            if kernel in name:
                counts[name] = tuple(fn.count(op) for op in ops)
        assert counts and all(all(c) for c in counts.values()), \
            f"{kernel}: instantiations without {'/'.join(ops)}: {counts}"
        print(f"[build] {kernel}: {len(counts)} instantiations, {'/'.join(ops)} per instantiation "
              + " ".join("/".join(map(str, c)) for c in counts.values()))


# ---------------------------------------------------------------- phase 2
def _time_ms(fn, flush, reps=30):
    """Median device time of one call, each after an L2 flush: a 256 MB
    memset, then a read of the same buffer, so that the call finds the L2
    cold and clean (no dirty lines of the memset left to write back while it
    runs). A spin kernel queued before the start event keeps the device busy
    until the host has enqueued the whole call (it spins twice the host's
    enqueue time of one call, and at least about 1 ms: a plain version of
    many small ops takes longer than that to enqueue), so the events
    bracket device work only, not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    spin = int(2e9 * max(1e-3, 2 * (time.perf_counter() - t0)))   # ~2 cycles per ns
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        flush.sum()
        torch.cuda._sleep(spin)
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


def _bound(nbytes, flops, flop_rate=BF16_FLOP_PER_S):
    """Least time (ms): the larger of bytes over HBM rate and operations
    over the card's peak rate for their type (bf16 tensor cores unless
    given), and which of the two."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels():
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_err = decode_err = flash_rel = decode_rel = 0.0
    n_flash = n_decode = 0
    for dtype in (torch.float32, torch.bfloat16):
        # qwen2-1.5b's head layout (H=12, KH=2, D=128), granite-moe-3b-a800m's
        # at its prefill buckets (H=24, KH=8, D=64: 3 query heads per KV
        # head), and ragged and other layouts.
        cases = [(12, 2, 128, s, s, True) for s in (16, 64, 256, 100)]
        cases += [(24, 8, 64, s, s, True) for s in (8, 16, 32, 64)]
        cases += [(12, 2, 128, 64, 100, False), (4, 2, 64, 48, 48, True),
                  (6, 6, 32, 80, 80, True)]
        # zamba2-1.2b's shared block at exact prompt lengths (H=KH=32, D=64)
        cases += [(32, 32, 64, s, s, True) for s in (8, 63, 200)]
        # each served model's heads from one token to a long prompt, and
        # Sq != Sk without causality both ways
        for H, KH, D in ((12, 2, 128), (24, 8, 64), (32, 32, 64)):
            cases += [(H, KH, D, s, s, True) for s in (1, 63, 2048)]
            cases += [(H, KH, D, 37, 100, False), (H, KH, D, 100, 37, False)]
        # glm4-9b's heads: 16 query heads per KV head (every row of a block's
        # tile a live head) at D=128
        cases += [(32, 2, 128, s, s, True) for s in (1, 63, 256)]
        # minicpm-2b's MHA (H=KH=36, D=64) and mistral-nemo-12b's heads
        # (H=32, KH=8, D=128), served in phase 4
        for H, KH, D in ((36, 36, 64), (32, 8, 128)):
            cases += [(H, KH, D, s, s, True) for s in (1, 63, 256)]
            cases += [(H, KH, D, 37, 100, False)]
        # whisper-base's encoder (Sq = Sk = 1500) and cross-attention of a
        # prompt against the 1500 frames, without a causal mask: the last
        # key tile is partial
        cases += [(8, 8, 64, s, 1500, False) for s in (1500, 1, 16, 64)]
        for H, KH, D, Sq, Sk, causal in cases:
            for window in (0, 64):
                q = _randn(gen, 2, Sq, H, D, dtype=dtype)
                k = _randn(gen, 2, Sk, KH, D, dtype=dtype)
                v = _randn(gen, 2, Sk, KH, D, dtype=dtype)
                out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
                want = fa_ref.mha_reference(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                what = (f"flash {dtype} H={H} KH={KH} D={D} Sq={Sq} Sk={Sk} causal={causal} "
                        f"window={window}")
                flash_err = max(flash_err, _check(what, out, want, **TOL[dtype]))
                if dtype == torch.bfloat16:
                    rel = _row_rel(out, fa_ref.mha_reference(
                        q.float(), k.float(), v.float(), causal=causal, window=window))
                    assert rel <= FLASH_ROW_REL, \
                        f"{what}: row error {rel:.3e} exceeds {FLASH_ROW_REL} of the row's norm"
                    flash_rel = max(flash_rel, rel)
                n_flash += 1
        for B, H, KH, D, S in ((8, 12, 2, 128, 256), (8, 24, 8, 64, 256), (8, 32, 32, 64, 256),
                               (8, 12, 2, 128, 1500), (3, 32, 2, 64, 200),
                               (2, 6, 6, 32, 64), (8, 36, 36, 64, 256), (8, 32, 8, 128, 256),
                               (3, 32, 8, 128, 1500)):
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
                what = f"decode {dtype} B={B} H={H} KH={KH} D={D} Smax={S} window={window}"
                decode_err = max(decode_err, _check(what, out, want, **TOL[dtype]))
                if dtype == torch.bfloat16:
                    decode_rel = max(decode_rel, _decode_row_check(what, out, q, kc, vc, lens,
                                                                   window))
                n_decode += 1
    print(f"[kernels] flash: {n_flash} cases match the plain version, max abs err {flash_err:.3e}; "
          f"bf16 rows within {flash_rel:.3e} of the fp32 plain version's norm")
    print(f"[kernels] decode: {n_decode} cases match the plain version, max abs err {decode_err:.3e}; "
          f"bf16 rows within {decode_rel:.3e} of the fp32 plain version's norm")
    decode_err = max(decode_err, _decode_split_cases(gen))

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    rows = {arch: _attention_rows(arch, gen, flush) for arch in ATTENTION_ARCHS}
    for arch, pair in rows.items():
        for r in pair:
            _print_attention(arch, r)
    for arch in HEAD_ARCHS:
        for r in _attention_rows(arch, gen, flush):
            _print_attention(arch, r)
    # Flash alone at the longer buckets the engine pads to and a long prompt.
    for arch in ATTENTION_ARCHS:
        for S in FLASH_TIMED_S[1:]:
            _print_attention(arch, _flash_row(arch, S, gen, flush))
    # Decode alone over a long cache, every length full.
    for arch in ATTENTION_ARCHS:
        for B in (1, 8):
            S = DECODE_LONG_S
            lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
            _print_attention(arch, _decode_row(arch, B, S, lens, gen, flush))
    # whisper-base's encoder and its cross decode over all 1500 frames (3
    # splits at B=8), and glm4-9b's decode at the multi-LLM example's cache
    # (4 slots of 128 positions; prompts of 8-47 tokens, up to 23 new).
    whisper = "whisper-base"
    _print_attention(whisper, _flash_row(whisper, 1500, gen, flush, B=8, causal=False))
    lens = torch.full((8,), 1500, dtype=torch.int32, device="cuda")
    _print_attention(whisper, _decode_row(whisper, 8, 1500, lens, gen, flush))
    lens = torch.randint(9, 71, (4,), generator=gen, device="cuda", dtype=torch.int32)
    _print_attention("glm4-9b", _decode_row("glm4-9b", 4, 128, lens, gen, flush))
    # The kernels line reports attention at granite's shapes: the path whose
    # attention launches are counted below.
    flash, decode = rows[MAIN_ARCH]
    flash["max_abs_err"], decode["max_abs_err"] = flash_err, decode_err
    return [flash, decode, _gmm_kernel(gen, flush), _ssd_kernel(gen, flush),
            _flash_bwd_kernel(gen, flush), *_gmm_bwd_kernel(gen, flush),
            _ssd_bwd_kernel(gen, flush)]


FLASH_TIMED_S = (64, 256, 2048)   # the 64-token bucket, a longer one, a long prompt
DECODE_LONG_S = 4096              # a long cache, timed at B = 1 and 8


def _decode_row_check(what, out, q, kc, vc, lens, window):
    """bf16 decode's rows against the plain version in fp32 on the same
    inputs, within DECODE_ROW_REL of each row's norm; returns the largest."""
    from repro_torch.kernels.decode_attention import ref as da_ref

    rel = _row_rel(out, da_ref.decode_attention_reference(
        q.float(), kc.float(), vc.float(), lens, window=window))
    assert rel <= DECODE_ROW_REL, \
        f"{what}: row error {rel:.3e} exceeds {DECODE_ROW_REL} of the row's norm"
    return rel


# (B, H, KH, D, Smax, every length full) of the split path's cases: each
# served model's heads, glm4-9b's (16 query heads per KV head, D=128), and
# whisper-base's cross cache, whose lengths are all its 1500 frames.
DECODE_SPLIT_SHAPES = ((1, 12, 2, 128, 4096, False), (8, 12, 2, 128, 4096, False),
                       (1, 24, 8, 64, 1500, False), (8, 24, 8, 64, 1500, False),
                       (1, 32, 32, 64, 4096, False), (8, 24, 8, 64, 256, False),
                       (8, 12, 2, 128, 256, False), (2, 6, 6, 32, 1500, False),
                       (1, 32, 2, 128, 256, False), (8, 32, 2, 128, 256, False),
                       (1, 32, 2, 128, 4096, False), (8, 32, 2, 128, 4096, False),
                       (1, 8, 8, 64, 1500, True), (8, 8, 8, 64, 1500, True))


def _decode_split_inputs(gen, sms):
    """The split path's cases: (what, dtype, splits, q, kc, vc, lens, window)
    at lengths 1, 63, 64, 65, on and beside a split's boundary, across it
    with window 64, at and past Smax (or every length Smax); the shapes of
    DECODE_SPLIT_SHAPES; fp32 then bf16."""
    from repro_torch.kernels.common import cdiv
    from repro_torch.kernels.decode_attention import ops as da_ops

    for dtype in (torch.float32, torch.bfloat16):
        for B, H, KH, D, S, full in DECODE_SPLIT_SHAPES:
            splits = da_ops.split_count(B, KH, S, sms)
            span = cdiv(cdiv(S, da_ops.SPAN_UNIT), splits) * da_ops.SPAN_UNIT
            edges = sorted({e for e in (1, 63, 64, 65, span - 1, span, span + 1, span + 30,
                                        S - 1, S, S + 5) if e >= 1})
            groups = [[S] * B] if full else [[e] for e in edges] if B == 1 else \
                [(edges * B)[i:i + B] for i in range(0, len(edges), B)]
            q = _randn(gen, B, H, D, dtype=dtype)
            kc = _randn(gen, B, S, KH, D, dtype=dtype)
            vc = _randn(gen, B, S, KH, D, dtype=dtype)
            for lens in groups:
                lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
                for window in (0, 64):
                    yield (f"decode {dtype} B={B} H={H} KH={KH} D={D} Smax={S} splits={splits} "
                           f"lens={lens.tolist()} window={window}",
                           dtype, splits, q, kc, vc, lens, window)


def _decode_split_cases(gen):
    """Decode attention at the split path's edges (_decode_split_inputs)
    against the plain version (bf16: the split-KV kernel; fp32: the
    one-block kernel, same shapes); bf16 rows also pass _decode_row_check.
    Then two streams run split calls at once, each with its own counters.
    Returns the largest abs error."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err, rel, n, splits_seen = 0.0, 0.0, 0, set()
    for what, dtype, splits, q, kc, vc, lens, window in _decode_split_inputs(gen, sms):
        out = da_ops.decode_attention(q, kc, vc, lens, window=window)
        want = da_ref.decode_attention_reference(q, kc, vc, lens, window=window)
        torch.cuda.synchronize()
        err = max(err, _check(what, out, want, **TOL[dtype]))
        if dtype == torch.bfloat16:
            rel = max(rel, _decode_row_check(what, out, q, kc, vc, lens, window))
        n += 1
        splits_seen.add(splits)
    print(f"[kernels] decode split path: {n} cases (splits {sorted(splits_seen)}) match the "
          f"plain version, max abs err {err:.3e}; bf16 rows within {rel:.3e} of the fp32 "
          f"plain version's norm")

    # Two streams, each queueing split calls over the same (sequence, KV
    # head) pairs behind a spin, so that their blocks run at once. Its own
    # generator leaves the later phases' inputs as they were.
    B, H, KH, D, S = 8, 24, 8, 64, 4096
    assert da_ops.split_count(B, KH, S, sms) > 1
    g2 = torch.Generator(device="cuda").manual_seed(1)
    q = _randn(g2, B, H, D, dtype=torch.bfloat16)
    kc, vc = (_randn(g2, B, S, KH, D, dtype=torch.bfloat16) for _ in range(2))
    lens = torch.randint(1, S + 1, (B,), generator=g2, device="cuda", dtype=torch.int32)
    want = da_ref.decode_attention_reference(q, kc, vc, lens)
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    for st in streams:
        with torch.cuda.stream(st):
            torch.cuda._sleep(5_000_000)
    outs = []
    for _ in range(8):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(da_ops.decode_attention(q, kc, vc, lens))
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        err = max(err, _check(f"decode on two streams, call {i}", got, want, **TOL[torch.bfloat16]))
        assert torch.equal(got, outs[0]), f"decode on two streams, call {i}: not bit for bit"
    _decode_row_check("decode on two streams", outs[0], q, kc, vc, lens, 0)
    print(f"[kernels] decode split path on two streams at once: {len(outs)} calls match the "
          f"plain version, bit for bit alike")
    return err


def _decode_before(q, kc, vc, lens):
    """The earlier one-block decode kernel (now the fp32 variant) on the same
    bf16 inputs, through the C entry point: timed as before_ms, never
    counted as a launch."""
    from repro_torch.kernels.common import DTYPE_CODES
    from repro_torch.kernels.decode_attention import ops as da_ops

    (B, H, D), (Smax, KH) = q.shape, kc.shape[1:3]
    out = torch.empty_like(q)
    err = da_ops._lib()(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), lens.data_ptr(),
                        out.data_ptr(), None, None, B, Smax, H, KH, D, DTYPE_CODES[q.dtype],
                        0, D ** -0.5, 1, da_ops.VARIANTS["fma"], q.device.index,
                        torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"decode before: error {err}"
    return out


def _decode_row(arch, B, S, lens, gen, flush):
    """Decode attention timed at ``arch``'s heads over a (B, S) cache with
    ``lens``, bf16, beside the earlier kernel (before_ms), its plain
    version, scaled_dot_product_attention (timed here only) and the bound:
    q and the live K/V read once, the output written once."""
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref

    cfg = get_config(arch)
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = _randn(gen, B, H, D, dtype=torch.bfloat16)
    kc, vc = (_randn(gen, B, S, KH, D, dtype=torch.bfloat16) for _ in range(2))
    qs, ks, vs = q[:, :, None], kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    live = int(lens.clamp(max=S).sum())
    nbytes = 2 * (2 * q.numel() + 2 * live * KH * D) + 4 * B
    bound, by = _bound(nbytes, 4 * live * H * D)
    splits = da_ops.split_count(B, KH, S, torch.cuda.get_device_properties(0).multi_processor_count)
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:79",
        "ms": _time_ms(lambda: da_ops.decode_attention(q, kc, vc, lens), flush),
        "before_ms": _time_ms(lambda: _decode_before(q, kc, vc, lens), flush),
        "plain_ms": _time_ms(lambda: da_ref.decode_attention_reference(q, kc, vc, lens), flush),
        "bound_ms": bound, "bound_by": by,
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True), flush),
        "host_us": _host_us(lambda: da_ops.decode_attention(q, kc, vc, lens)),
        "shape": f"B={B} Smax={S} H={H} KH={KH} D={D} bf16 sum(len)={live} splits={splits}",
    }


def _flash_row(arch, S, gen, flush, B=1, causal=True):
    """Flash attention timed at ``arch``'s heads, Sq=Sk=S, bf16, causal
    unless asked, beside its plain version, scaled_dot_product_attention
    (timed here only) and the bound."""
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    cfg = get_config(arch)
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = (_randn(gen, B, S, n, D, dtype=torch.bfloat16) for n in (H, KH, KH))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pairs = S * (S + 1) // 2 if causal else S * S
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bound, by = _bound(nbytes, 4 * B * pairs * H * D)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:90",
        "ms": _time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=causal), flush),
        "before_ms": _time_ms(lambda: _flash_before(q, k, v, causal), flush),
        "plain_ms": _time_ms(lambda: fa_ref.mha_reference(q, k, v, causal=causal), flush),
        "bound_ms": bound, "bound_by": by,
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), flush),
        "host_us": _host_us(lambda: fa_ops.flash_attention(q, k, v, causal=causal)),
        "shape": f"B={B} S={S} H={H} KH={KH} D={D} bf16 {'causal' if causal else 'no mask'}",
    }


def _flash_before(q, k, v, causal=True):
    """The earlier CUDA-core flash kernel (now the fp32 variant) on the same
    bf16 inputs, Sq = Sk, through the C entry point: timed as before_ms,
    never counted as a launch."""
    from repro_torch.kernels.common import DTYPE_CODES
    from repro_torch.kernels.flash_attention import ops as fa_ops

    (B, S, H, D), KH = q.shape, k.shape[2]
    out = torch.empty_like(q)
    err = fa_ops._lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                        B, S, S, H, KH, D, DTYPE_CODES[q.dtype], int(causal), 0, D ** -0.5,
                        fa_ops.VARIANTS["fma"], q.device.index,
                        torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"flash before: error {err}"
    return out


def _print_attention(arch, r):
    """One timing line of an attention kernel (flash or decode)."""
    before = f" (before: {r['before_ms']:.4f})" if "before_ms" in r else ""
    print(f"[kernels] {r['name']} at {arch}'s {r['shape']}: kernel {r['ms']:.4f} ms{before}, "
          f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
          f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}); "
          f"host enqueue {r['host_us']:.1f} us/call")


def _attention_rows(arch, gen, flush):
    """Flash and decode attention timed at ``arch``'s serving shapes, bf16:
    prefill at the 64-token bucket (prompts are 8-63 tokens); decode over
    the 8-slot, 256-position cache with lengths in the path's range (prompt
    + up to 31 generated tokens). Beside each kernel: its plain version,
    scaled_dot_product_attention (timed here only) and the bound."""
    flash = _flash_row(arch, 64, gen, flush)

    B, S = 8, SERVE_MAX_LEN
    lens = torch.randint(9, 96, (B,), generator=gen, device="cuda", dtype=torch.int32)
    return flash, _decode_row(arch, B, S, lens, gen, flush)


# granite-moe-3b-a800m's expert products (E=40; gate/up d=1536 -> f=512,
# down 512 -> 1536) at the decode capacity (C=4 for 8 slots, the first row:
# the kernels line's) and the prefill buckets' (C=8, 16, 64).
GMM_TIMED = [(40, c, d, f) for c in (4, 8, 16, 64) for d, f in ((1536, 512), (512, 1536))]


def _gmm_row(E, C, d, f, gen, flush):
    """The grouped matmul timed at (E, C, d, f), bf16, beside its plain
    version, torch.bmm (timed here only) and the bound."""
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.moe_gmm import ref as gmm_ref

    x, w = _randn(gen, E, C, d, dtype=torch.bfloat16), _randn(gen, E, d, f, dtype=torch.bfloat16)
    bound, by = _bound(2 * (x.numel() + w.numel() + E * C * f), 2 * E * C * d * f)
    extra = {"mma_ms": _time_ms(lambda: gmm_ops._launch(x, w), flush)} \
        if gmm_ops.route(x.dtype, C, d, f, True) == "tiled" else {}
    return {"name": "grouped_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/moe_gmm.cu",
            "replaces": "src/repro/kernels/moe_gmm/kernel.py:49",
            "ms": _time_ms(lambda: gmm_ops.grouped_matmul(x, w), flush),
            "before_ms": _time_ms(lambda: _gmm_before(x, w), flush),
            "plain_ms": _time_ms(lambda: gmm_ref.gmm_reference(x, w), flush),
            "bound_ms": bound, "bound_by": by,
            "library_ms": _time_ms(lambda: torch.bmm(x, w), flush),
            "host_us": _host_us(lambda: gmm_ops.grouped_matmul(x, w)),
            "shape": f"E={E} C={C} d={d} f={f} bf16", **extra}


def _gmm_before(x, w):
    """The earlier CUDA-core grouped matmul (now the fp32 variant) on the
    same bf16 operands, through the C entry point: timed as before_ms, never
    counted as a launch."""
    from repro_torch.kernels.common import DTYPE_CODES
    from repro_torch.kernels.moe_gmm import ops as gmm_ops

    (E, C, d), f = x.shape, w.shape[2]
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    err = gmm_ops._lib()(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f,
                         DTYPE_CODES[x.dtype], gmm_ops.VARIANTS["fma"], x.device.index,
                         torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"gmm before: error {err}"
    return out


def _print_gmm(r):
    print(f"[kernels] grouped_matmul at {MAIN_ARCH}'s {r['shape']}: kernel "
          f"{r['ms']:.4f} ms (before: {r['before_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bmm {r['library_ms']:.4f} ms, "
          f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}); "
          f"host enqueue {r['host_us']:.1f} us/call")


def _gmm_kernel(gen, flush):
    """The grouped matmul against its plain version over the repo's sweep
    (ragged shapes included, and a w that is not 16-byte aligned) and the
    serving shapes, then timed at granite's decode shape."""
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.moe_gmm import ref as gmm_ref

    serving = [(40, c, d, f) for c in (1, 4, 8, 16, 17, 64) for d, f in ((1536, 512), (512, 1536))]
    # training capacities (on the grouped GEMM from TILED_MIN_C rows) and
    # shapes past its tile edges
    training = [(40, c, d, f) for c in (128, 256) for d, f in ((1536, 512), (512, 1536))] + \
        [(2, 130, 136, 264), (1, 200, 264, 136)]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        # the repo's sweep, ragged d (104: a partial last d tile), a long d
        # (1024: 32 tiles through the ring), a w that is not 16-byte aligned,
        # and the served shapes
        cases = [(2, 32, 16, 16, True), (4, 64, 96, 160, True), (8, 128, 128, 128, True),
                 (3, 5, 96, 160, True), (2, 37, 64, 12, True), (2, 16, 8, 12, True),
                 (3, 17, 104, 136, True), (2, 9, 1024, 72, True), (4, 64, 96, 160, False)] + \
            [c + (True,) for c in serving + training]
        for E, C, d, f, aligned in cases:
            x = _randn(gen, E, C, d, dtype=dtype)
            w = _randn(gen, E * d * f + 1, dtype=dtype) * d ** -0.5
            w = (w[:-1] if aligned else w[1:]).view(E, d, f)
            out = gmm_ops.grouped_matmul(x, w)
            want = gmm_ref.gmm_reference(x, w)
            torch.cuda.synchronize()
            errs[dtype] = max(errs.get(dtype, 0.0), _check(
                f"gmm {dtype} E={E} C={C} d={d} f={f} aligned={aligned}",
                out, want, **GMM_TOL[dtype]))
        routes = [gmm_ops.route(dtype, C, d, f, aligned) for _, C, d, f, aligned in cases]
        print(f"[kernels] grouped_matmul {str(dtype)[6:]}: {len(cases)} cases ({routes.count('mma')} "
              f"on gmm_mma_kernel, {routes.count('tiled')} on the grouped GEMM) match the plain "
              f"version, max abs err {errs[dtype]:.3e}")

    # granite-moe-3b-a800m decode: 8 slots -> capacity 4 per expert; the
    # gate/up products (d=1536 -> f=512) are two of each layer's three calls.
    gmm = _gmm_row(40, 4, 1536, 512, gen, flush)
    gmm["max_abs_err"] = max(errs.values())
    _print_gmm(gmm)
    # The path's other shapes: the down product and the prefill buckets'
    # capacities (C=16 at the 64-token bucket, C=64 at the 256-token one).
    for E, C, d, f in GMM_TIMED[1:]:
        _print_gmm(_gmm_row(E, C, d, f, gen, flush))
    # The training capacities, on the grouped GEMM, beside gmm_mma_kernel
    # (the route below TILED_MIN_C) on the same operands.
    for E, C, d, f in GMM_BWD_TIMED:
        r = _gmm_row(E, C, d, f, gen, flush)
        print(f"[kernels] grouped_matmul ({gmm_ops.route(torch.bfloat16, C, d, f, True)}) at "
              f"{MAIN_ARCH}'s training {r['shape']}: kernel {r['ms']:.4f} ms (gmm_mma_kernel: "
              f"{r['mma_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bmm {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}); host enqueue {r['host_us']:.1f} us/call")
    return gmm


# ------------------------------------------------- phase 2: the backward kernels
def _rel(out, want):
    """||out - want|| / ||want|| (||out - want|| where want is all zeros)."""
    d = torch.linalg.vector_norm(out.float() - want.float())
    n = torch.linalg.vector_norm(want.float())
    return (d / n).item() if n > 0 else d.item()


def _check_rows(what, out, want, atol, rtol):
    """_check with atol in units of each row's RMS over the last axis where
    that exceeds 1: |out - want| <= atol max(1, rms(want row)) + rtol |want|."""
    unit = want.float().square().mean(-1, keepdim=True).sqrt().clamp(min=1.0)
    _check(f"{what} (atol in units of the row's RMS)", out.float() / unit, want.float() / unit,
           atol, rtol)


def _flash_bwd_cases():
    """(H, KH, D, Sq, Sk, causal, window) of the backward's checks: qwen2-1.5b's,
    granite-moe-3b-a800m's and glm4-9b's heads (6, 3 and 16 query heads per KV
    head) from one token to the train phase's 512, a ragged 100 that no tile
    divides, a window, Sq < Sk with and without one; whisper-base's heads
    without a mask (its cross-attention against 1500 frames, and a ragged
    300); D=32; the CPU tests' shapes."""
    cases = []
    for H, KH, D in ((12, 2, 128), (24, 8, 64), (32, 2, 128)):
        cases += [(H, KH, D, s, s, True, 0) for s in (1, 64, 100, 512)]
        cases += [(H, KH, D, 200, 200, True, 64), (H, KH, D, 37, 130, True, 0),
                  (H, KH, D, 37, 130, True, 64)]
    cases += [(8, 8, 64, s, 1500, False, 0) for s in (16, 64)]
    cases += [(8, 8, 64, 300, 300, False, 0), (4, 2, 32, 48, 48, True, 16),
              (6, 6, 32, 80, 80, True, 0)]
    # tests/test_torch_train_kernels.py's shapes with 6 query heads per KV
    # head at D = 64 and 128
    cases += [(12, 2, 128, 128, 128, True, 0), (6, 1, 64, 64, 64, True, 16),
              (6, 1, 128, 64, 128, True, 0)]
    return cases


def _flash_bwd_kernel(gen, flush):
    """The flash backward (and the forward's LSE) against the plain versions
    over _flash_bwd_cases, fp32 and bf16; bf16 gradients also within
    FLASH_BWD_REL of the plain backward in fp32. Through autograd and under
    torch.utils.checkpoint the gradients are the kernel's, bit for bit. Then
    timed at the train phase's shapes beside the plain backward and SDPA's
    backward through autograd."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    err = lse_err = rel = 0.0
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for H, KH, D, Sq, Sk, causal, window in _flash_bwd_cases():
            q, dout = (_randn(gen, 2, Sq, H, D, dtype=dtype) for _ in range(2))
            k, v = (_randn(gen, 2, Sk, KH, D, dtype=dtype) for _ in range(2))
            what = (f"flash bwd {dtype} H={H} KH={KH} D={D} Sq={Sq} Sk={Sk} causal={causal} "
                    f"window={window}")
            out, lse = fa_ops._forward("cuda", q, k, v, causal, window, None, True)
            got = fa_ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, window=window)
            want = fa_ref.mha_backward_reference(q, k, v, dout, causal=causal, window=window)
            torch.cuda.synchronize()
            lse_err = max(lse_err, _check(f"{what} lse", lse, fa_ref.lse_reference(
                q, k, causal=causal, window=window), **LSE_TOL))
            check = _check if dtype == torch.float32 else _check_rows
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                check(f"{what} {name}", a, b, **FLASH_BWD_TOL[dtype])
                err = max(err, (a.float() - b.float()).abs().max().item())
            if dtype == torch.bfloat16:
                exact = fa_ref.mha_backward_reference(q.float(), k.float(), v.float(),
                                                      dout.float(), causal=causal, window=window)
                for name, a, b in zip(("dq", "dk", "dv"), got, exact):
                    r = _rel(a, b)
                    assert r <= FLASH_BWD_REL, \
                        f"{what} {name}: error {r:.3e} exceeds {FLASH_BWD_REL} of the norm"
                    rel = max(rel, r)
            n += 1
    # the same gradients through autograd, and through a checkpointed call
    # whose backward reruns the forward and saves that run's LSE
    from torch.utils.checkpoint import checkpoint
    q = _randn(gen, 2, 100, 12, 128, dtype=torch.bfloat16)
    k, v = (_randn(gen, 2, 100, 2, 128, dtype=torch.bfloat16) for _ in range(2))
    dout = _randn(gen, 2, 100, 12, 128, dtype=torch.bfloat16)
    out, lse = fa_ops._forward("cuda", q, k, v, True, 0, None, True)
    direct = fa_ops.flash_attention_bwd(q, k, v, out, lse, dout)
    for remat in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = checkpoint(fa_ops.flash_attention, *leaves, use_reentrant=False) if remat \
            else fa_ops.flash_attention(*leaves)
        auto = torch.autograd.grad(o, leaves, dout)
        assert all(torch.equal(a, b) for a, b in zip(auto, direct)), \
            f"flash through autograd (checkpointed: {remat}) differs from the backward kernel"
    print(f"[kernels] flash backward: {n} cases match the plain version, max abs err {err:.3e}; "
          f"bf16 gradients within {rel:.3e} of the fp32 plain backward's norm; forward LSE "
          f"within {lse_err:.3e}; through autograd and a checkpoint bit for bit the kernel's")

    rows = {arch: _flash_bwd_row(arch, *TRAIN_SHAPES[arch], gen, flush)
            for arch in ATTENTION_TRAIN_ARCHS + (SSD_ARCH,)}
    for arch, r in rows.items():
        _print_bwd(arch, r)
    row = rows[MAIN_ARCH]
    row["max_abs_err"] = err
    return row


def _flash_bwd_row(arch, B, S, gen, flush):
    """The flash backward timed at ``arch``'s heads, B x S causal, bf16,
    beside the plain backward, SDPA's backward through autograd (timed here
    only) and the bound: q, k, v, the output, dO and the LSE read once, dq,
    dk and dv written once; 10 D operations per kept (query, key) pair and
    head (s, dP, dV, dK, dQ)."""
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    cfg = get_config(arch)
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, dout = (_randn(gen, B, S, H, D, dtype=torch.bfloat16) for _ in range(2))
    k, v = (_randn(gen, B, S, KH, D, dtype=torch.bfloat16) for _ in range(2))
    out, lse = fa_ops._forward("cuda", q, k, v, True, 0, None, True)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = dout.transpose(1, 2).contiguous()
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    bound, by = _bound(nbytes, 10 * B * H * (S * (S + 1) // 2) * D)
    call = lambda: fa_ops.flash_attention_bwd(q, k, v, out, lse, dout)  # noqa: E731
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention/ops.py:36",
            "ms": _time_ms(call, flush),
            "plain_ms": _time_ms(lambda: fa_ref.mha_backward_reference(q, k, v, dout), flush),
            "bound_ms": bound, "bound_by": by,
            "library_ms": _time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                                               retain_graph=True), flush),
            "host_us": _host_us(call),
            "shape": f"B={B} S={S} H={H} KH={KH} D={D} bf16 causal"}


def _print_bwd(what, r):
    before = f" (before: {r['before_ms']:.4f}, its copy {r['copy_ms']:.4f})" if "before_ms" in r else ""
    print(f"[kernels] {r['name']} at {what}'s {r['shape']}: kernel {r['ms']:.4f} ms{before}, "
          f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
          f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}); host enqueue {r['host_us']:.1f} us/call")


# granite-moe-3b-a800m's expert products in training: capacity 256 at the
# train phase's B x S = 1024 tokens (one-hot dispatch: ceil(1.25 * 8 * 1024
# / 40)), 512 at 2048 tokens; gate/up (d=1536 -> f=512) and down.
GMM_BWD_TIMED = [(40, c, d, f) for c in (256, 512) for d, f in ((1536, 512), (512, 1536))]


def _gmm_bwd_kernel(gen, flush):
    """The grouped matmul's gradients against their plain versions: the
    repo's gradient-check shape, ragged shapes (on the CUDA-core kernel: d or
    f not a multiple of 8), capacities that are not multiples of 8 (which dw
    contracts over), shapes past the GEMM's tile edges, a decode-size
    capacity and the train phase's; fp32 and bf16.
    Through autograd the gradients are the kernels', bit for bit. Then dx and
    dw timed at granite's training capacities beside the plain versions and
    torch.bmm on the same operands."""
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.moe_gmm import ref as gmm_ref

    # the last three: tests/test_torch_train_kernels.py's shapes past the
    # GEMM's tile edges (C, d and f past 128 rows and columns and past the K
    # steps of 64), then at granite's width
    cases = [(2, 16, 8, 12), (3, 17, 104, 136), (2, 37, 64, 12), (4, 100, 96, 160),
             (40, 9, 1536, 512), (40, 256, 1536, 512), (40, 256, 512, 1536), (40, 512, 1536, 512),
             (2, 130, 136, 72), (1, 200, 264, 136), (40, 130, 1544, 520)]
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for E, C, d, f in cases:
            # w and g scaled so that dx and dw stay near 1 whatever d and C
            x = _randn(gen, E, C, d, dtype=dtype)
            w = (torch.randn((E, d, f), generator=gen, device="cuda") * d ** -0.5).to(dtype)
            g = (torch.randn((E, C, f), generator=gen, device="cuda") * C ** -0.5).to(dtype)
            dx, dw = gmm_ops.grouped_matmul_dx(g, w), gmm_ops.grouped_matmul_dw(x, g)
            torch.cuda.synchronize()
            what = f"gmm bwd {dtype} E={E} C={C} d={d} f={f}"
            err = max(err, _check(f"{what} dx", dx, gmm_ref.gmm_dx_reference(g, w),
                                  **GMM_BWD_TOL[dtype]),
                      _check(f"{what} dw", dw, gmm_ref.gmm_dw_reference(x, g), **GMM_BWD_TOL[dtype]))
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        auto = torch.autograd.grad(gmm_ops.grouped_matmul(xl, wl), (xl, wl), g)
        assert torch.equal(auto[0], dx) and torch.equal(auto[1], dw), \
            f"gmm through autograd ({dtype}) differs from the dx / dw kernels"
    print(f"[kernels] grouped_matmul dx / dw: {2 * len(cases)} cases each match the plain "
          f"versions, max abs err {err:.3e}; through autograd bit for bit the kernels'")

    rows = [_gmm_bwd_rows(*shape, gen, flush) for shape in GMM_BWD_TIMED]
    for pair in rows:
        for r in pair:
            _print_bwd(MAIN_ARCH, r)
    for r in rows[0]:
        r["max_abs_err"] = err
    return rows[0]


def _gmm_bwd_rows(E, C, d, f, gen, flush):
    """dx = g w^T and dw = x^T g of the grouped matmul (E, C, d) @ (E, d, f)
    timed, bf16, beside the plain versions, torch.bmm on the same operands
    (timed here only) and the bound: each operand read once, the gradient
    written once, 2 E C d f operations. before_ms: the earlier path, the
    wrapper's contiguous copy of w^T or x^T and the forward kernel on it
    (timed as one call, copy included); copy_ms: that copy alone."""
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.moe_gmm import ref as gmm_ref

    x, w, g = (_randn(gen, *s, dtype=torch.bfloat16) for s in ((E, C, d), (E, d, f), (E, C, f)))
    rows = []
    for name, call, plain, lib, before, copy, out_elems in (
            ("grouped_matmul_dx", lambda: gmm_ops.grouped_matmul_dx(g, w),
             lambda: gmm_ref.gmm_dx_reference(g, w), lambda: torch.bmm(g, w.transpose(1, 2)),
             lambda: gmm_ops._launch(g, w.transpose(1, 2).contiguous()),
             lambda: w.transpose(1, 2).contiguous(), E * C * d),
            ("grouped_matmul_dw", lambda: gmm_ops.grouped_matmul_dw(x, g),
             lambda: gmm_ref.gmm_dw_reference(x, g), lambda: torch.bmm(x.transpose(1, 2), g),
             lambda: gmm_ops._launch(x.transpose(1, 2).contiguous(), g),
             lambda: x.transpose(1, 2).contiguous(), E * d * f)):
        ins = (g.numel() + w.numel()) if name.endswith("dx") else (x.numel() + g.numel())
        bound, by = _bound(2 * (ins + out_elems), 2 * E * C * d * f)
        rows.append({"name": name, "route": "cuda", "source": "src/repro_torch/csrc/moe_gmm.cu",
                     "replaces": "src/repro/kernels/moe_gmm/ops.py:22",
                     "ms": _time_ms(call, flush), "plain_ms": _time_ms(plain, flush),
                     "bound_ms": bound, "bound_by": by, "library_ms": _time_ms(lib, flush),
                     "before_ms": _time_ms(before, flush), "copy_ms": _time_ms(copy, flush),
                     "host_us": _host_us(call), "shape": f"E={E} C={C} d={d} f={f} bf16"})
    return rows


def _ssd_inputs(gen, B, S, H, P, N, dtype, init=False):
    """x, dt, A, B, C, D, initial state: x/B/C in ``dtype``, the rest fp32
    (the distributions of tests/test_kernels.py's SSD sweep)."""
    f32 = torch.float32
    u = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(shape, generator=gen, device="cuda")  # noqa: E731
    return (_randn(gen, B, S, H, P, dtype=dtype), u(0.001, 0.1, B, S, H), -u(0.5, 2.0, H),
            _randn(gen, B, S, N, dtype=dtype), _randn(gen, B, S, N, dtype=dtype),
            _randn(gen, H, dtype=f32), _randn(gen, B, H, P, N, dtype=f32) if init else None)


def _ssd_cost(B, S, H, P, N, itemsize, init):
    """Bytes the scan must move (each input read once, y and the final state
    written once) and the operations it needs: per (b, chunk of v
    tokens) C.B^T over u <= t, once for all heads; per head the masked
    scores times x, the read of the carried state (not where that state is
    the zero initial state) and the state update."""
    nbytes = itemsize * (2 * B * S * H * P + 2 * B * S * N) + 4 * (B * S * H + 2 * H) \
        + 4 * B * H * P * N * (2 if init else 1)
    flops = 0
    for c0 in range(0, S, 64):
        v = min(64, S - c0)
        tri = v * (v + 1) // 2
        state_read = 2 * v * N * P if (c0 or init) else 0
        flops += B * (2 * tri * N + H * (2 * tri * P + state_read + 2 * v * P * N))
    return nbytes, flops


def _ssd_kernel(gen, flush):
    """The SSD scan against its plain version on both dtypes of x/B/C, at
    the test sweep's (H, P, N), a P that 16 does not divide, and zamba2's
    (64, 64, 64); S from 1 to 1000 (ragged tails); B 1 and 3, B=3 with a
    nonzero initial state; then zamba2's layout, x/B/C as column slices of
    one conv buffer. Timed at zamba2-1.2b's prefill shape (B=1, S=64, bf16),
    and the kernel alone at S=256 and 1000."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.mamba_scan import ref as ms_ref

    errs, rel = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        n = n_mma = 0
        # the test sweep's (H, P, N), P = 24 and 12 (which 16 does not
        # divide; 12 takes the CUDA-core kernel in bf16 too), N = 128, and
        # zamba2's (64, 64, 64)
        for H, P, N in ((2, 16, 16), (3, 16, 32), (1, 64, 64), (2, 24, 32), (2, 12, 16),
                        (2, 32, 128), (64, 64, 64)):
            for S in (1, 8, 63, 64, 100, 128, 200, 1000):
                for B in (1, 3):
                    args = _ssd_inputs(gen, B, S, H, P, N, dtype, init=B == 3)
                    y, st = ms_ops.ssd_scan(*args, with_state=True)
                    yw, sw = ms_ref.ssd_chunked_reference(*args)
                    torch.cuda.synchronize()
                    what = f"ssd {dtype} B={B} S={S} H={H} P={P} N={N}"
                    errs[dtype] = max(errs.get(dtype, 0.0),
                                      _check(what + " y", y, yw, **SSD_TOL[dtype]),
                                      _check(what + " state", st, sw, **SSD_TOL[dtype]))
                    if dtype == torch.bfloat16:
                        x, dt, A, Bm, Cm, D, s0 = args
                        y32, s32 = ms_ref.ssd_chunked_reference(x.float(), dt, A, Bm.float(),
                                                                Cm.float(), D, s0)
                        ry, rs = _row_rel(y, y32), _row_rel(st, s32)
                        r = max(ry, rs)
                        assert r <= SSD_ROW_REL, (f"{what}: row error {ry:.3e} (y), {rs:.3e} "
                                                  f"(state) exceeds {SSD_ROW_REL} of the row's norm")
                        rel = max(rel, r)
                    n_mma += ms_ops.takes_mma(args[0], args[3], args[4])
                    n += 1
        # the model's layout: x, B and C are column slices of one conv buffer
        H, P, N = 64, 64, 64
        for S in (63, 200):
            buf = _randn(gen, 1, S, H * P + 2 * N, dtype=dtype)
            x, Bm, Cm = buf[..., :H * P].view(1, S, H, P), buf[..., H * P:H * P + N], buf[..., H * P + N:]
            _, dt, A, _, _, D, _ = _ssd_inputs(gen, 1, S, H, P, N, dtype)
            y, st = ms_ops.ssd_scan(x, dt, A, Bm, Cm, D, with_state=True)
            yw, sw = ms_ref.ssd_chunked_reference(x, dt, A, Bm, Cm, D)
            torch.cuda.synchronize()
            errs[dtype] = max(errs[dtype],
                              _check(f"ssd {dtype} strided S={S} y", y, yw, **SSD_TOL[dtype]),
                              _check(f"ssd {dtype} strided S={S} state", st, sw, **SSD_TOL[dtype]))
            n += 1
        print(f"[kernels] ssd_scan {str(dtype)[6:]}: {n} cases ({n_mma} on the tensor-core "
              f"kernel) match the plain version (y and final state), max abs err "
              f"{errs[dtype]:.3e}" + (f"; rows within {rel:.3e} of the fp32 plain version's norm"
                                      if dtype == torch.bfloat16 else ""))

    cfg = get_config(SSD_ARCH)
    H, P, N = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    B, S = 1, 64
    args = _ssd_inputs(gen, B, S, H, P, N, torch.bfloat16)
    bound, by = _bound(*_ssd_cost(B, S, H, P, N, 2, False))
    ssd = {"name": "ssd_scan", "route": "cuda",
           "source": "src/repro_torch/csrc/mamba_scan.cu",
           "replaces": "src/repro/kernels/mamba_scan/kernel.py:79",
           "max_abs_err": max(errs.values()),
           "ms": _time_ms(lambda: ms_ops.ssd_scan(*args, with_state=True), flush),
           "before_ms": _time_ms(lambda: _ssd_before(*args), flush),
           "plain_ms": _time_ms(lambda: ms_ref.ssd_chunked_reference(*args), flush),
           "bound_ms": bound, "bound_by": by, "library_ms": None,
           "host_us": _host_us(lambda: ms_ops.ssd_scan(*args, with_state=True)),
           "shape": f"B={B} S={S} H={H} P={P} N={N} bf16 x/B/C"}
    print(f"[kernels] ssd_scan at {SSD_ARCH}'s {ssd['shape']}: kernel {ssd['ms']:.4f} ms "
          f"(before: {ssd['before_ms']:.4f}), plain {ssd['plain_ms']:.4f} ms, no library call, "
          f"bound {ssd['bound_ms']:.6f} ms ({ssd['bound_by']}, bf16 rate); "
          f"host enqueue {ssd['host_us']:.1f} us/call")
    sweep = []
    for S in (256, 1000):
        args = _ssd_inputs(gen, B, S, H, P, N, torch.bfloat16)
        b_ms, b_by = _bound(*_ssd_cost(B, S, H, P, N, 2, False))
        sweep.append(f"S={S}: {_time_ms(lambda: ms_ops.ssd_scan(*args, with_state=True), flush):.4f} ms "
                     f"(before: {_time_ms(lambda: _ssd_before(*args), flush):.4f}; "
                     f"bound {b_ms:.6f}, {b_by})")
    print(f"[kernels] ssd_scan alone at B=1 H={H} P={P} N={N} bf16: {'; '.join(sweep)}")
    return ssd


def _ssd_before(x, dt, A, Bm, Cm, D, init):
    """The earlier CUDA-core SSD kernel (now the fp32 variant) on the same
    bf16 inputs, through the C entry point: timed as before_ms, never
    counted as a launch."""
    from repro_torch.kernels.common import DTYPE_CODES
    from repro_torch.kernels.mamba_scan import ops as ms_ops

    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    final = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    err = ms_ops._lib()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                        D.data_ptr(), None if init is None else init.data_ptr(), y.data_ptr(),
                        final.data_ptr(), Bsz, S, H, P, N, x.stride(0), x.stride(1),
                        dt.stride(0), dt.stride(1), Bm.stride(0), Bm.stride(1), Cm.stride(0),
                        Cm.stride(1), DTYPE_CODES[x.dtype], ms_ops.VARIANTS["fma"],
                        x.device.index, torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"ssd before: error {err}"
    return y, final


def _ssd_bwd_cost(B, S, H, P, N, itemsize, init):
    """Bytes the scan's backward must move (x, B, C, dy, dt, A, D and the
    initial state read once; dx, dB, dC, ddt, dA, dD and dinit written once)
    and the operations it needs: per (b, chunk of v tokens) C.B^T over
    u <= t, once for all heads; per head the chunk start states' recompute
    (every chunk but the last), dy.x^T, dx's and dB's and dC's sums over the
    triangle, and the products with the state's adjoint G (G B and G^T x; not
    in the last chunk, where G is zero), with the start state (S0^T dy; not
    where that is the zero initial state) and G's update (not after the first
    chunk unless there is an initial state)."""
    nbytes = itemsize * (3 * B * S * H * P + 4 * B * S * N) + 4 * 2 * (B * S * H + 2 * H) \
        + 4 * B * H * P * N * (2 if init else 1)
    flops, starts = 0, list(range(0, S, 64))
    for c, c0 in enumerate(starts):
        v = min(64, S - c0)
        tri = v * (v + 1) // 2
        last, first = c == len(starts) - 1, c == 0
        state_ops = (not last) * 3 + (not first or init) * 2   # recompute, G B, G^T x | S0^T dy, G update
        flops += B * (2 * tri * N + H * (2 * tri * P + 2 * tri * P + 2 * 2 * tri * N
                                         + state_ops * 2 * v * P * N))
    return nbytes, flops


def _ssd_bwd_check(what, got, args, dy):
    """One backward call against the plain backward: fp32 against the plain
    pass in fp64 (returns the largest share of the tolerance, the kernel's
    and the fp32 plain pass's); bf16 against the plain pass on the same
    inputs, and within SSD_ROW_REL of the plain pass in fp32 (returns the
    largest row error). Returns (max abs err, ratio or row error, plain
    fp32 ratio or 0)."""
    from repro_torch.kernels.mamba_scan import ref as ms_ref

    dtype = args[0].dtype
    tol = SSD_BWD_TOL[dtype]
    if dtype == torch.float32:
        want = ms_ref.ssd_backward_reference(*[None if a is None else a.double() for a in args],
                                             dy.double())
        plain = ms_ref.ssd_backward_reference(*args, dy)
        share = lambda a, w: ((a.double() - w).abs() / (tol["atol"] + tol["rtol"] * w.abs())).max().item()  # noqa: E731
        err = ratio = own = 0.0
        for name, g, w, p in zip(SSD_BWD_NAMES, got, want, plain):
            err = max(err, _check(f"{what} {name}", g.double(), w, **tol))
            ratio, own = max(ratio, share(g, w)), max(own, share(p, w))
        return err, ratio, own
    same = ms_ref.ssd_backward_reference(*args, dy)
    x, dt, A, Bm, Cm, D, s0 = args
    exact = ms_ref.ssd_backward_reference(x.float(), dt, A, Bm.float(), Cm.float(), D, s0,
                                          dy.float())
    err = rel = 0.0
    for name, g, w, e in zip(SSD_BWD_NAMES, got, same, exact):
        assert g.dtype == w.dtype, f"{what} {name}: {g.dtype}, plain {w.dtype}"
        err = max(err, _check(f"{what} {name}", g, w, **tol))
        r = _row_rel(g, e) if name in ("dx", "dB", "dC") else _rel(g, e)
        assert r <= SSD_ROW_REL, f"{what} {name}: error {r:.3e} exceeds {SSD_ROW_REL} of the norm"
        rel = max(rel, r)
    return err, rel, 0.0


def _ssd_bwd_kernel(gen, flush):
    """The SSD scan's backward kernel (B7) against its plain version: the
    forward's cases (the test sweep's (H, P, N), P = 24 and 12, which 16 does
    not divide, every N of STATE_DIMS, zamba2's (64, 64, 64); S from 1 to
    1000, ragged tails; B 1, and 3 with a nonzero initial state), zamba2's
    layout (x, B and C column slices of one conv buffer, B 1 and 2) and
    heads the two-sweep kernel refused (fp32 P = 64, N = 128; bf16 P = N = 128
    and P = 200, N = 64; S 63, 200, 1000, the 200 at B = 2 with an initial
    state); fp32 and bf16, every case twice, bit for bit. Then through autograd
    and under a checkpoint: an ssd_scan call under grad whose backward goes
    through the kernel (counted), bit for bit the kernel's, and held to the
    plain version's autograd (fp64 for the fp32 kernel, at its tolerance;
    fp32 for the bf16 one, in rows). Timed at zamba2-1.2b's train shape (B=4,
    S=512, bf16, x/B/C the conv buffer's slices, dy contiguous) beside the
    plain backward and the bound."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.mamba_scan import ref as ms_ref

    def conv_slices(B, S, H, P, N, dtype):
        buf = _randn(gen, B, S, H * P + 2 * N, dtype=dtype)
        _, dt, A, _, _, D, _ = _ssd_inputs(gen, B, S, H, P, N, dtype)
        return (buf[..., :H * P].view(B, S, H, P), dt, A, buf[..., H * P:H * P + N],
                buf[..., H * P + N:], D, None)

    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(f"B={B} S={S} H={H} P={P} N={N}", _ssd_inputs(gen, B, S, H, P, N, dtype,
                                                                 init=B == 3))
                 for H, P, N in ((2, 16, 16), (3, 16, 32), (1, 64, 64), (2, 24, 32), (2, 12, 16),
                                 (2, 32, 128), (64, 64, 64))
                 for S in (1, 8, 63, 64, 100, 128, 200, 1000) for B in (1, 3)]
        cases += [(f"strided B={B} S={S}", conv_slices(B, S, 64, 64, 64, dtype))
                  for B, S in ((1, 63), (1, 200), (2, 200))]
        big = ((64, 128),) if dtype == torch.float32 else ((128, 128), (200, 64))
        cases += [(f"B={B} S={S} H=2 P={P} N={N}", _ssd_inputs(gen, B, S, 2, P, N, dtype,
                                                               init=B == 2))
                  for P, N in big for S, B in ((63, 1), (200, 2), (1000, 1))]
        n_mma = sum(ms_ops.bwd_takes_mma(a[0], a[3], a[4], a[0]) for _, a in cases)
        err = share = own = 0.0
        for what, args in cases:
            dy = _randn(gen, *args[0].shape, dtype=dtype)
            got = ms_ops.ssd_scan_bwd(*args, dy)
            again = ms_ops.ssd_scan_bwd(*args, dy)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                f"ssd bwd {dtype} {what}: two calls differ"
            e, r, o = _ssd_bwd_check(f"ssd bwd {dtype} {what}", got, args, dy)
            err, share, own = max(err, e), max(share, r), max(own, o)
        summary[dtype] = err
        if dtype == torch.float32:
            print(f"[kernels] ssd_scan_bwd float32: {len(cases)} cases match the plain backward "
                  f"in fp64, max abs err {err:.3e} ({share:.3f} of the tolerance at most; the "
                  f"plain backward in fp32 reaches {own:.3f} of it); two calls bit for bit")
        else:
            print(f"[kernels] ssd_scan_bwd bfloat16: {len(cases)} cases ({n_mma} on the tensor-core "
                  f"kernels) match the plain backward on the same inputs, max abs err {err:.3e}; "
                  f"dx, dB, dC rows (the rest in norm) within {share:.3e} of the fp32 plain "
                  f"backward; two calls bit for bit")

    # through autograd and a checkpoint: the Function's backward is the kernel
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, A, Bm, Cm, D, _ = conv_slices(2, 200, 64, 64, 64, dtype)
        s0 = _randn(gen, 2, 64, 64, 64, dtype=torch.float32)
        dy = _randn(gen, *x.shape, dtype=dtype)
        direct = ms_ops.ssd_scan_bwd(x, dt, A, Bm, Cm, D, s0, dy)
        for remat in (False, True):
            leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, Bm, Cm, D, s0)]
            before = ms_ops.ssd_scan_bwd.launches
            y = checkpoint(ms_ops.ssd_scan, *leaves, use_reentrant=False) if remat \
                else ms_ops.ssd_scan(*leaves)
            y.backward(dy)
            assert ms_ops.ssd_scan_bwd.launches == before + 1, "the backward kernel did not run"
            auto = [t.grad for t in leaves]
            assert all(torch.equal(a, b) for a, b in zip(auto, direct)), \
                f"ssd_scan through autograd ({dtype}, checkpointed: {remat}) differs from the kernel"
        # the plain version's autograd: in fp64 for the fp32 kernel (as its
        # direct checks), in fp32 for the bf16 one (as its row checks)
        wide = torch.float64 if dtype == torch.float32 else torch.float32
        plain = [t.detach().to(wide).requires_grad_() for t in (x, dt, A, Bm, Cm, D, s0)]
        grads = torch.autograd.grad(ms_ref.ssd_chunked_reference(*plain)[0], plain, dy.to(wide))
        for name, a, b in zip(SSD_BWD_NAMES, direct, grads):
            if dtype == torch.float32:
                _check(f"ssd_scan autograd fp32 {name}", a.double(), b, **SSD_BWD_TOL[dtype])
            else:
                r = _row_rel(a, b) if name in ("dx", "dB", "dC") else _rel(a, b)
                assert r <= SSD_ROW_REL, f"ssd_scan autograd bf16 {name}: {r:.3e} of the norm"
    print("[kernels] ssd_scan under grad: the backward through autograd and under a checkpoint "
          "is the kernel's, bit for bit (fp32, bf16), and matches the plain version's autograd")

    cfg = get_config(SSD_ARCH)
    H, P, N = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    B, S = TRAIN_SHAPES[SSD_ARCH]
    args = conv_slices(B, S, H, P, N, torch.bfloat16)
    dy = _randn(gen, B, S, H, P, dtype=torch.bfloat16)
    assert ms_ops.bwd_takes_mma(args[0], args[3], args[4], dy), "the train shape's route"
    nbytes, flops = _ssd_bwd_cost(B, S, H, P, N, 2, False)
    bound, by = _bound(nbytes, flops)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ms_ops.bwd_plan(B, S, H, P, N, torch.bfloat16, "mma", sms)
    before = ms_ops.bwd_plan(B, S, H, P, N, torch.bfloat16, "sweep", sms)
    call = lambda: ms_ops.ssd_scan_bwd(*args, dy)  # noqa: E731
    old = lambda: ms_ops._bwd_launch(before, *args, dy)  # noqa: E731
    assert all(bool(torch.isfinite(g).all()) for g in old()), "ssd bwd before: not finite"
    regs = _ptxas_lines("mamba_scan_bwd", ("ssd_bwd_states_mma<64>", "ssd_bwd_chunk_mma<64>",
                                           "ssd_bwd_kernel<__nv_bfloat16>"))
    row = {"name": "ssd_scan_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/mamba_scan_bwd.cu",
           "replaces": "src/repro/kernels/mamba_scan/ops.py:25",
           "max_abs_err": max(summary.values()),
           "ms": _time_ms(call, flush),
           "before_ms": _time_ms(old, flush),
           "plain_ms": _time_ms(lambda: ms_ref.ssd_backward_reference(*args, dy), flush, reps=10),
           "bound_ms": bound, "bound_by": by, "library_ms": None, "host_us": _host_us(call),
           "workspace_bytes": plan.workspace_bytes, "workspace_traffic": plan.workspace_traffic,
           "before_workspace_traffic": before.workspace_traffic, "registers": regs,
           "plan": f"{plan.heads_per_group} heads a group, chunk grid {plan.chunk_grid}, "
                   f"states grid {plan.states_grid}, {plan.blocks_per_sm} chunk blocks an SM",
           "shape": f"B={B} S={S} H={H} P={P} N={N} bf16 x/B/C/dy"}
    print(f"[kernels] ssd_scan_bwd at {SSD_ARCH}'s train shape {row['shape']} (x/B/C slices of "
          f"the conv buffer): kernel {row['ms']:.4f} ms (before: {row['before_ms']:.4f}), plain "
          f"{row['plain_ms']:.4f} ms, no library call, bound {bound:.6f} ms ({by}, bf16 rate: "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; the bytes alone "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms, the operations "
          f"{flops / BF16_FLOP_PER_S * 1e3:.6f} ms); host enqueue {row['host_us']:.1f} us/call")
    print(f"[kernels] ssd_scan_bwd plan: {row['plan']}; workspace {plan.workspace_bytes / 1e6:.1f} "
          f"MB allocated (S0 and G {plan.state_bytes / 1e6:.1f}, of them "
          f"{plan.state_traffic / 1e6:.1f} written; dB / dC partials {plan.dbc_bytes / 1e6:.1f}; "
          f"dA / dD partials {plan.ad_bytes / 1e6:.3f}), {plan.workspace_traffic / 1e6:.1f} MB "
          f"written and read back (before: {before.workspace_traffic / 1e6:.1f} MB)")
    for line in regs:
        print(f"[kernels] ssd_scan_bwd {line}")
    _profiled("ssd_scan_bwd at the train shape, by kernel", call, 5)
    return row


def _ptxas_lines(lib, kernels):
    """ptxas's registers and spills of the named kernels in ``lib``'s build
    log: one line each, "kernel: N registers, S bytes spill stores"."""
    from repro_torch.kernels import build

    out, fn, spill = [], None, ""
    for line in build.build_log(lib).splitlines():
        if "Function properties for" in line:
            fn = _demangle(line.split("Function properties for")[1].strip())
        elif fn in kernels and "spill stores" in line:
            spill = line.strip()
        elif fn in kernels and "registers" in line:
            regs = line.split("Used")[1].split(",")[0].strip()
            out.append(f"{fn}: {regs}, {spill}")
    return out


# ---------------------------------------------------------------- phase 3
def phase_parity(arch):
    """``arch`` at full width, cut in depth, fp32, on the card and on the
    CPU from one seeded set of weights: 2 layers (Whisper: 2 encoder and 2
    decoder layers, over its 1500 seeded frames; the VLM: its 256 seeded
    vision embeddings before the prompt), a 64-token prompt; for the
    hybrid, 12 layers (2 groups of attn_every=6 Mamba layers, each followed
    by the shared block) and a 200-token prompt (4 SSD chunks, the last
    ragged), with its SSM state compared too."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import common as cm
    from repro_torch.models.api import get_model

    cfg = get_config(arch)
    hybrid = cfg.family == "hybrid"
    cut = dict(n_layers=2 * cfg.attn_every if hybrid else 2, dtype="float32")
    if cfg.is_encoder_decoder:
        cut["n_enc_layers"] = 2
    cfg = cfg.with_(**cut)
    model = get_model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(0), cfg)
    p_gpu = cm.nest({k: v.cuda() for k, v in cm.flatten(p_cpu).items()})
    rng = np.random.default_rng(0)
    S = 200 if hybrid else 64
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32))
    V = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    last = torch.tensor([V + 40, V + S - 1], dtype=torch.int32)
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 2)).astype(np.int32))
    batch = {"tokens": toks}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(
            rng.standard_normal((2, V, cfg.d_model)).astype(np.float32))
    tol = dict(atol=2e-4, rtol=2e-3)     # the repo's fp32 model bound

    logits, caches = {}, {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        lg, c = model.prefill(p, cfg, {k: v.to(dev) for k, v in batch.items()}, last.to(dev))
        # room for 4 decode steps along the K/V sequence axis; the hybrid's
        # SSM and conv state are per sequence and keep their shape
        pad = torch.zeros(c["k"].shape[:2] + (4,) + c["k"].shape[3:], device=dev)
        c = dict(c, k=torch.cat([c["k"], pad], 2), v=torch.cat([c["v"], pad], 2))
        logits[dev], caches[dev] = [lg], c
        for t in steps:
            lg, caches[dev] = model.decode_step(p, cfg, caches[dev], t.to(dev))
            logits[dev].append(lg)
    err = max(_check(f"parity {arch} {'prefill' if i == 0 else f'decode {i}'}",
                     g.cpu(), c, **tol)
              for i, (c, g) in enumerate(zip(logits["cpu"], logits["cuda"])))
    state = ""
    if hybrid:
        ssm = caches["cpu"]["ssm"]
        state = (f"; SSM state (max |value| {ssm.abs().max().item():.3e}) max abs err "
                 f"{_check(f'parity {arch} SSM state', caches['cuda']['ssm'].cpu(), ssm, **tol):.3e}")
    depth = f"{cfg.n_enc_layers} + {cfg.n_layers}" if cfg.is_encoder_decoder else cfg.n_layers
    inputs = f", {cfg.enc_seq} frames" if cfg.family == "audio" else \
        f", {V} vision tokens" if V else ""
    print(f"[parity] {arch} full width, {depth} layers, fp32, {S}-token prompt{inputs}: "
          f"prefill + 4 decode steps on the card match the CPU, logits max abs err "
          f"{err:.3e}{state} (atol {tol['atol']}, rtol {tol['rtol']})")


def _xlstm_run(model, cfg, params, toks, last, steps, dev):
    """A prefill of ``toks`` with ``last`` then one decode step per row of
    ``steps`` on ``dev``: {(quantity, when): tensor on the CPU} of each step's
    logits and of every state entry after the prefill and after the last
    step (copied: decode updates the state in place)."""
    state = [n for names in model.STATE.values() for n in names]
    logits, cache = model.prefill(params, cfg, {"tokens": toks.to(dev)}, last.to(dev))
    out = {("logits", "prefill"): logits.cpu()}
    out.update({(n, "after the prefill"): cache[n].to("cpu", copy=True) for n in state})
    for i, t in enumerate(steps):
        logits, cache = model.decode_step(params, cfg, cache, t.to(dev))
        out["logits", f"decode {i + 1}"] = logits.cpu()
    out.update({(n, "after decode"): cache[n].cpu() for n in state})
    return out


def phase_parity_xlstm():
    """xlstm-350m at full width cut to XLSTM_PARITY_LAYERS (5 mLSTM, 1
    sLSTM), one seeded set of weights on the card and on the CPU:
    prompts of 512 tokens (2 mLSTM chunks) and of 300 (one chunk that 256
    does not divide), each a batch of 2 with last_pos, then 4 decode steps;
    the logits of every step and every state entry after the prefill and
    after the decode steps.
    - fp64 on both: the card matches the CPU within the fp32 model bound
      (atol 2e-4 / rtol 2e-3), the same code on each device.
    - fp32: no elementwise bound holds at this width. An fp32 run is up
      to a few 1e-4 off the exact (fp64) values, the JAX package's as much
      as the port's (PERF.md section 6), and the rounding of one run lands
      on other elements than another's, at up to 6x another run's largest
      error. So the card's fp32 run is held in norm: for each quantity (the
      logits of all steps; each state entry at both times), its error's
      norm relative to the exact values' norm stays within 3x the CPU's
      own fp32 run's, or 1e-4 (the CPU's is 5e-6 to 5e-5 at this cut); a
      wrong term moves it by orders of magnitude more.
    """
    from repro_torch.configs.registry import get_config
    from repro_torch.models import common as cm
    from repro_torch.models.api import get_model

    cfg = get_config(XLSTM).with_(n_layers=XLSTM_PARITY_LAYERS)
    model = get_model(cfg)
    p32 = model.init(torch.Generator().manual_seed(0), cfg.with_(dtype="float32"))
    rng = np.random.default_rng(0)
    atol, rtol = 2e-4, 2e-3       # the repo's fp32 model bound
    for S in (512, 300):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32))
        last = torch.tensor([40, S - 1], dtype=torch.int32)
        steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 2)).astype(np.int32))
        runs = {}
        for dtype in ("float64", "float32"):
            c = cfg.with_(dtype=dtype)
            for dev in ("cpu", "cuda"):
                p = cm.nest({k: v.to(dev, getattr(torch, dtype))
                             for k, v in cm.flatten(p32).items()})
                runs[dtype, dev] = _xlstm_run(model, c, p, toks, last, steps, dev)
        exact, err64 = runs["float64", "cpu"], 0.0
        sq = {}         # by quantity and run: sum of squared errors, and of exact values
        for key, want in exact.items():
            err64 = max(err64, _check(f"parity {XLSTM} S={S} fp64 {' '.join(key)}",
                                      runs["float64", "cuda"][key], want, atol, rtol))
            for side in ("cpu", "cuda", "exact"):
                got = want if side == "exact" else runs["float32", side][key].double() - want
                sq[key[0], side] = sq.get((key[0], side), 0.0) + got.square().sum().item()
        rel = {}
        for q in dict.fromkeys(key[0] for key in exact):
            own, card = ((sq[q, side] / sq[q, "exact"]) ** 0.5 for side in ("cpu", "cuda"))
            assert card <= max(1e-4, 3 * own), \
                f"parity {XLSTM} S={S} fp32 {q}: the card's relative error {card:.3e}, the CPU's {own:.3e}"
            rel[q] = (card, own)
        print(f"[parity] {XLSTM} full width, {cfg.n_layers} layers, {S}-token prompt, prefill + "
              f"4 decode steps: fp64 on the card matches the CPU in the logits and every state "
              f"entry, max abs err {err64:.3e} (atol {atol}, rtol {rtol}); fp32 error norm "
              f"relative to the fp64 values', the card's (the CPU's): " + ", ".join(
                  f"{q} {c:.2e} ({o:.2e})" for q, (c, o) in rel.items()))
    torch.cuda.empty_cache()


def phase_train_parity(arch, n_layers=2, S=64, dtype="float32"):
    """``arch`` at full width cut to ``n_layers``, in ``dtype``, one seeded
    set of weights on the card and on the CPU: one train step on each, a
    batch of 2 sequences of ``S`` tokens. The loss and every param's
    gradient agree within the parity bound (atol 2e-4 / rtol 2e-3), and
    every gradient is present and nonzero. The card's AdamW step (with the card's gradients) equals the
    CPU's AdamW on the same params and gradients within fp32 rounding (atol
    1e-6 / rtol 1e-5); beside the CPU's own step it stays within 2 lr, the
    most two AdamW steps from the same params can differ (lr g / (|g| + eps)
    is below lr in size), and the share of params off by more than the parity
    bound is printed (a gradient within a few eps of zero flips its update)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import common as cm
    from repro_torch.models.api import get_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps

    cfg = get_config(arch).with_(n_layers=n_layers, dtype=dtype)
    model = get_model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(0), cfg)
    p_gpu = cm.nest({k: v.cuda() for k, v in cm.flatten(p_cpu).items()})
    p_ref = cm.nest({k: v.clone() for k, v in cm.flatten(p_cpu).items()})
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32))
    tol = dict(atol=2e-4, rtol=2e-3)     # the repo's fp32 model bound
    oc = opt.OptConfig(total_steps=4, warmup_steps=1)
    loss, grads = {}, {}
    for side, dev, p in (("cpu", "cpu", p_cpu), ("card", "cuda", p_gpu)):
        flat = cm.flatten(p)
        for t in flat.values():
            t.requires_grad_(True)
        lv, _ = steps.loss_fn(p, cfg, {"tokens": toks.to(dev), "labels": toks.to(dev)})
        grads[side] = dict(zip(flat, torch.autograd.grad(lv, list(flat.values()))))
        loss[side] = lv.item()
    gerr = 0.0
    for key, g in grads["card"].items():
        assert g.abs().max().item() > 0, f"train parity {arch}: {key} got no gradient"
        gerr = max(gerr, _check(f"train parity {arch} grad {key}", g.cpu(), grads["cpu"][key], **tol))
    lerr = _check(f"train parity {arch} loss", torch.tensor(loss["card"]), torch.tensor(loss["cpu"]),
                  **tol)
    lr = opt.lr_at(oc, 1).item()
    grads_gpu = cm.nest({k: g.contiguous() for k, g in grads["card"].items()})
    opt.adamw_update(oc, p_gpu, grads_gpu, opt.init_opt_state(p_gpu))
    opt.adamw_update(oc, p_ref, cm.nest({k: g.cpu() for k, g in grads["card"].items()}),
                     opt.init_opt_state(p_ref))
    opt.adamw_update(oc, p_cpu, cm.nest({k: g.contiguous() for k, g in grads["cpu"].items()}),
                     opt.init_opt_state(p_cpu))
    perr = drift = 0.0
    off = total = 0
    for key, t in cm.flatten(p_gpu).items():
        got = t.detach().cpu()
        perr = max(perr, _check(f"train parity {arch} AdamW {key}", got,
                                cm.flatten(p_ref)[key], atol=1e-6, rtol=1e-5))
        own = cm.flatten(p_cpu)[key].detach()
        d = (got - own).abs()
        drift = max(drift, d.max().item())
        off += int((d > tol["atol"] + tol["rtol"] * own.abs()).sum())
        total += own.numel()
    assert drift <= 2 * lr, f"train parity {arch}: params {drift:.3e} apart, over 2 lr = {2 * lr:.3e}"
    print(f"[parity] {arch} full width, {cfg.n_layers} layers, {dtype.replace('float', 'fp')}, "
          f"one train step (B=2, S={S}) on the card "
          f"matches the CPU: loss {loss['card']:.6f} (err {lerr:.3e}), all {len(grads['card'])} "
          f"gradients present, max abs err {gerr:.3e} (atol {tol['atol']}, rtol {tol['rtol']}); "
          f"AdamW (lr {lr:.3e}) on the card's gradients within {perr:.3e} of the CPU's; beside "
          f"the CPU's own step within {drift:.3e} (2 lr {2 * lr:.3e}), {off} of {total} params "
          f"outside the parity bound")
    del p_gpu, grads, grads_gpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4
def _kernel_ops():
    """Each kernel's wrapper by name; a wrapper's ``launches`` counts the
    launches of its kernel and nothing else."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    return {"flash_attention": fa_ops.flash_attention,
            "flash_attention_bwd": fa_ops.flash_attention_bwd,
            "decode_attention": da_ops.decode_attention,
            "grouped_matmul": gmm_ops.grouped_matmul,
            "grouped_matmul_dx": gmm_ops.grouped_matmul_dx,
            "grouped_matmul_dw": gmm_ops.grouped_matmul_dw,
            "ssd_scan": ms_ops.ssd_scan,
            "ssd_scan_bwd": ms_ops.ssd_scan_bwd}


def _per_call_launches(cfg):
    """The launches each prefill and each decode step must make: one
    attention kernel per layer, and for MoE three grouped matmuls per layer
    (gate, up, down). The hybrid: one SSD scan per Mamba layer in prefill
    (none in decode, whose one-token recurrence is plain torch) and one
    attention kernel per shared-block insertion. Whisper: one flash per
    encoder layer and two per decoder layer (self, cross) in prefill, two
    decode attention per decoder layer in decode. The xLSTM: none, its
    mLSTM and sLSTM are plain torch in both packages."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        none = dict.fromkeys(("flash_attention", "decode_attention", "grouped_matmul", "ssd_scan"), 0)
        return {"prefill": none, "decode": none}
    if cfg.family == "hybrid":
        ni = L // cfg.attn_every
        return {"prefill": {"flash_attention": ni, "decode_attention": 0,
                            "grouped_matmul": 0, "ssd_scan": L},
                "decode": {"flash_attention": 0, "decode_attention": ni,
                           "grouped_matmul": 0, "ssd_scan": 0}}
    if cfg.family == "audio":
        return {"prefill": {"flash_attention": cfg.n_enc_layers + 2 * L, "decode_attention": 0,
                            "grouped_matmul": 0, "ssd_scan": 0},
                "decode": {"flash_attention": 0, "decode_attention": 2 * L,
                           "grouped_matmul": 0, "ssd_scan": 0}}
    gmm = 3 * L if cfg.family == "moe" else 0
    return {"prefill": {"flash_attention": L, "decode_attention": 0, "grouped_matmul": gmm,
                        "ssd_scan": 0},
            "decode": {"flash_attention": 0, "decode_attention": L, "grouped_matmul": gmm,
                       "ssd_scan": 0}}


CAPTURES = ("prefill_capture", "decode_capture")


class _Counted:
    """For the length of a ``with``, wraps a family module's prefill and
    decode_step (the engine and the model API call them through the module):
    every call must launch each kernel exactly as _per_call_launches says
    for the config it is given, and a prefill or decode_step that a CUDA
    graph's capture records (kinds "prefill_capture", "decode_capture")
    must record each kernel so, in the wrappers' ``captured`` counts, and
    launch none. Counts the calls per (model, kind) and keeps whether every
    logit was finite (the check is recorded with a captured call and runs
    at each replay); on entry sets every launch and capture count to 0."""

    def __init__(self, model):
        self.model = model
        self.ops = _kernel_ops()
        self.real = {"prefill": model.prefill, "decode": model.decode_step}
        self.calls = {}
        self.finite = torch.ones((), dtype=torch.bool, device="cuda")

    def _wrap(self, kind):
        def call(params, cfg, *a, **kw):
            capture = torch.cuda.is_current_stream_capturing()
            before = {n: (op.launches, op.captured) for n, op in self.ops.items()}
            logits, cache = self.real[kind](params, cfg, *a, **kw)
            launched = {n: op.launches - before[n][0] for n, op in self.ops.items()}
            recorded = {n: op.captured - before[n][1] for n, op in self.ops.items()}
            got, none = (recorded, launched) if capture else (launched, recorded)
            want = {n: _per_call_launches(cfg)[kind].get(n, 0) for n in self.ops}
            kind_ = f"{kind}_capture" if capture else kind
            assert got == want and not any(none.values()), \
                f"{cfg.name} {kind_}: launched {launched}, captured {recorded}, want {want}"
            self.calls[cfg.name, kind_] = self.calls.get((cfg.name, kind_), 0) + 1
            self.finite.logical_and_(torch.isfinite(logits).all())
            return logits, cache
        return call

    def launches(self):
        return {n: op.launches for n, op in self.ops.items()}

    def captured(self):
        return {n: op.captured for n, op in self.ops.items()}

    def expected(self, cfgs, kinds=("prefill", "decode")):
        """Launches the counted calls of the models ``cfgs`` must have made
        (with ``kinds=CAPTURES``, what their captures must have recorded)."""
        return {n: sum(_per_call_launches(c)[k.removesuffix("_capture")].get(n, 0)
                       * self.calls.get((c.name, k), 0) for c in cfgs for k in kinds)
                for n in self.ops}

    def __enter__(self):
        for op in self.ops.values():
            op.launches = op.captured = 0
        self.model.prefill, self.model.decode_step = self._wrap("prefill"), self._wrap("decode")
        return self

    def __exit__(self, *exc):
        self.model.prefill, self.model.decode_step = self.real["prefill"], self.real["decode"]


def _eager_prefill(eng, n):
    """The engine's prefill body run eagerly on its static buffers: the
    harness's yardstick for a prefill graph's replay."""
    from repro_torch.serving.engine import prefill_body
    prefill_body(*eng._prefill_args(n))
    return eng.prefill_logits


@contextlib.contextmanager
def _engines(eager=False, margins=False):
    """Records what every TorchEngine made inside the ``with`` did: yields a
    list that is filled on exit with one dict per engine (its model,
    whether it captured its decode graph, its replays, its decode rows; the
    shapes of its prefill graphs, their replays after capture, the seconds
    of each capture (warm-up, capture, first replay, to a synchronize), its
    prefill rows and their shapes; and with ``margins`` its decode calls'
    top-2 logit margins per slot and the slots active in each), and drops
    the engines themselves. ``eager``: the engines skip their decode
    capture and run every prefill and decode body eagerly on the card, the
    harness's yardstick for the graphs (the engine itself never falls back
    to eager steps on the card)."""
    from repro_torch.serving.engine import TorchEngine

    made, real = [], (TorchEngine.__init__, TorchEngine._capture, TorchEngine.decode,
                      TorchEngine.prefill, TorchEngine._capture_prefill)
    out = []

    def init(self, *a, **kw):
        self.decodes, self.capture_s = [], []
        real[0](self, *a, **kw)
        made.append(self)

    def capture_prefill(self, n):
        t0 = time.perf_counter()
        real[4](self, n)
        torch.cuda.synchronize()
        self.capture_s.append(time.perf_counter() - t0)

    def decode(self):
        logits = real[2](self)
        if margins:
            top = logits[:, :self.cfg.vocab_size].float().topk(2, -1).values
            self.decodes.append((top[:, 0] - top[:, 1],
                                 {s.rid: i for i, s in enumerate(self.slots) if s is not None}))
        return logits

    TorchEngine.__init__, TorchEngine.decode = init, decode
    TorchEngine._capture_prefill = capture_prefill
    if eager:
        TorchEngine._capture, TorchEngine.prefill = (lambda self: None), _eager_prefill
    try:
        yield out
    finally:
        (TorchEngine.__init__, TorchEngine._capture, TorchEngine.decode, TorchEngine.prefill,
         TorchEngine._capture_prefill) = real
        for e in made:
            shapes = [n for k, n, _ in e.iteration_log if k == "prefill"]
            out.append({"arch": e.cfg.name, "graph": e.graph is not None, "replays": e.replays,
                        "decode_rows": sum(k == "decode" for k, _, _ in e.iteration_log),
                        "prefill_graphs": sorted(e.prefill_graphs),
                        "prefill_replays": e.prefill_replays, "capture_s": e.capture_s,
                        "prefill_rows": len(shapes), "prefill_shapes": sorted(set(shapes)),
                        "decodes": [(m.cpu(), act) for m, act in e.decodes]})
        made.clear()


def _token_diffs(what, got, want, got_decodes, want_decodes):
    """Prints whether two runs' tokens ({rid: tokens}) are equal, and for
    each request whose tokens differ, the first decode step that differs
    (the request's own step, and the engine's decode call in each run) and
    the top-2 logit margin of that slot there in both runs. Returns
    whether they were equal."""
    def at(decodes, rid, j):       # the decode call that made token j (j >= 1) of rid
        calls = [(n, m[act[rid]]) for n, (m, act) in enumerate(decodes) if rid in act]
        return calls[j - 1]

    differ = []
    for rid in sorted(want):
        j = next((j for j, (a, b) in enumerate(zip(got[rid], want[rid])) if a != b), None)
        if j is None and len(got[rid]) == len(want[rid]):
            continue
        if j is None or j == 0:
            differ.append(f"rid {rid}: {'length' if j is None else 'prefill token'} differs")
            continue
        (ng, mg), (nw, mw) = at(got_decodes, rid, j), at(want_decodes, rid, j)
        differ.append(f"rid {rid} token {j} ({got[rid][j]} vs {want[rid][j]}): decode call "
                      f"{ng} vs {nw}, top-2 margin {float(mg):.4g} vs {float(mw):.4g}")
    n = sum(map(len, want.values()))
    print(f"[serve] {what}: tokens {'equal' if not differ else 'DIFFER'} ({n} tokens of "
          f"{len(want)} requests; {len(got_decodes)} vs {len(want_decodes)} decode calls)"
          + "".join(f"\n[serve]   {d}" for d in differ))
    return not differ


def _same_schedule(cfg, reqs):
    """``reqs`` ({rid: (prompt, max_new)}) all submitted before the first
    step to an engine that captures its decode step and its prefills and to
    one that runs both eagerly, on serve()'s params (seed 0), each drained: one schedule in
    both, where serve()'s admissions follow the clock (and granite's expert
    capacity, hence its tokens, depends on which slots are busy). Prints
    and returns whether every token is equal."""
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import TorchEngine

    params = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0), cfg)
    out = {}
    for mode in ("captured", "eager"):
        with _engines(eager=mode == "eager", margins=True) as engines:
            eng = TorchEngine(cfg, params, max_batch=8, max_len=SERVE_MAX_LEN)
            for rid, (prompt, max_new) in sorted(reqs.items()):
                eng.submit(rid, prompt, max_new)
            out[mode] = {rid: list(r.out_tokens) for rid, r in eng.drain().items()}
            del eng
        (e,) = engines
        captured = mode == "captured"
        assert e["graph"] == captured and \
            e["prefill_graphs"] == (e["prefill_shapes"] if captured else []), e
        out[mode + " decodes"] = e["decodes"]
    del params
    torch.cuda.empty_cache()
    return _token_diffs(f"{cfg.name}, the burst's requests on one schedule, captured vs eager",
                        out["captured"], out["eager"], out["captured decodes"],
                        out["eager decodes"])


def phase_serve(arch, profile_run=False):
    """Serve ``arch`` at full width through repro_torch.launch.serve, with
    Poisson arrivals at 5/s and with all requests at once. Each engine
    captures its decode step as one CUDA graph and every decode step is a
    replay: an engine calls decode_step once to warm up (checked for its
    launches) and once under capture (checked for what it records, and
    that it launches nothing), the replays are counted and equal the
    engine's decode rows, and the captured isfinite of _Counted holds every
    replay's logits. Each prefill shape is captured at its first admission
    (one warm-up prefill, checked for its launches, and one under capture,
    checked for what it records) and every later admission of it is a
    replay: captures + prefill replays = admissions. With ``profile_run``,
    one torch.profiler window (device activity) over the whole poisson5
    run, the last of the four, counts the kernels' device launches by
    symbol, which must be the wrappers' launches (the warm-ups) plus the
    decode replays x the per-step count plus the prefill graphs' runs
    (captures and replays) x the per-prefill count. The burst and poisson5
    traces run once more with both captures skipped (eager prefill and
    decode steps, each checked), for the eager tok/s, TTFT and TPOT; the
    burst's requests are drained on one schedule by a captured and an
    eager engine (_same_schedule), whose tokens are compared."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.api import get_model

    cfg = get_config(arch)
    model = get_model(cfg)      # the family's module, which the engine calls
    per_step, per_prefill = (_per_call_launches(cfg)[k] for k in ("decode", "prefill"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _Counted(model) as warm, _engines():
        # warm-up: first-call costs (cuBLAS handles, allocator) out of the numbers
        serve(cfg, n_requests=2, rate=1e3, max_len=SERVE_MAX_LEN, seed=1, device="cuda")
    assert bool(warm.finite), f"{arch} warm-up: non-finite logits"
    runs = {}
    # the profiled poisson5 run last: the other runs' tok/s, TTFT and TPOT
    # are taken before it, with no profiler's events alive in the process
    for label, rate, eager in (("burst", 1e6, False), ("burst_eager", 1e6, True),
                               ("poisson5_eager", 5.0, True), ("poisson5", 5.0, False)):
        profiled = profile_run and label == "poisson5"
        window = profile(activities=[ProfilerActivity.CUDA]) if profiled \
            else contextlib.nullcontext()
        with _Counted(model) as counted, _engines(eager) as engines, window as prof:
            if profiled:
                _window_prelude()
            finished, summary = serve(cfg, n_requests=16, rate=rate, max_batch=8,
                                      max_len=SERVE_MAX_LEN, seed=0, device="cuda")
            torch.cuda.synchronize()
            if profiled:
                time.sleep(WINDOW_TAIL_S)
            t_run = time.perf_counter()
        t_exit = time.perf_counter() - t_run
        launches, captured = counted.launches(), counted.captured()
        calls = {k: counted.calls.get((cfg.name, k), 0)
                 for k in ("prefill", "decode") + CAPTURES}
        (eng,) = engines
        graphs = eng["prefill_graphs"]
        assert len(finished) == 16, f"{label}: {len(finished)} of 16 requests finished"
        assert bool(counted.finite), f"{arch} {label}: non-finite logits"
        assert eng["prefill_rows"] == 16 and eng["decode_rows"] > 0, eng
        if eager:
            assert not eng["graph"] and eng["replays"] == 0 and not graphs and \
                eng["prefill_replays"] == 0 and calls["decode_capture"] == 0 and \
                calls["prefill_capture"] == 0 and calls["prefill"] == 16 and \
                calls["decode"] == eng["decode_rows"], (calls, eng)
        else:
            assert eng["graph"] and calls["decode"] == calls["decode_capture"] == 1 and \
                eng["replays"] == eng["decode_rows"], f"{arch} {label}: {calls}, {eng}"
            assert graphs == eng["prefill_shapes"] and \
                calls["prefill"] == calls["prefill_capture"] == len(graphs) and \
                len(graphs) + eng["prefill_replays"] == 16, f"{arch} {label}: {calls}, {eng}"
        want = counted.expected([cfg])
        assert launches == want, f"{arch} {label}: launches {launches}, want {want}"
        want = counted.expected([cfg], CAPTURES)
        assert captured == want, f"{arch} {label}: captured {captured}, want {want}"
        cap_s = eng["capture_s"]
        print(f"[serve] {arch} {label}: rate {rate}/s, " + (
            f"{calls['prefill']} eager prefills, {calls['decode']} eager decode steps" if eager
            else f"{len(graphs)} prefill graphs captured (shapes {graphs}; {sum(cap_s):.2f}s in "
                 f"all, warm-up and first replay included) and {eng['prefill_replays']} "
                 f"replayed, {eng['replays']} decode graph replays (decode_step called once to "
                 f"warm up, once under capture)") + f", kernels launched by their wrappers "
              f"{json.dumps(launches)}" + ("" if eager else
                                          f", recorded by the captures {json.dumps(captured)}"))
        print(f"[serve] {arch} {label}: {json.dumps(summary)}")
        runs[label] = {"launches": launches, "captured": captured, "summary": summary,
                       "replays": eng["replays"], "prefill_graphs": graphs,
                       "prefill_replays": eng["prefill_replays"], "capture_s": cap_s,
                       "tokens": {rid: list(r.out_tokens) for rid, r in finished.items()},
                       "requests": {rid: (r.prompt, r.max_new) for rid, r in finished.items()}}
        if profiled:
            t0 = time.perf_counter()
            # the window's raw kineto events, counted by name: building the
            # FunctionEvents of prof.events() or key_averages() over the
            # run's ~10^5 kernels takes 25-30 s
            device = _symbol_launches(collections.Counter(
                e.name() for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA))
            prefills = len(graphs) + eng["prefill_replays"]
            want = {op: launches[op] + eng["replays"] * per_step[op] + prefills * per_prefill[op]
                    for op in KERNEL_SYMBOLS}
            assert device == want, f"{arch} {label}: the device launched {device}, want {want}"
            runs[label]["device_launches"] = device
            prof = None
            gc.collect()
            print(f"[serve] {arch} {label}: the kernels' device launches in the run, counted by "
                  f"symbol in one profiler window over it: {json.dumps(device)} = the wrappers' "
                  f"launches + {eng['replays']} decode replays x {json.dumps(per_step)} + "
                  f"{prefills} prefill graph runs ({len(graphs)} first replays after capture, "
                  f"{eng['prefill_replays']} replays) x {json.dumps(per_prefill)} (the window "
                  f"closed in {t_exit:.1f}s, counted in {time.perf_counter() - t0:.1f}s)")
    runs["tokens_equal_eager"] = _same_schedule(cfg, runs["burst"]["requests"])
    runs["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"[serve] {arch}: peak device memory {runs['peak_bytes'] / 1e9:.2f} GB")
    torch.cuda.empty_cache()
    return runs


def phase_multi_llm():
    """The multi-LLM example at full width, bf16, random weights from a seed:
    qwen2-1.5b (28 layers) and glm4-9b (40 layers) on two engines behind the
    round robin, the JAX example's trace (16 requests per model at 4 req/s
    per model). Every request finishes, every logit is finite, each engine
    captured its decode graph and replayed it once per decode row (two
    graphs on one card, replayed in turn on one stream), each engine
    captured one prefill graph per shape it admitted and replayed it at
    every later admission, and each engine's prefill and decode_step calls
    (warm-ups and captures) launch or record flash and decode attention
    once per layer of its model. Returns the summary per model, with each
    engine's prefill captures, their seconds and its prefill replays."""
    from repro_torch.configs.registry import get_config
    from repro_torch.examples.serve_multi_llm import ARCHS, N_REQ, serve_multi_llm
    from repro_torch.models.api import get_model

    cfgs = [get_config(a) for a in ARCHS]
    model = get_model(cfgs[0])
    assert all(get_model(c) is model for c in cfgs)
    with _Counted(model) as warm, _engines():       # warm-up: one request per model
        serve_multi_llm(n_req=1, rate=1e3, smoke=False, device="cuda", seed=1)
    assert bool(warm.finite), "multi-LLM warm-up: non-finite logits"
    torch.cuda.empty_cache()
    with _Counted(model) as counted, _engines() as engines:
        finished, summary = serve_multi_llm(smoke=False, device="cuda")
    assert len(finished) == N_REQ * len(ARCHS), f"{len(finished)} requests finished"
    assert bool(counted.finite), "multi-LLM: non-finite logits"
    assert sorted(e["arch"] for e in engines) == sorted(c.name for c in cfgs), engines
    for c in cfgs:
        (eng,) = [e for e in engines if e["arch"] == c.name]
        graphs = eng["prefill_graphs"]
        assert counted.calls.get((c.name, "decode")) == \
            counted.calls.get((c.name, "decode_capture")) == 1, counted.calls
        assert counted.calls.get((c.name, "prefill")) == \
            counted.calls.get((c.name, "prefill_capture")) == len(graphs), counted.calls
        assert eng["graph"] and eng["replays"] == eng["decode_rows"] > 0, eng
        assert graphs == eng["prefill_shapes"] and \
            len(graphs) + eng["prefill_replays"] == eng["prefill_rows"] == N_REQ, eng
        summary[c.name].update(prefill_graphs=graphs, prefill_replays=eng["prefill_replays"],
                               capture_s=eng["capture_s"])
    launches, want = counted.launches(), counted.expected(cfgs)
    assert launches == want, f"multi-LLM: launches {launches}, want {want}"
    captured, want = counted.captured(), counted.expected(cfgs, CAPTURES)
    assert captured == want, f"multi-LLM: captured {captured}, want {want}"
    print(f"[serve] multi-LLM {' + '.join(ARCHS)} full width: calls "
          f"{json.dumps({f'{m} {k}': n for (m, k), n in sorted(counted.calls.items())})}, "
          f"decode graph replays {json.dumps({e['arch']: e['replays'] for e in engines})}, "
          f"prefill graphs {json.dumps({e['arch']: e['prefill_graphs'] for e in engines})} and "
          f"replays {json.dumps({e['arch']: e['prefill_replays'] for e in engines})}, "
          f"kernels launched by their wrappers {json.dumps(launches)}, recorded by the "
          f"captures {json.dumps(captured)}")
    from repro_torch.obs.percentiles import percentiles
    for i, (arch, s) in enumerate(summary.items()):
        # TPOT as launch.serve counts it: the gaps between a request's tokens
        gaps = [g for rid, r in finished.items() if rid % len(ARCHS) == i
                for g in np.diff(r.token_times)]
        s["tpot_p50_s"], s["tpot_p95_s"] = percentiles(gaps, (0.50, 0.95))
        print(f"[serve] multi-LLM {arch}: {json.dumps(s)}")
    torch.cuda.empty_cache()
    return summary


def _train_launches(cfg):
    """The launches one train step must make: with remat each layer's
    forward runs twice (once in the backward pass), so two flash forwards
    and one flash backward per layer, and for MoE six grouped matmuls (gate,
    up, down, twice) and one dx and one dw for each of the three. The
    hybrid: two SSD scans (the second in the backward pass) and one SSD
    backward per Mamba layer, and one flash forward and backward per
    insertion of the shared block, which is not checkpointed. The xLSTM
    launches none."""
    runs = 2 if cfg.remat else 1
    if cfg.family == "hybrid":
        ni = cfg.n_layers // cfg.attn_every
        return {"flash_attention": ni, "flash_attention_bwd": ni, "decode_attention": 0,
                "grouped_matmul": 0, "grouped_matmul_dx": 0, "grouped_matmul_dw": 0,
                "ssd_scan": runs * cfg.n_layers, "ssd_scan_bwd": cfg.n_layers}
    L = 0 if cfg.family == "ssm" else cfg.n_layers      # attention layers
    gmm = 3 * L if cfg.family == "moe" else 0
    return {"flash_attention": runs * L, "flash_attention_bwd": L, "decode_attention": 0,
            "grouped_matmul": runs * gmm, "grouped_matmul_dx": gmm, "grouped_matmul_dw": gmm,
            "ssd_scan": 0, "ssd_scan_bwd": 0}


def phase_train(arch, profile=True):
    """``arch`` at full width and depth, bf16, trained for TRAIN_STEPS steps
    through repro_torch.launch.train's train_loop (B x S of TRAIN_SHAPES,
    remat on, random weights from its seed, its synthetic data): every loss
    and grad norm is finite, every param gets a gradient on every step
    (grad_sq_min > 0), and every step launches each kernel exactly as
    _train_launches counts. Prints each step's time, tokens/s and the peak
    device memory; the last step runs inside one profiler window. Returns
    the launches of the whole run and the peak of allocated device bytes."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import train_loop
    from repro_torch.models import common as cm

    cfg = get_config(arch)
    B, S = TRAIN_SHAPES[arch]
    ops = _kernel_ops()
    want = _train_launches(cfg)
    seen, times, prof = [], [], {}
    last = {"t": 0.0, "launches": {}}

    def on_step(i, params, opt_state, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - last["t"])
        launches = {n: op.launches for n, op in ops.items()}
        made = {n: launches[n] - last["launches"][n] for n in ops}
        assert made == want, f"{arch} train step {i + 1}: launches {made}, want {want}"
        m = {k: float(v) for k, v in metrics.items() if k in ("loss", "grad_norm", "lr",
                                                                "grad_sq_min")}
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]), f"{arch} step {i + 1}: {m}"
        assert m["grad_sq_min"] > 0, f"{arch} step {i + 1}: a param got no gradient"
        seen.append(m)
        if "window" in prof:
            prof["window"].__exit__(None, None, None)
            prof["wall_ms"] = 1e3 * (now - last["t"])
            prof["close_s"] = time.perf_counter() - now
        if profile and i == TRAIN_STEPS - 2:
            # device activity only: the report reads device events alone, and
            # recording the host's ops too made the xLSTM step's (186,739
            # device ops) take about 100 s to report
            from torch.profiler import ProfilerActivity, profile as torch_profile
            prof["window"] = torch_profile(activities=[ProfilerActivity.CUDA])
            prof["window"].__enter__()
        torch.cuda.synchronize()
        last["t"], last["launches"] = time.perf_counter(), launches

    for op in ops.values():
        op.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    last["t"], last["launches"] = time.perf_counter(), {n: 0 for n in ops}
    params, opt_state, losses = train_loop(cfg, steps_total=TRAIN_STEPS, batch_size=B, seq_len=S,
                                           log_every=TRAIN_STEPS + 1, device="cuda",
                                           on_step=on_step)
    launches = {n: op.launches for n, op in ops.items()}
    peak_bytes = torch.cuda.max_memory_allocated()
    peak = peak_bytes / 1e9
    n_params = sum(t.numel() for t in cm.flatten(params).values())
    assert len(seen) == TRAIN_STEPS and losses == [m["loss"] for m in seen]
    assert launches == {n: TRAIN_STEPS * k for n, k in want.items()}, launches
    steady = statistics.median(times[1:])
    print(f"[train] {arch} full width, {cfg.n_layers} layers, {n_params / 1e9:.3f} B params, "
          f"{cfg.dtype}, remat {cfg.remat}, B={B}, S={S}: {TRAIN_STEPS} AdamW steps, losses "
          f"{[round(m['loss'], 4) for m in seen]}, grad norms "
          f"{[round(m['grad_norm'], 4) for m in seen]}, every param a gradient on every step; "
          f"kernels per step {json.dumps(want)}")
    print(f"[train] {arch} on {_card()}: step times (s) {[round(t, 3) for t in times]} (the "
          f"first with warm-up); steady {steady * 1e3:.1f} ms/step, {B * S / steady:.0f} tokens/s; "
          f"peak device memory {peak:.1f} GB")
    if "window" in prof:
        t0 = time.perf_counter()
        _report_profile(f"train step, {arch} {cfg.dtype}, B={B} S={S}", prof["window"],
                        prof["wall_ms"], 1)
        print(f"[time] 5 train {arch}: the profiler's window closed in {prof['close_s']:.1f}s, "
              f"its report took {time.perf_counter() - t0:.1f}s")
    del params, opt_state
    torch.cuda.empty_cache()
    return launches, peak_bytes


@contextlib.contextmanager
def _split_counts():
    """Records (Smax, splits) of every bf16 decode launch: the host's split
    rule, which the wrapper calls once per launch."""
    from repro_torch.kernels.decode_attention import ops as da_ops

    real, seen = da_ops.split_count, []

    def record(B, KH, Smax, sms):
        seen.append((Smax, real(B, KH, Smax, sms)))
        return seen[-1][1]

    da_ops.split_count = record
    try:
        yield seen
    finally:
        da_ops.split_count = real


def phase_model_api(arch, B, S, steps=16, profile_steps=0):
    """``arch`` at full width, bf16, random weights from a seed, greedy
    through the model API (the engine serves neither Whisper nor the VLM,
    as JaxEngine does not): one prefill of B prompts of S tokens (Whisper:
    over 1500 seeded frames; the VLM: after 256 seeded vision embeddings),
    then ``steps`` decode steps, each checked for its launches and finite
    logits; Whisper's cross decode must run on the split path. Then, if
    asked, one profiler window over ``profile_steps`` further steps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.models.api import get_model

    cfg = get_config(arch)
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, cfg)
    dt = params["ln_f"]["scale"].dtype
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()}
    if cfg.family == "audio":
        batch["frames"] = _randn(gen, B, cfg.enc_seq, cfg.d_model, dtype=dt)
    if cfg.family == "vlm":
        batch["vision_embeds"] = _randn(gen, B, cfg.n_vision_tokens, cfg.d_model, dtype=dt)
    with _Counted(model) as counted, _split_counts() as splits:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, cfg, batch)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        # room in the self-attention cache for every step to come
        pad = torch.zeros(cache["k"].shape[:2] + (steps + profile_steps,) + cache["k"].shape[3:],
                          dtype=cache["k"].dtype, device="cuda")
        cache = dict(cache, k=torch.cat([cache["k"], pad], 2), v=torch.cat([cache["v"], pad], 2))
        tok = logits[:, :cfg.vocab_size].argmax(-1).int()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = model.decode_step(params, cfg, cache, tok)
            tok = logits[:, :cfg.vocab_size].argmax(-1).int()
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
    assert counted.calls == {(cfg.name, "prefill"): 1, (cfg.name, "decode"): steps}, counted.calls
    assert bool(counted.finite), f"{arch}: non-finite logits"
    launches = counted.launches()
    assert launches == counted.expected([cfg]), launches
    assert cache["len"].tolist() == [cache["k"].shape[2] - profile_steps] * B
    by_smax = {}
    for smax, n in splits:
        by_smax.setdefault(smax, set()).add(n)
    split_note = ""
    if cfg.family == "audio":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        want = da_ops.split_count(B, cfg.n_kv_heads, cfg.enc_seq, sms)
        assert by_smax.get(cfg.enc_seq) == {want} and want > 1, by_smax
        assert len(splits) == steps * 2 * cfg.n_layers, len(splits)
        split_note = f", cross decode on {want} splits ({sms} SMs)"
    V = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    what = f"{arch} full width bf16, B={B}, {S}-token prompt" + \
        (f" + {V} vision tokens" if V else "") + \
        (f" over {cfg.enc_seq} frames" if cfg.family == "audio" else "")
    print(f"[serve] {what}: prefill {1e3 * t_prefill:.1f} ms, {steps} decode steps "
          f"{1e3 * t_decode / steps:.1f} ms/step, {B * steps / t_decode:.1f} tok/s; kernels "
          f"{json.dumps(launches)}; decode splits by Smax "
          f"{json.dumps({k: sorted(v) for k, v in sorted(by_smax.items())})}{split_note}")
    if profile_steps:
        state = {"cache": cache, "tok": tok}

        def step():
            lg, state["cache"] = model.decode_step(params, cfg, state["cache"], state["tok"])
            state["tok"] = lg[:, :cfg.vocab_size].argmax(-1).int()

        _profiled(f"decode step, B={B}, {arch} bf16", step, profile_steps)
    del params, cache
    torch.cuda.empty_cache()


KERNEL_FAMILIES = {"grouped matmul": ("gmm_kernel", "gmm_mma_kernel", "gmm_tiled_kernel",
                                      "gemm_fma_kernel"),
                   "attention": ("flash_fwd_kernel", "flash_mma_kernel", "decode_kernel",
                                 "decode_split_kernel"),
                   "attention backward": ("flash_bwd_",),
                   "ssd scan": ("ssd_scan_kernel", "ssd_mma_kernel"),
                   "ssd scan backward": ("ssd_bwd_",)}


# The forward kernels' symbols by the wrapper that launches them: a
# profiler's kernel key is the demangled symbol
KERNEL_SYMBOLS = {"flash_attention": ("flash_fwd_kernel", "flash_mma_kernel"),
                  "decode_attention": ("decode_kernel", "decode_split_kernel"),
                  "grouped_matmul": ("gmm_kernel", "gmm_mma_kernel", "gmm_tiled_kernel"),
                  "ssd_scan": ("ssd_scan_kernel", "ssd_mma_kernel")}
# A window whose device events are counted exactly opens with PRELUDE_KERNELS
# marker kernels (torch.cuda._sleep's spin_kernel), synchronized, which no
# count includes: the trace can lose a window's first few device events
# (chip_profiler_window.py), even after the window sat idle. It
# closes WINDOW_TAIL_S after the last sync: the trace keeps only device
# events that end before its stop on the host's clock, onto which the
# device's timestamps are mapped.
PRELUDE_KERNELS = 64
PRELUDE_SYMBOL = "spin_kernel"
WINDOW_TAIL_S = 0.5


def _window_prelude():
    """The marker kernels that open a counted profiler window."""
    for _ in range(PRELUDE_KERNELS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def _profiled(what, fn, calls):
    """One torch.profiler window over ``calls`` runs of ``fn``, opened by
    _window_prelude and closed WINDOW_TAIL_S after the last sync (both
    outside the wall time): prints the wall time per call, the device's
    busy share, its split into the port's kernel families and the rest, and
    the kernels by device time. Returns _report_profile's numbers."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _window_prelude()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / calls * 1e3
        time.sleep(WINDOW_TAIL_S)
    return _report_profile(what, prof, wall_ms, calls)


def _report_profile(what, prof, wall_ms, calls):
    """Device busy share, its split into kernel families and the top kernels
    of a finished profiler window over ``calls`` calls of ``wall_ms`` each.
    Returns {wall_ms, busy_ms, ops (device ops per call), launches (the
    window's device launches of each KERNEL_SYMBOLS wrapper's kernels)}."""
    kernels = _device_events(prof)
    dev = {e.key: e.self_device_time_total / 1e3 / calls for e in kernels}   # ms per call
    busy = sum(dev.values())
    n_launch = sum(e.count for e in kernels) / calls
    print(f"[profile] {what}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall_ms:.1f}%), {n_launch:.0f} device ops per call")
    assert busy > 0, f"{what}: the profiler saw no device time"
    split = {fam: sum(ms for name, ms in dev.items() if any(k in name for k in keys))
             for fam, keys in KERNEL_FAMILIES.items()}
    split["rest"] = busy - sum(split.values())
    print(f"[profile] {what} device busy split (ms/call): " + ", ".join(
        f"{fam} {ms:.3f} ({100 * ms / busy:.1f}%)" for fam, ms in split.items()))
    for name, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[profile]   {ms:8.3f} ms/call  {name[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "ops": n_launch,
            "launches": _symbol_launches({e.key: e.count for e in kernels})}


def _device_events(prof):
    """A finished profiler window's device events, aggregated by kernel,
    without _window_prelude's markers."""
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and PRELUDE_SYMBOL not in e.key]


def _symbol_launches(counts):
    """The device launches of each KERNEL_SYMBOLS wrapper's kernels, from
    ``counts`` ({kernel name: launches})."""
    import re
    return {op: sum(n for name, n in counts.items()
                    if re.search(r"\b(" + "|".join(syms) + r")\b", name))
            for op, syms in KERNEL_SYMBOLS.items()}


PROFILE_ARCHS = SERVE_ARCHS + HEAD_ARCHS + ("glm4-9b",)
TIMED_STEPS = 10    # engine steps per turn of the eager-against-replay timing


def phase_profile(arch, steps=4):
    """A full-width decode step, eager against captured, with all 8 slots of
    an engine busy (48-token prompts, bf16). (a) Parity: from copies of the
    same cache and tokens, one eager decode_step's logits and one replay's
    agree within the bf16 tolerance. (b) The engine's step timed with its
    graph set aside (the body eagerly) and replayed, in turns (eager,
    replay, replay, eager; TIMED_STEPS steps each): median wall per step.
    (c) One profiler window over ``steps`` eager steps and one over
    ``steps`` replays: wall, device busy share, device ops per step; in the
    replay window, the port's kernels launch by symbol exactly ``steps`` x
    the per-step count. For the hybrid also one prefill of a 63-token
    prompt, where its SSD kernel runs. (d) Prefill (_prefill_graph_rows):
    one replay against one eager prefill_body, bit for bit, and the
    admission's wall eager and replayed per shape. Returns the numbers."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import TorchEngine

    cfg = get_config(arch)
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = TorchEngine(cfg, params, max_batch=8, max_len=SERVE_MAX_LEN)
    assert eng.graph is not None, f"{arch}: the engine did not capture its decode step"
    graph = eng.graph
    rng = np.random.default_rng(0)
    for rid in range(8):
        eng.submit(rid, rng.integers(0, cfg.vocab_size, size=(48,)), 160)
    eng.step()                                   # 8 prefills + 1 decode step
    eng.step()

    # (a) one replay against one eager step from copies of the same state
    eng.tokens.copy_(eng.next_tokens)
    cache = {k: v.clone() for k, v in eng.cache.items()}
    with torch.no_grad():
        want, _ = model.decode_step(params, cfg, cache, eng.tokens.clone())
    got = eng.decode().clone()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    _check(f"{arch} replay vs eager decode_step logits", got.float(), want.float(),
           **TOL[torch.bfloat16])
    same_tok = bool((got[:, :cfg.vocab_size].argmax(-1) == want[:, :cfg.vocab_size].argmax(-1))
                    .all())
    print(f"[graph] {arch}: one replay vs one eager decode_step from copies of the same cache "
          f"and tokens: logits max abs err {err:.3g} (bf16 atol/rtol 2e-2; bit for bit "
          f"{bool(torch.equal(got, want))}), greedy tokens equal {same_tok}")
    del cache, want

    # (b) wall per step, eager and replayed, in turns
    def run(mode, n):
        eng.graph = None if mode == "eager" else graph
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    walls = {"eager": [], "replay": []}
    for mode in ("eager", "replay", "replay", "eager"):
        walls[mode].append(run(mode, TIMED_STEPS))
    wall = {m: statistics.mean(v) for m, v in walls.items()}

    # (c) a profiler window over each
    per_step = _per_call_launches(cfg)["decode"]
    eng.graph = None
    eager = _profiled(f"decode step eager, 8 slots busy, {arch} bf16", eng.step, steps)
    eng.graph = graph
    replays0 = eng.replays
    replay = _profiled(f"decode step replayed, 8 slots busy, {arch} bf16", eng.step, steps)
    assert eng.replays - replays0 == steps and all(s is not None for s in eng.slots)
    want_launches = {op: steps * per_step[op] for op in KERNEL_SYMBOLS}
    assert replay["launches"] == want_launches, \
        f"{arch}: {steps} replays launched {replay['launches']}, want {want_launches}"
    print(f"[graph] {arch} on {_card()}: decode step wall eager {wall['eager']:.2f} ms, "
          f"replayed {wall['replay']:.2f} ms (x{wall['eager'] / wall['replay']:.2f}; turns "
          f"{json.dumps({m: [round(t, 3) for t in v] for m, v in walls.items()})}); device busy "
          f"eager {100 * eager['busy_ms'] / eager['wall_ms']:.1f}% ({eager['ops']:.0f} ops/step),"
          f" replayed {100 * replay['busy_ms'] / replay['wall_ms']:.1f}% ({replay['ops']:.0f} "
          f"ops/step); kernels in {steps} replays {json.dumps(replay['launches'])} = {steps} x "
          f"the per-step count")
    if cfg.family == "hybrid":
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 63)).astype(np.int32)).cuda()
        prefill = lambda: model.prefill(params, cfg, {"tokens": toks})  # noqa: E731
        prefill()
        _profiled(f"prefill of a 63-token prompt, {arch} bf16", prefill, 1)
    pre = _prefill_graph_rows(eng, rng)
    del eng, params, graph
    torch.cuda.empty_cache()
    return {"wall": wall, "eager": eager, "replay": replay, "err": err, "prefill": pre}


PREFILL_TIMED = (16, 32, 64)   # prompt lengths: phase 4's buckets; exact shapes when recurrent
PREFILL_CALLS = 10             # admissions per turn of the eager-against-replay timing


def _prefill_graph_rows(eng, rng):
    """An engine's prefill graphs against its prefill body run eagerly, into
    slot 0 (the decode measurements are done; its request's cache is
    overwritten). (a) A 48-token prompt, whose shape the engine admitted
    and captured: the eager body into a copy of the cache, then one replay
    into the engine's cache; the first token, the logits and the whole
    cache bit for bit equal. (b) Per length of PREFILL_TIMED: the first
    admission of a shape not yet captured (warm-up, capture, first replay:
    the capture's seconds), then the admission's wall (row upload, prefill,
    first token read back), eager and replayed in turns (eager, replay,
    replay, eager; PREFILL_CALLS admissions each): the mean per admission.
    (c) One profiler window over 4 replays of the 64-token shape: wall,
    device busy, ops, and the port's kernels by symbol = 4 x the
    per-prefill count. Returns the numbers."""
    from repro_torch.serving.engine import prefill_body

    cfg = eng.cfg
    vocab = cfg.vocab_size
    n = eng._load_prompt(0, rng.integers(0, vocab, size=(48,)))
    assert n in eng.prefill_graphs, f"{cfg.name}: shape {n} was not captured"
    eng._prefill_in[n].copy_(eng._prefill_host[:3 + n])
    args = list(eng._prefill_args(n))
    cache = {k: v.clone() for k, v in eng.cache.items()}
    first, logits = torch.zeros_like(eng.first_token), torch.zeros_like(eng.prefill_logits)
    args[3], args[8], args[9] = cache, first, logits
    prefill_body(*args)
    replays0 = eng.prefill_replays
    tok = eng._prefill_into(n)
    assert eng.prefill_replays == replays0 + 1
    same = {"first token": tok == int(first),
            "logits": torch.equal(eng.prefill_logits, logits),
            **{f"cache {k}": torch.equal(eng.cache[k], cache[k]) for k in cache}}
    assert all(same.values()), f"{cfg.name}: prefill replay vs eager body: {same}"
    print(f"[prefill] {cfg.name}: one replay of the {n}-token shape vs the eager prefill_body "
          f"of the same prompt into slot 0 of a copy of the cache: first token {tok}, logits "
          f"and every cache entry ({', '.join(cache)}) bit for bit equal")
    del cache

    def turn(mode, m):
        if mode == "eager":
            eng.prefill = lambda k: _eager_prefill(eng, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PREFILL_CALLS):
            eng._prefill_into(m)
        ms = (time.perf_counter() - t0) / PREFILL_CALLS * 1e3
        eng.__dict__.pop("prefill", None)
        return ms

    rows = {}
    for S in PREFILL_TIMED:
        m = eng._load_prompt(0, rng.integers(0, vocab, size=(S,)))
        first_ms = None
        if m not in eng.prefill_graphs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._prefill_into(m)
            first_ms = (time.perf_counter() - t0) * 1e3
        walls = {"eager": [], "replay": []}
        for mode in ("eager", "replay", "replay", "eager"):
            walls[mode].append(turn(mode, m))
        rows[m] = {"eager_ms": statistics.mean(walls["eager"]),
                   "replay_ms": statistics.mean(walls["replay"]), "first_ms": first_ms,
                   "turns": {k: [round(t, 3) for t in v] for k, v in walls.items()}}
    per_prefill = _per_call_launches(cfg)["prefill"]
    prof = _profiled(f"prefill replayed, {m}-token shape, {cfg.name} bf16",
                     lambda: eng._prefill_into(m), 4)
    want = {op: 4 * per_prefill[op] for op in KERNEL_SYMBOLS}
    assert prof["launches"] == want, \
        f"{cfg.name}: 4 prefill replays launched {prof['launches']}, want {want}"
    print(f"[prefill] {cfg.name} on {_card()}: admission wall per shape, eager / replayed (ms, "
          f"mean of {2 * PREFILL_CALLS} each; first use: warm-up, capture and first replay) "
          + "; ".join(f"{m}: {r['eager_ms']:.2f} / {r['replay_ms']:.2f}"
                      + (f" (first {r['first_ms']:.1f})" if r["first_ms"] else "")
                      for m, r in rows.items())
          + f"; 4 replays of the {m}-token shape launched {json.dumps(prof['launches'])}")
    return {"rows": rows, "profile": prof}


def _graph_table(runs, multi, graphs):
    """One line per served model, eager against captured: the decode step's
    wall and the device's busy share and ops per step (phase_profile), and
    tok/s and TPOT p50/p95 of its serving runs (phase_serve; glm4-9b's from
    the multi-LLM driver, whose engines are captured)."""
    card = _card()
    for arch, g in graphs.items():
        row = {"arch": arch, "card": card,
               "wall_ms": {m: round(g["wall"][m], 3) for m in ("eager", "replay")},
               "busy_pct": {m: round(100 * g[m]["busy_ms"] / g[m]["wall_ms"], 1)
                            for m in ("eager", "replay")},
               "ops_per_step": {m: round(g[m]["ops"]) for m in ("eager", "replay")},
               "logits_max_abs_err": g["err"]}
        if arch in runs:
            row["serve"] = {label: {k: runs[arch][label]["summary"][k]
                                    for k in ("tok_per_s", "tpot_p50_s", "tpot_p95_s")}
                            for label in ("poisson5", "burst", "burst_eager")}
            row["tokens_equal_eager_one_schedule"] = runs[arch]["tokens_equal_eager"]
            row["poisson5_under_profiler"] = "device_launches" in runs[arch]["poisson5"]
        elif arch in multi:
            row["serve"] = {"multi_llm": {k: multi[arch][k]
                                          for k in ("tok_per_s", "tpot_p50_s", "tpot_p95_s")}}
        print(f"[graph-table] {json.dumps(row)}")


def _prefill_table(runs, multi, graphs):
    """One line per served model and glm4-9b: the admission's wall per
    prefill shape, eager against replayed, the first use's (warm-up,
    capture, first replay), the replayed prefill's device busy time and ops
    (_prefill_graph_rows); the prefill captures of its captured serving
    runs, their seconds, and TTFT p50/p95 of the captured and eager runs
    (phase_serve; glm4-9b's captured only, from the multi-LLM driver)."""
    card = _card()
    ms = lambda x: None if x is None else round(1e3 * x, 3)  # noqa: E731
    for arch, g in graphs.items():
        pre = g["prefill"]
        prof = pre["profile"]
        row = {"arch": arch, "card": card,
               "wall_ms": {m: {k: round(r[k], 3) for k in ("eager_ms", "replay_ms")}
                           for m, r in pre["rows"].items()},
               "first_use_ms": {m: r["first_ms"] and round(r["first_ms"], 1)
                                for m, r in pre["rows"].items()},
               "replay_profiled": {"wall_ms": round(prof["wall_ms"], 3),
                                   "busy_ms": round(prof["busy_ms"], 3),
                                   "ops": round(prof["ops"])}}
        if arch in runs:
            row["captures"] = {label: {"shapes": runs[arch][label]["prefill_graphs"],
                                       "seconds": round(sum(runs[arch][label]["capture_s"]), 3),
                                       "replays": runs[arch][label]["prefill_replays"]}
                               for label in ("burst", "poisson5")}
            row["ttft_ms"] = {label: {mode: [ms(runs[arch][key]["summary"][f"ttft_p{q}_s"])
                                             for q in (50, 95)]
                                      for mode, key in (("eager", f"{label}_eager"),
                                                        ("captured", label))}
                              for label in ("burst", "poisson5")}
        elif arch in multi:
            m = multi[arch]
            row["captures"] = {"multi_llm": {"shapes": m["prefill_graphs"],
                                             "seconds": round(sum(m["capture_s"]), 3),
                                             "replays": m["prefill_replays"]}}
            row["ttft_ms"] = {"multi_llm": {"captured": [ms(m["ttft_p50_s"]),
                                                         ms(m["ttft_p95_s"])]}}
        print(f"[prefill-table] {json.dumps(row)}")


# ---------------------------------------------------------------- phase 6
MESH_ARCH = "qwen2-1.5b"
# (b): the dry-run of the train phase's steps (bf16, remat) and of
# mistral-nemo-12b's serving decode step (the engine's 8 slots of
# SERVE_MAX_LEN positions), each on a 1x1 mesh
DRYRUN_CARD = {"qwen2-1.5b": ("train",) + TRAIN_SHAPES["qwen2-1.5b"],
               "granite-moe-3b-a800m": ("train",) + TRAIN_SHAPES["granite-moe-3b-a800m"],
               "mistral-nemo-12b": ("decode", 8, SERVE_MAX_LEN)}
# (c): cells of the production meshes
DRYRUN_MESH = (("qwen2-1.5b", "train_4k", False), ("dbrx-132b", "train_4k", True),
               ("zamba2-1.2b", "long_500k", False))
PERSIST_TOL = 0.01     # the dry-run's params + optimizer bytes against the card's
PEAK_UNDER = 0.10      # how far below the card's peak the dry-run's estimate may fall
_DRYRUN = """
import json, sys
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
out, card, cells = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
for arch, (kind, B, S) in card.items():
    shape = InputShape(f"{kind}_b{B}_s{S}", S, B, kind)
    rec = dryrun.run_cell(arch, shape.name, out_dir=out, verbose=False, shape=shape,
                          mesh_shape=((1, 1), ("data", "model")))
    print("[dryrun-record]", json.dumps(rec), flush=True)
for arch, name, multi in cells:
    rec = dryrun.run_cell(arch, name, multi_pod=multi, out_dir=out, verbose=False)
    print("[dryrun-record]", json.dumps(rec), flush=True)
"""


def _dry_run(card, cells, out):
    """Start the dry-run of ``card`` ({arch: (kind, B, S)} on a 1x1 mesh)
    and ``cells`` ((arch, shape, multi_pod) on a production mesh) in a
    child process, which writes its records under ``out``: its fake process
    group of 256 or 512 ranks and this process's NCCL group cannot share a
    process, and it needs no card. ``_dry_run_records`` waits for it."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", _DRYRUN, out, json.dumps(card),
                             json.dumps(cells)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _dry_run_records(proc, n):
    """The ``n`` records a ``_dry_run`` child prints, once it has exited."""
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, f"dry-run child failed:\n{stderr[-4000:]}"
    recs = [json.loads(line.split(" ", 1)[1]) for line in stdout.splitlines()
            if line.startswith("[dryrun-record] ")]
    assert len(recs) == n, stdout[-2000:]
    return recs


def _card_persistent(arch):
    """The bytes the card holds for ``arch``'s params and AdamW state, right
    after init_opt_state (bf16 params, fp32 moments, an int32 step)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import get_model
    from repro_torch.train.optimizer import init_opt_state

    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt_state = init_opt_state(params)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    del params, opt_state
    torch.cuda.empty_cache()
    return held


def _decode_peak(arch, steps=4):
    """The peak of allocated device bytes over ``steps`` engine decode steps
    of ``arch`` at full width, bf16, with every one of the engine's 8 slots
    of SERVE_MAX_LEN positions busy: params, cache and a decode step's
    activations (the peak is reset after the prefills, so neither the
    params' fp32 init nor a prefill is in it)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import TorchEngine

    cfg = get_config(arch)
    params = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = TorchEngine(cfg, params, max_batch=8, max_len=SERVE_MAX_LEN)
    rng = np.random.default_rng(0)
    for rid in range(8):
        eng.submit(rid, rng.integers(0, cfg.vocab_size, size=(48,)), 64)
    eng.step()                                   # 8 prefills + 1 decode step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del eng, params
    torch.cuda.empty_cache()
    return peak


def phase_mesh(runs, train_peaks):
    """The distributed layer and the dry-run against the card.
    (a) A one-rank NCCL group (from an in-process store: no address, no
    network) and make_debug_mesh() on the card: qwen2-1.5b served through
    TorchEngine under use_mesh, phase 4's poisson5 and burst traces, greedy:
    every request's tokens equal phase 4's without a mesh, every call
    launches flash and decode attention as in phase 4 (the burst run, whose
    batching has no clock in it, the same launches in all), and the group is
    torn down. (b) The dry-run of phase 5's qwen2-1.5b and
    granite-moe-3b-a800m steps on a 1x1 mesh: its params and optimizer
    bytes within PERSIST_TOL of what the card holds after init_opt_state,
    its peak estimate not below phase 5's measured peak by more than
    PEAK_UNDER, and its FLOPs per step beside 6 N tokens; mistral-nemo-12b's
    decode cell beside the card's peak over its decode steps (the engine's
    8 slots busy). (c) Three cells of the
    production meshes, each record printed."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import current_mesh, use_mesh
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.serve import serve
    from repro_torch.models.api import get_model

    import tempfile
    out = tempfile.mkdtemp(prefix="dryrun_")
    t0 = time.time()
    # two children, each on its own core, while the card serves (a)
    children = [(_dry_run(DRYRUN_CARD, [], out), len(DRYRUN_CARD)),
                (_dry_run({}, DRYRUN_MESH, out), len(DRYRUN_MESH))]
    cfg = get_config(MESH_ARCH)
    model = get_model(cfg)
    with mesh_mod.process_group(1, "nccl"):
        mesh = mesh_mod.make_debug_mesh()
        assert mesh.device_type == "cuda" and mesh.size() == 1, mesh
        with use_mesh(mesh):
            for label, rate in (("poisson5", 5.0), ("burst", 1e6)):
                with _Counted(model) as counted, _engines() as engines:
                    finished, summary = serve(cfg, n_requests=16, rate=rate, max_batch=8,
                                              max_len=SERVE_MAX_LEN, seed=0, device="cuda")
                launches, want = counted.launches(), counted.expected([cfg])
                before = runs[MESH_ARCH][label]
                got = {rid: list(r.out_tokens) for rid, r in finished.items()}
                (eng,) = engines
                assert bool(counted.finite), f"mesh {label}: non-finite logits"
                assert launches == want, f"mesh {label}: launches {launches}, want {want}"
                assert got == before["tokens"], \
                    f"mesh {label}: tokens differ from phase 4's without a mesh"
                # the plain params are captured under the mesh as without it:
                # decode_step called to warm up and under capture, then
                # replays; each prefill shape warmed up and captured at its
                # first admission, then replayed, phase 4's shapes and counts
                graphs = eng["prefill_graphs"]
                assert eng["graph"] and counted.calls[cfg.name, "decode"] == 1 and \
                    counted.calls[cfg.name, "decode_capture"] == 1 and \
                    eng["replays"] == eng["decode_rows"], (counted.calls, eng)
                assert graphs == before["prefill_graphs"] == eng["prefill_shapes"] and \
                    counted.calls[cfg.name, "prefill"] == \
                    counted.calls[cfg.name, "prefill_capture"] == len(graphs) and \
                    eng["prefill_replays"] == before["prefill_replays"] == 16 - len(graphs), \
                    (counted.calls, eng, before["prefill_graphs"], before["prefill_replays"])
                assert launches == before["launches"], (launches, before["launches"])
                assert counted.captured() == before["captured"], \
                    (counted.captured(), before["captured"])
                if label == "burst":
                    assert eng["replays"] == before["replays"], \
                        f"mesh burst: {eng['replays']} replays, phase 4 {before['replays']}"
                print(f"[mesh] {MESH_ARCH} {label} under a one-rank {mesh.device_type} mesh "
                      f"{mesh}: {sum(map(len, got.values()))} tokens of 16 requests equal phase "
                      f"4's without a mesh; decode graph captured, {eng['replays']} replays "
                      f"(phase 4: {before['replays']}); prefill graphs {graphs} captured and "
                      f"replayed {eng['prefill_replays']} times (as in phase 4); kernels by "
                      f"their wrappers {json.dumps(launches)} (phase 4: "
                      f"{json.dumps(before['launches'])}); {summary['tok_per_s']:.1f} tok/s")
        assert current_mesh() is None
    import torch.distributed as dist
    assert not dist.is_initialized()

    held = {arch: _card_persistent(arch) for arch, (kind, _, _) in DRYRUN_CARD.items()
            if kind == "train"}
    recs = [r for proc, n in children for r in _dry_run_records(proc, n)]
    import shutil
    shutil.rmtree(out, ignore_errors=True)
    print(f"[dryrun] {len(recs)} cells in two child processes, done {time.time() - t0:.1f}s "
          f"after they started")
    card = _card()
    for rec in recs[:len(DRYRUN_CARD)]:
        arch, mem = rec["arch"], rec["memory"]
        assert rec["status"] == "ok" and rec["n_devices"] == 1, rec
        if rec["kind"] == "train":
            est = mem["params"] + mem["optimizer"]
            ratio = est / held[arch]
            assert abs(ratio - 1) <= PERSIST_TOL, \
                f"{arch}: dry-run params + optimizer {est} B, the card holds {held[arch]} B"
            peak = train_peaks[arch]
            assert mem["total"] >= (1 - PEAK_UNDER) * peak, \
                f"{arch}: dry-run peak {mem['total'] / 1e9:.2f} GB under the card's {peak / 1e9:.2f} GB"
            six_nd = 6 * rec["params_active"] * rec["global_batch"] * rec["seq_len"]
            print(f"[dryrun] {arch} train B={rec['global_batch']} S={rec['seq_len']} on 1x1 vs "
                  f"{card}: params + optimizer {est / 1e9:.4f} GB, the card {held[arch] / 1e9:.4f} "
                  f"GB (ratio {ratio:.5f}); peak estimate {mem['total'] / 1e9:.2f} GB (activations "
                  f"{mem['activations'] / 1e9:.2f}), the card's phase-5 peak {peak / 1e9:.2f} GB "
                  f"(ratio {mem['total'] / peak:.3f}); FLOPs per step {rec['flops_per_device']:.4e}, "
                  f"6 N tokens {six_nd:.4e} (ratio {rec['flops_per_device'] / six_nd:.3f})")
        else:
            peak = _decode_peak(arch)
            print(f"[dryrun] {arch} decode B={rec['global_batch']} Smax={rec['seq_len']} on 1x1: "
                  f"estimate {mem['total'] / 1e9:.2f} GB (params {mem['params'] / 1e9:.2f}, cache "
                  f"{mem['cache'] / 1e9:.2f}, activations {mem['activations'] / 1e9:.2f}); the "
                  f"card's peak over 4 decode steps with 8 slots busy on {card} {peak / 1e9:.2f} GB "
                  f"(ratio {mem['total'] / peak:.3f}; its phase-4 serving peak, the params' fp32 "
                  f"init included, {runs[arch]['peak_bytes'] / 1e9:.2f} GB)")
    for rec in recs[len(DRYRUN_CARD):]:
        assert rec["status"] == "ok", rec
        print(f"[dryrun] {json.dumps(rec)}")


CONTROL_DEMAND_X = 20.0                            # demand: 20x each trace's mean
CONTROL_SCARCITY = {"L40S": 0.15, "A10G": 0.3}     # the scarce allocation case


def _control_models():
    from repro_torch.core import modelspec as ms
    from repro_torch.traces.workloads import workload_stats
    models = [ms.PAPER_MODELS[n] for n in ms.CORE_MODELS]
    return models, {m.name: workload_stats(m.trace) for m in models}


def _tset(temps):
    """Everything a template holds, in order (bit-exact comparison)."""
    from dataclasses import astuple
    return [(t.model, t.phase, t.slo_ms, t.counts, astuple(t.placement), t.throughput)
            for t in temps]


def _control_allocations(lib):
    """allocate on ``lib`` for CORE_REGIONS: availability from
    gen_availability (seeded) and a scarce case; demand 20x each trace's
    mean. Returns {case: (Allocation, availability, demands)}."""
    from repro_torch.core import allocator as al, hardware as hw
    from repro_torch.traces.workloads import default_base_availability, gen_availability
    models, wls = _control_models()
    base = default_base_availability(hw.CORE_CONFIGS, abundance=10.0)
    demands = []
    for m in models:
        wl = wls[m.name]
        demands += [al.Demand(m.name, "prefill", CONTROL_DEMAND_X * wl.avg_prompt),
                    al.Demand(m.name, "decode", CONTROL_DEMAND_X * wl.avg_output)]
    out = {}
    for case, scarcity in (("seeded", None), ("scarce", CONTROL_SCARCITY)):
        avail = gen_availability(hw.CORE_REGIONS, hw.CORE_CONFIGS, 1, base, seed=0,
                                 scarcity=scarcity)[0]
        out[case] = (al.allocate(al.AllocProblem(hw.CORE_REGIONS, hw.CORE_CONFIGS, avail,
                                                 demands, lib)), avail, demands)
    return out


def _alloc_summary(a):
    return {"ok": a.ok, "unmet": sorted(a.unmet), "solve_path": a.solve_path,
            "cost": a.cost_per_hour, "objective": a.objective, "n_vars": a.n_vars,
            "instances": sorted(a.instances.items())}


def _control_builds(device):
    """The builds phase 7 compares: the core library and llama3-70b decode
    on EXT_CONFIGS, on ``device``; returns the libraries' template sets,
    the heavy set and each build's seconds and stats."""
    from repro_torch.core import hardware as hw, modelspec as ms, templates as tp
    from repro_torch.traces.workloads import workload_stats
    models, wls = _control_models()
    t0 = time.time()
    lib = tp.build_library(models, hw.CORE_CONFIGS, wls, n_max=6, rho=12.0, device=device)
    lib_s = time.time() - t0
    heavy = ms.PAPER_MODELS["llama3-70b"]
    t0 = time.time()
    temps, stats = tp.generate_templates(heavy, "decode", hw.EXT_CONFIGS,
                                         workload_stats(heavy.trace), n_max=6, device=device)
    return lib, lib_s, temps, stats, time.time() - t0


def _dump(obj, path):
    """Pickle ``obj`` to ``path`` whole or not at all (a reader polls it)."""
    import os
    import pickle
    tmp = f"{path}.part"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def _control_cpu_side(out_path):
    """The CPU half of phases 7 and 8, in a child process: the port's CPU
    builds, allocations and examples (phase 7, pickled to ``out_path``),
    then phase 8's runs on the CPU-built core library (pickled beside it),
    for the parent to compare."""
    import io
    torch.set_num_threads(6)
    lib, lib_s, temps, stats, heavy_s = _control_builds("cpu")
    allocs = {case: _alloc_summary(a) for case, (a, _, _) in _control_allocations(lib).items()}
    from repro_torch.examples import quickstart, templates_for_archs
    with contextlib.redirect_stdout(io.StringIO()):
        _, qs = quickstart.run("cpu")
        archs = templates_for_archs.run("cpu")
    _dump({"lib": {k: _tset(v) for k, v in lib.templates.items()}, "lib_s": lib_s,
           "heavy": _tset(temps), "heavy_s": heavy_s, "heavy_combos": stats["combos"],
           "allocs": allocs, "quickstart": _alloc_summary(qs),
           "archs": {k: _tset(v) for k, v in archs.items()}}, out_path)
    t0 = time.time()
    runs = _loop_runs(lib, "cpu")
    _dump({"runs": runs, "seconds": time.time() - t0}, _loop_path(Path(out_path)))


def _start_control_child():
    """Phases 7 and 8's CPU side: ``chip_smoke.py --control-cpu OUT``."""
    import tempfile
    out = Path(tempfile.mkdtemp(prefix="control_")) / "cpu.pkl"
    return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--control-cpu",
                             str(out)]), out


def _await_pickle(child, path, timeout):
    """The child's pickle at ``path`` once written; fails if the child
    ended without it or the time runs out."""
    import pickle
    t0 = time.time()
    while not path.exists():
        rc = child.poll()
        if rc is not None and not path.exists():
            raise AssertionError(f"the CPU side of phases 7 and 8 failed (exit {rc})")
        assert time.time() - t0 < timeout, f"no {path.name} from the CPU side in {timeout}s"
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def _stop(child):
    if child.poll() is None:
        child.kill()
    child.wait()


def _check_allocation(what, a, want, avail, demands):
    """Phase 7's allocation checks: the CPU-built library's result
    (``want``, a summary) and the reference's feasibility check."""
    got = _alloc_summary(a)
    for k in ("ok", "unmet", "solve_path", "n_vars"):
        assert got[k] == want[k], (what, k, got[k], want[k])
    assert abs(got["cost"] - want["cost"]) <= 1e-9 * abs(want["cost"]), (what, got, want)
    assert abs(got["objective"] - want["objective"]) <= 5e-4 * abs(want["objective"]), what
    used = {}
    for (region, key), n in a.instances.items():
        for c, k in a.templates[key].counts:
            used[(region, c)] = used.get((region, c), 0) + k * n
    assert all(v <= avail.get(k, 0) for k, v in used.items()), (what, used)
    for d in demands:
        served = a.served(d.model, d.phase)
        assert served + a.unmet.get((d.model, d.phase), 0.0) >= d.tokens_per_s - 1e-3, what
    return got["instances"] == want["instances"]


def phase_control_plane(child, out):
    """7. The two-stage optimiser on the card against its CPU run; returns
    the card-built core library (phase 8 runs on it). ``child``/``out``:
    the CPU side's process and pickle (``_start_control_child``), which
    goes on to phase 8's CPU runs."""
    import io
    from repro_torch.core import hardware as hw, modelspec as ms, placement as pl
    from repro_torch.core import profiles as pr, templates as tp
    from repro_torch.examples import quickstart, templates_for_archs
    from repro_torch.traces.workloads import workload_stats
    card = _card()
    # (1) profile rows: card vs CPU, bit for bit
    t0 = time.time()
    n = 0
    for m in ms.PAPER_MODELS.values():
        wl = workload_stats(m.trace)
        for phase in ("prefill", "decode"):
            slo = m.prefill_slo_ms if phase == "prefill" else m.decode_slo_ms
            on_card = pr.ProfileTable(m, phase, slo, wl, device="cuda")
            on_cpu = pr.ProfileTable(m, phase, slo, wl, device="cpu")
            for c in hw.EXT_CONFIGS:
                for S in range(1, 9):
                    got = on_card.table(c, S)
                    assert got.device.type == "cuda" and got.dtype == torch.float64
                    assert torch.equal(got.cpu(), on_cpu.table(c, S)), (m.name, phase, c.name, S)
                    n += 1
    print(f"[control] profile rows: {n} rows (6 models x 20 configs x 2 phases x S 1..8), "
          f"card == CPU bit for bit, {time.time() - t0:.2f}s [{card}]", flush=True)
    # (2), (3) the core library and the heavy pair on the card
    torch.cuda.synchronize()
    lib, lib_s, temps, stats, heavy_s = _control_builds("cuda")
    for key, st in lib.stats.items():
        cols = lib.columns(*key)
        assert cols.usage.device.type == "cuda" and cols.throughput.device.type == "cuda"
        print(f"[control] core library {key[0]} {key[1]}: {st['combos']} combos -> "
              f"{st['templates']} templates, device {st['device_seconds']:.3f}s, "
              f"host {st['host_seconds']:.3f}s [{card}]")
    # the placement cache's rows on the card: one pair again, through
    # a cache made here
    m0 = ms.PAPER_MODELS[ms.CORE_MODELS[0]]
    wl0 = workload_stats(m0.trace)
    pt0 = pr.ProfileTable(m0, "decode", m0.decode_slo_ms, wl0, device="cuda")
    by_name = {c.name: c for c in hw.CORE_CONFIGS}
    cache = pl.PlacementCache(lambda nm, S: pt0.table(by_name[nm], S), m0.n_layers,
                              device="cuda")
    again, _ = tp.generate_templates(m0, "decode", hw.CORE_CONFIGS, wl0, cache=cache)
    assert cache._rows and all(r.device.type == "cuda" for r in cache._rows.values())
    assert _tset(again) == _tset(lib.get(m0.name, "decode"))
    print(f"[control] core library on the card: {lib.size} templates in {lib_s:.2f}s "
          f"[{card}]")
    print(f"[control] llama3-70b decode on EXT_CONFIGS (n_max=6): {stats['combos']} combos "
          f"-> {len(temps)} templates in {heavy_s:.2f}s: device "
          f"{stats['device_seconds']:.3f}s, host (Placement and ServingTemplate objects) "
          f"{stats['host_seconds']:.3f}s [{card}]", flush=True)
    # (4) allocations on the card-built library
    card_allocs = _control_allocations(lib)
    # (5) the examples on the card
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        _, qs = quickstart.run("cuda")
        archs = templates_for_archs.run("cuda")
    print("[control] quickstart on the card:\n" + "\n".join(
        "[control]   " + line for line in buf.getvalue().splitlines()))
    cpu = _await_pickle(child, out, 900)
    assert {k: _tset(v) for k, v in lib.templates.items()} == cpu["lib"]
    assert lib.size == 28074, lib.size
    assert _tset(temps) == cpu["heavy"] and stats["combos"] == cpu["heavy_combos"]
    print(f"[control] core library card == CPU bit for bit ({lib.size} templates; CPU "
          f"{cpu['lib_s']:.2f}s); llama3-70b decode card == CPU ({len(temps)} templates; "
          f"CPU {cpu['heavy_s']:.2f}s, 6 threads)")
    for case, (a, avail, demands) in card_allocs.items():
        same = _check_allocation(case, a, cpu["allocs"][case], avail, demands)
        print(f"[control] allocate {case}: ok={a.ok} cost ${a.cost_per_hour:.4f}/h "
              f"objective {a.objective:.6f} path={a.solve_path} vars={a.n_vars} "
              f"unmet={sorted(a.unmet) or 'none'} instances equal to CPU's: {same}; "
              f"seconds: device {a.device_seconds:.4f}, assembly "
              f"{a.build_seconds - a.device_seconds:.4f}, solver ({a.solve_path}) "
              f"{a.solver_seconds:.4f}, extract {a.extract_seconds:.4f}, total "
              f"{a.solve_seconds:.4f} [{card}]")
    got = _alloc_summary(qs)
    for k in ("ok", "unmet", "solve_path", "n_vars", "instances"):
        assert got[k] == cpu["quickstart"][k], ("quickstart", k)
    assert abs(got["cost"] - cpu["quickstart"]["cost"]) <= 1e-9 * abs(got["cost"])
    assert {k: _tset(v) for k, v in archs.items()} == cpu["archs"]
    print(f"[control] examples on the card equal their CPU runs: quickstart cost "
          f"${qs.cost_per_hour:.4f}/h ({qs.solve_path}), templates_for_archs "
          f"{sum(len(v) for v in archs.values())} templates over {len(archs)} (arch, phase)")
    return lib


# ---------------------------------------------------------------- phase 8
LOOP_EPOCHS, FAULT_EPOCHS, LOOP_EPOCH_S, LOOP_RATE, LOOP_SEED = 10, 12, 240.0, 2.0, 2
# (c): batched=False beside batched; the batched/oracle contract covers runs
# on truth demands (a closed loop's estimator reads queue snapshots, which
# the batched loop holds differently by design)
ORACLE_RUNS = (("flash_crowd", "truth"), ("crash_storm", "fault"))
# wall-clock fields: the only numbers allowed to differ between two runs
LOOP_WALL = ("solve_seconds", "solve_ms", "assembly_ms", "extract_ms")
TRACE_WALL = ("solve_ms", "assembly_ms", "extract_ms", "total_ms")


def _loop_path(out):
    return out.with_name("loop.pkl")


class _RecordedAllocator:
    """``AllocatorState`` that keeps each solve's allocation beside the
    epoch it ran in (``rt``, set after the runtime is built, gives it)."""

    def __init__(self):
        from repro_torch.core.allocator import AllocatorState
        self.state, self.rt, self.calls = AllocatorState(), None, []

    def set_incumbent(self, counts):
        self.state.set_incumbent(counts)

    def __call__(self, prob):
        a = self.state(prob)
        self.calls.append((self.rt._epoch_idx, a))
        return a


@contextlib.contextmanager
def _layer_clock(acc):
    """Adds to ``acc["sim"]`` the wall seconds of the event loop
    (``Simulator.run_until``, with the runtime's callbacks that its events
    run), to ``acc["solve"]`` those of the allocator's calls and to
    ``acc["queries"]`` those of the observables' queries (goodput,
    throughput, arrival windows, SLO windows: the tensors on the run's
    device and the syncs that read them back). Each second counts once, in
    the innermost clocked call: a mid-epoch re-solve inside ``run_until``
    counts as a solve, the sanitizer's arrival windows there as queries."""
    from repro_torch.obs import reqlog as rl
    from repro_torch.simulator import sim as sm
    saved = [(c, n, c.__dict__[n], layer) for c, n, layer in (
        (sm.Simulator, "run_until", "sim"), (_RecordedAllocator, "__call__", "solve"),
        (sm.Simulator, "goodput", "queries"),
        (sm.Simulator, "throughput", "queries"), (sm._ObsLog, "window", "queries"),
        (rl.SLOReport, "window", "queries"))]
    inner = []                  # the seconds of nested clocked calls, per level

    def clocked(fn, layer):
        def run(*args, **kwargs):
            inner.append(0.0)
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t
                acc[layer] += dt - inner.pop()
                if inner:
                    inner[-1] += dt
        return run

    for c, n, fn, layer in saved:
        setattr(c, n, clocked(fn, layer))
    try:
        yield acc
    finally:
        for c, n, fn, _ in saved:
            setattr(c, n, fn)


def _loop_digest(res, epoch_s, sim=None, trace=None):
    """Everything a run produces except wall-clock fields: epoch metrics,
    aggregates, the SLO report over the run and its per-epoch series, the
    request log's records and token totals; with the run's simulator also
    the finished requests, drops and arrival totals, and with its trace the
    records. The example returns its ``RunResult`` alone: ``sim=None``."""
    from dataclasses import asdict
    rep = res.slo_report
    T = len(res.epochs) * epoch_s
    out = {"epochs": [{k: v for k, v in asdict(e).items() if k not in LOOP_WALL}
                      for e in res.epochs],
           "aggregates": (res.avg_cost(), res.n_resolves(), res.total_failed(),
                          res.total_restarted(), res.total_shed(), res.recovery_epochs(),
                          res.solve_path_counts(), res.total_mid_resolves()),
           "slo": rep.window(0.0, T),
           "trace": None if trace is None else
           [{k: v for k, v in r.items() if k not in TRACE_WALL} for r in trace.records]}
    for m in rep.reqlog.models:
        tok = rep.tokens[m]
        out[m] = {"series": rep.series(m, epoch_s, 0.0, T), "tokens": len(tok),
                  "count": (tok.count(0.0, T), tok.count(0.0, T, True)),
                  "first": rep.reqlog.first_records(m),
                  "terminal": rep.reqlog.terminal_records(m)}
        if sim is not None:
            out[m]["arrivals"] = sim.obs[m].arrival.window(0.0, T)
    if sim is not None:
        out["finished"] = sorted((r.rid, r.model, r.finish, r.prefill_done, r.decode_slo_ok,
                                  r.decode_tokens_ok) for r in sim.finished)
        out["counts"] = (sim.dropped, sim.shed, dict(sim.dropped_by_model),
                         dict(sim.shed_by_model))
    return out


def _first_diff(a, b, path=""):
    """The first path at which two digests differ (None when equal)."""
    if isinstance(a, dict) and isinstance(b, dict):
        if sorted(a, key=repr) != sorted(b, key=repr):
            return f"{path} keys"
        return next((d for k in sorted(a, key=repr)
                     for d in [_first_diff(a[k], b[k], f"{path}/{k}")] if d), None)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return f"{path} length {len(a)} != {len(b)}"
        return next((d for i, (x, y) in enumerate(zip(a, b))
                     for d in [_first_diff(x, y, f"{path}[{i}]")] if d), None)
    return None if a == b else f"{path}: {a!r} != {b!r}"


def _one_loop(lib, name, kind, batched=True):
    """One run of phase 8 on ``lib``'s device: ``closed`` (the closed loop
    as examples/adaptive_cluster.py wires it), ``fault`` (truth demands, a
    FaultInjector and the hardened runtime: health probe, restart backoff,
    load shedding) or ``truth`` (truth demands alone). Returns its digest,
    its allocations by epoch and its seconds split by layer."""
    from repro_torch import control as ctl
    from repro_torch.core import hardware as hw, modelspec as ms
    from repro_torch.obs.trace import TraceLog
    from repro_torch.runtime.cluster import ClusterRuntime
    from repro_torch.simulator.sim import ShedPolicy
    models, wls = _control_models()
    models = {m.name: m for m in models}
    sc = ctl.make_scenario(name, models, hw.CORE_REGIONS, hw.CORE_CONFIGS, wls,
                           n_epochs=FAULT_EPOCHS if kind == "fault" else LOOP_EPOCHS,
                           epoch_s=LOOP_EPOCH_S, base_rate=LOOP_RATE, seed=LOOP_SEED)
    alloc, trace = _RecordedAllocator(), TraceLog()
    kw = dict(health_check_s=15.0, shed_policy=ShedPolicy(32.0),
              restart_policy=ctl.RestartPolicy(backoff_base_s=20.0, backoff_mult=2.0,
                                               backoff_max_s=300.0, budget_per_epoch=4)) \
        if kind == "fault" else {}
    rt = ClusterRuntime(models, hw.CORE_REGIONS, hw.CORE_CONFIGS, lib, alloc, wls,
                        epoch_s=sc.epoch_s, spot_market=sc.spot_market, sim_batched=batched,
                        trace=trace, **kw)
    alloc.rt = rt
    acc = {"sim": 0.0, "solve": 0.0, "queries": 0.0}
    t0 = time.perf_counter()
    with _layer_clock(acc):
        if kind == "closed":
            res = rt.run(sc.requests, sc.availability,
                         estimator=ctl.DemandEstimator(list(models), wls),
                         controller=ctl.ReSolveController(),
                         planner=ctl.TransitionPlanner(lib, hw.CORE_REGIONS, rt.init_k))
        elif kind == "fault":
            res = rt.run(sc.requests, sc.availability, sc.truth_demands,
                         fault_injector=ctl.FaultInjector(sc.faults))
        else:
            res = rt.run(sc.requests, sc.availability, sc.truth_demands)
    wall = time.perf_counter() - t0
    digest = _loop_digest(res, rt.epoch_s, rt.sim, trace)
    calls = [a for _, a in alloc.calls]
    parts = (sum(a.device_seconds for a in calls),
             sum(a.build_seconds - a.device_seconds for a in calls),
             sum(a.solver_seconds for a in calls), sum(a.extract_seconds for a in calls))
    return {"digest": digest,
            "allocs": [(e, a.ok, a.fallback, a.solve_path, sorted(a.instances.items()))
                       for e, a in alloc.calls],
            "n_requests": len(sc.requests),
            "seconds": {"wall": wall, "parts": parts, **acc,
                        "rest": wall - sum(acc.values())}}


def _loop_runs(lib, device):
    """Phase 8's runs that the card and the CPU child both make: the five
    closed-loop scenarios, the four fault scenarios and the example."""
    import io
    from repro_torch.control import FAULT_SCENARIO_NAMES, SCENARIO_NAMES
    from repro_torch.examples import adaptive_cluster
    assert str(lib.device).startswith(device), (lib.device, device)
    runs = {("closed", n): _one_loop(lib, n, "closed") for n in SCENARIO_NAMES}
    runs.update({("fault", n): _one_loop(lib, n, "fault") for n in FAULT_SCENARIO_NAMES})
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        res = adaptive_cluster.run(device)
    runs["example"] = {"run": _loop_digest(res, LOOP_EPOCH_S),
                       "text": [line[:29] + line[37:] for line in buf.getvalue().splitlines()]}
    return runs


def phase_closed_loop(lib, child, out, device="cuda"):
    """8. The closed loop on the card over the core library phase 7 built
    there, against the same runs on the CPU-built library in the child."""
    import os
    card = _card()
    t_all = time.time()
    card_runs = _loop_runs(lib, device)
    # (c) batched=False beside batched, on the card
    for name, kind in ORACLE_RUNS:
        batched = card_runs.get((kind, name)) or _one_loop(lib, name, kind)
        oracle = _one_loop(lib, name, kind, batched=False)
        diff = _first_diff(oracle["digest"], batched["digest"])
        assert diff is None, f"{name} ({kind}) batched=False differs from batched: {diff}"
        print(f"[loop] {name} ({'truth demands' if kind == 'truth' else 'faults'}) "
              f"batched=False == batched bit for bit on the card: oracle "
              f"{oracle['seconds']['wall']:.2f}s vs batched {batched['seconds']['wall']:.2f}s "
              f"[{card}]", flush=True)
    # (d) the sanitizer on the card
    was = os.environ.get("CORAL_SANITIZE")
    os.environ["CORAL_SANITIZE"] = "1"
    try:
        san = _one_loop(lib, "spot_preemption", "closed")
    finally:
        if was is None:
            del os.environ["CORAL_SANITIZE"]
        else:
            os.environ["CORAL_SANITIZE"] = was
    diff = _first_diff(san["digest"], card_runs[("closed", "spot_preemption")]["digest"])
    assert diff is None, f"spot_preemption under CORAL_SANITIZE=1 differs: {diff}"
    print(f"[loop] spot_preemption under CORAL_SANITIZE=1 on the card: no violation, same "
          f"run, {san['seconds']['wall']:.2f}s [{card}]", flush=True)
    cpu = _await_pickle(child, _loop_path(out), 900)
    assert child.wait(timeout=60) == 0, "the CPU side of phases 7 and 8 failed"
    # (a), (b) card == CPU bit for bit, epoch by epoch; equal allocations, no fallback
    for key, r in card_runs.items():
        if key == "example":
            continue
        want = cpu["runs"][key]
        for (e, ok, fb, path, inst), (e2, ok2, fb2, path2, inst2) in zip(r["allocs"],
                                                                        want["allocs"]):
            assert not fb and not fb2 and ok and ok2, \
                f"{key} epoch {e}: a fallback or failed solve (card {fb}/{ok}, CPU {fb2}/{ok2})"
            assert (e, path, inst) == (e2, path2, inst2), \
                f"{key} epoch {e}: the card's allocation differs from the CPU's"
        assert len(r["allocs"]) == len(want["allocs"]), key
        diff = _first_diff(r["digest"], want["digest"])
        assert diff is None, f"{key}: card != CPU at {diff}"
        dg, sec = r["digest"], r["seconds"]
        slo = dg["slo"]
        print(f"[loop] {key[0]} {key[1]}: card == CPU bit for bit ({len(dg['epochs'])} epochs, "
              f"{len(r['allocs'])} solves, equal allocations, no fallback); "
              f"{r['n_requests']} requests, {dg['aggregates'][1]} re-solves, mean "
              f"${dg['aggregates'][0]:.4f}/h [{card}]")
        for m in slo:
            gp = sum(e["goodput"][m] for e in dg["epochs"]) / len(dg["epochs"])
            s = slo[m]
            print(f"[loop]   {m}: goodput {gp:.2f} tok/s, TTFT p95 {s['ttft_p95']:.4f}s "
                  f"attain {s['ttft_attain']:.4f}, TBT p95 {s['tbt_p95']:.5f}s attain "
                  f"{s['tbt_attain']:.4f}")
        dev_s, asm_s, hs_s, ext_s = sec["parts"]
        print(f"[loop]   seconds: {sec['wall']:.2f} wall = event loop (host: run_until, "
              f"with the runtime's callbacks in it) "
              f"{sec['sim']:.2f} + solves {sec['solve']:.2f} (device {dev_s:.3f}, assembly "
              f"{asm_s:.3f}, solver {hs_s:.3f}, extract {ext_s:.3f}) + observable queries "
              f"(device) {sec['queries']:.3f} + the rest on the host (estimator, controller, "
              f"planner, reconcile, trace) {sec['rest']:.3f}; CPU child "
              f"{want['seconds']['wall']:.2f}", flush=True)
    # (e) the example
    ex, want = card_runs["example"], cpu["runs"]["example"]
    diff = _first_diff(ex, want)
    assert diff is None, f"adaptive_cluster on the card != its CPU run at {diff}"
    print(f"[loop] examples/adaptive_cluster on the card == its CPU run "
          f"({len(ex['run']['epochs'])} epochs) [{card}]")
    print(f"[loop] phase 8: card side {time.time() - t_all:.1f}s, CPU child's runs "
          f"{cpu['seconds']:.1f}s [{card}]")


@contextlib.contextmanager
def _timed(what):
    """Prints the wall time of the phase run inside the ``with``."""
    t0 = time.time()
    yield
    print(f"[time] {what}: {time.time() - t0:.1f}s", flush=True)


def main():
    if sys.argv[1:2] == ["--control-cpu"]:
        sys.path.insert(0, str(ROOT / "src"))
        _control_cpu_side(sys.argv[2])
        return
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; nothing was run")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: src/repro_torch is missing; run from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    with _timed("1 device and build"):
        phase_device()
    with _timed("2 kernels"):
        kernels = phase_kernels()
    for arch in PARITY_ARCHS:
        with _timed(f"3 parity {arch}"):
            phase_parity(arch)
    with _timed(f"3 parity {XLSTM}"):
        phase_parity_xlstm()
    for arch in ATTENTION_TRAIN_ARCHS:
        with _timed(f"3 train parity {arch}"):
            phase_train_parity(arch)
    # fp64: in fp32 a token whose denominator lies within rounding of its
    # clamp can take the other side of the kink (PERF.md section 6)
    with _timed(f"3 train parity {XLSTM}"):
        phase_train_parity(XLSTM, n_layers=XLSTM_PARITY_LAYERS, S=512, dtype="float64")
    with _timed(f"3 train parity {SSD_ARCH}"):
        phase_train_parity(SSD_ARCH, n_layers=SSD_PARITY_LAYERS, S=SSD_PARITY_S)
    runs, graphs = {}, {}
    for arch in SERVE_ARCHS + HEAD_ARCHS:
        with _timed(f"4 serve {arch}"):
            runs[arch] = phase_serve(arch, profile_run=arch in (MAIN_ARCH, SSD_ARCH))
    with _timed("4 multi-LLM and model API"):
        multi = phase_multi_llm()
        phase_model_api("whisper-base", B=8, S=16, profile_steps=4)
        phase_model_api("qwen2-vl-2b", B=2, S=32)
    with _timed("4 profiles"):
        for arch in PROFILE_ARCHS:
            graphs[arch] = phase_profile(arch)
    _graph_table(runs, multi, graphs)
    _prefill_table(runs, multi, graphs)
    trained, train_peaks = {}, {}
    for arch in TRAIN_SHAPES:
        with _timed(f"5 train {arch}"):
            trained[arch], train_peaks[arch] = phase_train(arch)
    with _timed("6 mesh and dry-run"):
        phase_mesh(runs, train_peaks)
    child, out = _start_control_child()
    try:
        with _timed("7 control plane"):
            core_lib = phase_control_plane(child, out)
        with _timed("8 closed loop"):
            phase_closed_loop(core_lib, child, out)
    finally:
        _stop(child)
    # each kernel's launches on its path's run: the forward kernels on the
    # poisson5 serving run (granite's runs attention and the grouped matmul,
    # zamba2's the SSD scan), counted on the device by symbol in a profiler
    # window over the run (the prefill and decode graphs' replays included);
    # the backward ones on granite's train run, the SSD scan's backward on
    # zamba2's, counted by their wrappers. wrapper_launches: the wrappers'
    # own counts in the same run (the warm-ups, no replay); captured: the
    # calls the graphs' captures recorded. Each path's counts per prefill,
    # decode step and train step were checked in phases 4 and 5.
    for r in kernels:
        if r["name"] in ("flash_attention_bwd", "grouped_matmul_dx", "grouped_matmul_dw"):
            arch, r["launches"] = MAIN_ARCH, trained[MAIN_ARCH][r["name"]]
            r["wrapper_launches"], r["captured"] = r["launches"], 0
        elif r["name"] == "ssd_scan_bwd":
            arch, r["launches"] = SSD_ARCH, trained[SSD_ARCH][r["name"]]
            r["wrapper_launches"], r["captured"] = r["launches"], 0
        else:
            arch = SSD_ARCH if r["name"] == "ssd_scan" else MAIN_ARCH
            run = runs[arch]["poisson5"]
            r["launches"] = run["device_launches"][r["name"]]
            r["wrapper_launches"] = run["launches"][r["name"]]
            r["captured"] = run["captured"][r["name"]]
        assert r["launches"] > 0, f"{r['name']} was never launched on {arch}'s path"
    print(f"[done] all phases passed in {time.time() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
