"""T̂_j(g): max throughput of node g holding j consecutive layers under a
per-stage latency budget (paper §4.2, "obtained from a one-time offline
profiling run").

An analytical roofline cost model over the node profiles of
``repro_torch.core.hardware`` (compute term, HBM term, capacity limit,
pipeline-network term, iteration overhead), as in the reference. The
interface — a table of T̂_j(g) per (model, phase, per-stage budget) — is
the reference's; its rows are float64 tensors on the table's device.

Rows equal the reference's to the last bit, on the CPU and on the card:
every row is a sweep of elementwise float64 operations in the reference's
order (IEEE-exact on both devices), with two rules. A tensor is never
divided by a Python number (``exact_div``): CUDA's ``div`` multiplies by
the divisor's reciprocal when the divisor is a host scalar, which can
move the last bit. And a Python number is never divided by a tensor:
``float / tensor`` is ``reciprocal() * float`` in PyTorch on every device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.core.hardware import (INTER_NODE_GBPS, INTER_NODE_LATENCY_S,
                                       NodeConfig)
from repro_torch.core.modelspec import ServedModel
from repro_torch.kernels.common import resolve_device

# calibration constants (the "profiling fit")
MFU_PREFILL = 0.55          # achievable fraction of peak FLOPs in prefill
MFU_DECODE = 0.35           # gemm efficiency at small batch
BW_EFF = 0.80               # achievable fraction of HBM bandwidth
ALPHA_PREFILL = 3e-3        # per-iteration overhead (s)
ALPHA_DECODE = 1.2e-3
MEM_HEADROOM = 0.90         # fraction of HBM usable for weights+KV
MAX_PREFILL_CHUNK = 16384   # engine cap on tokens per prefill iteration


@dataclass(frozen=True)
class WorkloadStats:
    """Average request shape (from the trace class; repro_torch.traces)."""
    avg_prompt: float
    avg_output: float

    @property
    def avg_ctx_decode(self) -> float:
        return self.avg_prompt + self.avg_output / 2.0

    @property
    def max_ctx(self) -> float:
        return self.avg_prompt * 2.0 + self.avg_output * 2.0


def exact_div(a, b):
    """``a / b`` correctly rounded on every device, for tensors and Python
    numbers in any mix (see the module docstring): a Python number on
    either side becomes a 0-dim tensor on the other's device first."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(float(b), dtype=torch.float64, device=a.device)
    elif not isinstance(a, torch.Tensor):
        a = torch.tensor(float(a), dtype=torch.float64, device=b.device)
    return torch.div(a, b)


def prefill_throughput(model: ServedModel, node: NodeConfig, j: int,
                       budget_s: float, wl: WorkloadStats) -> float:
    """Tokens/s of prefill for a stage of j layers on ``node``."""
    w_bytes = model.bytes_for_layers(j)
    mem = node.mem_gb * 1e9 * MEM_HEADROOM
    if w_bytes > mem:
        return 0.0
    eff_flops = node.tflops * 1e12 * node.tp_efficiency() * MFU_PREFILL
    eff_bw = node.bw_tbps * 1e12 * BW_EFF
    f_tok = model.flops_per_token_layer(wl.avg_prompt / 2, "prefill") * j
    net_tok = model.d_model * model.dtype_bytes / (INTER_NODE_GBPS * 1e9)
    fixed = ALPHA_PREFILL + w_bytes / eff_bw + INTER_NODE_LATENCY_S
    per_tok = f_tok / eff_flops + net_tok
    # the average prompt must fit one iteration within the stage budget
    if fixed + wl.avg_prompt * per_tok > budget_s:
        return 0.0
    chunk = min((budget_s - fixed) / per_tok, MAX_PREFILL_CHUNK)
    t = fixed + chunk * per_tok
    return chunk / t


def decode_throughput(model: ServedModel, node: NodeConfig, j: int,
                      budget_s: float, wl: WorkloadStats) -> float:
    """Tokens/s of decode for a stage of j layers on ``node``."""
    w_bytes = model.bytes_for_layers(j)
    mem = node.mem_gb * 1e9 * MEM_HEADROOM
    if w_bytes > mem:
        return 0.0
    eff_flops = node.tflops * 1e12 * node.tp_efficiency() * MFU_DECODE
    eff_bw = node.bw_tbps * 1e12 * BW_EFF
    ctx = wl.avg_ctx_decode
    if model.recurrent:
        kv_seq = j * 64 * model.d_model * 4     # SSM state, ctx-independent
    else:
        kv_seq = model.kv_bytes_per_seq(j, wl.max_ctx)
    b_mem = (mem - w_bytes) / max(kv_seq, 1.0)
    if b_mem < 1:
        return 0.0

    f_tok = model.flops_per_token_layer(ctx, "decode") * j
    net_tok = model.d_model * model.dtype_bytes / (INTER_NODE_GBPS * 1e9)

    def iter_time(b: float) -> float:
        return (ALPHA_DECODE + INTER_NODE_LATENCY_S
                + model.decode_read_bytes(j, b, ctx) / eff_bw
                + b * f_tok / eff_flops + b * net_tok)

    if iter_time(1.0) > budget_s:
        return 0.0
    # largest batch meeting the budget (iter_time is affine+monotone in b)
    lo, hi = 1.0, float(b_mem)
    if iter_time(hi) <= budget_s:
        b = hi
    else:
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            if iter_time(mid) <= budget_s:
                lo = mid
            else:
                hi = mid
        b = lo
    return b / iter_time(b)


def _layers(model: ServedModel, device) -> torch.Tensor:
    return torch.arange(1, model.n_layers + 1, dtype=torch.float64,
                        device=device)


def prefill_throughput_row(model: ServedModel, node: NodeConfig,
                           budget_s: float, wl: WorkloadStats,
                           device) -> torch.Tensor:
    """``prefill_throughput`` over j = 1..n_layers as one tensor sweep,
    operation for operation the scalar function's (so equal to it bit for
    bit: the scalar function reads ``int(j * per * bytes)``, a floor of a
    positive float, and compares that integer with ``mem`` exactly as a
    float64 does below 2^53)."""
    j = _layers(model, device)
    per = model.params_layer_total + model.embed_params / model.n_layers
    w_bytes = torch.floor(j * per * model.dtype_bytes)    # int() truncation
    mem = node.mem_gb * 1e9 * MEM_HEADROOM
    eff_flops = node.tflops * 1e12 * node.tp_efficiency() * MFU_PREFILL
    eff_bw = node.bw_tbps * 1e12 * BW_EFF
    f_tok = model.flops_per_token_layer(wl.avg_prompt / 2, "prefill") * j
    net_tok = model.d_model * model.dtype_bytes / (INTER_NODE_GBPS * 1e9)
    fixed = ALPHA_PREFILL + exact_div(w_bytes, eff_bw) + INTER_NODE_LATENCY_S
    per_tok = exact_div(f_tok, eff_flops) + net_tok
    feasible = (w_bytes <= mem) & (fixed + wl.avg_prompt * per_tok <= budget_s)
    chunk = torch.clamp_max(exact_div(budget_s - fixed, per_tok),
                            float(MAX_PREFILL_CHUNK))
    t = fixed + chunk * per_tok
    return torch.where(feasible, exact_div(chunk, t), 0.0)


def decode_throughput_row(model: ServedModel, node: NodeConfig,
                          budget_s: float, wl: WorkloadStats,
                          device) -> torch.Tensor:
    """Vectorized ``decode_throughput`` over j = 1..n_layers.

    One tensor sweep replaces n_layers scalar calls (each with a 40-step
    batch bisection). Every operation mirrors the scalar function in the
    same order, the 40-step bisection included, so rows are bit-identical
    to the scalar sweep and to the reference's numpy row.
    """
    L = model.n_layers
    j = _layers(model, device)
    per = model.params_layer_total + model.embed_params / model.n_layers
    w_bytes = torch.floor(j * per * model.dtype_bytes)    # int() truncation
    mem = node.mem_gb * 1e9 * MEM_HEADROOM
    eff_flops = node.tflops * 1e12 * node.tp_efficiency() * MFU_DECODE
    eff_bw = node.bw_tbps * 1e12 * BW_EFF
    ctx = wl.avg_ctx_decode
    if model.recurrent:
        kv_seq = j * 64 * model.d_model * 4
    else:
        kv_seq = j * model.kv_bytes_per_token_layer() \
            * model._ctx_eff(wl.max_ctx)
    b_mem = exact_div(mem - w_bytes, torch.clamp_min(kv_seq, 1.0))
    f_tok = model.flops_per_token_layer(ctx, "decode") * j
    net_tok = model.d_model * model.dtype_bytes / (INTER_NODE_GBPS * 1e9)
    kv_read = model.kv_read_bytes_layer(ctx)
    if model.n_experts:
        shared = (model.attn_params_layer + 2 * model.d_model
                  + model.embed_params / model.n_layers) * model.dtype_bytes
        expert_all = model.ffn_params_layer_total * model.dtype_bytes
        n_experts = torch.tensor(float(model.n_experts), dtype=torch.float64,
                                 device=device)

        def read_bytes(b):
            frac = torch.clamp_max(exact_div(b * model.top_k, n_experts), 1.0)
            return j * (shared + frac * expert_all) + b * j * kv_read
    else:
        def read_bytes(b):
            return w_bytes + b * j * kv_read

    base = ALPHA_DECODE + INTER_NODE_LATENCY_S
    # the bisection's divisors as 0-dim tensors on the row's device, made
    # once (exact_div would make one per call)
    eff_bw, eff_flops = (torch.tensor(x, dtype=torch.float64, device=device)
                         for x in (eff_bw, eff_flops))

    def iter_time(b):
        return base + exact_div(read_bytes(b), eff_bw) \
            + exact_div(b * f_tok, eff_flops) + b * net_tok

    ones = torch.ones(L, dtype=torch.float64, device=device)
    feasible = (w_bytes <= mem) & (b_mem >= 1.0) \
        & (iter_time(ones) <= budget_s)
    hi = torch.where(b_mem >= 1.0, b_mem, 1.0)
    full = iter_time(hi) <= budget_s
    lo, hw = ones, hi.clone()
    for _ in range(40):
        mid = 0.5 * (lo + hw)
        ok = iter_time(mid) <= budget_s
        lo = torch.where(ok, mid, lo)
        hw = torch.where(ok, hw, mid)
    b = torch.where(full, hi, lo)
    thr = exact_div(b, iter_time(b))
    return torch.where(feasible, thr, 0.0)


def throughput(model: ServedModel, node: NodeConfig, j: int, phase: str,
               budget_s: float, wl: WorkloadStats) -> float:
    fn = prefill_throughput if phase == "prefill" else decode_throughput
    return fn(model, node, j, budget_s, wl)


class ProfileTable:
    """Monotone T̂_j(g) tables per (model, phase, n_stages).

    ``table(node, S)[j-1]`` = T̂_j(node) under per-stage budget slo/S,
    made non-increasing in j (required by the exact placement solver;
    physically, more layers on the same node is never faster). Rows are
    float64 tensors on ``device`` (``cuda`` unless the caller asks for
    another).

    Rows are memoized process-wide, keyed by the frozen value objects
    (model, phase, SLO, workload, node, S) and the device: every table
    instance over the same inputs on one device shares one computed row.
    Callers must treat returned tensors as read-only.
    """

    _shared: Dict = {}

    def __init__(self, model: ServedModel, phase: str, slo_ms: float,
                 wl: WorkloadStats, max_stages: int = 8, device=None):
        self.model = model
        self.phase = phase
        self.slo_s = slo_ms / 1e3
        self.wl = wl
        self.max_stages = max_stages
        self.device = resolve_device(device)

    def table(self, node: NodeConfig, n_stages: int) -> torch.Tensor:
        key = (self.model, self.phase, self.slo_s, self.wl, node, n_stages,
               self.device)
        row = self._shared.get(key)
        if row is None:
            budget = self.slo_s / n_stages
            sweep = (decode_throughput_row if self.phase == "decode"
                     else prefill_throughput_row)
            vals = sweep(self.model, node, budget, self.wl, self.device)
            row = torch.cummin(vals, dim=0).values
            self._shared[key] = row
        return row
