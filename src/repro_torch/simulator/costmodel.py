"""Stage-granularity cost model for the event simulator (paper §5.2:
"the simulator's cost model is fitted from offline profiling data; the
simulator advances execution at the granularity of individual pipeline
stages on each engine node").

``InstanceCostModel`` turns a Serving Template's placement into
per-stage iteration-time functions using the same roofline terms as
repro.core.profiles — so the allocator's predictions and the simulator's
measurements share one calibrated model, and deviations between them
come only from queueing/batching dynamics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.core import profiles as prof
from repro_torch.core.hardware import (INTER_NODE_GBPS, INTER_NODE_LATENCY_S,
                                 NodeConfig)
from repro_torch.core.modelspec import ServedModel
from repro_torch.core.placement import Placement
from repro_torch.core.profiles import WorkloadStats

KV_TRANSFER_GBPS = 2.5       # prefill->decode KV over CPU RDMA (GLOO)
KV_TRANSFER_LAT = 0.010


@dataclass
class StageModel:
    j: int                      # layers held
    fixed: float                # per-iteration fixed seconds (alpha + weights)
    per_token: float            # marginal seconds per token (aggregated DP)
    capacity_seqs: float        # resident sequences the stage can hold
    # exact decode-iteration model (per DP node): (node, eff_bw, eff_fl,
    # fixed_wo_weights, share) — shares split the batch by node speed
    nodes: tuple = ()


class InstanceCostModel:
    def __init__(self, model: ServedModel, phase: str, placement: Placement,
                 config_by_name: Dict[str, NodeConfig], wl: WorkloadStats):
        self.model = model
        self.phase = phase
        self.wl = wl
        self.placement = placement
        self.slo_s = (model.prefill_slo_ms if phase == "prefill"
                      else model.decode_slo_ms) / 1e3
        self.stages: List[StageModel] = []
        ctx = wl.avg_ctx_decode
        for j, names in zip(placement.layer_counts, placement.stage_nodes):
            fixed = 0.0
            inv_rate = 0.0
            cap = 0.0
            node_terms = []
            for nm in names:
                node = config_by_name[nm]
                eff_bw = node.bw_tbps * 1e12 * prof.BW_EFF
                w_bytes = model.bytes_for_layers(j)
                if phase == "prefill":
                    eff_fl = node.tflops * 1e12 * node.tp_efficiency() \
                        * prof.MFU_PREFILL
                    f_tok = model.flops_per_token_layer(
                        wl.avg_prompt / 2, "prefill") * j
                    fx = prof.ALPHA_PREFILL + w_bytes / eff_bw \
                        + INTER_NODE_LATENCY_S
                    pt = f_tok / eff_fl + model.d_model * model.dtype_bytes \
                        / (INTER_NODE_GBPS * 1e9)
                    cap += prof.MAX_PREFILL_CHUNK
                else:
                    eff_fl = node.tflops * 1e12 * node.tp_efficiency() \
                        * prof.MFU_DECODE
                    f_tok = model.flops_per_token_layer(ctx, "decode") * j
                    fx = prof.ALPHA_DECODE + INTER_NODE_LATENCY_S \
                        + model.decode_read_bytes(j, 0.0, ctx) / eff_bw
                    pt = (model.decode_read_bytes(j, 1.0, ctx)
                          - model.decode_read_bytes(j, 0.0, ctx)) / eff_bw \
                        + f_tok / eff_fl + model.d_model * model.dtype_bytes \
                        / (INTER_NODE_GBPS * 1e9)
                    mem = node.mem_gb * 1e9 * prof.MEM_HEADROOM
                    kv_seq = model.kv_bytes_per_seq(j, wl.max_ctx) if not \
                        model.recurrent else j * 64 * model.d_model * 4
                    cap += max((mem - w_bytes) / max(kv_seq, 1.0), 0.0)
                    node_terms.append((j, eff_bw, eff_fl,
                                       f_tok, 1.0 / pt))
                fixed = max(fixed, fx)
                inv_rate += 1.0 / pt
            shares = tuple((jj, bw, fl, ft, inv / inv_rate)
                           for jj, bw, fl, ft, inv in node_terms)
            self.stages.append(StageModel(j, fixed, 1.0 / inv_rate, cap,
                                          shares))

    # ------------------------------------------------------------- prefill
    def prefill_iter_time(self, tokens: int) -> float:
        """Bottleneck-stage time for one chunked-prefill iteration."""
        return max(s.fixed + tokens * s.per_token for s in self.stages)

    def prefill_pipeline_latency(self, tokens: int) -> float:
        return sum(s.fixed + tokens * s.per_token for s in self.stages)

    @property
    def prefill_chunk(self) -> int:
        """SLO-aware chunked-prefill admission budget (the C* the template
        generator assumed): largest chunk whose pipeline traversal meets
        the prefill SLO."""
        if hasattr(self, "_pchunk"):
            return self._pchunk
        fixed = sum(s.fixed for s in self.stages)
        pt = sum(s.per_token for s in self.stages)
        if fixed >= self.slo_s:
            self._pchunk = max(int(self.wl.avg_prompt), 1)
        else:
            c = int((self.slo_s - fixed) / max(pt, 1e-12))
            self._pchunk = max(min(c, prof.MAX_PREFILL_CHUNK), 1)
        return self._pchunk

    # -------------------------------------------------------------- decode
    def _decode_stage_time(self, s: StageModel, batch: int) -> float:
        """Exact per-stage decode iteration time: the nonlinear
        decode_read_bytes (MoE expert reads saturate once every expert is
        activated) evaluated per DP node at its share of the batch."""
        if not s.nodes or self.phase != "decode":
            return s.fixed + batch * s.per_token
        ctx = self.wl.avg_ctx_decode
        t = 0.0
        for j, eff_bw, eff_fl, f_tok, share in s.nodes:
            b = batch * share
            tn = (prof.ALPHA_DECODE + INTER_NODE_LATENCY_S
                  + self.model.decode_read_bytes(j, b, ctx) / eff_bw
                  + b * f_tok / eff_fl
                  + b * self.model.d_model * self.model.dtype_bytes
                  / (INTER_NODE_GBPS * 1e9))
            t = max(t, tn)
        return t

    def decode_iter_time(self, batch: int) -> float:
        return max(self._decode_stage_time(s, batch) for s in self.stages)

    def decode_pipeline_latency(self, batch: int) -> float:
        return sum(self._decode_stage_time(s, batch) for s in self.stages)

    def decode_times(self, batch: int) -> Tuple[float, float]:
        """Batched-loop API: (iteration time, pipeline latency) from a
        single per-stage sweep — the same floats ``decode_iter_time`` /
        ``decode_pipeline_latency`` produce, computed once instead of
        twice per scheduled iteration."""
        ts = [self._decode_stage_time(s, batch) for s in self.stages]
        return max(ts), sum(ts)

    @property
    def decode_capacity(self) -> int:
        """Resident-batch cap: KV memory AND SLO-aware admission — the
        largest batch whose inter-token (pipeline) latency meets the SLO."""
        if hasattr(self, "_dcap"):
            return self._dcap
        b_mem = max(int(min(s.capacity_seqs for s in self.stages)), 1)
        if self.decode_pipeline_latency(1) > self.slo_s:
            self._dcap = 1
            return 1
        lo, hi = 1, b_mem
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.decode_pipeline_latency(mid) <= self.slo_s:
                lo = mid
            else:
                hi = mid - 1
        self._dcap = lo
        return lo

    # ------------------------------------------------------------ transfer
    def kv_transfer_time(self, prompt_tokens: int) -> float:
        bytes_ = prompt_tokens * self.model.kv_bytes_per_token_layer() \
            * self.model.n_layers
        if self.model.recurrent:
            bytes_ = self.model.n_layers * 64 * self.model.d_model * 4
        return KV_TRANSFER_LAT + bytes_ / (KV_TRANSFER_GBPS * 1e9)
