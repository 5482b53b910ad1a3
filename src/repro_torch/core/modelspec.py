"""Analytic descriptors of the LLMs being served (the cost-model view).

The Coral optimizer needs only per-layer compute / weight / KV figures,
not executable models. ``ServedModel`` provides them for the paper's six
evaluation models (Table 3) and, via ``from_model_config``, for every
architecture in ``repro_torch.configs`` — so the same template
generator runs over both.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ServedModel:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    n_experts: int = 0
    top_k: int = 0
    hybrid_attn: bool = False      # half the layers use sliding-window attn
    sliding_window: int = 4096
    recurrent: bool = False        # SSM-style O(1) decode state
    dtype_bytes: int = 2
    # serving metrics (paper Table 3)
    prefill_slo_ms: float = 1500.0
    decode_slo_ms: float = 80.0
    trace: str = "burstgpt"

    # ---------------- derived quantities ----------------
    @property
    def attn_params_layer(self) -> int:
        d, hd = self.d_model, self.head_dim
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d

    @property
    def ffn_params_layer_total(self) -> int:
        if self.n_experts:
            return self.n_experts * 3 * self.d_model * self.d_ff \
                + self.d_model * self.n_experts
        return 3 * self.d_model * self.d_ff

    @property
    def ffn_params_layer_active(self) -> int:
        if self.n_experts:
            return self.top_k * 3 * self.d_model * self.d_ff
        return 3 * self.d_model * self.d_ff

    @property
    def params_layer_total(self) -> int:
        return self.attn_params_layer + self.ffn_params_layer_total \
            + 2 * self.d_model

    @property
    def params_layer_active(self) -> int:
        return self.attn_params_layer + self.ffn_params_layer_active \
            + 2 * self.d_model

    @property
    def embed_params(self) -> int:
        return 2 * self.vocab * self.d_model

    @property
    def params_total(self) -> int:
        return self.embed_params + self.n_layers * self.params_layer_total

    @property
    def params_active(self) -> int:
        return self.embed_params + self.n_layers * self.params_layer_active

    @property
    def bytes_total(self) -> int:
        return self.params_total * self.dtype_bytes

    def bytes_for_layers(self, j: int) -> int:
        """Weight bytes a stage holding j layers must store (embedding
        amortized uniformly across layers)."""
        per = self.params_layer_total + self.embed_params / self.n_layers
        return int(j * per * self.dtype_bytes)

    def flops_per_token_layer(self, ctx: float, phase: str) -> float:
        """Forward FLOPs per token per layer at average context ``ctx``."""
        base = 2.0 * self.params_layer_active
        ctx_eff = self._ctx_eff(ctx)
        attn = 4.0 * self.n_heads * self.head_dim * ctx_eff
        if phase == "prefill":
            attn *= 0.5        # causal: average over positions
        return base + attn

    def _ctx_eff(self, ctx: float) -> float:
        if self.recurrent:
            return float(self.sliding_window) * 0.1
        if self.hybrid_attn:
            return (ctx + min(ctx, self.sliding_window)) / 2.0
        return ctx

    def kv_bytes_per_token_layer(self) -> float:
        """Bytes appended to the KV cache per token per layer (average
        across layers for hybrid-attention models)."""
        full = 2 * self.n_kv_heads * self.head_dim * self.dtype_bytes
        return full

    def kv_read_bytes_layer(self, ctx: float) -> float:
        """Bytes of KV streamed per generated token per layer."""
        return self.kv_bytes_per_token_layer() * self._ctx_eff(ctx)

    def kv_bytes_per_seq(self, j: int, ctx: float) -> float:
        """Resident KV bytes per sequence for a stage with j layers."""
        return j * self.kv_bytes_per_token_layer() * self._ctx_eff(ctx)

    def decode_read_bytes(self, j: int, batch: float, ctx: float) -> float:
        """Weight+KV bytes streamed per decode iteration (B tokens).

        MoE models with small batches only touch the activated experts.
        """
        w = self.bytes_for_layers(j)
        if self.n_experts:
            shared = (self.attn_params_layer + 2 * self.d_model
                      + self.embed_params / self.n_layers) * self.dtype_bytes
            expert_all = self.ffn_params_layer_total * self.dtype_bytes
            frac = min(1.0, batch * self.top_k / self.n_experts)
            w = j * (shared + frac * expert_all)
        kv = batch * j * self.kv_read_bytes_layer(ctx)
        return w + kv


# ---------------------------------------------------------------- paper set
# Table 3 of the paper; architecture constants from the public model cards.
PAPER_MODELS: Dict[str, ServedModel] = {m.name: m for m in [
    ServedModel("phi4-14b", 40, 5120, 40, 10, 128, 17920, 100352,
                prefill_slo_ms=1200, decode_slo_ms=60, trace="azure_conv"),
    ServedModel("gpt-oss-20b", 24, 2880, 64, 8, 64, 2880, 201088,
                n_experts=32, top_k=4, hybrid_attn=True, sliding_window=128,
                prefill_slo_ms=900, decode_slo_ms=30, trace="azure_code"),
    ServedModel("qwen3-32b", 64, 5120, 64, 8, 128, 25600, 151936,
                prefill_slo_ms=1600, decode_slo_ms=100, trace="burstgpt"),
    ServedModel("llama3-70b", 80, 8192, 64, 8, 128, 28672, 128256,
                prefill_slo_ms=1500, decode_slo_ms=80, trace="burstgpt"),
    ServedModel("gpt-oss-120b", 36, 2880, 64, 8, 64, 2880, 201088,
                n_experts=128, top_k=4, hybrid_attn=True, sliding_window=128,
                prefill_slo_ms=1000, decode_slo_ms=40, trace="azure_conv"),
    ServedModel("qwen3-235b", 94, 4096, 64, 4, 128, 1536, 151936,
                n_experts=128, top_k=8,
                prefill_slo_ms=1800, decode_slo_ms=120, trace="azure_code"),
]}

CORE_MODELS = ["qwen3-32b", "gpt-oss-20b", "phi4-14b"]
EXT_MODELS = CORE_MODELS + ["qwen3-235b", "gpt-oss-120b", "llama3-70b"]


def from_model_config(cfg: ModelConfig, *, prefill_slo_ms=1200.0,
                      decode_slo_ms=60.0, trace="burstgpt") -> ServedModel:
    """Bridge an assigned-architecture config into the serving cost model."""
    return ServedModel(
        name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim,
        d_ff=cfg.d_ff if cfg.d_ff else 2 * cfg.d_model,
        vocab=cfg.vocab_size, n_experts=cfg.n_experts, top_k=cfg.top_k,
        recurrent=cfg.is_recurrent,
        prefill_slo_ms=prefill_slo_ms, decode_slo_ms=decode_slo_ms,
        trace=trace)
