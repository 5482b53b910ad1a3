"""Model configuration for the models the port runs: the decoders it serves
(dense, MoE, hybrid Mamba2 and xLSTM), and Whisper (audio) and Qwen2-VL
(vlm) at the model API.

An own copy of ``ModelConfig``, cut to the fields and properties the
dense, MoE, hybrid, ssm (xLSTM), audio and vlm paths read, in serving and
in training, and the dry-run's input shapes and parameter count.
``weight_sharding`` and ``kv_seq_shard`` choose the spec trees
(``param_specs``, ``cache_specs``), which only a mesh reads;
``vision_stub`` records that the vision tower is a stub (the batch brings
the vision embeddings). ``param_dtype`` is the reference's training field,
unread there as here: both inits build params in ``dtype``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope: str = "rope"               # rope | mrope | none | sinusoidal
    rope_theta: float = 1e6
    sliding_window: int = 0          # 0 -> full attention
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    # "onehot": GShard-style dispatch via one-hot einsums (reference;
    #   O(T·E·cap) memory). "sorted": argsort/scatter dispatch, linear in
    #   tokens.
    moe_impl: str = "onehot"

    # --- SSM / Mamba2 ---
    ssm_state: int = 0               # N (state size per head)
    ssm_head_dim: int = 64           # P (channels per SSM head)
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_conv: int = 4
    attn_every: int = 0              # hybrid: shared attn block after every k SSM layers

    # --- xLSTM ---
    slstm_every: int = 0             # sLSTM block at layers where (i+1) % slstm_every == 0
    mlstm_expand: float = 2.0

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 0                 # encoder positions (whisper-base: 1500)

    # --- VLM ---
    vision_stub: bool = False        # frontend stubbed: input provides patch embeds
    n_vision_tokens: int = 0

    dtype: str = "bfloat16"          # weight and activation dtype
    param_dtype: str = "float32"     # master-weight dtype, unread (see above)
    remat: bool = True               # activation checkpointing of each layer in training
    weight_sharding: str = "tp"      # tp | fsdp (fsdp: "data" on the weights' input dim)
    kv_seq_shard: bool = False       # decode KV: the sequence over "model", not the heads

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def mlstm_d_inner(self) -> int:
        return int(self.mlstm_expand * self.d_model)

    @property
    def is_recurrent(self) -> bool:
        """True if decode state is O(1) in context length (no full KV)."""
        return self.family in ("ssm", "hybrid")

    @property
    def supports_long_context(self) -> bool:
        """sub-quadratic decode => long_500k cell runs."""
        return self.is_recurrent

    # --- parameter counting (the reference's closed form, for the dry-run) ---
    def param_count(self, active_only: bool = False) -> int:
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm", "audio", "moe"):
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d
            if self.family == "moe":
                n_e = self.top_k if active_only else self.n_experts
                ffn = n_e * 3 * d * self.d_ff + d * self.n_experts  # router
            else:
                ffn = 3 * d * self.d_ff
            total = emb + L * (attn + ffn + 2 * d)
            if self.is_encoder_decoder:
                enc = self.n_enc_layers * (attn + 3 * d * self.d_ff + 2 * d)
                cross = L * attn          # cross-attention in decoder
                total += enc + cross
            return total
        if self.family == "hybrid":
            di, N = self.d_inner, self.ssm_state
            H = self.ssm_nheads
            mamba = d * 2 * di + di * self.ssm_conv + di * 2 * N \
                + 2 * H + di + di * d + d * di  # in/out/gate projections approx
            shared_attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d + d * self.d_ff * 3
            n_attn = L // max(self.attn_every, 1) if self.attn_every else 0
            return emb + L * (mamba + 2 * d) + (shared_attn if n_attn else 0)
        if self.family == "ssm":  # xLSTM
            di = self.mlstm_d_inner
            mlstm = d * 2 * di + 3 * di * di // max(self.n_heads, 1) + di * d + 4 * di
            slstm = 4 * d * d + 4 * d
            n_s = L // self.slstm_every if self.slstm_every else 0
            return emb + (L - n_s) * mlstm + n_s * slstm + L * 2 * d
        raise ValueError(self.family)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


# ----------------------------------------------------------------------
# The dry-run's input shapes (the reference's four, identical for every arch).
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4_096, 256, "train"),
    InputShape("prefill_32k", 32_768, 32, "prefill"),
    InputShape("decode_32k", 32_768, 128, "decode"),
    InputShape("long_500k", 524_288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def cell_is_runnable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether an (arch x shape) dry-run cell runs, and why not if skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("skipped: pure full-attention arch — O(seq^2) attention and "
                       f"{shape.seq_len}-token KV are quadratic")
    return True, ""
