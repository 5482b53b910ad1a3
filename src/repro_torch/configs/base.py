"""Model configuration for the models the port runs: the decoders it serves
(dense, MoE, hybrid Mamba2 and xLSTM), and Whisper (audio) and Qwen2-VL
(vlm) at the model API.

An own copy of ``ModelConfig``, cut to the fields and properties the
dense, MoE, hybrid, ssm (xLSTM), audio and vlm paths read, in serving and
in training. ``weight_sharding``, ``kv_seq_shard`` and ``vision_stub`` are
kept so that the per-arch ``config()`` functions stay verbatim copies;
nothing in the port reads the first two until it has a mesh, and the
third records that the vision tower is a stub (the batch brings the
vision embeddings). ``param_dtype`` is the reference's training field,
unread there as here: both inits build params in ``dtype``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


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
    weight_sharding: str = "tp"      # sharding hint, unused without a mesh
    kv_seq_shard: bool = False       # sharding hint, unused without a mesh

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

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)
