"""qwen2-vl-2b — VLM backbone with M-RoPE [arXiv:2409.12191].

Backbone only, as in the JAX package: the vision tower is a stub. The
batch supplies precomputed patch embeddings (batch, n_vision_tokens,
d_model), which are put before the token embeddings, and the model gives
them and the text 3-component M-RoPE position ids (temporal, h, w).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab_size=151936, qkv_bias=True, rope="mrope",
        vision_stub=True, n_vision_tokens=256, tie_embeddings=True,
        kv_seq_shard=True,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="qwen2vl-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, n_vision_tokens=8, dtype="float32",
    )
