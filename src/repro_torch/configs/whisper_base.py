"""whisper-base — encoder-decoder audio transformer [arXiv:2212.04356].

6 encoder + 6 decoder layers, d_model=512, 8 heads, d_ff=2048,
vocab=51865. The conv audio frontend is a stub, as in the JAX package:
the model takes precomputed frame embeddings (batch, 1500, d_model).
The decoder has causal self-attention and cross-attention into the
encoder output.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio",
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=2048, vocab_size=51865,
        is_encoder_decoder=True, n_enc_layers=6, enc_seq=1500, kv_seq_shard=True,
        rope="sinusoidal", qkv_bias=True,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="whisper-smoke", n_layers=2, n_enc_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512, enc_seq=32,
        dtype="float32",
    )
