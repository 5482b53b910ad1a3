"""qwen2-1.5b — dense GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab_size=151936, qkv_bias=True, rope="rope",
        tie_embeddings=True, kv_seq_shard=True,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="qwen2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, dtype="float32",
    )
