"""glm4-9b — dense, RoPE, extreme GQA (kv=2) [hf:THUDM/glm-4-9b]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab_size=151552, rope="rope", qkv_bias=True,
        kv_seq_shard=True,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="glm4-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, dtype="float32",
    )
