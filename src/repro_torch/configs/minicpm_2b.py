"""minicpm-2b — dense llama-like [arXiv:2404.06395].

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense",
        n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
        d_ff=5760, vocab_size=122753, rope="rope", tie_embeddings=True,
        kv_seq_shard=True,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="minicpm-smoke", n_layers=2, d_model=72, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, dtype="float32",
    )
