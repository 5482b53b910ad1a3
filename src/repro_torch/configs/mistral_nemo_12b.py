"""mistral-nemo-12b — dense, 128k context [hf:mistralai/Mistral-Nemo-Base-2407].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072. head_dim=128
(explicit: the real model decouples head_dim from d_model/n_heads).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=131072, head_dim=128,
        rope="rope", rope_theta=1e6, weight_sharding="fsdp",
        kv_seq_shard=True,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="nemo-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16, dtype="float32",
        weight_sharding="tp",
    )
