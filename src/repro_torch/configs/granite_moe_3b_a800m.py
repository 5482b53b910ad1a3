"""granite-moe-3b-a800m — fine-grained MoE [hf:ibm-granite].

Assigned spec: 32L d_model=1536 24H (GQA kv=8) d_ff=512 (per expert)
vocab=49155, MoE 40 experts top-8. NOTE: the source model card lists 32
experts; the assigned shape (40e top-8) is the one implemented.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab_size=49155,
        n_experts=40, top_k=8, rope="rope", kv_seq_shard=True,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="granite-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab_size=512, n_experts=4, top_k=2, dtype="float32",
    )
