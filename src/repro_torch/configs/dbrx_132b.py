"""dbrx-132b — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352. About 264 GB in
bf16: it does not fit one 80 GB card, so the port runs it at smoke size.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=10752, vocab_size=100352,
        n_experts=16, top_k=4, rope="rope",
        weight_sharding="fsdp", kv_seq_shard=True,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="dbrx-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=512, n_experts=4, top_k=2, dtype="float32",
        weight_sharding="tp",
    )
