"""zamba2-1.2b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242].

38 Mamba2 layers; a single *shared* full-attention block (one weight set)
is applied after every 6th SSM layer (6 insertion points), following the
Zamba2 shared-block design. ssm_state=64.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32000,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
        attn_every=6, rope="rope", tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="zamba2-smoke", n_layers=7, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, ssm_state=16, ssm_head_dim=16,
        attn_every=3, dtype="float32",
    )
