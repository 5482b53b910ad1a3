"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517].

24 recurrent layers: mLSTM (matrix memory, up-projection 2x) with an sLSTM
block at every 6th position (4 sLSTM blocks total). d_ff=0 per the assigned
spec: blocks carry their own up-projections, there is no separate FFN.
Fully recurrent => O(1) decode state.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304,
        slstm_every=6, mlstm_expand=2.0, rope="none",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="xlstm-smoke", n_layers=6, d_model=64, n_heads=2, n_kv_heads=2,
        vocab_size=512, slstm_every=3, dtype="float32",
    )
