"""Unified model API: family dispatch. Every family module exposes init,
forward, prefill, decode_step and init_cache."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, transformer, whisper, xlstm


_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "audio": whisper, "hybrid": hybrid, "ssm": xlstm}


def get_model(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise NotImplementedError(f"unknown family {cfg.family!r}; known: {sorted(_FAMILY)}")
    return _FAMILY[cfg.family]
