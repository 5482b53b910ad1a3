"""--arch <id> registry, with the ids of ``repro`` in its order: every arch
of the reference is ported."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import SHAPE_BY_NAME, SHAPES, ModelConfig, cell_is_runnable

_ARCH_MODULES: Dict[str, str] = {
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "whisper-base": "repro_torch.configs.whisper_base",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1p5b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def all_cells():
    """Yield (arch_id, shape, runnable, skip_reason) for all 40 cells."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, why = cell_is_runnable(cfg, shape)
            yield arch, shape, ok, why


__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "all_cells",
           "SHAPES", "SHAPE_BY_NAME"]
