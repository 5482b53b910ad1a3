"""Unified model API: family dispatch, and the dry-run's spec trees.

Every family module exposes init, forward, prefill, decode_step,
init_cache, param_shapes, param_specs and cache_specs. ``input_specs(cfg,
shape)`` gives the shape and dtype of every input of the step of one
dry-run cell (``ShapeDtype`` records, nothing allocated) with its spec
tree, keyed flat as the params are.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed.sharding import P
from repro_torch.models import common as cm
from repro_torch.models import hybrid, transformer, whisper, xlstm


_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "audio": whisper, "hybrid": hybrid, "ssm": xlstm}


class ShapeDtype(NamedTuple):
    """The shape and dtype of a tensor that is never allocated."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def get_model(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise NotImplementedError(f"unknown family {cfg.family!r}; known: {sorted(_FAMILY)}")
    return _FAMILY[cfg.family]


def param_specs(cfg: ModelConfig) -> Dict[str, P]:
    """Flat param key -> spec (the keys of ``param_shapes``)."""
    return get_model(cfg).param_specs(cfg)


def param_records(cfg: ModelConfig) -> Dict[str, ShapeDtype]:
    """Flat param key -> (shape, dtype), as ``init`` makes them."""
    model = get_model(cfg)
    dtype = cm.compute_dtype(cfg)
    return {k: ShapeDtype(tuple(s), model.param_dtype(k, dtype))
            for k, s in model.param_shapes(cfg).items()}


def batch_specs(cfg: ModelConfig, shape: InputShape,
                with_labels: bool) -> Tuple[Dict, Dict]:
    """(records, specs) of a forward or prefill batch."""
    B, S = shape.global_batch, shape.seq_len
    dt = cm.compute_dtype(cfg)
    dp = ("pod", "data")
    batch = {"tokens": ShapeDtype((B, S), torch.int32)}
    specs = {"tokens": P(dp, None)}
    if cfg.family == "audio":
        batch["frames"] = ShapeDtype((B, cfg.enc_seq, cfg.d_model), dt)
        specs["frames"] = P(dp, None, None)
    if cfg.family == "vlm":
        batch["vision_embeds"] = ShapeDtype((B, cfg.n_vision_tokens, cfg.d_model), dt)
        specs["vision_embeds"] = P(dp, None, None)
    if with_labels:
        batch["labels"] = ShapeDtype((B, S), torch.int32)
        specs["labels"] = P(dp, None)
    return batch, specs


def decode_specs(cfg: ModelConfig, shape: InputShape) -> Tuple[Dict, Dict]:
    """(records, specs) of one decode step: a cache of ``seq_len``
    positions for ``global_batch`` slots, and one new token per slot."""
    B, S = shape.global_batch, shape.seq_len
    model = get_model(cfg)
    cache = model.init_cache(cfg, B, S, cm.compute_dtype(cfg), device="meta")
    inputs = {"cache": {k: ShapeDtype(tuple(t.shape), t.dtype) for k, t in cache.items()},
              "tokens": ShapeDtype((B,), torch.int32)}
    return inputs, {"cache": model.cache_specs(cfg), "tokens": P(("pod", "data"))}


def input_specs(cfg: ModelConfig, shape: InputShape):
    """Dispatch per shape kind (train/prefill/decode)."""
    if shape.kind == "train":
        return batch_specs(cfg, shape, with_labels=True)
    if shape.kind == "prefill":
        return batch_specs(cfg, shape, with_labels=False)
    return decode_specs(cfg, shape)
