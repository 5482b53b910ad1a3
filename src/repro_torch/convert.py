"""Params between numpy trees and the port.

Keys are the ``/``-joined paths that ``repro.train.checkpoint._flatten``
writes (``emb/embed``, ``layers/attn/wq``, ``layers/ln1/scale``,
``ln_f/scale``, ...). The layout is kept as it is -- ``x @ W`` weights and
a leading stacked-layer axis -- so a JAX ``Checkpointer`` npz loads
directly into the port.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models import common as cm
from repro_torch.models.api import get_model


def params_from_numpy(flat: Dict[str, np.ndarray], cfg, device,
                      dtype: torch.dtype | None = None):
    """Flat numpy params -> the port's nested tensor params on ``device``
    (in ``dtype``, default the config's; keys the model keeps in fp32, such
    as the MoE router, stay fp32). Raises on a missing, extra or misshapen
    key."""
    model = get_model(cfg)
    want = model.param_shapes(cfg)
    if set(flat) != set(want):
        raise KeyError(f"param keys differ: missing {sorted(set(want) - set(flat))}, "
                       f"unexpected {sorted(set(flat) - set(want))}")
    dtype = dtype or cm.compute_dtype(cfg)
    out = {}
    for key, shape in want.items():
        a = np.asarray(flat[key])
        if a.shape != shape:
            raise ValueError(f"{key}: shape {a.shape}, expected {shape}")
        # bf16 has no numpy dtype of its own here: go through fp32
        out[key] = torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=model.param_dtype(key, dtype))
    return cm.nest(out)


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """The port's params -> flat fp32 numpy arrays under the same keys."""
    return {k: v.detach().float().cpu().numpy()
            for k, v in cm.flatten(params).items()}
