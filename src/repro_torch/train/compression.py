"""int8 gradient compression with error feedback, on trees of tensors.

A port of the JAX package's ``train/compression.py``: per-tensor symmetric
scaling to int8, the quantization residual carried in an error-feedback
buffer so that the compression bias vanishes over steps (Seide et al. /
EF-SGD style). The distributed launcher would reduce the int8 grads
between ``compress`` and ``decompress``; ``compressed_roundtrip`` is the
single-process helper.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models import common as cm


def _q(x, ef):
    xf = x.float() + ef
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    err = xf - q.float() * scale
    return q, scale, err


def init_error_feedback(grads):
    return cm.nest({k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                    for k, g in cm.flatten(grads).items()})


def compress(grads, ef) -> Tuple:
    """-> (int8 grads, fp32 scales, new error-feedback residuals)."""
    flat_e = cm.flatten(ef)
    out = {k: _q(g, flat_e[k]) for k, g in cm.flatten(grads).items()}
    return tuple(cm.nest({k: o[i] for k, o in out.items()}) for i in range(3))


def decompress(grads_q, scales):
    flat_s = cm.flatten(scales)
    return cm.nest({k: q.float() * flat_s[k].float() for k, q in cm.flatten(grads_q).items()})


def compressed_roundtrip(grads, ef):
    """Quantize and dequantize with error feedback; returns (approx_grads,
    new_ef)."""
    q, s, new_ef = compress(grads, ef)
    return decompress(q, s), new_ef
