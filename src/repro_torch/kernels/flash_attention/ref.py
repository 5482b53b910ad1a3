"""Plain PyTorch version of flash attention (GQA + sliding window).

Materializes the full (Sq, Sk) score matrix: the oracle the CUDA kernel
is held against, and the path a tensor on the CPU takes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF


def mha_reference(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None):
    """q: (B, Sq, H, D); k, v: (B, Sk, KH, D) with H % KH == 0 (GQA).

    window > 0: each query attends to the last ``window`` positions,
    itself included. Query i sits at absolute position Sk - Sq + i
    ("suffix" alignment). Returns (B, Sq, H, D) in q.dtype.
    """
    _, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    g = H // KH
    scale = scale if scale is not None else D ** -0.5

    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=2)        # expand kv heads for GQA
    vf = v.float().repeat_interleave(g, dim=2)

    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)

    q_pos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window and window > 0:
        mask &= k_pos > q_pos - window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / (probs.sum(dim=-1, keepdim=True) + 1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)
