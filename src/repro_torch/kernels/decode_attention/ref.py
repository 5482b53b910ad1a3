"""Plain PyTorch version of single-token GQA decode attention over a KV
cache: the oracle the CUDA kernel is held against, and the path a tensor
on the CPU takes."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF


def decode_attention_reference(q, k_cache, v_cache, lengths, *,
                               scale: float | None = None, window: int = 0):
    """q: (B, H, D); k/v_cache: (B, Smax, KH, D); lengths: (B,) int32.

    The query token sits at position lengths-1 (the cache already holds
    its K/V there). A length past Smax attends the whole cache. Returns
    (B, H, D).
    """
    _, H, D = q.shape
    _, S, KH, _ = k_cache.shape
    g = H // KH
    scale = scale if scale is not None else D ** -0.5

    qf = q.float() * scale
    kf = k_cache.float().repeat_interleave(g, dim=2)     # (B, S, H, D)
    vf = v_cache.float().repeat_interleave(g, dim=2)

    logits = torch.einsum("bhd,bshd->bhs", qf, kf)
    k_pos = torch.arange(S, device=q.device)[None, None, :]
    lens = lengths[:, None, None]
    mask = k_pos < lens
    if window and window > 0:
        mask &= k_pos > (lens - 1 - window)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / (probs.sum(dim=-1, keepdim=True) + 1e-30)
    out = torch.einsum("bhs,bshd->bhd", probs, vf)
    return out.to(q.dtype)
