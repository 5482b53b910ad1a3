"""Plain PyTorch version of single-token GQA decode attention over a KV
cache: the oracle the CUDA kernel is held against, and the path a tensor
on the CPU takes."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF, cdiv


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


SPAN_UNIT = 64   # a split's span is whole units of this many keys


def decode_attention_split_reference(q, k_cache, v_cache, lengths, *, splits: int,
                                     scale: float | None = None, window: int = 0):
    """The bf16 kernel's split-KV form, in plain torch and fp32: split s
    takes keys [s * span, (s + 1) * span) with span = cdiv(cdiv(Smax, 64),
    splits) * 64, computes its own (m, l, acc) over the keys it holds that
    attend, and the splits merge in split order:
        out = sum_s exp(m_s - M) acc_s / (sum_s exp(m_s - M) l_s + 1e-30).
    A split that holds no key that attends has m = NEG_INF, l = 0, acc = 0
    and weighs zero. Same arguments and result as
    ``decode_attention_reference``; the CUDA path never calls it."""
    B, H, D = q.shape
    _, S, KH, _ = k_cache.shape
    g = H // KH
    scale = scale if scale is not None else D ** -0.5
    span = cdiv(cdiv(S, SPAN_UNIT), splits) * SPAN_UNIT

    qf = q.float() * scale
    kf = k_cache.float().repeat_interleave(g, dim=2)     # (B, S, H, D)
    vf = v_cache.float().repeat_interleave(g, dim=2)
    logits = torch.einsum("bhd,bshd->bhs", qf, kf)
    k_pos = torch.arange(S, device=q.device)[None, None, :]
    lens = lengths[:, None, None]
    keep = k_pos < lens
    if window and window > 0:
        keep &= k_pos > (lens - 1 - window)
    parts = []
    for s in range(splits):
        mine = keep & (k_pos >= s * span) & (k_pos < (s + 1) * span)
        m = torch.where(mine, logits, NEG_INF).amax(dim=-1)             # (B, H)
        p = torch.where(mine, torch.exp(logits - m[..., None]), 0.0)
        parts.append((m, p.sum(-1), torch.einsum("bhs,bshd->bhd", p, vf)))
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    num = torch.zeros_like(qf)
    den = torch.zeros_like(top)
    for m, l, acc in parts:
        w = torch.exp(m - top)
        num = num + w[..., None] * acc
        den = den + w * l
    return (num / (den[..., None] + 1e-30)).to(q.dtype)
