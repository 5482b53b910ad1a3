"""Plain PyTorch version of flash attention (GQA + sliding window), its
log-sum-exp and its backward.

Materializes the full (Sq, Sk) score matrix: the oracle the CUDA kernels
are held against, and the path a tensor on the CPU takes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF


def _masked_logits(q, k, causal, window, scale):
    """fp32 scaled scores (B, H, Sq, Sk), NEG_INF where a key is not kept."""
    _, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    scale = scale if scale is not None else D ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(H // KH, dim=2)  # expand kv heads for GQA
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    q_pos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window and window > 0:
        mask &= k_pos > q_pos - window
    return torch.where(mask, logits, NEG_INF)


def mha_reference(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None):
    """q: (B, Sq, H, D); k, v: (B, Sk, KH, D) with H % KH == 0 (GQA).

    window > 0: each query attends to the last ``window`` positions,
    itself included. Query i sits at absolute position Sk - Sq + i
    ("suffix" alignment). Returns (B, Sq, H, D) in q.dtype.
    """
    H, KH = q.shape[2], k.shape[2]
    vf = v.float().repeat_interleave(H // KH, dim=2)
    logits = _masked_logits(q, k, causal, window, scale)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / (probs.sum(dim=-1, keepdim=True) + 1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)


def lse_reference(q, k, *, causal: bool = True, window: int = 0,
                  scale: float | None = None):
    """Each row's log-sum-exp of its kept scaled scores, (B, H, Sq) fp32:
    what the forward kernel saves for the backward."""
    return torch.logsumexp(_masked_logits(q, k, causal, window, scale), dim=-1)


def mha_backward_reference(q, k, v, dout, *, causal: bool = True, window: int = 0,
                           scale: float | None = None):
    """(dq, dk, dv): the VJP of ``mha_reference`` at (q, k, v) for the
    cotangent ``dout``, by autograd, each in its input's dtype."""
    with torch.enable_grad():
        qd, kd, vd = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = mha_reference(qd, kd, vd, causal=causal, window=window, scale=scale)
        return torch.autograd.grad(out, (qd, kd, vd), dout)
