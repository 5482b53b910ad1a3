"""GQA attention layer: full-sequence forward (prefill, cross-attention)
and single-token cached decode, with RoPE, M-RoPE or no rotation.
Attention itself runs in the hand-written kernels; the projections are
plain matmuls."""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P, batch_axes, constrain, is_dtensor
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import common as cm


def attn_specs(cfg):
    """The projections' specs: heads over "model", the input dim over
    "data" under fsdp; the biases over "model"."""
    fsdp = cm.fsdp_axis(cfg)
    s = {"wq": P(fsdp, "model"), "wk": P(fsdp, "model"), "wv": P(fsdp, "model"),
         "wo": P("model", fsdp)}
    if cfg.qkv_bias:
        s.update({"bq": P("model"), "bk": P("model"), "bv": P("model")})
    return s


def _project_qkv(p, cfg, x):
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, S = x.shape[:-2], x.shape[-2]
    return (sh.reshape(q, *B, S, H, hd), sh.reshape(k, *B, S, KH, hd),
            sh.reshape(v, *B, S, KH, hd))


def _rope_qk(cfg, q, k, positions, mrope_pos=None):
    """RoPE on q and k at ``positions``, or M-RoPE at the 3-row
    ``mrope_pos``; sinusoidal and rope-free models pass q and k through
    (their positions, if any, are added to the embeddings)."""
    if cfg.rope == "rope":
        return (cm.apply_rope(q, positions, cfg.rope_theta),
                cm.apply_rope(k, positions, cfg.rope_theta))
    if cfg.rope == "mrope":
        return (cm.apply_mrope(q, mrope_pos, cfg.rope_theta),
                cm.apply_mrope(k, mrope_pos, cfg.rope_theta))
    if cfg.rope in ("sinusoidal", "none"):
        return q, k
    raise ValueError(f"unknown rope {cfg.rope!r}")


def attn_forward(p, cfg, x, positions=None, mrope_pos=None, causal=True, kv=None):
    """Full-sequence attention. x: (B,S,d). kv: optional (k, v) for
    cross-attention, (B,Sk,KH,hd) each: then neither rope nor any mask but
    the causal one the caller asks for."""
    return _attend(p, cfg, x, positions, mrope_pos, causal, kv, constrained=True)[0]


def attn_prefill(p, cfg, x, positions=None, mrope_pos=None):
    """Causal forward; returns (out, (k, v)), k/v the cache slices (B,S,KH,hd)."""
    return _attend(p, cfg, x, positions, mrope_pos, True)


def _attend(p, cfg, x, positions, mrope_pos, causal, kv=None, constrained=False):
    """``constrained``: q and k heads over "model" (the full-sequence
    forward's sites; the prefill has none, as in the JAX package)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    if kv is not None:
        k, v = kv
    else:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q, k = _rope_qk(cfg, q, k, positions, mrope_pos)
    if constrained:
        q = constrain(q, batch_axes(), None, "model", None)
        k = constrain(k, batch_axes(), None, "model", None)
    out = fa_ops.flash_attention(q, k, v, causal=causal,
                                 window=cfg.sliding_window)
    return sh.rows(sh.reshape(out, B, S, -1) @ p["wo"]), (k, v)


def _write_kv(cache_k, cache_v, k, v, lengths):
    """Write k/v (B,KH,hd) IN PLACE at position ``lengths`` of each slot's
    cache, where lengths < Smax. A DTensor cache (the dry-run's, its slots
    and heads or positions sharded) takes the JAX package's one-hot write,
    elementwise over every position, since an indexed write into a sharded
    tensor has no DTensor rule."""
    B, S = cache_k.shape[:2]
    if is_dtensor(cache_k):
        hit = (torch.arange(S, device=lengths.device)[None, :] == lengths[:, None])[..., None, None]
        cache_k.copy_(torch.where(hit, k[:, None].to(cache_k.dtype), cache_k))
        cache_v.copy_(torch.where(hit, v[:, None].to(cache_v.dtype), cache_v))
        return
    rows = torch.arange(B, device=k.device)
    fits = (lengths < S)[:, None, None]
    at = lengths.clamp(max=S - 1).long()
    # where the slot is full, write back what is there: no host sync needed
    cache_k[rows, at] = torch.where(fits, k.to(cache_k.dtype), cache_k[rows, at])
    cache_v[rows, at] = torch.where(fits, v.to(cache_v.dtype), cache_v[rows, at])


def attn_decode(p, cfg, x, cache_k, cache_v, lengths, mrope_pos=None):
    """One-token decode. x: (B,d); cache_k/v: (B,Smax,KH,hd); lengths (B,)
    int32 = number of valid tokens BEFORE this one, the token's RoPE
    position (M-RoPE: ``mrope_pos``, (3, B, 1)).

    Writes this token's K/V into the caches IN PLACE at position
    ``lengths`` -- only where lengths < Smax: an idle serving slot's length
    keeps growing past the cache, and there the write is skipped (the
    JAX version's one-hot write matches nothing). Returns out (B,d).
    """
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x[:, None, :])
    q, k = _rope_qk(cfg, q, k, lengths[:, None], mrope_pos)
    _write_kv(cache_k, cache_v, k[:, 0], v[:, 0], lengths)
    out = da_ops.decode_attention(q[:, 0], cache_k, cache_v, lengths + 1,
                                  window=cfg.sliding_window)
    out = constrain(out, batch_axes(), "model", None)
    return sh.rows(sh.reshape(out, B, -1) @ p["wo"])
