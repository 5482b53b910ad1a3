"""Shared model building blocks on tensors. Params are nested dicts of
tensors with the JAX package's layout (``x @ W`` weights, a leading
stacked-layer axis), so a ``repro`` checkpoint loads directly."""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

VOCAB_PAD = 256


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def wide(dtype: torch.dtype) -> torch.dtype:
    """fp32, or ``dtype`` if it is wider: where the norms, the loss and the
    recurrent states are computed (an fp64 model stays fp64 throughout)."""
    return torch.promote_types(dtype, torch.float32)


# ------------------------------------------------------------- param trees
def nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"a/b": x} -> {"a": {"b": x}} (keys as ``repro.train.checkpoint``'s
    ``_flatten`` writes them)."""
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        *path, name = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Inverse of ``nest``."""
    flat: Dict[str, Any] = {}
    for name, node in tree.items():
        key = f"{prefix}{name}"
        if isinstance(node, dict):
            flat.update(flatten(node, key + "/"))
        else:
            flat[key] = node
    return flat


def layer_views(stacked: Dict[str, Any], n: int):
    """Per-layer views of a tree of params stacked along a leading axis of
    ``n`` layers. Each leaf is cut by one ``unbind``, so in training the
    layers' gradients go back to the stacked tensor in one stack."""
    flat = {k: v.unbind(0) for k, v in flatten(stacked).items()}
    return [nest({k: views[i] for k, views in flat.items()}) for i in range(n)]


def remat(cfg, fn, *args):
    """``fn(*args)``, under activation checkpointing when ``cfg.remat`` is set
    and a gradient is being taken (grad mode on, and a tensor among the
    args, or in a dict of them, requires grad), as the JAX package wraps its
    scanned layer body in ``jax.checkpoint``: the layer's activations are not
    kept, and its forward runs again in the backward pass."""
    if cfg.remat and torch.is_grad_enabled() and any(
            t.requires_grad for a in args
            for t in (flatten(a).values() if isinstance(a, dict) else (a,))
            if isinstance(t, torch.Tensor)):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------- init utils
def dense_init(gen: torch.Generator, fan_in: int, shape, dtype) -> torch.Tensor:
    """N(0, 1/fan_in) drawn in fp32 on the generator's device, then cast."""
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


ZERO_INIT = ("bq", "bk", "bv", "conv_b")   # biases start at zero


def init_params(gen: torch.Generator, cfg, shapes, dtype_of, const=None):
    """Params on ``gen``'s device from flat key -> shape, as the JAX init
    makes them: N(0, 1/fan_in) weights (fan-in: the second-to-last axis;
    d_model for the embedding), zero biases, unit norm scales, and the
    values of ``const`` (key -> tensor broadcast to the shape); each key in
    ``dtype_of(key)``. Returns the nested tree."""
    const = const or {}
    flat = {}
    for key, shape in shapes.items():
        kdt = dtype_of(key)
        name = key.rsplit("/", 1)[-1]
        if key in const:
            flat[key] = const[key].to(kdt).expand(shape).contiguous()
        elif name == "scale":
            flat[key] = torch.ones(shape, dtype=kdt, device=gen.device)
        elif name in ZERO_INIT:
            flat[key] = torch.zeros(shape, dtype=kdt, device=gen.device)
        else:
            fan_in = cfg.d_model if key == "emb/embed" else shape[-2]
            flat[key] = dense_init(gen, fan_in, shape, kdt)
    return nest(flat)


# ------------------------------------------------------------------- norms
def rmsnorm(x, p, eps: float):
    xf = x.to(wide(x.dtype))
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].to(xf.dtype)
    return out.to(x.dtype)


# -------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    D = x.shape[-1]
    inv = rope_freqs(D, theta, x.device)                    # (D/2,)
    ang = positions[..., None].float() * inv                # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    half = head_dim // 2
    s1 = half // 4
    s2 = (half - s1) // 2
    return s1, s2, half - s1 - s2


def apply_mrope(x, positions3, theta: float):
    """M-RoPE: positions3 (3, ..., S) = (temporal, h, w) ids; the frequency
    bands are split across the three components (Qwen2-VL §2)."""
    D = x.shape[-1]
    inv = rope_freqs(D, theta, x.device)
    parts, off = [], 0
    for comp, sec in enumerate(mrope_sections(D)):
        parts.append(positions3[comp][..., None].float() * inv[off:off + sec])
        off += sec
    ang = torch.cat(parts, dim=-1)                          # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(S: int, d: int, offset=0, device=None):
    """(S, d) fp32 sin/cos table of positions offset .. offset + S - 1;
    ``offset`` may also be a (B, 1) tensor of per-sequence offsets, which
    gives (B, S, d)."""
    pos = torch.arange(S, dtype=torch.float32, device=device) + offset
    inv = 1.0 / (10000.0 ** (torch.arange(d // 2, dtype=torch.float32, device=device)
                             / (d // 2)))
    ang = pos[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------- embeddings
def embed_tokens(p, tokens):
    return p["embed"][tokens.long()]


def unembed(p, cfg, x):
    w = p.get("unembed")
    if w is None:
        w = p["embed"].T
    return x @ w


# -------------------------------------------------------------------- loss
def cross_entropy(logits, labels, vocab_size: int):
    """Mean cross entropy over the valid labels (0 <= label < vocab_size),
    in fp32 (or the logits' dtype if wider) over the (possibly padded) vocab
    axis of ``logits``; other labels are masked out, and the mean is over
    the valid ones (at least one)."""
    logits = logits.to(wide(logits.dtype))
    lse = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    mask = (labels >= 0) & (labels < vocab_size)
    ll = logits.gather(-1, torch.where(mask, labels, 0)[..., None])[..., 0]
    nll = torch.where(mask, lse - ll, 0.0)
    return nll.sum() / mask.sum().clamp(min=1)
