"""Shared model building blocks on tensors. Params are nested dicts of
tensors with the JAX package's layout (``x @ W`` weights, a leading
stacked-layer axis), so a ``repro`` checkpoint loads directly."""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import P, grad_as_input, is_dtensor, rows

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
    layers' gradients go back to the stacked tensor in one stack (of a
    DTensor leaf, each layer's gradient laid out as its slice first)."""
    flat = {k: [grad_as_input(t) for t in v.unbind(0)] for k, v in flatten(stacked).items()}
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


# ------------------------------------------------------------- spec trees
def stacked_specs(specs: Dict[str, Any]) -> Dict[str, Any]:
    """Specs of one layer -> specs of the layers stacked along a leading
    axis: a None entry in front of each (the JAX package's ``stacked``)."""
    return {k: stacked_specs(s) if isinstance(s, dict) else P(None, *s)
            for k, s in specs.items()}


def embedding_specs(cfg) -> Dict[str, Any]:
    """The embedding's rows and the unembedding's columns over "model"."""
    s = {"embed": P("model", None)}
    if not cfg.tie_embeddings:
        s["unembed"] = P(None, "model")
    return s


NORM_SPECS = {"scale": P(None)}


def fsdp_axis(cfg):
    """"data" on the input dim of the weights under fsdp, else None."""
    return "data" if cfg.weight_sharding == "fsdp" else None


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
    if is_dtensor(p["embed"]):
        return rows(_sharded_embedding(p["embed"], tokens.long()))
    return p["embed"][tokens.long()]


def _vocab_slice(t, dim: int):
    """(mesh dims that shard ``t``'s dim ``dim``, the index of this rank's
    first row along it)."""
    mesh = t.device_mesh
    dims = [i for i, p in enumerate(t.placements) if p.is_shard(dim)]
    first = 0
    for i in dims:
        first = first * mesh.size(i) + mesh.get_local_rank(i)
    return dims, first * t.to_local().shape[dim]


def _sharded_embedding(table, tokens):
    """Rows of a DTensor table (the dry-run's, the vocab over "model") for
    DTensor token ids, as vocab-parallel embedding looks them up: each rank
    reads the ids its slice holds from its slice (zeros for the others),
    and the sum over the slices is left partial for ``rows`` to complete.
    Local ops only, its backward too: DTensor's index rule is missing, or
    its embedding rule's gradient cannot meet another, in some releases."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = table.device_mesh
    table = table.redistribute(mesh, [p if p.is_shard(0) else Replicate()
                                      for p in table.placements])
    vocab, first = _vocab_slice(table, 0)
    ids = tokens.redistribute(mesh, [Replicate() if i in vocab or not p.is_shard(0) else p
                                     for i, p in enumerate(tokens.placements)])
    placed = [Partial() if i in vocab else p for i, p in enumerate(ids.placements)]
    tl, il = table.to_local(), ids.to_local() - first
    mine = (il >= 0) & (il < tl.shape[0])
    out = torch.nn.functional.embedding(il.clamp(0, tl.shape[0] - 1), tl) * mine[..., None]
    shape = (*tokens.shape, table.shape[1])
    return DTensor.from_local(out, mesh, placed, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


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
    labels = labels.long()
    mask = (labels >= 0) & (labels < vocab_size)
    if is_dtensor(logits) and any(p.is_shard(logits.ndim - 1) and logits.device_mesh.size(i) > 1
                                  for i, p in enumerate(logits.placements)):
        lse, ll = _sharded_ce_terms(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, torch.where(mask, labels, 0)[..., None])[..., 0]
    nll = torch.where(mask, lse - ll, 0.0)
    return nll.sum() / mask.sum().clamp(min=1)


def _sharded_ce_terms(logits, labels):
    """(log-sum-exp, the label's logit), each (B, S), of DTensor logits (the
    dry-run's, the vocab over "model"), as vocab-parallel cross entropy
    computes them: each rank reduces its own slice of the vocab and a
    collective of (B, S) values completes the max and the sums. Its
    backward stays on the slices too; torch.logsumexp, a gather's backward
    or a sum's broadcast gradient would each put the whole vocab on every
    rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh, plc = logits.device_mesh, logits.placements
    vdim = logits.ndim - 1
    vocab = [i for i, p in enumerate(plc) if p.is_shard(vdim)]
    rows = [p if p.is_shard() and p.dim < vdim else Replicate() for p in plc]
    part = lambda kind: [Partial(kind) if i in vocab else p for i, p in enumerate(rows)]  # noqa: E731

    def reduce(t, kind):
        return DTensor.from_local(t, mesh, part(kind), run_check=False) \
            .redistribute(mesh, rows).to_local()

    lg = logits.to_local()
    lb = labels.redistribute(mesh, rows).to_local()
    first = _vocab_slice(logits, vdim)[1]      # the vocab index of this rank's slice
    mx = reduce(lg.detach().amax(-1), "max")
    lse = mx + torch.log(reduce(torch.exp(lg - mx[..., None]).sum(-1), "sum"))
    hit = torch.arange(first, first + lg.shape[-1], device=lg.device) == lb[..., None]
    ll = reduce(torch.where(hit, lg, 0.0).sum(-1), "sum")
    wrap = lambda t: DTensor.from_local(t, mesh, rows, run_check=False)  # noqa: E731
    return wrap(lse), wrap(ll)
