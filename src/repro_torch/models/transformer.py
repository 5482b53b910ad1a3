"""Decoder-only transformer LM: dense, MoE and VLM families.

Layers are stacked along a leading axis, as in the JAX package, and run
in a Python loop over per-layer views. Decode updates the KV cache in
place. In training (grad mode on) each layer of ``forward`` runs under
activation checkpointing when ``cfg.remat`` is set, as the JAX package
checkpoints its scanned layer body.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.distributed.sharding import P, batch_axes, constrain
from repro_torch.kernels.common import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod


def param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Flat ``/``-joined param keys -> shapes (the JAX checkpoint layout)."""
    d, L, f = cfg.d_model, cfg.n_layers, cfg.d_ff
    hq = cfg.n_heads * cfg.resolved_head_dim
    hkv = cfg.n_kv_heads * cfg.resolved_head_dim
    vp = cm.padded_vocab(cfg.vocab_size)
    s = {"emb/embed": (vp, d)}
    if not cfg.tie_embeddings:
        s["emb/unembed"] = (d, vp)
    s.update({
        "layers/ln1/scale": (L, d),
        "layers/attn/wq": (L, d, hq), "layers/attn/wk": (L, d, hkv),
        "layers/attn/wv": (L, d, hkv), "layers/attn/wo": (L, hq, d),
    })
    if cfg.qkv_bias:
        s.update({"layers/attn/bq": (L, hq), "layers/attn/bk": (L, hkv),
                  "layers/attn/bv": (L, hkv)})
    s["layers/ln2/scale"] = (L, d)
    if cfg.family == "moe":
        E = cfg.n_experts
        s.update({"layers/moe/router": (L, d, E),
                  "layers/moe/wg": (L, E, d, f), "layers/moe/wu": (L, E, d, f),
                  "layers/moe/wd": (L, E, f, d)})
    else:
        s.update({"layers/mlp/wg": (L, d, f), "layers/mlp/wu": (L, d, f),
                  "layers/mlp/wd": (L, f, d)})
    s["ln_f/scale"] = (d,)
    return s


def param_specs(cfg) -> Dict[str, P]:
    """Flat param keys (as ``param_shapes``) -> partition specs."""
    layer = {"ln1": cm.NORM_SPECS, "attn": attn.attn_specs(cfg), "ln2": cm.NORM_SPECS}
    if cfg.family == "moe":
        layer["moe"] = mlp_mod.moe_specs(cfg)
    else:
        layer["mlp"] = mlp_mod.mlp_specs(cfg)
    return cm.flatten({"emb": cm.embedding_specs(cfg), "layers": cm.stacked_specs(layer),
                       "ln_f": cm.NORM_SPECS})


FP32_KEYS = ("layers/moe/router",)   # fp32 in every model, as in the JAX init


def param_dtype(key: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype param ``key`` takes in a model of weight dtype ``dtype``."""
    return torch.float32 if key in FP32_KEYS else dtype


# ------------------------------------------------------------------ layers
def _ffn(p, cfg, x):
    """The block's feed-forward half on x (B, S, d): (y, aux loss)."""
    if cfg.family == "moe":
        return mlp_mod.moe_forward(p["moe"], cfg, x)
    return mlp_mod.mlp_forward(p["mlp"], cfg, x), 0.0


def layer_forward(p, cfg, h, positions, mrope_pos=None):
    h = h + attn.attn_forward(p["attn"], cfg, cm.rmsnorm(h, p["ln1"], cfg.norm_eps),
                              positions, mrope_pos)
    y, aux = _ffn(p, cfg, cm.rmsnorm(h, p["ln2"], cfg.norm_eps))
    return h + y, aux


def layer_prefill(p, cfg, h, positions, mrope_pos=None):
    a, kv = attn.attn_prefill(p["attn"], cfg, cm.rmsnorm(h, p["ln1"], cfg.norm_eps),
                              positions, mrope_pos)
    h = h + a
    y, _ = _ffn(p, cfg, cm.rmsnorm(h, p["ln2"], cfg.norm_eps))
    return h + y, kv


def layer_decode(p, cfg, h, ck, cv, lengths, mrope_pos=None):
    h = h + attn.attn_decode(p["attn"], cfg, cm.rmsnorm(h, p["ln1"], cfg.norm_eps),
                             ck, cv, lengths, mrope_pos)
    x = cm.rmsnorm(h, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":               # every slot is one token of the batch
        y, _ = mlp_mod.moe_forward(p["moe"], cfg, x[:, None, :])
        return h + y[:, 0, :]
    return h + mlp_mod.mlp_forward(p["mlp"], cfg, x)


def _layers(params, cfg) -> List[Dict]:
    """Per-layer views of the stacked layer params."""
    return cm.layer_views(params["layers"], cfg.n_layers)


# ------------------------------------------------------------------- model
def init(gen: torch.Generator, cfg, dtype: torch.dtype | None = None):
    """Random params on ``gen``'s device: N(0, 1/fan_in) weights, zero
    biases, unit norm scales (the JAX init's distributions), each key in
    ``param_dtype``."""
    dtype = dtype or cm.compute_dtype(cfg)
    return cm.init_params(gen, cfg, param_shapes(cfg), lambda key: param_dtype(key, dtype))


def _positions_and_embeds(params, cfg, batch):
    """Token embeddings and RoPE positions (B, S); for the VLM the vision
    embeddings (B, V, d) go first, and the 3-row M-RoPE positions
    (3, B, V + S) take the place of ``positions``: the vision tokens on a
    side x side grid at time 0, text token t at side + t on all three."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    h = cm.embed_tokens(params["emb"], tokens)
    if cfg.family != "vlm":
        return h, torch.arange(S, device=dev)[None, :], None
    ve = batch["vision_embeds"].to(h.dtype)
    V = ve.shape[1]
    h = torch.cat([ve, h], dim=1)
    side = max(int(V ** 0.5), 1)
    vis = torch.arange(V, device=dev)
    txt = side + torch.arange(S, device=dev)
    pos3 = torch.stack([torch.cat([torch.zeros_like(vis), txt]),
                        torch.cat([vis // side, txt]),
                        torch.cat([vis % side, txt])])            # (3, V + S)
    return h, None, pos3[:, None, :].expand(3, B, V + S)


def forward(params, cfg, batch):
    """Teacher-forced logits (B, S, Vp) (VLM: (B, V + S, Vp)) and the aux
    loss summed over layers (0.0 for dense)."""
    h, positions, mrope_pos = _positions_and_embeds(params, cfg, batch)
    h = constrain(h, batch_axes(), None, None)
    aux = 0.0
    for lp in _layers(params, cfg):
        h, a = cm.remat(cfg, layer_forward, lp, cfg, h, positions, mrope_pos)
        h = constrain(h, batch_axes(), None, None)
        aux = aux + a
    h = cm.rmsnorm(h, params["ln_f"], cfg.norm_eps)
    return constrain(cm.unembed(params["emb"], cfg, h), batch_axes(), None, "model"), aux


# ------------------------------------------------------------------ serving
def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Zeroed cache: positions past a sequence's length must read as zeros."""
    L, KH, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    dev = resolve_device(device)
    shape = (L, batch_size, max_len, KH, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "len": torch.zeros((batch_size,), dtype=torch.int32, device=dev)}


def cache_specs(cfg) -> Dict[str, P]:
    """The cache's specs: slots over "data", KV heads over "model", or the
    sequence over "model" with ``kv_seq_shard`` (when the KV heads cannot
    use it)."""
    dp = ("data",)
    kv = P(None, dp, "model", None, None) if cfg.kv_seq_shard \
        else P(None, dp, None, "model", None)
    return {"k": kv, "v": kv, "len": P(dp)}


def prefill(params, cfg, batch, last_pos=None):
    """Run the prompt; returns (logits at the last prompt position (B, Vp),
    cache). ``last_pos`` (B,) overrides the sampled position for
    bucket-padded prompts (pads are never attended: the engine sets the
    cache length)."""
    h, positions, mrope_pos = _positions_and_embeds(params, cfg, batch)
    ks, vs = [], []
    for lp in _layers(params, cfg):
        h, (k, v) = layer_prefill(lp, cfg, h, positions, mrope_pos)
        h = constrain(h, batch_axes(), None, None)
        ks.append(k)
        vs.append(v)
    B, S = h.shape[:2]
    hl = h[:, -1] if last_pos is None else \
        h[torch.arange(B, device=h.device), last_pos.long()]
    logits = cm.unembed(params["emb"], cfg, cm.rmsnorm(hl, params["ln_f"], cfg.norm_eps))
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "len": torch.full((B,), S, dtype=torch.int32, device=h.device)}
    return logits, cache


def decode_step(params, cfg, cache, tokens):
    """One token for every sequence. tokens (B,) -> (logits (B,Vp), cache).

    The returned cache shares ``cache``'s K/V tensors, which this step
    updates IN PLACE; only ``len`` is a new tensor (every slot + 1)."""
    h = cm.embed_tokens(params["emb"], tokens)              # (B, d)
    lengths = cache["len"]
    mrope_pos = None
    if cfg.family == "vlm":    # the cache length on all three rows, as in the JAX package
        mrope_pos = lengths[None, :, None].expand(3, -1, 1)
    for i, lp in enumerate(_layers(params, cfg)):
        h = layer_decode(lp, cfg, h, cache["k"][i], cache["v"][i], lengths, mrope_pos)
    h = cm.rmsnorm(h, params["ln_f"], cfg.norm_eps)
    logits = cm.unembed(params["emb"], cfg, h)
    return logits, {"k": cache["k"], "v": cache["v"], "len": lengths + 1}
