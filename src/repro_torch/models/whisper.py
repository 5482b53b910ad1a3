"""Whisper-style encoder-decoder (audio family).

The conv audio frontend is a stub, as in the JAX package: the model takes
precomputed frame embeddings (B, enc_seq, d_model). Sinusoidal positions
on both sides. Decoder layers carry causal self-attention and
cross-attention into the encoder output; decode caches the self K/V
(updated in place) and the fixed cross K/V (``xk``/``xv``). The three
attention sites run in the hand-written kernels: the encoder and the
cross-attention of a prompt in flash without a causal mask (Sq = Sk =
enc_seq, and Sq = prompt against Sk = enc_seq), a decode step's
cross-attention in decode attention over all enc_seq frames. In training
(grad mode on) each decoder layer runs under activation checkpointing when
``cfg.remat`` is set, as in the JAX package (its encoder layers are not
checkpointed there either).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P, batch_axes, constrain
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod


def param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Flat ``/``-joined param keys -> shapes (the JAX checkpoint layout)."""
    d, f = cfg.d_model, cfg.d_ff
    hq = cfg.n_heads * cfg.resolved_head_dim
    hkv = cfg.n_kv_heads * cfg.resolved_head_dim
    vp = cm.padded_vocab(cfg.vocab_size)
    s = {"emb/embed": (vp, d)}
    if not cfg.tie_embeddings:
        s["emb/unembed"] = (d, vp)
    for stack, L, norms, attns in (("enc_layers", cfg.n_enc_layers, ("ln1", "ln2"), ("attn",)),
                                   ("dec_layers", cfg.n_layers, ("ln1", "ln2", "ln_x"),
                                    ("attn", "xattn"))):
        for n in norms:
            s[f"{stack}/{n}/scale"] = (L, d)
        for a in attns:
            s.update({f"{stack}/{a}/wq": (L, d, hq), f"{stack}/{a}/wk": (L, d, hkv),
                      f"{stack}/{a}/wv": (L, d, hkv), f"{stack}/{a}/wo": (L, hq, d)})
            if cfg.qkv_bias:
                s.update({f"{stack}/{a}/bq": (L, hq), f"{stack}/{a}/bk": (L, hkv),
                          f"{stack}/{a}/bv": (L, hkv)})
        s.update({f"{stack}/mlp/wg": (L, d, f), f"{stack}/mlp/wu": (L, d, f),
                  f"{stack}/mlp/wd": (L, f, d)})
    s["ln_enc/scale"] = (d,)
    s["ln_f/scale"] = (d,)
    return s


def param_specs(cfg) -> Dict[str, P]:
    """Flat param keys (as ``param_shapes``) -> partition specs."""
    enc = {"ln1": cm.NORM_SPECS, "attn": attn.attn_specs(cfg), "ln2": cm.NORM_SPECS,
           "mlp": mlp_mod.mlp_specs(cfg)}
    dec = dict(enc, ln_x=cm.NORM_SPECS, xattn=attn.attn_specs(cfg))
    return cm.flatten({"emb": cm.embedding_specs(cfg), "enc_layers": cm.stacked_specs(enc),
                       "dec_layers": cm.stacked_specs(dec), "ln_enc": cm.NORM_SPECS,
                       "ln_f": cm.NORM_SPECS})


def param_dtype(key: str, dtype: torch.dtype) -> torch.dtype:
    """Every param takes the model's weight dtype."""
    return dtype


def init(gen: torch.Generator, cfg, dtype: torch.dtype | None = None):
    """Random params on ``gen``'s device: N(0, 1/fan_in) weights, zero
    biases, unit norm scales (the JAX init's distributions)."""
    dtype = dtype or cm.compute_dtype(cfg)
    return cm.init_params(gen, cfg, param_shapes(cfg), lambda key: param_dtype(key, dtype))


def encode(params, cfg, frames):
    """frames: (B, F, d) stub embeddings -> encoder states (B, F, d)."""
    h = frames + cm.sinusoidal_pos(frames.shape[1], cfg.d_model,
                                   device=frames.device).to(frames.dtype)[None]
    h = constrain(h, batch_axes(), None, None)
    for lp in cm.layer_views(params["enc_layers"], cfg.n_enc_layers):
        h = h + attn.attn_forward(lp["attn"], cfg, cm.rmsnorm(h, lp["ln1"], cfg.norm_eps),
                                  causal=False)
        h = h + mlp_mod.mlp_forward(lp["mlp"], cfg, cm.rmsnorm(h, lp["ln2"], cfg.norm_eps))
        h = constrain(h, batch_axes(), None, None)
    return cm.rmsnorm(h, params["ln_enc"], cfg.norm_eps)


def _cross_kv(lp, cfg, enc):
    """One decoder layer's cross K/V from the encoder states, (B, F, KH, hd)
    each."""
    B, F, _ = enc.shape
    KH, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    p = lp["xattn"]
    k, v = enc @ p["wk"], enc @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return sh.reshape(k, B, F, KH, hd), sh.reshape(v, B, F, KH, hd)


def _embed(params, cfg, tokens):
    h = cm.embed_tokens(params["emb"], tokens)
    return h + cm.sinusoidal_pos(tokens.shape[1], cfg.d_model,
                                 device=tokens.device).to(h.dtype)[None]


def _decoder(params, cfg, batch, constrained=False):
    """Encoder, then the decoder over the prompt: (h (B, S, d), the self K/V
    and cross K/V of each layer). ``constrained``: each layer's output is
    constrained (the forward's sites; the prefill has none, as in the JAX
    package)."""
    enc = encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    h = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    kvs = []
    for lp in cm.layer_views(params["dec_layers"], cfg.n_layers):
        h, kv = cm.remat(cfg, _dec_layer, lp, cfg, h, enc, positions)
        if constrained:
            h = constrain(h, batch_axes(), None, None)
        kvs.append(kv)
    return h, kvs


def _dec_layer(lp, cfg, h, enc, positions):
    """One decoder layer over the prompt: (h, (self K, self V, cross K, cross V))."""
    a, (k, v) = attn.attn_prefill(lp["attn"], cfg, cm.rmsnorm(h, lp["ln1"], cfg.norm_eps),
                                  positions)
    h = h + a
    kx, vx = _cross_kv(lp, cfg, enc)
    h = h + attn.attn_forward(lp["xattn"], cfg, cm.rmsnorm(h, lp["ln_x"], cfg.norm_eps),
                              causal=False, kv=(kx, vx))
    h = h + mlp_mod.mlp_forward(lp["mlp"], cfg, cm.rmsnorm(h, lp["ln2"], cfg.norm_eps))
    return h, (k, v, kx, vx)


def forward(params, cfg, batch):
    """batch: frames (B, F, d), tokens (B, S) -> (logits (B, S, Vp), aux 0.0)."""
    h, _ = _decoder(params, cfg, batch, constrained=True)
    h = cm.rmsnorm(h, params["ln_f"], cfg.norm_eps)
    return constrain(cm.unembed(params["emb"], cfg, h), batch_axes(), None, "model"), 0.0


# ------------------------------------------------------------------ serving
def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Zeroed cache: self K/V over max_len positions, cross K/V over enc_seq."""
    L, KH, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    dev = resolve_device(device)
    zeros = lambda S: torch.zeros((L, batch_size, S, KH, hd), dtype=dtype, device=dev)  # noqa: E731
    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(cfg.enc_seq), "xv": zeros(cfg.enc_seq),
            "len": torch.zeros((batch_size,), dtype=torch.int32, device=dev)}


def cache_specs(cfg) -> Dict[str, P]:
    dp = ("data",)
    kv = P(None, dp, "model", None, None) if cfg.kv_seq_shard \
        else P(None, dp, None, "model", None)
    return {"k": kv, "v": kv, "xk": P(None, dp, None, "model", None),
            "xv": P(None, dp, None, "model", None), "len": P(dp)}


def prefill(params, cfg, batch, last_pos=None):
    """Encode and run the decoder prompt; returns (logits at the last prompt
    position (B, Vp), cache). ``last_pos`` (B,) overrides the sampled
    position for bucket-padded prompts."""
    h, kvs = _decoder(params, cfg, batch)
    B, S = h.shape[:2]
    hl = h[:, -1] if last_pos is None else \
        h[torch.arange(B, device=h.device), last_pos.long()]
    logits = cm.unembed(params["emb"], cfg, cm.rmsnorm(hl, params["ln_f"], cfg.norm_eps))
    k, v, xk, xv = (torch.stack(t) for t in zip(*kvs))
    return logits, {"k": k, "v": v, "xk": xk, "xv": xv,
                    "len": torch.full((B,), S, dtype=torch.int32, device=h.device)}


def decode_step(params, cfg, cache, tokens):
    """One token for every sequence. tokens (B,) -> (logits (B, Vp), cache).

    The returned cache shares ``cache``'s tensors; this step writes its self
    K/V into them IN PLACE, and only ``len`` is a new tensor (every slot + 1)."""
    B = tokens.shape[0]
    lengths = cache["len"]
    h = cm.embed_tokens(params["emb"], tokens)
    # the new token's sinusoidal position: each sequence's own length
    h = h + cm.sinusoidal_pos(1, cfg.d_model, lengths[:, None],
                              device=h.device)[:, 0].to(h.dtype)
    flen = torch.full((B,), cfg.enc_seq, dtype=torch.int32, device=h.device)
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    for i, lp in enumerate(cm.layer_views(params["dec_layers"], cfg.n_layers)):
        h = h + attn.attn_decode(lp["attn"], cfg, cm.rmsnorm(h, lp["ln1"], cfg.norm_eps),
                                 cache["k"][i], cache["v"][i], lengths)
        p = lp["xattn"]
        q = cm.rmsnorm(h, lp["ln_x"], cfg.norm_eps) @ p["wq"]
        if "bq" in p:
            q = q + p["bq"]
        cx = da_ops.decode_attention(sh.reshape(q, B, H, hd), cache["xk"][i], cache["xv"][i], flen)
        h = h + sh.rows(sh.reshape(cx, B, -1) @ p["wo"])
        h = h + mlp_mod.mlp_forward(lp["mlp"], cfg, cm.rmsnorm(h, lp["ln2"], cfg.norm_eps))
    logits = cm.unembed(params["emb"], cfg, cm.rmsnorm(h, params["ln_f"], cfg.norm_eps))
    return logits, dict(cache, len=lengths + 1)
