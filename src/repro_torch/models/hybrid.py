"""Zamba2-style hybrid: a stack of Mamba2 (SSD) layers with one *shared*
attention+MLP block (a single weight set) applied after every
``attn_every``-th SSM layer. The shared block consumes concat(h, emb0)
(2d -> d input projection), following Zamba2's global-residual design.

Decode state is O(1) per sequence (SSM state + conv tail) plus a KV cache
only at the few shared-attention insertion points. The SSD scan of a
prefill or a train step runs in the hand-written kernel (its gradient in the
backward kernel); decode updates the SSM, conv and KV caches in place.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P, batch_axes, constrain
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.mamba_scan import ops as ssd_ops
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod


def _conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def n_insertions(cfg) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Flat ``/``-joined param keys -> shapes (the JAX checkpoint layout)."""
    d, L, f = cfg.d_model, cfg.n_layers, cfg.d_ff
    di, H, cd = cfg.d_inner, cfg.ssm_nheads, _conv_dim(cfg)
    hq = cfg.n_heads * cfg.resolved_head_dim
    hkv = cfg.n_kv_heads * cfg.resolved_head_dim
    vp = cm.padded_vocab(cfg.vocab_size)
    s = {"emb/embed": (vp, d)}
    if not cfg.tie_embeddings:
        s["emb/unembed"] = (d, vp)
    s.update({
        "mamba/ln/scale": (L, d), "mamba/in_proj": (L, d, di + cd + H),
        "mamba/conv_w": (L, cfg.ssm_conv, cd), "mamba/conv_b": (L, cd),
        "mamba/A_log": (L, H), "mamba/D": (L, H), "mamba/dt_bias": (L, H),
        "mamba/norm/scale": (L, di), "mamba/out_proj": (L, di, d),
        "shared/ln/scale": (2 * d,),
        "shared/attn/wq": (2 * d, hq), "shared/attn/wk": (2 * d, hkv),
        "shared/attn/wv": (2 * d, hkv), "shared/attn/wo": (hq, d),
    })
    if cfg.qkv_bias:
        s.update({"shared/attn/bq": (hq,), "shared/attn/bk": (hkv,),
                  "shared/attn/bv": (hkv,)})
    s.update({"shared/ln2/scale": (d,), "shared/mlp/wg": (d, f),
              "shared/mlp/wu": (d, f), "shared/mlp/wd": (f, d),
              "ln_f/scale": (d,)})
    return s


def param_specs(cfg) -> Dict[str, P]:
    """Flat param keys (as ``param_shapes``) -> partition specs."""
    fsdp = cm.fsdp_axis(cfg)
    mamba = {"ln": cm.NORM_SPECS, "in_proj": P(fsdp, "model"), "conv_w": P(None, "model"),
             "conv_b": P("model"), "A_log": P(None), "D": P(None), "dt_bias": P(None),
             "norm": {"scale": P("model")}, "out_proj": P("model", fsdp)}
    shared = {"ln": cm.NORM_SPECS, "attn": attn.attn_specs(cfg), "ln2": cm.NORM_SPECS,
              "mlp": mlp_mod.mlp_specs(cfg)}
    return cm.flatten({"emb": cm.embedding_specs(cfg), "mamba": cm.stacked_specs(mamba),
                       "shared": shared, "ln_f": cm.NORM_SPECS})


FP32_KEYS = ("mamba/A_log", "mamba/D", "mamba/dt_bias")   # fp32 in every model


def param_dtype(key: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype param ``key`` takes in a model of weight dtype ``dtype``."""
    return torch.float32 if key in FP32_KEYS else dtype


def init(gen: torch.Generator, cfg, dtype: torch.dtype | None = None):
    """Params on ``gen``'s device: N(0, 1/fan_in) weights (conv_w with fan-in
    ssm_conv), zero biases, unit norm scales, and the JAX init's constants
    A_log = log(linspace(1, 16, H)), D = 1, dt_bias = -2, so a run decays as
    the reference's does."""
    dtype = dtype or cm.compute_dtype(cfg)
    H, dev = cfg.ssm_nheads, gen.device
    const = {"mamba/A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
             "mamba/D": torch.ones(H, device=dev),
             "mamba/dt_bias": torch.full((H,), -2.0, device=dev)}
    return cm.init_params(gen, cfg, param_shapes(cfg), lambda key: param_dtype(key, dtype),
                          const)


# --------------------------------------------------------------- mamba layer
def _mamba_project(p, cfg, x):
    """x (..., d) -> z (..., di), xBC (..., cd), dt (..., H) post-activation."""
    di, cd = cfg.d_inner, _conv_dim(cfg)
    # whole on every rank before it is cut into z, xBC and dt, whose
    # bounds the model axis's shards do not meet (a no-op on plain tensors)
    proj = sh.rows(x @ p["in_proj"])
    dt = F.softplus(proj[..., di + cd:].float() + p["dt_bias"])
    return proj[..., :di], proj[..., di:di + cd], dt


def _split_xbc(cfg, xBC):
    di, N = cfg.d_inner, cfg.ssm_state
    return xBC[..., :di], xBC[..., di:di + N], xBC[..., di + N:]


def _gated_out(p, cfg, h, y, z):
    y = cm.rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return h + sh.rows(y @ p["out_proj"])


def mamba_forward(p, cfg, h, return_state=False):
    """Full-sequence Mamba2 layer. h (B,S,d). With ``return_state`` also
    returns (final SSM state (B,H,P,N) fp32, conv tail (B,conv-1,cd))."""
    B, S, _ = h.shape
    H, Pd = cfg.ssm_nheads, cfg.ssm_head_dim
    z, xBC, dt = _mamba_project(p, cfg, cm.rmsnorm(h, p["ln"], cfg.norm_eps))
    # causal depthwise conv (width ssm_conv) over the sequence, summed in
    # the compute dtype in the JAX package's order
    w = p["conv_w"]
    pad = F.pad(xBC, (0, 0, cfg.ssm_conv - 1, 0))
    conv = sum(pad[:, i:i + S, :] * w[i] for i in range(cfg.ssm_conv)) + p["conv_b"]
    x, Bm, Cm = _split_xbc(cfg, F.silu(conv))
    # the scan's operands with the heads over "model" and the sequence whole
    # (a no-op on plain tensors): each rank scans its own heads
    dp = batch_axes()
    x = constrain(sh.reshape(x, B, S, H, Pd), dp, None, "model", None)
    dt = constrain(dt, dp, None, "model")
    Bm, Cm = constrain(Bm, dp, None, None), constrain(Cm, dp, None, None)
    out = ssd_ops.ssd_scan(x, dt, -torch.exp(p["A_log"]), Bm, Cm, p["D"],
                           with_state=return_state)
    y, state = out if return_state else (out, None)
    out_h = _gated_out(p, cfg, h, sh.reshape(y, B, S, cfg.d_inner), z)
    if not return_state:
        return out_h
    # the last (conv-1) raw xBC inputs, needed to continue the conv
    k = cfg.ssm_conv - 1
    tail = xBC[:, S - k:, :] if S >= k else F.pad(xBC, (0, 0, k - S, 0))
    return out_h, (state, tail)


def mamba_decode(p, cfg, h, ssm_state, conv_buf):
    """One-token step. h (B,d); ssm_state (B,H,P,N); conv_buf (B,conv-1,cd).
    Returns (h, new state, new conv window)."""
    B = h.shape[0]
    z, xBC, dt = _mamba_project(p, cfg, cm.rmsnorm(h, p["ln"], cfg.norm_eps))
    window = torch.cat([conv_buf, xBC[:, None, :]], dim=1)     # (B,conv,cd)
    # fp32 sum, one rounding: the JAX einsum's accumulation
    conv = (window.float() * p["conv_w"].float()).sum(1).to(h.dtype) + p["conv_b"]
    x, Bm, Cm = _split_xbc(cfg, F.silu(conv))
    y, state = ssd_ops.decode_step(ssm_state, sh.reshape(x, B, cfg.ssm_nheads, cfg.ssm_head_dim),
                                   dt, -torch.exp(p["A_log"]), Bm, Cm, p["D"])
    return _gated_out(p, cfg, h, sh.reshape(y, B, cfg.d_inner), z), state, window[:, 1:, :]


# ------------------------------------------------------- shared attn block
def _shared_mlp(p, cfg, h):
    return h + mlp_mod.mlp_forward(p["mlp"], cfg, cm.rmsnorm(h, p["ln2"], cfg.norm_eps))


def _shared_in(p, cfg, h, emb0):
    return cm.rmsnorm(torch.cat([h, emb0], dim=-1), p["ln"], cfg.norm_eps)


def shared_forward(p, cfg, h, emb0, positions):
    return _shared_mlp(p, cfg, h + attn.attn_forward(
        p["attn"], cfg, _shared_in(p, cfg, h, emb0), positions))


def shared_prefill(p, cfg, h, emb0, positions):
    a, kv = attn.attn_prefill(p["attn"], cfg, _shared_in(p, cfg, h, emb0), positions)
    return _shared_mlp(p, cfg, h + a), kv


def shared_decode(p, cfg, h, emb0, ck, cv, lengths):
    """Writes this token's K/V into ck/cv IN PLACE (see attn.attn_decode)."""
    return _shared_mlp(p, cfg, h + attn.attn_decode(
        p["attn"], cfg, _shared_in(p, cfg, h, emb0), ck, cv, lengths))


# ------------------------------------------------------------------- model
def _groups(cfg):
    """[(start, stop, attn_after)] covering all layers; the last group has
    no attention when attn_every does not divide n_layers."""
    out, i = [], 0
    k = cfg.attn_every
    while i < cfg.n_layers:
        j = min(i + k, cfg.n_layers)
        out.append((i, j, (j - i) == k))
        i = j
    return out


def _layers(params, cfg) -> List[Dict]:
    """Per-layer views of the stacked Mamba params."""
    return cm.layer_views(params["mamba"], cfg.n_layers)


def forward(params, cfg, batch):
    """Teacher-forced logits (B, S, Vp) and the aux loss (0.0). Each Mamba
    layer runs under ``cm.remat`` (checkpointed when ``cfg.remat`` is set and
    a gradient is taken), as the JAX package checkpoints its scanned Mamba
    body; the shared block is not checkpointed there, nor here."""
    tokens = batch["tokens"]
    h = emb0 = cm.embed_tokens(params["emb"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    layers = _layers(params, cfg)
    for lo, hi, has_attn in _groups(cfg):
        for lp in layers[lo:hi]:
            h = constrain(cm.remat(cfg, mamba_forward, lp, cfg, h), batch_axes(), None, None)
        if has_attn:
            h = shared_forward(params["shared"], cfg, h, emb0, positions)
    h = cm.rmsnorm(h, params["ln_f"], cfg.norm_eps)
    return constrain(cm.unembed(params["emb"], cfg, h), batch_axes(), None, "model"), 0.0


# ------------------------------------------------------------------ serving
def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Zeroed cache: SSM state (fp32) and conv tail per Mamba layer, K/V per
    shared-attention insertion, and per-slot lengths."""
    dev = resolve_device(device)
    L, H, Pd, N = cfg.n_layers, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    kv = (n_insertions(cfg), batch_size, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "ssm": torch.zeros((L, batch_size, H, Pd, N), dtype=torch.float32, device=dev),
        "conv": torch.zeros((L, batch_size, cfg.ssm_conv - 1, _conv_dim(cfg)),
                            dtype=dtype, device=dev),
        "k": torch.zeros(kv, dtype=dtype, device=dev),
        "v": torch.zeros(kv, dtype=dtype, device=dev),
        "len": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
    }


def cache_specs(cfg) -> Dict[str, P]:
    dp = ("data",)
    return {"ssm": P(None, dp, "model", None, None), "conv": P(None, dp, None, "model"),
            "k": P(None, dp, None, "model", None), "v": P(None, dp, None, "model", None),
            "len": P(dp)}


def prefill(params, cfg, batch, last_pos=None):
    """Run the prompt; returns (logits at the last prompt position (B, Vp),
    cache). A recurrent state absorbs every token it is given, so the
    prompt must come at its exact length (no bucket pads)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = emb0 = cm.embed_tokens(params["emb"], tokens)
    positions = torch.arange(S, device=tokens.device)[None, :]
    layers = _layers(params, cfg)
    states, convs, ks, vs = [], [], [], []
    for lo, hi, has_attn in _groups(cfg):
        for lp in layers[lo:hi]:
            h, (st, tail) = mamba_forward(lp, cfg, h, return_state=True)
            states.append(st)
            convs.append(tail)
        if has_attn:
            h, (k, v) = shared_prefill(params["shared"], cfg, h, emb0, positions)
            ks.append(k)
            vs.append(v)
    hl = h[:, -1] if last_pos is None else \
        h[torch.arange(B, device=h.device), last_pos.long()]
    logits = cm.unembed(params["emb"], cfg, cm.rmsnorm(hl, params["ln_f"], cfg.norm_eps))
    empty = (0, B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {
        "ssm": torch.stack(states),
        "conv": torch.stack(convs),
        "k": torch.stack(ks) if ks else h.new_zeros(empty),
        "v": torch.stack(vs) if vs else h.new_zeros(empty),
        "len": torch.full((B,), S, dtype=torch.int32, device=h.device),
    }
    return logits, cache


def decode_step(params, cfg, cache, tokens):
    """One token for every sequence. tokens (B,) -> (logits (B,Vp), cache).

    The returned cache shares ``cache``'s SSM, conv and K/V tensors, which
    this step updates IN PLACE; only ``len`` is a new tensor (every slot + 1)."""
    lengths = cache["len"]
    h = emb0 = cm.embed_tokens(params["emb"], tokens)
    layers = _layers(params, cfg)
    ins = 0
    for lo, hi, has_attn in _groups(cfg):
        for i in range(lo, hi):
            h, st, window = mamba_decode(layers[i], cfg, h, cache["ssm"][i],
                                         cache["conv"][i])
            cache["ssm"][i].copy_(st)
            cache["conv"][i].copy_(window)
        if has_attn:
            h = shared_decode(params["shared"], cfg, h, emb0, cache["k"][ins],
                              cache["v"][ins], lengths)
            ins += 1
    logits = cm.unembed(params["emb"], cfg, cm.rmsnorm(h, params["ln_f"], cfg.norm_eps))
    return logits, dict(cache, len=lengths + 1)
