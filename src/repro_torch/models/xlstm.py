"""xLSTM LM: mLSTM (matrix-memory, exponential gating) blocks with an
sLSTM (scalar-memory, diagonal recurrence) block every ``slstm_every``
layers. Fully recurrent: the decode state is O(1) in context length.

The mLSTM runs the stabilized chunkwise-parallel form over a full sequence
(train, prefill) and the exact recurrent form in decode; the two agree
because the output
    h_t = C_t q_t / max(|n_t . q_t|, exp(-m_t))
does not depend on the stabilizer m. The sLSTM runs its recurrence token
by token in both. The gates, the stabilizers and every state are fp32 in
a bf16 or fp32 model, as in the JAX package (an fp64 model keeps them in
fp64: an exact evaluation to hold fp32 runs against). No hand-written
kernel runs here: the JAX package has none for this family, and
everything is PyTorch on ``params``' device.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P, batch_axes, constrain
from repro_torch.kernels.common import resolve_device
from repro_torch.models import common as cm

CONV = 4          # causal conv width in the mLSTM block
CHUNK = 256       # chunk length of the memory-bounded parallel form
M_INIT = -1e30    # the stabilizers' start: no token seen yet
R_FAN_IN = 100    # the sLSTM's recurrent weights r start at N(0, 0.1^2)


# ------------------------------------------------------------------- layout
def _layout(cfg) -> List[Tuple[int, bool]]:
    """Groups of (n_mlstm, has_slstm) covering n_layers: an sLSTM at each
    layer i with (i + 1) % slstm_every == 0, after the mLSTMs before it."""
    out, nm = [], 0
    k = cfg.slstm_every
    for i in range(cfg.n_layers):
        if k and (i + 1) % k == 0:
            out.append((nm, True))
            nm = 0
        else:
            nm += 1
    if nm:
        out.append((nm, False))
    return out


def _order(cfg):
    """The layers in order, as ("mlstm", i) or ("slstm", j): the i-th of the
    stacked mLSTM layers, the j-th of the sLSTM ones."""
    mi = si = 0
    for nm, has_s in _layout(cfg):
        for _ in range(nm):
            yield "mlstm", mi
            mi += 1
        if has_s:
            yield "slstm", si
            si += 1


def n_slstm(cfg) -> int:
    return cfg.n_layers // cfg.slstm_every if cfg.slstm_every else 0


def n_mlstm(cfg) -> int:
    return cfg.n_layers - n_slstm(cfg)


def param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Flat ``/``-joined param keys -> shapes (the JAX checkpoint layout):
    the mLSTM and sLSTM layers each stacked along a leading axis."""
    d, di, H = cfg.d_model, cfg.mlstm_d_inner, cfg.n_heads
    Lm, Ls = n_mlstm(cfg), n_slstm(cfg)
    vp = cm.padded_vocab(cfg.vocab_size)
    s = {"emb/embed": (vp, d)}
    if not cfg.tie_embeddings:
        s["emb/unembed"] = (d, vp)
    s.update({
        "mlstm/ln/scale": (Lm, d), "mlstm/up": (Lm, d, 2 * di),
        "mlstm/conv_w": (Lm, CONV, di), "mlstm/conv_b": (Lm, di),
        "mlstm/wq": (Lm, di, di), "mlstm/wk": (Lm, di, di), "mlstm/wv": (Lm, di, di),
        "mlstm/w_if": (Lm, di, 2 * H), "mlstm/b_if": (Lm, 2 * H),
        "mlstm/norm/scale": (Lm, di), "mlstm/down": (Lm, di, d),
    })
    if Ls:
        s.update({"slstm/ln/scale": (Ls, d), "slstm/W": (Ls, d, 4 * d),
                  "slstm/r": (Ls, 4, d), "slstm/b": (Ls, 4 * d),
                  "slstm/out": (Ls, d, d)})
    s["ln_f/scale"] = (d,)
    return s


def param_specs(cfg) -> Dict[str, P]:
    """Flat param keys (as ``param_shapes``) -> partition specs."""
    fsdp = cm.fsdp_axis(cfg)
    tree = {"emb": cm.embedding_specs(cfg), "mlstm": cm.stacked_specs({
        "ln": cm.NORM_SPECS, "up": P(fsdp, "model"), "conv_w": P(None, "model"),
        "conv_b": P("model"), "wq": P(None, "model"), "wk": P(None, "model"),
        "wv": P(None, "model"), "w_if": P("model", None), "b_if": P(None),
        "norm": {"scale": P("model")}, "down": P("model", fsdp)})}
    if n_slstm(cfg):
        tree["slstm"] = cm.stacked_specs({"ln": cm.NORM_SPECS, "W": P(None, "model"),
                                          "r": P(None, None), "b": P(None),
                                          "out": P(None, None)})
    tree["ln_f"] = cm.NORM_SPECS
    return cm.flatten(tree)


# the gate projections and the sLSTM's recurrence: fp32 in a bf16 model
FP32_KEYS = ("mlstm/w_if", "mlstm/b_if", "slstm/W", "slstm/r", "slstm/b")


def param_dtype(key: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype param ``key`` takes in a model of weight dtype ``dtype``."""
    return cm.wide(dtype) if key in FP32_KEYS else dtype


def init(gen: torch.Generator, cfg, dtype: torch.dtype | None = None):
    """Params on ``gen``'s device: N(0, 1/fan_in) weights (conv_w with
    fan-in CONV, r with fan-in R_FAN_IN), zero biases, unit norm scales,
    and the JAX init's gate biases: b_if = [0]*H ++ linspace(3, 6, H) and
    the sLSTM's b = [0]*d ++ [3]*d ++ [0]*2d, so a run gates and decays as
    the reference's does."""
    dtype = dtype or cm.compute_dtype(cfg)
    H, d, dev = cfg.n_heads, cfg.d_model, gen.device
    const = {"mlstm/b_if": torch.cat([torch.zeros(H, device=dev),
                                      torch.linspace(3.0, 6.0, H, device=dev)])}
    if n_slstm(cfg):
        const["slstm/b"] = torch.cat([torch.zeros(d, device=dev), torch.full((d,), 3.0, device=dev),
                                      torch.zeros(2 * d, device=dev)])
        const["slstm/r"] = cm.dense_init(gen, R_FAN_IN, (n_slstm(cfg), 4, d), torch.float32)
    return cm.init_params(gen, cfg, param_shapes(cfg), lambda key: param_dtype(key, dtype),
                          const)


def _layers(params, cfg):
    """Per-layer views of the stacked mLSTM and sLSTM params, by kind."""
    return {"mlstm": cm.layer_views(params["mlstm"], n_mlstm(cfg)),
            "slstm": cm.layer_views(params["slstm"], n_slstm(cfg)) if n_slstm(cfg) else []}


# ------------------------------------------------------------------- mLSTM
def _mlstm_project(p, cfg, x_in, conv_window):
    """The projections shared by the sequence and the one-token forms.
    x_in (..., d); ``conv_window`` gives the causally convolved x. Returns
    q, k, v, log_i, log_f (gates in w_if's dtype), z and the raw x."""
    di, H = cfg.mlstm_d_inner, cfg.n_heads
    up = x_in @ p["up"]
    x, z = up[..., :di], up[..., di:]
    xc = conv_window(x)
    gates = xc.to(p["w_if"].dtype) @ p["w_if"] + p["b_if"]
    return (xc @ p["wq"], xc @ p["wk"], x @ p["wv"], gates[..., :H],
            sh.replicated(F.logsigmoid, gates[..., H:]), z, x)


def _heads(cfg, q, k, v):
    """(..., di) -> (..., H, dh) in the state dtype for q, k (scaled by
    1/sqrt(dh)) and v."""
    H, dh = cfg.n_heads, cfg.mlstm_d_inner // cfg.n_heads
    split = lambda t: sh.reshape(t, *t.shape[:-1], H, dh).to(cm.wide(t.dtype))   # noqa: E731
    return split(q), split(k) / (dh ** 0.5), split(v)


def _mlstm_chunked(qh, kh, vh, log_i, log_f):
    """Chunkwise-parallel stabilized mLSTM from the empty state: O(chunk^2)
    score blocks with an inter-chunk (C, n, m) state recurrence, the same
    outputs as the token recurrence. qh/kh/vh (B,S,H,dh) and log_i/log_f
    (B,S,H) in the state dtype. A length that CHUNK does not divide runs as
    one chunk. Returns (hh (B,S,H,dh), the final (C (B,H,dh,dh), n
    (B,H,dh), m (B,H)))."""
    B, S, H, dh = qh.shape
    Tc = CHUNK if S % CHUNK == 0 else S
    C = qh.new_zeros((B, H, dh, dh))
    n = qh.new_zeros((B, H, dh))
    m0 = qh.new_full((B, H), M_INIT)
    t = torch.arange(Tc, device=qh.device)
    causal = (t[:, None] >= t[None, :])[None, :, :, None]           # (1,T,U,1)
    outs = []
    # the chunks as views cut by one split each (their gradient gathers in
    # one cat, not a full-length tensor per chunk)
    for qc, kc, vc, lic, lfc in zip(*(t.split(Tc, dim=1) for t in (qh, kh, vh, log_i, log_f))):
        Fc = torch.cumsum(lfc, dim=1)                                # (B,T,H)
        D = Fc[:, :, None, :] - Fc[:, None, :, :] + lic[:, None, :, :]
        D = torch.where(causal, D, -torch.inf)                       # (B,T,U,H)
        m_inter = Fc + m0[:, None, :]
        # amax, not max(dim): a tie's gradient is split evenly, as in JAX
        m = torch.maximum(torch.amax(D, dim=2), m_inter)
        scores = torch.einsum("bthd,buhd->btuh", qc, kc) * torch.exp(D - m[:, :, None, :])
        w_inter = torch.exp(m_inter - m)                             # (B,T,H)
        num = torch.einsum("btuh,buhd->bthd", scores, vc) \
            + w_inter[..., None] * torch.einsum("bhde,bthe->bthd", C, qc)
        den = scores.sum(dim=2) + w_inter * torch.einsum("bhd,bthd->bth", n, qc)
        den = torch.maximum(den.abs(), torch.exp(-m))
        outs.append(num / den[..., None])
        # carry the state to the end of the chunk
        Fe = Fc[:, -1]                                               # (B,H)
        dd = Fe[:, None, :] - Fc + lic                               # (B,T,H)
        m_end = torch.maximum(Fe + m0, torch.amax(dd, dim=1))
        wu = torch.exp(dd - m_end[:, None, :])
        carry = torch.exp(Fe + m0 - m_end)
        # "buh,buhd,buhe->bhde" with wu folded into v: one contraction over
        # u, never a (B,U,H,dh,dh) tensor
        C = carry[..., None, None] * C + torch.einsum("buhd,buhe->bhde", wu[..., None] * vc, kc)
        n = carry[..., None] * n + torch.einsum("buh,buhd->bhd", wu, kc)
        m0 = m_end
    return torch.cat(outs, dim=1), (C, n, m0)


def _mlstm_out(p, cfg, h, hh, z):
    y = sh.reshape(hh, *h.shape[:-1], cfg.mlstm_d_inner).to(h.dtype)
    y = cm.rmsnorm(y, p["norm"], cfg.norm_eps) * F.silu(z)
    return h + sh.rows(y @ p["down"])


def mlstm_forward(p, cfg, h, return_state=False):
    """Full-sequence mLSTM layer. h (B,S,d). With ``return_state`` also
    returns (C, n, m, conv tail (B,CONV-1,di)): the decode state after the
    last token."""
    S = h.shape[1]

    def conv(x):
        pad = F.pad(x, (0, 0, CONV - 1, 0))
        out = sum(pad[:, i:i + S, :] * p["conv_w"][i] for i in range(CONV)) + p["conv_b"]
        return F.silu(out)

    q, k, v, log_i, log_f, z, x_raw = _mlstm_project(
        p, cfg, cm.rmsnorm(h, p["ln"], cfg.norm_eps), conv)
    # the chunk loop's operands with the heads over "model" and the sequence
    # whole (a no-op on plain tensors)
    dp = batch_axes()
    qh, kh, vh = (constrain(t, dp, None, "model", None) for t in _heads(cfg, q, k, v))
    log_i, log_f = (constrain(t, dp, None, "model") for t in (log_i, log_f))
    hh, (C, n, m) = _mlstm_chunked(qh, kh, vh, log_i, log_f)
    out = _mlstm_out(p, cfg, h, hh, z)
    if not return_state:
        return out
    tail = x_raw[:, S - (CONV - 1):, :] if S >= CONV - 1 else \
        F.pad(x_raw, (0, 0, CONV - 1 - S, 0))
    return out, (C, n, m, tail)


def mlstm_decode(p, cfg, h, C, n, m, conv_buf):
    """One-token recurrent step. h (B,d); C (B,H,dh,dh); n (B,H,dh); m (B,H);
    conv_buf (B,CONV-1,di). Returns (h, C, n, m, new conv window)."""
    window = None

    def conv(x):
        nonlocal window
        window = torch.cat([conv_buf, x[:, None, :]], dim=1)            # (B,CONV,di)
        # a wide sum, one rounding: the JAX einsum's accumulation
        wide = cm.wide(x.dtype)
        out = (window.to(wide) * p["conv_w"].to(wide)).sum(1).to(x.dtype) + p["conv_b"]
        return F.silu(out)

    q, k, v, log_i, log_f, z, _ = _mlstm_project(
        p, cfg, cm.rmsnorm(h, p["ln"], cfg.norm_eps), conv)
    qh, kh, vh = _heads(cfg, q, k, v)                                   # (B,H,dh)
    m_new = torch.maximum(log_f + m, log_i)                             # (B,H)
    f_s = torch.exp(log_f + m - m_new)
    i_s = torch.exp(log_i - m_new)
    C = f_s[..., None, None] * C + i_s[..., None, None] * (vh[..., :, None] * kh[..., None, :])
    n = f_s[..., None] * n + i_s[..., None] * kh
    denom = torch.maximum((n * qh).sum(-1).abs(), torch.exp(-m_new))
    hh = torch.einsum("bhde,bhe->bhd", C, qh) / denom[..., None]
    return _mlstm_out(p, cfg, h, hh, z), C, n, m_new, window[:, 1:, :]


# ------------------------------------------------------------------- sLSTM
def _slstm_cell(p, pre, state):
    """pre (B,4d) = x @ W + b. state: (c, n, hs, m), each (B,d); all in W's dtype."""
    c, n, hs, m = state
    pre = pre + (p["r"][None] * hs[:, None, :]).flatten(1)      # r[g] * hs per gate g
    i_p, f_p, z_p, o_p = pre.chunk(4, dim=-1)
    log_f = sh.replicated(F.logsigmoid, f_p)   # a DTensor has no rule for its backward
    m_new = torch.maximum(log_f + m, i_p)
    i_s = torch.exp(i_p - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c = f_s * c + i_s * torch.tanh(z_p)
    n = f_s * n + i_s
    hs = torch.sigmoid(o_p) * c / torch.maximum(n, torch.exp(-m_new))
    return c, n, hs, m_new


def _slstm_pre(p, cfg, h):
    return cm.rmsnorm(h, p["ln"], cfg.norm_eps).to(p["W"].dtype) @ p["W"] + p["b"]


def slstm_forward(p, cfg, h):
    """Sequence forward from the empty state, one cell step per token. h
    (B,S,d). Returns (out, the state after the last token)."""
    B, S, d = h.shape
    # the sequence whole: the loop takes one token at a time (a no-op on
    # plain tensors)
    pre = constrain(_slstm_pre(p, cfg, h), batch_axes(), None, "model")
    zeros = pre.new_zeros((B, d))
    state = (zeros, zeros, zeros, pre.new_full((B, d), M_INIT))
    ys = []
    # the tokens as views cut by one unbind (their gradient gathers in one
    # stack, not a full-length tensor per token)
    for pre_t in pre.unbind(1):
        state = _slstm_cell(p, pre_t, state)
        ys.append(state[2])
    y = torch.stack(ys, dim=1).to(h.dtype)
    return h + y @ p["out"], state


def slstm_decode(p, cfg, h, state):
    state = _slstm_cell(p, _slstm_pre(p, cfg, h), state)
    return h + state[2].to(h.dtype) @ p["out"], state


# ------------------------------------------------------------------- model
def forward(params, cfg, batch):
    """Teacher-forced logits (B, S, Vp) and the aux loss (0.0). Each mLSTM
    layer runs under activation checkpointing when ``cfg.remat`` is set, as
    the JAX package checkpoints its scanned mLSTM body; the sLSTM layers
    are not checkpointed there either."""
    h = cm.embed_tokens(params["emb"], batch["tokens"])
    layers = _layers(params, cfg)
    for kind, i in _order(cfg):
        if kind == "mlstm":
            h = cm.remat(cfg, mlstm_forward, layers[kind][i], cfg, h)
            h = constrain(h, batch_axes(), None, None)
        else:
            h, _ = slstm_forward(layers[kind][i], cfg, h)
    h = cm.rmsnorm(h, params["ln_f"], cfg.norm_eps)
    return constrain(cm.unembed(params["emb"], cfg, h), batch_axes(), None, "model"), 0.0


# ------------------------------------------------------------------ serving
# the cache entries of each kind of layer: mLSTM (C, n, m, conv tail) and
# sLSTM (c, n, hs, m)
STATE = {"mlstm": ("mC", "mn", "mm", "conv"), "slstm": ("sc", "sn", "sh", "sm")}


def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """The empty state: per mLSTM layer C, n, m (fp32, or ``dtype`` if wider)
    and the conv tail (in ``dtype``), per sLSTM layer c, n, hs, m (as C);
    the stabilizers at
    M_INIT. Axis 0 is the layer, axis 1 the slot. ``max_len`` is unused:
    the state does not grow with the context."""
    dev = resolve_device(device)
    H, di, d, B = cfg.n_heads, cfg.mlstm_d_inner, cfg.d_model, batch_size
    dh = di // H
    Lm, Ls = n_mlstm(cfg), n_slstm(cfg)
    wide = dict(dtype=cm.wide(dtype), device=dev)
    return {
        "mC": torch.zeros((Lm, B, H, dh, dh), **wide),
        "mn": torch.zeros((Lm, B, H, dh), **wide),
        "mm": torch.full((Lm, B, H), M_INIT, **wide),
        "conv": torch.zeros((Lm, B, CONV - 1, di), dtype=dtype, device=dev),
        "sc": torch.zeros((Ls, B, d), **wide),
        "sn": torch.zeros((Ls, B, d), **wide),
        "sh": torch.zeros((Ls, B, d), **wide),
        "sm": torch.full((Ls, B, d), M_INIT, **wide),
        "len": torch.zeros((B,), dtype=torch.int32, device=dev),
    }


def cache_specs(cfg) -> Dict[str, P]:
    dp = ("data",)
    return {"mC": P(None, dp, "model", None, None), "mn": P(None, dp, "model", None),
            "mm": P(None, dp, "model"), "conv": P(None, dp, None, "model"),
            "sc": P(None, dp, None), "sn": P(None, dp, None),
            "sh": P(None, dp, None), "sm": P(None, dp, None), "len": P(dp)}


def prefill(params, cfg, batch, last_pos=None):
    """Run the prompt; returns (logits at the last prompt position (B, Vp),
    cache). A recurrent state absorbs every token it is given, so the
    prompt must come at its exact length (no bucket pads)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = cm.embed_tokens(params["emb"], tokens)
    cache = init_cache(cfg, B, S, h.dtype, h.device)
    if sh.is_dtensor(h):       # the dry-run's prefill: the cache laid out by its specs
        cache = sh.distribute(cache, cache_specs(cfg))
    layers = _layers(params, cfg)
    for kind, i in _order(cfg):
        if kind == "mlstm":
            h, state = mlstm_forward(layers[kind][i], cfg, h, return_state=True)
        else:
            h, state = slstm_forward(layers[kind][i], cfg, h)
        for name, t in zip(STATE[kind], state):
            cache[name][i].copy_(t)
    hl = h[:, -1] if last_pos is None else \
        h[torch.arange(B, device=h.device), last_pos.long()]
    logits = cm.unembed(params["emb"], cfg, cm.rmsnorm(hl, params["ln_f"], cfg.norm_eps))
    cache["len"].fill_(S)
    return logits, cache


def decode_step(params, cfg, cache, tokens):
    """One token for every sequence. tokens (B,) -> (logits (B,Vp), cache).

    The returned cache shares ``cache``'s state tensors, which this step
    updates IN PLACE; only ``len`` is a new tensor (every slot + 1)."""
    h = cm.embed_tokens(params["emb"], tokens)
    layers = _layers(params, cfg)
    for kind, i in _order(cfg):
        state = [cache[name][i] for name in STATE[kind]]
        if kind == "mlstm":
            h, *state = mlstm_decode(layers[kind][i], cfg, h, *state)
        else:
            h, state = slstm_decode(layers[kind][i], cfg, h, tuple(state))
        for name, t in zip(STATE[kind], state):
            cache[name][i].copy_(t)
    logits = cm.unembed(params["emb"], cfg, cm.rmsnorm(h, params["ln_f"], cfg.norm_eps))
    return logits, dict(cache, len=cache["len"] + 1)
