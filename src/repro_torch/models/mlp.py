"""Dense SwiGLU MLP and MoE (top-k, capacity-dispatched). The expert
products run in the hand-written grouped-matmul kernel; routing, dispatch
and combine are plain tensor code."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P, batch_axes, constrain
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models import common as cm

PRODUCTION_TP = 16  # model-axis size of the production mesh


def mlp_specs(cfg):
    fsdp = cm.fsdp_axis(cfg)
    return {"wg": P(fsdp, "model"), "wu": P(fsdp, "model"), "wd": P("model", fsdp)}


def moe_specs(cfg):
    """EP over the model axis when the expert count divides it; otherwise
    TP over the per-expert hidden dim (granite: 40 experts, f=512)."""
    fsdp = cm.fsdp_axis(cfg)
    ep = cfg.n_experts % PRODUCTION_TP == 0
    we = P("model", fsdp, None) if ep else P(None, fsdp, "model")
    wd = P("model", None, fsdp) if ep else P(None, "model", fsdp)
    return {"router": P(None, None), "wg": we, "wu": we, "wd": wd}


def mlp_forward(p, cfg, x):
    h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    h = constrain(h, batch_axes(), None, "model")
    return sh.rows(h @ p["wd"])


# ------------------------------------------------------------------- MoE
def moe_forward(p, cfg, x):
    if cfg.moe_impl == "sorted":
        return moe_forward_sorted(p, cfg, x)
    return moe_forward_onehot(p, cfg, x)


def _route(p, cfg, x):
    """fp32 router (its weights are fp32 in every model): softmax probs,
    the top-k experts of each token and their renormalised gates."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gate_vals, gate_idx


def _experts(p, xe):
    """SwiGLU of every expert over its capacity rows: (E, C, d) -> (E, C, d)."""
    h = F.silu(gmm_ops.grouped_matmul(xe, p["wg"])) * gmm_ops.grouped_matmul(xe, p["wu"])
    return gmm_ops.grouped_matmul(h, p["wd"])


def moe_forward_onehot(p, cfg, x):
    """Capacity-factor top-k MoE with the GShard queue order.

    x: (B, S, d) -> (y (B, S, d), aux load-balancing loss). Each (token, k)
    assignment takes the next free slot of its expert's queue, in
    token-major order over all B*S tokens; assignments past the capacity
    are dropped. The JAX package builds the (T, E, cap) one-hot dispatch
    tensor; here the same slots are filled by indexing, which gives the
    same buffers (each slot holds one token or zeros) without the
    quadratic tensor.

    The queue spans every token, so under a mesh the dispatch and the
    combine run on full replicas (``sh.replicated``: the tokens, their
    routes and the experts' outputs are gathered, and the dry-run counts
    the collectives); the expert products run on the sharded buffers. For
    plain tensors both are the functions themselves.
    """
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = sh.reshape(x, T, d)
    probs, gate_vals, gate_idx = _route(p, cfg, xt)              # (T, E), (T, K)

    cap = int(cfg.moe_capacity_factor * K * T / E + 0.999)
    cap = max(cap, 4)
    buf, dest, keep = sh.replicated(
        lambda xt, gv, gi: _dispatch_onehot(xt, gv, gi, E, K, cap), xt, gate_vals, gate_idx)
    gates = (gate_vals * keep).to(x.dtype)                       # (T, K)
    xe = constrain(buf[:E * cap].view(E, cap, d), "model", None, None)
    ye = _experts(p, xe)                                         # (E, cap, d)
    y = sh.replicated(lambda ye, dest, gates: _combine_onehot(ye, dest, gates, x.dtype),
                      ye, dest, gates)

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    kept_te = sh.replicated(lambda gi, kp: torch.zeros((T, E), device=gi.device)
                            .scatter_(1, gi, kp.float()), gate_idx, keep)
    aux = E * torch.sum(probs.mean(0) * kept_te.mean(0))
    return y.reshape(B, S, d), aux


def _dispatch_onehot(xt, gate_vals, gate_idx, E: int, K: int, cap: int):
    """(buffers (E*cap + 1, d), dest (T*K,), keep (T, K)): kept assignments
    go to their (expert, slot) rows, dropped ones to a dump row past the
    buffers (no data-dependent shapes, no host sync)."""
    T, d = xt.shape
    # position of each (token, k) assignment within its expert's queue
    onehot = F.one_hot(gate_idx, E)                              # (T, K, E)
    flat = onehot.reshape(T * K, E)
    slot = ((flat.cumsum(0) - 1) * flat).sum(-1).reshape(T, K)   # (T, K)
    keep = (slot < cap) & (gate_vals > 0)
    dest = torch.where(keep, gate_idx * cap + slot, E * cap).reshape(T * K)
    buf = xt.new_zeros((E * cap + 1, d))
    buf.index_add_(0, dest, xt.repeat_interleave(K, dim=0))
    return buf, dest, keep


def _combine_onehot(ye, dest, gates, dtype):
    """Gate-weighted sum over each token's kept assignments: (T, d)."""
    E, cap, d = ye.shape
    T, K = gates.shape
    ye_flat = torch.cat([ye.reshape(E * cap, d), ye.new_zeros((1, d))])
    picked = ye_flat[dest].view(T, K, d)
    return torch.einsum("tkd,tk->td", picked.float(), gates.float()).to(dtype)


def moe_forward_sorted(p, cfg, x):
    """Sorted (argsort/scatter) capacity MoE dispatch, linear in tokens.

    Tokens are grouped by sequence, sorted by expert id inside each group
    (stable, so ties keep token order), scattered into the (E, cap, d)
    expert buffers, run through the grouped matmul and gathered back.
    Capacity is per group: cap_g = ceil(factor * K * S / E). Dropped
    assignments go to one dump row past the buffers, which is thrown away.
    """
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    Tg = S * K
    cap = int(cfg.moe_capacity_factor * K * S / E + 0.999)
    cap = max(cap, 1)
    probs, gate_vals, gate_idx = _route(p, cfg, x)               # (B, S, E), (B, S, K)

    ids = gate_idx.reshape(B, Tg)
    order = torch.argsort(ids, dim=-1, stable=True)              # (B, Tg)
    sorted_ids = ids.gather(-1, order)
    counts = F.one_hot(ids, E).sum(1)                            # (B, E)
    starts = counts.cumsum(-1) - counts                          # exclusive
    rank = torch.arange(Tg, device=x.device)[None, :] - starts.gather(-1, sorted_ids)
    keep = rank < cap
    dest = torch.where(keep, sorted_ids * cap + rank, E * cap)   # (B, Tg)
    src_tok = order // K

    # scatter tokens into per-expert capacity buffers (+ the dump row)
    xs = x.gather(1, src_tok[..., None].expand(B, Tg, d))        # (B, Tg, d)
    buf = x.new_zeros((B, E * cap + 1, d))
    buf.scatter_add_(1, dest[..., None].expand(B, Tg, d), xs)
    xe = buf[:, :E * cap].reshape(B, E, cap, d).transpose(0, 1).reshape(E, B * cap, d)
    # E % TP == 0: EP, experts over "model". Otherwise expert-TP: tokens stay
    # data-resident and every device applies all experts with model-sharded
    # hidden dims (E over a non-dividing axis would replicate the buffers)
    xe = constrain(xe, "model" if E % PRODUCTION_TP == 0 else None, "data", None)

    ye = _experts(p, xe)                                         # (E, B*cap, d)
    ye = ye.reshape(E, B, cap, d).transpose(0, 1).reshape(B, E * cap, d)
    ye_flat = torch.cat([ye, ye.new_zeros((B, 1, d))], dim=1)

    # gather back to (token, k) slots and combine with gates
    out_sorted = ye_flat.gather(1, dest[..., None].expand(B, Tg, d))
    inv = torch.argsort(order, dim=-1)
    out_tk = out_sorted.gather(1, inv[..., None].expand(B, Tg, d)).reshape(B, S, K, d)
    keep_tk = keep.to(x.dtype).gather(-1, inv).reshape(B, S, K)
    gates = gate_vals.to(x.dtype) * keep_tk
    y = torch.einsum("bskd,bsk->bsd", out_tk.float(), gates.float()).to(x.dtype)

    # load-balancing aux (same definition as the one-hot path)
    me = probs.reshape(B * S, E).mean(0)
    ce = (counts.float() / Tg).mean(0)
    aux = E * torch.sum(me * ce)
    return y, aux
