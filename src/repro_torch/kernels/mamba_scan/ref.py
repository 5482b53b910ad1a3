"""Plain PyTorch versions of the Mamba2 SSD selective scan: the oracle the
CUDA kernel is held against, the path a tensor on the CPU takes, and the
one-token decode recurrence.

Semantics (per batch b, head h; state S in R^{P x N}):
    lam_t = exp(dt_t * A_h)                       (A_h < 0 => decay)
    S_t   = lam_t * S_{t-1} + (dt_t * x_t) outer B_t
    y_t   = S_t @ C_t + D_h * x_t
Shapes: x (B,S,H,P), dt (B,S,H) [post-softplus], A (H,), B/C (B,S,N),
D (H,), init_state (B,H,P,N). All math is fp32; y comes back in x's dtype
and the final state in fp32.
"""
from __future__ import annotations

import torch


def _fp32(*ts):
    return [t.float() for t in ts]


def _init(x, N, init_state):
    Bsz, _, H, P = x.shape
    if init_state is None:
        return torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    return init_state.float()


def ssd_reference(x, dt, A, Bmat, Cmat, D, init_state=None):
    """The token-by-token scan. Returns (y (B,S,H,P), final_state)."""
    state = _init(x, Bmat.shape[-1], init_state)
    xf, dtf, Bf, Cf, Af, Df = _fp32(x, dt, Bmat, Cmat, A, D)
    ys = []
    for t in range(x.shape[1]):
        xt, dtt = xf[:, t], dtf[:, t]                      # (B,H,P), (B,H)
        lam = torch.exp(dtt * Af[None, :])
        upd = (dtt[..., None] * xt)[..., None] * Bf[:, t, None, None, :]
        state = lam[..., None, None] * state + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t])
                  + Df[None, :, None] * xt)
    return torch.stack(ys, 1).to(x.dtype), state


def ssd_chunked_reference(x, dt, A, Bmat, Cmat, D, init_state=None,
                          chunk: int = 64):
    """The chunk-parallel form (the math the kernel implements): per chunk,
    the decay-masked (C.B^T) product, the read of the carried state and the
    state update. Any S: the tail is padded with dt = 0, where the decay is
    exp(0) = 1 and the update 0, so the state passes through unchanged; the
    padded rows of y are dropped."""
    Bsz, S, H, P = x.shape
    N = Bmat.shape[-1]
    state = _init(x, N, init_state)
    nc = -(-S // chunk)
    pad = nc * chunk - S
    xf, dtf, Bf, Cf, Af, Df = _fp32(x, dt, Bmat, Cmat, A, D)
    if pad:
        xf, dtf, Bf, Cf = (torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
                           for a in (xf, dtf, Bf, Cf))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, dtc, Bc, Cc = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl]
        cum = torch.cumsum(dtc * Af, dim=1)                       # (B,T,H) log L_t
        # intra-chunk: M[t,u] = (C_t.B_u) dt_u exp(cum_t - cum_u), u <= t;
        # the exponent is taken only where u <= t (above the diagonal it is
        # positive and could overflow)
        diff = cum[:, :, None, :] - cum[:, None, :, :]            # (B,T,U,H)
        ratio = torch.exp(torch.where(tri[None, :, :, None], diff, 0.0))
        cb = torch.einsum("btn,bun->btu", Cc, Bc)
        M = (cb[..., None] * dtc[:, None, :, :] * ratio) * tri[None, :, :, None]
        y = torch.einsum("btuh,buhp->bthp", M, xc)
        # inter-chunk: y += L_t * (S_0 @ C_t)
        y = y + torch.exp(cum)[..., None] * torch.einsum("bhpn,btn->bthp", state, Cc)
        y = y + Df[None, None, :, None] * xc
        # state update
        w = torch.exp(cum[:, -1:, :] - cum) * dtc                 # (B,T,H)
        upd = torch.einsum("bthp,btn,bth->bhpn", xc, Bc, w)
        state = torch.exp(cum[:, -1, :])[..., None, None] * state + upd
        ys.append(y)
    y = torch.cat(ys, 1)[:, :S]
    return y.to(x.dtype), state


def ssd_decode_step(state, xt, dtt, A, Bt, Ct, D):
    """Single-token recurrence. state (B,H,P,N) fp32; xt (B,H,P); dtt (B,H);
    Bt/Ct (B,N). Returns (y (B,H,P) in xt's dtype, new_state fp32)."""
    xf = xt.float()
    lam = torch.exp(dtt.float() * A[None, :])
    upd = (dtt[..., None] * xf)[..., None] * Bt.float()[:, None, None, :]
    state = lam[..., None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", state, Ct.float()) + D[None, :, None] * xf
    return y.to(xt.dtype), state
