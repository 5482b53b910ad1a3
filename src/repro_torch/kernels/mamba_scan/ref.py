"""Plain PyTorch versions of the Mamba2 SSD selective scan: the oracle the
CUDA kernel is held against, the path a tensor on the CPU takes, and the
one-token decode recurrence.

Semantics (per batch b, head h; state S in R^{P x N}):
    lam_t = exp(dt_t * A_h)                       (A_h < 0 => decay)
    S_t   = lam_t * S_{t-1} + (dt_t * x_t) outer B_t
    y_t   = S_t @ C_t + D_h * x_t
Shapes: x (B,S,H,P), dt (B,S,H) [post-softplus], A (H,), B/C (B,S,N),
D (H,), init_state (B,H,P,N). All math is fp32 (fp64 when x is fp64); y
comes back in x's dtype and the final state in the math's.
"""
from __future__ import annotations

import torch


def _work(x):
    """The math's dtype: fp32, or fp64 for fp64 inputs."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _wide(x, *ts):
    return [t.to(_work(x)) for t in ts]


def _init(x, N, init_state):
    Bsz, _, H, P = x.shape
    if init_state is None:
        return torch.zeros((Bsz, H, P, N), dtype=_work(x), device=x.device)
    return init_state.to(_work(x))


def ssd_reference(x, dt, A, Bmat, Cmat, D, init_state=None):
    """The token-by-token scan. Returns (y (B,S,H,P), final_state)."""
    state = _init(x, Bmat.shape[-1], init_state)
    xf, dtf, Bf, Cf, Af, Df = _wide(x, x, dt, Bmat, Cmat, A, D)
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
    xf, dtf, Bf, Cf, Af, Df = _wide(x, x, dt, Bmat, Cmat, A, D)
    if pad:
        xf, dtf, Bf, Cf = (torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
                           for a in (xf, dtf, Bf, Cf))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    # the chunks as views cut by one split each (their gradient gathers in
    # one cat, not a full-length tensor per chunk)
    for xc, dtc, Bc, Cc in zip(*(a.split(chunk, dim=1) for a in (xf, dtf, Bf, Cf))):
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


def ssd_backward_reference(x, dt, A, Bmat, Cmat, D, init_state, dy, chunk: int = 64):
    """The VJP of the scan's y (not of its final state, which no gradient
    enters), written as the chunked reverse pass the backward kernel runs.
    Returns (dx, ddt, dA, dB, dC, dD, dinit): dx, dB and dC in x's, B's and
    C's dtypes, the rest in fp32; all arithmetic in fp32 (fp64 when x is
    fp64). A forward sweep recomputes each chunk's start state S0; then,
    from the last chunk to the first, with G the adjoint of the chunk's end
    state (0 after the last chunk), T the chunk length, cum_t the running
    sum of dt_u A over the chunk and M[t,u] = (C_t.B_u) dt_u e^{cum_t-cum_u}
    for u <= t:
        dx_u  = sum_{t>=u} M[t,u] dy_t + D dy_u + dt_u e^{cum_T-cum_u} G B_u
        dC_t += sum_{u<=t} (dy_t.x_u) dt_u e^{cum_t-cum_u} B_u + e^{cum_t} S0^T dy_t
        dB_u += sum_{t>=u} (dy_t.x_u) dt_u e^{cum_t-cum_u} C_t
                + dt_u e^{cum_T-cum_u} G^T x_u
        G    <- e^{cum_T} G + sum_t e^{cum_t} dy_t C_t^T   (dinit after chunk 0)
    and dD = sum dy.x. dt enters directly through dt_u and through cum: the
    adjoint of cum_t is collected, its reverse running sum r_t over the chunk
    taken, and A r_t added to ddt_t, sum_t dt_t r_t to dA. The exponent is
    taken only where u <= t, and a ragged last chunk is padded with dt = 0,
    as in the forward."""
    Bsz, S, H, P = x.shape
    N = Bmat.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    xf, dyf, dtf, Bf, Cf, Af, Df = _wide(x, x, dy, dt, Bmat, Cmat, A, D)
    if pad:
        xf, dyf, dtf, Bf, Cf = (torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
                                for a in (xf, dyf, dtf, Bf, Cf))
    state = _init(x, N, init_state)
    starts = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        starts.append(state)
        cum = torch.cumsum(dtf[:, sl] * Af, dim=1)
        w = torch.exp(cum[:, -1:, :] - cum) * dtf[:, sl]
        state = torch.exp(cum[:, -1, :])[..., None, None] * state + \
            torch.einsum("bthp,btn,bth->bhpn", xf[:, sl], Bf[:, sl], w)

    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    G = torch.zeros_like(state)
    dx, ddt, dB, dC = (torch.empty_like(a) for a in (xf, dtf, Bf, Cf))
    dA, dD = torch.zeros_like(Af), torch.zeros_like(Df)
    for c in reversed(range(nc)):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, dyc, dtc, Bc, Cc, S0 = xf[:, sl], dyf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl], starts[c]
        cum = torch.cumsum(dtc * Af, dim=1)                               # (B,T,H)
        cT = cum[:, -1, :]                                                # (B,H)
        diff = cum[:, :, None, :] - cum[:, None, :, :]                    # (B,T,U,H)
        decay = torch.exp(torch.where(tri[None, :, :, None], diff, 0.0)) * tri[None, :, :, None]
        cb = torch.einsum("btn,bun->btu", Cc, Bc)[..., None]              # (B,T,U,1)
        dxy = torch.einsum("bthp,buhp->btuh", dyc, xc)                    # dy_t.x_u
        K = dxy * cb * decay                  # d y-part / d dt_u, before dt_u
        M = cb * dtc[:, None] * decay
        W = dxy * dtc[:, None] * decay
        Q = K * dtc[:, None]                  # d / d cum_t (row t), - d / d cum_u (column u)
        ecum, erev = torch.exp(cum), torch.exp(cT[:, None, :] - cum)      # (B,T,H)
        w = erev * dtc
        GB = torch.einsum("bhpn,bun->buhp", G, Bc)                         # G B_u
        xGB = (xc * GB).sum(-1)                                           # x_u^T G B_u
        inter = ecum[..., None] * torch.einsum("bhpn,bthp->bthn", S0, dyc)  # e^{cum_t} S0^T dy_t
        dx[:, sl] = torch.einsum("btuh,bthp->buhp", M, dyc) + Df[:, None] * dyc + \
            w[..., None] * GB
        dC[:, sl] = torch.einsum("btuh,bun->btn", W, Bc) + inter.sum(2)
        dB[:, sl] = torch.einsum("btuh,btn->bun", W, Cc) + \
            torch.einsum("bth,bthp,bhpn->btn", w, xc, G)
        dcum = Q.sum(2) - Q.sum(1) + torch.einsum("bthn,btn->bth", inter, Cc) - w * xGB
        dcum[:, -1] += torch.exp(cT) * (G * S0).sum((-2, -1)) + (w * xGB).sum(1)
        r = dcum.flip(1).cumsum(1).flip(1)                                # sum_{t'>=t}
        ddt[:, sl] = K.sum(1) + erev * xGB + Af * r
        dA = dA + (dtc * r).sum((0, 1))
        dD = dD + torch.einsum("bthp,bthp->h", dyc, xc)
        G = torch.exp(cT)[..., None, None] * G + \
            torch.einsum("bth,bthp,btn->bhpn", ecum, dyc, Cc)
    return (dx[:, :S].to(x.dtype), ddt[:, :S], dA, dB[:, :S].to(Bmat.dtype),
            dC[:, :S].to(Cmat.dtype), dD, G)


def ssd_backward_chunk_parallel(x, dt, A, Bmat, Cmat, D, init_state, dy, chunk: int = 64,
                                heads_per_group: int = 1):
    """The same VJP as ``ssd_backward_reference``, in the decomposition the
    chunked backward kernels run (csrc/mamba_scan_bwd.cu, variants 1 and 2):
    (a) each chunk's state increment sum_u w_u x_u B_u^T in parallel, then a
    pass over the chunks forms each start state S0_c; (b) the adjoint's
    increments sum_t e^{cum_t} dy_t C_t^T in parallel, then a reverse pass
    forms G_c, the adjoint of chunk c's end state (dinit is the pass's
    result after chunk 0); (c) every chunk at once, given S0_c and G_c: dx,
    ddt, the per-(b, chunk, h) parts of dA and dD, and dB, dC summed over
    groups of ``heads_per_group`` heads, then over the groups in order.
    Returns (dx, ddt, dA, dB, dC, dD, dinit) as ``ssd_backward_reference``
    does."""
    Bsz, S, H, P = x.shape
    N = Bmat.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    xf, dyf, dtf, Bf, Cf, Af, Df = _wide(x, x, dy, dt, Bmat, Cmat, A, D)
    if pad:
        xf, dyf, dtf, Bf, Cf = (torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
                                for a in (xf, dyf, dtf, Bf, Cf))
    # chunk axis second: x, dy (B,nc,T,H,P); dt (B,nc,T,H); B, C (B,nc,T,N)
    xc, dyc = (a.reshape(Bsz, nc, chunk, H, P) for a in (xf, dyf))
    dtc = dtf.reshape(Bsz, nc, chunk, H)
    Bc, Cc = (a.reshape(Bsz, nc, chunk, N) for a in (Bf, Cf))
    cum = torch.cumsum(dtc * Af, dim=2)                                   # (B,nc,T,H)
    cT = cum[:, :, -1]                                                    # (B,nc,H)
    ecum, erev = torch.exp(cum), torch.exp(cT[:, :, None] - cum)
    w = erev * dtc
    decay = torch.exp(cT)[..., None, None]                                # (B,nc,H,1,1)

    # (a) start states: S0_{c+1} = e^{cum_T} S0_c + sum_u w_u x_u B_u^T
    inc = torch.einsum("bcth,bcthp,bctn->bchpn", w, xc, Bc)
    starts = [_init(x, N, init_state)]
    for c in range(nc - 1):
        starts.append(decay[:, c] * starts[-1] + inc[:, c])
    S0 = torch.stack(starts, 1)                                           # (B,nc,H,P,N)
    # (b) adjoints: G_{c-1} = e^{cum_T} G_c + sum_t e^{cum_t} dy_t C_t^T, G_{nc-1} = 0
    adj = torch.einsum("bcth,bcthp,bctn->bchpn", ecum, dyc, Cc)
    ends = [torch.zeros_like(starts[0])]
    for c in range(nc - 1, 0, -1):
        ends.insert(0, decay[:, c] * ends[0] + adj[:, c])
    G = torch.stack(ends, 1)                                              # (B,nc,H,P,N)
    dinit = decay[:, 0] * G[:, 0] + adj[:, 0]

    # (c) every chunk at once
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]                  # (B,nc,T,U,H)
    dec = torch.exp(torch.where(tri[None, None, :, :, None], diff, 0.0)) * \
        tri[None, None, :, :, None]
    cb = torch.einsum("bctn,bcun->bctu", Cc, Bc)[..., None]               # (B,nc,T,U,1)
    dxy = torch.einsum("bcthp,bcuhp->bctuh", dyc, xc)
    K = dxy * cb * dec
    M = cb * dtc[:, :, None] * dec
    W = dxy * dtc[:, :, None] * dec
    Q = K * dtc[:, :, None]
    GB = torch.einsum("bchpn,bcun->bcuhp", G, Bc)                         # G B_u
    xGB = (xc * GB).sum(-1)                                               # (B,nc,T,H)
    inter = ecum[..., None] * torch.einsum("bchpn,bcthp->bcthn", S0, dyc)
    dx = torch.einsum("bctuh,bcthp->bcuhp", M, dyc) + Df[:, None] * dyc + w[..., None] * GB
    dCh = torch.einsum("bctuh,bcun->bcthn", W, Bc) + inter               # per head
    dBh = torch.einsum("bctuh,bctn->bcuhn", W, Cc) + \
        w[..., None] * torch.einsum("bcthp,bchpn->bcthn", xc, G)
    dcum = Q.sum(3) - Q.sum(2) + torch.einsum("bcthn,bctn->bcth", inter, Cc) - w * xGB
    dcum[:, :, -1] += torch.exp(cT) * (G * S0).sum((-2, -1)) + (w * xGB).sum(2)
    r = dcum.flip(2).cumsum(2).flip(2)                                    # sum_{t'>=t}
    ddt = K.sum(2) + erev * xGB + Af * r
    dA_part = (dtc * r).sum(2)                                            # (B,nc,H)
    dD_part = torch.einsum("bcthp,bcthp->bch", dyc, xc)
    groups = -(-H // heads_per_group)
    dB = sum(dBh[:, :, :, g * heads_per_group:(g + 1) * heads_per_group].sum(3)
             for g in range(groups))
    dC = sum(dCh[:, :, :, g * heads_per_group:(g + 1) * heads_per_group].sum(3)
             for g in range(groups))
    dA = dA_part.reshape(-1, H).sum(0)
    dD = dD_part.reshape(-1, H).sum(0)
    flat = lambda a: a.reshape(Bsz, nc * chunk, *a.shape[3:])[:, :S]    # noqa: E731
    return (flat(dx).to(x.dtype), flat(ddt), dA, flat(dB).to(Bmat.dtype),
            flat(dC).to(Cmat.dtype), dD, dinit)


def ssd_decode_step(state, xt, dtt, A, Bt, Ct, D):
    """Single-token recurrence. state (B,H,P,N) fp32; xt (B,H,P); dtt (B,H);
    Bt/Ct (B,N). Returns (y (B,H,P) in xt's dtype, new_state fp32)."""
    xf = xt.float()
    lam = torch.exp(dtt.float() * A[None, :])
    upd = (dtt[..., None] * xf)[..., None] * Bt.float()[:, None, None, :]
    state = lam[..., None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", state, Ct.float()) + D[None, :, None] * xf
    return y.to(xt.dtype), state
